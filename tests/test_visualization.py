"""Visualization stack: registry, controller fan-out, views, movie export.

Equivalent of the reference's view/controller test suite
(``tests/verify_gui_logic.py``, ``tests/verify_video_exporter.py``) —
payload-level assertions on every view class plus an end-to-end movie export
over a simulated CpslDS dataset, all headless.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import yaml

from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.data.cpsl_dataset import make_odom_rows, write_dataset
from mmwave_radar_processing_jax.visualization import (
    MmWaveRadarProcessorController,
    get_default_registry,
)
from mmwave_radar_processing_jax.visualization.views import VIEW_CLASSES


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory, flagship_config):
    """Small simulated dataset in the CpslDS layout + YAML param files."""
    root = tmp_path_factory.mktemp("dataset")
    rng = np.random.default_rng(0)
    frames, odom = [], []
    for i in range(5):
        alt = 0.5 + 0.05 * i
        scene = Scene(
            targets=[
                PointTarget(range_m=alt, rcs=4.0),
                PointTarget(range_m=1.5, azimuth_rad=0.3, velocity_m_s=0.5, rcs=3.0),
            ],
            noise_sigma=0.04,
        )
        frames.append(simulate_frame(flagship_config, scene, rng))
        odom.append(make_odom_rows(np.array([0.3, 0.0, 0.1])))
    write_dataset(str(root / "rec"), np.stack(frames), odom=np.stack(odom))

    ds_params = {
        "dataset": {"dataset_path": str(root / "rec"),
                    "radar_adc_folder": "radar_0_adc",
                    "vehicle_odom_folder": "vehicle_odom"},
        "config": {"name": os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "configs",
                         "6843_RadVel_ods_20Hz.cfg")),
            "array_geometry": "ods", "array_direction": "down"},
    }
    proc_params = {
        "processors": {
            "range_doppler_resp": {"rx_idx": 0},
            "range_resp": {"chirp_idx": 0},
            "micro_doppler_resp": {"target_ranges": [0.2, 2.0],
                                   "num_frames_history": 5},
            "doppler_azimuth_resp": {"num_angle_bins": 64,
                                     "rx_antennas": [0, 3, 4, 7]},
            "range_detector": {"cfar_type": "os_cfar_1d",
                               "cfar_params": {"num_train": 5, "num_guard": 3,
                                               "rho": 0.5, "alpha": 2}},
            "altimeter": {"min_altitude_m": 0.25, "zoom_search_region_m": 0.2,
                          "altitude_search_limit_m": 0.4},
            "range_doppler_detector_2d": {
                "cfar_type": "os_cfar_2d",
                "cfar_params": {"num_train": [5, 5], "num_guard": [3, 2],
                                "rho": 0.7, "alpha": 4}},
            "point_cloud_generator": {
                "az_antenna_idxs": [0, 3, 4, 7],
                "el_antenna_idxs": [9, 8, 5, 4],
                "detector_type": "range_doppler_detector_2d",
                "detector_params": {
                    "cfar_type": "os_cfar_2d",
                    "cfar_params": {"num_train": [5, 5], "num_guard": [3, 2],
                                    "rho": 0.7, "alpha": 4}}},
        }
    }
    ds_path = root / "dataset_params.yaml"
    pp_path = root / "processor_params.yaml"
    ds_path.write_text(yaml.safe_dump(ds_params))
    pp_path.write_text(yaml.safe_dump(proc_params))
    return str(ds_path), str(pp_path)


@pytest.fixture(scope="module")
def controller(sim_dataset):
    ds_path, pp_path = sim_dataset
    registry = get_default_registry()
    # DBS + sequential + ground need extra params; disable for this run
    for k in ("range_angle_resp_dbs_enhanced", "range_doppler_detector_sequential",
              "range_doppler_ground_detector"):
        registry[k].enabled = False
    ctl = MmWaveRadarProcessorController(
        registry=registry, dataset_params_path=ds_path,
        processor_params_path=pp_path,
    )
    return ctl


def test_controller_loads_and_fans_out(controller):
    assert controller.dataset_model.num_frames == 5
    assert controller.config_model.config.num_virtual_antennas == 12
    assert len(controller.processors) >= 8

    received = {}
    controller.subscribe_view_update(lambda k, p: received.setdefault(k, p))
    frames_done = []
    controller.subscribe_frame_processed(frames_done.append)

    controller.process_next_frame(0)
    assert frames_done == [0]
    assert "range_doppler_resp" in received
    assert received["range_doppler_resp"]["data"].shape == (63, 70)
    assert "range_bins" in received["range_doppler_resp"]
    assert "altimeter" in received
    assert "point_cloud_generator" in received
    assert received["point_cloud_generator"]["data"].shape[1] == 4


def test_all_views_render(controller):
    received = {}
    controller.subscribe_view_update(lambda k, p: received.__setitem__(k, p))
    controller.process_next_frame(1)

    for key, payload in received.items():
        spec = controller.registry[key]
        view_cls = VIEW_CLASSES[spec.view_name]
        fig, ax = plt.subplots()
        view = view_cls(ax=ax)
        view.set_data(payload)
        # dB toggle re-renders from the cached payload (reference behavior)
        view.set_db_mode(False)
        assert view.latest_payload is payload
        plt.close(fig)


def test_view_db_conversion():
    from mmwave_radar_processing_jax.visualization.views import RangeDopplerView

    fig, ax = plt.subplots()
    v = RangeDopplerView(ax=ax)
    data = np.abs(np.random.default_rng(0).standard_normal((10, 12))) + 0.1
    v.set_data({"data": data, "range_bins": np.arange(10),
                "vel_bins": np.linspace(-1, 1, 12)})
    img_db = v.ax.images[-1].get_array()
    np.testing.assert_allclose(
        img_db, 20 * np.log10(np.maximum(data, 1e-12)), rtol=1e-6
    )
    v.set_db_mode(False)
    img_lin = v.ax.images[-1].get_array()
    np.testing.assert_allclose(img_lin, data, rtol=1e-6)
    plt.close(fig)


def test_video_export(controller, tmp_path):
    from mmwave_radar_processing_jax.visualization.video_exporter import VideoExporter

    out = str(tmp_path / "out.mp4")  # falls back to .gif without ffmpeg
    exporter = VideoExporter(
        controller,
        view_keys=["range_doppler_resp", "range_resp", "altimeter",
                   "point_cloud_generator"],
        fps=10,
    )
    n = exporter.export(out, start=0, end=3)
    assert n == 3
    produced = [p for p in (out, out[:-4] + ".gif") if os.path.exists(p)]
    assert produced and os.path.getsize(produced[0]) > 1000


def test_view_panel_model():
    from mmwave_radar_processing_jax.visualization.view_panel import ViewPanelModel

    events = []
    panel = ViewPanelModel(num_cells=4, on_assign=lambda c, k: events.append((c, k)))

    assert panel.select(0, "range_doppler") is None
    payload = {"data": 1}
    assert panel.handle_view_update("range_doppler", payload) == [0]

    # cached payload returned on (re)selection elsewhere + uniqueness enforced
    got = panel.select(2, "range_doppler")
    assert got is payload
    assert panel.assignments[0] is None and panel.assignments[2] == "range_doppler"
    assert (0, None) in events

    # hidden view caches payloads and re-renders on reveal
    panel.handle_view_update("altitude", {"data": 2})
    got = panel.select(1, "altitude")
    assert got == {"data": 2}
    assert panel.cell_of("altitude") == 1


# --- precompute-then-scrub playback (device-backed viewer) ------------- #
def _fresh_controller(sim_dataset):
    ds_path, pp_path = sim_dataset
    registry = get_default_registry()
    for k in ("range_angle_resp_dbs_enhanced", "range_doppler_detector_sequential",
              "range_doppler_ground_detector"):
        registry[k].enabled = False
    return MmWaveRadarProcessorController(
        registry=registry, dataset_params_path=ds_path,
        processor_params_path=pp_path,
    )


def test_precomputed_payload_parity(sim_dataset):
    """Precomputed (batched device pipeline) payloads == per-frame payloads.

    Two fresh controllers on the same recording: one plays per-frame (the
    reference-mirroring CPU fan-out), the other serves from the precompute
    cache.  Every covered key's payload must match: maps to float tolerance
    (FFT vs DFT-matmul differ at ~1e-6 relative), detection index sets and
    stateful histories exactly/shape-wise, bins bit-identically (they come
    off the same live processor either way).
    """
    from mmwave_radar_processing_jax.visualization.precompute import COVERED

    ref_ctl = _fresh_controller(sim_dataset)
    ref_payloads = {}
    ref_ctl.subscribe_view_update(
        lambda k, p, store=ref_payloads: store.setdefault(k, []).append(p))
    ref_ctl.play()

    pre_ctl = _fresh_controller(sim_dataset)
    covered = pre_ctl.enable_precomputed_playback()
    assert covered >= {"range_doppler_resp", "range_resp",
                       "micro_doppler_resp", "doppler_azimuth_resp",
                       "range_doppler_detector_2d", "point_cloud_generator",
                       "altimeter", "range_angle_resp", "range_detector",
                       "capon_beamformer", "bartlett_beamformer"}
    assert covered <= COVERED
    pre_payloads = {}
    pre_ctl.subscribe_view_update(
        lambda k, p, store=pre_payloads: store.setdefault(k, []).append(p))
    pre_ctl.play()

    n = ref_ctl.dataset_model.num_frames
    for key in covered:
        assert len(pre_payloads[key]) == len(ref_payloads[key]) == n, key
    for i in range(n):
        for key in ("range_doppler_resp", "range_resp",
                    "doppler_azimuth_resp", "micro_doppler_resp",
                    "range_angle_resp", "capon_beamformer",
                    "bartlett_beamformer"):
            want = np.asarray(ref_payloads[key][i]["data"])
            got = np.asarray(pre_payloads[key][i]["data"])
            scale = max(np.max(np.abs(want[np.isfinite(want)])), 1.0)
            finite = np.isfinite(want)
            np.testing.assert_array_equal(finite, np.isfinite(got), err_msg=key)
            np.testing.assert_allclose(
                got[finite], want[finite], rtol=2e-4, atol=2e-4 * scale,
                err_msg=f"{key} frame {i}")
        # detection sets: identical CFAR decisions expected at these SNRs
        want = ref_payloads["range_doppler_detector_2d"][i]
        got = pre_payloads["range_doppler_detector_2d"][i]
        np.testing.assert_array_equal(np.asarray(got["data"]),
                                      np.asarray(want["data"]))
        np.testing.assert_allclose(got["rng_dop_resp"], want["rng_dop_resp"],
                                   rtol=2e-4, atol=1e-3)
        # point cloud: same detections -> same points to float tolerance
        np.testing.assert_allclose(
            np.asarray(pre_payloads["point_cloud_generator"][i]["data"]),
            np.asarray(ref_payloads["point_cloud_generator"][i]["data"]),
            rtol=1e-4, atol=1e-4)
        # altimeter: sequential track matches the stateful processor
        np.testing.assert_allclose(
            float(pre_payloads["altimeter"][i]["data"]),
            float(ref_payloads["altimeter"][i]["data"]), atol=2e-3)
        # 1D range detector: same detection indices, thresholds, profile
        want = ref_payloads["range_detector"][i]
        got = pre_payloads["range_detector"][i]
        np.testing.assert_array_equal(np.asarray(got["data"]),
                                      np.asarray(want["data"]))
        wt, gt = np.asarray(want["thresholds"]), np.asarray(got["thresholds"])
        np.testing.assert_array_equal(np.isfinite(wt), np.isfinite(gt))
        fin = np.isfinite(wt)
        np.testing.assert_allclose(gt[fin], wt[fin], rtol=2e-4, atol=1e-3)
        # static bins ride along bit-identically
        for key in covered:
            for attr, val in ref_payloads[key][i].items():
                if attr.endswith("_bins") and val is not None:
                    np.testing.assert_array_equal(
                        np.asarray(pre_payloads[key][i][attr]), np.asarray(val))


def test_precompute_fallback_for_unsupported_params(sim_dataset, tmp_path):
    """YAML params outside the batched pipeline's surface -> per-frame path."""
    ds_path, pp_path = sim_dataset
    params = yaml.safe_load(open(pp_path))
    params["processors"]["doppler_azimuth_resp"]["use_precise_fft"] = True
    pp2 = tmp_path / "pp2.yaml"
    pp2.write_text(yaml.safe_dump(params))
    ctl = _fresh_controller((ds_path, str(pp2)))
    covered = ctl.enable_precomputed_playback()
    assert "doppler_azimuth_resp" not in covered
    assert "range_doppler_resp" in covered
    seen = {}
    ctl.subscribe_view_update(lambda k, p: seen.setdefault(k, []).append(p))
    ctl.process_next_frame(0)
    # the uncovered key still emits (per-frame fallback ran)
    assert "doppler_azimuth_resp" in seen and "range_doppler_resp" in seen


def test_precomputed_detector_parity_sequential_and_ground(sim_dataset, tmp_path):
    """Sequential + ground RD detectors: cached payloads == per-frame."""
    ds_path, pp_path = sim_dataset
    params = yaml.safe_load(open(pp_path))
    params["processors"]["range_doppler_detector_sequential"] = {
        "rng_cfar_type": "os_cfar_1d",
        "rng_cfar_params": {"num_train": 5, "num_guard": 3, "rho": 0.6,
                            "alpha": 2},
    }
    params["processors"]["range_doppler_ground_detector"] = {
        "vel_cfar_type": "os_cfar_1d",
        "vel_cfar_params": {"num_train": 5, "num_guard": 2, "rho": 0.6,
                            "alpha": 4},
        "altimeter_params": {"min_altitude_m": 0.25,
                             "zoom_search_region_m": 0.2,
                             "altitude_search_limit_m": 0.4},
    }
    pp2 = tmp_path / "pp_det.yaml"
    pp2.write_text(yaml.safe_dump(params))

    def make(enable_cache):
        registry = get_default_registry()
        keep = {"range_doppler_detector_sequential",
                "range_doppler_ground_detector"}
        for k in registry:
            registry[k].enabled = k in keep
        ctl = MmWaveRadarProcessorController(
            registry=registry, dataset_params_path=ds_path,
            processor_params_path=str(pp2))
        if enable_cache:
            covered = ctl.enable_precomputed_playback()
            assert keep <= covered
        store = {}
        ctl.subscribe_view_update(
            lambda k, p, s=store: s.setdefault(k, []).append(p))
        ctl.play()
        return store

    ref, pre = make(False), make(True)
    for key in ("range_doppler_detector_sequential",
                "range_doppler_ground_detector"):
        for i in range(len(ref[key])):
            np.testing.assert_array_equal(
                np.asarray(pre[key][i]["data"]),
                np.asarray(ref[key][i]["data"]),
                err_msg=f"{key} frame {i}")
            np.testing.assert_allclose(
                pre[key][i]["rng_dop_resp"], ref[key][i]["rng_dop_resp"],
                rtol=2e-4, atol=1e-3)


def test_cache_miss_degrades_to_per_frame_recompute(sim_dataset, monkeypatch):
    """A covered key whose cached payload misses must recompute per-frame.

    Regression (advisor round-4): with every processor covered by the cache,
    the frame inputs were never fetched, so a payload() miss (e.g. scrubbing
    outside the cached range) fell through to ``proc.process(None)`` — a
    guaranteed exception swallowed as a per-frame warning, and the view
    silently never updated.  The miss must instead fetch the frame lazily and
    emit a real recomputed payload.
    """
    ref_ctl = _fresh_controller(sim_dataset)
    ref_payloads = {}
    ref_ctl.subscribe_view_update(
        lambda k, p, store=ref_payloads: store.setdefault(k, []).append(p))
    ref_ctl.process_next_frame(0)

    ctl = _fresh_controller(sim_dataset)
    covered = ctl.enable_precomputed_playback()
    missing_key = "range_doppler_resp"
    assert missing_key in covered
    cache = ctl.playback_cache
    real_payload = cache.payload
    monkeypatch.setattr(
        cache, "payload",
        lambda k, i: None if k == missing_key else real_payload(k, i))

    payloads = {}
    ctl.subscribe_view_update(
        lambda k, p, store=payloads: store.setdefault(k, []).append(p))
    ctl.process_next_frame(0)

    # the missed key emitted a real per-frame payload matching the reference
    # per-frame controller — not a swallowed exception
    assert missing_key in payloads
    got = np.asarray(payloads[missing_key][0]["data"])
    want = np.asarray(ref_payloads[missing_key][0]["data"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the other covered keys still served from the cache
    assert set(payloads) == set(ref_payloads)


def test_precomputed_dbs_parity_both_branches(tmp_path, flagship_config):
    """DBS-enhanced range-angle cache == per-frame path on BOTH gate branches.

    Round-5 coverage mandate: the 12th registry key.  A recording with
    alternating slow/fast odometry exercises the plain range-angle fallback
    and the DBS-sharpened branch; the cached payload must match the
    per-frame processor's data AND carry the branch-matching bin grid/mesh
    (the live processor mutates its own attrs per frame).
    """
    rng = np.random.default_rng(4)
    frames, odom = [], []
    vels = [np.array([0.1, 0.0, 0.0]), np.array([0.5, 0.2, 0.0]),
            np.array([0.05, 0.05, 0.0]), np.array([0.8, -0.3, 0.0])]
    for v in vels:
        scene = Scene(
            targets=[PointTarget(range_m=1.2, azimuth_rad=0.25,
                                 velocity_m_s=0.4, rcs=3.0),
                     PointTarget(range_m=2.2, azimuth_rad=-0.3,
                                 velocity_m_s=-0.5, rcs=2.5)],
            noise_sigma=0.04,
        )
        frames.append(simulate_frame(flagship_config, scene, rng))
        odom.append(make_odom_rows(v))
    root = tmp_path / "dbsrec"
    write_dataset(str(root), np.stack(frames), odom=np.stack(odom))

    ds_params = {
        "dataset": {"dataset_path": str(root),
                    "radar_adc_folder": "radar_0_adc",
                    "vehicle_odom_folder": "vehicle_odom"},
        "config": {"name": os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "configs",
                         "6843_RadVel_ods_20Hz.cfg")),
            "array_geometry": "ods", "array_direction": "down"},
    }
    proc_params = {"processors": {
        "range_angle_resp_dbs_enhanced": {
            "num_angle_bins_range_angle_response": 64,
            "num_angle_bins_dbs_enhanced_response": 100,
            "min_x_y_vel_dbs": 0.25,
            "rx_antennas": [0, 3, 4, 7],
        },
    }}
    dsp = tmp_path / "ds.yaml"
    ppp = tmp_path / "pp.yaml"
    dsp.write_text(yaml.safe_dump(ds_params))
    ppp.write_text(yaml.safe_dump(proc_params))

    def make(enable_cache):
        registry = get_default_registry()
        for k in registry:
            registry[k].enabled = k == "range_angle_resp_dbs_enhanced"
        ctl = MmWaveRadarProcessorController(
            registry=registry, dataset_params_path=str(dsp),
            processor_params_path=str(ppp))
        if enable_cache:
            covered = ctl.enable_precomputed_playback()
            assert "range_angle_resp_dbs_enhanced" in covered
        store = {}
        ctl.subscribe_view_update(
            lambda k, p, s=store: s.setdefault(k, []).append(p))
        ctl.play()
        return store["range_angle_resp_dbs_enhanced"]

    ref, pre = make(False), make(True)
    assert len(ref) == len(pre) == len(vels)
    for i, v in enumerate(vels):
        want, got = np.asarray(ref[i]["data"]), np.asarray(pre[i]["data"])
        expect_dbs = np.linalg.norm(v[:2]) >= 0.25
        assert want.shape == got.shape == (63, 100 if expect_dbs else 64), i
        scale = max(float(np.max(np.abs(want))), 1.0)
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4 * scale,
                                   err_msg=f"frame {i}")
        # branch-matching bins and mesh ride in the cached payload
        np.testing.assert_allclose(np.asarray(pre[i]["angle_bins"]),
                                   np.asarray(ref[i]["angle_bins"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(pre[i]["x_s"]),
                                   np.asarray(ref[i]["x_s"]), rtol=1e-5)
