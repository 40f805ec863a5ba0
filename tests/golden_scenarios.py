"""Frozen-golden parity scenarios (VERDICT round-4 mandate #6).

Every numerical-parity guarantee in ``tests/test_parity_*.py`` depends on the
live reference checkout at ``/root/reference`` — if it disappears, the claims
silently skip.  This module defines the flagship scenarios ONCE, with three
faces each:

- ``make_inputs()``  — deterministic inputs from our simulator (fixed seeds;
  nothing stored, the test regenerates them and asserts the SHA-256 recorded
  at generation time still matches — drift fails loudly, not numerically).
- ``run_reference()`` — the reference-side computation (imports
  ``/root/reference``; used ONLY by ``scripts/make_goldens.py``).
- ``run_ours()``     — our JAX computation.
- ``compare(ours, golden)`` — the parity assertions, with the same tolerances
  as the live-reference tests.

``scripts/make_goldens.py`` freezes ``run_reference`` outputs into
``tests/goldens/<name>.npz`` (verifying ``compare(run_ours(...), ...)`` passes
before writing — goldens are born green).  ``tests/test_goldens.py`` then
asserts parity against the committed NPZs with no reference checkout needed.

Reference citations live with the individual scenarios below; scene
constructions mirror the live-parity test files so both tiers pin the same
behavior.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "goldens")
CONFIG_DIR = os.path.join(HERE, "..", "configs")

FLAGSHIP_CFG = os.path.join(CONFIG_DIR, "6843_RadVel_ods_20Hz.cfg")
STANDARD_CFG = os.path.join(CONFIG_DIR, "1843_RadVel_20Hz.cfg")

OS2D = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
OS1D_RNG = dict(num_train=5, num_guard=3, rho=0.6, alpha=2.0)
OS1D_VEL = dict(num_train=5, num_guard=2, rho=0.7, alpha=3.0)
GROUND_VEL = dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0)
ALT_PARAMS = dict(
    min_altitude_m=0.25, zoom_search_region_m=0.2,
    altitude_search_limit_m=0.4, range_bias=0.0, precise_est_enabled=True,
)


@dataclass
class Scenario:
    make_inputs: Callable[[], Dict[str, np.ndarray]]
    run_reference: Callable[[Dict], Dict[str, np.ndarray]]
    run_ours: Callable[[Dict], Dict[str, np.ndarray]]
    compare: Callable[[Dict, Dict], None]


SCENARIOS: Dict[str, Scenario] = {}


def scenario(name):
    def deco(builder):
        SCENARIOS[name] = builder()
        return builder

    return deco


def input_sha(inputs: Dict[str, np.ndarray]) -> str:
    """Order-independent digest of the regenerated inputs."""
    h = hashlib.sha256()
    for k in sorted(inputs):
        h.update(k.encode())
        arr = np.ascontiguousarray(np.asarray(inputs[k]))
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _ours_cfg(path=FLAGSHIP_CFG, geometry="ods", direction="down"):
    from mmwave_radar_processing_jax.config import load_cfg

    return load_cfg(path, array_geometry=geometry, array_direction=direction)


def _ref_cfg(path=FLAGSHIP_CFG, geometry="ods", direction="down"):
    from mmwave_radar_processing.config_managers.cfgManager import (
        ConfigManager,
    )

    mgr = ConfigManager()
    mgr.load_cfg(path, array_geometry=geometry, array_direction=direction)
    return mgr


def _as_set(dets):
    dets = np.asarray(dets)
    if dets.size == 0:
        return set()
    return set(map(tuple, np.atleast_2d(dets.astype(int))))


def _close(got, want, rtol, atol_scale=None, atol=None):
    got, want = np.asarray(got), np.asarray(want)
    if atol is None:
        scale = np.max(np.abs(want)) if want.size else 1.0
        atol = (atol_scale if atol_scale is not None else rtol) * max(
            float(scale), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------- #
# config numerology (reference cfgManager.py:105-169 derived formulas)
# --------------------------------------------------------------------------- #
_DERIVED_FIELDS = ("range_res_m", "range_bin_size_m", "range_max_m",
                   "vel_res_m_s", "vel_max_m_s")
_INT_FIELDS_OURS = ("num_rx_antennas", "num_tx_antennas")


@scenario("config_derived")
def _config_scenario():
    import glob

    cfg_paths = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.cfg")))

    def make_inputs():
        # hash the cfg file bytes: the goldens are only valid for these files
        return {os.path.basename(p): np.frombuffer(
            open(p, "rb").read(), np.uint8) for p in cfg_paths}

    def run_reference(inputs):
        out = {}
        for p in cfg_paths:
            name = os.path.basename(p)
            ref = _ref_cfg(p, "standard", "down")
            out[f"{name}:derived"] = np.array(
                [getattr(ref, f) for f in _DERIVED_FIELDS], np.float64)
            out[f"{name}:ints"] = np.array(
                [ref.num_rx_antennas, ref.num_tx_antennas,
                 int(ref.virtual_antennas_enabled), ref.frameCfg_loops,
                 ref.frameCfg_start_index, ref.frameCfg_end_index], np.int64)
        return out

    def run_ours(inputs):
        out = {}
        for p in cfg_paths:
            name = os.path.basename(p)
            ours = _ours_cfg(p, "standard", "down")
            out[f"{name}:derived"] = np.array(
                [getattr(ours, f) for f in _DERIVED_FIELDS], np.float64)
            out[f"{name}:ints"] = np.array(
                [ours.num_rx_antennas, ours.num_tx_antennas,
                 int(ours.virtual_antennas_enabled), ours.frame.loops,
                 ours.frame.start_index, ours.frame.end_index], np.int64)
        return out

    def compare(got, want):
        for k in want:
            if k.endswith(":derived"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# spectral processors, flagship ODS config (test_parity_processors.py mirror)
# --------------------------------------------------------------------------- #
def _spectral_raw_cube():
    from mmwave_radar_processing_jax.data import (
        PointTarget, Scene, simulate_frame,
    )

    scene = Scene(
        targets=[
            PointTarget(range_m=1.2, azimuth_rad=0.3, velocity_m_s=0.5,
                        rcs=2.0),
            PointTarget(range_m=2.5, azimuth_rad=-0.4, velocity_m_s=-0.8),
            PointTarget(range_m=0.8, elevation_rad=0.2, velocity_m_s=0.1),
        ],
        noise_sigma=0.05,
    )
    return simulate_frame(_ours_cfg(), scene,
                          np.random.default_rng(7)).astype(np.complex128)


DA_COARSE_CASES = [
    ((0, 3, 4, 7), (0.9, 2.0), True),
    ((1, 2, 5, 6), (0.5, 3.0), True),
    ((9, 8, 5, 4), (), False),
]


@scenario("spectral_ods")
def _spectral_scenario():
    def make_inputs():
        return {"raw": _spectral_raw_cube()}

    def run_reference(inputs):
        from mmwave_radar_processing.processors.doppler_azimuth_resp import (
            DopplerAzimuthProcessor as RefDA,
        )
        from mmwave_radar_processing.processors.micro_doppler_resp import (
            MicroDopplerProcessor as RefMD,
        )
        from mmwave_radar_processing.processors.range_angle_resp import (
            RangeAngleProcessor as RefRA,
        )
        from mmwave_radar_processing.processors.range_doppler_resp import (
            RangeDopplerProcessor as RefRD,
        )
        from mmwave_radar_processing.processors.range_resp import (
            RangeProcessor as RefRP,
        )
        from mmwave_radar_processing.processors.virtual_array_reformater import (
            VirtualArrayReformatter as RefVAR,
        )

        ref_cfg = _ref_cfg()
        raw = inputs["raw"]
        virt = RefVAR(ref_cfg).process(raw)
        out = {"virtual": virt.astype(np.complex64)}

        rp = RefRP(ref_cfg)
        coarse = rp.coarse_fft(virt, chirp_idx=0)
        out["range_coarse"] = coarse.astype(np.float32)
        out["range_bins"] = np.asarray(rp.range_bins, np.float64)
        zoom_mag, zoom_bins = rp.zoom_fft(virt, 0.8, 1.6, chirp_idx=0)
        out["zoom_mag"] = zoom_mag.astype(np.float32)
        out["zoom_bins"] = np.asarray(zoom_bins, np.float64)
        pk_bins, _ = rp.find_peaks(20 * np.log10(coarse), rp.range_bins,
                                   max_peaks=3)
        out["range_peak_bins"] = np.sort(np.asarray(pk_bins, np.float64))

        rd = RefRD(ref_cfg)
        out["vel_bins"] = np.asarray(rd.vel_bins, np.float64)
        out["rd_rx0_mag"] = rd.process(virt, rx_idx=0,
                                       return_magnitude=True).astype(
                                           np.float32)
        out["rd_all"] = rd.process(virt, rx_idx=-1,
                                   return_magnitude=False).astype(np.complex64)

        ra = RefRA(ref_cfg, num_angle_bins=64)
        out["ra_angle_bins"] = np.asarray(ra.angle_bins, np.float64)
        out["ra_subset"] = ra.process(
            virt, chirp_idx=0, rx_antennas=np.array([0, 3, 4, 7], int)
        ).astype(np.float32)
        out["ra_empty"] = ra.process(
            virt, chirp_idx=0, rx_antennas=np.array([], int)
        ).astype(np.float32)

        da = RefDA(ref_cfg, num_angle_bins=64)
        out["da_vel_bins"] = np.asarray(da.vel_bins, np.float64)
        out["da_valid_angle_bins"] = np.asarray(da.valid_angle_bins)
        for i, (rx, window, shift) in enumerate(DA_COARSE_CASES):
            out[f"da_coarse_{i}"] = da.process(
                virt, rx_antennas=np.array(rx, int),
                range_window=np.array(window), shift_angle=shift,
            ).astype(np.float32)
        out["da_precise"] = da.process(
            virt, rx_antennas=np.array([0, 3, 4, 7], int),
            range_window=np.array([0.9, 2.0]), shift_angle=True,
            use_precise_fft=True, precise_vel_range=np.array([-0.25, 0.25]),
        ).astype(np.float32)
        out["da_zoomed_vel_bins"] = np.asarray(da.zoomed_vel_bins, np.float64)

        md = RefMD(ref_cfg, target_ranges=[0.5, 2.0], num_frames_history=5)
        for i in range(4):
            md_out = md.process(virt * np.exp(1j * 0.1 * i), rx_idx=0)
        out["md_final"] = md_out.astype(np.float32)
        return out

    def run_ours(inputs):
        from mmwave_radar_processing_jax.processors import (
            DopplerAzimuthProcessor,
            MicroDopplerProcessor,
            RangeAngleProcessor,
            RangeDopplerProcessor,
            RangeProcessor,
            VirtualArrayReformatter,
        )

        cfg = _ours_cfg()
        raw = inputs["raw"]
        virt = np.asarray(VirtualArrayReformatter(cfg).process(raw))
        out = {"virtual": virt.astype(np.complex64)}

        rp = RangeProcessor(cfg)
        coarse = np.asarray(rp.coarse_fft(virt, chirp_idx=0))
        out["range_coarse"] = coarse.astype(np.float32)
        out["range_bins"] = np.asarray(rp.range_bins, np.float64)
        zoom_mag, zoom_bins = rp.zoom_fft(virt, 0.8, 1.6, chirp_idx=0)
        out["zoom_mag"] = np.asarray(zoom_mag, np.float32)
        out["zoom_bins"] = np.asarray(zoom_bins, np.float64)
        p_rng, _, p_valid = rp.find_peaks(
            20.0 * np.log10(coarse + 1e-12), np.asarray(rp.range_bins),
            max_peaks=3)
        out["range_peak_bins"] = np.sort(
            np.asarray(p_rng, np.float64)[np.asarray(p_valid)])

        rd = RangeDopplerProcessor(cfg)
        out["vel_bins"] = np.asarray(rd.vel_bins, np.float64)
        out["rd_rx0_mag"] = np.asarray(
            rd.process(virt, rx_idx=0, return_magnitude=True), np.float32)
        out["rd_all"] = np.asarray(
            rd.process(virt, rx_idx=-1, return_magnitude=False), np.complex64)

        ra = RangeAngleProcessor(cfg, num_angle_bins=64)
        out["ra_angle_bins"] = np.asarray(ra.angle_bins, np.float64)
        out["ra_subset"] = np.asarray(
            ra.process(virt, chirp_idx=0, rx_antennas=[0, 3, 4, 7]),
            np.float32)
        out["ra_empty"] = np.asarray(
            ra.process(virt, chirp_idx=0, rx_antennas=[]), np.float32)

        da = DopplerAzimuthProcessor(cfg, num_angle_bins=64)
        out["da_vel_bins"] = np.asarray(da.vel_bins, np.float64)
        out["da_valid_angle_bins"] = np.asarray(da.valid_angle_bins)
        for i, (rx, window, shift) in enumerate(DA_COARSE_CASES):
            out[f"da_coarse_{i}"] = np.asarray(
                da.process(virt, rx_antennas=list(rx),
                           range_window=list(window) if window else None,
                           shift_angle=shift),
                np.float32)
        precise, bins, row_valid = da.process(
            virt, rx_antennas=[0, 3, 4, 7], range_window=[0.9, 2.0],
            shift_angle=True, use_precise_fft=True,
            precise_vel_range=[-0.25, 0.25])
        assert np.asarray(row_valid).all()
        out["da_precise"] = np.asarray(precise, np.float32)
        out["da_zoomed_vel_bins"] = np.asarray(bins, np.float64)

        md = MicroDopplerProcessor(cfg, target_ranges=[0.5, 2.0],
                                   num_frames_history=5)
        for i in range(4):
            md_out = md.process(virt * np.exp(1j * 0.1 * i), rx_idx=0)
        out["md_final"] = np.asarray(md_out, np.float32)
        return out

    def compare(got, want):
        _close(got["virtual"], want["virtual"], 1e-6, atol=1e-6)
        _close(got["range_coarse"], want["range_coarse"], 1e-4)
        np.testing.assert_allclose(got["range_bins"], want["range_bins"],
                                   rtol=1e-9)
        _close(got["zoom_mag"], want["zoom_mag"], 1e-3)
        np.testing.assert_allclose(got["zoom_bins"], want["zoom_bins"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["range_peak_bins"],
                                   want["range_peak_bins"], rtol=1e-5)
        np.testing.assert_allclose(got["vel_bins"], want["vel_bins"],
                                   rtol=1e-9, atol=1e-12)
        _close(got["rd_rx0_mag"], want["rd_rx0_mag"], 2e-4)
        _close(got["rd_all"], want["rd_all"], 2e-4)
        np.testing.assert_allclose(got["ra_angle_bins"],
                                   want["ra_angle_bins"], rtol=1e-9)
        _close(got["ra_subset"], want["ra_subset"], 2e-4)
        _close(got["ra_empty"], want["ra_empty"], 2e-4)
        np.testing.assert_allclose(got["da_vel_bins"], want["da_vel_bins"],
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(got["da_valid_angle_bins"],
                                      want["da_valid_angle_bins"])
        for i in range(len(DA_COARSE_CASES)):
            _close(got[f"da_coarse_{i}"], want[f"da_coarse_{i}"], 3e-4)
        _close(got["da_precise"], want["da_precise"], 3e-3)
        np.testing.assert_allclose(got["da_zoomed_vel_bins"],
                                   want["da_zoomed_vel_bins"], rtol=1e-4,
                                   atol=1e-6)
        _close(got["md_final"], want["md_final"], 2e-4)

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# altimeter track (reference altimeter.py:104-140 stateful gate)
# --------------------------------------------------------------------------- #
ALT_PROFILE = [0.6, 0.65, 0.72, 0.70]


@scenario("altimeter_ods")
def _altimeter_scenario():
    def make_inputs():
        from mmwave_radar_processing_jax.data import (
            PointTarget, Scene, simulate_frame,
        )

        cfg = _ours_cfg()
        rng = np.random.default_rng(3)
        cubes = {}
        for step, alt in enumerate(ALT_PROFILE):
            scene = Scene(
                targets=[PointTarget(range_m=alt, rcs=4.0),
                         PointTarget(range_m=2.2, rcs=1.0)],
                noise_sigma=0.02,
            )
            cubes[f"cube_{step}"] = simulate_frame(cfg, scene, rng).astype(
                np.complex128)
        return cubes

    def run_reference(inputs):
        from mmwave_radar_processing.processors.altimeter import (
            Altimeter as RefAlt,
        )

        params = {k: v for k, v in ALT_PARAMS.items()
                  if k != "precise_est_enabled"}
        alt = RefAlt(_ref_cfg(), **params)
        track = [alt.process(inputs[f"cube_{i}"], precise_est_enabled=True)
                 for i in range(len(ALT_PROFILE))]
        return {"track": np.asarray(track, np.float64)}

    def run_ours(inputs):
        from mmwave_radar_processing_jax.processors import Altimeter

        params = {k: v for k, v in ALT_PARAMS.items()
                  if k != "precise_est_enabled"}
        alt = Altimeter(_ours_cfg(), **params)
        track = [float(alt.process(inputs[f"cube_{i}"],
                                   precise_est_enabled=True))
                 for i in range(len(ALT_PROFILE))]
        return {"track": np.asarray(track, np.float64)}

    def compare(got, want):
        np.testing.assert_allclose(got["track"], want["track"], atol=5e-3)
        np.testing.assert_allclose(want["track"], ALT_PROFILE, atol=0.1)

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# CFAR detector family on frozen signals (reference detectors/*.py)
# --------------------------------------------------------------------------- #
CFAR_CASES = [
    ("ca_cfar_1d", dict(num_train=8, num_guard=3, pfa=1e-3), "profile"),
    ("os_cfar_1d", dict(num_train=5, num_guard=3, rho=0.5, alpha=2.0),
     "profile"),
    ("go_cfar_1d", dict(num_train=6, num_guard=2, pfa=1e-3), "profile"),
    ("so_cfar_1d", dict(num_train=6, num_guard=2, pfa=1e-3), "profile"),
    ("ca_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3),
     "rd_map"),
    ("os_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7,
                        alpha=2.0), "rd_map"),
]


@scenario("cfar_detectors")
def _cfar_scenario():
    def make_inputs():
        from mmwave_radar_processing_jax.processors import (
            RangeDopplerProcessor, RangeProcessor, VirtualArrayReformatter,
        )

        cfg = _ours_cfg()
        virt = np.asarray(
            VirtualArrayReformatter(cfg).process(_spectral_raw_cube()))
        rd_map = np.asarray(RangeDopplerProcessor(cfg).process(
            virt, rx_idx=0, return_magnitude=True), np.float64)
        profile = np.asarray(RangeProcessor(cfg).process(virt), np.float64)
        return {"rd_map": rd_map, "profile": profile}

    def _run(registry, inputs):
        out = {}
        for name, params, signal in CFAR_CASES:
            det = registry[name](**params)
            dets = np.atleast_2d(np.asarray(det.detect(inputs[signal]), int))
            out[f"{name}:dets"] = dets
            out[f"{name}:noise"] = np.asarray(det.noise_estimates, np.float64)
        return out

    def run_reference(inputs):
        from mmwave_radar_processing.detectors.detector_registry import (
            get_detector_registry,
        )

        return _run(get_detector_registry(), inputs)

    def run_ours(inputs):
        from mmwave_radar_processing_jax.detectors import (
            get_detector_registry,
        )

        return _run(get_detector_registry(), inputs)

    def compare(got, want):
        for name, _, _ in CFAR_CASES:
            assert _as_set(got[f"{name}:dets"]) == \
                _as_set(want[f"{name}:dets"]), name
            np.testing.assert_allclose(
                got[f"{name}:noise"], want[f"{name}:noise"], rtol=1e-4,
                atol=1e-6, err_msg=name)

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# RD detector family + point clouds (test_parity_detection.py mirror)
# --------------------------------------------------------------------------- #
def _ground_cubes():
    from mmwave_radar_processing_jax.data import (
        PointTarget, Scene, simulate_frame,
    )

    cfg = _ours_cfg()
    rng = np.random.default_rng(11)
    cubes = []
    for alt in [0.5, 0.8, 1.1]:
        scene = Scene(
            targets=[
                PointTarget(range_m=alt, rcs=5.0),
                PointTarget(range_m=alt * 1.2, azimuth_rad=0.4,
                            velocity_m_s=0.6, rcs=3.0),
                PointTarget(range_m=alt * 1.5, azimuth_rad=-0.5,
                            velocity_m_s=-0.9, rcs=3.0),
            ],
            noise_sigma=0.05,
        )
        cubes.append(simulate_frame(cfg, scene, rng).astype(np.complex128))
    return cubes


PCG_GROUND_KW = dict(
    az_antenna_idxs=[0, 3, 4, 7], el_antenna_idxs=[9, 8, 5, 4],
    detector_type="range_doppler_ground_detector",
    detector_params=dict(vel_cfar_type="os_cfar_1d",
                         vel_cfar_params=GROUND_VEL,
                         altimeter_params=ALT_PARAMS),
    shift_az_resp=True, shift_el_resp=False,
)
PCG_2D_KW = dict(
    az_antenna_idxs=[0, 3, 4, 7], el_antenna_idxs=[9, 8, 5, 4],
    detector_type="range_doppler_detector_2d",
    detector_params=dict(cfar_type="os_cfar_2d", cfar_params=OS2D),
)


@scenario("rd_detection_pointcloud_ods")
def _detection_scenario():
    def make_inputs():
        raws = _ground_cubes()
        from mmwave_radar_processing_jax.processors import (
            VirtualArrayReformatter,
        )

        var = VirtualArrayReformatter(_ours_cfg())
        return {f"virt_{i}": np.asarray(var.process(raw)).astype(
            np.complex128) for i, raw in enumerate(raws)}

    def _run(mods, inputs):
        (RangeDetectorCls, RD2DCls, SeqCls, GroundCls, PCGCls, cfg) = mods
        cubes = [inputs[f"virt_{i}"] for i in range(3)]
        out = {}
        rd1 = RangeDetectorCls(cfg, cfar_type="os_cfar_1d",
                               cfar_params=dict(num_train=5, num_guard=3,
                                                rho=0.5, alpha=2.0))
        det2d = RD2DCls(cfg, cfar_type="os_cfar_2d", cfar_params=OS2D)
        seq = SeqCls(cfg, rng_cfar_type="os_cfar_1d",
                     rng_cfar_params=OS1D_RNG, vel_cfar_type="os_cfar_1d",
                     vel_cfar_params=OS1D_VEL)
        ground = GroundCls(cfg, vel_cfar_type="os_cfar_1d",
                           vel_cfar_params=GROUND_VEL,
                           altimeter_params=ALT_PARAMS)
        pcg_ground = PCGCls(cfg, **PCG_GROUND_KW)
        pcg_2d = PCGCls(cfg, **PCG_2D_KW)
        for i, cube in enumerate(cubes):
            out[f"rng_dets_{i}"] = np.sort(
                np.asarray(rd1.process(cube), int).reshape(-1))
            out[f"rd2d_dets_{i}"] = np.atleast_2d(
                np.asarray(det2d.process(cube), int))
            out[f"seq_dets_{i}"] = np.atleast_2d(
                np.asarray(seq.process(cube), int))
            out[f"ground_dets_{i}"] = np.atleast_2d(
                np.asarray(ground.process(cube), int))
        # point clouds need fresh stateful detectors (altimeter state)
        for i, cube in enumerate(cubes):
            out[f"pcg_ground_pts_{i}"] = np.asarray(
                pcg_ground.process(cube), np.float64).reshape(-1, 4)
            out[f"pcg_2d_pts_{i}"] = np.asarray(
                pcg_2d.process(cube), np.float64).reshape(-1, 4)
        return out

    def run_reference(inputs):
        from mmwave_radar_processing.processors.point_cloud_generator import (
            PointCloudGenerator,
        )
        from mmwave_radar_processing.processors.range_detector import (
            RangeDetector,
        )
        from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_detector_2d import (
            RangeDopplerDetector2D,
        )
        from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_detector_sequential import (
            RangeDopplerDetectorSequential,
        )
        from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_ground_detector import (
            RangeDopplerGroundDetector,
        )

        return _run((RangeDetector, RangeDopplerDetector2D,
                     RangeDopplerDetectorSequential,
                     RangeDopplerGroundDetector, PointCloudGenerator,
                     _ref_cfg()), inputs)

    def run_ours(inputs):
        from mmwave_radar_processing_jax.processors.detection import (
            RangeDetector,
            RangeDopplerDetector2D,
            RangeDopplerDetectorSequential,
            RangeDopplerGroundDetector,
        )
        from mmwave_radar_processing_jax.processors.point_cloud import (
            PointCloudGenerator,
        )

        return _run((RangeDetector, RangeDopplerDetector2D,
                     RangeDopplerDetectorSequential,
                     RangeDopplerGroundDetector, PointCloudGenerator,
                     _ours_cfg()), inputs)

    def compare(got, want):
        for i in range(3):
            np.testing.assert_array_equal(
                got[f"rng_dets_{i}"], want[f"rng_dets_{i}"], err_msg=f"rng {i}")
            for key in ("rd2d_dets", "seq_dets", "ground_dets"):
                assert _as_set(got[f"{key}_{i}"]) == \
                    _as_set(want[f"{key}_{i}"]), (key, i)
            for key in ("pcg_ground_pts", "pcg_2d_pts"):
                g, w = got[f"{key}_{i}"], want[f"{key}_{i}"]
                assert g.shape == w.shape, (key, i, g.shape, w.shape)
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{key} {i}")

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# ADC-path ego-velocity, flagship ODS (velocity_estimator.py:785-872 chain)
# --------------------------------------------------------------------------- #
VEL_EGO_VELS = [(1.2, 0.3, -0.1), (1.0, 0.5, 0.2)]
VEL_FRAMES_PER = 3
VEL_ALTITUDE = 1.2


@scenario("velocity_adc_ods")
def _velocity_scenario():
    def make_inputs():
        from mmwave_radar_processing_jax.data import (
            ground_scene, simulate_frame,
        )
        from mmwave_radar_processing_jax.processors import (
            VirtualArrayReformatter,
        )

        cfg = _ours_cfg()
        var = VirtualArrayReformatter(cfg)
        rng = np.random.default_rng(17)
        out = {}
        k = 0
        for ego in VEL_EGO_VELS:
            for _ in range(VEL_FRAMES_PER):
                scene = ground_scene(cfg, altitude_m=VEL_ALTITUDE,
                                     ego_vel=np.asarray(ego),
                                     num_patches=200, rng=rng,
                                     noise_sigma=0.01)
                raw = simulate_frame(cfg, scene, rng)
                out[f"virt_{k}"] = np.asarray(var.process(raw)).astype(
                    np.complex128)
                k += 1
        return out

    n_frames = len(VEL_EGO_VELS) * VEL_FRAMES_PER

    def run_reference(inputs):
        from mmwave_radar_processing.processors.velocity_estimator import (
            VelocityEstimator as RefVE,
        )

        ve = RefVE(_ref_cfg(), lower_range_bound=0.5, upper_range_bound=0.5,
                   min_R2_threshold=0.2, min_inlier_percent=0.3)
        vels, az0 = [], None
        for i in range(n_frames):
            v = ve.process(adc_cube=inputs[f"virt_{i}"],
                           altitude=VEL_ALTITUDE)
            vels.append(np.asarray(v, np.float64).copy())
            if i == 0:
                az0 = np.asarray(ve.azimuth_response_mag, np.float32)
        return {"velocity": np.stack(vels), "az_resp_0": az0}

    def run_ours(inputs):
        from mmwave_radar_processing_jax.processors.velocity_estimator import (
            VelocityEstimator,
        )

        ve = VelocityEstimator(_ours_cfg(), lower_range_bound=0.5,
                               upper_range_bound=0.5, min_R2_threshold=0.2,
                               min_inlier_percent=0.3)
        vels, az0 = [], None
        for i in range(n_frames):
            v = ve.process(adc_cube=inputs[f"virt_{i}"],
                           altitude=VEL_ALTITUDE)
            vels.append(np.asarray(v, np.float64).copy())
            if i == 0:
                az0 = np.asarray(ve.azimuth_response_mag, np.float32)
        return {"velocity": np.stack(vels), "az_resp_0": az0}

    def compare(got, want):
        # deterministic zero-azimuth vx readout: bin-exact
        np.testing.assert_allclose(got["velocity"][:, 2],
                                   want["velocity"][:, 2], atol=1e-4)
        # RANSAC-dependent vy/vz: same bound as the live accuracy leg
        np.testing.assert_allclose(got["velocity"][:, :2],
                                   want["velocity"][:, :2], atol=0.45)
        _close(got["az_resp_0"], want["az_resp_0"], 3e-4)
        # the frozen reference estimates are themselves informative: vx
        # tracks the planted ego velocity
        gt_vx = np.repeat([e[0] for e in VEL_EGO_VELS], VEL_FRAMES_PER)
        assert float(np.sqrt(np.mean(
            (want["velocity"][:, 2] - gt_vx) ** 2))) < 0.2

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# points-path ego-velocity estimators (vel_estimator.py, vehicle_vel_estimator)
# --------------------------------------------------------------------------- #
def _golden_ground_points(rng, ego_vel, n=120, n_out=20, planar=False):
    """tests/test_estimators.py `_ground_points` construction (kept in sync)."""
    dirs = rng.standard_normal((n, 3))
    if planar:
        dirs[:, 2] = 0.0
    else:
        dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = rng.uniform(0.5, 3.0, n)
    p = dirs * r[:, None]
    vel = -dirs @ np.asarray(ego_vel) + 0.02 * rng.standard_normal(n)
    out = rng.choice(n, n_out, replace=False)
    vel[out] += rng.uniform(0.5, 2.0, n_out) * rng.choice([-1, 1], n_out)
    return np.column_stack([p, vel])


PTS_EGO_3D = np.array([0.4, -0.2, 1.0])
PTS_EGO_2D = np.array([0.8, -0.3, 0.0])


@scenario("velocity_points")
def _points_scenario():
    def make_inputs():
        rng = np.random.default_rng(1234)
        return {
            "pts_3d": _golden_ground_points(rng, PTS_EGO_3D),
            "pts_2d": _golden_ground_points(rng, PTS_EGO_2D, planar=True),
        }

    def run_reference(inputs):
        from mmwave_radar_processing.point_cloud_processing.vel_estimator import (
            VelocityEstimator as RefPointsVE,
        )
        from mmwave_radar_processing.point_cloud_processing.vehicle_vel_estimator import (
            VehicleVelEstimator as RefVVE,
        )

        ods = RefPointsVE(_ref_cfg(), min_R2_threshold=0.6,
                          min_inlier_percent=0.6)
        out3d = np.asarray(ods.process(points=inputs["pts_3d"]), np.float64)
        std = RefPointsVE(
            _ref_cfg(STANDARD_CFG, "standard", "down"),
            min_R2_threshold=0.5, min_inlier_percent=0.5)
        out2d = np.asarray(std.process(points=inputs["pts_2d"]), np.float64)
        vve = RefVVE(points_per_fit=7, max_iters=100, fit_thresh=0.05,
                     num_close_pts=10, static_vel_thresh=0.2)
        outv = np.asarray(
            vve.estimate_ego_vel(inputs["pts_2d"], only_2D=True), np.float64)
        return {"out_3d": out3d, "out_2d": out2d, "out_vehicle": outv}

    def run_ours(inputs):
        from mmwave_radar_processing_jax.point_cloud_processing import (
            VehicleVelEstimator,
            VelocityEstimator as PointsVE,
        )

        ods = PointsVE(_ours_cfg(), min_R2_threshold=0.6,
                       min_inlier_percent=0.6)
        out3d = np.asarray(ods.process(points=inputs["pts_3d"]), np.float64)
        std = PointsVE(_ours_cfg(STANDARD_CFG, "standard", "down"),
                       min_R2_threshold=0.5, min_inlier_percent=0.5)
        out2d = np.asarray(std.process(points=inputs["pts_2d"]), np.float64)
        vve = VehicleVelEstimator(points_per_fit=7, max_iters=100,
                                  fit_thresh=0.05, num_close_pts=10,
                                  static_vel_thresh=0.2)
        outv = np.asarray(
            vve.estimate_ego_vel(inputs["pts_2d"], only_2D=True), np.float64)
        return {"out_3d": out3d, "out_2d": out2d, "out_vehicle": outv}

    def compare(got, want):
        # different RANSAC engines converge to the same inlier LSQ on these
        # clean scenes: a few cm/s agreement, and both track the planted ego
        np.testing.assert_allclose(got["out_3d"], want["out_3d"], atol=0.05)
        np.testing.assert_allclose(want["out_3d"], PTS_EGO_3D, atol=0.05)
        np.testing.assert_allclose(got["out_2d"][:2], want["out_2d"][:2],
                                   atol=0.06)
        np.testing.assert_allclose(want["out_2d"][:2], PTS_EGO_2D[:2],
                                   atol=0.06)
        np.testing.assert_allclose(got["out_vehicle"], want["out_vehicle"],
                                   atol=0.1)

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# SAR slab (test_parity_sar.py mirror)
# --------------------------------------------------------------------------- #
SA_KW = dict(
    receiver_idx=0, chirp_cfg_idx=0, num_frames=3, stride=1,
    min_vel=np.array([0.15, 0.0, 0.0]), max_vel=np.array([0.3, 0.05, 0.05]),
    max_vel_stdev=np.array([0.1, 0.1, 0.1]),
)
SA_VEL = np.array([0.2, 0.01, 0.0])


def _sar_cubes():
    from mmwave_radar_processing_jax.data import (
        PointTarget, Scene, simulate_frame,
    )

    cfg = _ours_cfg()
    rng = np.random.default_rng(21)
    cubes = []
    for i in range(4):
        scene = Scene(
            targets=[
                PointTarget(range_m=1.0 + 0.1 * i, rcs=4.0),
                PointTarget(range_m=1.8, azimuth_rad=0.3, velocity_m_s=0.4,
                            rcs=2.0),
                PointTarget(range_m=2.6, azimuth_rad=-0.2, velocity_m_s=-0.3,
                            rcs=2.0),
            ],
            noise_sigma=0.03,
        )
        cubes.append(simulate_frame(cfg, scene, rng).astype(np.complex128))
    return cubes


@scenario("sar_ods")
def _sar_scenario():
    az_bins = np.deg2rad(np.linspace(-30, 30, 40))
    el_bins = np.array([0.0])

    def make_inputs():
        return {f"raw_{i}": c for i, c in enumerate(_sar_cubes())}

    def _run(mods, inputs):
        (SARCls, DBSCls, SACls, var_process, cfg) = mods
        cubes = [inputs[f"raw_{i}"] for i in range(4)]
        out = {}
        sar = SARCls(cfg)
        for vel in (0.2, 0.35):
            out[f"sar_{vel}"] = np.asarray(sar.process(
                cubes[0], vel_m_per_s=vel, sensor_height_m=0.24,
                max_SAR_distance=1.5)).astype(np.complex64)
        out["sar_ground_range_bins"] = np.asarray(sar.ground_range_bins,
                                                  np.float64)
        out["sar_ground_az_bins"] = np.asarray(sar.ground_az_bins_rad,
                                               np.float64)

        virt = var_process(cubes[0])
        dbs = DBSCls(cfg, num_angle_bins_range_angle_response=64,
                     num_angle_bins_dbs_enhanced_response=100,
                     min_x_y_vel_dbs=0.25)
        rx = np.array([0, 3, 4, 7])
        out["dbs_slow"] = np.asarray(dbs.process(
            virt, velocity_ned=np.array([0.1, 0.05, 0.0]),
            rx_antennas=rx)).astype(np.float32)
        out["dbs_fast"] = np.asarray(dbs.process(
            virt, velocity_ned=np.array([0.5, 0.2, 0.0]),
            rx_antennas=rx)).astype(np.float32)

        sa = SACls(cfg, az_angle_bins_rad=az_bins, el_angle_bins_rad=el_bins,
                   **SA_KW)
        sa_out = None
        for cube in cubes:
            sa_out = sa.process(cube.copy(), current_vel=SA_VEL)
        assert sa.array_geometry_valid
        out["sa_resp"] = np.asarray(sa_out).astype(np.complex64)
        out["sa_geometry"] = np.asarray(sa.array_geometry, np.float64)
        out["sa_pattern"] = np.asarray(
            sa.compute_synthetic_array_pattern(sa.array_geometry),
            np.float32)

        sa_cal = SACls(cfg, az_angle_bins_rad=az_bins,
                       el_angle_bins_rad=el_bins, enable_calibration=True,
                       num_calibration_iters=1, **SA_KW)
        cal_out = None
        for cube in cubes:
            cal_out = sa_cal.process(cube.copy(), current_vel=SA_VEL)
        out["sa_cal_geometry"] = np.asarray(sa_cal.array_geometry_calibrated,
                                            np.float64)
        out["sa_cal_resp_mag"] = np.abs(np.asarray(cal_out)).astype(
            np.float32)
        return out

    def run_reference(inputs):
        from mmwave_radar_processing.processors.range_angle_resp_dbs_enhanced import (
            RangeAngleProcessorDBSEnhanced as RefDBS,
        )
        from mmwave_radar_processing.processors.simple_synthetic_array_beamformer_processor_multiFrame import (
            SyntheticArrayBeamformerProcessor as RefSA,
        )
        from mmwave_radar_processing.processors.strip_map_SAR_processor import (
            StripMapSARProcessor as RefSAR,
        )
        from mmwave_radar_processing.processors.virtual_array_reformater import (
            VirtualArrayReformatter as RefVAR,
        )

        ref_cfg = _ref_cfg()
        return _run((RefSAR, RefDBS, RefSA, RefVAR(ref_cfg).process, ref_cfg),
                    inputs)

    def run_ours(inputs):
        from mmwave_radar_processing_jax.processors.dbs import (
            RangeAngleProcessorDBSEnhanced,
        )
        from mmwave_radar_processing_jax.processors.strip_map_sar import (
            StripMapSARProcessor,
        )
        from mmwave_radar_processing_jax.processors.synthetic_array import (
            SyntheticArrayBeamformerProcessor,
        )
        from mmwave_radar_processing_jax.processors.virtual_array import (
            VirtualArrayReformatter,
        )

        cfg = _ours_cfg()
        return _run(
            (StripMapSARProcessor, RangeAngleProcessorDBSEnhanced,
             SyntheticArrayBeamformerProcessor,
             lambda c: np.asarray(VirtualArrayReformatter(cfg).process(c)),
             cfg),
            inputs)

    def compare(got, want):
        for vel in (0.2, 0.35):
            _close(got[f"sar_{vel}"], want[f"sar_{vel}"], 2e-4)
        np.testing.assert_allclose(got["sar_ground_range_bins"],
                                   want["sar_ground_range_bins"], rtol=1e-6)
        np.testing.assert_allclose(got["sar_ground_az_bins"],
                                   want["sar_ground_az_bins"], rtol=1e-6)
        _close(got["dbs_slow"], want["dbs_slow"], 2e-4)
        _close(got["dbs_fast"], want["dbs_fast"], 3e-4)
        _close(got["sa_resp"], want["sa_resp"], 5e-4)
        np.testing.assert_allclose(got["sa_geometry"], want["sa_geometry"],
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(got["sa_pattern"], want["sa_pattern"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["sa_cal_geometry"],
                                   want["sa_cal_geometry"], rtol=1e-3,
                                   atol=1e-5)
        _close(got["sa_cal_resp_mag"], want["sa_cal_resp_mag"], 5e-3)

    return Scenario(make_inputs, run_reference, run_ours, compare)


# --------------------------------------------------------------------------- #
# standard-geometry leg (test_parity_standard_geometry.py mirror)
# --------------------------------------------------------------------------- #
@scenario("standard_1843")
def _standard_scenario():
    def make_inputs():
        from mmwave_radar_processing_jax.data import (
            PointTarget, Scene, simulate_frame,
        )
        from mmwave_radar_processing_jax.processors import (
            VirtualArrayReformatter,
        )

        cfg = _ours_cfg(STANDARD_CFG, "standard", "down")
        scene = Scene(
            targets=[
                PointTarget(range_m=1.2, azimuth_rad=0.25, velocity_m_s=0.4,
                            rcs=3.0),
                PointTarget(range_m=2.4, azimuth_rad=-0.3, velocity_m_s=-0.7,
                            rcs=3.0),
            ],
            noise_sigma=0.04,
        )
        raw = simulate_frame(cfg, scene, np.random.default_rng(17)).astype(
            np.complex128)
        virt = np.asarray(VirtualArrayReformatter(cfg).process(raw))
        assert virt.shape == (8, 63, 100)
        return {"virt": virt}

    def run_reference(inputs):
        from mmwave_radar_processing.processors.doppler_azimuth_resp import (
            DopplerAzimuthProcessor as RefDA,
        )
        from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_detector_2d import (
            RangeDopplerDetector2D as Ref2D,
        )
        from mmwave_radar_processing.processors.range_doppler_resp import (
            RangeDopplerProcessor as RefRD,
        )
        from mmwave_radar_processing.processors.velocity_estimator import (
            VelocityEstimator as RefVE,
        )

        ref_cfg = _ref_cfg(STANDARD_CFG, "standard", "down")
        virt = inputs["virt"]
        out = {
            "rd_rx0": RefRD(ref_cfg).process(virt, rx_idx=0).astype(
                np.float32),
            "da": RefDA(ref_cfg, num_angle_bins=64).process(
                virt, rx_antennas=np.arange(8),
                range_window=np.array([0.5, 3.0])).astype(np.float32),
            "dets_2d": np.atleast_2d(np.asarray(Ref2D(
                ref_cfg, cfar_type="os_cfar_2d",
                cfar_params=OS2D).process(virt), int)),
        }
        ve = RefVE(ref_cfg, lower_range_bound=0.5, upper_range_bound=0.5)
        ve_out = ve.process(adc_cube=virt, altitude=1.2)
        out["ve_az_resp"] = np.asarray(ve.azimuth_response_mag, np.float32)
        out["ve_vx"] = np.asarray([ve.ego_vx_estimate], np.float64)
        out["ve_out"] = np.asarray(ve_out, np.float64)
        out["ve_proposed"] = np.asarray(ve.proposed_velocity_estimate,
                                        np.float64)
        return out

    def run_ours(inputs):
        from mmwave_radar_processing_jax.processors import (
            DopplerAzimuthProcessor, RangeDopplerProcessor,
        )
        from mmwave_radar_processing_jax.processors.detection import (
            RangeDopplerDetector2D,
        )
        from mmwave_radar_processing_jax.processors.velocity_estimator import (
            VelocityEstimator,
        )

        cfg = _ours_cfg(STANDARD_CFG, "standard", "down")
        virt = inputs["virt"]
        out = {
            "rd_rx0": np.asarray(
                RangeDopplerProcessor(cfg).process(virt, rx_idx=0),
                np.float32),
            "da": np.asarray(DopplerAzimuthProcessor(
                cfg, num_angle_bins=64).process(
                    virt, rx_antennas=list(range(8)),
                    range_window=[0.5, 3.0]), np.float32),
            "dets_2d": np.atleast_2d(np.asarray(RangeDopplerDetector2D(
                cfg, cfar_type="os_cfar_2d",
                cfar_params=OS2D).process(virt), int)),
        }
        ve = VelocityEstimator(cfg, lower_range_bound=0.5,
                               upper_range_bound=0.5)
        ve_out = ve.process(adc_cube=virt, altitude=1.2)
        out["ve_az_resp"] = np.asarray(ve.azimuth_response_mag, np.float32)
        out["ve_vx"] = np.asarray([ve.ego_vx_estimate], np.float64)
        out["ve_out"] = np.asarray(ve_out, np.float64)
        out["ve_r2"] = np.asarray(
            [ve.azimuth_estimate_R2, ve.min_R2_threshold], np.float64)
        return out

    def compare(got, want):
        _close(got["rd_rx0"], want["rd_rx0"], 2e-4)
        _close(got["da"], want["da"], 3e-4)
        assert _as_set(got["dets_2d"]) == _as_set(want["dets_2d"])
        assert len(_as_set(want["dets_2d"])) > 0
        _close(got["ve_az_resp"], want["ve_az_resp"], 3e-4)
        np.testing.assert_allclose(got["ve_vx"], want["ve_vx"], atol=1e-6)
        if want["ve_vx"][0] < 0.0:
            # documented divergence (test_parity_standard_geometry.py:132-146):
            # the reference's sign-test sentinel zeroes a genuine negative
            # ADC-path vx; we keep it and gate vy per the ADC branch
            np.testing.assert_allclose(want["ve_out"], np.zeros(3), atol=1e-12)
            np.testing.assert_allclose(got["ve_out"][0], want["ve_vx"][0],
                                       atol=1e-6)
            vy_expected = (want["ve_proposed"][1]
                           if got["ve_r2"][0] >= got["ve_r2"][1] else 0.0)
            np.testing.assert_allclose(got["ve_out"][1:], [vy_expected, 0.0],
                                       atol=0.1)
        else:
            np.testing.assert_allclose(got["ve_out"], want["ve_out"],
                                       atol=0.1)

    return Scenario(make_inputs, run_reference, run_ours, compare)
