"""Aux subsystems: profiling counters, checkpoint/resume, platform guard."""

import os

import pytest

import numpy as np

from mmwave_radar_processing_jax.processors.altimeter import Altimeter, AltimeterState
from mmwave_radar_processing_jax.processors.micro_doppler import MicroDopplerProcessor
from mmwave_radar_processing_jax.processors.synthetic_array import (
    SyntheticArrayBeamformerProcessor,
)
from mmwave_radar_processing_jax.utils.checkpoint import (
    PipelineCheckpointer,
    load_state,
    save_state,
)
from mmwave_radar_processing_jax.utils.profiling import StageTimer


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("fft", items=64) as sink:
        sink(np.ones(8))
    with timer.stage("fft", items=64) as sink:
        sink(np.ones(8))
    with timer.stage("cfar", items=64) as sink:
        sink(None)
    report = timer.report()
    assert "fft" in report and "cfar" in report
    assert timer.counts["fft"] == 2
    assert timer.items["fft"] == 128


def test_checkpoint_roundtrip(tmp_path, flagship_config):
    md = MicroDopplerProcessor(flagship_config, num_frames_history=5)
    alt = Altimeter(flagship_config, min_altitude_m=0.25,
                    zoom_search_region_m=0.2, altitude_search_limit_m=0.4)
    sa = SyntheticArrayBeamformerProcessor(flagship_config, num_frames=2)

    states = {
        "micro_doppler": np.asarray(md.init_state()) + 1.5,
        "altimeter": AltimeterState(np.float32(0.77)),
        "synthetic": sa.init_state()._replace(
            adc_history=np.full((2, 63, 70), 1 + 2j, np.complex64)
        ),
    }
    path = str(tmp_path / "state.npz")
    save_state(path, states, metadata={"frame_idx": 42})

    like = {
        "micro_doppler": md.init_state(),
        "altimeter": alt.init_state(),
        "synthetic": sa.init_state(),
    }
    restored, meta = load_state(path, like)
    assert meta["frame_idx"] == 42
    np.testing.assert_allclose(np.asarray(restored["micro_doppler"]),
                               np.asarray(states["micro_doppler"]))
    np.testing.assert_allclose(
        float(restored["altimeter"].altitude_measured_m), 0.77, rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(restored["synthetic"].adc_history),
        np.asarray(states["synthetic"].adc_history),
    )


def test_pipeline_checkpointer(tmp_path, flagship_config):
    alt = Altimeter(flagship_config, min_altitude_m=0.25,
                    zoom_search_region_m=0.2, altitude_search_limit_m=0.4)
    cp = PipelineCheckpointer(str(tmp_path / "ckpt"), every_n_frames=10)

    states = {"altimeter": AltimeterState(np.float32(1.23))}
    assert not cp.maybe_save(5, states)
    assert cp.maybe_save(10, states)

    like = {"altimeter": alt.init_state()}
    restored, frame = cp.restore(like)
    assert frame == 10
    np.testing.assert_allclose(
        float(restored["altimeter"].altitude_measured_m), 1.23, rtol=1e-6
    )

    # no checkpoint -> passthrough
    cp2 = PipelineCheckpointer(str(tmp_path / "empty"))
    passthrough, frame = cp2.restore(like)
    assert frame == 0
    assert passthrough is like


def test_platform_guard_static():
    import jax

    from mmwave_radar_processing_jax.utils import platform as plat

    # on the CPU test platform the plain path is chosen and nothing switches
    assert plat.kernel_route() == "xla"
    assert jax.default_backend() == "cpu"


def test_env_convention(tmp_path, monkeypatch):
    from mmwave_radar_processing_jax.utils import env as env_mod

    envfile = tmp_path / ".env"
    envfile.write_text(
        "# roots\nDATASET_DIRECTORY=/data/sets\nCONFIG_DIRECTORY='/data/cfgs'\n"
    )
    monkeypatch.chdir(tmp_path)
    # monkeypatch.delenv(raising=False) on an *absent* key records no change,
    # so load_env's setdefault would leak past the test; pop explicitly.
    try:
        parsed = env_mod.load_env()
        assert parsed["DATASET_DIRECTORY"] == "/data/sets"
        assert os.environ["CONFIG_DIRECTORY"] == "/data/cfgs"
        assert env_mod.resolve_dir("rec1", "DATASET_DIRECTORY") == "/data/sets/rec1"
        assert env_mod.resolve_dir("/abs/x", "DATASET_DIRECTORY") == "/abs/x"
    finally:
        for key in ("DATASET_DIRECTORY", "CONFIG_DIRECTORY"):
            os.environ.pop(key, None)


@pytest.mark.skipif(
    not os.path.isdir("/root/reference/mmwave_radar_processing"),
    reason="reference not available",
)
def test_rotations_parity():
    import importlib.util
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "ref_rot",
        "/root/reference/mmwave_radar_processing/supportFns/rotation_functions.py",
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    from mmwave_radar_processing_jax.utils import rotations as ours

    rng = np.random.default_rng(0)
    for ang in (-2.0, 0.0, 0.7, 3.5):
        np.testing.assert_allclose(
            ours.get_rot_matrix(ang), ref.get_rot_matrix(ang), rtol=1e-12
        )
        np.testing.assert_allclose(
            ours.get_angle_from_rot_matrix(ours.get_rot_matrix(ang)),
            ref.get_angle_from_rot_matrix(ref.get_rot_matrix(ang)),
        )
        np.testing.assert_allclose(ours.wrap_heading(ang), ref.wrap_heading(ang),
                                   atol=1e-12)

    pts = rng.standard_normal((6, 2))
    np.testing.assert_allclose(
        ours.apply_rot_trans(pts, 0.4, [1.0, -2.0]),
        ref.apply_rot_trans(pts, 0.4, np.array([1.0, -2.0])),
        rtol=1e-12,
    )
    angs = rng.uniform(-np.pi, np.pi, 4)
    trans = rng.standard_normal((4, 2))
    np.testing.assert_allclose(
        ours.apply_multiple_rot_trans(pts, angs, trans),
        ref.apply_multiple_rot_trans(pts, angs, trans),
        rtol=1e-10,
    )
    pts4 = rng.standard_normal((4, 2))
    np.testing.assert_allclose(
        ours.apply_unique_rot_trans_to_multiple_points(pts4, angs, trans),
        ref.apply_unique_rot_trans_to_multiple_points(pts4, angs, trans),
        rtol=1e-10,
    )
