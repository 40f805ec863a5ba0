"""Parity of the SAR slab: strip-map SAR, DBS, synthetic-aperture beamformer."""

import sys

import numpy as np
import pytest

from tests.conftest import REFERENCE_ROOT, requires_reference

from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.processors.dbs import RangeAngleProcessorDBSEnhanced
from mmwave_radar_processing_jax.processors.strip_map_sar import StripMapSARProcessor
from mmwave_radar_processing_jax.processors.synthetic_array import (
    SyntheticArrayBeamformerProcessor,
)
from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter

pytestmark = requires_reference

sys.path.insert(0, REFERENCE_ROOT)


@pytest.fixture(scope="module")
def ref_cfg(flagship_cfg_path):
    from mmwave_radar_processing.config_managers.cfgManager import ConfigManager

    mgr = ConfigManager()
    mgr.load_cfg(str(flagship_cfg_path), array_geometry="ods", array_direction="down")
    return mgr


@pytest.fixture(scope="module")
def raw_cubes(flagship_config):
    rng = np.random.default_rng(21)
    cubes = []
    for i in range(4):
        scene = Scene(
            targets=[
                PointTarget(range_m=1.0 + 0.1 * i, rcs=4.0),
                PointTarget(range_m=1.8, azimuth_rad=0.3, velocity_m_s=0.4, rcs=2.0),
                PointTarget(range_m=2.6, azimuth_rad=-0.2, velocity_m_s=-0.3, rcs=2.0),
            ],
            noise_sigma=0.03,
        )
        cubes.append(
            simulate_frame(flagship_config, scene, rng).astype(np.complex128)
        )
    return cubes


def test_strip_map_sar_parity(flagship_config, ref_cfg, raw_cubes):
    from mmwave_radar_processing.processors.strip_map_SAR_processor import (
        StripMapSARProcessor as RefSAR,
    )

    ref = RefSAR(ref_cfg)
    ours = StripMapSARProcessor(flagship_config)
    for vel in (0.2, 0.35):
        ref_out = ref.process(
            raw_cubes[0], vel_m_per_s=vel, sensor_height_m=0.24, max_SAR_distance=1.5
        )
        ours_out = ours.process(
            raw_cubes[0], vel_m_per_s=vel, sensor_height_m=0.24, max_SAR_distance=1.5
        )
        assert ours_out.shape == ref_out.shape
        np.testing.assert_allclose(
            ours_out, ref_out, rtol=2e-4, atol=2e-4 * np.abs(ref_out).max()
        )
        np.testing.assert_allclose(ours.ground_range_bins, ref.ground_range_bins,
                                   rtol=1e-6)
        np.testing.assert_allclose(ours.ground_az_bins_rad, ref.ground_az_bins_rad,
                                   rtol=1e-6)


def test_dbs_parity(flagship_config, ref_cfg, raw_cubes):
    from mmwave_radar_processing.processors.range_angle_resp_dbs_enhanced import (
        RangeAngleProcessorDBSEnhanced as RefDBS,
    )
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter as RefVAR,
    )

    virt = RefVAR(ref_cfg).process(raw_cubes[0])
    kwargs = dict(
        num_angle_bins_range_angle_response=64,
        num_angle_bins_dbs_enhanced_response=100,
        min_x_y_vel_dbs=0.25,
    )
    ref = RefDBS(ref_cfg, **kwargs)
    ours = RangeAngleProcessorDBSEnhanced(flagship_config, **kwargs)

    rx = np.array([0, 3, 4, 7])
    # slow platform -> plain range-angle fallback
    slow = np.array([0.1, 0.05, 0.0])
    ref_out = ref.process(virt, velocity_ned=slow, rx_antennas=rx)
    ours_out = np.asarray(ours.process(virt, velocity_ned=slow, rx_antennas=rx))
    np.testing.assert_allclose(ours_out, ref_out, rtol=2e-4,
                               atol=2e-4 * np.abs(ref_out).max())

    # fast platform -> DBS path
    fast = np.array([0.5, 0.2, 0.0])
    ref_out = ref.process(virt, velocity_ned=fast, rx_antennas=rx)
    ours_out = np.asarray(ours.process(virt, velocity_ned=fast, rx_antennas=rx))
    assert ours_out.shape == ref_out.shape
    np.testing.assert_allclose(ours_out, ref_out, rtol=3e-4,
                               atol=3e-4 * np.abs(ref_out).max())
    np.testing.assert_allclose(ours.angle_bins_dbs_enhanced,
                               ref.angle_bins_dbs_enhanced, rtol=1e-9)


def test_synthetic_array_parity(flagship_config, ref_cfg, raw_cubes):
    from mmwave_radar_processing.processors.simple_synthetic_array_beamformer_processor_multiFrame import (
        SyntheticArrayBeamformerProcessor as RefSA,
    )

    kwargs = dict(
        receiver_idx=0,
        chirp_cfg_idx=0,
        num_frames=3,
        stride=1,
        az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 40)),
        el_angle_bins_rad=np.array([0.0]),
        min_vel=np.array([0.15, 0.0, 0.0]),
        max_vel=np.array([0.3, 0.05, 0.05]),
        max_vel_stdev=np.array([0.1, 0.1, 0.1]),
    )
    ref = RefSA(ref_cfg, **kwargs)
    ours = SyntheticArrayBeamformerProcessor(flagship_config, **kwargs)

    np.testing.assert_allclose(ours.chirp_start_times_us, ref.chirp_start_times_us)
    np.testing.assert_array_equal(ours.valid_chirps_mask, ref.valid_chirps_mask)
    np.testing.assert_allclose(ours.d, ref.d, rtol=1e-9)

    vel = np.array([0.2, 0.01, 0.0])
    ref_out = ours_out = None
    for cube in raw_cubes:
        ref_out = ref.process(cube.copy(), current_vel=vel)
        ours_out = ours.process(cube, current_vel=vel)
        assert ours.array_geometry_valid == ref.array_geometry_valid

    assert ref.array_geometry_valid  # the gate passed on the steady track
    np.testing.assert_allclose(
        ours.array_geometry, ref.array_geometry, rtol=1e-5, atol=1e-8
    )
    np.testing.assert_allclose(
        ours_out, ref_out, rtol=5e-4, atol=5e-4 * np.abs(ref_out).max()
    )
    # array-factor pattern parity
    ref_pat = ref.compute_synthetic_array_pattern(ref.array_geometry)
    ours_pat = ours.compute_synthetic_array_pattern(ours.array_geometry)
    np.testing.assert_allclose(ours_pat, ref_pat, rtol=1e-4, atol=1e-4)


def test_synthetic_array_calibration_runs(flagship_config, ref_cfg, raw_cubes):
    """Calibration path executes and keeps the response finite & improves focus."""
    kwargs = dict(
        receiver_idx=0, chirp_cfg_idx=0, num_frames=3, stride=1,
        az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 40)),
        el_angle_bins_rad=np.array([0.0]),
        min_vel=np.array([0.15, 0.0, 0.0]),
        max_vel=np.array([0.3, 0.05, 0.05]),
        max_vel_stdev=np.array([0.1, 0.1, 0.1]),
        enable_calibration=True, num_calibration_iters=1,
    )
    ours = SyntheticArrayBeamformerProcessor(flagship_config, **kwargs)
    vel = np.array([0.2, 0.01, 0.0])
    out = None
    for cube in raw_cubes:
        out = ours.process(cube, current_vel=vel)
    assert out.size > 0 and np.all(np.isfinite(np.abs(out)))
    assert ours.interpolated_beamformed_resp.size > 0


def test_synthetic_array_calibration_parity(flagship_config, ref_cfg, raw_cubes):
    """Self-calibration: corrected geometry + recomputed response match."""
    from mmwave_radar_processing.processors.simple_synthetic_array_beamformer_processor_multiFrame import (
        SyntheticArrayBeamformerProcessor as RefSA,
    )

    kwargs = dict(
        receiver_idx=0, chirp_cfg_idx=0, num_frames=3, stride=1,
        az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 40)),
        el_angle_bins_rad=np.array([0.0]),
        min_vel=np.array([0.15, 0.0, 0.0]),
        max_vel=np.array([0.3, 0.05, 0.05]),
        max_vel_stdev=np.array([0.1, 0.1, 0.1]),
        enable_calibration=True, num_calibration_iters=1,
    )
    ref = RefSA(ref_cfg, **kwargs)
    ours = SyntheticArrayBeamformerProcessor(flagship_config, **kwargs)

    vel = np.array([0.2, 0.01, 0.0])
    for cube in raw_cubes:
        ref_out = ref.process(cube.copy(), current_vel=vel)
        ours_out = ours.process(cube, current_vel=vel)

    assert ref.array_geometry_valid and ours.array_geometry_valid
    assert ref.array_geometry_calibrated.shape == ours.array_geometry_calibrated.shape
    np.testing.assert_allclose(
        ours.array_geometry_calibrated, ref.array_geometry_calibrated,
        rtol=1e-3, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.abs(ours_out), np.abs(ref_out), rtol=5e-3,
        atol=5e-3 * np.abs(ref_out).max(),
    )
