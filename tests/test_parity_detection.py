"""Parity of the RD detector family + point-cloud generator vs the reference."""

import sys

import numpy as np
import pytest

from tests.conftest import REFERENCE_ROOT, requires_reference

from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.processors.detection import (
    RangeDetector,
    RangeDopplerDetector2D,
    RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector,
    get_range_doppler_detector_registry,
)
from mmwave_radar_processing_jax.processors.point_cloud import PointCloudGenerator
from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter

pytestmark = requires_reference

sys.path.insert(0, REFERENCE_ROOT)

OS2D = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
OS1D_RNG = dict(num_train=5, num_guard=3, rho=0.6, alpha=2.0)
OS1D_VEL = dict(num_train=5, num_guard=2, rho=0.7, alpha=3.0)
GROUND_VEL = dict(num_train=12, num_guard=4, rho=0.5, alpha=15.0)
ALT = dict(
    min_altitude_m=0.25,
    zoom_search_region_m=0.2,
    altitude_search_limit_m=0.4,
    range_bias=0.0,
    precise_est_enabled=True,
)


@pytest.fixture(scope="module")
def ref_cfg(flagship_cfg_path):
    from mmwave_radar_processing.config_managers.cfgManager import ConfigManager

    mgr = ConfigManager()
    mgr.load_cfg(str(flagship_cfg_path), array_geometry="ods", array_direction="down")
    return mgr


@pytest.fixture(scope="module")
def ground_cubes(flagship_config):
    """A short down-facing sequence with ground + moving scatterers."""
    rng = np.random.default_rng(11)
    cubes = []
    for alt in [0.5, 0.8, 1.1]:
        scene = Scene(
            targets=[
                PointTarget(range_m=alt, rcs=5.0),
                PointTarget(range_m=alt * 1.2, azimuth_rad=0.4, velocity_m_s=0.6, rcs=3.0),
                PointTarget(range_m=alt * 1.5, azimuth_rad=-0.5, velocity_m_s=-0.9, rcs=3.0),
            ],
            noise_sigma=0.05,
        )
        raw = simulate_frame(flagship_config, scene, rng).astype(np.complex128)
        cubes.append(raw)
    return cubes


@pytest.fixture(scope="module")
def virtual_cubes(ref_cfg, ground_cubes):
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter as RefVAR,
    )

    var = RefVAR(ref_cfg)
    return [var.process(c) for c in ground_cubes]


def _as_set(dets):
    return set(map(tuple, np.atleast_2d(np.asarray(dets, int)))) if np.size(dets) else set()


def test_range_detector_parity(flagship_config, ref_cfg, virtual_cubes):
    from mmwave_radar_processing.processors.range_detector import (
        RangeDetector as RefRangeDetector,
    )

    params = dict(num_train=5, num_guard=3, rho=0.5, alpha=2.0)
    ref = RefRangeDetector(ref_cfg, cfar_type="os_cfar_1d", cfar_params=params)
    ours = RangeDetector(flagship_config, cfar_type="os_cfar_1d", cfar_params=params)
    for cube in virtual_cubes:
        ref_dets = np.asarray(ref.process(cube), int)
        ours_dets = np.asarray(ours.process(cube), int)
        np.testing.assert_array_equal(np.sort(ours_dets), np.sort(ref_dets))


def test_rd_detector_2d_parity(flagship_config, ref_cfg, virtual_cubes):
    from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_detector_2d import (
        RangeDopplerDetector2D as Ref2D,
    )

    ref = Ref2D(ref_cfg, cfar_type="os_cfar_2d", cfar_params=OS2D)
    ours = RangeDopplerDetector2D(flagship_config, cfar_type="os_cfar_2d", cfar_params=OS2D)
    for cube in virtual_cubes:
        assert _as_set(ours.process(cube)) == _as_set(ref.process(cube))
    # bin mapping helper parity
    ref_dets = ref.process(virtual_cubes[0])
    ours_dets = ours.process(virtual_cubes[0])
    rr, rv, _, _ = ref._map_detections_to_bins(np.asarray(ref_dets))
    orr, orv, _, _ = ours._map_detections_to_bins(ours_dets)
    np.testing.assert_allclose(np.sort(orr), np.sort(rr), rtol=1e-6)
    np.testing.assert_allclose(np.sort(orv), np.sort(rv), rtol=1e-6, atol=1e-6)


def test_rd_detector_sequential_parity(flagship_config, ref_cfg, virtual_cubes):
    from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_detector_sequential import (
        RangeDopplerDetectorSequential as RefSeq,
    )

    ref = RefSeq(
        ref_cfg,
        rng_cfar_type="os_cfar_1d", rng_cfar_params=OS1D_RNG,
        vel_cfar_type="os_cfar_1d", vel_cfar_params=OS1D_VEL,
    )
    ours = RangeDopplerDetectorSequential(
        flagship_config,
        rng_cfar_type="os_cfar_1d", rng_cfar_params=OS1D_RNG,
        vel_cfar_type="os_cfar_1d", vel_cfar_params=OS1D_VEL,
    )
    for cube in virtual_cubes:
        assert _as_set(ours.process(cube)) == _as_set(ref.process(cube))


def test_rd_ground_detector_parity(flagship_config, ref_cfg, virtual_cubes):
    from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_ground_detector import (
        RangeDopplerGroundDetector as RefGround,
    )

    ref = RefGround(
        ref_cfg, vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL,
        altimeter_params=ALT,
    )
    ours = RangeDopplerGroundDetector(
        flagship_config, vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL,
        altimeter_params=ALT,
    )
    for cube in virtual_cubes:  # stateful altimeter advances identically
        assert _as_set(ours.process(cube)) == _as_set(ref.process(cube))


def test_point_cloud_generator_parity(flagship_config, ref_cfg, virtual_cubes):
    from mmwave_radar_processing.processors.point_cloud_generator import (
        PointCloudGenerator as RefPCG,
    )

    kwargs = dict(
        az_antenna_idxs=[0, 3, 4, 7],
        el_antenna_idxs=[9, 8, 5, 4],
        detector_type="range_doppler_ground_detector",
        detector_params=dict(
            vel_cfar_type="os_cfar_1d", vel_cfar_params=GROUND_VEL, altimeter_params=ALT
        ),
        shift_az_resp=True,
        shift_el_resp=False,
    )
    ref = RefPCG(ref_cfg, **kwargs)
    ours = PointCloudGenerator(flagship_config, **kwargs)
    for cube in virtual_cubes:
        ref_pts = np.asarray(ref.process(cube))
        ours_pts = np.asarray(ours.process(cube))
        assert ref_pts.shape == ours_pts.shape
        # same detections -> same points; order is row-major on both sides
        np.testing.assert_allclose(ours_pts, ref_pts, rtol=1e-4, atol=1e-5)


def test_point_cloud_recovers_planted_targets(flagship_config, virtual_cubes):
    """Behavioral: azimuth targets appear at the right (x, y, vel)."""
    ours = PointCloudGenerator(
        flagship_config,
        az_antenna_idxs=[0, 3, 4, 7],
        el_antenna_idxs=[],
        detector_type="range_doppler_detector_2d",
        detector_params=dict(cfar_type="os_cfar_2d", cfar_params=OS2D),
    )
    pts = ours.process(virtual_cubes[2])  # alt=1.1 frame
    assert pts.shape[0] > 0
    # the +0.6 m/s target at az=0.4, range 1.32
    sel = pts[np.abs(pts[:, 3] - 0.6) < 0.15]
    assert sel.shape[0] > 0
    az = np.arctan2(sel[:, 1], sel[:, 0])
    assert np.any(np.abs(az - 0.4) < 0.12), az
