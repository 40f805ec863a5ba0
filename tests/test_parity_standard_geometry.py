"""Parity on the 1843 standard-geometry config (8-element virtual line).

The flagship tests use the 6843 ODS config; this module re-checks the
processor family on ``1843_RadVel_20Hz`` (2 TX slots, 100 loops, "standard"
geometry) to pin down generality: different cube shapes, the standard
geometry's extra angular Hann window in the Doppler-azimuth path, and the
standard-path velocity estimator.
"""

import os
import sys

import numpy as np
import pytest

from tests.conftest import REFERENCE_ROOT, requires_reference

from mmwave_radar_processing_jax.config import load_cfg
from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.processors import (
    DopplerAzimuthProcessor,
    RangeDopplerProcessor,
    VirtualArrayReformatter,
)
from mmwave_radar_processing_jax.processors.detection import RangeDopplerDetector2D
from mmwave_radar_processing_jax.processors.velocity_estimator import VelocityEstimator

pytestmark = requires_reference

sys.path.insert(0, REFERENCE_ROOT)

CFG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "1843_RadVel_20Hz.cfg")


@pytest.fixture(scope="module")
def cfg():
    return load_cfg(CFG_PATH, array_geometry="standard", array_direction="down")


@pytest.fixture(scope="module")
def ref_cfg():
    from mmwave_radar_processing.config_managers.cfgManager import ConfigManager

    mgr = ConfigManager()
    mgr.load_cfg(CFG_PATH, array_geometry="standard", array_direction="down")
    return mgr


@pytest.fixture(scope="module")
def virtual_cube(cfg, ref_cfg):
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter as RefVAR,
    )

    scene = Scene(
        targets=[
            PointTarget(range_m=1.2, azimuth_rad=0.25, velocity_m_s=0.4, rcs=3.0),
            PointTarget(range_m=2.4, azimuth_rad=-0.3, velocity_m_s=-0.7, rcs=3.0),
        ],
        noise_sigma=0.04,
    )
    raw = simulate_frame(cfg, scene, np.random.default_rng(17)).astype(np.complex128)
    ref = RefVAR(ref_cfg).process(raw)
    ours = np.asarray(VirtualArrayReformatter(cfg).process(raw))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-9)
    assert ref.shape == (8, 63, 100)  # 2 tx slots x 4 rx, 100 loops
    return ref


def test_range_doppler_parity_standard(cfg, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.range_doppler_resp import (
        RangeDopplerProcessor as RefRD,
    )

    ref = RefRD(ref_cfg).process(virtual_cube, rx_idx=0)
    ours = np.asarray(RangeDopplerProcessor(cfg).process(virtual_cube, rx_idx=0))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4 * ref.max())


def test_doppler_azimuth_parity_standard(cfg, ref_cfg, virtual_cube):
    """Standard geometry applies the extra angular Hann window (ref :95-98)."""
    from mmwave_radar_processing.processors.doppler_azimuth_resp import (
        DopplerAzimuthProcessor as RefDA,
    )

    ref_da = RefDA(ref_cfg, num_angle_bins=64)
    ours_da = DopplerAzimuthProcessor(cfg, num_angle_bins=64)
    assert ours_da._angle_window  # standard + virtual -> angle window active

    rx = np.arange(8)
    ref = ref_da.process(virtual_cube, rx_antennas=rx,
                         range_window=np.array([0.5, 3.0]))
    ours = np.asarray(
        ours_da.process(virtual_cube, rx_antennas=list(rx),
                        range_window=[0.5, 3.0])
    )
    np.testing.assert_allclose(ours, ref, rtol=3e-4, atol=3e-4 * ref.max())


def test_detector_parity_standard(cfg, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.range_doppler_detection.range_doppler_detector_2d import (
        RangeDopplerDetector2D as Ref2D,
    )

    params = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
    ref = Ref2D(ref_cfg, cfar_type="os_cfar_2d", cfar_params=params)
    ours = RangeDopplerDetector2D(cfg, cfar_type="os_cfar_2d", cfar_params=params)
    ref_dets = set(map(tuple, np.atleast_2d(ref.process(virtual_cube))))
    ours_dets = set(map(tuple, np.atleast_2d(ours.process(virtual_cube))))
    assert ref_dets == ours_dets and len(ref_dets) > 0


def test_velocity_estimator_standard_path(cfg, ref_cfg, virtual_cube):
    """Standard geometry: azimuth response from arange(8), vy-only model."""
    from mmwave_radar_processing.processors.velocity_estimator import (
        VelocityEstimator as RefVE,
    )

    kwargs = dict(lower_range_bound=0.5, upper_range_bound=0.5)
    ref_ve = RefVE(ref_cfg, **kwargs)
    ours_ve = VelocityEstimator(cfg, **kwargs)

    ref_out = ref_ve.process(adc_cube=virtual_cube, altitude=1.2)
    ours_out = ours_ve.process(adc_cube=virtual_cube, altitude=1.2)
    np.testing.assert_allclose(
        np.asarray(ours_ve.azimuth_response_mag), ref_ve.azimuth_response_mag,
        rtol=3e-4, atol=3e-4 * np.max(ref_ve.azimuth_response_mag),
    )
    np.testing.assert_allclose(ours_ve.ego_vx_estimate, ref_ve.ego_vx_estimate,
                               atol=1e-6)
    if ref_ve.ego_vx_estimate < 0.0:
        # Documented divergence (update_and_check_current_vel_measurements):
        # the reference's sign-test sentinel (ref :623) mis-gates a genuine
        # negative ADC-path vx through the points branch and zeroes it; we
        # gate on the explicit input path, so vx survives and vy is R^2-gated
        # per the ADC branch (ref :630-638).  Pin both behaviors.
        np.testing.assert_allclose(ref_out, np.zeros(3), atol=1e-12)
        np.testing.assert_allclose(ours_out[0], ref_ve.ego_vx_estimate,
                                   atol=1e-6)
        vy_expected = (
            ref_ve.proposed_velocity_estimate[1]
            if ours_ve.azimuth_estimate_R2 >= ours_ve.min_R2_threshold
            else 0.0
        )
        np.testing.assert_allclose(ours_out[1:], [vy_expected, 0.0], atol=0.1)
    else:
        np.testing.assert_allclose(ours_out, ref_out, atol=0.1)
