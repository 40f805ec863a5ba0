"""Numerical parity of the spectral/detector processors vs the live reference.

Each test feeds the *same* simulated ADC cube to the upstream numpy
implementation (imported from the reference checkout) and to our JAX kernels,
and asserts agreement within float32 tolerance.  These are the strongest
correctness checks in the suite; they skip gracefully when the reference
checkout is absent (the numeric oracles in test_ops.py still run).
"""

import sys

import numpy as np
import pytest

from tests.conftest import REFERENCE_ROOT, requires_reference

from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.processors import (
    Altimeter,
    DopplerAzimuthProcessor,
    MicroDopplerProcessor,
    RangeAngleProcessor,
    RangeDopplerProcessor,
    RangeProcessor,
    VirtualArrayReformatter,
)

pytestmark = requires_reference

sys.path.insert(0, REFERENCE_ROOT)


@pytest.fixture(scope="module")
def ref_cfg(flagship_cfg_path):
    from mmwave_radar_processing.config_managers.cfgManager import (
        ConfigManager as RefConfigManager,
    )

    mgr = RefConfigManager()
    mgr.load_cfg(str(flagship_cfg_path), array_geometry="ods", array_direction="down")
    return mgr


@pytest.fixture(scope="module")
def raw_cube(flagship_config):
    scene = Scene(
        targets=[
            PointTarget(range_m=1.2, azimuth_rad=0.3, velocity_m_s=0.5, rcs=2.0),
            PointTarget(range_m=2.5, azimuth_rad=-0.4, velocity_m_s=-0.8),
            PointTarget(range_m=0.8, elevation_rad=0.2, velocity_m_s=0.1),
        ],
        noise_sigma=0.05,
    )
    return simulate_frame(flagship_config, scene, np.random.default_rng(7)).astype(
        np.complex128
    )


@pytest.fixture(scope="module")
def virtual_cube(ref_cfg, raw_cube):
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter as RefVAR,
    )

    return RefVAR(ref_cfg).process(raw_cube)


TOL = dict(rtol=2e-4, atol=2e-4)


def test_virtual_array_parity(flagship_config, ref_cfg, raw_cube):
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter as RefVAR,
    )

    ref = RefVAR(ref_cfg).process(raw_cube)
    ours = np.asarray(VirtualArrayReformatter(flagship_config).process(raw_cube))
    np.testing.assert_allclose(ours, ref, **TOL)


def test_range_processor_parity(flagship_config, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.range_resp import RangeProcessor as RefRP

    ref_rp = RefRP(ref_cfg)
    ours_rp = RangeProcessor(flagship_config)

    ref = ref_rp.coarse_fft(virtual_cube, chirp_idx=0)
    ours = np.asarray(ours_rp.coarse_fft(virtual_cube, chirp_idx=0))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * ref.max())

    np.testing.assert_allclose(ours_rp.range_bins, ref_rp.range_bins, rtol=1e-12)

    # zoom FFT around a band
    ref_mag, ref_bins = ref_rp.zoom_fft(virtual_cube, 0.8, 1.6, chirp_idx=0)
    ours_mag, ours_bins = ours_rp.zoom_fft(virtual_cube, 0.8, 1.6, chirp_idx=0)
    np.testing.assert_allclose(np.asarray(ours_bins), ref_bins, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ours_mag), ref_mag, rtol=1e-3, atol=1e-3 * ref_mag.max()
    )

    # peak finding on the coarse profile (dB domain)
    ref_peak_bins, ref_peak_vals = ref_rp.find_peaks(
        20 * np.log10(ref), ref_rp.range_bins, max_peaks=3
    )
    p_rng, p_vals, p_valid = ours_rp.find_peaks(
        20.0 * np.log10(ours + 1e-12), np.asarray(ours_rp.range_bins), max_peaks=3
    )
    ours_peaks = np.asarray(p_rng)[np.asarray(p_valid)]
    np.testing.assert_allclose(np.sort(ours_peaks), np.sort(ref_peak_bins), rtol=1e-5)


def test_range_doppler_parity(flagship_config, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.range_doppler_resp import (
        RangeDopplerProcessor as RefRD,
    )

    ref_rd = RefRD(ref_cfg)
    ours_rd = RangeDopplerProcessor(flagship_config)

    np.testing.assert_allclose(ours_rd.range_bins, ref_rd.range_bins, rtol=1e-12)
    np.testing.assert_allclose(ours_rd.vel_bins, ref_rd.vel_bins, rtol=1e-12, atol=1e-12)

    for rx_idx, mag in [(0, True), (-1, False), (3, True)]:
        ref = ref_rd.process(virtual_cube, rx_idx=rx_idx, return_magnitude=mag)
        ours = np.asarray(
            ours_rd.process(virtual_cube, rx_idx=rx_idx, return_magnitude=mag)
        )
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())


def test_range_angle_parity(flagship_config, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.range_angle_resp import (
        RangeAngleProcessor as RefRA,
    )

    ref_ra = RefRA(ref_cfg, num_angle_bins=64)
    ours_ra = RangeAngleProcessor(flagship_config, num_angle_bins=64)

    np.testing.assert_allclose(ours_ra.range_bins, ref_ra.range_bins, rtol=1e-9)
    np.testing.assert_allclose(ours_ra.angle_bins, ref_ra.angle_bins, rtol=1e-12)
    np.testing.assert_allclose(ours_ra.x_s, ref_ra.x_s, rtol=1e-6)

    for rx in ([0, 3, 4, 7], []):
        ref = ref_ra.process(virtual_cube, chirp_idx=0, rx_antennas=np.array(rx, int))
        ours = np.asarray(ours_ra.process(virtual_cube, chirp_idx=0, rx_antennas=rx))
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4 * ref.max())


def test_doppler_azimuth_coarse_parity(flagship_config, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.doppler_azimuth_resp import (
        DopplerAzimuthProcessor as RefDA,
    )

    ref_da = RefDA(ref_cfg, num_angle_bins=64)
    ours_da = DopplerAzimuthProcessor(flagship_config, num_angle_bins=64)

    np.testing.assert_allclose(ours_da.vel_bins, ref_da.vel_bins, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours_da.valid_angle_bins, ref_da.valid_angle_bins)

    for rx, window, shift in [
        ([0, 3, 4, 7], [0.9, 2.0], True),
        ([1, 2, 5, 6], [0.5, 3.0], True),
        ([9, 8, 5, 4], [], False),
    ]:
        ref = ref_da.process(
            virtual_cube,
            rx_antennas=np.array(rx, int),
            range_window=np.array(window),
            shift_angle=shift,
        )
        ours = np.asarray(
            ours_da.process(
                virtual_cube,
                rx_antennas=rx,
                range_window=window if window else None,
                shift_angle=shift,
            )
        )
        np.testing.assert_allclose(ours, ref, rtol=3e-4, atol=3e-4 * ref.max())


def test_doppler_azimuth_precise_parity(flagship_config, ref_cfg, virtual_cube):
    from mmwave_radar_processing.processors.doppler_azimuth_resp import (
        DopplerAzimuthProcessor as RefDA,
    )

    ref_da = RefDA(ref_cfg, num_angle_bins=64)
    ours_da = DopplerAzimuthProcessor(flagship_config, num_angle_bins=64)

    vel_range = [-0.25, 0.25]
    ref = ref_da.process(
        virtual_cube,
        rx_antennas=np.array([0, 3, 4, 7], int),
        range_window=np.array([0.9, 2.0]),
        shift_angle=True,
        use_precise_fft=True,
        precise_vel_range=np.array(vel_range),
    )
    ours, bins, row_valid = ours_da.process(
        virtual_cube,
        rx_antennas=[0, 3, 4, 7],
        range_window=[0.9, 2.0],
        shift_angle=True,
        use_precise_fft=True,
        precise_vel_range=vel_range,
    )
    ours = np.asarray(ours)
    assert np.asarray(row_valid).all()  # both sides present for this band
    np.testing.assert_allclose(np.asarray(bins), ref_da.zoomed_vel_bins, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=3e-3, atol=3e-3 * ref.max())


def test_micro_doppler_parity(flagship_config, ref_cfg, virtual_cube, flagship_cfg_path):
    from mmwave_radar_processing.processors.micro_doppler_resp import (
        MicroDopplerProcessor as RefMD,
    )

    ref_md = RefMD(ref_cfg, target_ranges=[0.5, 2.0], num_frames_history=5)
    ours_md = MicroDopplerProcessor(
        flagship_config, target_ranges=[0.5, 2.0], num_frames_history=5
    )

    for i in range(4):
        cube_i = virtual_cube * np.exp(1j * 0.1 * i)
        ref = ref_md.process(cube_i, rx_idx=0)
        ours = np.asarray(ours_md.process(cube_i, rx_idx=0))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4 * ref.max())


def test_altimeter_parity(flagship_config, ref_cfg):
    from mmwave_radar_processing.processors.altimeter import Altimeter as RefAlt

    params = dict(
        min_altitude_m=0.25,
        zoom_search_region_m=0.2,
        altitude_search_limit_m=0.4,
        range_bias=0.0,
    )
    ref_alt = RefAlt(ref_cfg, **params)
    ours_alt = Altimeter(flagship_config, **params)

    rng = np.random.default_rng(3)
    for step, alt in enumerate([0.6, 0.65, 0.72, 0.70]):
        scene = Scene(
            targets=[PointTarget(range_m=alt, rcs=4.0),
                     PointTarget(range_m=2.2, rcs=1.0)],
            noise_sigma=0.02,
        )
        cube = simulate_frame(flagship_config, scene, rng).astype(np.complex128)
        ref_out = ref_alt.process(cube, precise_est_enabled=True)
        ours_out = float(ours_alt.process(cube, precise_est_enabled=True))
        assert abs(ours_out - ref_out) < 5e-3, (step, ours_out, ref_out)
        assert abs(ours_out - alt) < 0.1


def test_cfar_detector_parity(ref_cfg, virtual_cube, flagship_config):
    """CFAR objects vs reference detectors on a real range-Doppler map."""
    from mmwave_radar_processing.detectors.detector_registry import (
        get_detector_registry as ref_registry,
    )

    from mmwave_radar_processing_jax.detectors import get_detector_registry

    rd = RangeDopplerProcessor(flagship_config)
    rd_map = np.asarray(rd.process(virtual_cube, rx_idx=0, return_magnitude=True))
    rng_profile = np.asarray(RangeProcessor(flagship_config).process(virtual_cube))

    cases = [
        ("ca_cfar_1d", dict(num_train=8, num_guard=3, pfa=1e-3), rng_profile),
        ("os_cfar_1d", dict(num_train=5, num_guard=3, rho=0.5, alpha=2.0), rng_profile),
        ("go_cfar_1d", dict(num_train=6, num_guard=2, pfa=1e-3), rng_profile),
        ("so_cfar_1d", dict(num_train=6, num_guard=2, pfa=1e-3), rng_profile),
        ("ca_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3), rd_map),
        ("os_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=2.0), rd_map),
    ]
    for name, params, signal in cases:
        ref_det = ref_registry()[name](**params)
        ours_det = get_detector_registry()[name](**params)
        ref_out = ref_det.detect(signal)
        ours_out = ours_det.detect(signal)
        assert list(map(tuple, np.atleast_2d(ref_out))) == list(
            map(tuple, np.atleast_2d(ours_out))
        ) or ref_out == ours_out, name
        np.testing.assert_allclose(
            np.asarray(ours_det.noise_estimates),
            ref_det.noise_estimates,
            rtol=1e-4,
            atol=1e-6,
        )
