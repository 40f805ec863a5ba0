"""Config layer: parsing + derived performance parameters + bin grids.

Golden values are the reference formulas (cfgManager.py:113-158) evaluated by
hand for the flagship 6843 ODS 20 Hz config; when the upstream checkout is
present we additionally compare against its live ConfigManager on every
shipped config file.
"""

import glob
import os
import sys

import numpy as np
import pytest

from mmwave_radar_processing_jax.config import ConfigManager, grids, load_cfg
from tests.conftest import REFERENCE_ROOT, requires_reference

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_flagship_derived_params(flagship_config):
    cfg = flagship_config
    # profileCfg 0 60 150 7 44.0 0 0 80.0 1 63 2100 0 0 158 / frameCfg 0 2 70 0 50 1 0
    assert cfg.num_rx_antennas == 4
    assert cfg.num_tx_antennas == 3
    assert cfg.num_adc_samples == 63
    assert cfg.frame.loops == 70
    assert cfg.chirp_cfgs_per_loop == 3
    assert cfg.num_virtual_antennas == 12
    assert cfg.virtual_antennas_enabled
    c = 299_792_458.0
    fs = 2100e3
    slope = 80e12
    np.testing.assert_allclose(cfg.range_res_m, c * fs / (2 * slope * 63), rtol=1e-12)
    np.testing.assert_allclose(cfg.range_max_m, c * fs / (2 * slope), rtol=1e-12)
    lam = c / 60e9
    tc = 194e-6  # idle 150 + ramp 44 us
    np.testing.assert_allclose(cfg.vel_max_m_s, lam / (4 * tc * 3), rtol=1e-12)
    np.testing.assert_allclose(cfg.vel_res_m_s, lam / (2 * tc * 3 * 70), rtol=1e-12)
    # headline numbers from BASELINE.md
    assert abs(cfg.range_res_m - 0.0625) < 1e-3
    assert abs(cfg.range_max_m - 3.94) < 0.01
    assert abs(cfg.vel_max_m_s - 2.15) < 0.01
    assert abs(cfg.vel_res_m_s - 0.061) < 0.001


def test_grid_shapes(flagship_config):
    cfg = flagship_config
    for variant in ("plain", "eps", "offset", "linspace"):
        assert grids.range_bins(cfg, variant).shape == (63,)
    assert grids.vel_bins(cfg).shape == (70,)
    ab = grids.angle_bins(64)
    assert ab.shape == (64,)
    np.testing.assert_allclose(ab[0], np.pi / 2)
    np.testing.assert_allclose(ab[-1], -np.pi / 2)
    assert np.all(np.diff(ab) < 0)
    assert grids.time_bins(cfg, 20).shape == (20,)


def test_config_manager_facade(flagship_cfg_path):
    mgr = ConfigManager()
    mgr.load_cfg(flagship_cfg_path, array_geometry="ods", array_direction="down")
    mgr.compute_radar_perforance()  # reference-compatible (sic) API
    assert mgr.get_num_adc_samples() == 63
    assert mgr.frameCfg_loops == 70
    assert mgr.num_rx_antennas == 4
    assert mgr.array_geometry == "ods"
    assert mgr.profile_cfgs[0]["adcSamples"] == 63
    assert mgr.range_res_m > 0


@requires_reference
@pytest.mark.parametrize(
    "cfg_name", [os.path.basename(p) for p in sorted(glob.glob(os.path.join(CONFIG_DIR, "*.cfg")))]
)
def test_parity_vs_reference_config_manager(cfg_name):
    """Cross-check our derived params against the live upstream ConfigManager."""
    sys.path.insert(0, REFERENCE_ROOT)
    try:
        from mmwave_radar_processing.config_managers.cfgManager import (
            ConfigManager as RefConfigManager,
        )
    finally:
        sys.path.pop(0)

    path = os.path.join(CONFIG_DIR, cfg_name)
    ref = RefConfigManager()
    ref.load_cfg(path)
    ours = load_cfg(path)

    np.testing.assert_allclose(ours.range_res_m, ref.range_res_m, rtol=1e-12)
    np.testing.assert_allclose(ours.range_bin_size_m, ref.range_bin_size_m, rtol=1e-12)
    np.testing.assert_allclose(ours.range_max_m, ref.range_max_m, rtol=1e-12)
    np.testing.assert_allclose(ours.vel_res_m_s, ref.vel_res_m_s, rtol=1e-12)
    np.testing.assert_allclose(ours.vel_max_m_s, ref.vel_max_m_s, rtol=1e-12)
    assert ours.num_rx_antennas == ref.num_rx_antennas
    assert ours.num_tx_antennas == ref.num_tx_antennas
    assert ours.virtual_antennas_enabled == ref.virtual_antennas_enabled
    assert ours.frame.loops == ref.frameCfg_loops
    assert ours.frame.start_index == ref.frameCfg_start_index
    assert ours.frame.end_index == ref.frameCfg_end_index


# --------------------------------------------------------------------------- #
# shipped config catalog
# --------------------------------------------------------------------------- #

REFERENCE_CATALOG_NAMES = [
    # every config name the reference ships (reference configs/ listing);
    # our catalog provides a fresh-designed profile under each name
    "1843_RaGNNarok.cfg", "1843_RaGNNarok_UAV_10m.cfg",
    "1843_RaGNNarok_UAV_50m.cfg", "1843_RaGNNarok_UAV_5m.cfg",
    "1843_RadVel.cfg", "1843_RadVel_10Hz.cfg", "1843_RadVel_10Hz_lr.cfg",
    "1843_RadVel_10Hz_lr_SAR.cfg", "1843_RadVel_20Hz.cfg",
    "1843_RadVel_5Hz.cfg", "1843_human_movement.cfg", "1843_vel_nav.cfg",
    "1843_vel_sr.cfg", "6843_RadVel_ods_10Hz.cfg", "6843_RadVel_ods_20Hz.cfg",
    "6843_RadVel_ods_5Hz.cfg", "6843_hand_ods_30Hz.cfg", "6843_vel_sr.cfg",
    "RadCloud.cfg", "RadCloud_original.cfg", "RadSAR.cfg",
    "RadSAR_1843_official.cfg", "RadSAR_6843_ods_altitude_10Hz_official.cfg",
    "RadSAR_lr.cfg", "RadarHD.cfg",
]


def test_catalog_covers_reference_names():
    shipped = {os.path.basename(p) for p in glob.glob(os.path.join(CONFIG_DIR, "*.cfg"))}
    missing = set(REFERENCE_CATALOG_NAMES) - shipped
    assert not missing, f"catalog missing reference config names: {sorted(missing)}"


@pytest.mark.parametrize(
    "cfg_name", [os.path.basename(p) for p in sorted(glob.glob(os.path.join(CONFIG_DIR, "*.cfg")))]
)
def test_catalog_config_self_consistent(cfg_name):
    """Every shipped config must be physically realizable and parseable."""
    cfg = load_cfg(os.path.join(CONFIG_DIR, cfg_name))
    p = cfg.profile(0)

    assert cfg.range_res_m > 0 and cfg.range_max_m > 0
    assert cfg.vel_res_m_s > 0 and cfg.vel_max_m_s > 0
    assert cfg.num_rx_antennas == 4
    # chirpCfg count matches the frameCfg loop window
    assert len(cfg.chirps) == cfg.chirp_cfgs_per_loop
    # each chirpCfg enables exactly one TX (TDM MIMO), all within the TX mask
    for chirp in cfg.chirps:
        assert bin(chirp.tx_mask).count("1") == 1
        assert chirp.tx_mask & cfg.tx_chan_mask == chirp.tx_mask
    # ADC sampling window fits inside the ramp
    sampling_us = p.adc_samples / (p.sample_rate_ksps * 1e3) * 1e6
    assert sampling_us <= p.ramp_end_time_us - p.adc_start_time_us + 1e-9
    # sweep bandwidth within a 4 GHz chirp
    assert p.freq_slope_mhz_us * p.ramp_end_time_us <= 4000 + 1e-9
    # active chirping fits inside the frame period
    active_ms = cfg.chirps_per_frame * cfg.chirp_period_us * 1e-3
    assert active_ms < cfg.frame.periodicity_ms
