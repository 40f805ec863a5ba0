"""Radar configuration layer.

Parses TI mmWave-SDK CLI ``.cfg`` files into an immutable :class:`RadarConfig`
and derives radar performance parameters (range/velocity/angle resolution and
bin grids) eagerly at load time.  All derived grids are host ``numpy`` arrays:
they are *static* constants baked into traced/jitted device programs, never traced
values — this keeps every downstream kernel shape-static.

Reference behavior being matched: ``config_managers/cfgManager.py`` (parser
dispatch :210-264, performance formulas :105-169) in
davidmhunt/mmwave_radar_processing.
"""

from mmwave_radar_processing_jax.config.manager import (
    ChirpCfg,
    ConfigManager,
    ConfigNotLoaded,
    InvalidConfiguration,
    ProfileCfg,
    RadarConfig,
    load_cfg,
)
from mmwave_radar_processing_jax.config import grids

__all__ = [
    "ChirpCfg",
    "ConfigManager",
    "ConfigNotLoaded",
    "InvalidConfiguration",
    "ProfileCfg",
    "RadarConfig",
    "load_cfg",
    "grids",
]
