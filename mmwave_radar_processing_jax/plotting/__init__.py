"""Presentation layer: matplotlib dashboards and movie export.

Host-side rendering of device-computed responses (reference ``plotting/``):

- :class:`PlotterMmWaveData` — per-frame heatmaps (range-azimuth cart/polar,
  range-Doppler, micro-Doppler, Doppler-azimuth, range profile, raw ADC) and
  the 2x3 compilation dashboard.
- :class:`PlotterOdometryData` — altimeter + velocity-vs-ground-truth panels.
- :class:`PlotterSyntheticArrayData` — synthetic-array geometry, beamformed
  slices, cartesian SAR image, array pattern, depth map.
- :class:`AnalysisPlotter` — error CDFs/histograms/time series/summaries.
- :class:`MovieGenerator` + subclasses — per-frame PNG rendering to mp4.
"""

from mmwave_radar_processing_jax.plotting.plotter_mmwave_data import PlotterMmWaveData
from mmwave_radar_processing_jax.plotting.plotter_odometry import PlotterOdometryData
from mmwave_radar_processing_jax.plotting.plotter_synthetic_array import (
    PlotterSyntheticArrayData,
)
from mmwave_radar_processing_jax.plotting.analysis_plotter import AnalysisPlotter
from mmwave_radar_processing_jax.plotting.movie_generator import (
    MovieGenerator,
    MmWaveDataMovieGenerator,
    OdometryMovieGenerator,
    SyntheticArrayMovieGenerator,
)

# reference-name aliases (ref movies_mmWave_data.py / movies_odometry.py /
# movies_synthetic_array_data.py class names) for drop-in migration
MovieGeneratorMmWaveData = MmWaveDataMovieGenerator
MovieGeneratorOdometry = OdometryMovieGenerator
MovieGeneratorSyntheticArrayData = SyntheticArrayMovieGenerator

__all__ = [
    "MovieGeneratorMmWaveData",
    "MovieGeneratorOdometry",
    "MovieGeneratorSyntheticArrayData",
    "PlotterMmWaveData",
    "PlotterOdometryData",
    "PlotterSyntheticArrayData",
    "AnalysisPlotter",
    "MovieGenerator",
    "MmWaveDataMovieGenerator",
    "OdometryMovieGenerator",
    "SyntheticArrayMovieGenerator",
]
