"""Analysis layer: error statistics for estimated-vs-ground-truth histories."""

from mmwave_radar_processing_jax.analysis.analyzers import BaseAnalyzer, VelocityAnalyzer

__all__ = ["BaseAnalyzer", "VelocityAnalyzer"]
