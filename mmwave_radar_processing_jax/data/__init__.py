"""Data layer: CPSL-dataset-compatible loading + synthetic FMCW simulation.

- :mod:`~mmwave_radar_processing_jax.data.simulator` — point-target FMCW scene
  simulator producing raw ADC cubes with known ground truth (the reference's
  sample dataset is not distributable, so synthetic scenes are the primary
  test/benchmark input).
- :mod:`~mmwave_radar_processing_jax.data.cpsl_dataset` — ``CpslDS``-equivalent
  NPY-folder reader with the call-site API reconstructed in SURVEY.md §2.11.
- :mod:`~mmwave_radar_processing_jax.data.prefetch` — host->device frame-batch
  prefetcher.
"""

from mmwave_radar_processing_jax.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_jax.data.simulator import (
    ArrayGeometry,
    PointTarget,
    Scene,
    ground_scene,
    simulate_frame,
    simulate_frames,
)

__all__ = [
    "CpslDS",
    "ArrayGeometry",
    "PointTarget",
    "Scene",
    "ground_scene",
    "simulate_frame",
    "simulate_frames",
]
