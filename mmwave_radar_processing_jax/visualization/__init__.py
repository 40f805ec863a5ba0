"""Visualization stack: processor registry + MVC controller + views.

Re-design of the reference's PyQt6 GUI architecture (``visualization/``,
``docs/GUI.md``) with the Qt dependency made optional:

- :mod:`~mmwave_radar_processing_jax.visualization.processor_registry` — the
  ``ProcessorSpec`` dataclass + default registry of 12 processors with their
  view pairings and payload contracts.
- :mod:`~mmwave_radar_processing_jax.visualization.controller` — the playback
  controller (dataset/config models, per-frame processor fan-out, payload
  emission) implemented with plain observer callbacks so the full pipeline is
  headless-testable; a Qt shell can subscribe to the same callbacks.
- :mod:`~mmwave_radar_processing_jax.visualization.views` — matplotlib-backed
  view classes implementing the reference payload protocol
  (``set_data -> update_view``, dB toggling, detection overlays).
- :mod:`~mmwave_radar_processing_jax.visualization.video_exporter` — drives
  the controller frame by frame and encodes the rendered views to mp4.
"""

from mmwave_radar_processing_jax.visualization.processor_registry import (
    ProcessorSpec,
    get_default_registry,
)
from mmwave_radar_processing_jax.visualization.controller import (
    ConfigModel,
    DatasetModel,
    MmWaveRadarProcessorController,
)

# reference-name alias (ref backends/mmwave_radar_processor_controller.py:22)
mmWaveRadarProcessorController = MmWaveRadarProcessorController

__all__ = [
    "mmWaveRadarProcessorController",
    "ProcessorSpec",
    "get_default_registry",
    "ConfigModel",
    "DatasetModel",
    "MmWaveRadarProcessorController",
]
