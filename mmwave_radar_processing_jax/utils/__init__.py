"""Support utilities: rotations, logging."""

from mmwave_radar_processing_jax.utils import rotations
from mmwave_radar_processing_jax.utils.logger import get_logger, setup_logger

__all__ = ["rotations", "get_logger", "setup_logger"]
