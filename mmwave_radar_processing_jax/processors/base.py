"""Processor base: config-bound objects over pure jitted kernels.

The reference's ``_Processor`` ABC (``processors/_processor.py:6-64``) couples
configuration, mutable per-frame state, and history tracking into one object.
Here those concerns are split so the compute path stays functional:

- configuration is an immutable :class:`RadarConfig` + precomputed numpy
  constants (bin grids, windows) bound at construction;
- per-frame state is an explicit pytree threaded through ``step``;
- estimate/ground-truth histories live host-side in plain lists (they feed the
  analysis layer, never the device path).
"""

from __future__ import annotations

from typing import List

import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig


class Processor:
    """Config-bound processor with host-side history tracking."""

    def __init__(self, config: RadarConfig):
        if config.range_res_m <= 0:
            config = config.derive()
        self.config = config
        self.history_estimated: List[np.ndarray] = []
        self.history_gt: List[np.ndarray] = []

    def update_history(self, estimated=None, ground_truth=None) -> None:
        """Append one (estimate, ground truth) pair for later analysis."""
        if estimated is not None:
            self.history_estimated.append(np.asarray(estimated))
        if ground_truth is not None:
            self.history_gt.append(np.asarray(ground_truth))

    def reset(self) -> None:
        self.history_estimated = []
        self.history_gt = []
