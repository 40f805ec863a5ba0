"""Standalone points-based ego-velocity estimator.

Re-design of ``point_cloud_processing/vel_estimator.py``: the headline
RadVel estimator used by the analysis scripts
(``scripts/test_vel_estimation.py:119,154``).  Fits ``-vel = (p/|p|) . v``
with RANSAC over the point cloud — 2D (x, y) for the standard geometry, 3D
for ODS — and keeps the last gate-passing estimate (reference :172-181).

Accepts either a plain ``(N, 4)`` array or a fixed-capacity padded
``(points, valid)`` pair, so it can sit at the end of a fully jitted
device pipeline.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.ops.ransac import RansacResult, ransac_linear
from mmwave_radar_processing_jax.processors.base import Processor


def ego_vel_from_points(
    points: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    *,
    dims: int,
    min_samples: int = 10,
    residual_threshold: float = 0.15,
    max_trials: int = 20,
) -> RansacResult:
    """Pure kernel: RANSAC ego-velocity from padded ``(K, 4)`` points.

    ``dims=2`` fits (vx, vy) from (x, y); ``dims=3`` also vz
    (reference :76-170).
    """
    p = points[:, :dims]
    norm = jnp.linalg.norm(p, axis=1, keepdims=True)
    h = p / jnp.maximum(norm, 1e-12)
    y = -points[:, 3]
    return ransac_linear(
        h, y, valid,
        key,
        min_samples=min_samples,
        residual_threshold=residual_threshold,
        max_trials=max_trials,
    )


class VelocityEstimator(Processor):
    """Points-only ego-velocity estimator with R^2 / inlier gating."""

    def __init__(
        self,
        config: RadarConfig,
        min_R2_threshold: float = 0.6,
        min_inlier_percent: float = 0.75,
        seed: int = 42,
        **kwargs,
    ):
        super().__init__(config)
        self.min_R2_threshold = min_R2_threshold
        self.min_inlier_percent = min_inlier_percent
        self._key = jax.random.PRNGKey(seed)
        self.estimated_R2 = 0.0
        self.inlier_percent = 0.0
        self.proposed_velocity_estimate = np.empty(0)
        self.current_velocity_estimate = np.array([0.0, 0.0, 0.0])
        self.history_R2_statistics = []
        self.history_inlier_statistics = []

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def estimate_ego_velocity_points(self, points: np.ndarray, valid=None):
        dims = 2 if self.config.array_geometry == "standard" else 3
        points = np.asarray(points, float)
        if valid is None:
            valid = np.ones(points.shape[0], bool)
        res = ego_vel_from_points(
            jnp.asarray(points), jnp.asarray(valid), self._next_key(), dims=dims
        )
        self.estimated_R2 = float(res.r2)
        self.inlier_percent = float(res.inlier_fraction)
        vel = np.asarray(res.coef)
        if dims == 2:
            self.proposed_velocity_estimate = np.array([vel[0], vel[1], 0.0])
        else:
            self.proposed_velocity_estimate = vel

    def update_and_check_current_vel_measurements(self):
        """Keep the last estimate unless the new one passes both gates."""
        if (
            self.estimated_R2 >= self.min_R2_threshold
            and self.inlier_percent >= self.min_inlier_percent
        ):
            self.current_velocity_estimate = self.proposed_velocity_estimate.copy()

    def update_history(self, estimated=None, ground_truth=None):
        self.history_R2_statistics.append(self.estimated_R2)
        self.history_inlier_statistics.append(self.inlier_percent)
        super().update_history(estimated, ground_truth)

    def process(self, points: Optional[np.ndarray] = None, valid=None, **kwargs):
        """Velocity estimate ``[vx, vy, vz]`` (reference ``process`` :215-243)."""
        if points is not None and np.size(points) > 0:
            self.estimate_ego_velocity_points(points, valid)
        self.update_and_check_current_vel_measurements()
        return self.current_velocity_estimate

    def reset(self):
        self.history_R2_statistics = []
        self.history_inlier_statistics = []
        super().reset()
