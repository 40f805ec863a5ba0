"""Point-cloud post-processing: ego-velocity estimation from radar points.

Re-design of the reference ``point_cloud_processing/`` package:
RANSAC-robust least squares over ``(x, y, z, vel)`` detections, run as
deterministic vmapped hypothesis batches.
"""

from mmwave_radar_processing_jax.point_cloud_processing.vel_estimator import (
    VelocityEstimator,
)
from mmwave_radar_processing_jax.point_cloud_processing.vehicle_vel_estimator import (
    VehicleVelEstimator,
)

__all__ = ["VelocityEstimator", "VehicleVelEstimator"]
