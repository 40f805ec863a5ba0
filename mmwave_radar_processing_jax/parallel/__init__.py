"""Multi-chip sharding layer: mesh pipelines, halos, beamforming collectives.

The reference is single-process numpy with no parallelism (SURVEY.md §2.13);
the natural parallel axes of the domain are frames (batch), virtual channels,
range/Doppler bins, and steering angles.  This package makes them first-class:

- :mod:`~mmwave_radar_processing_jax.parallel.mesh` — mesh construction and
  named-sharding helpers.
- :mod:`~mmwave_radar_processing_jax.parallel.pipeline` — the fused
  frame-batched radar pipeline (reformat -> range-Doppler -> CFAR -> AoA ->
  point cloud) sharded over the ``data`` (frames) axis.
- :mod:`~mmwave_radar_processing_jax.parallel.halo_cfar` — ``shard_map`` CFAR
  with guard/train halo exchange over a sharded range axis (``ppermute``).
- :mod:`~mmwave_radar_processing_jax.parallel.sharded_beamform` — synthetic-
  aperture beamforming with elements sharded over the ``model`` axis and a
  ``psum`` over partial element sums; snapshot-sharded Capon covariance.
- :mod:`~mmwave_radar_processing_jax.parallel.capon_pipeline` — fused
  frame-batched Capon/Bartlett range-azimuth heatmap pipeline.
- :mod:`~mmwave_radar_processing_jax.parallel.overlap_save` — sample-axis-
  sharded spectral zoom (demod -> FIR -> decimate -> zoom DFT) with
  overlap-save boundary exchange, bit-identical to the unsharded op.
"""

from mmwave_radar_processing_jax.parallel.mesh import make_mesh
from mmwave_radar_processing_jax.parallel.pipeline import (
    PointCloudBatch,
    build_point_cloud_pipeline,
    shard_pipeline,
)
from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
    VelocityBatch,
    build_velocity_pipeline,
)
from mmwave_radar_processing_jax.parallel.beamform_pipeline import (
    build_synthetic_aperture_pipeline,
)
from mmwave_radar_processing_jax.parallel.capon_pipeline import (
    build_capon_pipeline,
)
from mmwave_radar_processing_jax.parallel.spectral_pipeline import (
    SpectralMaps,
    build_dbs_pipeline,
    build_micro_doppler_pipeline,
    build_spectral_maps_pipeline,
)
from mmwave_radar_processing_jax.parallel.overlap_save import (
    build_sharded_zoom_fir,
)

__all__ = [
    "make_mesh",
    "PointCloudBatch",
    "build_point_cloud_pipeline",
    "shard_pipeline",
    "VelocityBatch",
    "build_velocity_pipeline",
    "build_synthetic_aperture_pipeline",
    "build_capon_pipeline",
    "SpectralMaps",
    "build_dbs_pipeline",
    "build_micro_doppler_pipeline",
    "build_spectral_maps_pipeline",
    "build_sharded_zoom_fir",
]
