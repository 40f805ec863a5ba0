"""Pure jittable compute kernels for mmWave radar processing on the accelerator.

Everything here is shape-static, functional, and safe to ``jax.jit`` /
``jax.vmap`` / ``shard_map``:

- :mod:`~mmwave_radar_processing_jax.ops.windows` — spectral window constants.
- :mod:`~mmwave_radar_processing_jax.ops.czt` — chirp-z transform (zoom FFT as
  two FFTs + pointwise products, Bluestein's algorithm).
- :mod:`~mmwave_radar_processing_jax.ops.peaks` — vectorized local-maxima +
  prominence peak finding with fixed-capacity padded outputs.
- :mod:`~mmwave_radar_processing_jax.ops.cfar` — CA/GO/SO/OS CFAR threshold
  maps (1D/2D) as vectorized gather + reduce/sort.
- :mod:`~mmwave_radar_processing_jax.ops.beamform` — Capon/Bartlett
  covariance beamforming spectra as split-complex matmuls.
- :mod:`~mmwave_radar_processing_jax.ops.ransac` — deterministic vmapped
  fixed-trial RANSAC with closed-form least squares.
- :mod:`~mmwave_radar_processing_jax.ops.masked` — utilities for fixed-capacity
  masked detection sets (the jit-friendly replacement for dynamic-length lists).
"""

from mmwave_radar_processing_jax.ops import (
    beamform,
    czt,
    cfar,
    masked,
    peaks,
    ransac,
    windows,
)

__all__ = ["beamform", "czt", "cfar", "masked", "peaks", "ransac", "windows"]
