"""Hand-written Pallas kernels for the GPU (Triton route).

- :mod:`~mmwave_radar_processing_jax.ops.pallas.doppler_az` — the fused
  Doppler-azimuth response stage of the velocity pipeline.
"""
