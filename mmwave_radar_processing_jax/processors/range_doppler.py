"""Range-Doppler map: separable Hann windows + 2D FFT + Doppler fftshift.

Re-design of the reference ``RangeDopplerProcessor``
(``processors/range_doppler_resp.py``): the separable range/velocity windows
become one precomputed 2D constant fused into the FFT input, and the
``[rx, sample, chirp]`` cube is transformed for *all* RX at once — selecting a
single antenna afterwards is free, and detectors need the full complex cube
anyway (``range_doppler_detector.py:72-78``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import windows
from mmwave_radar_processing_jax.processors.base import Processor


@partial(jax.jit, static_argnames=("window",))
def range_doppler_map(adc_cube: jax.Array, *, window: bool = True) -> jax.Array:
    """Complex range-Doppler cube for all RX.

    Args:
        adc_cube: ``[..., rx, samples, chirps]`` complex.

    Returns:
        ``[..., rx, samples, chirps]`` complex, Doppler axis fftshifted
        (zero velocity centered), matching reference :95-103.
    """
    ns, nc = adc_cube.shape[-2], adc_cube.shape[-1]
    if window:
        w2d = jnp.asarray(windows.outer_window(windows.hanning(ns), windows.hanning(nc)))
        adc_cube = adc_cube * w2d
    return jnp.fft.fftshift(jnp.fft.fft2(adc_cube, axes=(-2, -1)), axes=-1)


class RangeDopplerProcessor(Processor):
    """Range-Doppler response processor (reference-compatible API)."""

    def __init__(self, config: RadarConfig, **kwargs):
        super().__init__(config)
        self.range_bins = grids.range_bins(config, variant="eps")
        self.vel_bins = grids.vel_bins(config)

    def process(
        self,
        adc_cube: jax.Array,
        rx_idx: int = 0,
        return_magnitude: bool = True,
        **kwargs,
    ) -> jax.Array:
        """Range-Doppler response.

        ``rx_idx >= 0`` selects one antenna, ``-1`` returns all (reference
        :71-110); ``return_magnitude`` toggles ``abs``.
        """
        resp = range_doppler_map(adc_cube)
        if return_magnitude:
            resp = jnp.abs(resp)
        if rx_idx >= 0:
            resp = resp[..., rx_idx, :, :]
        return resp
