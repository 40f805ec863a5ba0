"""Range-azimuth heatmap: windowed 2D FFT over (sample, antenna).

Re-design of the reference ``RangeAngleProcessor``
(``processors/range_angle_resp.py``): antenna selection and zero padding to
``num_angle_bins`` are static-shape ops; the angle grid is the reference's
quirky ``arcsin(delta_phi/pi)`` convention from
:mod:`mmwave_radar_processing_jax.config.grids`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import windows
from mmwave_radar_processing_jax.processors.base import Processor


@partial(jax.jit, static_argnames=("num_angle_bins", "window"))
def range_angle_map(
    chirp_slice: jax.Array, *, num_angle_bins: int, window: bool = True
) -> jax.Array:
    """Range-azimuth magnitude map from one chirp.

    Args:
        chirp_slice: ``[..., rx, samples]`` complex (antennas already selected).

    Returns:
        ``[..., samples, num_angle_bins]`` float magnitude, angle axis
        fftshifted (reference :104-120).
    """
    rx, ns = chirp_slice.shape[-2], chirp_slice.shape[-1]
    if window:
        w = jnp.asarray(
            windows.outer_window(windows.hanning(rx), windows.hanning(ns))
        )
        chirp_slice = chirp_slice * w
    # [..., samples, rx] zero-padded to [..., samples, num_angle_bins]
    data = jnp.swapaxes(chirp_slice, -1, -2)
    pad = [(0, 0)] * (data.ndim - 1) + [(0, num_angle_bins - rx)]
    data = jnp.pad(data, pad)
    resp = jnp.fft.fftshift(jnp.fft.fft2(data, axes=(-2, -1)), axes=-1)
    return jnp.abs(resp)


class RangeAngleProcessor(Processor):
    """Range-azimuth heatmap processor (reference-compatible API)."""

    def __init__(self, config: RadarConfig, num_angle_bins: int = 64, **kwargs):
        super().__init__(config)
        self.num_angle_bins = num_angle_bins
        self.num_range_bins = config.num_adc_samples
        self.range_bins = grids.range_bins(config, variant="offset")
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins
        )

    def process(
        self,
        adc_cube: jax.Array,
        chirp_idx: int = 0,
        rx_antennas: Optional[Sequence[int]] = None,
        perform_windowing: bool = True,
        **kwargs,
    ) -> jax.Array:
        """Range-azimuth response ``[range_bins, angle_bins]`` (reference :68-122).

        Note the reference windows over the *full* antenna axis before
        selecting ``rx_antennas``; that behavior is preserved.
        """
        if perform_windowing:
            rx, ns = adc_cube.shape[-3], adc_cube.shape[-2]
            w = windows.outer_window(windows.hanning(rx), windows.hanning(ns))
            adc_cube = adc_cube * jnp.asarray(w)[..., None]
        if rx_antennas is not None and len(rx_antennas) > 0:
            adc_cube = adc_cube[..., np.asarray(rx_antennas, dtype=int), :, :]
        return range_angle_map(
            adc_cube[..., :, :, chirp_idx],
            num_angle_bins=self.num_angle_bins,
            window=False,
        )
