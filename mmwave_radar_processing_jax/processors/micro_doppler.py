"""Micro-Doppler spectrogram: per-frame Doppler slice + shift-register history.

Re-design of the reference ``MicroDopplerProcessor``
(``processors/micro_doppler_resp.py``): the per-frame 2D FFT + range-gated max
is a pure function; the ``num_frames_history``-column spectrogram is an
explicit state array threaded through :func:`step`, so a whole recording can be
processed with one ``lax.scan`` instead of Python-side mutation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.processors.base import Processor


@jax.jit
def micro_doppler_column(rx_slice: jax.Array, range_mask: jax.Array) -> jax.Array:
    """One spectrogram column: max over gated range bins of the RD magnitude.

    Args:
        rx_slice: ``[samples, chirps]`` complex, one RX antenna.
        range_mask: ``[samples]`` bool, range bins to keep.

    Returns:
        ``[chirps]`` float column.

    Reference :97-107 — note no windows are applied and only the Doppler axis
    is fftshifted.
    """
    resp = jnp.abs(jnp.fft.fftshift(jnp.fft.fft2(rx_slice, axes=(-2, -1)), axes=-1))
    gated = jnp.where(range_mask[:, None], resp, -jnp.inf)
    return jnp.max(gated, axis=-2)


@jax.jit
def shift_in_column(history: jax.Array, column: jax.Array) -> jax.Array:
    """Shift-register update: newest column at index 0 (reference :110-113)."""
    return jnp.concatenate([column[:, None], history[:, :-1]], axis=1)


class MicroDopplerProcessor(Processor):
    """Velocity-vs-time spectrogram processor with explicit state."""

    def __init__(
        self,
        config: RadarConfig,
        target_ranges=(0.0, 1.0),
        num_frames_history: int = 20,
        **kwargs,
    ):
        super().__init__(config)
        target_ranges = np.asarray(target_ranges, dtype=float)
        self.vel_bins = grids.vel_bins(config)
        self.range_bins = grids.range_bins(config, variant="eps")
        self.num_frames_history = num_frames_history
        self.target_ranges = target_ranges
        self.range_mask = np.logical_and(
            self.range_bins >= target_ranges[0], self.range_bins <= target_ranges[1]
        )
        self.time_bins = grids.time_bins(config, num_frames_history)
        self.micro_doppler_resp = self.init_state()

    def init_state(self) -> jax.Array:
        """Zeroed spectrogram ``[vel_bins, num_frames_history]``."""
        return jnp.zeros((self.vel_bins.shape[0], self.num_frames_history), jnp.float32)

    def step(self, state: jax.Array, adc_cube: jax.Array, rx_idx: int = 0):
        """Functional update: ``(state, frame) -> (state, state)``."""
        col = micro_doppler_column(adc_cube[..., rx_idx, :, :], jnp.asarray(self.range_mask))
        new_state = shift_in_column(state, col)
        return new_state, new_state

    def scan(self, adc_frames: jax.Array, rx_idx: int = 0):
        """Process ``[frames, rx, samples, chirps]`` with one ``lax.scan``.

        Returns the final state and the per-frame spectrogram stack.
        """
        def body(state, frame):
            return self.step(state, frame, rx_idx=rx_idx)

        return jax.lax.scan(body, self.init_state(), adc_frames)

    def process(self, adc_cube: jax.Array, rx_idx: int = 0, **kwargs) -> jax.Array:
        """Stateful one-frame update (reference-compatible mutating API)."""
        self.micro_doppler_resp, out = self.step(
            self.micro_doppler_resp, adc_cube, rx_idx=rx_idx
        )
        return out

    def reset(self) -> None:
        self.micro_doppler_resp = self.init_state()
        super().reset()
