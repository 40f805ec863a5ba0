"""Doppler-domain strip-map SAR for linear platform motion.

Re-design of ``processors/strip_map_SAR_processor.py``: one windowless 2D
FFT over ``[sample, chirp]`` of a single RX, with the synthetic element
spacing ``d_rx = 2 * Tc * v`` recomputed from the current platform velocity
each frame.  The FFT runs on device for the full map; the velocity-dependent
valid range/angle crop is applied host-side exactly like the reference
(the crop bounds depend on runtime velocity, so a fused variant would mask
rather than slice).

Reference quirk kept for parity: the angle grid is
``arcsin(phase_shifts * lambda) / (2*pi*d_rx)`` — the ``arcsin`` is applied
*before* dividing by ``2*pi*d_rx`` (``strip_map_SAR_processor.py:119-121``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.processors.base import Processor
from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter


@jax.jit
def strip_map_fft(rx_slice: jax.Array) -> jax.Array:
    """Full 2D FFT of ``[sample, chirp]`` with Doppler fftshift (ref :181-189)."""
    return jnp.fft.fftshift(jnp.fft.fft2(rx_slice, axes=(-2, -1)), axes=-1)


class StripMapSARProcessor(Processor):
    """Strip-map SAR processor (reference-compatible API)."""

    def __init__(
        self,
        config: RadarConfig,
        az_angle_range_rad=np.deg2rad(np.array([-30.0, 30.0])),
        **kwargs,
    ):
        super().__init__(config)
        self.az_angle_range_rad = np.asarray(az_angle_range_rad, float)
        if config.virtual_antennas_enabled:
            self.virtual_array_reformatter = VirtualArrayReformatter(config)

        self.num_range_bins = config.num_adc_samples
        self.range_bins = np.linspace(0, config.range_max_m, self.num_range_bins)
        self.lambda_m = config.lambda_m
        self.chirps_per_frame = config.chirps_per_frame
        self.chirp_period_us = config.chirp_period_us
        self.phase_shifts = np.linspace(np.pi, -np.pi, config.frame.loops)

        # per-frame geometry (velocity dependent)
        self.angle_bins_rad: Optional[np.ndarray] = None
        self.valid_ranges_slice: Optional[slice] = None
        self.valid_angles_slice: Optional[slice] = None
        self.ground_range_bins: Optional[np.ndarray] = None
        self.ground_az_bins_rad: Optional[np.ndarray] = None
        self.thetas = self.rhos = self.x_s = self.y_s = None

    def configure_array_geometry(
        self, vel_m_per_s: float, sensor_height_m: float, max_SAR_distance: float
    ) -> None:
        """Recompute synthetic-array bins for the current velocity (ref :112-160)."""
        d_rx = 2.0 * self.chirp_period_us * 1e-6 * vel_m_per_s
        self.angle_bins_rad = np.arcsin(self.phase_shifts * self.lambda_m) / (
            2 * np.pi * d_rx
        )
        min_angle_idx = np.argmin(
            np.abs(self.angle_bins_rad - np.min(self.az_angle_range_rad))
        )
        max_angle_idx = np.argmin(
            np.abs(self.angle_bins_rad - np.max(self.az_angle_range_rad))
        )
        self.valid_angles_slice = slice(
            min(min_angle_idx, max_angle_idx), max(min_angle_idx, max_angle_idx)
        )
        self.ground_az_bins_rad = self.angle_bins_rad[self.valid_angles_slice]

        min_rng_idx = np.nonzero(self.range_bins > sensor_height_m)[0][0]
        max_rng_idx = np.nonzero(self.range_bins < max_SAR_distance)[0][-1]
        self.valid_ranges_slice = slice(min_rng_idx, max_rng_idx)
        self.ground_range_bins = np.sqrt(
            self.range_bins[self.valid_ranges_slice] ** 2 - d_rx**2
        )

        self.thetas, self.rhos = np.meshgrid(
            self.ground_az_bins_rad, self.ground_range_bins, indexing="xy"
        )
        self.x_s = self.rhos * np.cos(self.thetas)
        self.y_s = self.rhos * np.sin(self.thetas)

    def process(
        self,
        adc_cube: jax.Array,
        vel_m_per_s: float,
        sensor_height_m: float = 0.24,
        rx_index: int = 0,
        max_SAR_distance: float = 1.5,
        **kwargs,
    ) -> np.ndarray:
        """Cropped complex strip-map SAR image ``[ground_range, ground_angle]``."""
        if self.config.virtual_antennas_enabled:
            adc_cube = self.virtual_array_reformatter.process(adc_cube)
        self.configure_array_geometry(vel_m_per_s, sensor_height_m, max_SAR_distance)
        response = np.asarray(strip_map_fft(adc_cube[..., rx_index, :, :]))
        return response[..., self.valid_ranges_slice, self.valid_angles_slice]
