"""Doppler beam sharpening (DBS) enhanced range-angle processing.

Re-design of ``processors/range_angle_resp_dbs_enhanced.py``: the 3D
windowed FFT (range -> Doppler -> zero-padded angle) is one fused kernel, and
the reference's per-output-angle Python loop (:216-263) — select the Doppler
bin matching the expected ground Doppler ``vd = -r_hat . v`` at each look
angle — becomes a single vectorized gather with traced velocity.  The
low-speed fallback to the plain range-angle response (:308-342) is a host-side
branch in the object API (the gate compares a runtime velocity to a static
threshold, exactly like the reference).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import windows
from mmwave_radar_processing_jax.processors.range_angle import RangeAngleProcessor


@partial(jax.jit, static_argnames=("num_angle_bins",))
def windowed_3d_fft(adc_cube: jax.Array, *, num_angle_bins: int) -> jax.Array:
    """Hann-windowed 3D FFT ``[angle, range, doppler]`` (reference :137-198).

    Range FFT along samples, shifted Doppler FFT along chirps, then an angle
    window over the *input* antennas, zero-padding to ``num_angle_bins`` and a
    shifted FFT along the antenna axis.
    """
    rx, ns, nc = adc_cube.shape[-3:]
    rng_win = jnp.asarray(windows.hanning(ns))[:, None]
    rng_resp = jnp.fft.fft(adc_cube * rng_win, axis=-2)

    vel_win = jnp.asarray(windows.hanning(nc))
    rng_dop = jnp.fft.fftshift(jnp.fft.fft(rng_resp * vel_win, axis=-1), axes=-1)

    ang_win = jnp.asarray(windows.hanning(rx))[:, None, None]
    padded = jnp.pad(
        rng_dop * ang_win,
        [(0, 0)] * (adc_cube.ndim - 3) + [(0, num_angle_bins - rx), (0, 0), (0, 0)],
    )
    return jnp.fft.fftshift(jnp.fft.fft(padded, axis=-3), axes=-3)


@jax.jit
def dbs_sharpen(
    angle_rng_dop_mag: jax.Array,
    velocity_ned: jax.Array,
    dbs_angle_bins: jax.Array,
    coarse_angle_bins: jax.Array,
    vel_bins: jax.Array,
) -> jax.Array:
    """Gather ``resp[nearest coarse angle, :, nearest Doppler bin]`` per angle.

    Returns the sharpened ``[range, dbs_angle]`` map (reference :200-263).
    """
    r_hat = jnp.stack(
        [jnp.cos(dbs_angle_bins), jnp.sin(dbs_angle_bins)], axis=1
    )  # unit by construction (z=0 row contributes nothing)
    dop_vel = -(r_hat @ velocity_ned[:2])  # [n_dbs]
    vel_idx = jnp.argmin(
        jnp.abs(vel_bins[None, :] - dop_vel[:, None]), axis=1
    )
    ang_idx = jnp.argmin(
        jnp.abs(coarse_angle_bins[None, :] - dbs_angle_bins[:, None]), axis=1
    )
    gathered = angle_rng_dop_mag[ang_idx, :, vel_idx]  # [n_dbs, range]
    return gathered.T


class RangeAngleProcessorDBSEnhanced(RangeAngleProcessor):
    """Range-angle heatmap with Doppler beam sharpening above a speed gate."""

    def __init__(
        self,
        config: RadarConfig,
        num_angle_bins_range_angle_response: int = 64,
        num_angle_bins_dbs_enhanced_response: int = 64,
        min_x_y_vel_dbs: float = 0.25,
        **kwargs,
    ):
        super().__init__(config, num_angle_bins=num_angle_bins_range_angle_response)
        self.num_angle_bins_dbs_enhanced_response = num_angle_bins_dbs_enhanced_response
        self.min_vel_dbs = min_x_y_vel_dbs
        self.vel_bins = grids.vel_bins(config)
        self.angle_bins_no_dbs_enhancement = self.angle_bins.copy()
        self.angle_bins_dbs_enhanced = np.linspace(
            self.angle_bins_no_dbs_enhancement[0],
            self.angle_bins_no_dbs_enhancement[-1],
            num_angle_bins_dbs_enhanced_response,
        )
        self.compute_mesh_grid()

    # mesh switching (reference :91-109) ------------------------------- #
    def compute_mesh_grid(self) -> None:
        self.angle_bins = self.angle_bins_no_dbs_enhancement
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins
        )

    def compute_mesh_grid_dbs_enhanced(self) -> None:
        self.angle_bins = self.angle_bins_dbs_enhanced
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins
        )

    def get_dop_vel(self, angle: float, ego_vel: np.ndarray) -> float:
        """Expected ground Doppler at a look angle (reference :200-214)."""
        r = np.array([np.cos(angle), np.sin(angle), 0.0])
        return float(-(r / np.linalg.norm(r)) @ np.asarray(ego_vel))

    def process_no_dbs(self, adc_cube, chirp_idx=0, rx_antennas=None, **kwargs):
        self.compute_mesh_grid()
        return super().process(
            adc_cube, chirp_idx=chirp_idx, rx_antennas=rx_antennas, **kwargs
        )

    def process_dbs_enhanced(
        self,
        adc_cube: jax.Array,
        velocity_ned,
        rx_antennas: Optional[Sequence[int]] = None,
        **kwargs,
    ):
        """DBS-sharpened ``[range, dbs_angle]`` response (reference :318-342)."""
        self.compute_mesh_grid_dbs_enhanced()
        if rx_antennas is not None and len(rx_antennas) > 0:
            adc_cube = adc_cube[np.asarray(rx_antennas, int), :, :]
        mag = jnp.abs(
            windowed_3d_fft(adc_cube, num_angle_bins=self.num_angle_bins)
        )
        return dbs_sharpen(
            mag,
            jnp.asarray(velocity_ned, jnp.float32),
            jnp.asarray(self.angle_bins_dbs_enhanced),
            jnp.asarray(self.angle_bins_no_dbs_enhancement),
            jnp.asarray(self.vel_bins),
        )

    def process(
        self,
        adc_cube: jax.Array,
        velocity_ned,
        rx_antennas: Optional[Sequence[int]] = None,
        chirp_idx: int = 0,
        **kwargs,
    ):
        """DBS when moving fast enough, plain range-angle otherwise."""
        velocity_ned = np.asarray(velocity_ned, float)
        if np.linalg.norm(velocity_ned[0:2]) < self.min_vel_dbs:
            return self.process_no_dbs(
                adc_cube, chirp_idx=chirp_idx, rx_antennas=rx_antennas, **kwargs
            )
        return self.process_dbs_enhanced(
            adc_cube, velocity_ned, rx_antennas=rx_antennas, **kwargs
        )
