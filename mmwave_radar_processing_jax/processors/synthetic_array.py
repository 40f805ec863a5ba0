"""Multi-frame synthetic-aperture beamformer — the flagship matmul kernel.

Re-design of
``processors/simple_synthetic_array_beamformer_processor_multiFrame.py``.
The reference iterates a Python double loop over az x el steering angles, each
evaluating a phase-shifted sum over all synthetic elements plus a range FFT
(:570-583) — O(angles * elements * samples) in interpreter-space.  Here the
whole beamformer is:

    phases[A, E]   = exp(j*2*pi * (D[A, 3] @ P[3, E]) / lambda)   (A = az*el)
    beamformed     = (data[ns, E] * hamming[E]) @ phases.T        (one matmul)
    response       = FFT(hann[ns] * beamformed, axis=0)           (batched FFT)

i.e. one complex ``[ns, E] x [E, A]`` matmul that XLA tiles straight onto the
matmul, plus a batched range FFT.  Per-frame element positions, the velocity
consistency gate, and the phase self-calibration are expressed as pure
functions over an explicit ring-buffer state so recordings run under
``lax.scan``.

Component map to the reference:
- velocity gate         ``_update_vel_history``        (:332-375)
- backward-chained geometry ``_update_array_geometries`` (:377-471)
- steering vectors       ``_compute_beam_stearing_vectors`` (:474-488)
- beamforming            ``compute_synthetic_response``  (:499-585)
- array factor/pattern   ``compute_synthetic_array_pattern`` (:615-670)
- self-calibration       ``perform_array_calibration``   (:673-816)
- cartesian interpolation ``get_interpolated_response_cart`` (:587-613),
  implemented as precomputed bilinear gather weights instead of
  ``scipy.griddata`` so it also runs on device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.ops import peaks as peaks_ops, windows
from mmwave_radar_processing_jax.processors.base import Processor


class SyntheticArrayState(NamedTuple):
    """Ring buffers carried across frames (newest at index -1)."""

    adc_history: jax.Array  # (num_frames, ns, n_valid_chirps) complex64
    vel_history: jax.Array  # (num_frames, 3) float32


@partial(jax.jit, static_argnames=())
def beamform(
    data: jax.Array,  # (ns, E) complex — flattened [sample, frames*chirps]
    positions: jax.Array,  # (3, E) float — synthetic element positions (m)
    steering: jax.Array,  # (A, 3) float — unit steering vectors
    lambda_m: float,
    range_window: jax.Array,  # (ns,) float
    element_window: jax.Array,  # (E,) float
) -> jax.Array:
    """Beamformed range response for every steering angle: ``(ns, A)`` complex.

    The element sum is one complex matmul; the range FFT batches over
    angles.  Matches the reference's per-angle
    ``FFT(hann * sum_e(data_e * exp(j*2pi*(d.p_e)/lambda)))`` exactly.
    """
    phases = jnp.exp(1j * 2 * jnp.pi * (steering @ positions) / lambda_m)  # (A, E)
    weighted = data * element_window[None, :]
    beamformed = weighted @ phases.T  # (ns, A) — the matmul kernel
    return jnp.fft.fft(beamformed * range_window[:, None], axis=0)


def velocity_gate(
    vel_history: jax.Array, min_vel, max_vel, max_vel_stdev
) -> jax.Array:
    """Velocity-consistency gate (pure; reference ``_update_vel_history`` :332-375).

    All history rows within |bounds|, per-axis stdev under threshold, and all
    pairwise direction cosines > 0.95.
    """
    within = jnp.all(
        (jnp.asarray(min_vel) <= jnp.abs(vel_history))
        & (jnp.abs(vel_history) <= jnp.asarray(max_vel))
    )
    stdev_ok = jnp.all(jnp.std(vel_history, axis=0) <= jnp.asarray(max_vel_stdev))
    dirs = vel_history / (
        jnp.linalg.norm(vel_history, axis=1, keepdims=True) + 1e-6
    )
    direction_ok = jnp.all(dirs @ dirs.T > 0.95)
    return within & stdev_ok & direction_ok


def chained_geometry(
    vel_history: jax.Array, chirp_times_s: jax.Array, frame_dt_s: float
) -> jax.Array:
    """Backward-chained per-frame synthetic element positions ``(F, 3, C)``.

    Pure function shared by the object API and the scan pipeline
    (reference ``_update_array_geometries`` :377-471).
    """
    deltas = -2.0 * vel_history * frame_dt_s  # (F, 3)
    suffix = jnp.flip(jnp.cumsum(jnp.flip(deltas, 0), axis=0), 0)
    poses = jnp.concatenate([suffix[1:], jnp.zeros((1, 3))], axis=0)
    return (
        2.0 * chirp_times_s[None, None, :] * vel_history[:, :, None]
        + poses[:, :, None]
    )


@jax.jit
def array_factor_pattern(
    positions: jax.Array, steering: jax.Array, lambda_m: float
) -> jax.Array:
    """|sum_e exp(j*2pi*(d.p_e)/lambda)| per angle, normalized (ref :615-670)."""
    phases = jnp.exp(1j * 2 * jnp.pi * (steering @ positions) / lambda_m)
    pattern = jnp.abs(jnp.sum(phases, axis=1))
    return pattern / jnp.max(pattern)


class SyntheticArrayBeamformerProcessor(Processor):
    """Coherent multi-frame synthetic-aperture beamformer with calibration."""

    def __init__(
        self,
        config: RadarConfig,
        receiver_idx: int = 0,
        chirp_cfg_idx: int = 0,
        num_frames: int = 2,
        stride: int = 1,
        az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 60)),
        el_angle_bins_rad=np.array([0.0]),
        min_vel=np.array([0.17, 0.0, 0.0]),
        max_vel=np.array([0.25, 0.05, 0.05]),
        max_vel_stdev=np.array([0.1, 0.1, 0.1]),
        enable_calibration: bool = False,
        num_calibration_iters: int = 1,
        interpolated_grid_resolution_m: float = 0.1,
        **kwargs,
    ):
        super().__init__(config)
        self.receiver_idx = receiver_idx
        self.chirp_cfg_idx = chirp_cfg_idx
        self.num_frames = num_frames
        self.stride = stride
        self.az_angle_bins_rad = np.asarray(az_angle_bins_rad, float)
        self.el_angle_bins_rad = np.asarray(el_angle_bins_rad, float)
        self.min_vel = np.asarray(min_vel, float)
        self.max_vel = np.asarray(max_vel, float)
        self.max_vel_stdev = np.asarray(max_vel_stdev, float)
        self.enable_calibration = enable_calibration
        self.num_calibration_iters = num_calibration_iters
        self.interpolated_grid_resolution_m = interpolated_grid_resolution_m

        # --- static radar parameters (reference :175-246) --------------- #
        self.num_range_bins = config.num_adc_samples
        self.range_bins = np.linspace(0, config.range_max_m, self.num_range_bins)
        self.lambda_m = config.lambda_m
        self.chirps_per_frame = config.chirps_per_frame
        self.chirp_period_us = config.chirp_period_us
        self.frame_period_ms = config.frame.periodicity_ms

        chirp_cfg_idxs = np.tile(
            np.arange(config.frame.start_index, config.frame.end_index + 1),
            config.frame.loops,
        )
        valid = chirp_cfg_idxs == chirp_cfg_idx
        valid_idx = np.flatnonzero(valid)[:: self.stride]
        self.valid_chirps_mask = np.zeros_like(valid)
        self.valid_chirps_mask[valid_idx] = True
        self.n_valid_chirps = int(self.valid_chirps_mask.sum())

        # chirp start times counted backward from frame end (ref :226-234)
        all_starts = (
            np.arange(self.chirps_per_frame - 1, -1, -1) * -self.chirp_period_us
        )
        self.chirp_start_times_us = all_starts[self.valid_chirps_mask]

        # --- steering grid + meshes (reference :248-288, :474-488) ------ #
        self.rhos, self.thetas, self.phis = np.meshgrid(
            self.range_bins, self.az_angle_bins_rad, self.el_angle_bins_rad,
            indexing="ij",
        )
        self.x_s = self.rhos * np.cos(self.thetas) * np.cos(self.phis)
        self.y_s = self.rhos * np.sin(self.thetas) * np.cos(self.phis)
        self.z_s = self.rhos * np.sin(self.phis)

        th, ph = np.meshgrid(self.az_angle_bins_rad, self.el_angle_bins_rad,
                             indexing="ij")
        self.d = np.array(
            [np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph), np.sin(ph)]
        )  # (3, n_az, n_el)
        self._steering_flat = self.d.reshape(3, -1).T  # (A, 3)

        self._element_window = windows.hamming(self.num_frames * self.n_valid_chirps)
        self._range_window = windows.hanning(self.num_range_bins)
        self._init_interp_grid()

        # mutable object-API state
        self.state = self.init_state()
        self.array_geometry = np.empty(0)
        self.array_geometry_calibrated = np.empty(0)
        self.array_geometry_valid = False
        self.beamformed_resp = np.zeros(
            (self.num_range_bins, len(self.az_angle_bins_rad),
             len(self.el_angle_bins_rad)),
            complex,
        )
        self.interpolated_beamformed_resp = np.empty(0)

    # ------------------------------------------------------------------ #
    def init_state(self) -> SyntheticArrayState:
        return SyntheticArrayState(
            adc_history=jnp.zeros(
                (self.num_frames, self.num_range_bins, self.n_valid_chirps),
                jnp.complex64,
            ),
            vel_history=jnp.zeros((self.num_frames, 3), jnp.float32),
        )

    def _init_interp_grid(self):
        """Bilinear polar->cartesian resampling weights (device-friendly).

        Replaces ``scipy.griddata`` (reference :587-613): the azimuth slice at
        el index 0 lives on a (range, az) polar grid; each cartesian output
        pixel maps back to fractional (range, az) coordinates, sampled with
        bilinear weights.  Out-of-grid pixels are 0 (griddata fill_value).
        """
        x = self.x_s[:, :, 0]
        y = self.y_s[:, :, 0]
        res = self.interpolated_grid_resolution_m
        x_lin = np.arange(x.min(), x.max(), res)
        y_lin = np.arange(y.min(), y.max(), res)
        self.interp_x_s, self.interp_y_s = np.meshgrid(x_lin, y_lin, indexing="ij")
        rr = np.hypot(self.interp_x_s, self.interp_y_s)
        th = np.arctan2(self.interp_y_s, self.interp_x_s)

        rmax = self.range_bins[-1]
        nr = self.num_range_bins
        r_frac = rr / max(rmax, 1e-9) * (nr - 1)
        az = self.az_angle_bins_rad
        a_frac = np.interp(th, az, np.arange(len(az)), left=-1, right=-1)
        in_grid = (r_frac <= nr - 1) & (a_frac >= 0)
        # also reject angles outside the az span (np.interp clamps; mark them)
        in_grid &= (th >= az.min()) & (th <= az.max())
        r0 = np.clip(np.floor(r_frac).astype(int), 0, nr - 2)
        a0 = np.clip(np.floor(a_frac).astype(int), 0, len(az) - 2)
        self._interp = dict(
            r0=r0, a0=a0,
            wr=np.clip(r_frac - r0, 0, 1), wa=np.clip(a_frac - a0, 0, 1),
            mask=in_grid,
        )

    # geometry ----------------------------------------------------------- #
    def update_vel_history(self, vel_history: jax.Array) -> jax.Array:
        """Velocity-consistency gate (reference ``_update_vel_history`` :332-375)."""
        return velocity_gate(vel_history, self.min_vel, self.max_vel,
                             self.max_vel_stdev)

    def compute_array_geometry(self, vel_history: jax.Array) -> jax.Array:
        """Backward-chained per-frame element positions ``(F, 3, C)``.

        Frame f's elements sit at ``2 * t_chirp * v_f + pose_f`` where poses
        chain backward from the newest frame at the origin:
        ``pose_{f-1} = pose_f - 2 * v_f * T_frame`` (reference :377-471).
        """
        t = jnp.asarray(self.chirp_start_times_us * 1e-6, jnp.float32)
        return chained_geometry(vel_history, t, self.frame_period_ms * 1e-3)

    # beamforming --------------------------------------------------------- #
    def _flatten(self, state: SyntheticArrayState, geometry: jax.Array):
        data = jnp.transpose(state.adc_history, (1, 0, 2)).reshape(
            self.num_range_bins, -1
        )
        positions = jnp.transpose(geometry, (1, 0, 2)).reshape(3, -1)
        return data, positions

    def compute_synthetic_response(self, state, geometry) -> jax.Array:
        """Beamformed ``[range, az, el]`` complex response."""
        data, positions = self._flatten(state, geometry)
        resp = beamform(
            data, positions, jnp.asarray(self._steering_flat), self.lambda_m,
            jnp.asarray(self._range_window), jnp.asarray(self._element_window),
        )
        return resp.reshape(
            self.num_range_bins, len(self.az_angle_bins_rad), len(self.el_angle_bins_rad)
        )

    def compute_synthetic_array_pattern(self, array_geometry) -> np.ndarray:
        positions = jnp.transpose(jnp.asarray(array_geometry), (1, 0, 2)).reshape(3, -1)
        pat = array_factor_pattern(
            positions, jnp.asarray(self._steering_flat), self.lambda_m
        )
        return np.asarray(pat).reshape(
            len(self.az_angle_bins_rad), len(self.el_angle_bins_rad)
        )

    # calibration ---------------------------------------------------------- #
    def perform_array_calibration(
        self, state: SyntheticArrayState, geometry: jax.Array, beamformed: jax.Array
    ):
        """Phase self-calibration from targets of opportunity (ref :673-816).

        Finds 3 strong (range, az) reflectors, measures per-element residual
        phase slopes after steering at them, solves a tiny LSQ per element for
        (dx, dy) corrections, and applies the cumulative correction.  Returns
        ``(corrected_geometry, ok)``; callers keep the original geometry when
        ``ok`` is False (fewer than 3 usable targets).
        """
        data, positions = self._flatten(state, geometry)
        freq = jnp.fft.fft(data * jnp.asarray(self._element_window)[None, :], axis=0)

        avg_db = jnp.mean(20.0 * jnp.log10(jnp.abs(freq) + 1e-12), axis=1)
        pk_mask = peaks_ops.local_maxima(avg_db) & (avg_db > 0)
        vals = jnp.where(pk_mask, avg_db, -jnp.inf)
        _, rng_idx = jax.lax.top_k(vals, 3)
        n_found = jnp.sum(pk_mask)

        bf_az0 = jnp.abs(beamformed[:, :, 0])  # [range, az]
        az_db = 10.0 * jnp.log10(bf_az0[rng_idx] + 1e-12)  # (3, n_az)

        def best_az(row):
            m = peaks_ops.local_maxima(jnp.abs(row))
            v = jnp.where(m, jnp.abs(row), -jnp.inf)
            return jnp.argmax(v), jnp.any(m)

        az_idx, az_found = jax.vmap(best_az)(az_db)
        steering = jnp.asarray(self._steering_flat).reshape(
            len(self.az_angle_bins_rad), len(self.el_angle_bins_rad), 3
        )[az_idx, 0]  # (3 targets, 3)

        # per-target unwrapped phase slopes after steering
        shifts = jnp.exp(
            1j * 2 * jnp.pi * (steering @ positions) / self.lambda_m
        )  # (3, E)
        shifted = freq[rng_idx] * shifts  # (3, E)
        phase = jnp.unwrap(jnp.angle(shifted), axis=1)
        phi = jnp.diff(phase, axis=1)  # (3, E-1)

        d_j = 2 * jnp.pi / self.lambda_m * steering[:, 0:2]  # (3, 2)
        # least-squares (dx, dy) per element, batched over E-1 elements
        delta_p, *_ = jnp.linalg.lstsq(d_j, phi)
        corrections = jnp.cumsum(delta_p, axis=1)  # (2, E-1)
        new_positions = positions.at[0:2, 1:].add(-corrections)

        ok = (n_found >= 3) & jnp.all(az_found)
        new_geometry = new_positions.reshape(3, self.num_frames, -1).transpose(1, 0, 2)
        return new_geometry, ok

    # interpolation --------------------------------------------------------- #
    def get_interpolated_response_cart(self, beamformed=None) -> np.ndarray:
        """Bilinear resample of the el=0 slice onto a cartesian grid."""
        if beamformed is None:
            beamformed = self.beamformed_resp
        sl = np.asarray(beamformed)[:, :, 0]
        g = self._interp
        v00 = sl[g["r0"], g["a0"]]
        v01 = sl[g["r0"], g["a0"] + 1]
        v10 = sl[g["r0"] + 1, g["a0"]]
        v11 = sl[g["r0"] + 1, g["a0"] + 1]
        out = (
            v00 * (1 - g["wr"]) * (1 - g["wa"])
            + v01 * (1 - g["wr"]) * g["wa"]
            + v10 * g["wr"] * (1 - g["wa"])
            + v11 * g["wr"] * g["wa"]
        )
        out = np.where(g["mask"], out, 0.0)
        self.interpolated_beamformed_resp = out
        return out

    # functional step -------------------------------------------------------- #
    def step(self, state: SyntheticArrayState, adc_cube: jax.Array, current_vel):
        """``(state, frame, vel) -> (state, (response, valid))`` pure update."""
        frame = adc_cube[..., self.receiver_idx, :, :][
            ..., :, np.flatnonzero(self.valid_chirps_mask)
        ]
        adc_history = jnp.concatenate(
            [state.adc_history[1:], frame[None].astype(jnp.complex64)], axis=0
        )
        vel_history = jnp.concatenate(
            [state.vel_history[1:], jnp.asarray(current_vel, jnp.float32)[None]],
            axis=0,
        )
        new_state = SyntheticArrayState(adc_history, vel_history)
        valid = self.update_vel_history(vel_history)
        geometry = self.compute_array_geometry(vel_history)
        resp = self.compute_synthetic_response(new_state, geometry)
        return new_state, (resp, valid, geometry)

    def process(self, adc_cube: jax.Array, current_vel) -> np.ndarray:
        """Reference-compatible API: response array or empty when gated out."""
        self.state, (resp, valid, geometry) = self.step(
            self.state, adc_cube, np.asarray(current_vel, float)
        )
        self.array_geometry = np.asarray(geometry)
        self.array_geometry_valid = bool(valid)
        if not self.array_geometry_valid:
            return np.empty(0)

        if self.enable_calibration:
            geom = jnp.asarray(geometry)
            for _ in range(self.num_calibration_iters):
                new_geom, ok = self.perform_array_calibration(self.state, geom, resp)
                if not bool(ok):
                    self.array_geometry_calibrated = np.asarray(geom)
                    break
                geom = new_geom
                self.array_geometry_calibrated = np.asarray(geom)
                resp = self.compute_synthetic_response(self.state, geom)
        self.beamformed_resp = np.asarray(resp)
        self.get_interpolated_response_cart(self.beamformed_resp)
        return self.beamformed_resp

    def reset(self):
        self.state = self.init_state()
        self.array_geometry_valid = False
        super().reset()
