"""Doppler-azimuth (velocity-vs-angle) response + peak detectors.

Re-design of the reference ``DopplerAzimuthProcessor``
(``processors/doppler_azimuth_resp.py``).  Key transformations:

- The data-dependent *range window* (altitude-centered) becomes a traced mask
  and a masked mean over the full range axis, instead of slicing to a dynamic
  shape (``:102-128`` slices; per-range-bin FFTs are independent so masked
  averaging is numerically identical).
- The *precise* (zoom FFT) path keeps the reference's split into a negative
  and a positive velocity half-band (``:207-293``) — including the aliasing
  ``+2*vel_max`` shift for the negative half and the historical ``fs*2``
  scaling quirk (``:153-154``) — but always emits a fixed ``2*num_vel_bins``
  velocity layout with a validity mask.  The reference drops an empty side and
  returns 70 or 140 bins dynamically; here empty sides are masked instead so
  the whole pipeline stays shape-static under jit.
- Per-row peak picking (``detect_peaks_rows`` :336-384) vmaps a dense
  prominence computation over rows; outputs are fixed-capacity ``(angle, vel)``
  arrays with validity masks (at most one peak per velocity row, as upstream).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import czt, peaks as peaks_ops, windows
from mmwave_radar_processing_jax.processors.base import Processor


# --------------------------------------------------------------------------- #
# pure kernels
# --------------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=("angle_window",))
def _window_cube(adc_cube: jax.Array, *, angle_window: bool) -> jax.Array:
    """Hann windows over range + chirp (+ optionally antenna) axes.

    Reference ``apply_hanning_windows`` :84-100; the antenna window applies for
    the standard geometry with virtual antennas enabled.
    """
    rx, ns, nc = adc_cube.shape[-3:]
    w = windows.outer_window(windows.hanning(ns), windows.hanning(nc))  # (ns, nc)
    out = adc_cube * jnp.asarray(w)
    if angle_window:
        out = out * jnp.asarray(windows.hanning(rx))[:, None, None]
    return out


@jax.jit
def _range_fft(adc_cube: jax.Array) -> jax.Array:
    """Range FFT along the sample axis: ``[rx, samp, chirp] -> [rx, range, chirp]``."""
    return jnp.fft.fft(adc_cube, axis=-2)


@partial(jax.jit, static_argnames=("num_angle_bins", "shift_angle"))
def coarse_doppler_azimuth(
    rng_fft: jax.Array, *, num_angle_bins: int, shift_angle: bool = True
) -> jax.Array:
    """Per-range 2D (chirp x rx) FFT magnitude.

    Args:
        rng_fft: ``[rx, range, chirp]`` complex range-FFT cube.

    Returns:
        ``[range, doppler, angle]`` float magnitude; Doppler always
        fftshifted, angle only when ``shift_angle`` (reference :296-334).
    """
    num_rx = rng_fft.shape[-3]
    data = jnp.moveaxis(rng_fft, -3, -1)  # [range, chirp, rx]
    pad = [(0, 0)] * (data.ndim - 1) + [(0, num_angle_bins - num_rx)]
    data = jnp.pad(data, pad)
    spec = jnp.fft.fft2(data, axes=(-2, -1))
    axes = (-2, -1) if shift_angle else (-2,)
    return jnp.abs(jnp.fft.fftshift(spec, axes=axes))


@partial(jax.jit, static_argnames=("num_angle_bins", "num_samples", "fs"))
def _zoom_half_band(
    rng_fft_rearranged: jax.Array,
    f_start: jax.Array,
    f_stop: jax.Array,
    *,
    num_angle_bins: int,
    num_samples: int,
    fs: float,
) -> jax.Array:
    """Zoom FFT over the chirp axis then angle FFT (reference ``zoom_fft`` :130-162).

    Args:
        rng_fft_rearranged: ``[range, chirp, angle_pad]`` complex.

    Returns:
        ``[range, num_samples, angle_pad]`` float magnitude (no angle shift).
    """
    x = rng_fft_rearranged[:, :num_samples, :]
    # historical quirk kept for parity: ZoomFFT is built with fs*2
    zoomed = czt.zoom_fft_dynamic(x, f_start, f_stop, n=num_samples, m=num_samples,
                                  fs=fs * 2.0, axis=1)
    return jnp.abs(jnp.fft.fft(zoomed, axis=2))


@jax.jit
def floor_db(resp_mag: jax.Array, min_threshold_db: float = 30.0) -> jax.Array:
    """dB conversion with a floor ``max - threshold`` (reference :350-355)."""
    db = 20.0 * jnp.log10(jnp.abs(resp_mag) + 1e-12)
    floor = jnp.max(db) - min_threshold_db
    return jnp.maximum(db, floor)


@jax.jit
def detect_peaks_rows(
    resp_mag: jax.Array,
    vel_bins: jax.Array,
    valid_angle_bins: jax.Array,
    min_threshold_db: float = 30.0,
    row_valid: Optional[jax.Array] = None,
):
    """Best prominent peak (>=4 dB) per velocity row.

    Returns ``(angles, vels, valid)`` of shape ``[rows]`` — the reference's
    Nx2 (angle, velocity) list as a fixed-capacity masked set (reference
    :336-384: one best peak per row, rows without peaks dropped).
    """
    db = floor_db(resp_mag, min_threshold_db)

    def per_row(row):
        mask = peaks_ops.local_maxima(row)
        mask = mask & (peaks_ops.prominences(row, mask) >= 4.0)
        vals = jnp.where(mask, row, -jnp.inf)
        best = jnp.argmax(vals)
        return best, jnp.any(mask)

    best_idx, found = jax.vmap(per_row)(db)
    if row_valid is not None:
        found = found & row_valid
    angles = jnp.where(found, valid_angle_bins[best_idx], 0.0)
    vels = jnp.where(found, vel_bins, 0.0)
    return angles, vels, found


@partial(jax.jit, static_argnames=("zero_az_col",))
def detect_peak_zero_az(
    resp_mag: jax.Array,
    vel_bins: jax.Array,
    *,
    zero_az_col: int,
    min_threshold_db: float = 30.0,
    row_valid: Optional[jax.Array] = None,
):
    """Strongest local maximum of the zero-azimuth column.

    Returns ``(velocity, found)`` (reference :387-415 returns ``[0, vel]`` or
    an empty array).
    """
    db = floor_db(resp_mag, min_threshold_db)
    col = db[:, zero_az_col]
    mask = peaks_ops.local_maxima(col)
    if row_valid is not None:
        mask = mask & row_valid
    vals = jnp.where(mask, col, -jnp.inf)
    best = jnp.argmax(vals)
    found = jnp.any(mask)
    return jnp.where(found, vel_bins[best], 0.0), found


# --------------------------------------------------------------------------- #
# processor
# --------------------------------------------------------------------------- #
class DopplerAzimuthProcessor(Processor):
    """Velocity-vs-angle response processor (x-forward, y-left frame)."""

    def __init__(
        self,
        config: RadarConfig,
        num_angle_bins: int = 64,
        valid_angle_range: Sequence[float] = (np.deg2rad(-60), np.deg2rad(60)),
        min_zoom_fft_vel_span: float = 0.1,
        **kwargs,
    ):
        super().__init__(config)
        self.num_angle_bins = num_angle_bins
        self.min_zoom_fft_vel_span = min_zoom_fft_vel_span
        self.range_bins = grids.range_bins(config, variant="eps")
        self.num_range_bins = config.num_adc_samples
        self.vel_bins = grids.vel_bins(config)
        self.num_vel_bins = self.vel_bins.shape[0]
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        valid_angle_range = np.asarray(valid_angle_range, float)
        self.valid_angle_range = valid_angle_range
        self.valid_angle_mask = (self.angle_bins >= valid_angle_range[0]) & (
            self.angle_bins <= valid_angle_range[1]
        )
        self.valid_angle_bins = self.angle_bins[self.valid_angle_mask]
        self.zero_az_col = int(np.argmin(np.abs(self.valid_angle_bins)))
        self._angle_window = (
            config.array_geometry == "standard" and config.virtual_antennas_enabled
        )
        # velocity zoom frequency mapping (reference :146-151)
        self._vel_fs = 1.0 / config.vel_res_m_s
        self._vel_scale = self._vel_fs / config.vel_max_m_s
        # layout of the fixed zoomed velocity grid: [neg (num_vel_bins) | pos (num_vel_bins)]
        self.zoomed_vel_bins: Optional[jax.Array] = None
        self.zoomed_vel_valid: Optional[jax.Array] = None

    # ------------------------------------------------------------------ #
    def _range_mask(self, range_window) -> jax.Array:
        bins = jnp.asarray(self.range_bins)
        if range_window is None or (
            hasattr(range_window, "__len__") and len(range_window) == 0
        ):
            return jnp.ones(bins.shape, bool)
        rw = jnp.asarray(range_window)
        return (bins >= rw[0]) & (bins <= rw[1])

    def _prepare(self, adc_cube, rx_antennas):
        if rx_antennas is not None and len(rx_antennas) > 0:
            adc_cube = adc_cube[np.asarray(rx_antennas, int), :, :]
        cube = _window_cube(adc_cube, angle_window=self._angle_window)
        return _range_fft(cube)

    def _zoomed_grid(self, vel_range: jax.Array):
        """Fixed-layout zoomed velocity grid + per-side spans.

        Mirrors ``set_zoomed_fft_vel_bins`` (reference :164-205) with both
        sides always materialized; emptiness is a mask, not a shape.
        """
        nv = self.num_vel_bins
        v0, v1 = vel_range[0], vel_range[1]
        neg_stop = jnp.minimum(-1e-4, v1)
        neg_bins = v0 + (neg_stop - v0) * jnp.arange(nv) / nv  # endpoint=False
        neg_present = v0 <= 0
        pos_start = jnp.maximum(1e-4, v0)
        pos_bins = pos_start + (v1 - pos_start) * jnp.arange(nv) / nv
        pos_present = v1 > 0
        bins = jnp.concatenate([neg_bins, pos_bins])
        valid = jnp.concatenate(
            [jnp.broadcast_to(neg_present, (nv,)), jnp.broadcast_to(pos_present, (nv,))]
        )
        return bins, valid, (neg_bins, neg_present), (pos_bins, pos_present)

    def _clamp_vel_range(self, vel_range: jax.Array) -> jax.Array:
        """Clamp to [-vmax, vmax] and enforce the minimum spread (ref :234-246)."""
        vmax = self.config.vel_max_m_s
        v0 = jnp.maximum(vel_range[0], -vmax)
        v1 = jnp.minimum(vel_range[1], vmax)
        spread = 2.0 * self.min_zoom_fft_vel_span
        need = (v1 - v0) < spread
        dist_hi = jnp.abs(v1 - vmax)
        dist_lo = jnp.abs(v0 + vmax)
        v1 = jnp.where(need & (dist_hi > dist_lo), v0 + spread, v1)
        v0 = jnp.where(need & (dist_lo > dist_hi), v1 - spread, v0)
        return jnp.stack([v0, v1])

    def precise_doppler_azimuth(
        self, rng_fft: jax.Array, vel_range, shift_angle: bool = True
    ):
        """Zoom-FFT Doppler-azimuth response over a fixed two-half-band grid.

        Returns ``(resp [2*num_vel_bins_rows, range?, ...], zoomed_vel_bins,
        row_valid)``; see class docstring for the masked-layout divergence.
        """
        vel_range = self._clamp_vel_range(jnp.asarray(vel_range, jnp.float32))
        bins, valid, (neg_bins, neg_present), (pos_bins, pos_present) = self._zoomed_grid(
            vel_range
        )
        nv = self.num_vel_bins
        num_rx = rng_fft.shape[-3]
        data = jnp.moveaxis(rng_fft, -3, -1)  # [range, chirp, rx]
        pad = [(0, 0)] * (data.ndim - 1) + [(0, self.num_angle_bins - num_rx)]
        data = jnp.pad(data, pad)

        vmax = self.config.vel_max_m_s
        span = self.min_zoom_fft_vel_span

        # negative half: aliased band (+2*vmax), reference :251-265
        neg_lo, neg_hi = jnp.min(neg_bins), jnp.max(neg_bins)
        neg_ok = neg_present & (jnp.abs(neg_hi - neg_lo) > span)
        neg_resp = _zoom_half_band(
            data,
            (neg_lo + 2 * vmax) * self._vel_scale,
            (neg_hi + 2 * vmax) * self._vel_scale,
            num_angle_bins=self.num_angle_bins,
            num_samples=nv,
            fs=self._vel_fs,
        )
        neg_resp = jnp.where(neg_ok, neg_resp, 0.0)

        pos_lo, pos_hi = jnp.min(pos_bins), jnp.max(pos_bins)
        pos_ok = pos_present & (jnp.abs(pos_hi - pos_lo) > span)
        pos_resp = _zoom_half_band(
            data,
            pos_lo * self._vel_scale,
            pos_hi * self._vel_scale,
            num_angle_bins=self.num_angle_bins,
            num_samples=nv,
            fs=self._vel_fs,
        )
        pos_resp = jnp.where(pos_ok, pos_resp, 0.0)

        resp = jnp.concatenate([neg_resp, pos_resp], axis=1)  # [range, 2nv, angle]
        if shift_angle:
            resp = jnp.fft.fftshift(resp, axes=2)
        row_valid = jnp.concatenate(
            [jnp.broadcast_to(neg_ok, (nv,)), jnp.broadcast_to(pos_ok, (nv,))]
        ) & valid
        return resp, bins, row_valid

    # ------------------------------------------------------------------ #
    def process(
        self,
        adc_cube: jax.Array,
        rx_antennas: Optional[Sequence[int]] = None,
        range_window=None,
        shift_angle: bool = True,
        use_precise_fft: bool = False,
        precise_vel_range=(-0.25, 0.25),
        **kwargs,
    ):
        """Doppler-azimuth response averaged over the range window.

        Returns the ``[vel, valid_angle]`` response for the coarse path, or
        ``(resp, zoomed_vel_bins, row_valid)`` for the precise path.
        Reference ``process`` :419-491.
        """
        rng_fft = self._prepare(adc_cube, rx_antennas)
        rmask = self._range_mask(range_window)

        if not use_precise_fft:
            resp = coarse_doppler_azimuth(
                rng_fft, num_angle_bins=self.num_angle_bins, shift_angle=shift_angle
            )
            resp = resp[..., np.flatnonzero(self.valid_angle_mask)]
            avg = jnp.sum(resp * rmask[:, None, None], axis=0) / jnp.maximum(
                jnp.sum(rmask), 1
            )
            return avg

        resp, bins, row_valid = self.precise_doppler_azimuth(
            rng_fft, jnp.asarray(precise_vel_range, jnp.float32), shift_angle=shift_angle
        )
        resp = resp[..., np.flatnonzero(self.valid_angle_mask)]
        avg = jnp.sum(resp * rmask[:, None, None], axis=0) / jnp.maximum(jnp.sum(rmask), 1)
        self.zoomed_vel_bins = bins
        self.zoomed_vel_valid = row_valid
        return avg, bins, row_valid

    # peak detectors (reference-compatible wrappers) -------------------- #
    def detect_peaks_rows(self, resp_mag, vel_bins, min_threshold_dB=30.0, row_valid=None):
        return detect_peaks_rows(
            resp_mag,
            jnp.asarray(vel_bins),
            jnp.asarray(self.valid_angle_bins),
            min_threshold_dB,
            row_valid,
        )

    def detect_peak_zero_az(self, resp_mag, vel_bins, min_threshold_dB=30.0, row_valid=None):
        return detect_peak_zero_az(
            resp_mag,
            jnp.asarray(vel_bins),
            zero_az_col=self.zero_az_col,
            min_threshold_db=min_threshold_dB,
            row_valid=row_valid,
        )
