"""Fused device pipelines for the remaining spectral maps.

Batch/scan versions of the spectral processor family in split-complex
matmul form, so every map the GUI/plotting stack consumes is produced on the
device at batch throughput:

- :func:`build_spectral_maps_pipeline` — per frame: range-Doppler magnitude
  (one RX), range-azimuth map, coarse Doppler-azimuth map.
- :func:`build_micro_doppler_pipeline` — ``lax.scan`` over a recording with
  the shift-register spectrogram state on device.
- :func:`build_dbs_pipeline` — DBS-sharpened range-angle maps with traced
  platform velocities (3D windowed DFT + vectorized Doppler-bin gather) and
  the low-speed plain-range-angle fallback as a ``jnp.where`` blend.

Each matches its object-API processor on identical inputs
(tests/test_mxu.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import mxu
from mmwave_radar_processing_jax.processors.virtual_array import reformat


class SpectralMaps(NamedTuple):
    range_doppler: jax.Array  # (B, ns, loops)
    range_angle: jax.Array  # (B, ns, num_angle_bins)
    doppler_azimuth: jax.Array  # (B, loops, n_valid_angles)


def _reformat_c2(raw_re, raw_im, num_rx, cpl):
    return mxu.C2(
        reformat(raw_re, num_rx=num_rx, cfgs_per_loop=cpl),
        reformat(raw_im, num_rx=num_rx, cfgs_per_loop=cpl),
    )


def build_spectral_maps_pipeline(
    cfg: RadarConfig,
    *,
    rx_idx: int = 0,
    ra_rx_antennas: Sequence[int] = (0, 3, 4, 7),
    da_rx_antennas: Sequence[int] = (0, 3, 4, 7),
    num_angle_bins: int = 64,
    valid_angle_range: Sequence[float] = (np.deg2rad(-60), np.deg2rad(60)),
    chirp_idx: int = 0,
    da_shift_angle: bool = True,
    reformat_input: bool = True,
):
    """Compile ``(raw_re, raw_im) -> SpectralMaps`` over a frame batch."""
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    ra_idx = np.asarray(ra_rx_antennas, int)
    da_idx = np.asarray(da_rx_antennas, int)
    angle_bins = grids.angle_bins(num_angle_bins)
    var = np.asarray(valid_angle_range, float)
    valid_cols = np.flatnonzero((angle_bins >= var[0]) & (angle_bins <= var[1]))

    rd_rng, rd_dop = mxu.range_doppler_factors(ns, loops)
    # range-angle: Hann over samples + Hann over the *full* antenna axis
    # before selection (reference range_angle_resp.py:95-101)
    n_virtual = num_rx * cpl
    ant_window_full = np.hanning(n_virtual)
    ra_ant_factors = mxu.dft_factors(len(ra_idx), num_angle_bins, shift=True)
    ra_rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    da_rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    da_chirp_factors = mxu.dft_factors(loops, window=np.hanning(loops), shift=True)
    da_ant_factors = mxu.dft_factors(len(da_idx), num_angle_bins,
                                     shift=da_shift_angle)
    angle_window_da = (
        cfg.array_geometry == "standard" and cfg.virtual_antennas_enabled
    )

    def single_frame(raw_re, raw_im):
        if reformat_input:
            cube = _reformat_c2(raw_re, raw_im, num_rx, cpl)
        else:
            cube = mxu.C2(raw_re, raw_im)

        # range-Doppler magnitude of one antenna
        rd = mxu.range_doppler_map_mxu(
            mxu.C2(cube.re[rx_idx : rx_idx + 1], cube.im[rx_idx : rx_idx + 1]),
            rd_rng, rd_dop,
        )
        rd_mag = mxu.cabs(mxu.C2(rd.re[0], rd.im[0]))

        # range-angle: window full antenna axis, select, range DFT, angle DFT
        aw = jnp.asarray(ant_window_full, jnp.float32)[:, None]
        chirp = mxu.C2(
            (cube.re[:, :, chirp_idx] * aw)[ra_idx],
            (cube.im[:, :, chirp_idx] * aw)[ra_idx],
        )  # [ra_rx, ns]
        ra = mxu.dft_apply(chirp, ra_rng_factors, axis=1)
        ra = mxu.C2(ra.re.T, ra.im.T)  # [ns, ra_rx]
        ra = mxu.dft_apply(ra, ra_ant_factors, axis=1)
        ra_mag = mxu.cabs(ra)

        # coarse Doppler-azimuth over the selected sub-array
        sub = mxu.C2(cube.re[da_idx], cube.im[da_idx])
        if angle_window_da:
            w = jnp.asarray(np.hanning(len(da_idx)), jnp.float32)[:, None, None]
            sub = mxu.C2(sub.re * w, sub.im * w)
        rng_fft = mxu.dft_apply(sub, da_rng_factors, axis=1)  # [rx, ns, loops]
        data = mxu.C2(
            jnp.moveaxis(rng_fft.re, 0, -1), jnp.moveaxis(rng_fft.im, 0, -1)
        )
        spec = mxu.dft_apply(data, da_chirp_factors, axis=1)
        spec = mxu.dft_apply(spec, da_ant_factors, axis=2)
        da_mag = jnp.mean(mxu.cabs(spec)[..., valid_cols], axis=0)

        return SpectralMaps(rd_mag, ra_mag, da_mag)

    return jax.jit(jax.vmap(single_frame))


def build_micro_doppler_pipeline(
    cfg: RadarConfig,
    *,
    rx_idx: int = 0,
    target_ranges: Sequence[float] = (0.0, 1.0),
    num_frames_history: int = 20,
    reformat_input: bool = True,
):
    """Compile ``(raw_re[T,...], raw_im[T,...]) -> spectrograms[T, vel, hist]``.

    Reference ``micro_doppler_resp.py``: unwindowed 2D FFT, Doppler-only
    fftshift, max over the gated range rows, shift-register history — run as
    one ``lax.scan`` over the recording.
    """
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    range_bins = grids.range_bins(cfg, variant="eps")
    tr = np.asarray(target_ranges, float)
    range_mask = jnp.asarray((range_bins >= tr[0]) & (range_bins <= tr[1]))
    rng_factors = mxu.dft_factors(ns)  # no windows in the reference kernel
    dop_factors = mxu.dft_factors(loops, shift=True)

    def step(hist, frame):
        raw_re, raw_im = frame
        if reformat_input:
            cube = _reformat_c2(raw_re, raw_im, num_rx, cpl)
        else:
            cube = mxu.C2(raw_re, raw_im)
        sl = mxu.C2(cube.re[rx_idx], cube.im[rx_idx])  # [ns, loops]
        spec = mxu.dft_apply(sl, rng_factors, axis=0)
        spec = mxu.dft_apply(spec, dop_factors, axis=1)
        mag = mxu.cabs(spec)
        col = jnp.max(jnp.where(range_mask[:, None], mag, -jnp.inf), axis=0)
        hist = jnp.concatenate([col[:, None], hist[:, :-1]], axis=1)
        return hist, hist

    def pipeline(raw_re, raw_im):
        init = jnp.zeros((loops, num_frames_history), jnp.float32)
        _, out = jax.lax.scan(step, init, (raw_re, raw_im))
        return out

    return jax.jit(pipeline)


def build_strip_map_pipeline(
    cfg: RadarConfig,
    *,
    rx_index: int = 0,
    reformat_input: bool = True,
):
    """Compile ``(raw_re, raw_im) -> |SAR map| [B, ns, loops]`` (full map).

    The strip-map SAR transform is one windowless 2D DFT with a Doppler
    fftshift (reference ``strip_map_SAR_processor.py:181-189``); the
    velocity-dependent valid range/angle crop stays host-side (it changes
    shape), applied by :class:`...processors.strip_map_sar.StripMapSARProcessor`
    conventions on the returned full map.
    """
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    rng_factors = mxu.dft_factors(ns)
    dop_factors = mxu.dft_factors(loops, shift=True)

    def single_frame(raw_re, raw_im):
        if reformat_input:
            cube = _reformat_c2(raw_re, raw_im, num_rx, cpl)
        else:
            cube = mxu.C2(raw_re, raw_im)
        sl = mxu.C2(cube.re[rx_index], cube.im[rx_index])
        spec = mxu.dft_apply(sl, rng_factors, axis=0)
        spec = mxu.dft_apply(spec, dop_factors, axis=1)
        return mxu.cabs(spec)

    return jax.jit(jax.vmap(single_frame))


def build_dbs_pipeline(
    cfg: RadarConfig,
    *,
    rx_antennas: Sequence[int] = (0, 3, 4, 7),
    num_angle_bins: int = 64,
    num_dbs_angle_bins: int = 100,
    min_x_y_vel_dbs: float = 0.25,
    chirp_idx: int = 0,
    reformat_input: bool = True,
):
    """Compile ``(raw_re, raw_im, velocity_ned[B,3]) -> [B, ns, n_dbs]``.

    The speed gate becomes a per-frame ``jnp.where`` blend between the
    DBS-sharpened map (resampled onto the DBS angle grid the reference indexes
    with nearest-coarse-angle gather) and the plain range-angle response.
    """
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    rx_idx = np.asarray(rx_antennas, int)
    angle_bins = grids.angle_bins(num_angle_bins)
    dbs_bins = np.linspace(angle_bins[0], angle_bins[-1], num_dbs_angle_bins)
    vel_bins = jnp.asarray(grids.vel_bins(cfg))
    # nearest coarse angle per DBS angle (static)
    ang_near = np.argmin(
        np.abs(angle_bins[None, :] - dbs_bins[:, None]), axis=1
    )

    rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    dop_factors = mxu.dft_factors(loops, window=np.hanning(loops), shift=True)
    ang_factors = mxu.dft_factors(
        len(rx_idx), num_angle_bins, shift=True, window=np.hanning(len(rx_idx))
    )
    # plain range-angle path windows the FULL antenna axis before selection
    n_virtual = num_rx * cpl
    ant_window_full = np.hanning(n_virtual)
    ra_ant_factors = mxu.dft_factors(len(rx_idx), num_angle_bins, shift=True)
    ra_rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    dbs_dirs = jnp.asarray(
        np.stack([np.cos(dbs_bins), np.sin(dbs_bins)], axis=1), jnp.float32
    )

    def single_frame(raw_re, raw_im, velocity_ned):
        if reformat_input:
            cube = _reformat_c2(raw_re, raw_im, num_rx, cpl)
        else:
            cube = mxu.C2(raw_re, raw_im)
        sub = mxu.C2(cube.re[rx_idx], cube.im[rx_idx])

        # --- DBS path: 3D windowed DFT [angle, range, doppler] ---------- #
        spec = mxu.dft_apply(sub, rng_factors, axis=1)
        spec = mxu.dft_apply(spec, dop_factors, axis=2)
        spec = mxu.C2(jnp.moveaxis(spec.re, 0, -1), jnp.moveaxis(spec.im, 0, -1))
        spec = mxu.dft_apply(spec, ang_factors, axis=2)  # [ns, loops, angle]
        mag = mxu.cabs(spec)
        mag = jnp.transpose(mag, (2, 0, 1))  # [angle, range, doppler]

        dop_vel = -(dbs_dirs @ velocity_ned[:2])  # [n_dbs]
        vel_idx = jnp.argmin(jnp.abs(vel_bins[None, :] - dop_vel[:, None]), axis=1)
        sharpened = mag[jnp.asarray(ang_near), :, vel_idx].T  # [ns, n_dbs]

        # --- plain range-angle fallback, resampled to the DBS grid ------ #
        aw = jnp.asarray(ant_window_full, jnp.float32)[:, None]
        chirp = mxu.C2(
            (cube.re[:, :, chirp_idx] * aw)[rx_idx],
            (cube.im[:, :, chirp_idx] * aw)[rx_idx],
        )
        ra = mxu.dft_apply(chirp, ra_rng_factors, axis=1)
        ra = mxu.C2(ra.re.T, ra.im.T)
        ra = mxu.dft_apply(ra, ra_ant_factors, axis=1)
        plain = mxu.cabs(ra)[:, jnp.asarray(ang_near)]  # nearest-angle resample

        fast = jnp.linalg.norm(velocity_ned[:2]) >= min_x_y_vel_dbs
        return jnp.where(fast, sharpened, plain)

    return jax.jit(jax.vmap(single_frame))
