"""Zoom FFT via demodulate -> FIR low-pass -> decimate -> zoom DFT.

The CZT zoom (:mod:`ops/czt`) matches the reference's ``scipy.signal.ZoomFFT``
(``range_resp.py:92``, ``doppler_azimuth_resp.py:154``) but Bluestein needs the
*whole* sample axis resident on one chip.  This module is the scaling
formulation of the same spectral zoom for long, sharded sample axes: the only
non-local operator is a short FIR whose shard-boundary needs are exactly
``num_taps - 1`` halo samples — the classic **overlap-save** pattern
(``parallel/overlap_save.py`` provides the sharded build; bit-identical to
this unsharded composition by construction).

Pipeline for a band centered on ``f_center`` of width ``fs / decim``:

    1. demodulate:  d[j] = x[j] * exp(-2j*pi*f_center*j/fs)
    2. low-pass FIR (windowed-sinc, cutoff fs/(2*decim)) on both planes
    3. decimate by ``decim``  ->  rate fs' = fs/decim, length n' = n/decim
    4. zoom DFT (two real matmuls) to ``m`` bins over ``[f1, f2)``
       *relative to f_center* at rate ``fs'``

Output bin ``k`` therefore measures absolute frequency
``f_center + f1 + k*(f2-f1)/m``.  Everything is split-complex (:class:`C2`) —
no complex dtypes on the device path (see CLAUDE.md platform constraints).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.ops.mxu import C2, dft_apply


def lowpass_taps(num_taps: int, cutoff: float, fs: float) -> np.ndarray:
    """Hamming-windowed-sinc low-pass FIR taps, unit DC gain.

    ``cutoff`` is the -6 dB edge in the same units as ``fs``.
    """
    if num_taps % 2 == 0:
        raise ValueError("num_taps must be odd (linear phase, integer delay)")
    j = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * cutoff / fs * np.sinc(2 * cutoff / fs * j)
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def demod_factors(n: int, f_center: float, fs: float):
    """Static ``exp(-2j*pi*f_center*j/fs)`` planes, ``j = 0..n-1``."""
    ang = -2 * np.pi * f_center * np.arange(n) / fs
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def fir_causal(x: jax.Array, taps: np.ndarray, axis: int = -1) -> jax.Array:
    """Causal FIR ``y[j] = sum_t h[t] x[j-t]`` (zero left padding).

    Written as a static loop over taps with a fixed accumulation order so the
    sharded overlap-save build (which runs this same loop on a halo-extended
    chunk) is *bit-identical*, not merely close.
    """
    x = jnp.moveaxis(x, axis, -1)
    t_len = len(taps)
    pad = [(0, 0)] * (x.ndim - 1) + [(t_len - 1, 0)]
    xp = jnp.pad(x, pad)
    y = _fir_valid(xp, taps)
    return jnp.moveaxis(y, -1, axis)


def _fir_valid(xp: jax.Array, taps: np.ndarray) -> jax.Array:
    """Valid-mode tap loop on a left-extended signal (last axis).

    ``xp`` carries ``len(taps) - 1`` extension samples on the left — either
    zero padding (unsharded) or the neighbor shard's halo (overlap-save).
    """
    t_len = len(taps)
    n = xp.shape[-1] - (t_len - 1)
    acc = float(taps[0]) * xp[..., t_len - 1 : t_len - 1 + n]
    for t in range(1, t_len):
        acc = acc + float(taps[t]) * xp[..., t_len - 1 - t : t_len - 1 - t + n]
    return acc


def zoom_dft_factors(n: int, m: int, f1: float, f2: float, fs: float,
                     *, delay: float = 0.0):
    """Static rectangular DTFT factors ``M = C - jS`` shaped ``(n, m)``.

    Frequencies ``f_k = f1 + k*(f2-f1)/m`` (endpoint=False).  ``delay``
    compensates a known group delay in samples (the linear-phase FIR's
    ``(num_taps-1)/2``) by evaluating phases at ``j - delay/decim`` — folded
    into the matrix so it costs nothing at run time.
    """
    j = np.arange(n, dtype=np.float64)[:, None] - delay
    k = np.arange(m, dtype=np.float64)[None, :]
    freqs = f1 + k * (f2 - f1) / m
    ang = 2 * np.pi * j * freqs / fs
    return (jnp.asarray(np.cos(ang), jnp.float32),
            jnp.asarray(np.sin(ang), jnp.float32))


@partial(jax.jit, static_argnames=("f_center", "fs", "decim", "num_taps", "m",
                                   "f1", "f2"))
def zoom_fft_fir(
    x: C2,
    *,
    f_center: float,
    fs: float,
    decim: int,
    num_taps: int,
    m: int,
    f1: float,
    f2: float,
) -> C2:
    """Zoom spectrum of ``x`` (last axis) around ``f_center`` — see module doc.

    Args:
        x: split-complex ``[..., n]`` with ``n % decim == 0``.
        f_center: band center (same units as ``fs``).
        decim: decimation ratio; analysis band width is ``fs / decim``.
        num_taps: odd FIR length; ``num_taps - 1`` is the overlap-save halo.
        m: output bins over ``[f1, f2)`` *relative to* ``f_center`` at the
           decimated rate ``fs / decim``.

    Returns:
        split-complex ``[..., m]`` zoom spectrum.
    """
    n = x.shape[-1]
    if n % decim != 0:
        raise ValueError(f"n={n} must be a multiple of decim={decim}")
    dr, di = demod_factors(n, f_center, fs)
    d = C2(
        x.re * dr - x.im * di,
        x.re * di + x.im * dr,
    )
    taps = lowpass_taps(num_taps, fs / (2 * decim), fs)
    filt = C2(fir_causal(d.re, taps), fir_causal(d.im, taps))
    dec = C2(filt.re[..., ::decim], filt.im[..., ::decim])
    factors = zoom_dft_factors(
        n // decim, m, f1, f2, fs / decim,
        delay=(num_taps - 1) / 2 / decim,
    )
    return dft_apply(dec, factors)
