"""Chirp-z transform (zoom FFT) via Bluestein's algorithm.

The reference uses ``scipy.signal.ZoomFFT`` for high-resolution spectral zoom
(``range_resp.py:92``, ``doppler_azimuth_resp.py:154``).  A CZT is exactly two
FFTs plus pointwise complex multiplies — an ideal accelerator shape: the chirp factors
are static trace-time constants and XLA fuses the pointwise work into the FFT
pipeline.

Semantics match ``scipy.signal.ZoomFFT(n, [f1, f2], fs=fs)`` with the scipy
defaults ``m=n``, ``endpoint=False``:

    scale = (f2 - f1) / fs
    y[k]  = sum_j x[j] * exp(-2j*pi*(f1/fs + scale*k/m)*j),   k = 0..m-1

i.e. ``m`` frequency samples from ``f1`` (inclusive) stepping ``(f2-f1)/m``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def czt_factors(n: int, m: int, f1: float, f2: float, fs: float):
    """Precompute static Bluestein factors for a zoom FFT.

    Returns ``(awk2, fwk2, wk2_m, nfft)`` as numpy constants:
    - ``awk2``: (n,) input chirp factors ``exp(-2j*pi*f1*j/fs) * w(j)``
    - ``fwk2``: (nfft,) FFT of the reciprocal chirp
    - ``wk2_m``: (m,) output chirp factors
    """
    k = np.arange(max(m, n), dtype=np.float64)
    scale = (f2 - f1) / fs  # endpoint=False convention
    wk2 = np.exp(-1j * np.pi * scale * k**2 / m)
    ak = np.exp(-2j * np.pi * f1 / fs * k[:n])
    awk2 = ak * wk2[:n]
    nfft = _next_pow2(n + m - 1)
    fwk2 = np.fft.fft(1.0 / np.concatenate([wk2[n - 1:0:-1], wk2[:m]]), nfft)
    return (
        awk2.astype(np.complex64),
        fwk2.astype(np.complex64),
        wk2[:m].astype(np.complex64),
        nfft,
    )


@partial(jax.jit, static_argnames=("n", "m", "f1", "f2", "fs", "axis"))
def zoom_fft(
    x: jax.Array,
    *,
    n: int,
    m: int | None = None,
    f1: float,
    f2: float,
    fs: float = 2.0,
    axis: int = -1,
) -> jax.Array:
    """Zoom FFT of ``x`` along ``axis`` over the band ``[f1, f2)``.

    Drop-in equivalent of ``scipy.signal.ZoomFFT(n, [f1, f2], fs=fs)(x, axis)``
    (validated by golden tests).  ``n`` must equal ``x.shape[axis]``.
    """
    if m is None:
        m = n
    awk2, fwk2, wk2_m, nfft = czt_factors(n, m, float(f1), float(f2), float(fs))

    x = jnp.moveaxis(x, axis, -1)
    y = x.astype(jnp.complex64) * jnp.asarray(awk2)
    y = jnp.fft.ifft(jnp.fft.fft(y, n=nfft, axis=-1) * jnp.asarray(fwk2), axis=-1)
    y = y[..., n - 1 : n + m - 1] * jnp.asarray(wk2_m)
    return jnp.moveaxis(y, -1, axis)


@partial(jax.jit, static_argnames=("n", "m", "fs", "axis"))
def zoom_fft_dynamic(
    x: jax.Array,
    f1: jax.Array,
    f2: jax.Array,
    *,
    n: int,
    m: int | None = None,
    fs: float = 2.0,
    axis: int = -1,
) -> jax.Array:
    """Zoom FFT with *traced* band edges ``f1``/``f2`` (scalars).

    Same math as :func:`zoom_fft` but the Bluestein chirp factors are computed
    in-graph, so a pipeline whose zoom window is data-dependent (altimeter
    refinement around the tracked ground peak, precise Doppler zoom centered on
    the running ``-vx`` estimate) compiles exactly once.  Only the band moves;
    ``n``/``m`` stay static, as jitted shapes must.
    """
    if m is None:
        m = n
    kmax = max(m, n)
    k = jnp.arange(kmax, dtype=jnp.float32)
    scale = (f2 - f1) / fs
    wk2 = jnp.exp(-1j * jnp.pi * scale * k**2 / m)
    ak = jnp.exp(-2j * jnp.pi * f1 / fs * k[:n])
    awk2 = ak * wk2[:n]
    nfft = _next_pow2(n + m - 1)
    fwk2 = jnp.fft.fft(
        1.0 / jnp.concatenate([wk2[n - 1:0:-1], wk2[:m]]), n=nfft
    )

    x = jnp.moveaxis(x, axis, -1)
    y = x.astype(jnp.complex64) * awk2
    y = jnp.fft.ifft(jnp.fft.fft(y, n=nfft, axis=-1) * fwk2, axis=-1)
    y = y[..., n - 1 : n + m - 1] * wk2[:m]
    return jnp.moveaxis(y, -1, axis)
