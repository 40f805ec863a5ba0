"""Capon / Bartlett covariance beamforming — split-complex matmul kernels.

The reference library estimates angles with a zero-padded FFT over antenna
snapshots (``processors/point_cloud_generator.py:143-214``) and builds
range-azimuth maps with an antenna-axis FFT (``range_angle_resp.py:104-120``).
This module generalizes both to the classical covariance beamformers named in
the build's north star:

- **Bartlett** (conventional): ``P(theta) = a(theta)^H R a(theta)``, which on a
  per-snapshot basis is exactly the squared-magnitude DTFT the FFT path
  evaluates — but computed on the *exact* quirky reference angle grid
  (``config/grids.py`` ``arcsin(delta_phi/pi)``) rather than FFT bin centers.
- **Capon / MVDR**: ``P(theta) = 1 / (a(theta)^H R^{-1} a(theta))`` with
  diagonal loading — super-resolution relative to Bartlett at the cost of a
  per-range-bin Hermitian solve.

Design notes:

- Everything is split-complex (:class:`~mmwave_radar_processing_jax.ops.mxu.C2`),
  like the rest of the device path (``ops/mxu.py``).
- The snapshot covariance ``R = X X^H / K`` and the steering contraction are
  plain batched matmuls, batched over (frame, range-bin).
- The Capon solve avoids complex linear algebra entirely via the standard
  *real embedding*: a Hermitian ``R = Rr + j Ri`` maps to the real symmetric
  ``[[Rr, -Ri], [Ri, Rr]]`` (SPD iff ``R`` is HPD), so a batched float32
  Cholesky + triangular solve computes
  ``a^H R^{-1} a = embed(a)^T embed(R)^{-1} embed(a)``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.ops.mxu import C2


# --------------------------------------------------------------------------- #
# steering matrices (static constants)
# --------------------------------------------------------------------------- #
def steering_ula(phase_shifts: np.ndarray, n_antennas: int) -> C2:
    """Steering matrix for a uniform linear array on a phase-shift grid.

    ``a[n, m] = exp(-j * n * phase_shifts[m])``: a target at azimuth ``az``
    produces antenna phases ``-pi * n * sin(az)`` (TI ladder convention,
    ``data/simulator.py`` array phase), so the Bartlett spectrum peaks at the
    grid entry with ``phase_shifts[m] = pi * sin(az)`` — i.e. exactly at
    ``grids.angle_bins[m] = arcsin(phase_shifts[m]/pi) = az``.  This matches
    the reference's zero-padded FFT AoA (``point_cloud_generator.py:143-214``),
    which maps the ascending-frequency FFT index into the *descending*
    phase-shift grid (``range_angle_resp.py:38-48``), but evaluated on the
    quirky reference grid directly instead of FFT bin centers.

    Returns:
        ``C2`` of shape ``(n_antennas, n_angles)``, float32.
    """
    n = np.arange(n_antennas)[:, None]
    ang = -n * np.asarray(phase_shifts)[None, :]
    return C2(jnp.asarray(np.cos(ang), jnp.float32),
              jnp.asarray(np.sin(ang), jnp.float32))


def steering_planar(
    positions_yz: np.ndarray,
    az_rad: np.ndarray,
    el_rad: np.ndarray,
) -> C2:
    """Steering matrix for an arbitrary planar array over an az x el grid.

    Args:
        positions_yz: ``(A, 2)`` element positions in **half-wavelength
            units** — ``y`` (azimuth baseline, positive left) and ``z``
            (elevation baseline, positive up) in the FLU frame used by the
            point-cloud output (``point_cloud_generator.py:216-248``).
        az_rad / el_rad: 1D angle grids; the output direction axis is the
            flattened ``(az, el)`` meshgrid, ``az`` major.

    Phase model: ``phi = -pi * (y * sin(az) * cos(el) + z * sin(el))`` — the
    plane-wave delay for unit direction ``(cos el cos az, cos el sin az,
    sin el)`` against half-wavelength-scaled positions, with the negative-going
    sign of the TI array convention (``data/simulator.py`` array phase; same
    sign choice as :func:`steering_ula`).

    Returns:
        ``C2`` of shape ``(A, n_az * n_el)``.
    """
    pos = np.asarray(positions_yz, np.float64)
    azg, elg = np.meshgrid(np.asarray(az_rad), np.asarray(el_rad), indexing="ij")
    u_y = (np.sin(azg) * np.cos(elg)).ravel()  # (M,)
    u_z = np.sin(elg).ravel()
    ang = -np.pi * (pos[:, 0:1] * u_y[None, :] + pos[:, 1:2] * u_z[None, :])
    return C2(jnp.asarray(np.cos(ang), jnp.float32),
              jnp.asarray(np.sin(ang), jnp.float32))


# --------------------------------------------------------------------------- #
# covariance + spectra (device kernels)
# --------------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=())
def spatial_covariance(x: C2) -> C2:
    """Sample spatial covariance ``R = X X^H / K`` over snapshots.

    Args:
        x: ``[..., A, K]`` split-complex antenna snapshots (``K`` = chirps).

    Returns:
        ``[..., A, A]`` split-complex Hermitian covariance — two/four real
        batched matmuls.
    """
    k = x.re.shape[-1]
    scale = 1.0 / float(k)
    xr_t = jnp.swapaxes(x.re, -1, -2)
    xi_t = jnp.swapaxes(x.im, -1, -2)
    # (xr + j xi)(xr - j xi)^T = (xr xr^T + xi xi^T) + j (xi xr^T - xr xi^T)
    rr = (x.re @ xr_t + x.im @ xi_t) * scale
    ri = (x.im @ xr_t - x.re @ xi_t) * scale
    return C2(rr, ri)


def diagonal_load(r: C2, loading: float = 1e-3, floor: float = 1e-12) -> C2:
    """Relative diagonal loading: ``R + (loading * tr(R)/A + floor) I``.

    Standard MVDR regularization — keeps the embedded matrix SPD when the
    snapshot count is below the antenna count or the scene is coherent.
    """
    a = r.re.shape[-1]
    tr = jnp.trace(r.re, axis1=-2, axis2=-1)[..., None, None]
    eye = jnp.eye(a, dtype=r.re.dtype)
    return C2(r.re + (loading * tr / a + floor) * eye, r.im)


@jax.jit
def bartlett_from_covariance(r: C2, steering: C2) -> jax.Array:
    """Bartlett spectrum ``P_m = a_m^H R a_m`` (real for Hermitian ``R``).

    Args:
        r: ``[..., A, A]`` covariance; steering: ``(A, M)``.

    Returns:
        ``[..., M]`` float32 power.
    """
    # y = R a  (complex):  yr = Rr ar - Ri ai ; yi = Rr ai + Ri ar
    yr = r.re @ steering.re - r.im @ steering.im
    yi = r.re @ steering.im + r.im @ steering.re
    # P = Re(a^H y) = sum_n (ar yr + ai yi)
    return jnp.sum(steering.re * yr + steering.im * yi, axis=-2)


@jax.jit
def bartlett_from_snapshots(x: C2, steering: C2) -> jax.Array:
    """Bartlett spectrum directly from snapshots: ``mean_k |a^H x_k|^2``.

    Mathematically identical to :func:`bartlett_from_covariance` of the
    sample covariance, but skips forming ``R``: one ``[M, A] x [A, K]``
    contraction per batch element.
    """
    ar_t = steering.re.T  # (M, A)
    ai_t = steering.im.T
    # s = a^H x : sr = ar^T xr + ai^T xi ; si = ar^T xi - ai^T xr
    sr = jnp.einsum("ma,...ak->...mk", ar_t, x.re) + \
        jnp.einsum("ma,...ak->...mk", ai_t, x.im)
    si = jnp.einsum("ma,...ak->...mk", ar_t, x.im) - \
        jnp.einsum("ma,...ak->...mk", ai_t, x.re)
    return jnp.mean(sr * sr + si * si, axis=-1)


def _real_embed(r: C2) -> jax.Array:
    """``[..., 2A, 2A]`` real symmetric embedding of a Hermitian ``R``."""
    top = jnp.concatenate([r.re, -r.im], axis=-1)
    bot = jnp.concatenate([r.im, r.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _unrolled_cho_solve(m2: jax.Array, b_full: jax.Array) -> jax.Array:
    """Batched SPD solve with a fully unrolled Cholesky (small static n).

    ``jnp.linalg.cholesky`` + ``cho_solve`` can lower small batched
    factorizations to sequential loops.  For the radar's aperture sizes
    (n = 2A <= 24) the factorization unrolls into O(n^2) *elementwise*
    recurrences over the [batch] axis — plain elementwise code that XLA
    fuses — followed by unrolled forward/back substitution on the
    ``[..., n, M]`` RHS.

    Args:
        m2: ``[..., n, n]`` SPD matrices.
        b_full: ``[..., n, M]`` right-hand sides.

    Returns:
        ``[..., n, M]`` solutions ``m2^{-1} b``.
    """
    n = m2.shape[-1]
    tiny = jnp.finfo(jnp.float32).tiny
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = m2[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = jnp.sqrt(jnp.maximum(s, tiny))
        l[j][j] = d
        for i in range(j + 1, n):
            s = m2[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s / d
    y = [None] * n
    for i in range(n):
        s = b_full[..., i, :]
        for k in range(i):
            s = s - l[i][k][..., None] * y[k]
        y[i] = s / l[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i][..., None] * x[k]
        x[i] = s / l[i][i][..., None]
    return jnp.stack(x, axis=-2)


def _unrolled_chol_inverse(m2: jax.Array) -> jax.Array:
    """Batched ``L^{-1}`` of the Cholesky factor, fully unrolled (small n).

    Same elementwise-recurrence strategy as :func:`_unrolled_cho_solve`, but
    instead of substituting the ``[..., n, M]`` RHS through 2n sequential
    passes, it inverts the tiny ``[..., n, n]`` factor (forward substitution
    on the identity — O(n^3/6) elementwise ops over the batch vector) so the
    angle grid can be applied with ONE batched matmul downstream.

    Returns ``[..., n, n]`` lower-triangular ``L^{-1}``.
    """
    n = m2.shape[-1]
    tiny = jnp.finfo(jnp.float32).tiny
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = m2[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = jnp.sqrt(jnp.maximum(s, tiny))
        l[j][j] = d
        for i in range(j + 1, n):
            s = m2[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s / d
    inv = [[None] * n for _ in range(n)]
    for j in range(n):
        inv[j][j] = 1.0 / l[j][j]
        for i in range(j + 1, n):
            s = l[i][j] * inv[j][j]
            for k in range(j + 1, i):
                s = s + l[i][k] * inv[k][j]
            inv[i][j] = -s / l[i][i]
    zero = jnp.zeros_like(m2[..., 0, 0])
    rows = [
        jnp.stack([inv[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


@partial(jax.jit, static_argnames=("method",))
def capon_from_covariance(
    r: C2, steering: C2, *, loading: float = 1e-3, method: str = "linv"
) -> jax.Array:
    """Capon/MVDR spectrum ``P_m = 1 / (a_m^H R^{-1} a_m)``.

    Solves the Hermitian system through the real embedding
    ``[[Rr, -Ri], [Ri, Rr]]`` (SPD for loaded HPD ``R``) with float32
    Cholesky machinery — no complex dtypes on device.  ``a^H R^{-1} a`` is
    real, equal to ``embed(a)^T embed(R)^{-1} embed(a)``.

    ``method``:

    - ``"linv"`` (default): invert the tiny triangular
      factor in unrolled elementwise code, then
      ``P_m = 1 / ||L^{-1} b_m||^2`` — the whole angle grid applies as ONE
      batched ``[.., n, n] x (n, M)`` matmul with a fused square-sum;
      no broadcast RHS and no 2n sequential ``[.., n, M]`` substitution
      passes touching HBM.
    - ``"solve"``: the unrolled Cholesky solve on the broadcast
      RHS (kept for A/B and as the fallback oracle).

    Args:
        r: ``[..., A, A]`` covariance (unloaded; loading applied here).
        steering: ``(A, M)``.

    Returns:
        ``[..., M]`` float32 Capon power.
    """
    if method not in ("linv", "solve"):
        # a misconfiguration would otherwise silently run the slow solve
        # path (mirrors rd_values_from_range_dft's mode check)
        raise ValueError(
            f"capon_from_covariance: unknown method {method!r} "
            "(expected 'linv' or 'solve')")
    r = diagonal_load(r, loading)
    m2 = _real_embed(r)  # [..., 2A, 2A]
    b = jnp.concatenate([steering.re, steering.im], axis=0)  # (2A, M)
    if method == "linv" and m2.shape[-1] <= 24:
        linv = _unrolled_chol_inverse(m2)  # [..., n, n]
        g = jnp.einsum("...ij,jm->...im", linv, b)
        denom = jnp.sum(g * g, axis=-2)
        return 1.0 / jnp.maximum(denom, jnp.finfo(jnp.float32).tiny)
    b_full = jnp.broadcast_to(b, m2.shape[:-2] + b.shape)
    if m2.shape[-1] <= 24:
        y = _unrolled_cho_solve(m2, b_full)
    else:
        chol = jnp.linalg.cholesky(m2)
        y = jax.scipy.linalg.cho_solve((chol, True), b_full)
    denom = jnp.sum(b * y, axis=-2)
    return 1.0 / jnp.maximum(denom, jnp.finfo(jnp.float32).tiny)
