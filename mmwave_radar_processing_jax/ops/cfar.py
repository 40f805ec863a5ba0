"""CFAR threshold maps (CA / GO / SO / OS, 1D and 2D) as vectorized kernels.

Re-design of the reference's sliding-window CFAR detectors
(``detectors/base.py``, ``ca_cfar.py``, ``go_so_cfar.py``, ``os_cfar.py``) for
the accelerator: instead of ``numpy.lib.stride_tricks.sliding_window_view`` + per-window
Python, every cell-under-test's training set is materialized with one static
gather, and the noise statistic (mean / one-sided means / rank) is a dense
reduction or sort along the window axis.  All window geometry is static at
trace time, so XLA sees fixed-shape gathers it can tile.

Conventions matched to the reference:

- Window = ``2*(num_train + num_guard) + 1`` per axis; cells whose window falls
  off the edge get ``+inf`` thresholds (no detections there) and 0 noise
  (``ca_cfar.py:22-25``).
- CA alpha ``N*(pfa^(-1/N)-1)`` with N = total training cells; GO/SO use the
  one-sided N (``go_so_cfar.py:58``).
- OS-CFAR takes rank ``k = clamp(int(rho*N), 1, N)`` (1-based) and a
  user-supplied alpha; ``pfa`` is unused (``os_cfar.py:22-27``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def alpha_ca(num_train_cells: int, pfa: float) -> float:
    """CA-CFAR scaling ``N * (pfa^(-1/N) - 1)`` (exponential noise model)."""
    return num_train_cells * (pfa ** (-1.0 / num_train_cells) - 1.0)


# --------------------------------------------------------------------------- #
# window gathers (static geometry)
# --------------------------------------------------------------------------- #
def _windows_1d(x: jax.Array, win: int) -> jax.Array:
    """(L - win + 1, win) sliding windows via a static gather."""
    n_out = x.shape[-1] - win + 1
    idx = np.arange(n_out)[:, None] + np.arange(win)[None, :]
    return x[..., idx]


def _windows_2d(x: jax.Array, win_r: int, win_d: int) -> jax.Array:
    """(R', D', win_r, win_d) sliding windows via a static gather."""
    r_out = x.shape[-2] - win_r + 1
    d_out = x.shape[-1] - win_d + 1
    ridx = (np.arange(r_out)[:, None] + np.arange(win_r)[None, :])  # (R', Wr)
    didx = (np.arange(d_out)[:, None] + np.arange(win_d)[None, :])  # (D', Wd)
    return x[..., ridx[:, None, :, None], didx[None, :, None, :]]


def _train_stack_2d(x: jax.Array, num_train, num_guard) -> jax.Array:
    """(R', D', n_train) training cells via static slice-stacking.

    Each training offset is a contiguous static slice of the map, stacked on
    a trailing axis (no generic gather).  NOTE: compiled standalone at large
    batch, XLA materializes every padded slab copy before the concatenate
    and compilation OOMs, hence the chunking in :func:`os_2d`.
    """
    win_r = 2 * (num_train[0] + num_guard[0]) + 1
    win_d = 2 * (num_train[1] + num_guard[1]) + 1
    r_out = x.shape[-2] - win_r + 1
    d_out = x.shape[-1] - win_d + 1
    mask = _train_mask_2d(num_train, num_guard)
    slabs = [
        x[..., i : i + r_out, j : j + d_out]
        for i, j in np.argwhere(mask)
    ]
    return jnp.stack(slabs, axis=-1)


def _pad_valid_1d(computed: jax.Array, edge: int, fill) -> jax.Array:
    pad = [(0, 0)] * (computed.ndim - 1) + [(edge, edge)]
    return jnp.pad(computed, pad, constant_values=fill)


def _pad_valid_2d(computed: jax.Array, edge_r: int, edge_d: int, fill) -> jax.Array:
    pad = [(0, 0)] * (computed.ndim - 2) + [(edge_r, edge_r), (edge_d, edge_d)]
    return jnp.pad(computed, pad, constant_values=fill)


def _train_cols_1d(num_train: int, num_guard: int) -> np.ndarray:
    """Static window-column indices of the training cells (left + right)."""
    win = 2 * (num_train + num_guard) + 1
    cols = np.arange(win)
    left = cols[:num_train]
    right = cols[num_train + 2 * num_guard + 1 :]
    return np.concatenate([left, right])


def _train_mask_2d(num_train, num_guard) -> np.ndarray:
    win_r = 2 * (num_train[0] + num_guard[0]) + 1
    win_d = 2 * (num_train[1] + num_guard[1]) + 1
    mask = np.ones((win_r, win_d), dtype=bool)
    gr0, gr1 = num_train[0], num_train[0] + 2 * num_guard[0]
    gd0, gd1 = num_train[1], num_train[1] + 2 * num_guard[1]
    mask[gr0 : gr1 + 1, gd0 : gd1 + 1] = False
    return mask


# --------------------------------------------------------------------------- #
# 1D threshold maps
# --------------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=("num_train", "num_guard", "pfa"))
def ca_1d(x: jax.Array, *, num_train: int, num_guard: int, pfa: float):
    """CA-CFAR thresholds + noise estimates for a 1D magnitude signal."""
    edge = num_train + num_guard
    win = 2 * edge + 1
    if x.shape[-1] < win:
        return jnp.full_like(x, jnp.inf), jnp.zeros_like(x)
    windows = _windows_1d(x, win)
    train = windows[..., _train_cols_1d(num_train, num_guard)]
    means = jnp.mean(train, axis=-1)
    alpha = alpha_ca(2 * num_train, pfa)
    return _pad_valid_1d(alpha * means, edge, jnp.inf), _pad_valid_1d(means, edge, 0.0)


@partial(jax.jit, static_argnames=("num_train", "num_guard", "pfa", "greatest"))
def go_so_1d(
    x: jax.Array, *, num_train: int, num_guard: int, pfa: float, greatest: bool
):
    """GO- (``greatest=True``) / SO-CFAR thresholds for a 1D signal.

    One-sided training means combined with max (clutter-edge robust) or min
    (closely-spaced-target robust); alpha computed with the one-sided N
    (reference convention, ``go_so_cfar.py:53-58``).
    """
    edge = num_train + num_guard
    win = 2 * edge + 1
    if x.shape[-1] < win:
        return jnp.full_like(x, jnp.inf), jnp.zeros_like(x)
    windows = _windows_1d(x, win)
    mean_left = jnp.mean(windows[..., :num_train], axis=-1)
    mean_right = jnp.mean(windows[..., num_train + 2 * num_guard + 1 :], axis=-1)
    combine = jnp.maximum if greatest else jnp.minimum
    noise = combine(mean_left, mean_right)
    alpha = alpha_ca(num_train, pfa)
    return _pad_valid_1d(alpha * noise, edge, jnp.inf), _pad_valid_1d(noise, edge, 0.0)


def os_rank(rho: float, n_train: int) -> int:
    """1-based OS rank ``clamp(int(rho*N), 1, N)`` (``os_cfar.py:25-27``)."""
    return max(1, min(int(rho * n_train), n_train))


@partial(jax.jit, static_argnames=("num_train", "num_guard", "rho", "alpha"))
def os_1d(x: jax.Array, *, num_train: int, num_guard: int, rho: float, alpha: float):
    """OS-CFAR thresholds for a 1D signal (rank statistic via sort)."""
    edge = num_train + num_guard
    win = 2 * edge + 1
    if x.shape[-1] < win:
        return jnp.full_like(x, jnp.inf), jnp.zeros_like(x)
    windows = _windows_1d(x, win)
    train = windows[..., _train_cols_1d(num_train, num_guard)]
    k_idx = os_rank(rho, 2 * num_train) - 1
    noise = jnp.sort(train, axis=-1)[..., k_idx]
    return _pad_valid_1d(alpha * noise, edge, jnp.inf), _pad_valid_1d(noise, edge, 0.0)


# --------------------------------------------------------------------------- #
# 2D threshold maps
# --------------------------------------------------------------------------- #
@partial(jax.jit, static_argnames=("num_train", "num_guard", "pfa"))
def ca_2d(x: jax.Array, *, num_train, num_guard, pfa: float):
    """CA-CFAR thresholds for a 2D map (range x Doppler)."""
    edge_r = num_train[0] + num_guard[0]
    edge_d = num_train[1] + num_guard[1]
    win_r, win_d = 2 * edge_r + 1, 2 * edge_d + 1
    if x.shape[-2] < win_r or x.shape[-1] < win_d:
        return jnp.full_like(x, jnp.inf), jnp.zeros_like(x)
    windows = _windows_2d(x, win_r, win_d)
    mask = _train_mask_2d(num_train, num_guard)
    n_train = int(mask.sum())
    flat = windows.reshape(*windows.shape[:-2], -1)
    train = flat[..., np.flatnonzero(mask.reshape(-1))]
    means = jnp.sum(train, axis=-1) / n_train
    alpha = alpha_ca(n_train, pfa)
    return (
        _pad_valid_2d(alpha * means, edge_r, edge_d, jnp.inf),
        _pad_valid_2d(means, edge_r, edge_d, 0.0),
    )


# Sort-path batches are processed in lax.map chunks of this size: the slab
# stacking in _train_stack_2d expands the map ~190x, and compiling it over a
# large fused batch OOMs at *compile time* (XLA materializes every padded
# slab copy).  Chunking bounds peak memory to chunk_size * expansion while
# the while-loop body compiles once.
_SORT_BATCH_CHUNK = 32


@partial(jax.jit, static_argnames=("num_train", "num_guard", "rho", "alpha"))
def os_2d(x: jax.Array, *, num_train, num_guard, rho: float, alpha: float):
    """OS-CFAR thresholds for a 2D map (rank statistic via sort).

    Accepts leading batch dims ``[..., R, D]``.  For batched sort-path use,
    call this directly on the stacked maps (the batch is chunked internally)
    rather than ``vmap``-ing the single-map call — vmap re-introduces the
    unchunked slab expansion that OOMs compilation at large batch.
    """
    edge_r = num_train[0] + num_guard[0]
    edge_d = num_train[1] + num_guard[1]
    win_r, win_d = 2 * edge_r + 1, 2 * edge_d + 1
    if x.shape[-2] < win_r or x.shape[-1] < win_d:
        return jnp.full_like(x, jnp.inf), jnp.zeros_like(x)
    n_train = int(_train_mask_2d(num_train, num_guard).sum())
    k_rank = os_rank(rho, n_train)

    def one(xm):
        train = _train_stack_2d(xm, num_train, num_guard)
        return jnp.sort(train, axis=-1)[..., k_rank - 1]

    batch = int(np.prod(x.shape[:-2])) if x.ndim > 2 else 1
    if batch > _SORT_BATCH_CHUNK:
        flat = x.reshape((-1,) + x.shape[-2:])
        noise = jax.lax.map(one, flat, batch_size=_SORT_BATCH_CHUNK)
        noise = noise.reshape(x.shape[:-2] + noise.shape[-2:])
    else:
        noise = one(x)
    return (
        _pad_valid_2d(alpha * noise, edge_r, edge_d, jnp.inf),
        _pad_valid_2d(noise, edge_r, edge_d, 0.0),
    )


# --------------------------------------------------------------------------- #
# detection-only OS-CFAR (no rank selection)
# --------------------------------------------------------------------------- #
# For detection, the rank statistic never needs to be computed:
#
#   x > alpha * rank_k(train)   <=>   #{t in train : alpha*t < x} >= k
#
# (alpha > 0: multiplication by a positive float constant is weakly monotone,
# so {t : alpha*t < x} is downward-closed in sorted order and its size reaches
# k exactly when alpha * (k-th smallest) < x — bit-exact against the
# threshold path, ties and all; verified in tests/test_ops.py.)  Counting is a
# single pass over the training offsets, far fewer vector ops than a rank
# selection.  Use these in
# fused pipelines where only the detection mask matters; the threshold-
# returning variants above remain for the reference-compatible detector API.


@partial(jax.jit, static_argnames=("num_train", "num_guard", "rho", "alpha"))
def os_1d_detect(
    x: jax.Array, *, num_train: int, num_guard: int, rho: float, alpha: float
) -> jax.Array:
    """OS-CFAR 1D detection mask (edges False, the +inf-threshold convention).

    Accepts leading batch dims: ``[..., L] -> [..., L]`` bool.
    """
    assert alpha > 0.0
    edge = num_train + num_guard
    win = 2 * edge + 1
    if x.shape[-1] < win:
        return jnp.zeros(x.shape, bool)
    n_out = x.shape[-1] - win + 1
    k = os_rank(rho, 2 * num_train)
    center = x[..., edge : edge + n_out]
    count = jnp.zeros(center.shape, jnp.int32)
    for j in _train_cols_1d(num_train, num_guard):
        count = count + (alpha * x[..., j : j + n_out] < center)
    pad = [(0, 0)] * (x.ndim - 1) + [(edge, edge)]
    return jnp.pad(count >= k, pad, constant_values=False)


@partial(jax.jit, static_argnames=("num_train", "num_guard", "rho", "alpha"))
def os_2d_detect(
    x: jax.Array, *, num_train, num_guard, rho: float, alpha: float,
) -> jax.Array:
    """OS-CFAR 2D detection mask (edges False).

    Accepts leading batch dims: ``[..., R, D] -> [..., R, D]`` bool.

    The slice formulation nominally reads a shifted copy of the map per
    training offset, but XLA fuses the slices into one pass over the map.
    """
    assert alpha > 0.0
    edge_r = num_train[0] + num_guard[0]
    edge_d = num_train[1] + num_guard[1]
    win_r, win_d = 2 * edge_r + 1, 2 * edge_d + 1
    if x.shape[-2] < win_r or x.shape[-1] < win_d:
        return jnp.zeros(x.shape, bool)
    r_out = x.shape[-2] - win_r + 1
    d_out = x.shape[-1] - win_d + 1
    mask = _train_mask_2d(num_train, num_guard)
    k = os_rank(rho, int(mask.sum()))
    center = x[..., edge_r : edge_r + r_out, edge_d : edge_d + d_out]
    count = jnp.zeros(center.shape, jnp.int32)
    for i, j in np.argwhere(mask):
        count = count + (alpha * x[..., i : i + r_out, j : j + d_out] < center)
    pad = [(0, 0)] * (x.ndim - 2) + [(edge_r, edge_r), (edge_d, edge_d)]
    return jnp.pad(count >= k, pad, constant_values=False)
