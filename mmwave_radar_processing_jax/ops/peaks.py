"""Vectorized peak finding with prominences (scipy ``find_peaks`` equivalent).

The reference leans on ``scipy.signal.find_peaks`` with prominence filtering in
four places: range-profile peaks (``range_resp.py:126``), Doppler-azimuth row
peaks (``doppler_azimuth_resp.py:371``), zero-azimuth column peaks
(``doppler_azimuth_resp.py:409``), and calibration target selection.  On an
accelerator a sequential peak walk is a non-starter; instead local maxima and
prominences are computed as dense O(N^2) masked reductions — for spectra of
63-256 bins this is a handful of tiny fused elementwise ops, far cheaper than
a host round-trip.

Divergence note: scipy treats the midpoint of a flat plateau as a peak; here a
peak is a strict local maximum (``x[i-1] < x[i] > x[i+1]``).  Exact plateaus do
not occur in floating-point FFT magnitudes, and the golden tests confirm parity
on real and synthetic spectra.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.ops.masked import mask_to_indices


@jax.jit
def local_maxima(x: jax.Array) -> jax.Array:
    """Boolean mask of strict interior local maxima of a 1D signal."""
    left = jnp.concatenate([jnp.array([jnp.inf], x.dtype), x[:-1]])
    right = jnp.concatenate([x[1:], jnp.array([jnp.inf], x.dtype)])
    return (x > left) & (x > right)


@jax.jit
def prominences(x: jax.Array, peak_mask: jax.Array) -> jax.Array:
    """Topographic prominence of every sample treated as a peak.

    Matches scipy's definition (``peak_prominences`` with full window): the
    prominence of peak ``i`` is ``x[i] - max(left_base, right_base)`` where
    each base is the minimum of ``x`` between the peak and the nearest
    strictly-higher sample on that side (or the signal edge).

    Dense O(N^2) formulation: for each (peak, sample) pair build interval
    membership masks and reduce.  Entries where ``peak_mask`` is False are 0.

    This IS the production path, deliberately: an asymptotically better
    O(N log N) ANSV formulation (:func:`prominences_ansv`, kept as a
    recorded negative result) is bit-identical but was far slower in the
    velocity pipeline on the first target — its per-element sparse-table
    gathers do not vectorize, while the dense masks fuse into a handful of
    full-width reductions.
    """
    n = x.shape[0]
    i = jnp.arange(n)[:, None]
    j = jnp.arange(n)[None, :]
    h = x[:, None]
    xj = x[None, :]

    higher_left = (j < i) & (xj > h)
    nearest_higher_left = jnp.max(jnp.where(higher_left, j, -1), axis=1)
    in_left = (j > nearest_higher_left[:, None]) & (j <= i)
    left_min = jnp.min(jnp.where(in_left, xj, jnp.inf), axis=1)

    higher_right = (j > i) & (xj > h)
    nearest_higher_right = jnp.min(jnp.where(higher_right, j, n), axis=1)
    in_right = (j >= i) & (j < nearest_higher_right[:, None])
    right_min = jnp.min(jnp.where(in_right, xj, jnp.inf), axis=1)

    prom = x - jnp.maximum(left_min, right_min)
    return jnp.where(peak_mask, prom, 0.0)


def _log_tables(x: jax.Array, levels: int, pad: float, op) -> jax.Array:
    """Doubling (sparse) table: ``T[k, s] = op(x[s .. s+2^k-1])``, padded."""
    n = x.shape[0]
    t = x
    rows = [t]
    for k in range(1, levels + 1):
        half = 1 << (k - 1)
        shifted = jnp.concatenate(
            [t[half:], jnp.full((half,), pad, x.dtype)]
        ) if half < n else jnp.full((n,), pad, x.dtype)
        t = op(t, shifted)
        rows.append(t)
    return jnp.stack(rows)  # [levels+1, n]


@jax.jit
def prominences_ansv(x: jax.Array, peak_mask: jax.Array) -> jax.Array:
    """O(N log N) prominence — recorded NEGATIVE RESULT; do not wire in.

    Same contract and bit-identical output as :func:`prominences` (every op
    is a comparison, min, or max — no rounding; asserted across a randomized
    size/tie/monotone sweep in ``tests/test_ops.py``): the nearest strictly-higher sample on each side
    is located by a binary descent over a doubling range-max table (skip a
    2^k block iff its max is <= x[i] — the greedy skip sequence is exactly
    the binary decomposition of the true distance), and each side's base is
    a two-overlapping-intervals range-min query on a doubling range-min
    table.

    Far slower than the dense form in the velocity pipeline on the first
    target (not re-measured on the GPU): the data-dependent
    ``table[k, idx]`` gathers (one per element per descent level) do not
    vectorize, where the dense O(N^2) masks fuse into full-width reductions.
    At spectrum-row sizes (N = 60-256) asymptotics never get a chance.  Kept
    for documentation and as a CPU-friendly alternative.
    """
    n = x.shape[0]
    if n <= 16:  # tables + gathers don't pay on rows this short
        return prominences(x, peak_mask)
    k_hi = max(1, int(np.ceil(np.log2(n))))  # descent levels: K-1 .. 0
    k_min = int(np.floor(np.log2(n)))  # max level a range-min query needs
    tmax = _log_tables(x, k_hi - 1, -np.inf, jnp.maximum)
    tmin = _log_tables(x, k_min, np.inf, jnp.minimum)
    i = jnp.arange(n)

    def descend(start, leftward: bool):
        """Exclusive boundary of the all-<=x[i] run on one side."""
        p = start
        for k in range(k_hi - 1, -1, -1):
            step = 1 << k
            if leftward:
                s = p - step
                ok = (s >= 0) & (tmax[k][jnp.clip(s, 0, n - 1)] <= x)
                p = jnp.where(ok, s, p)
            else:
                ok = (p + step <= n) & (tmax[k][jnp.clip(p, 0, n - 1)] <= x)
                p = jnp.where(ok, p + step, p)
        return p

    def range_min(lo, hi):
        """min(x[lo..hi]) per element, hi >= lo (two overlapping intervals)."""
        length = hi - lo + 1
        k = jnp.zeros_like(length)
        for t in range(1, k_min + 1):
            k = k + (length >= (1 << t)).astype(k.dtype)
        step = jnp.left_shift(jnp.ones_like(k), k)
        return jnp.minimum(tmin[k, lo], tmin[k, hi - step + 1])

    p = descend(i, leftward=True)  # interval (nearest-higher-left, i] = [p, i]
    q = descend(i + 1, leftward=False)  # [i, nearest-higher-right) = [i, q-1]
    left_min = range_min(p, i)
    right_min = range_min(i, q - 1)
    prom = x - jnp.maximum(left_min, right_min)
    return jnp.where(peak_mask, prom, 0.0)


@partial(jax.jit, static_argnames=("capacity",))
def find_peaks(x: jax.Array, capacity: int, min_prominence: float | None = None):
    """All strict local maxima (optionally prominence-filtered), index order.

    Returns ``(indices, valid, count)`` fixed-capacity padded arrays, ascending
    index order — matching ``scipy.signal.find_peaks`` output ordering.
    """
    mask = local_maxima(x)
    if min_prominence is not None:
        mask = mask & (prominences(x, mask) >= min_prominence)
    return mask_to_indices(mask, capacity)


@partial(jax.jit, static_argnames=("capacity",))
def best_peak(x: jax.Array, capacity: int = 32):
    """Highest-amplitude local maximum.

    Returns ``(index, value, found)``.  Mirrors the reference pattern
    ``peaks[np.argmax(x[peaks])]`` (``doppler_azimuth_resp.py:409-413``).
    """
    mask = local_maxima(x)
    vals = jnp.where(mask, x, -jnp.inf)
    idx = jnp.argmax(vals)
    found = jnp.any(mask)
    return idx, x[idx], found


@partial(jax.jit, static_argnames=("max_peaks",))
def top_peaks_within_threshold(
    x_db: jax.Array,
    max_peaks: int,
    min_prominence: float = 6.0,
    threshold_db: float = 20.0,
):
    """Strongest prominent peaks within ``threshold_db`` of the maximum peak.

    Re-design of ``RangeProcessor.find_peaks`` (``range_resp.py:104-150``):
    prominence-6dB local maxima, drop peaks more than ``threshold_db`` below
    the strongest, keep the ``max_peaks`` largest sorted descending by value.

    Returns ``(indices, values, valid)`` of shape ``(max_peaks,)``.

    Prominences are evaluated at peak candidates only (see
    :func:`_candidate_peaks` — an exact bound); the candidate list is
    value-descending with index-ascending ties, i.e. exactly ``lax.top_k``'s
    order over the dense masked row, so the selection is bit-compatible with
    the dense formulation (asserted in ``tests/test_ops.py``).
    """
    cand_vals, cand_idx = _candidate_peaks(x_db)
    prom = _prominences_at(x_db, cand_vals, cand_idx)
    passing = jnp.isfinite(cand_vals) & (prom >= min_prominence)
    vals = jnp.where(passing, cand_vals, -jnp.inf)
    max_val = jnp.max(vals)
    passing = passing & (cand_vals >= max_val - threshold_db)
    vals = jnp.where(passing, cand_vals, -jnp.inf)
    k = min(max_peaks, vals.shape[0])
    top_vals, sel = jax.lax.top_k(vals, k)
    top_idx = jnp.where(jnp.isfinite(top_vals), cand_idx[sel], 0)
    if k < max_peaks:  # row shorter than the requested peak count
        pad = max_peaks - k
        top_vals = jnp.pad(top_vals, (0, pad), constant_values=-jnp.inf)
        top_idx = jnp.pad(top_idx, (0, pad))
    valid = jnp.isfinite(top_vals)
    return top_idx, jnp.where(valid, top_vals, 0.0), valid


def _candidate_peaks(x: jax.Array):
    """Top-(N//2) local maxima by value — an exact candidate bound.

    Strict local maxima cannot be adjacent, so an N-sample row holds at most
    ``ceil((N-1)/2)`` of them; the top-``(N+1)//2`` by value therefore
    contain EVERY peak.  Returns ``(cand_vals, cand_idx)`` value-descending
    (ties index-ascending, ``lax.top_k`` convention); non-peak slots carry
    ``-inf``.
    """
    m = (x.shape[0] + 1) // 2
    return jax.lax.top_k(jnp.where(local_maxima(x), x, -jnp.inf), m)


def _prominences_at(x: jax.Array, cand_vals: jax.Array,
                    cand_idx: jax.Array) -> jax.Array:
    """Topographic prominence at the candidate positions only.

    Same pairwise formulation as :func:`prominences` on ``(M, N)`` masks
    instead of ``(N, N)`` — the full dense pass wastes >half its vector ops
    on non-peak rows.
    """
    n = x.shape[0]
    i = cand_idx[:, None]
    j = jnp.arange(n)[None, :]
    xi = cand_vals[:, None]
    xj = x[None, :]
    higher_left = (j < i) & (xj > xi)
    nhl = jnp.max(jnp.where(higher_left, j, -1), axis=1)
    in_left = (j > nhl[:, None]) & (j <= i)
    left_min = jnp.min(jnp.where(in_left, xj, jnp.inf), axis=1)
    higher_right = (j > i) & (xj > xi)
    nhr = jnp.min(jnp.where(higher_right, j, n), axis=1)
    in_right = (j >= i) & (j < nhr[:, None])
    right_min = jnp.min(jnp.where(in_right, xj, jnp.inf), axis=1)
    return cand_vals - jnp.maximum(left_min, right_min)


@partial(jax.jit, static_argnames=("min_prominence",))
def best_prominent_peak(x: jax.Array, min_prominence: float):
    """Highest-value local maximum with prominence >= ``min_prominence``.

    Bit-compatible with ``argmax(where(local_maxima & (prominences >= p),
    x, -inf))`` but ~2x cheaper: strict local maxima of an N-sample row
    number at most ceil((N-1)/2), so prominences are evaluated only at the
    top-(N//2) candidates by value (an exact bound — the candidate set can
    never overflow) on (M, N) masks instead of the full (N, N) pair matrix.
    Round-5 velocity stage bisection put 3.2 ms of the 15.5 ms dispatch in
    the dense per-row prominence pass; this is the semantics-preserving
    half of that cost.

    Returns ``(index, found)``.
    """
    n = x.shape[0]
    cand_vals, cand_idx = _candidate_peaks(x)
    prom = _prominences_at(x, cand_vals, cand_idx)
    passing = jnp.isfinite(cand_vals) & (prom >= min_prominence)
    # exact argmax-first semantics: highest passing value, ties broken
    # toward the LOWEST index (jnp.argmax returns the first occurrence in
    # the dense formulation)
    vmax = jnp.max(jnp.where(passing, cand_vals, -jnp.inf))
    best_idx = jnp.min(jnp.where(passing & (cand_vals == vmax),
                                 cand_idx, n))
    return jnp.where(best_idx < n, best_idx, 0), jnp.any(passing)
