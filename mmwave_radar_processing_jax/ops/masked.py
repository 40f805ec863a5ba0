"""Fixed-capacity masked sets — the jit-friendly replacement for dynamic-length lists.

Everything under ``jit`` must be shape-static, so "a variable number of
detections" becomes a padded index array plus a validity mask and a count.
These helpers convert between boolean maps and padded index sets and are used
throughout the detector / point-cloud / estimator stages.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("capacity",))
def mask_to_indices(mask: jax.Array, capacity: int):
    """Indices of True entries of a 1D boolean mask, in ascending order.

    Returns ``(indices, valid, count)``:
    - ``indices``: (capacity,) int32, first ``count`` entries are the True
      positions in ascending order; the rest are 0-padded.
    - ``valid``: (capacity,) bool validity mask.
    - ``count``: () int32 number of True entries (clamped to ``capacity``).

    min-k compaction: valid entries keep their index as the key, invalid
    entries push to the end; the ``capacity`` smallest keys in ascending
    order are exactly the first-``capacity`` True positions, selected with
    ``lax.top_k`` on the negated keys.
    """
    n = mask.shape[0]
    k = min(capacity, n)
    keys = jnp.where(mask, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    order = -jax.lax.top_k(-keys, k)[0]
    if k < capacity:  # capacity may exceed the mask length
        order = jnp.pad(order, (0, capacity - k), constant_values=n)
    valid = order < n
    indices = jnp.where(valid, order, 0).astype(jnp.int32)
    count = jnp.minimum(jnp.sum(mask).astype(jnp.int32), capacity)
    return indices, valid, count


@partial(jax.jit, static_argnames=("capacity", "interior"))
def mask_to_indices_2d(mask: jax.Array, capacity: int, *, interior=None):
    """Row-major (row, col) indices of True entries of a 2D boolean mask.

    Returns ``(rows, cols, valid, count)`` with the same padding semantics as
    :func:`mask_to_indices`.  Row-major order matches ``np.where`` and hence
    the reference's ``list(zip(*np.where(mask)))`` detection ordering
    (``detectors/base.py:229-230``).

    ``interior``: optional static ``(edge_rows, edge_cols)``.  When given,
    the caller guarantees every True entry lies inside
    ``mask[er:-er, ed:-ed]`` (CFAR detection maps pad their edges False by
    construction — ``ops/cfar.py`` ``os_2d_detect``), and the min-k
    compaction runs on that interior slab only (~30% fewer keys on the
    flagship 63x70 map with (8, 7) edges, ~0.5 ms of a 10 ms batch-1024
    dispatch) with indices mapped back to full-map coordinates.  Results are
    identical because interior row-major order is full-map row-major order
    restricted to the interior.
    """
    if interior is not None and any(interior):
        er, ed = interior
        r, c = mask.shape
        inner = mask[er : r - er, ed : c - ed]
        ri, ci, valid, count = mask_to_indices_2d(inner, capacity)
        return (jnp.where(valid, ri + er, 0), jnp.where(valid, ci + ed, 0),
                valid, count)
    r, c = mask.shape
    flat_idx, valid, count = mask_to_indices(mask.reshape(-1), capacity)
    return flat_idx // c, flat_idx % c, valid, count


def top_k_masked(values: jax.Array, valid: jax.Array, k: int):
    """Top-k of ``values`` restricted to ``valid`` entries.

    Returns ``(top_values, top_indices, top_valid)``; invalid inputs are
    treated as -inf and never selected as valid outputs.
    """
    neg_inf = jnp.asarray(-jnp.inf, values.dtype)
    masked = jnp.where(valid, values, neg_inf)
    top_values, top_indices = jax.lax.top_k(masked, k)
    return top_values, top_indices, top_values > neg_inf
