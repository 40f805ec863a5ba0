"""Sharded CFAR with guard/train halo exchange.

When the range (or Doppler) axis is sharded across chips, every CFAR
cell-under-test near a shard boundary needs ``num_train + num_guard``
neighbor cells from the adjacent shard.  This module implements that halo
exchange with ``jax.lax.ppermute`` inside ``shard_map``: each shard sends its
edge cells to both neighbors, prepends/appends the received halos, runs the
dense local threshold kernel, and crops back — so the sharded result is
bit-identical to the single-device map (verified in tests on the virtual CPU
mesh).

The edge shards keep the ``+inf`` no-detection convention at the true signal
boundary, exactly like the unsharded kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mmwave_radar_processing_jax.ops import cfar as cfar_ops


def _exchange_halo_1d(x_local: jax.Array, halo: int, axis_name: str):
    """Append both neighbors' edges: returns (extended, pad_left, pad_right).

    Boundary shards have no neighbor; their halo slots are filled with zeros
    and the caller masks the corresponding outputs back to +inf thresholds via
    cropping (the local kernel's own edge handling covers them).

    Shapes are static under ``shard_map``, so the per-shard-rows >= halo
    requirement is checked at trace time: with fewer local rows than the halo
    width, ``x_local[-halo:]`` silently yields too few rows and the crop would
    return a wrong (misaligned) result instead of an error.
    """
    if x_local.shape[0] < halo:
        raise ValueError(
            f"sharded CFAR needs rows_per_shard >= num_train + num_guard "
            f"(= {halo}) on the sharded axis, got {x_local.shape[0]}; use "
            f"fewer shards or a smaller train/guard window"
        )
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)

    right_edge = x_local[-halo:]
    left_edge = x_local[:halo]
    # send my right edge to my right neighbor (it becomes their left halo)
    from_left = jax.lax.ppermute(
        right_edge, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    # send my left edge to my left neighbor (their right halo)
    from_right = jax.lax.ppermute(
        left_edge, axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    extended = jnp.concatenate([from_left, x_local, from_right])
    has_left = idx > 0
    has_right = idx < n - 1
    return extended, has_left, has_right


def os_cfar_1d_sharded(
    mesh: Mesh,
    *,
    num_train: int,
    num_guard: int,
    rho: float,
    alpha: float,
    axis: str = "data",
):
    """Build a sharded OS-CFAR 1D threshold fn over a range-sharded signal.

    Returns ``fn(x) -> thresholds`` where ``x`` is sharded on its only axis
    over ``axis``; the output sharding matches the input.
    """
    halo = num_train + num_guard

    def local(x_local):
        extended, has_left, has_right = _exchange_halo_1d(x_local, halo, axis)
        thr, _ = cfar_ops.os_1d(
            extended, num_train=num_train, num_guard=num_guard, rho=rho, alpha=alpha
        )
        core = thr[halo:-halo]
        m = x_local.shape[0]
        pos = jnp.arange(m)
        # interior shards got real halos; boundary shards must reproduce the
        # unsharded edge convention (+inf within ``halo`` of the true edge)
        left_bad = (~has_left) & (pos < halo)
        right_bad = (~has_right) & (pos >= m - halo)
        return jnp.where(left_bad | right_bad, jnp.inf, core)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=P(axis),
            out_specs=P(axis),
        )
    )


def ca_cfar_2d_row_sharded(
    mesh: Mesh,
    *,
    num_train,
    num_guard,
    pfa: float,
    axis: str = "data",
):
    """Sharded CA-CFAR 2D with the *range* (row) axis split over ``axis``.

    Rows near shard boundaries receive ``train+guard`` halo rows from the
    neighbor shards; columns stay local.
    """
    halo = num_train[0] + num_guard[0]

    def local(x_local):
        extended, has_left, has_right = _exchange_halo_1d(x_local, halo, axis)
        thr, _ = cfar_ops.ca_2d(
            extended, num_train=num_train, num_guard=num_guard, pfa=pfa
        )
        core = thr[halo:-halo]
        m = x_local.shape[0]
        pos = jnp.arange(m)[:, None]
        left_bad = (~has_left) & (pos < halo)
        right_bad = (~has_right) & (pos >= m - halo)
        return jnp.where(left_bad | right_bad, jnp.inf, core)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=P(axis, None),
            out_specs=P(axis, None),
        )
    )


def os_cfar_2d_detect_row_sharded(
    mesh: Mesh,
    *,
    num_train,
    num_guard,
    rho: float,
    alpha: float,
    axis: str = "data",
):
    """Sharded counting OS-CFAR 2D detection with the range axis split.

    Multi-chip counterpart of :func:`ops.cfar.os_2d_detect` (the fused
    pipelines' detection path): halo rows ride ``ppermute``, the local pass is
    the counting kernel, and the result is bit-identical to the unsharded
    detection mask (edge shards reproduce the no-detection edge convention).
    """
    halo = num_train[0] + num_guard[0]

    def local(x_local):
        extended, has_left, has_right = _exchange_halo_1d(x_local, halo, axis)
        det = cfar_ops.os_2d_detect(
            extended, num_train=num_train, num_guard=num_guard, rho=rho,
            alpha=alpha,
        )
        core = det[halo:-halo]
        m = x_local.shape[0]
        pos = jnp.arange(m)[:, None]
        left_bad = (~has_left) & (pos < halo)
        right_bad = (~has_right) & (pos >= m - halo)
        return core & ~(left_bad | right_bad)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=P(axis, None),
            out_specs=P(axis, None),
        )
    )
