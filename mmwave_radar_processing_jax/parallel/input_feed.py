"""Per-process local-shard input feed for the frame-DP pipelines.

SURVEY §5.8 mandates a multi-host data path ("DCN for multi-host data loading
of ADC frame streams"): on a multi-host mesh every process must load ONLY the
frames its local devices own and assemble the global batch without an
all-to-host gather.  The JAX-native mechanism is
``jax.make_array_from_process_local_data``: each process hands in its local
shard (here produced by the native C++ NPY loader /
:class:`~mmwave_radar_processing_jax.data.native_loader.SplitFramePrefetcher`)
and XLA stitches the distributed ``jax.Array`` across hosts over DCN.

On a single-process mesh (this container: one real chip, or the 8-device
virtual CPU mesh) the same code path runs with the process owning every
shard — which is exactly what the scaling harness exercises, so the feed
cost is *included* in the measured scaling rows
(``bench.py --metric scaling`` -> ``input_feed_included: true``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmwave_radar_processing_jax.data.native_loader import (
    SplitFramePrefetcher,
    load_frames_split,
)


def process_local_frame_slice(mesh: Mesh, n_global: int, axis: str = "data"
                              ) -> slice:
    """Global frame-index slice owned by this process on a frame-DP mesh.

    The batch axis is sharded over ``axis``; with ``D`` total devices each
    device owns ``n_global // D`` consecutive frames, and a process owns the
    contiguous run covered by its local devices (JAX orders mesh devices so
    that a process's addressable devices are contiguous along the mesh
    axes for standard device assignments).
    """
    n_dev = mesh.shape[axis]
    if n_global % n_dev:
        raise ValueError(f"global batch {n_global} not divisible by {n_dev}")
    per_dev = n_global // n_dev
    # ownership is along the SHARDING axis only: on a multi-axis mesh (e.g.
    # (data, model)) every device at data-row i holds frame shard i, so a
    # process owns the data-rows its local devices touch — flattening the
    # whole device grid (the old behavior) over-counted rows by the size of
    # the other axes and produced out-of-range slices on 2D meshes (caught
    # by the n=16/32 dryrun test)
    ax = mesh.axis_names.index(axis)
    local_ids = {d.id for d in jax.local_devices()}
    owned = sorted({
        idx[ax]
        for idx, d in np.ndenumerate(mesh.devices)
        if d.id in local_ids
    })
    if not owned:
        return slice(0, 0)
    if owned != list(range(owned[0], owned[-1] + 1)):
        raise ValueError("process-local devices not contiguous on the mesh")
    return slice(owned[0] * per_dev, (owned[-1] + 1) * per_dev)


def global_batch_from_local(
    mesh: Mesh, local: np.ndarray, axis: str = "data"
) -> jax.Array:
    """Assemble the global frame-sharded array from this process's shard."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local)


def sharded_recording_feed(
    mesh: Mesh,
    paths: Sequence[str],
    frame_shape: Tuple[int, ...],
    *,
    global_batch: int,
    axis: str = "data",
    altitude: float = 1.2,
    nthreads: int = 8,
) -> Iterator[Tuple[jax.Array, jax.Array, jax.Array]]:
    """Stream ``(raw_re, raw_im, altitude)`` global batches from NPY frames.

    Each process prefetches only its local slice of every global batch
    through the native loader (double-buffered on host threads), then
    assembles the distributed array — the multi-host feed path run on
    however many processes the mesh actually spans.
    """
    n_batches = len(paths) // global_batch
    local = process_local_frame_slice(mesh, global_batch, axis)
    local_paths: List[str] = []
    for b in range(n_batches):
        chunk = list(paths[b * global_batch:(b + 1) * global_batch])
        local_paths.extend(chunk[local])
    per_batch = local.stop - local.start
    if per_batch == 0:
        return
    prefetcher = SplitFramePrefetcher(local_paths, frame_shape,
                                      batch=per_batch, nthreads=nthreads)
    alt_local = np.full(per_batch, altitude, np.float32)
    for re_local, im_local in prefetcher:
        yield (
            global_batch_from_local(mesh, re_local, axis),
            global_batch_from_local(mesh, im_local, axis),
            global_batch_from_local(mesh, alt_local, axis),
        )


__all__ = [
    "global_batch_from_local",
    "load_frames_split",
    "process_local_frame_slice",
    "sharded_recording_feed",
]
