"""Checkpoint / resume for stateful processor pipelines (SURVEY.md §5.4).

The reference keeps all frame-to-frame state in mutable Python attributes and
loses it on crash; here every stateful stage exposes an explicit state pytree
(altimeter scalar, micro-Doppler history, synthetic-aperture ring buffers),
so a whole pipeline's state checkpoints as one flat ``.npz`` and restores
exactly — enabling resume of long recording batch jobs mid-stream.

Complex leaves are stored as split re/im planes so checkpoints stay portable
to runtimes without complex dtype support.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import jax
import numpy as np

from mmwave_radar_processing_jax.utils.logger import get_logger

_COMPLEX_SUFFIX_RE = "::re"
_COMPLEX_SUFFIX_IM = "::im"


def _flatten(state_tree: Any):
    leaves, treedef = jax.tree.flatten(state_tree)
    return leaves, treedef


def save_state(path: str, state_tree: Any, metadata: Dict | None = None) -> None:
    """Write a state pytree (+ optional JSON metadata) to ``path`` (.npz)."""
    leaves, treedef = _flatten(state_tree)
    arrays = {}
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        if np.iscomplexobj(arr):
            arrays[f"leaf{i}{_COMPLEX_SUFFIX_RE}"] = np.real(arr)
            arrays[f"leaf{i}{_COMPLEX_SUFFIX_IM}"] = np.imag(arr)
        else:
            arrays[f"leaf{i}"] = arr
    arrays["__treedef__"] = np.frombuffer(
        str(treedef).encode(), dtype=np.uint8
    )
    if metadata:
        arrays["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8
        )
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    get_logger(__name__).info("checkpointed %d state leaves to %s", len(leaves), path)


def load_state(path: str, like_tree: Any):
    """Restore a state pytree checkpointed by :func:`save_state`.

    ``like_tree`` supplies the tree structure (e.g. ``processor.init_state()``);
    leaf values come from the checkpoint.  Returns ``(state, metadata)``.
    """
    data = np.load(path)
    leaves, treedef = _flatten(like_tree)
    restored = []
    for i, ref_leaf in enumerate(leaves):
        if f"leaf{i}" in data:
            arr = data[f"leaf{i}"]
        else:
            arr = (
                data[f"leaf{i}{_COMPLEX_SUFFIX_RE}"]
                + 1j * data[f"leaf{i}{_COMPLEX_SUFFIX_IM}"]
            )
        ref = np.asarray(ref_leaf)
        if arr.shape != ref.shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected {ref.shape}"
            )
        restored.append(arr.astype(ref.dtype))
    metadata = None
    if "__metadata__" in data:
        metadata = json.loads(bytes(data["__metadata__"]).decode())
    return jax.tree.unflatten(treedef, restored), metadata


class PipelineCheckpointer:
    """Periodic checkpointing of a dict of named processor states."""

    def __init__(self, directory: str, every_n_frames: int = 100):
        self.directory = directory
        self.every = every_n_frames
        os.makedirs(directory, exist_ok=True)

    def path(self) -> str:
        return os.path.join(self.directory, "pipeline_state.npz")

    def maybe_save(self, frame_idx: int, states: Dict[str, Any]) -> bool:
        if frame_idx % self.every != 0 or frame_idx == 0:
            return False
        save_state(self.path(), states, metadata={"frame_idx": frame_idx})
        return True

    def restore(self, like_states: Dict[str, Any]):
        """Returns ``(states, resume_frame)`` or ``(like_states, 0)`` if none."""
        if not os.path.exists(self.path()):
            return like_states, 0
        states, meta = load_state(self.path(), like_states)
        return states, int(meta["frame_idx"]) if meta else 0
