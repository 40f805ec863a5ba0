"""ctypes binding for the native C++ NPY bulk loader (``native/npy_loader.cpp``).

Builds the shared library on first use (``g++ -O3 -shared``, into the
git-ignored ``native/libnpy_loader.so``) and exposes
:func:`load_frames_split`, which loads a range of complex NPY frames into one
contiguous split re/im float32 batch with a thread pool — the host-side feed
stage for the device pipelines.  Falls back to a numpy implementation when no
compiler is available, so the API is always usable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mmwave_radar_processing_jax.utils.logger import get_logger

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO_ROOT, "native", "npy_loader.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libnpy_loader.so")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    # build beside the target and rename into place: processes that build
    # concurrently never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        # no -march=native: the library must run on whatever x86-64 host the
        # checkout lands on
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, _SRC, "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        get_logger(__name__).warning("native loader build failed: %s", e)
        return False
    os.replace(tmp, _LIB)
    return True


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            _build_failed = True
            return None
    lib = ctypes.CDLL(_LIB)
    lib.mrp_npy_info.restype = ctypes.c_int
    lib.mrp_npy_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mrp_load_frames_split.restype = ctypes.c_int
    lib.mrp_load_frames_split.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_int,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _get_lib() is not None


def npy_info(path: str) -> Tuple[Tuple[int, ...], int]:
    """(shape, dtype_enum) of one NPY file via the native parser."""
    lib = _get_lib()
    if lib is None:
        arr = np.load(path, mmap_mode="r")
        return tuple(arr.shape), 0
    shape = (ctypes.c_long * 8)()
    dtype = ctypes.c_int()
    ndim = lib.mrp_npy_info(path.encode(), shape, ctypes.byref(dtype))
    if ndim < 0:
        raise IOError(f"failed to parse NPY header: {path}")
    return tuple(shape[i] for i in range(ndim)), dtype.value


def load_frames_split(
    paths: Sequence[str],
    frame_shape: Tuple[int, ...],
    nthreads: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load complex NPY frames into split ``(re, im)`` float32 batch arrays.

    Args:
        paths: NPY file paths, one frame each, all with ``frame_shape``.
        frame_shape: per-frame shape, e.g. ``(4, 63, 210)``.
        nthreads: loader thread-pool size (native path only).

    Returns:
        ``(re, im)`` of shape ``(len(paths), *frame_shape)``.
    """
    n = len(paths)
    elems = int(np.prod(frame_shape))
    re = np.empty((n, *frame_shape), np.float32)
    im = np.empty((n, *frame_shape), np.float32)

    lib = _get_lib()
    if lib is None:
        for i, p in enumerate(paths):
            arr = np.load(p)
            re[i] = np.real(arr)
            im[i] = np.imag(arr)
        return re, im

    blob = b"".join(p.encode() + b"\0" for p in paths)
    loaded = lib.mrp_load_frames_split(
        blob, n,
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        elems, nthreads,
    )
    if loaded != n:
        raise IOError(f"native loader loaded {loaded}/{n} frames")
    return re, im


class SplitFramePrefetcher:
    """Double-buffered background batch loader feeding the device pipeline.

    While the device processes batch ``k``, the next batch loads on host threads;
    ``__iter__`` yields ``(re, im)`` batches in order.
    """

    def __init__(self, paths: List[str], frame_shape, batch: int = 256,
                 nthreads: int = 8):
        self.paths = list(paths)
        self.frame_shape = tuple(frame_shape)
        self.batch = batch
        self.nthreads = nthreads

    def __iter__(self):
        import concurrent.futures as cf

        chunks = [
            self.paths[i : i + self.batch]
            for i in range(0, len(self.paths), self.batch)
        ]
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(
                load_frames_split, chunks[0], self.frame_shape, self.nthreads
            )
            for nxt in chunks[1:]:
                current = future.result()
                future = pool.submit(
                    load_frames_split, nxt, self.frame_shape, self.nthreads
                )
                yield current
            yield future.result()
