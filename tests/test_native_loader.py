"""Native C++ NPY loader: header parsing, split bulk loads, prefetcher."""

import os

import numpy as np
import pytest

from mmwave_radar_processing_jax.data import native_loader


@pytest.fixture(scope="module")
def frame_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    shape = (4, 63, 210)
    paths, frames = [], []
    for i in range(12):
        arr = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
            np.complex64 if i % 2 == 0 else np.complex128
        )
        p = str(root / f"frame_{i:03d}.npy")
        np.save(p, arr)
        paths.append(p)
        frames.append(arr)
    return paths, frames, shape


def test_native_builds():
    assert native_loader.native_available(), "g++ build of the native loader failed"


def test_npy_info(frame_files):
    paths, frames, shape = frame_files
    got_shape, dtype = native_loader.npy_info(paths[0])
    assert got_shape == shape
    assert dtype in (0, 1)  # DT_C64 via native, 0 via fallback


def test_load_frames_split_matches_numpy(frame_files):
    paths, frames, shape = frame_files
    re, im = native_loader.load_frames_split(paths, shape, nthreads=4)
    assert re.shape == (len(paths), *shape)
    for i, arr in enumerate(frames):
        np.testing.assert_allclose(re[i], np.real(arr).astype(np.float32), rtol=1e-6)
        np.testing.assert_allclose(im[i], np.imag(arr).astype(np.float32), rtol=1e-6)


def test_load_real_frames(tmp_path):
    shape = (8, 16)
    arr = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    p = str(tmp_path / "real.npy")
    np.save(p, arr)
    re, im = native_loader.load_frames_split([p], shape)
    np.testing.assert_allclose(re[0], arr, rtol=1e-6)
    np.testing.assert_array_equal(im[0], 0.0)


def test_prefetcher_order(frame_files):
    paths, frames, shape = frame_files
    fetcher = native_loader.SplitFramePrefetcher(paths, shape, batch=5, nthreads=2)
    out = list(fetcher)
    assert [b[0].shape[0] for b in out] == [5, 5, 2]
    re_all = np.concatenate([b[0] for b in out])
    for i, arr in enumerate(frames):
        np.testing.assert_allclose(re_all[i], np.real(arr).astype(np.float32),
                                   rtol=1e-6)


def test_bad_file_raises(tmp_path, frame_files):
    _, _, shape = frame_files
    bad = str(tmp_path / "bad.npy")
    open(bad, "wb").write(b"not an npy file at all")
    if native_loader.native_available():
        with pytest.raises(IOError):
            native_loader.load_frames_split([bad], shape)
