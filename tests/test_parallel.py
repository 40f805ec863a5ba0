"""Sharding layer on the 8-device virtual CPU mesh.

Validates that sharded execution is numerically identical to single-device
execution: the frame-parallel pipeline, halo-exchange CFAR, and the
element-sharded beamformer with its psum all-reduce.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frames
from mmwave_radar_processing_jax.ops import cfar as cfar_ops, windows
from mmwave_radar_processing_jax.parallel import (
    build_point_cloud_pipeline,
    make_mesh,
)
from mmwave_radar_processing_jax.parallel.halo_cfar import (
    ca_cfar_2d_row_sharded,
    os_cfar_1d_sharded,
)
from mmwave_radar_processing_jax.parallel.sharded_beamform import (
    build_sharded_beamformer,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"data": 4, "model": 2})


def test_pipeline_sharded_matches_unsharded(flagship_config, mesh):
    scenes = [
        Scene(targets=[PointTarget(range_m=1.0 + 0.1 * i, azimuth_rad=0.1 * i,
                                   velocity_m_s=0.2 * (i % 3 - 1), rcs=3.0)])
        for i in range(8)
    ]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    fn = build_point_cloud_pipeline(flagship_config, max_dets=64, backend="xla")

    ref = fn(raw)
    sharded_in = jax.device_put(raw, NamedSharding(mesh, P("data")))
    out = fn(sharded_in)
    np.testing.assert_allclose(np.asarray(out.points), np.asarray(ref.points),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.count), np.asarray(ref.count))
    # output actually sharded across the data axis
    assert len(out.points.sharding.device_set) >= 4


def test_halo_cfar_1d_matches_dense(mesh, rng):
    x = rng.exponential(1.0, 512).astype(np.float32)
    params = dict(num_train=6, num_guard=3, rho=0.5, alpha=2.0)
    dense, _ = cfar_ops.os_1d(x, **params)
    fn = os_cfar_1d_sharded(mesh, axis="data", **params)
    with mesh:
        sharded = fn(jax.device_put(x, NamedSharding(mesh, P("data"))))
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense), rtol=1e-5)


def test_halo_cfar_2d_matches_dense(mesh, rng):
    x = rng.exponential(1.0, (128, 40)).astype(np.float32)
    params = dict(num_train=(4, 3), num_guard=(2, 1), pfa=1e-3)
    dense, _ = cfar_ops.ca_2d(x, **params)
    fn = ca_cfar_2d_row_sharded(mesh, axis="data", **params)
    with mesh:
        sharded = fn(jax.device_put(x, NamedSharding(mesh, P("data", None))))
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense), rtol=1e-5)


def test_halo_cfar_2d_detect_matches_dense(mesh, rng):
    from mmwave_radar_processing_jax.parallel.halo_cfar import (
        os_cfar_2d_detect_row_sharded,
    )

    # quantized values force exact ties; bit-identical masks required
    x = (np.round(rng.exponential(1.0, (128, 40)) * 8) / 8).astype(np.float32)
    params = dict(num_train=(4, 3), num_guard=(2, 1), rho=0.7, alpha=4.0)
    dense = cfar_ops.os_2d_detect(x, **params)
    fn = os_cfar_2d_detect_row_sharded(mesh, axis="data", **params)
    with mesh:
        sharded = fn(jax.device_put(x, NamedSharding(mesh, P("data", None))))
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(dense))
    assert np.asarray(dense).sum() > 0


def test_halo_cfar_rejects_shards_smaller_than_halo(mesh, rng):
    """rows_per_shard < train+guard must fail at trace time, not misalign."""
    # 4 data shards x 8 rows/shard = 32 rows; halo = 4+2 = 6 < 8 is fine,
    # but train=(7,3) guard=(3,1) -> halo 10 > 8 must raise.
    x = rng.exponential(1.0, (32, 16)).astype(np.float32)
    fn = ca_cfar_2d_row_sharded(
        mesh, axis="data", num_train=(7, 3), num_guard=(3, 1), pfa=1e-3
    )
    with mesh, pytest.raises(ValueError, match="rows_per_shard"):
        fn(jax.device_put(x, NamedSharding(mesh, P("data", None))))


def test_sharded_beamformer_matches_dense(flagship_config, mesh, rng):
    from mmwave_radar_processing_jax.processors.synthetic_array import beamform

    ns, elements, n_angles = 63, 32, 24
    data = (rng.standard_normal((ns, elements))
            + 1j * rng.standard_normal((ns, elements))).astype(np.complex64)
    positions = (rng.standard_normal((3, elements)) * 0.01).astype(np.float32)
    theta = np.linspace(-0.5, 0.5, n_angles)
    steering = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)],
                        axis=1).astype(np.float32)
    rng_win = jnp.asarray(windows.hanning(ns))
    elem_win = jnp.asarray(windows.hamming(elements))
    lam = flagship_config.lambda_m

    dense = beamform(jnp.asarray(data), jnp.asarray(positions),
                     jnp.asarray(steering), lam, rng_win, elem_win)

    fn = build_sharded_beamformer(mesh, lambda_m=lam)
    with mesh:
        sharded = fn(
            jax.device_put(data, NamedSharding(mesh, P(None, "model"))),
            jax.device_put(positions, NamedSharding(mesh, P(None, "model"))),
            jnp.asarray(steering), rng_win, elem_win,
        )
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                               rtol=1e-4, atol=1e-4 * np.abs(np.asarray(dense)).max())


def test_snapshot_sharded_capon_matches_dense(mesh, rng):
    """Chirp-sharded covariance + psum == unsharded Capon/Bartlett."""
    from mmwave_radar_processing_jax.config import grids
    from mmwave_radar_processing_jax.ops import beamform as bf, mxu
    from mmwave_radar_processing_jax.parallel.sharded_beamform import (
        build_snapshot_sharded_capon,
    )

    x = (rng.standard_normal((6, 12, 64))
         + 1j * rng.standard_normal((6, 12, 64))).astype(np.complex64)
    c2 = mxu.from_complex(x)
    steering = bf.steering_ula(grids.phase_shift_bins(48), 12)

    dense_capon = np.asarray(bf.capon_from_covariance(
        bf.spatial_covariance(c2), steering, loading=1e-2))
    dense_bart = np.asarray(bf.bartlett_from_covariance(
        bf.spatial_covariance(c2), steering))

    sh = NamedSharding(mesh, P(None, None, "model"))
    xr = jax.device_put(np.asarray(c2.re), sh)
    xi = jax.device_put(np.asarray(c2.im), sh)
    with mesh:
        capon_fn = build_snapshot_sharded_capon(mesh, loading=1e-2)
        bart_fn = build_snapshot_sharded_capon(mesh, method="bartlett")
        got_capon = np.asarray(capon_fn(xr, xi, steering.re, steering.im))
        got_bart = np.asarray(bart_fn(xr, xi, steering.re, steering.im))
    np.testing.assert_allclose(got_capon, dense_capon, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got_bart, dense_bart, rtol=1e-4,
                               atol=1e-4 * dense_bart.max())


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = fn(*args)
    assert np.asarray(out.points).ndim == 3
    ge.dryrun_multichip(8)
    ge.dryrun_multichip(4)


def test_dryrun_multichip_at_16_and_32_devices():
    """The full sharded dryrun compiles+executes at pod-slice device counts.

    The in-process test mesh is 8 virtual devices; n=16/32 run in a
    subprocess with a larger virtual-device count, so meshes larger than one
    host's cards are not a first-ever compile.
    """
    import os
    import subprocess
    import sys

    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=32")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as ge; ge.dryrun_multichip(16); "
         "ge.dryrun_multichip(32); print('dryrun16/32 ok')"],
        env=env, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun16/32 ok" in proc.stdout


def test_pipeline_sharded_mxu(flagship_config, mesh):
    """MXU (split-complex) pipeline under data sharding matches unsharded."""
    scenes = [
        Scene(targets=[PointTarget(range_m=1.0 + 0.1 * i, azimuth_rad=0.1 * i,
                                   velocity_m_s=0.2 * (i % 3 - 1), rcs=3.0)])
        for i in range(8)
    ]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    re = np.real(raw).astype(np.float32)
    im = np.imag(raw).astype(np.float32)
    fn = build_point_cloud_pipeline(flagship_config, max_dets=64, backend="mxu")

    ref = fn(re, im)
    sh = NamedSharding(mesh, P("data"))
    out = fn(jax.device_put(re, sh), jax.device_put(im, sh))
    np.testing.assert_array_equal(np.asarray(out.count), np.asarray(ref.count))
    np.testing.assert_allclose(np.asarray(out.points), np.asarray(ref.points),
                               rtol=1e-5, atol=1e-5)


def test_overlap_save_zoom_bit_identical(mesh, rng):
    """Sample-axis-sharded zoom (overlap-save FIR halo) == unsharded, bitwise."""
    from mmwave_radar_processing_jax.ops import zoom_fir
    from mmwave_radar_processing_jax.ops.mxu import C2
    from mmwave_radar_processing_jax.parallel.overlap_save import (
        build_sharded_zoom_fir,
    )

    n, batch = 512, 3
    params = dict(f_center=0.31, fs=2.0, decim=4, num_taps=33, m=48,
                  f1=-0.2, f2=0.2)
    xr = rng.standard_normal((batch, n)).astype(np.float32)
    xi = rng.standard_normal((batch, n)).astype(np.float32)
    x = C2(jnp.asarray(xr), jnp.asarray(xi))

    ref = zoom_fir.zoom_fft_fir(x, **params)

    fn = build_sharded_zoom_fir(mesh, n=n, axis="data", **params)
    sh = NamedSharding(mesh, P(None, "data"))
    with mesh:
        out = fn(C2(jax.device_put(xr, sh), jax.device_put(xi, sh)))
    np.testing.assert_array_equal(np.asarray(out.re), np.asarray(ref.re))
    np.testing.assert_array_equal(np.asarray(out.im), np.asarray(ref.im))


def test_overlap_save_guards(mesh, rng):
    """Trace-time guards: halo wider than a shard, misaligned decimation."""
    from mmwave_radar_processing_jax.ops.mxu import C2
    from mmwave_radar_processing_jax.parallel.overlap_save import (
        build_sharded_zoom_fir,
    )

    with pytest.raises(ValueError, match="multiple of decim"):
        build_sharded_zoom_fir(mesh, n=36, axis="data", f_center=0.0, fs=2.0,
                               decim=6, num_taps=5, m=8, f1=-0.1, f2=0.1)
    fn = build_sharded_zoom_fir(mesh, n=64, axis="data", f_center=0.0, fs=2.0,
                                decim=4, num_taps=33, m=8, f1=-0.1, f2=0.1)
    xr = rng.standard_normal((2, 64)).astype(np.float32)
    sh = NamedSharding(mesh, P(None, "data"))
    with mesh, pytest.raises(ValueError, match="samples_per_shard"):
        fn(C2(jax.device_put(xr, sh), jax.device_put(xr, sh)))


def test_measure_scaling_structure(flagship_config):
    """Scaling harness: tables for every pipeline + bare-collective timings."""
    from mmwave_radar_processing_jax.parallel.scaling import measure_scaling

    if len(jax.devices()) < 2:
        pytest.skip("needs virtual multi-device mesh")
    table = measure_scaling(
        flagship_config, device_counts=(1, 2), per_device_batch=1, iters=1
    )
    for name in ("combined", "combined_with_feed", "halo_cfar_2d",
                 "capon_snapshot", "ppermute_halo_rows",
                 "psum_beamform_partials"):
        assert name in table, name
        entry = table[name]
        assert len(entry["devices"]) == len(entry["samples_per_s"])
        assert all(s > 0 for s in entry["samples_per_s"])
        assert len(entry["core_oversubscribed"]) == len(entry["devices"])
    # collectives only exist at n >= 2
    assert table["ppermute_halo_rows"]["devices"] == [2]
    assert table["combined"]["devices"] == [1, 2]
    # honesty fields: feed-inclusive rows + measured collective shares
    assert table["combined_with_feed"]["input_feed_included"] == [True, True]
    assert table["combined"]["input_feed_included"] == [False, False]
    for pipe in ("halo_cfar_2d", "capon_snapshot"):
        shares = table[pipe]["collective_share"]
        assert len(shares) == len(table[pipe]["devices"])
        assert shares[0] == 0.0  # no collective at n=1
        assert 0.0 < shares[-1] < 1.5  # measured, sane
    assert table["meta"]["physical_cores"] >= 1


def test_input_feed_assembles_global_batch(flagship_config, tmp_path):
    """Per-process local-shard feed == device_put of the full batch.

    Writes complex NPY frames, streams them through
    ``sharded_recording_feed`` (native loader + make_array_from_process_local
    _data) on a 4-device frame-DP mesh, and checks values, sharding, and
    batch order against a straight host load.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mmwave_radar_processing_jax.parallel.input_feed import (
        process_local_frame_slice,
        sharded_recording_feed,
    )
    from mmwave_radar_processing_jax.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs virtual multi-device mesh")
    mesh = make_mesh({"data": 4}, jax.devices()[:4])
    shape = (2, 8, 12)
    rng = np.random.default_rng(5)
    frames, paths = [], []
    for i in range(16):
        arr = (rng.standard_normal(shape)
               + 1j * rng.standard_normal(shape)).astype(np.complex64)
        p = tmp_path / f"f{i:02d}.npy"
        np.save(p, arr)
        frames.append(arr)
        paths.append(str(p))

    # single process on this mesh: the local slice is the whole batch
    assert process_local_frame_slice(mesh, 8) == slice(0, 8)

    batches = list(sharded_recording_feed(mesh, paths, shape, global_batch=8,
                                          altitude=0.7))
    assert len(batches) == 2
    for b, (re, im, alt) in enumerate(batches):
        want = np.stack(frames[b * 8:(b + 1) * 8])
        np.testing.assert_array_equal(np.asarray(re), np.real(want))
        np.testing.assert_array_equal(np.asarray(im), np.imag(want))
        np.testing.assert_allclose(np.asarray(alt), 0.7)
        assert re.sharding.is_equivalent_to(
            NamedSharding(mesh, P("data")), re.ndim)


def test_chunk_dispatch_bit_identical(flagship_config, rng):
    """One K-chunk mega-dispatch == K independent dispatches, bitwise.

    ``chunk_dispatch`` must remain a pure re-dispatch of the same compiled
    step, so every output leaf has to match the chunk-by-chunk result
    exactly, not approximately.
    """
    from mmwave_radar_processing_jax.parallel.pipeline import chunk_dispatch
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )

    cfg = flagship_config
    k, b = 3, 4
    shape = (k * b, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw_re = rng.standard_normal(shape).astype(np.float32)
    raw_im = rng.standard_normal(shape).astype(np.float32)

    # point-cloud pipeline (2-arg) and velocity pipeline (3-arg, mixed pytree
    # output) both go through the same wrapper
    pc = build_point_cloud_pipeline(cfg, max_dets=32, backend="mxu")
    mega_pc = chunk_dispatch(pc, k)
    got = mega_pc(raw_re, raw_im)
    want = jax.tree.map(
        lambda *xs: jnp.concatenate(xs),
        *[pc(raw_re[i * b:(i + 1) * b], raw_im[i * b:(i + 1) * b])
          for i in range(k)],
    )
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    alt = np.full(k * b, 1.2, np.float32)
    vel = build_velocity_pipeline(cfg)
    mega_vel = chunk_dispatch(vel, k)
    got = mega_vel(raw_re, raw_im, alt)
    want = jax.tree.map(
        lambda *xs: jnp.concatenate(xs),
        *[vel(raw_re[i * b:(i + 1) * b], raw_im[i * b:(i + 1) * b],
              alt[i * b:(i + 1) * b]) for i in range(k)],
    )
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    # k=1 must be the identity wrapper; indivisible batches must be loud
    assert chunk_dispatch(pc, 1) is pc
    with pytest.raises(ValueError, match="divisible"):
        chunk_dispatch(pc, 5)(raw_re, raw_im)


def test_chunk_dispatch_unrolled_bit_identical(flagship_config, rng):
    """Unrolled mega-dispatch variant == chunk-by-chunk, bitwise."""
    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
        chunk_dispatch_unrolled,
    )

    cfg = flagship_config
    k, b = 2, 3
    shape = (k * b, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw_re = rng.standard_normal(shape).astype(np.float32)
    raw_im = rng.standard_normal(shape).astype(np.float32)
    pc = build_point_cloud_pipeline(cfg, max_dets=32, backend="mxu")
    got = chunk_dispatch_unrolled(pc, k)(raw_re, raw_im)
    want = jax.tree.map(
        lambda *xs: jnp.concatenate(xs),
        *[pc(raw_re[i * b:(i + 1) * b], raw_im[i * b:(i + 1) * b])
          for i in range(k)],
    )
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert chunk_dispatch_unrolled(pc, 1) is pc
