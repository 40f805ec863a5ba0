"""Samples/s-vs-devices scaling harness (the >=80% north-star measurement).

Runs the sharded pipelines at 1/2/4/.../N devices with *weak scaling*
(constant per-device batch) and reports throughput + parallel efficiency
``eff(n) = (samples_per_s(n) / n) / samples_per_s(1)``:

- ``combined`` — the full serving pipeline (point clouds + ego-velocity),
  frame-data-parallel over ``data``; no cross-chip collectives on the hot
  path, so efficiency is bounded only by dispatch and input feed.
- ``halo_cfar_2d`` — range-row-sharded counting OS-CFAR detection whose
  shard boundaries exchange train+guard halos via ``ppermute`` each step.
- ``capon_snapshot`` — Capon heatmaps with the snapshot (chirp) axis sharded;
  partial covariances are all-reduced with one ``[.., A, A]`` ``psum``.

On several GPUs this measures scaling over their interconnect
(``bench.py --metric scaling`` refuses to run on fewer than two).  On a
virtual CPU mesh (tests) it only validates that the sharded programs execute
with the expected collective structure.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids


def _time_fn(fn, args, iters: int) -> float:
    """Median-of-runs wall-clock per call of ``fn(*args)``."""
    import jax

    jax.block_until_ready(fn(*args))  # warmup/compile
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def measure_scaling(
    cfg: RadarConfig,
    *,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    per_device_batch: int = 64,
    iters: int = 5,
    feed_frames_dir: str | None = None,
) -> Dict:
    """Weak-scaling table for the sharded pipelines.

    Returns ``{pipeline: {"devices": [...], "samples_per_s": [...],
    "efficiency": [...], ...}}`` where efficiency is normalized per-device
    throughput relative to 1 device.  Honesty fields per table:

    - ``input_feed_included`` — the ``combined_with_feed`` rows time the
      whole serving path *including* per-process local-shard loading
      (native NPY loader -> ``jax.make_array_from_process_local_data``),
      per SURVEY §5.8's multi-host input-feed mandate.
    - ``collective_share`` — fraction of each collective-using pipeline's
      step spent in its bare collective (measured separately at the same
      payload size), so compute-vs-communication is a measurement, not an
      assertion.
    - ``core_oversubscribed`` — rows where the virtual device count exceeds
      physical cores measure oversubscription, not interconnect; on real
      multi-chip hardware no row is oversubscribed.
    """
    import os as _os

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mmwave_radar_processing_jax.ops import beamform as bf
    from mmwave_radar_processing_jax.parallel.full_pipeline import (
        build_full_pipeline,
    )
    from mmwave_radar_processing_jax.parallel.halo_cfar import (
        os_cfar_2d_detect_row_sharded,
    )
    from mmwave_radar_processing_jax.parallel.mesh import make_mesh
    from mmwave_radar_processing_jax.parallel.sharded_beamform import (
        build_snapshot_sharded_capon,
    )

    avail = jax.devices()
    device_counts = [n for n in device_counts if n <= len(avail)]
    physical_cores = _os.cpu_count() or 1
    on_cpu = avail[0].platform == "cpu"
    rng = np.random.default_rng(0)
    results: Dict[str, Dict] = {}
    durations: Dict = {}

    def record(name, n, samples, dt, **extra):
        entry = results.setdefault(
            name, {"devices": [], "samples_per_s": [], "efficiency": [],
                   "core_oversubscribed": []}
        )
        sps = samples / dt
        entry["devices"].append(n)
        entry["samples_per_s"].append(round(sps, 1))
        base = entry["samples_per_s"][0] / entry["devices"][0]
        entry["efficiency"].append(round((sps / n) / base, 4))
        entry["core_oversubscribed"].append(bool(on_cpu and n > physical_cores))
        for k, v in extra.items():
            entry.setdefault(k, []).append(v)
        return dt

    # ---- combined serving pipeline, frame-DP ---------------------------- #
    shape1 = (per_device_batch, cfg.num_rx_antennas, cfg.num_adc_samples,
              cfg.chirps_per_frame)
    cfar_params = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
    combined = build_full_pipeline(cfg, cfar_params=cfar_params, max_dets=64)
    for n in device_counts:
        mesh = make_mesh({"data": n}, avail[:n])
        sh = NamedSharding(mesh, P("data"))
        sh0 = NamedSharding(mesh, P("data"))
        b = per_device_batch * n
        raw_re = jax.device_put(
            rng.standard_normal((b,) + shape1[1:]).astype(np.float32), sh)
        raw_im = jax.device_put(
            rng.standard_normal((b,) + shape1[1:]).astype(np.float32), sh)
        alts = jax.device_put(np.full(b, 1.2, np.float32), sh0)
        dt = _time_fn(combined, (raw_re, raw_im, alts), iters)
        record("combined", n, b, dt, input_feed_included=False)

    # ---- combined pipeline WITH the per-process input feed ---------------- #
    # Times the full serving path: native NPY loader (local shard only) ->
    # jax.make_array_from_process_local_data -> sharded pipeline.  SURVEY
    # §5.8's multi-host feed, exercised end-to-end.
    import tempfile

    from mmwave_radar_processing_jax.parallel.input_feed import (
        sharded_recording_feed,
    )

    frame_shape = shape1[1:]
    with tempfile.TemporaryDirectory() as td:
        uniq = []
        for i in range(16):
            arr = (rng.standard_normal(frame_shape)
                   + 1j * rng.standard_normal(frame_shape)).astype(np.complex64)
            p = f"{td}/frame_{i:03d}.npy"
            np.save(p, arr)
            uniq.append(p)
        for n in device_counts:
            mesh = make_mesh({"data": n}, avail[:n])
            b = per_device_batch * n
            n_batches = iters + 1
            paths = [uniq[k % len(uniq)] for k in range(b * n_batches)]

            def run_once():
                out = None
                for args in sharded_recording_feed(
                        mesh, paths, frame_shape, global_batch=b):
                    out = combined(*args)
                jax.block_until_ready(out)

            run_once()  # warmup/compile
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run_once()
                times.append((time.perf_counter() - t0) / n_batches)
            record("combined_with_feed", n, b, float(np.median(times)),
                   input_feed_included=True)

    # ---- halo-exchange CFAR (ppermute per step) -------------------------- #
    # The workload constants are recorded into the results entry next to
    # the timings they describe.
    rows_per_dev, halo_cols, halo_rows = 64, 128, 8
    for n in device_counts:
        mesh = make_mesh({"data": n}, avail[:n])
        x = rng.exponential(1.0, (rows_per_dev * n, halo_cols)).astype(
            np.float32)
        fn = os_cfar_2d_detect_row_sharded(
            mesh, num_train=(4, 3), num_guard=(2, 1), rho=0.7, alpha=4.0,
            axis="data",
        )
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
        with mesh:
            dt = _time_fn(fn, (xs,), iters)
        durations[("halo_cfar_2d", n)] = record(
            "halo_cfar_2d", n, x.shape[0] * x.shape[1], dt)
    results["halo_cfar_2d"]["samples_per_step_n1"] = rows_per_dev * halo_cols
    # train+guard boundary rows exchanged with both neighbors, f32
    results["halo_cfar_2d"]["halo_bytes_per_dev"] = \
        2 * halo_rows * halo_cols * 4

    # ---- bare collective microbenches ------------------------------------ #
    # per-collective timings at each device count, on the payload sizes the
    # sharded pipelines actually move: the CFAR halo ppermute (train+guard
    # boundary rows) and the beamforming psum ([ns, A] partial sums).  On GPUs
    # these are the interconnect costs; on the virtual CPU mesh they time the
    # collective's software path.
    from jax import shard_map

    for n in device_counts:
        if n < 2:
            continue
        mesh = make_mesh({"data": n}, avail[:n])
        perm = [(i, (i + 1) % n) for i in range(n)]
        halo = rng.standard_normal((n * 8, 128)).astype(np.float32)
        part = rng.standard_normal((n, 63, 64)).astype(np.float32)

        pperm = jax.jit(shard_map(
            lambda x: jax.lax.ppermute(x, "data", perm),
            mesh=mesh, in_specs=P("data"), out_specs=P("data")))
        psum = jax.jit(shard_map(
            lambda x: jax.lax.psum(x, "data"),
            mesh=mesh, in_specs=P("data"), out_specs=P()))
        xs = jax.device_put(halo, NamedSharding(mesh, P("data", None)))
        ps = jax.device_put(part, NamedSharding(mesh, P("data", None, None)))
        durations[("ppermute_halo_rows", n)] = record(
            "ppermute_halo_rows", n, halo.size, _time_fn(pperm, (xs,), iters))
        durations[("psum_beamform_partials", n)] = record(
            "psum_beamform_partials", n, part.size,
            _time_fn(psum, (ps,), iters))

    # ---- snapshot-sharded Capon (psum of partial covariances) ------------ #
    n_bins, n_ant, snaps_per_dev = 64, 12, 32
    steering = bf.steering_ula(grids.phase_shift_bins(64), n_ant)
    for n in device_counts:
        mesh = make_mesh({"model": n}, avail[:n])
        k = snaps_per_dev * n
        xr = rng.standard_normal((n_bins, n_ant, k)).astype(np.float32)
        xi = rng.standard_normal((n_bins, n_ant, k)).astype(np.float32)
        fn = build_snapshot_sharded_capon(mesh, loading=1e-2, axis="model")
        sh = NamedSharding(mesh, P(None, None, "model"))
        args = (jax.device_put(xr, sh), jax.device_put(xi, sh),
                steering.re, steering.im)
        with mesh:
            dt = _time_fn(fn, args, iters)
        durations[("capon_snapshot", n)] = record("capon_snapshot", n,
                                                  n_bins * k, dt)
    results["capon_snapshot"]["samples_per_step_n1"] = n_bins * snaps_per_dev
    # the pipeline psums the partial covariance [n_bins, A, A] re+im planes
    # (sharded_beamform.build_snapshot_sharded_capon) — the real payload, not
    # the microbench's proxy shape
    results["capon_snapshot"]["psum_bytes_per_dev"] = \
        n_bins * n_ant * n_ant * 2 * 4

    # ---- compute-vs-communication: collective share per pipeline row ------ #
    for pipe, coll in (("halo_cfar_2d", "ppermute_halo_rows"),
                       ("capon_snapshot", "psum_beamform_partials")):
        entry = results.get(pipe)
        if not entry:
            continue
        shares = []
        for n in entry["devices"]:
            tp = durations.get((pipe, n))
            tc = durations.get((coll, n))
            shares.append(round(tc / tp, 4) if tp and tc else 0.0)
        entry["collective_share"] = shares

    results["meta"] = {
        "physical_cores": physical_cores,
        "platform": avail[0].platform,
        "per_device_batch": per_device_batch,
        "note": ("core_oversubscribed rows measure CPU-core contention, not "
                 "interconnect; collective_share is the bare-collective time "
                 "over the pipeline step at the same payload/device count"),
    }
    return results
