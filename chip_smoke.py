"""Smoke run of the radar pipelines on one GPU, at full width.

Drives the flagship 6843 ODS 20 Hz deployment (``configs/6843_RadVel_ods_20Hz
.cfg``: 4 rx x 63 samples x 210 chirps) through the normal entry points at
batch 1024 on seeded simulated scenes, in one process:

1. device check (no GPU: exit non-zero, never fall back to the CPU);
2. every pipeline — point cloud, velocity, combined, ground, capon,
   bartlett — compiled, timed and sized;
3. the device against the CPU oracle (``bench.py --verify``), and the
   Doppler-azimuth kernel against an einsum reference at HIGHEST precision;
4. the Doppler-azimuth contest: plain XLA form vs the Pallas kernel, end to
   end in ``build_velocity_pipeline``, in turns;
5. the Capon chain's time and device kernels per dispatch (profiler trace);
6. ``scripts/process_recording.py`` on a simulated recording, in process.

(The verify pass of step 3 runs last, after the recording.)

Any failed phase exits non-zero.  The last line of stdout is one JSON object
``{"ok": true, "device": {...}}``.

``--four-cards`` instead runs only the multi-card paths on four GPUs (frames
data-parallel through the input feed, element-sharded beamforming, halo
CFAR), each compared with the one-card result on the same inputs.

Usage: ``python chip_smoke.py [--four-cards]``
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CFG_PATH = os.path.join(HERE, "configs", "6843_RadVel_ods_20Hz.cfg")
BATCH = 1024
#: distinct simulated frames; the batch repeats them (simulation is host work)
UNIQUE_FRAMES = 64
TIMED_CALLS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def device_check(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke.py needs {n_cards} GPUs; found {len(devs)}")
    from mmwave_radar_processing_jax.utils.roofline import card_power_limit

    card = card_power_limit()
    log(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"{len(devs)} device(s)")
    log(f"card: {card}")
    return card


def relative_error(got, want) -> float:
    """max |got - want| over max |want| (0 when both are zero)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    diff = float(np.max(np.abs(got - want))) if want.size else 0.0
    return diff / scale if scale > 0 else diff


def median_ms(fn, args, n: int = TIMED_CALLS) -> float:
    """Median wall time of ``n`` calls, each ended in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def peak_bytes_in_use() -> int:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def flagship_inputs(cfg, batch: int, seed: int = 7):
    """Seeded simulated frames (``utils.verify.make_inputs``), repeated to
    ``batch`` on the device."""
    import jax

    from mmwave_radar_processing_jax.utils.verify import make_inputs

    n = min(UNIQUE_FRAMES, batch)
    raw_re, raw_im, alt = make_inputs(cfg, n, seed)
    reps = -(-batch // n)
    return tuple(jax.device_put(np.concatenate([a] * reps)[:batch])
                 for a in (raw_re, raw_im, alt))


def build_pipelines(cfg):
    """name -> (jitted pipeline, whether it takes altitudes)."""
    from bench import AZ_IDXS, CFAR_PARAMS, EL_IDXS
    from mmwave_radar_processing_jax.parallel.capon_pipeline import (
        build_capon_pipeline,
    )
    from mmwave_radar_processing_jax.parallel.full_pipeline import (
        build_full_pipeline,
    )
    from mmwave_radar_processing_jax.parallel.ground_pipeline import (
        build_ground_point_cloud_pipeline,
    )
    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )

    return {
        "pointcloud": (build_point_cloud_pipeline(
            cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
            cfar_params=CFAR_PARAMS, max_dets=128, backend="mxu"), False),
        "velocity": (build_velocity_pipeline(cfg), True),
        "combined": (build_full_pipeline(cfg), True),
        "ground": (build_ground_point_cloud_pipeline(cfg), False),
        "capon": (build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS,
                                       method="capon"), False),
        "bartlett": (build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS,
                                          method="bartlett"), False),
    }


def check_finite(name, out) -> None:
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        a = np.asarray(leaf)
        if a.ndim and a.shape[0] != BATCH:
            raise AssertionError(f"{name}: leaf shape {a.shape}, want "
                                 f"leading {BATCH}")
        if np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a)):
            raise AssertionError(f"{name}: non-finite output")


def phase_pipelines(cfg, card, inputs) -> None:
    raw_re, raw_im, alt = inputs
    for name, (fn, needs_alt) in build_pipelines(cfg).items():
        args = (raw_re, raw_im) + ((alt,) if needs_alt else ())
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        log(f"{name}: memory_analysis {compiled.memory_analysis()}")
        check_finite(name, compiled(*args))
        ms = median_ms(compiled, args)
        peak = peak_bytes_in_use()
        log(f"[{card}] {name} @ batch {BATCH}: compile {compile_s:.3f} s "
            f"(set-up), {ms:.4f} ms/call (median of {TIMED_CALLS}, "
            f"block_until_ready) = {BATCH / ms * 1e3:.1f} frames/s, "
            f"peak_bytes_in_use {peak}")


def phase_verify(card) -> None:
    from mmwave_radar_processing_jax.utils import verify

    t0 = time.perf_counter()
    report = verify.run_verify(verify.VERIFY_METRICS, batch=32)
    log(verify.format_report(report))
    log(f"[{card}] verify: {time.perf_counter() - t0:.1f} s incl. CPU oracle")
    if not report["ok"]:
        raise AssertionError("device disagrees with the CPU oracle")


def doppler_az_reference(u_re, u_im, wgt, fct, fst, set_idx):
    """Plain einsum form at HIGHEST precision: [B, sets, nv, Av]."""
    import jax.numpy as jnp

    hi = "highest"
    idx = jnp.asarray(set_idx)
    ur, ui = u_re[:, idx], u_im[:, idx]  # [B, S, R, W, nv]
    n_sets, n_rx = idx.shape
    fc = fct.reshape(n_sets, n_rx, -1)
    fs = fst.reshape(n_sets, n_rx, -1)
    sp_re = (jnp.einsum("bsrwv,sra->bswva", ur, fc, precision=hi)
             + jnp.einsum("bsrwv,sra->bswva", ui, fs, precision=hi))
    sp_im = (jnp.einsum("bsrwv,sra->bswva", ui, fc, precision=hi)
             - jnp.einsum("bsrwv,sra->bswva", ur, fs, precision=hi))
    mag = jnp.sqrt(sp_re * sp_re + sp_im * sp_im)
    return jnp.einsum("bswva,bw->bsva", mag, wgt, precision=hi)


#: bound on the kernel's max relative error against the HIGHEST einsum: both
#: are float32 with the same operation count per output, so they differ only
#: in summation order (~1e-7 measured); 1e-4 leaves room and still catches a
#: wrong coefficient or a masked lane leaking in
KERNEL_REL_TOL = 1e-4


def phase_kernel_reference(card) -> None:
    import jax

    from mmwave_radar_processing_jax.ops.pallas import doppler_az
    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        ODS_AZ_SETS_VIRTUAL,
        ODS_EL_SETS_VIRTUAL,
    )

    # flagship widths: 12 virtual channels, W=19 range rows, 70 velocity
    # bins, 60 valid angle bins; the velocity pipeline's four sub-arrays
    set_idx = tuple(tuple(int(c) for c in s)
                    for s in (*ODS_AZ_SETS_VIRTUAL, *ODS_EL_SETS_VIRTUAL))
    rng = np.random.default_rng(0)
    shape = (BATCH, 12, 19, 70)
    u_re = jax.device_put(rng.standard_normal(shape).astype(np.float32))
    u_im = jax.device_put(rng.standard_normal(shape).astype(np.float32))
    wgt = rng.random((BATCH, 19)).astype(np.float32)
    wgt = jax.device_put(wgt / wgt.sum(axis=1, keepdims=True))
    fct = jax.device_put(rng.standard_normal((16, 60)).astype(np.float32))
    fst = jax.device_put(rng.standard_normal((16, 60)).astype(np.float32))
    kernel = jax.jit(jax.vmap(lambda a, b, c: doppler_az.set_responses(
        a, b, c, fct, fst, set_idx=set_idx)))
    want = jax.jit(doppler_az_reference, static_argnums=5)(
        u_re, u_im, wgt, fct, fst, set_idx)
    err = relative_error(kernel(u_re, u_im, wgt), want)
    log(f"[{card}] doppler_az kernel vs HIGHEST einsum at [{BATCH}, 12, 19, "
        f"70] -> [4, 70, 60]: max relative error {err:.3e} "
        f"(bound {KERNEL_REL_TOL:g}); kernel {median_ms(kernel, (u_re, u_im, wgt)):.4f} ms")
    if not err <= KERNEL_REL_TOL:
        raise AssertionError(f"doppler_az kernel error {err} > {KERNEL_REL_TOL}")


def phase_contest(cfg, card, inputs) -> None:
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )

    fns = {b: build_velocity_pipeline(cfg, response_backend=b).lower(
        *inputs).compile() for b in ("xla", "triton")}
    outs = {b: np.asarray(f(*inputs).velocity) for b, f in fns.items()}
    agree = float(np.mean(np.abs(outs["xla"] - outs["triton"]) <= 1e-3))
    times = {"xla": [], "triton": []}
    for b in ("xla", "triton", "triton", "xla"):
        times[b].append(median_ms(fns[b], inputs, 20))
    mean = {b: float(np.mean(t)) for b, t in times.items()}
    log(f"[{card}] doppler_az contest, build_velocity_pipeline @ batch "
        f"{BATCH}, turns plain,kernel,kernel,plain (median of 20 each): "
        f"plain XLA {times['xla']} ms, Pallas kernel {times['triton']} ms; "
        f"velocity agreement {agree:.4f}; faster: "
        f"{min(mean, key=mean.get)}")
    if agree < 0.99:
        raise AssertionError(f"kernel and plain velocity disagree ({agree})")


def device_kernels_per_call(fn, args, n_calls: int = 3) -> float:
    """Kernel events on the GPU planes of a short profiler trace, per call."""
    import glob

    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as td:
        jax.profiler.start_trace(td)
        for _ in range(n_calls):
            jax.block_until_ready(fn(*args))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(td, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        data = jax.profiler.ProfileData.from_file(path)
        n = sum(1 for plane in data.planes
                if plane.name.startswith("/device:GPU")
                for line in plane.lines for _ in line.events)
    return n / n_calls


def phase_capon_trace(cfg, card, inputs) -> None:
    fn, _ = build_pipelines(cfg)["capon"]
    args = inputs[:2]
    kernels = device_kernels_per_call(fn, args)
    log(f"[{card}] capon chain @ batch {BATCH}: {median_ms(fn, args):.4f} ms/"
        f"call, {kernels:.1f} device kernels per dispatch (profiler trace)")


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_prefixed(card, fn, *args):
    """Run ``fn``, re-printing everything it writes to stdout (its logger
    included) with the card's name and power limit on each line."""
    import contextlib
    import io
    import logging

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args)
    finally:
        for lg in [logging.root, *logging.root.manager.loggerDict.values()]:
            for h in getattr(lg, "handlers", []):
                if getattr(h, "stream", None) is buf:
                    h.setStream(sys.stdout)
        for line in buf.getvalue().splitlines():
            log(f"[{card}] | {line}")


def phase_process_recording(card, n_frames: int = 320) -> None:
    with tempfile.TemporaryDirectory() as td:
        ds, out = os.path.join(td, "recording"), os.path.join(td, "out.npz")
        card_prefixed(card, _load_script("simulate_dataset").main,
                      ["--out", ds, "--frames", str(n_frames),
                       "--config", CFG_PATH])
        t0 = time.perf_counter()
        card_prefixed(card, _load_script("process_recording").main,
                      ["--dataset", ds, "--out", out, "--batch", "64",
                       "--radar-config", CFG_PATH])
        wall = time.perf_counter() - t0
        with np.load(out) as z:
            points, velocity = z["points"], z["velocity"]
    log(f"[{card}] process_recording: {n_frames} frames in {wall:.2f} s wall "
        f"(compile included); points {points.shape}, velocity "
        f"{velocity.shape}")
    if points.shape[0] != n_frames or velocity.shape[0] != n_frames:
        raise AssertionError("expected one point cloud and one velocity per "
                             f"frame, got {points.shape} / {velocity.shape}")
    if not (np.all(np.isfinite(points)) and np.all(np.isfinite(velocity))):
        raise AssertionError("process_recording wrote non-finite values")


# --------------------------------------------------------------------------- #
# four cards
# --------------------------------------------------------------------------- #
def phase_four_data_parallel(cfg, card) -> None:
    """Combined pipeline, 1024 frames per card, through the input feed."""
    import jax

    from mmwave_radar_processing_jax.parallel.full_pipeline import (
        build_full_pipeline,
    )
    from mmwave_radar_processing_jax.parallel.input_feed import (
        sharded_recording_feed,
    )
    from mmwave_radar_processing_jax.parallel.mesh import make_mesh
    from mmwave_radar_processing_jax.utils import verify

    n_dev = 4
    mesh = make_mesh({"data": n_dev}, jax.devices()[:n_dev])
    raw_re, raw_im, _ = verify.make_inputs(cfg, UNIQUE_FRAMES, 7)
    fn = build_full_pipeline(cfg)
    global_batch = BATCH * n_dev
    with tempfile.TemporaryDirectory() as td:
        uniq = []
        for i in range(UNIQUE_FRAMES):
            p = os.path.join(td, f"frame_{i:03d}.npy")
            np.save(p, (raw_re[i] + 1j * raw_im[i]).astype(np.complex64))
            uniq.append(p)
        paths = [uniq[k % UNIQUE_FRAMES] for k in range(global_batch)]
        (args,) = list(sharded_recording_feed(
            mesh, paths, raw_re.shape[1:], global_batch=global_batch,
            altitude=1.2))
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    collectives = count_collectives(compiled.as_text())
    sharded = compiled(*args)
    ms = median_ms(compiled, args)
    log(f"[{card}] x{n_dev} data-parallel combined @ {global_batch} frames "
        f"({BATCH}/card): compile {compile_s:.3f} s, {ms:.4f} ms/call = "
        f"{global_batch / ms * 1e3:.1f} frames/s; collectives in the "
        f"program {collectives}")
    # the one-card reference runs the same global batch, so every frame
    # keeps its position (the per-frame RANSAC keys follow it)
    single = tuple(jax.device_put(np.asarray(a), jax.devices()[0])
                   for a in args)
    one = fn.lower(*single).compile()
    ref = one(*single)
    ms1 = median_ms(one, single)
    oracle, device = dict(_leaves(ref)), dict(_leaves(sharded))
    report = verify.compare_outputs(oracle, device)
    exact = float(np.mean([np.array_equal(oracle[k], device[k])
                           for k in oracle]))
    log(f"[{card}] one card @ {global_batch}: {ms1:.4f} ms/call; x{n_dev} "
        f"speed-up {ms1 / ms:.3f} (efficiency {ms1 / ms / n_dev:.4f})")
    log(verify.format_report(dict(report, device=card, batch=global_batch),
                             reference="one card"))
    log(f"data-parallel vs one card: {exact:.3f} of leaves bit-identical")
    if not report["ok"]:
        raise AssertionError("data-parallel result differs from one card")


def count_collectives(hlo: str) -> dict:
    """Collective ops in an HLO module's text, by kind (sync or async)."""
    import re

    kinds = ("all-gather", "all-reduce", "reduce-scatter",
             "collective-permute", "all-to-all")
    return {k: len(re.findall(rf"\b{k}(?:-start)?\(", hlo)) for k in kinds}


def _leaves(out):
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]:
        name = "combined/" + "/".join(
            str(getattr(p, "name", None) or getattr(p, "idx", p))
            for p in path)
        yield name, np.asarray(leaf)


def phase_four_beamform(cfg, card) -> None:
    """Element-sharded synthetic-aperture beamforming over a 4-card axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mmwave_radar_processing_jax.ops import windows
    from mmwave_radar_processing_jax.parallel.mesh import make_mesh
    from mmwave_radar_processing_jax.parallel.sharded_beamform import (
        build_sharded_beamformer,
    )

    ns, elements, n_dir = cfg.num_adc_samples, 8192, 1024
    rng = np.random.default_rng(3)
    data_re = rng.standard_normal((ns, elements)).astype(np.float32)
    data_im = rng.standard_normal((ns, elements)).astype(np.float32)
    positions = (rng.standard_normal((3, elements)) * 0.05).astype(np.float32)
    theta = np.linspace(-1.2, 1.2, n_dir)
    steering = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)],
                        axis=1).astype(np.float32)
    rwin = jnp.asarray(windows.hanning(ns))
    ewin = jnp.asarray(windows.hamming(elements))
    results = {}
    for n_dev in (1, 4):
        mesh = make_mesh({"model": n_dev}, jax.devices()[:n_dev])
        fn = build_sharded_beamformer(mesh, lambda_m=cfg.lambda_m,
                                      split_complex=True)
        sh = NamedSharding(mesh, P(None, "model"))
        args = (jax.device_put(data_re, sh), jax.device_put(data_im, sh),
                jax.device_put(positions, sh), steering, rwin, ewin)
        with mesh:
            out = fn(*args)
            ms = median_ms(fn, args)
        results[n_dev] = np.asarray(out[0]) + 1j * np.asarray(out[1])
        log(f"[{card}] element-sharded beamforming, {elements} elements x "
            f"{n_dir} directions x {ns} samples on {n_dev} card(s): "
            f"{ms:.4f} ms/call")
    err = relative_error(np.abs(results[4]), np.abs(results[1]))
    log(f"beamforming 4 cards vs 1: max relative error {err:.3e}")
    # both runs round the same inputs the same way; only the psum's
    # summation order differs
    if not err <= 1e-4:
        raise AssertionError(f"sharded beamforming differs ({err})")


def phase_four_halo_cfar(card) -> None:
    """Row-sharded OS-CFAR with ppermute halos vs the one-card detector."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import CFAR_PARAMS
    from mmwave_radar_processing_jax.ops import cfar as cfar_ops
    from mmwave_radar_processing_jax.parallel.halo_cfar import (
        os_cfar_2d_detect_row_sharded,
    )
    from mmwave_radar_processing_jax.parallel.mesh import make_mesh

    n_dev = 4
    mesh = make_mesh({"data": n_dev}, jax.devices()[:n_dev])
    rng = np.random.default_rng(5)
    x = rng.exponential(1.0, (4096, 1024)).astype(np.float32)
    fn = os_cfar_2d_detect_row_sharded(mesh, axis="data", **CFAR_PARAMS)
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    with mesh:
        got = np.asarray(fn(xs))
        ms = median_ms(fn, (xs,))
    want = np.asarray(cfar_ops.os_2d_detect(
        jax.device_put(x, jax.devices()[0]), **CFAR_PARAMS))
    log(f"[{card}] halo CFAR {x.shape} rows over {n_dev} cards: {ms:.4f} ms/"
        f"call; {int(want.sum())} detections; identical to one card: "
        f"{np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("halo CFAR differs from the one-card detector")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card paths")
    args = parser.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    card = device_check(n_cards)
    sys.path.insert(0, HERE)

    import jax

    from mmwave_radar_processing_jax.config import load_cfg
    from mmwave_radar_processing_jax.utils.platform import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    cfg = load_cfg(CFG_PATH, array_geometry="ods", array_direction="down")

    def run(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        log(f"[{card}] phase {name}: ok ({time.perf_counter() - t0:.1f} s)")

    if args.four_cards:
        run("four_data_parallel", phase_four_data_parallel, cfg, card)
        run("four_beamform", phase_four_beamform, cfg, card)
        run("four_halo_cfar", phase_four_halo_cfar, card)
    else:
        inputs = flagship_inputs(cfg, BATCH)
        run("pipelines", phase_pipelines, cfg, card, inputs)
        run("kernel_reference", phase_kernel_reference, card)
        run("contest", phase_contest, cfg, card, inputs)
        run("capon_trace", phase_capon_trace, cfg, card, inputs)
        run("process_recording", phase_process_recording, card)
        run("verify", phase_verify, card)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": n_cards}}))


if __name__ == "__main__":
    main()
