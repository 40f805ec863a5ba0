"""Kernel choice, compile cache, peaks table, precision modes, GPU entry points."""

import functools
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from mmwave_radar_processing_jax.utils import platform as plat
from mmwave_radar_processing_jax.utils import roofline

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


# --------------------------------------------------------------- kernel route
@pytest.mark.parametrize("platform,route", [("cpu", "xla"), ("gpu", "triton")])
def test_kernel_route(platform, route):
    assert plat.kernel_route(platform) == route


def test_kernel_route_defaults_to_backend():
    assert jax.default_backend() == "cpu"
    assert plat.kernel_route() == "xla"


def _primitives(jaxpr):
    """Every equation of a jaxpr and of the jaxprs nested in its params."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _primitives(inner)


def _velocity_jaxpr(cfg, monkeypatch, platform):
    from mmwave_radar_processing_jax.parallel import velocity_pipeline as vp

    monkeypatch.setattr(vp, "kernel_route",
                        functools.partial(plat.kernel_route, platform))
    fn = vp.build_velocity_pipeline(cfg)
    shape = (2, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw = jax.ShapeDtypeStruct(shape, np.float32)
    alt = jax.ShapeDtypeStruct((2,), np.float32)
    return jax.make_jaxpr(fn)(raw, raw, alt).jaxpr


@pytest.mark.parametrize("platform,kernels", [("cpu", 0), ("gpu", 1)])
def test_velocity_pipeline_kernel_choice(flagship_config, monkeypatch,
                                         platform, kernels):
    """The velocity pipeline asks kernel_route: the Pallas kernel on the GPU
    (compiled, never interpreted), the plain form on the CPU."""
    calls = [e for e in _primitives(_velocity_jaxpr(flagship_config,
                                                    monkeypatch, platform))
             if e.primitive.name == "pallas_call"]
    assert len(calls) == kernels
    for eqn in calls:
        assert not eqn.params["interpret"]
        assert eqn.params["backend"] == "triton"


def test_velocity_pipeline_rejects_unknown_backend(flagship_config):
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )

    for bad in ("pallas", "pallas2", "auto"):
        with pytest.raises(ValueError, match="response_backend"):
            build_velocity_pipeline(flagship_config, response_backend=bad)


# --------------------------------------------------------------- compile cache
def _record_updates(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    return updates


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = _record_updates(monkeypatch)
    assert plat.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in dict(updates)


def test_compile_cache_fixed_path_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = _record_updates(monkeypatch)
    assert plat.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    dirs = [v for k, v in updates if k == "jax_compilation_cache_dir"]
    assert dirs == [os.path.join(REPO, ".jax_cache")]


# --------------------------------------------------------------- peaks table
def test_peaks_known_device():
    p = roofline.device_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"f32_tflops": 67.0, "tf32_tflops": 495.0,
                 "bf16_tflops": 989.0, "hbm_gbs": 3350.0}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peaks_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.device_peaks(kind)


def test_classify_bound_needs_peaks():
    assert roofline.classify_bound(1.0, 10.0, peak_tflops=67.0,
                                   peak_gbs=3350.0) == "dispatch"
    assert roofline.classify_bound(40.0, 10.0, peak_tflops=67.0,
                                   peak_gbs=3350.0) == "compute"


# ------------------------------------------------------------ precision modes
def _dot_precisions(cfg, mode, dataflow="union"):
    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )

    fn = build_point_cloud_pipeline(cfg, aoa_precision=mode, max_dets=16,
                                    dataflow=dataflow)
    shape = (1, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw = jax.ShapeDtypeStruct(shape, np.float32)
    jaxpr = jax.make_jaxpr(fn)(raw, raw).jaxpr
    out = []
    for eqn in _primitives(jaxpr):
        if eqn.primitive.name == "dot_general":
            prec = eqn.params["precision"]
            out.append(None if prec is None else
                       max(prec, key=lambda p: p.value).name
                       if isinstance(prec, tuple) else str(prec))
    return out


@pytest.mark.parametrize("dataflow", ["union", "raw"])
def test_f32_mode_dot_precision(flagship_config, dataflow):
    """No mode asks for HIGH (TF32 on the GPU); "f32" runs its DFTs at
    HIGHEST, so it has more full-float32 dots than "exact", and "fast"
    has none."""
    counts = {}
    for mode in ("fast", "exact", "f32"):
        precs = _dot_precisions(flagship_config, mode, dataflow)
        assert "HIGH" not in precs, (mode, precs)
        counts[mode] = precs.count("HIGHEST")
    assert counts["fast"] == 0
    assert counts["f32"] > counts["exact"] > 0


# ------------------------------------------------------------ GPU entry points
def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_refuses_cpu(args):
    r = _run(["chip_smoke.py"] + args)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("metric", ["pointcloud", "scaling"])
def test_bench_refuses_cpu(metric):
    r = _run(["bench.py", "--metric", metric, "--batch", "8"])
    assert r.returncode != 0
    assert '"value"' not in r.stdout


@pytest.mark.parametrize("got,want,err", [
    ([1.0, 2.0], [1.0, 2.0], 0.0),
    ([1.0, 2.5], [1.0, 2.0], 0.25),
    ([0.0, 0.0], [0.0, 0.0], 0.0),
])
def test_chip_smoke_relative_error(got, want, err):
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.relative_error(np.asarray(got), np.asarray(want)) == \
        pytest.approx(err)


def test_chip_smoke_doppler_az_reference_matches_kernel_oracle():
    """The HIGHEST einsum reference the smoke run checks the kernel against
    agrees with the kernel (interpreter) at a small size."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from mmwave_radar_processing_jax.ops.pallas.doppler_az import set_responses

    rng = np.random.default_rng(2)
    set_idx = ((0, 3, 4, 7), (1, 2, 5, 6), (9, 8, 5, 4), (11, 10, 7, 6))
    u_re = rng.standard_normal((2, 12, 4, 20)).astype(np.float32)
    u_im = rng.standard_normal((2, 12, 4, 20)).astype(np.float32)
    wgt = rng.random((2, 4)).astype(np.float32)
    fct = rng.standard_normal((16, 9)).astype(np.float32)
    fst = rng.standard_normal((16, 9)).astype(np.float32)
    want = chip_smoke.doppler_az_reference(u_re, u_im, wgt, fct, fst,
                                           set_idx)
    got = jax.vmap(lambda a, b, c: set_responses(
        a, b, c, fct, fst, set_idx=set_idx, interpret=True))(u_re, u_im, wgt)
    assert chip_smoke.relative_error(got, want) < 1e-5


# -------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_doppler_az_kernel_on_gpu(gpu):
    """The compiled Triton kernel == the plain form at flagship widths."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from mmwave_radar_processing_jax.ops.pallas.doppler_az import set_responses

    rng = np.random.default_rng(0)
    set_idx = ((0, 3, 4, 7), (1, 2, 5, 6), (9, 8, 5, 4), (11, 10, 7, 6))
    u_re = rng.standard_normal((64, 12, 19, 70)).astype(np.float32)
    u_im = rng.standard_normal((64, 12, 19, 70)).astype(np.float32)
    wgt = rng.random((64, 19)).astype(np.float32)
    fct = rng.standard_normal((16, 60)).astype(np.float32)
    fst = rng.standard_normal((16, 60)).astype(np.float32)
    got = jax.jit(jax.vmap(lambda a, b, c: set_responses(
        a, b, c, fct, fst, set_idx=set_idx)))(u_re, u_im, wgt)
    want = chip_smoke.doppler_az_reference(u_re, u_im, wgt, fct, fst,
                                           set_idx)
    assert chip_smoke.relative_error(got, want) <= chip_smoke.KERNEL_REL_TOL


@pytest.mark.gpu
def test_velocity_backends_agree_on_gpu(gpu, flagship_config):
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )
    from mmwave_radar_processing_jax.utils.verify import make_inputs

    args = make_inputs(flagship_config, 16)
    a = build_velocity_pipeline(flagship_config, response_backend="xla")(*args)
    b = build_velocity_pipeline(flagship_config,
                                response_backend="triton")(*args)
    np.testing.assert_allclose(np.asarray(b.vx), np.asarray(a.vx),
                               rtol=1e-4, atol=1e-4)


def test_count_collectives_sync_and_async():
    sys.path.insert(0, REPO)
    import chip_smoke

    hlo = ("%a = f32[8] all-gather(%x)\n"
           "%b = (f32[4], f32[8]) all-gather-start(%y)\n"
           "%c = f32[8] all-gather-done(%b)\n"
           "%d = f32[8] all-reduce-start(%z)\n"
           "%e = f32[8] collective-permute(%w)\n")
    assert chip_smoke.count_collectives(hlo) == {
        "all-gather": 2, "all-reduce": 1, "reduce-scatter": 0,
        "collective-permute": 1, "all-to-all": 0}
