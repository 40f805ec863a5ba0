"""Device verification harness: device pipelines vs the CPU parity oracle.

The test suite runs on the CPU (``tests/conftest.py``), so by itself it never
certifies that the *device* path (the split-complex formulations in
``ops/mxu.py``, the GPU's TF32 matmuls, the Pallas kernels) matches the CPU
oracle.  This module closes that gap reproducibly: ``python bench.py
--verify`` runs every fused pipeline on identical simulated inputs twice —
once on the default device (the GPU) and once in a CPU subprocess — and
prints per-leaf agreement with the precision each leaf was computed in.

Role model: the reference's integration check runs its full pipeline on real
recordings and eyeballs/asserts the outputs
(``/root/reference/tests/verify_processors.py:118-154``); here the CPU run
*is* the oracle (it is itself parity-tested against the live reference in
``tests/test_parity_*.py``), so the device run is transitively certified
against the reference.

Pass criteria (see :func:`compare_outputs`): discrete decisions (detection
counts, validity masks, peak/bin indices) must agree on >= ``MIN_DISCRETE_
AGREEMENT`` of elements — device matmuls round (TF32) and accumulate in a
different order than the CPU, so a borderline CFAR comparison or an argmax
tie can legitimately flip — and float leaves must agree to ``FLOAT_ATOL``
wherever the discrete decisions agree.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Sequence

import numpy as np

#: metrics covered by the verify pass (every fused device pipeline)
VERIFY_METRICS = ("pointcloud", "pointcloud_exact", "pointcloud_f32",
                  "velocity", "combined", "ground", "capon", "bartlett")

#: the precision each metric's device run computes in (GPU; the CPU oracle
#: is float32 throughout)
METRIC_PRECISION = {
    "pointcloud": "aoa_precision=fast: TF32 DFTs and value selection",
    "pointcloud_exact": "aoa_precision=exact: TF32 DFTs, float32 selection "
                        "and angle transform",
    "pointcloud_f32": "aoa_precision=f32: float32 (Precision.HIGHEST)",
    "velocity": "TF32 DFTs, float32 angle contraction",
    "combined": "TF32 DFTs, float32 angle contraction",
    "ground": "TF32 DFTs and value selection",
    "capon": "TF32 covariance and steering, float32 Cholesky",
    "bartlett": "TF32 steering contraction",
}

# Gates, derived from the H100 (NVIDIA H100 80GB HBM3, 400 W power limit)
# run of ``chip_smoke.py`` on the seed-7 batch of 32 frames:
#: minimum fraction of agreeing elements per leaf.  Measured: every
#: positional leaf 1.0 except capon/out at 0.99997 (one TF32-rounded
#: heatmap cell past the float tolerance); a wrong kernel scores far below.
MIN_DISCRETE_AGREEMENT = 0.99
#: max |device - oracle| for float leaves, computed only where the frame's
#: discrete decisions agree (a flipped detection legitimately moves points)
FLOAT_ATOL = 2e-2
#: relative scale: TF32 keeps 10 mantissa bits (2^-11 ~ 5e-4 per rounding),
#: so 1e-3 of the leaf's largest magnitude covers one rounding of the
#: largest inputs (bartlett/out: max delta 250 on a scale of ~1e6, agree 1.0)
FLOAT_RTOL = 1e-3


def make_inputs(cfg, batch: int, seed: int = 7):
    """Deterministic simulated down-facing frames shared by both runs.

    Ground cone + nadir return (what the altimeter/velocity paths expect)
    plus 1-3 discrete point targets per frame, so CFAR detections, AoA picks
    and RANSAC fits all exercise their real code paths.
    """
    from mmwave_radar_processing_jax.data import (
        PointTarget,
        ground_scene,
        simulate_frames,
    )

    rng = np.random.default_rng(seed)
    scenes = []
    for i in range(batch):
        alt = 0.9 + 0.4 * rng.random()
        scene = ground_scene(
            cfg, altitude_m=alt,
            ego_vel=(0.3 * rng.standard_normal(), 0.2 * rng.standard_normal(),
                     0.1 * rng.standard_normal()),
            num_patches=32, rng=rng,
        )
        for _ in range(int(rng.integers(1, 4))):
            scene.targets.append(PointTarget(
                range_m=float(rng.uniform(0.4, 0.9) * cfg.range_max_m),
                azimuth_rad=float(rng.uniform(-0.8, 0.8)),
                elevation_rad=float(rng.uniform(-0.4, 0.4)),
                velocity_m_s=float(rng.uniform(-0.5, 0.5) * cfg.vel_max_m_s),
                rcs=float(rng.uniform(2.0, 8.0)),
            ))
        scenes.append(scene)
    raw = simulate_frames(cfg, scenes, rng=np.random.default_rng(seed + 1))
    raw_re = np.ascontiguousarray(raw.real, np.float32)
    raw_im = np.ascontiguousarray(raw.imag, np.float32)
    altitudes = (0.9 + 0.4 * np.random.default_rng(seed + 2)
                 .random(batch)).astype(np.float32)
    return raw_re, raw_im, altitudes


def _build_fn(cfg, metric: str):
    from bench import AZ_IDXS, CFAR_PARAMS, EL_IDXS  # repo-root bench.py

    if metric in ("pointcloud", "pointcloud_exact", "pointcloud_f32"):
        from mmwave_radar_processing_jax.parallel.pipeline import (
            build_point_cloud_pipeline,
        )

        precision = {"pointcloud": "fast", "pointcloud_exact": "exact",
                     "pointcloud_f32": "f32"}[metric]
        fn = build_point_cloud_pipeline(
            cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
            cfar_params=CFAR_PARAMS, max_dets=128, backend="mxu",
            aoa_precision=precision,
        )
        return fn, False
    if metric == "velocity":
        from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
            build_velocity_pipeline,
        )

        return build_velocity_pipeline(cfg), True
    if metric == "combined":
        from mmwave_radar_processing_jax.parallel.full_pipeline import (
            build_full_pipeline,
        )

        return build_full_pipeline(cfg), True
    if metric == "ground":
        from mmwave_radar_processing_jax.parallel.ground_pipeline import (
            build_ground_point_cloud_pipeline,
        )

        return build_ground_point_cloud_pipeline(cfg), False
    if metric in ("capon", "bartlett"):
        from mmwave_radar_processing_jax.parallel.capon_pipeline import (
            build_capon_pipeline,
        )

        return (build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method=metric),
                False)
    raise ValueError(f"unknown verify metric {metric!r}")


def compute_outputs(cfg, metrics: Sequence[str], batch: int,
                    seed: int = 7) -> Dict[str, np.ndarray]:
    """Run each metric's fused pipeline; flatten outputs to named host arrays.

    Keys are ``{metric}/{leaf_path}``; values are numpy (host-fetched).
    Runs on whatever JAX backend the process is configured for — the caller
    decides CPU oracle vs device.
    """
    import jax

    raw_re, raw_im, altitudes = make_inputs(cfg, batch, seed)
    out: Dict[str, np.ndarray] = {}
    for metric in metrics:
        fn, needs_alt = _build_fn(cfg, metric)
        args = (raw_re, raw_im) + ((altitudes,) if needs_alt else ())
        args = tuple(jax.device_put(a) for a in args)
        res = fn(*args)
        leaves = jax.tree_util.tree_flatten_with_path(res)[0]
        for path, leaf in leaves:
            name = "/".join(
                getattr(p, "name", None) or str(getattr(p, "idx", p))
                for p in path
            ) or "out"
            out[f"{metric}/{name}"] = np.asarray(leaf)
    return out


#: minimum mean per-frame intersection-over-union for compacted point sets.
#: Measured: ``aoa_precision="fast"`` (and combined, which shares it) 0.972
#: with 1.1% same-cell adjacent-angle-bin flips, ``"exact"`` 0.978 with 0.8%
#: — TF32 DFTs move borderline CFAR cells and near-tied AoA argmaxes; ground
#: 1.0.  The gate sits below those by the spread a different scene batch
#: can add, and far above a broken split-complex path (~0).
MIN_POINTS_IOU = 0.90
#: fraction of frames whose detection count must agree within +/-2.
#: Measured 1.0 for every pipeline (exact count on 87.5% of frames in the
#: TF32 modes, 100% in "f32"); 0.90 allows three frames of 32 past +/-2.
MIN_COUNT_NEAR = 0.90

#: raised certification gates for the full-precision mode: with the whole
#: decision chain in float32 (``aoa_precision="f32"``: Precision.HIGHEST
#: DFTs + exact hi/lo selection), device and CPU oracle must agree on
#: essentially every discrete decision — "ok" there means certified, not
#: merely "not broken".  Measured: set-IoU 0.991 (0.4% angle flips from
#: summation order alone), counts exact on every frame.
METRIC_POINTS_IOU = {"pointcloud_f32": 0.95}
METRIC_COUNT_NEAR = {"pointcloud_f32": 0.95}


def _point_set_report(o_pts, o_valid, d_pts, d_valid, tol: float) -> dict:
    """Per-frame set-IoU for fixed-capacity ``(points, valid)`` outputs.

    A single borderline CFAR flip (the device's default-precision matmul
    DFTs differ from CPU f32 at ~1e-3 relative, so noise-level threshold
    comparisons legitimately flip) SHIFTS the row-major compaction — every
    later slot then holds a different point, so positional comparison
    reads ~0.4% of flipped decisions as ~40% "disagreement".  The honest
    metric is set overlap: match valid rows within ``tol`` (greedy nearest).
    """
    ious, angle_flips, totals = [], 0, 0
    for f in range(o_pts.shape[0]):
        a = o_pts[f][o_valid[f].astype(bool)]
        b = d_pts[f][d_valid[f].astype(bool)]
        totals += max(len(a), len(b))
        if not len(a) and not len(b):
            ious.append(1.0)
            continue
        if not len(a) or not len(b):
            ious.append(0.0)
            continue
        d2 = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        used = np.zeros(len(b), bool)
        hits = 0
        unmatched_a = []
        for i in np.argsort(d2.min(axis=1)):
            j = int(np.argmin(np.where(used, np.inf, d2[i])))
            if not used[j] and d2[i, j] <= tol:
                used[j] = True
                hits += 1
            else:
                unmatched_a.append(i)
        ious.append(hits / (len(a) + len(b) - hits))
        # decompose the residual: an unmatched pair sharing (range, vel) is
        # the SAME detection cell whose AoA argmax flipped (a discrete
        # decision on a ~1e-3-perturbed spectrum), not a missed detection
        if unmatched_a and (~used).any():
            rv_a = np.stack([np.linalg.norm(a[unmatched_a, :3], axis=1),
                             a[unmatched_a, 3]], axis=1)
            bb = b[~used]
            rv_b = np.stack([np.linalg.norm(bb[:, :3], axis=1),
                             bb[:, 3]], axis=1)
            dd = np.linalg.norm(rv_a[:, None] - rv_b[None, :], axis=-1)
            angle_flips += int(np.sum(dd.min(axis=1) <= tol)) \
                if dd.size else 0
    return {"set_iou_mean": float(np.mean(ious)),
            "set_iou_min": float(np.min(ious)),
            "angle_flip_frac": round(angle_flips / max(totals, 1), 4)}


def compare_outputs(oracle: Dict[str, np.ndarray],
                    device: Dict[str, np.ndarray]) -> dict:
    """Per-leaf agreement report + overall pass/fail.

    Fixed-capacity compacted sets (``*/points`` with a sibling ``*/valid``)
    are scored as per-frame sets (:func:`_point_set_report`); their sibling
    ``*/count`` passes when nearly all frames agree within +/-2 (each
    borderline CFAR flip moves the count by one).  All other leaves compare
    positionally.
    """
    leaves = []
    ok_all = True
    for key in sorted(oracle):
        o, d = oracle[key], device.get(key)
        prefix = key.rsplit("/", 1)[0]
        if (key.endswith("/points") or key.endswith("points")) and \
                f"{prefix}/valid" in oracle and d is not None:
            rep = _point_set_report(o, oracle[f"{prefix}/valid"],
                                    d, device[f"{prefix}/valid"], tol=1e-2)
            gate = METRIC_POINTS_IOU.get(key.split("/", 1)[0],
                                         MIN_POINTS_IOU)
            entry = {"leaf": key, "shape": list(o.shape),
                     "dtype": str(o.dtype), "comparison": "set_iou",
                     **rep,
                     "agree_frac": rep["set_iou_mean"],
                     "gate": gate,
                     "ok": rep["set_iou_mean"] >= gate}
            ok_all = ok_all and entry["ok"]
            leaves.append(entry)
            continue
        if key.endswith("/valid") and f"{prefix}/points" in oracle \
                and d is not None:
            # redundant with the set-IoU + count checks: valid is the
            # compaction's "first count slots" mask, so each borderline
            # flip moves exactly one slot — recorded, not gated
            entry = {"leaf": key, "shape": list(o.shape),
                     "dtype": str(o.dtype), "comparison": "informational",
                     "agree_frac": float(np.mean(o == d)) if o.size else 1.0,
                     "ok": True}
            leaves.append(entry)
            continue
        if key.endswith("/count") and f"{prefix}/points" in oracle \
                and d is not None:
            near = float(np.mean(np.abs(o.astype(int) - d.astype(int)) <= 2))
            gate = METRIC_COUNT_NEAR.get(key.split("/", 1)[0],
                                         MIN_COUNT_NEAR)
            entry = {"leaf": key, "shape": list(o.shape),
                     "dtype": str(o.dtype), "comparison": "count_within_2",
                     "agree_frac": near,
                     "exact_frac": float(np.mean(o == d)),
                     "max_abs_delta": int(np.max(np.abs(
                         o.astype(int) - d.astype(int)))) if o.size else 0,
                     "gate": gate,
                     "ok": near >= gate}
            ok_all = ok_all and entry["ok"]
            leaves.append(entry)
            continue
        entry = {"leaf": key, "shape": list(o.shape), "dtype": str(o.dtype)}
        if d is None:
            entry.update(status="missing_on_device", ok=False)
            ok_all = False
            leaves.append(entry)
            continue
        if np.issubdtype(o.dtype, np.floating):
            delta = np.abs(o.astype(np.float64) - d.astype(np.float64))
            scale = max(1.0, float(np.max(np.abs(o))) if o.size else 1.0)
            tol = FLOAT_ATOL + FLOAT_RTOL * scale
            frac = float(np.mean(delta <= tol)) if o.size else 1.0
            entry.update(
                max_abs_delta=float(delta.max()) if o.size else 0.0,
                p999_abs_delta=float(np.quantile(delta, 0.999)) if o.size
                else 0.0,
                tol=tol,
                agree_frac=frac,
                ok=frac >= MIN_DISCRETE_AGREEMENT,
            )
        else:
            agree = float(np.mean(o == d)) if o.size else 1.0
            entry.update(
                agree_frac=agree,
                mismatches=int(np.sum(o != d)),
                ok=agree >= MIN_DISCRETE_AGREEMENT,
            )
        ok_all = ok_all and entry["ok"]
        leaves.append(entry)
    return {"ok": ok_all, "leaves": leaves}


def run_verify(metrics: Sequence[str], batch: int, seed: int = 7) -> dict:
    """Device-vs-CPU-oracle verification report (:func:`compare_outputs`).

    The oracle runs in a subprocess with ``JAX_PLATFORMS=cpu``, so it never
    opens the GPU; the device run happens in THIS process on its default
    backend.
    """
    import jax

    from mmwave_radar_processing_jax.config import load_cfg

    # Clamp once HERE so oracle and device always see the same leading dim:
    # the spawned --verify-dump path used to re-clamp to min(batch, 32) while
    # the in-process device run used the caller's value — a direct
    # run_verify(batch=64) then produced shape-mismatched comparisons.
    batch = min(batch, 32)

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = load_cfg(os.path.join(here, "configs", "6843_RadVel_ods_20Hz.cfg"),
                   array_geometry="ods", array_direction="down")

    with tempfile.TemporaryDirectory() as td:
        oracle_npz = os.path.join(td, "oracle.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "bench.py"),
             "--verify-dump", oracle_npz, "--batch", str(batch),
             "--verify-metrics", ",".join(metrics)],
            env=env, cwd=here, capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"CPU oracle subprocess failed:\n{proc.stderr[-4000:]}")
        with np.load(oracle_npz) as z:
            oracle = {k: z[k] for k in z.files}

    device = compute_outputs(cfg, metrics, batch, seed)
    report = compare_outputs(oracle, device)
    report.update(
        batch=batch,
        seed=seed,
        metrics=list(metrics),
        device=jax.devices()[0].device_kind,
        precision={m: METRIC_PRECISION[m] for m in metrics},
        measured_at=time.strftime("%Y-%m-%dT%H:%M:%S"),
        criteria=dict(min_discrete_agreement=MIN_DISCRETE_AGREEMENT,
                      float_atol=FLOAT_ATOL, float_rtol=FLOAT_RTOL,
                      min_points_set_iou=MIN_POINTS_IOU,
                      min_count_within_2=MIN_COUNT_NEAR),
    )
    return report


def format_report(report: dict, reference: str = "CPU oracle") -> str:
    """One line per leaf: agreement, gate and the metric's precision."""
    lines = [f"verify on {report['device']} vs {reference}, batch "
             f"{report['batch']}: {'ok' if report['ok'] else 'FAILED'}"]
    for leaf in report["leaves"]:
        metric = leaf["leaf"].split("/", 1)[0]
        extra = "".join(
            f" {k}={leaf[k]}" for k in ("gate", "max_abs_delta", "exact_frac",
                                        "angle_flip_frac", "mismatches")
            if k in leaf)
        lines.append(
            f"  {leaf['leaf']:<40} {leaf.get('comparison', 'positional'):<14}"
            f" agree={leaf.get('agree_frac', float('nan')):.5f}"
            f" ok={leaf['ok']}{extra}"
            f"  [{METRIC_PRECISION.get(metric, '?')}]")
    return "\n".join(lines)


def dump_oracle(metrics: Sequence[str], batch: int, out_npz: str,
                seed: int = 7) -> None:
    """CPU-subprocess entry: compute oracle outputs and save to ``out_npz``."""
    from mmwave_radar_processing_jax.config import load_cfg

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = load_cfg(os.path.join(here, "configs", "6843_RadVel_ods_20Hz.cfg"),
                   array_geometry="ods", array_direction="down")
    out = compute_outputs(cfg, metrics, batch, seed)
    np.savez(out_npz, **out)
