"""North-star benchmark: radar frames/s/chip for range-Doppler + CFAR + AoA.

Runs the fused point-cloud pipeline (virtual-array reformat -> windowed
range-Doppler FFT over all 12 virtual channels -> OS-CFAR 2D -> per-detection
AoA FFTs -> cartesian points) on the flagship 6843 ODS 20 Hz config over a
batch of frames, on the GPU (it refuses to time anything else).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline: the reference library publishes no benchmark numbers (BASELINE.md);
``vs_baseline`` divides by the *matching* reference numpy workload timed on
this container's CPU and persisted in ``BASELINE_MEASURED.json``
(``python bench.py --measure-baseline`` re-times all of them; see
``BASELINE_WORKLOADS`` for the metric -> reference-loop mapping).  Metrics
with no reference counterpart (capon, bartlett) print ``vs_baseline: null``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_MEASURED_PATH = os.path.join(_HERE, "BASELINE_MEASURED.json")

CFAR_PARAMS = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
AZ_IDXS, EL_IDXS = (0, 3, 4, 7), (9, 8, 5, 4)

# Which reference workload each metric's ``vs_baseline`` divides by.  Metrics
# absent here (capon/bartlett) have NO reference counterpart — their ratio is
# printed as null rather than against an unrelated workload.
BASELINE_WORKLOADS = {
    "pointcloud": "reference VirtualArrayReformatter + "
                  "RangeDopplerDetector2D[os_cfar_2d] + PointCloudGenerator",
    "velocity": "reference VirtualArrayReformatter + "
                "VelocityEstimator.process(adc_cube, altitude) ODS ADC path",
    "combined": "reference VirtualArrayReformatter + PointCloudGenerator"
                "[os_cfar_2d] + VelocityEstimator ADC path per frame",
    "ground": "reference VirtualArrayReformatter + PointCloudGenerator"
              "[range_doppler_ground_detector] (stateful altimeter gate)",
}


def _flagship_config():
    from mmwave_radar_processing_jax.config import load_cfg

    path = os.path.join(_HERE, "configs", "6843_RadVel_ods_20Hz.cfg")
    return load_cfg(path, array_geometry="ods", array_direction="down")


def _reference_processors():
    """Reference-library processors on the flagship config (CPU numpy)."""
    sys.path.insert(0, "/root/reference")
    from mmwave_radar_processing.config_managers.cfgManager import ConfigManager
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter,
    )
    from mmwave_radar_processing.processors.point_cloud_generator import (
        PointCloudGenerator,
    )
    from mmwave_radar_processing.processors.velocity_estimator import (
        VelocityEstimator,
    )

    cfg = ConfigManager()
    cfg.load_cfg(os.path.join(_HERE, "configs", "6843_RadVel_ods_20Hz.cfg"),
                 "ods", "down")
    var = VirtualArrayReformatter(cfg)
    pcg = PointCloudGenerator(
        cfg, az_antenna_idxs=list(AZ_IDXS), el_antenna_idxs=list(EL_IDXS),
        detector_type="range_doppler_detector_2d",
        detector_params=dict(cfar_type="os_cfar_2d", cfar_params=CFAR_PARAMS),
    )
    # ground-detector params from the reference's shipped
    # analyzer_configs/velocity_analysis_config.yaml:16-30
    pcg_ground = PointCloudGenerator(
        cfg, az_antenna_idxs=list(AZ_IDXS), el_antenna_idxs=list(EL_IDXS),
        detector_type="range_doppler_ground_detector",
        detector_params=dict(
            vel_cfar_type="os_cfar_1d",
            vel_cfar_params=dict(num_train=5, num_guard=2, rho=0.6, alpha=4),
            altimeter_params=dict(
                min_altitude_m=0.25, zoom_search_region_m=0.2,
                altitude_search_limit_m=0.4, range_bias=0.0,
                precise_est_enabled=True,
            ),
        ),
    )
    ve = VelocityEstimator(cfg, lower_range_bound=0.5, upper_range_bound=0.5)
    return var, pcg, pcg_ground, ve


def measure_reference_baselines(n: int = 40) -> dict:
    """Time the reference numpy workloads on CPU (requires /root/reference).

    One entry per metric in :data:`BASELINE_WORKLOADS`; each is the matching
    reference loop timed per frame on identical simulated cubes (reference
    ``scripts/test_vel_estimation.py:145-176`` is the velocity-loop model).
    """
    var, pcg, pcg_ground, ve = _reference_processors()
    rng = np.random.default_rng(0)
    frames = [
        rng.standard_normal((4, 63, 210)) + 1j * rng.standard_normal((4, 63, 210))
        for _ in range(8)
    ]
    virt = [var.process(f) for f in frames]

    def timed(fn, n_iter=n):
        fn(0)  # warmup (fills any internal state/caches)
        t0 = time.perf_counter()
        for i in range(n_iter):
            fn(i)
        return n_iter / (time.perf_counter() - t0)

    out = {}
    out["pointcloud"] = timed(lambda i: pcg.process(var.process(frames[i % 8])))
    out["velocity"] = timed(
        lambda i: ve.process(adc_cube=virt[i % 8], altitude=1.2) is not None
        and var.process(frames[i % 8]) is not None
    )
    out["combined"] = timed(
        lambda i: (
            lambda v: (pcg.process(v), ve.process(adc_cube=v, altitude=1.2))
        )(var.process(frames[i % 8]))
    )
    out["ground"] = timed(
        lambda i: pcg_ground.process(var.process(frames[i % 8]))
    )
    return out


def write_measured_baselines(n: int = 40) -> dict:
    """Measure and persist the per-metric reference baselines."""
    import platform

    vals = measure_reference_baselines(n)
    doc = {
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "host": platform.node(),
        "n_frames": n,
        "baselines": {
            k: {"frames_per_s": round(v, 2), "workload": BASELINE_WORKLOADS[k]}
            for k, v in vals.items()
        },
    }
    with open(BASELINE_MEASURED_PATH, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def load_measured_baseline(metric: str):
    """(frames_per_s, workload) for ``metric``, or (None, reason)."""
    if metric not in BASELINE_WORKLOADS:
        return None, "no reference counterpart for this workload"
    try:
        with open(BASELINE_MEASURED_PATH) as f:
            doc = json.load(f)
        entry = doc["baselines"][metric]
        return float(entry["frames_per_s"]), entry["workload"]
    except (OSError, KeyError, ValueError):
        return None, ("no measured baseline on record — run "
                      "`python bench.py --measure-baseline`")


def _device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=20,
                        help="timed calls per repetition")
    parser.add_argument("--repeats", type=int, default=5,
                        help="timing repetitions; every repeat is recorded "
                             "in the JSON, the median is the value")
    parser.add_argument("--metric",
                        choices=["pointcloud", "velocity", "combined", "ground",
                                 "capon", "bartlett", "scaling"],
                        default="pointcloud",
                        help="pointcloud: RD+CFAR+AoA north star; "
                             "velocity: fused RadVel ego-velocity pipeline; "
                             "combined: point clouds + ego-velocity per frame; "
                             "ground: stateful altimeter-gated ground scan; "
                             "capon/bartlett: covariance beamforming "
                             "range-azimuth heatmaps; "
                             "scaling: samples/s vs devices table (needs at "
                             "least two GPUs)")
    parser.add_argument("--measure-baseline", action="store_true",
                        help="re-time the reference CPU workloads and persist "
                             "BASELINE_MEASURED.json, then exit")
    parser.add_argument("--calibrate", action="store_true",
                        help="measure a large bf16 matmul and a large copy "
                             "on the attached GPU, print them with the "
                             "card's name and power limit, then exit")
    parser.add_argument("--verify", action="store_true",
                        help="run every fused pipeline on identical simulated "
                             "inputs on the default device AND a CPU-oracle "
                             "subprocess, print per-leaf agreement, exit "
                             "nonzero on disagreement (utils/verify.py)")
    parser.add_argument("--verify-metrics", default=None,
                        help="comma list of metrics for --verify "
                             "(default: all fused pipelines)")
    parser.add_argument("--verify-dump", default=None, metavar="NPZ",
                        help="internal: compute the oracle outputs on THIS "
                             "process's backend and save to NPZ, then exit "
                             "(spawned with JAX_PLATFORMS=cpu by --verify)")
    parser.add_argument("--peak-tflops", type=float, default=None,
                        help="float32 peak for MFU (default: the device's "
                             "entry in utils/roofline.PEAKS)")
    parser.add_argument("--peak-gbs", type=float, default=None,
                        help="memory bandwidth peak in GB/s (default: the "
                             "device's entry in utils/roofline.PEAKS)")
    args = parser.parse_args()

    if args.measure_baseline:
        doc = write_measured_baselines()
        for k, v in doc["baselines"].items():
            print(f"reference CPU {k}: {v['frames_per_s']:.2f} frames/s",
                  file=sys.stderr)
        print(f"persisted to {BASELINE_MEASURED_PATH}", file=sys.stderr)
        print(json.dumps(doc))
        return

    import jax

    from mmwave_radar_processing_jax.utils import verify as verify_mod

    metrics = (args.verify_metrics.split(",") if args.verify_metrics
               else list(verify_mod.VERIFY_METRICS))
    if args.verify_dump:
        # CPU-oracle subprocess: the parent set JAX_PLATFORMS=cpu before spawn
        verify_mod.dump_oracle(metrics, batch=min(args.batch, 32),
                               out_npz=args.verify_dump)
        return

    from mmwave_radar_processing_jax.utils.platform import enable_compile_cache

    enable_compile_cache()

    if args.verify:
        report = verify_mod.run_verify(metrics, batch=min(args.batch, 32))
        print(verify_mod.format_report(report), file=sys.stderr)
        worst = min((l.get("agree_frac", 1.0) for l in report["leaves"]),
                    default=1.0)
        print(json.dumps({
            "metric": "on-device parity vs CPU oracle (min leaf agreement)",
            "value": worst,
            "unit": "fraction",
            "vs_baseline": None,
            "ok": report["ok"],
            "device": _device_info(),
            "n_leaves": len(report["leaves"]),
        }))
        sys.exit(0 if report["ok"] else 1)

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {jax.devices()[0]}")

    if args.calibrate:
        from mmwave_radar_processing_jax.utils.roofline import (
            card_power_limit,
            measure_peaks,
        )

        card = card_power_limit()
        print(f"card: {card}", file=sys.stderr)
        print(json.dumps(dict(measure_peaks(), card=card,
                              device=_device_info())))
        return

    if args.metric == "scaling":
        if len(jax.devices()) < 2:
            sys.exit("--metric scaling needs at least two GPUs; found "
                     f"{len(jax.devices())}")
        run_scaling(args)
        return

    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )

    cfg = _flagship_config()
    total_batch = args.batch
    rng = np.random.default_rng(0)
    shape = (total_batch, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    raw_re = jax.device_put(rng.standard_normal(shape).astype(np.float32))
    raw_im = jax.device_put(rng.standard_normal(shape).astype(np.float32))

    if args.metric == "pointcloud":
        fn = build_point_cloud_pipeline(
            cfg, az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
            cfar_params=CFAR_PARAMS, max_dets=128, backend="mxu",
        )
        bench_args = (raw_re, raw_im)
        metric_name = "radar frames/s/device (range-Doppler+CFAR+AoA)"
    elif args.metric == "velocity":
        from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
            build_velocity_pipeline,
        )

        fn = build_velocity_pipeline(cfg)
        altitudes = jax.device_put(np.full(total_batch, 1.2, np.float32))
        bench_args = (raw_re, raw_im, altitudes)
        metric_name = "radar frames/s/device (fused RadVel ego-velocity)"
    elif args.metric == "combined":
        from mmwave_radar_processing_jax.parallel.full_pipeline import (
            build_full_pipeline,
        )

        fn = build_full_pipeline(cfg)
        altitudes = jax.device_put(np.full(total_batch, 1.2, np.float32))
        bench_args = (raw_re, raw_im, altitudes)
        metric_name = "radar frames/s/device (point clouds + ego-velocity)"
    elif args.metric in ("capon", "bartlett"):
        from mmwave_radar_processing_jax.parallel.capon_pipeline import (
            build_capon_pipeline,
        )

        fn = build_capon_pipeline(cfg, antenna_idxs=AZ_IDXS, method=args.metric)
        bench_args = (raw_re, raw_im)
        metric_name = (f"radar frames/s/device ({args.metric} covariance "
                       "beamforming heatmaps)")
    else:  # ground: one lax.scan over the recording (stateful altimeter gate)
        from mmwave_radar_processing_jax.parallel.ground_pipeline import (
            build_ground_point_cloud_pipeline,
        )

        fn = build_ground_point_cloud_pipeline(cfg)
        bench_args = (raw_re, raw_im)
        metric_name = "radar frames/s/device (altimeter-gated ground scan)"

    # alternate two input sets so no call can reuse the previous result
    rng2 = np.random.default_rng(1)
    alt_args = tuple(
        jax.device_put(rng2.standard_normal(a.shape).astype(a.dtype))
        if np.issubdtype(a.dtype, np.floating) and a.ndim > 1
        else a
        for a in bench_args
    )
    arg_sets = [bench_args, alt_args]

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*bench_args))  # compile + one execution
    setup_s = time.perf_counter() - t0

    fps = []
    for _ in range(max(1, args.repeats)):
        t0 = time.perf_counter()
        out = None
        for i in range(args.iters):
            out = fn(*arg_sets[i % 2])
        jax.block_until_ready(out)
        fps.append(args.iters * total_batch / (time.perf_counter() - t0))
    value = float(np.median(fps))

    base_fps, base_note = load_measured_baseline(args.metric)
    result = {
        "metric": metric_name,
        "value": value,
        "unit": "frames/s",
        "vs_baseline": value / base_fps if base_fps else None,
        "baseline_frames_per_s": base_fps,
        "baseline_workload": base_note,
        "per_repeat_frames_per_s": fps,
        "setup_s": setup_s,
        "device": _device_info(),
    }
    result.update(
        _roofline_fields(fn, bench_args, args, cfg, value,
                         frames_per_dispatch=total_batch))
    print(json.dumps(result))


def run_scaling(args) -> None:
    """samples/s-vs-devices tables for the sharded pipelines (weak scaling).

    Prints one JSON line whose ``value`` is the combined-pipeline parallel
    efficiency at the largest device count; the full per-pipeline tables
    ride in the ``table`` field.
    """
    from mmwave_radar_processing_jax.parallel.scaling import measure_scaling

    cfg = _flagship_config()
    table = measure_scaling(cfg, per_device_batch=args.batch,
                            iters=args.iters)
    # headline: the feed-INCLUSIVE serving pipeline (SURVEY §5.8 multi-host
    # input feed) at the largest device count
    head = table.get("combined_with_feed", table["combined"])
    eff = head["efficiency"][-1]
    n_max = head["devices"][-1]
    result = {
        "metric": f"samples/s scaling efficiency 1->{n_max} devices "
                  "(combined pipeline incl. input feed, weak scaling)",
        "value": eff,
        "unit": "fraction",
        "vs_baseline": None,
        "input_feed_included": bool(head.get("input_feed_included",
                                             [False])[-1]),
        "device": _device_info(),
        "table": table,
    }
    print(json.dumps(result))


def _cost_analysis(fn, bench_args):
    """(flops, "bytes accessed", source) per dispatch from the compiled HLO."""
    ca = fn.lower(*bench_args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"]), float(ca["bytes accessed"]), "xla_cost_analysis"


def _roofline_fields(fn, bench_args, args, cfg, frames_per_s,
                     frames_per_dispatch) -> dict:
    """MFU / roofline accounting for the timed pipeline.

    FLOP and byte counts come from the compiled executable's own
    ``cost_analysis()``.  Peaks come from the device's entry in
    :data:`utils.roofline.PEAKS` (an unknown device is an error) unless
    ``--peak-tflops`` / ``--peak-gbs`` give them.
    """
    import jax

    from mmwave_radar_processing_jax.utils import roofline

    flops_pd, bytes_pd, source = _cost_analysis(fn, bench_args)
    flops_per_frame = flops_pd / frames_per_dispatch
    bytes_per_frame = bytes_pd / frames_per_dispatch
    peaks = roofline.device_peaks(jax.devices()[0].device_kind)
    peak_tflops = args.peak_tflops or peaks["f32_tflops"]
    peak_gbs = args.peak_gbs or peaks["hbm_gbs"]
    tflops = frames_per_s * flops_per_frame / 1e12
    gbs = frames_per_s * bytes_per_frame / 1e9
    # NB: cost-analysis "bytes accessed" counts every operand touch, so
    # operands that fusion keeps on chip are billed as memory traffic — an
    # *upper bound*; hbm_util > 1 means on-chip reuse, not a violation.
    return {
        "flops_per_frame": flops_per_frame,
        "bytes_per_frame": bytes_per_frame,
        "tflops": tflops,
        "mfu": tflops / peak_tflops,
        "hbm_gbs": gbs,
        "hbm_util": gbs / peak_gbs,
        "bound": roofline.classify_bound(
            tflops, gbs, peak_tflops=peak_tflops, peak_gbs=peak_gbs
        ),
        "cost_source": source,
        "peak_tflops": peak_tflops,
        "peak_gbs": peak_gbs,
    }


if __name__ == "__main__":
    main()
