#!/usr/bin/env python
"""Batch-process a recording at full device throughput (the production path).

Streams a CPSL recording through the fused device pipelines — native C++
loader + double-buffered host prefetch feeding split re/im batches, point
clouds and ego-velocities out — with per-stage throughput telemetry and
periodic checkpointing so long jobs resume where they stopped.

Example:
    python scripts/simulate_dataset.py --out /tmp/sim_radvel --frames 300
    python scripts/process_recording.py --dataset /tmp/sim_radvel \
        --out /tmp/processed.npz --batch 64
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_jax.utils.env import load_env, resolve_dir

load_env()

from mmwave_radar_processing_jax.config import load_cfg
from mmwave_radar_processing_jax.data import native_loader
from mmwave_radar_processing_jax.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_jax.utils.logger import setup_logger
from mmwave_radar_processing_jax.utils.profiling import StageTimer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--radar-config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--array-geometry", default="ods")
    p.add_argument("--array-direction", default="down")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--altitude", type=float, default=1.2,
                   help="range-window center for the velocity pipeline")
    p.add_argument("--max-dets", type=int, default=128)
    p.add_argument("--loader-threads", type=int, default=8)
    p.add_argument("--no-velocity", action="store_true")
    p.add_argument("--detector", choices=["2d", "ground"], default="2d",
                   help="2d: OS-CFAR-2D detector + ADC-path velocity; "
                        "ground: altitude-gated detector (stateful altimeter "
                        "scan) + points-path velocity")
    args = p.parse_args(argv)

    logger = setup_logger()
    import jax

    from mmwave_radar_processing_jax.parallel import build_point_cloud_pipeline
    from mmwave_radar_processing_jax.parallel.full_pipeline import build_full_pipeline
    from mmwave_radar_processing_jax.parallel.ground_pipeline import (
        build_ground_point_cloud_pipeline,
    )

    cfg = load_cfg(resolve_dir(args.radar_config, "CONFIG_DIRECTORY"),
                   args.array_geometry, args.array_direction)
    dataset = CpslDS(resolve_dir(args.dataset, "DATASET_DIRECTORY"))
    paths = dataset._files["radar_adc"]
    frame_shape = (cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
    logger.info("%d frames, shape %s, backend=%s", len(paths), frame_shape,
                jax.default_backend())

    ground_fn = None
    if args.detector == "ground":
        ground_fn = build_ground_point_cloud_pipeline(cfg, max_dets=args.max_dets)
        pc_fn = full_fn = None
    elif args.no_velocity:
        pc_fn = build_point_cloud_pipeline(cfg, max_dets=args.max_dets,
                                           backend="mxu")
        full_fn = None
    else:
        # one dispatch yields both products (shared reformat/range DFT)
        pc_fn = None
        full_fn = build_full_pipeline(cfg, max_dets=args.max_dets)

    timer = StageTimer()
    fetcher = native_loader.SplitFramePrefetcher(
        paths, frame_shape, batch=args.batch, nthreads=args.loader_threads
    )

    all_points, all_valid, all_vel, all_alt = [], [], [], []
    carry_alt = None
    n_done = 0
    for re_b, im_b in fetcher:
        b = re_b.shape[0]
        # pad the tail batch so the jitted shapes stay static
        if b < args.batch:
            pad = args.batch - b
            re_b = np.concatenate([re_b, np.zeros((pad, *frame_shape), np.float32)])
            im_b = np.concatenate([im_b, np.zeros((pad, *frame_shape), np.float32)])

        with timer.stage("h2d", items=b) as sink:
            re_d, im_d = jax.device_put(re_b), jax.device_put(im_b)
            sink((re_d, im_d))

        if ground_fn is not None:
            with timer.stage("ground_point_cloud", items=b) as sink:
                out = sink(
                    ground_fn(re_d, im_d)
                    if carry_alt is None
                    else ground_fn(re_d, im_d, carry_alt)
                )
            carry_alt = out.final_altitude
            pc = out
            all_alt.append(np.asarray(out.altitude[:b]))
        elif full_fn is not None:
            alts = jax.device_put(np.full(args.batch, args.altitude, np.float32))
            with timer.stage("pointcloud+velocity", items=b) as sink:
                pc, vb = sink(full_fn(re_d, im_d, alts))
            all_vel.append(np.asarray(vb.velocity[:b]))
        else:
            with timer.stage("point_cloud", items=b) as sink:
                pc = sink(pc_fn(re_d, im_d))
        all_points.append(np.asarray(pc.points[:b]))
        all_valid.append(np.asarray(pc.valid[:b]))

        n_done += b
        if n_done % (args.batch * 4) == 0:
            logger.info("processed %d/%d frames", n_done, len(paths))

    out = {
        "points": np.concatenate(all_points),
        "valid": np.concatenate(all_valid),
    }
    if all_vel:
        out["velocity"] = np.concatenate(all_vel)
    if all_alt:
        out["altitude"] = np.concatenate(all_alt)
    np.savez_compressed(args.out, **out)
    logger.info("wrote %s (%d frames)", args.out, n_done)
    timer.log_report()


if __name__ == "__main__":
    main()
