"""Stage bisection of the north-star point-cloud pipeline on the GPU.

Times cumulative prefixes of the fused pipeline (range DFT union cube ->
ch0 Doppler map + magnitude -> OS-CFAR counting detection -> interior
compaction -> AoA values -> angles + points) as separate jitted programs,
each repetition of ``--iters`` calls ended in ``block_until_ready``, so each
stage's marginal cost is measured, not inferred.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

from bench import AZ_IDXS, EL_IDXS, CFAR_PARAMS, _flagship_config  # noqa: E402


def build_stage_fns(cfg, max_dets=128, aoa_precision="fast"):
    import jax
    import jax.numpy as jnp

    from mmwave_radar_processing_jax.config import grids
    from mmwave_radar_processing_jax.ops import cfar as cfar_ops, masked, mxu
    from mmwave_radar_processing_jax.processors.point_cloud import (
        spherical_to_cartesian_flu,
    )

    ns, nc_loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    az_idx = np.asarray(AZ_IDXS, int)
    el_idx = np.asarray(EL_IDXS, int)
    angle_bins = jnp.asarray(grids.angle_bins(64))
    rng_factors, dop_factors = mxu.range_doppler_factors(ns, nc_loops)
    az_factors = mxu.aoa_factors(len(az_idx), 64, True)
    el_factors = mxu.aoa_factors(len(el_idx), 64, False)
    union_idx, az_pos, el_pos, _ = mxu.aoa_union_layout(az_idx, el_idx)
    chans = tuple(int(v) for v in union_idx)
    ch0_pos = int(np.searchsorted(union_idx, 0))
    edge_r = CFAR_PARAMS["num_train"][0] + CFAR_PARAMS["num_guard"][0]
    edge_d = CFAR_PARAMS["num_train"][1] + CFAR_PARAMS["num_guard"][1]
    interior = (edge_r, edge_d)
    range_res = cfg.range_res_m
    vel0, vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s

    def upto(stage):
        def single(raw_re, raw_im):
            R = mxu.range_dft_channels(
                mxu.C2(raw_re, raw_im), chans, rng_factors,
                num_rx=num_rx, cfgs_per_loop=cpl)
            if stage == "rangedft":
                return R.re
            rd0 = mxu.dft_apply(
                mxu.C2(R.re[ch0_pos], R.im[ch0_pos]), dop_factors, axis=-1)
            mag = mxu.cabs(rd0)
            if stage == "mag":
                return mag
            det = cfar_ops.os_2d_detect(mag, **CFAR_PARAMS)
            if stage == "cfar":
                return det.astype(jnp.float32)
            r_i, v_i, valid, count = masked.mask_to_indices_2d(
                det, max_dets, interior=interior)
            if stage == "compact":
                return r_i + v_i + count
            vals = mxu.rd_values_from_range_dft(
                mxu.C2(R.re, R.im), dop_factors, r_i, v_i,
                mode=aoa_precision)
            if stage == "aoavals":
                return vals.re
            prec = "highest" if aoa_precision == "exact" else None
            az = mxu.aoa_peak_angles(vals, az_pos, az_factors, angle_bins,
                                     precision=prec)
            el = mxu.aoa_peak_angles(vals, el_pos, el_factors, angle_bins,
                                     precision=prec)
            ranges = r_i.astype(jnp.float32) * range_res
            vels = vel0 + v_i.astype(jnp.float32) * vel_res
            pts = spherical_to_cartesian_flu(ranges, az, el, vels)
            pts = jnp.where(valid[:, None], pts, 0.0)
            return pts

        return jax.jit(jax.vmap(single))

    return upto


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--aoa-precision", default="fast")
    parser.add_argument("--stages", default=None,
                        help="comma list; default all")
    args = parser.parse_args()

    import jax

    from mmwave_radar_processing_jax.utils.platform import enable_compile_cache

    enable_compile_cache()

    cfg = _flagship_config()
    shape = (args.batch, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    sets = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        sets.append((
            jax.device_put(rng.standard_normal(shape).astype(np.float32)),
            jax.device_put(rng.standard_normal(shape).astype(np.float32)),
        ))


    upto = build_stage_fns(cfg, aoa_precision=args.aoa_precision)
    stages = (args.stages.split(",") if args.stages else
              ["rangedft", "mag", "cfar", "compact", "aoavals", "full"])
    rows = []
    for stage in stages:
        fn = upto(stage)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*sets[0]))
        warm = time.perf_counter() - t0
        best = None
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = None
            for i in range(args.iters):
                out = fn(*sets[i % 2])
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / args.iters * 1e3
            best = dt if best is None else min(best, dt)
        rows.append({"stage": stage, "ms_per_dispatch": round(best, 3),
                     "warm_s": round(warm, 1)})
        print(json.dumps(rows[-1]), flush=True)

    print(json.dumps({"table": rows, "batch": args.batch,
                      "aoa_precision": args.aoa_precision}))


if __name__ == "__main__":
    main()
