"""A/B: range-DFT front-end formulations for the point-cloud pipeline.

The range-DFT union-cube stage reads the 433 MB batch-1024 input and does
16 GFLOP of matmul; the variants below differ only in how the virtual-array
reformat and channel selection are laid out.  Variants:

- ``current``: ``mxu.range_dft_channels`` — reshape raw to
  ``(rx, ns, loops, cpl)``, stack 7 per-channel strided slices, einsum.
- ``tform``: ``T[rx] = E_w^T @ raw[rx]`` — one clean matmul over the sample
  axis per rx/plane, NO reshape/stack (computes all 12 virtual channels'
  range DFTs implicitly as strided columns of T).
- ``tform_slice``: tform + strided-slice extraction of the 7 union channels
  into the ``(A, W, L)`` cube the downstream stages expect.
- ``tform_rd0mag``: tform + ch0 Doppler map + magnitude (the "mag" stage
  equivalent), Doppler factors pre-expanded to the strided 210-chirp layout
  so no slice of T is materialized.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

from bench import AZ_IDXS, EL_IDXS, _flagship_config  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from mmwave_radar_processing_jax.ops import mxu
    from mmwave_radar_processing_jax.utils.platform import (
        enable_compile_cache,
    )

    enable_compile_cache()

    cfg = _flagship_config()
    ns, nloops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    union_idx, _, _, _ = mxu.aoa_union_layout(
        np.asarray(AZ_IDXS, int), np.asarray(EL_IDXS, int))
    chans = tuple(int(v) for v in union_idx)
    rng_factors, dop_factors = mxu.range_doppler_factors(ns, nloops)
    rc, rs = rng_factors
    dc, ds = dop_factors

    def current(raw_re, raw_im):
        R = mxu.range_dft_channels(
            mxu.C2(raw_re, raw_im), chans, rng_factors,
            num_rx=num_rx, cfgs_per_loop=cpl)
        return R.re

    def tform(raw_re, raw_im):
        t_re = (jnp.einsum("rsc,sw->rwc", raw_re, rc)
                + jnp.einsum("rsc,sw->rwc", raw_im, rs))
        t_im = (jnp.einsum("rsc,sw->rwc", raw_im, rc)
                - jnp.einsum("rsc,sw->rwc", raw_re, rs))
        return t_re + t_im  # keep both planes live

    def tform_slice(raw_re, raw_im):
        t_re = (jnp.einsum("rsc,sw->rwc", raw_re, rc)
                + jnp.einsum("rsc,sw->rwc", raw_im, rs))
        t_im = (jnp.einsum("rsc,sw->rwc", raw_im, rc)
                - jnp.einsum("rsc,sw->rwc", raw_re, rs))
        sel_re = jnp.stack([t_re[v % num_rx, :, v // num_rx::cpl]
                            for v in chans])
        sel_im = jnp.stack([t_im[v % num_rx, :, v // num_rx::cpl]
                            for v in chans])
        return sel_re + sel_im

    # Doppler factors in raw-chirp (210) layout for cfg 0 (channel 0 =
    # rx 0, cfg 0) — the tested library helper, not a local copy
    d0c, d0s = mxu.doppler_factors_strided(dop_factors, 0, cpl)

    def tform_rd0mag(raw_re, raw_im):
        t_re = (jnp.einsum("sc,sw->wc", raw_re[0], rc)
                + jnp.einsum("sc,sw->wc", raw_im[0], rs))
        t_im = (jnp.einsum("sc,sw->wc", raw_im[0], rc)
                - jnp.einsum("sc,sw->wc", raw_re[0], rs))
        rd_re = t_re @ d0c + t_im @ d0s
        rd_im = t_im @ d0c - t_re @ d0s
        return jnp.sqrt(rd_re * rd_re + rd_im * rd_im)

    def current_rd0mag(raw_re, raw_im):
        R = mxu.range_dft_channels(
            mxu.C2(raw_re, raw_im), chans, rng_factors,
            num_rx=num_rx, cfgs_per_loop=cpl)
        ch0 = int(np.searchsorted(union_idx, 0))
        rd0 = mxu.dft_apply(mxu.C2(R.re[ch0], R.im[ch0]), dop_factors,
                            axis=-1)
        return mxu.cabs(rd0)

    shape = (args.batch, cfg.num_rx_antennas, ns, cfg.chirps_per_frame)
    sets = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        sets.append((
            jax.device_put(rng.standard_normal(shape).astype(np.float32)),
            jax.device_put(rng.standard_normal(shape).astype(np.float32)),
        ))

    variants = [("current", current), ("tform", tform),
                ("tform_slice", tform_slice),
                ("current_rd0mag", current_rd0mag),
                ("tform_rd0mag", tform_rd0mag)]
    for name, single in variants:
        fn = jax.jit(jax.vmap(single))
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
        print(json.dumps({"variant": name, "ms_per_dispatch": round(best, 3),
                          "warm_s": round(warm, 1)}), flush=True)


if __name__ == "__main__":
    main()
