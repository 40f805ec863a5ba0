"""Velocity-pipeline stage bisection on the GPU.

Cumulative prefixes via the ``stop_after`` knob: responses / +vx / +peaks /
full; 3 repetitions of 60 calls ended in ``block_until_ready``.
"""

import json, os, sys, time
import numpy as np
_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))); sys.path.insert(0, _HERE)
from bench import _flagship_config
import jax
from mmwave_radar_processing_jax.utils.platform import enable_compile_cache
enable_compile_cache()
from mmwave_radar_processing_jax.parallel.velocity_pipeline import build_velocity_pipeline

cfg = _flagship_config()
B = 1024
shape = (B, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
sets = []
for seed in (0, 1):
    g = np.random.default_rng(seed)
    sets.append((jax.device_put(g.standard_normal(shape).astype(np.float32)),
                 jax.device_put(g.standard_normal(shape).astype(np.float32)),
                 jax.device_put(np.full(B, 1.2, np.float32))))
import sys as _s
stages = _s.argv[1].split(",") if len(_s.argv) > 1 else ["responses","vx","peaks",None]
for stop in stages:
    if stop == "None": stop = None
    fn = build_velocity_pipeline(cfg, stop_after=stop)
    t0 = time.perf_counter(); jax.block_until_ready(fn(*sets[0])); warm = time.perf_counter()-t0
    best = None
    for _ in range(3):
        t0 = time.perf_counter(); out = None
        for i in range(60): out = fn(*sets[i % 2])
        jax.block_until_ready(out)
        dt = (time.perf_counter()-t0)/60*1e3
        best = dt if best is None else min(best, dt)
    print(json.dumps({"stage": stop or "full", "ms": round(best,3),
                      "fps": round(B/best*1e3,1), "warm_s": round(warm,1)}), flush=True)
