"""North-star dataflow A/B: union vs rawd x precision modes (GPU).

Each variant: 3 repetitions of 60 calls ended in ``block_until_ready``;
the best repetition's ms/call is printed.
"""

import json, os, sys, time
import numpy as np
_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))); sys.path.insert(0, _HERE)
from bench import AZ_IDXS, EL_IDXS, CFAR_PARAMS, _flagship_config
import jax
from mmwave_radar_processing_jax.utils.platform import enable_compile_cache
enable_compile_cache()
from mmwave_radar_processing_jax.parallel.pipeline import build_point_cloud_pipeline
cfg = _flagship_config()
B = 1024
shape = (B, cfg.num_rx_antennas, cfg.num_adc_samples, cfg.chirps_per_frame)
sets = []
for seed in (0, 1):
    rng = np.random.default_rng(seed)
    sets.append((jax.device_put(rng.standard_normal(shape).astype(np.float32)),
                 jax.device_put(rng.standard_normal(shape).astype(np.float32))))
kw = dict(az_antenna_idxs=AZ_IDXS, el_antenna_idxs=EL_IDXS,
          cfar_params=CFAR_PARAMS, max_dets=128, backend="mxu")
variants = [("union_fast", dict(dataflow="union")),
            ("rawd_fast", dict(dataflow="rawd")),
            ("rawd_exact", dict(dataflow="rawd", aoa_precision="exact")),
            ("rawd_f32", dict(dataflow="rawd", aoa_precision="f32"))]
for name, extra in variants:
    fn = build_point_cloud_pipeline(cfg, **kw, **extra)
    t0 = time.perf_counter(); jax.block_until_ready(fn(*sets[0])); warm = time.perf_counter()-t0
    best = None
    for _ in range(3):
        t0 = time.perf_counter(); out = None
        for i in range(60): out = fn(*sets[i % 2])
        jax.block_until_ready(out)
        dt = (time.perf_counter()-t0)/60*1e3
        best = dt if best is None else min(best, dt)
    print(json.dumps({"variant": name, "ms": round(best,3),
                      "frames_per_s": round(B/best*1e3,1), "warm_s": round(warm,1)}), flush=True)
