"""Combined serving pipeline: point clouds + ego-velocity in one dispatch.

The point-cloud and velocity pipelines share their front half — virtual-array
reformat and the Hann-windowed range DFT — so serving both products per frame
costs one reformat + one range transform instead of two.  One jitted program
maps a frame batch to ``(PointCloudBatch, VelocityBatch)``; this is the
configuration ``scripts/process_recording.py`` uses.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import cfar as cfar_ops, masked, mxu
from mmwave_radar_processing_jax.parallel.pipeline import PointCloudBatch
from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
    VelocityBatch,
    build_velocity_pipeline,
)
from mmwave_radar_processing_jax.processors.point_cloud import (
    spherical_to_cartesian_flu,
)


def build_full_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    cfar_params: Optional[dict] = None,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    aoa_precision: str = "fast",
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    velocity_kwargs: Optional[dict] = None,
):
    """Compile ``(raw_re, raw_im, altitude[B]) -> (PointCloudBatch, VelocityBatch)``.

    The velocity half reuses
    :func:`~mmwave_radar_processing_jax.parallel.velocity_pipeline.build_velocity_pipeline`
    semantics (ODS ADC path); the point-cloud half matches
    ``build_point_cloud_pipeline(backend="mxu")``.  XLA CSEs the shared
    reformat/range-DFT subgraphs; a fully hand-shared variant is not needed.
    """
    cfar_params = cfar_params or dict(
        num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0
    )
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    az_idx = np.asarray(az_antenna_idxs, int)
    el_idx = np.asarray(el_antenna_idxs, int)
    angle_bins = jnp.asarray(grids.angle_bins(num_angle_bins))
    rng_factors, dop_factors = mxu.range_doppler_factors(ns, loops)
    az_factors = mxu.aoa_factors(len(az_idx) or 1, num_angle_bins, shift_az_resp)
    el_factors = mxu.aoa_factors(len(el_idx) or 1, num_angle_bins, shift_el_resp)
    _aoa_prec = "highest" if aoa_precision == "exact" else None
    range_res = cfg.range_res_m
    vel0, vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s

    vel_fn_single = build_velocity_pipeline(cfg, **(velocity_kwargs or {}))

    union_idx, az_pos, el_pos, _ = mxu.aoa_union_layout(az_idx, el_idx)
    if union_idx.size and 0 in union_idx:
        chans = tuple(int(v) for v in union_idx)
        ch0_pos, aoa_start = int(np.searchsorted(union_idx, 0)), 0
    else:
        chans = (0,) + tuple(int(v) for v in union_idx)
        ch0_pos, aoa_start = 0, 1
    edge_r = cfar_params["num_train"][0] + cfar_params["num_guard"][0]
    edge_d = cfar_params["num_train"][1] + cfar_params["num_guard"][1]
    interior = ((edge_r, edge_d)
                if ns - 2 * edge_r > 0 and loops - 2 * edge_d > 0 else None)

    def point_cloud_frame(raw_re, raw_im):
        # reformat folded into the range DFT; one shared R feeds the CFAR
        # map and the per-detection AoA values (see
        # parallel/pipeline.py dataflow notes — same round-3 rework)
        R = mxu.range_dft_channels(
            mxu.C2(raw_re, raw_im), chans, rng_factors,
            num_rx=num_rx, cfgs_per_loop=cpl,
        )
        rd0 = mxu.dft_apply(
            mxu.C2(R.re[ch0_pos], R.im[ch0_pos]), dop_factors, axis=-1
        )
        mag = mxu.cabs(rd0)
        det = cfar_ops.os_2d_detect(mag, **cfar_params)
        r_i, v_i, valid, count = masked.mask_to_indices_2d(
            det, max_dets, interior=interior
        )
        if union_idx.size:
            sub = mxu.C2(R.re[aoa_start:], R.im[aoa_start:])
            vals = mxu.rd_values_from_range_dft(sub, dop_factors, r_i, v_i,
                                                mode=aoa_precision)
        az = (
            mxu.aoa_peak_angles(vals, az_pos, az_factors, angle_bins,
                                precision=_aoa_prec)
            if az_idx.size else jnp.zeros(r_i.shape, jnp.float32)
        )
        el = (
            mxu.aoa_peak_angles(vals, el_pos, el_factors, angle_bins,
                                precision=_aoa_prec)
            if el_idx.size else jnp.zeros(r_i.shape, jnp.float32)
        )
        ranges = r_i.astype(jnp.float32) * range_res
        vels = vel0 + v_i.astype(jnp.float32) * vel_res
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        return PointCloudBatch(jnp.where(valid[:, None], pts, 0.0), valid, count)

    def batch(raw_re, raw_im, altitude) -> Tuple[PointCloudBatch, VelocityBatch]:
        pc = jax.vmap(point_cloud_frame)(raw_re, raw_im)
        vel = vel_fn_single(raw_re, raw_im, altitude)
        return pc, vel

    return jax.jit(batch)
