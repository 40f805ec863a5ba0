"""Fused ground-gated point-cloud pipeline (the RadVel headline detector).

The reference's headline analysis flow detects with
``RangeDopplerGroundDetector``: a stateful altimeter tracks the ground range,
gates the RD rows to ``[altitude, altitude/cos 60deg]``, and a 1D OS-CFAR runs
along each gated Doppler row (``range_doppler_ground_detector.py:72-121``).

This module runs that whole chain as one ``lax.scan`` over a recording —
altimeter state on device, every transform a split-complex matmul, the zoom
refinement using traced-band DTFT factors — emitting fixed-capacity point
clouds and the tracked altitude per frame.  Matches the object API
(``Altimeter`` + ``RangeDopplerGroundDetector`` + ``PointCloudGenerator``)
on identical inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import cfar as cfar_ops, masked, mxu
from mmwave_radar_processing_jax.ops import peaks as peaks_ops
from mmwave_radar_processing_jax.processors.point_cloud import (
    spherical_to_cartesian_flu,
)


class GroundPipelineOut(NamedTuple):
    points: jax.Array  # (T, K, 4)
    valid: jax.Array  # (T, K)
    count: jax.Array  # (T,)
    altitude: jax.Array  # (T,)
    final_altitude: jax.Array  # () carry for chunked processing


def build_ground_point_cloud_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    vel_cfar_params: Optional[dict] = None,
    min_altitude_m: float = 0.25,
    zoom_search_region_m: float = 0.2,
    altitude_search_limit_m: float = 0.4,
    range_bias: float = 0.0,
    precise_est_enabled: bool = True,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    aoa_precision: str = "fast",
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    reformat_input: bool = True,
    stop_after: str = None,
):
    """Compile ``(raw_re[T,...], raw_im[T,...]) -> GroundPipelineOut``.

    ``stop_after="altitude"`` returns just the scanned altitude track (the
    sequential recursion), for on-device stage bisection of scan vs the
    vmapped detection behind it.
    """
    vel_cfar_params = vel_cfar_params or dict(
        num_train=12, num_guard=4, rho=0.5, alpha=15.0
    )
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    az_idx = np.asarray(az_antenna_idxs, int)
    el_idx = np.asarray(el_antenna_idxs, int)
    union_idx, az_pos, el_pos, _ = mxu.aoa_union_layout(az_idx, el_idx)
    if union_idx.size and 0 in union_idx:
        chans = tuple(int(v) for v in union_idx)
        ch0_pos, aoa_start = int(np.searchsorted(union_idx, 0)), 0
    else:
        chans = (0,) + tuple(int(v) for v in union_idx)
        ch0_pos, aoa_start = 0, 1
    # 1D CFAR edges along Doppler are False by construction -> the
    # compaction scans interior columns only (edge 16 of 70 per side here)
    edge_d = int(vel_cfar_params["num_train"]) + int(vel_cfar_params["num_guard"])
    interior = (0, edge_d) if loops - 2 * edge_d > 0 else None
    angle_bins = jnp.asarray(grids.angle_bins(num_angle_bins))
    plain_bins = jnp.asarray(grids.range_bins(cfg, variant="plain"))
    eps_bins = jnp.asarray(grids.range_bins(cfg, variant="eps"))
    range_res = cfg.range_res_m
    vel0, vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s
    max_plain = float(np.max(grids.range_bins(cfg, variant="plain")))

    rng_factors, dop_factors = mxu.range_doppler_factors(ns, loops)
    alt_rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    az_factors = mxu.aoa_factors(len(az_idx) or 1, num_angle_bins, shift_az_resp)
    el_factors = mxu.aoa_factors(len(el_idx) or 1, num_angle_bins, shift_el_resp)
    _aoa_prec = "highest" if aoa_precision == "exact" else None
    # altimeter zoom frequency mapping (reference range_resp.py:84-89)
    zoom_fs = 1.0 / cfg.range_res_m
    zoom_scale = zoom_fs / cfg.range_max_m

    def find_ground_peak(peak_ranges, peak_valid, current):
        ok = (
            peak_valid
            & (peak_ranges >= min_altitude_m)
            & (jnp.abs(peak_ranges - current) <= altitude_search_limit_m)
        )
        gp = jnp.min(jnp.where(ok, peak_ranges, jnp.inf))
        return jnp.where(jnp.isfinite(gp), gp, -1.0)

    def peak_candidates(chirp0: mxu.C2):
        """State-independent coarse altimeter precompute — batched OUTSIDE
        the scan.

        The coarse half of the altimeter recursion (mirroring
        ``Altimeter.step``) — range DFT + top-3 peak finding — does not
        depend on the tracked altitude, so it runs vmapped over the whole
        recording; the sequential ``lax.scan`` keeps only the eligibility
        gate / min-selection scalars and the ``lax.cond``-gated zoom refine
        (which must stay in-scan: its band depends on the selected
        candidate, and precomputing it for every candidate of every frame
        costs more in always-on in-graph cos/sin factor construction than
        the serialization it removes — measured 9.5 vs 6.8 ms on the
        altitude stage).

        ``chirp0``: ``(channels, ns)`` loop-0 chirp of every virtual
        channel, the only slice of the cube the altimeter reads.
        """
        spec = mxu.dft_apply(chirp0, alt_rng_factors, axis=1)
        coarse = jnp.mean(mxu.cabs(spec), axis=0)
        db = 20.0 * jnp.log10(coarse + 1e-12)
        idx, _, valid = peaks_ops.top_peaks_within_threshold(
            db, max_peaks=3, min_prominence=6.0, threshold_db=20.0
        )
        return jnp.where(valid, plain_bins[idx], 0.0), valid  # (3,)

    def alt_step(current, frame_in):
        """Scan body: selection scalars + the cond-gated zoom refine only."""
        cand, valid, chirp0_re, chirp0_im = frame_in
        chirp0 = mxu.C2(chirp0_re, chirp0_im)
        gp = find_ground_peak(cand, valid, current)

        def refine(gp_val):
            lo = jnp.maximum(1e-6, gp_val - zoom_search_region_m)
            hi = jnp.minimum(max_plain - 1e-6, gp_val + zoom_search_region_m)
            factors = mxu.zoom_dft_factors_dynamic(
                lo * zoom_scale, hi * zoom_scale, n=ns, m=ns, fs=zoom_fs,
                window=np.hanning(ns),
            )
            zspec = mxu.dft_apply(chirp0, factors, axis=1)
            zmag = jnp.mean(mxu.cabs(zspec), axis=0)
            zdb = 20.0 * jnp.log10(zmag + 1e-12)
            zidx, _, zvalid = peaks_ops.top_peaks_within_threshold(
                zdb, max_peaks=2, min_prominence=6.0, threshold_db=20.0
            )
            zbins = lo + zidx.astype(jnp.float32) * (hi - lo) / (ns - 1)
            refined = find_ground_peak(
                jnp.where(zvalid, zbins, 0.0), zvalid, current
            )
            return jnp.where(refined > 0, refined, current)

        if precise_est_enabled:
            new_alt = jax.lax.cond(gp >= 0, refine, lambda _: current, gp)
        else:
            new_alt = jnp.where(gp >= 0, gp, current)
        return new_alt, new_alt + range_bias

    def detect_frame(raw_re, raw_im, corrected):
        """Stateless per-frame detection, batched across the recording.

        The recording-long ``lax.scan`` used to carry this whole body, which
        serialized the heavy per-frame work behind the (tiny) altimeter
        recursion; only the altitude track is actually sequential, so the
        scan now emits ``corrected[T]`` and this runs under ``vmap``.
        """
        if reformat_input:
            # reformat folded into the range DFT; one shared R feeds the
            # CFAR map and the per-detection AoA values (see
            # parallel/pipeline.py dataflow notes — same round-3 rework)
            R = mxu.range_dft_channels(
                mxu.C2(raw_re, raw_im), chans, rng_factors,
                num_rx=num_rx, cfgs_per_loop=cpl,
            )
        else:
            sel = mxu.C2(raw_re[jnp.asarray(chans)],
                         raw_im[jnp.asarray(chans)])
            R = mxu.dft_apply(sel, rng_factors, axis=-2)

        # CFAR on antenna 0 only; the other channels' RD responses are never
        # materialized — per-detection values come from one-hot contractions
        # of the shared R
        rd0 = mxu.dft_apply(
            mxu.C2(R.re[ch0_pos], R.im[ch0_pos]), dop_factors, axis=-1
        )
        mag = mxu.cabs(rd0)

        # altitude range gate (reference :89-103, nearest-bin inclusive)
        min_idx = jnp.argmin(jnp.abs(eps_bins - corrected))
        max_rng = jnp.minimum(jnp.max(eps_bins),
                              corrected / jnp.cos(jnp.deg2rad(60.0)))
        max_idx = jnp.argmin(jnp.abs(eps_bins - max_rng))
        rows = jnp.arange(eps_bins.shape[0])
        row_gate = (rows >= min_idx) & (rows <= max_idx)

        vel_det = cfar_ops.os_1d_detect(
            mag,
            num_train=int(vel_cfar_params["num_train"]),
            num_guard=int(vel_cfar_params["num_guard"]),
            rho=float(vel_cfar_params["rho"]),
            alpha=float(vel_cfar_params["alpha"]),
        )
        det_mask = row_gate[:, None] & vel_det
        r_i, v_i, valid, count = masked.mask_to_indices_2d(
            det_mask, max_dets, interior=interior
        )

        if union_idx.size:
            sub = mxu.C2(R.re[aoa_start:], R.im[aoa_start:])
            vals = mxu.rd_values_from_range_dft(sub, dop_factors, r_i, v_i,
                                                mode=aoa_precision)

        az = (mxu.aoa_peak_angles(vals, az_pos, az_factors, angle_bins,
                                precision=_aoa_prec)
              if az_idx.size else jnp.zeros(r_i.shape, jnp.float32))
        el = (mxu.aoa_peak_angles(vals, el_pos, el_factors, angle_bins,
                                precision=_aoa_prec)
              if el_idx.size else jnp.zeros(r_i.shape, jnp.float32))
        ranges = r_i.astype(jnp.float32) * range_res
        vels = vel0 + v_i.astype(jnp.float32) * vel_res
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        pts = jnp.where(valid[:, None], pts, 0.0)
        return pts, valid, count

    def pipeline(raw_re, raw_im, init_altitude=None):
        init = (
            jnp.asarray(min_altitude_m, jnp.float32)
            if init_altitude is None
            else jnp.asarray(init_altitude, jnp.float32)
        )
        # loop-0 chirp of every virtual channel: chirp0[v = cfg*rx_n + r]
        # = raw[r, :, cfg]  (TDM order; see virtual_array.reformat)
        if reformat_input:
            re0 = jnp.moveaxis(raw_re[..., :num_rx, :, :cpl], -1, -3)
            im0 = jnp.moveaxis(raw_im[..., :num_rx, :, :cpl], -1, -3)
            re0 = re0.reshape(raw_re.shape[0], cpl * num_rx, ns)
            im0 = im0.reshape(raw_im.shape[0], cpl * num_rx, ns)
        else:
            re0, im0 = raw_re[..., 0], raw_im[..., 0]
        cand, valid = jax.vmap(lambda r, i: peak_candidates(mxu.C2(r, i)))(
            re0, im0)
        final, alts = jax.lax.scan(alt_step, init, (cand, valid, re0, im0))
        if stop_after == "altitude":
            return alts, final
        pts, valid, count = jax.vmap(detect_frame)(raw_re, raw_im, alts)
        return GroundPipelineOut(pts, valid, count, alts, final)

    return jax.jit(pipeline)
