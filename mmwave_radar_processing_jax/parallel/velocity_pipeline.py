"""Fused device-resident ego-velocity pipeline (the RadVel headline).

One jitted program per frame batch: raw ADC cubes + altitudes in, gated
``[az_vy, el_vy, vx]`` velocity estimates (+ quality stats) out.  Mirrors the
ODS ADC path of :class:`~mmwave_radar_processing_jax.processors.velocity_estimator.VelocityEstimator`
(coarse responses) with every stage split-complex (DFT matmuls, no
complex dtypes, no host syncs):

1. virtual-array reformat folded into the range DFT (no cube copy);
2. range DFT with the Hann window folded in;
3. Doppler-azimuth responses for the two azimuth and two elevation antenna
   sub-arrays (chirp DFT + zero-padded angle DFT as matmuls), averaged, with
   the altitude-centered range window as a traced masked mean;
4. ``vx`` from the strongest zero-azimuth Doppler peak of each response;
5. per-row prominent peaks -> RANSAC ``vy`` fits (standard model for
   ``vx >= 0.1``, inverted small-vx model otherwise, via ``lax.cond``);
6. R^2 / inlier-fraction gates.

Validated against the object API on identical inputs (tests/test_mxu.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import mxu, peaks as peaks_ops
from mmwave_radar_processing_jax.ops.pallas import doppler_az
from mmwave_radar_processing_jax.ops.ransac import ransac_linear
from mmwave_radar_processing_jax.processors.velocity_estimator import (
    ODS_AZ_SETS_VIRTUAL,
    ODS_EL_SETS_VIRTUAL,
)
from mmwave_radar_processing_jax.utils.platform import kernel_route


class VelocityBatch(NamedTuple):
    velocity: jax.Array  # (B, 3) gated [az_vy, el_vy, vx]
    vx: jax.Array  # (B,) zero-azimuth readout
    az_r2: jax.Array  # (B,)
    el_r2: jax.Array  # (B,)
    az_inlier: jax.Array  # (B,)
    el_inlier: jax.Array  # (B,)


def build_velocity_pipeline(
    cfg: RadarConfig,
    *,
    lower_range_bound: float = 0.5,
    upper_range_bound: float = 0.5,
    num_angle_bins: int = 64,
    valid_angle_range: Sequence[float] = (np.deg2rad(-70), np.deg2rad(70)),
    peak_threshold_db: float = 30.0,
    min_r2_threshold: float = 0.6,
    min_inlier_percent: float = 0.75,
    enable_precise: bool = False,
    precise_vel_bound: float = 0.25,
    min_zoom_fft_vel_span: float = 0.1,
    seed: int = 42,
    response_backend: str | None = None,
    stop_after: str = None,
):
    """Compile ``(raw_re, raw_im, altitude[B]) -> VelocityBatch``.

    ``enable_precise=True`` adds the reference's zoom-FFT refinement
    (``velocity_estimator.py:831-847``): responses are recomputed on a
    two-half-band zoomed velocity grid centered at ``-vx`` (traced band edges
    into in-graph DTFT factors — one compilation for any center), ``vx`` is
    re-read from the zoomed zero-azimuth column, and the vy fits use the
    zoomed rows with their validity mask.

    ``response_backend``: how the Doppler-azimuth response stage computes —
    ``"xla"`` (broadcast multiply-adds that XLA fuses), ``"triton"`` (the
    fused Pallas kernel, :mod:`ops.pallas.doppler_az`), ``"interpret"``
    (that kernel in the Pallas interpreter, for tests on the CPU), or
    ``None``: :func:`utils.platform.kernel_route` picks from the platform.

    ``stop_after``: debug/profiling knob — return the stage's raw outputs
    instead of running the full pipeline (``"responses"``: the averaged
    az/el Doppler-azimuth responses; ``"vx"``: the zero-azimuth readout;
    ``"peaks"``: the per-row peak angles/velocities/found masks).  Used for
    on-device stage bisection (dead code below the cut is eliminated by XLA,
    so each cut measures the true prefix cost).
    """
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    # static width of the altitude range window (bins), +2 for inclusive ends
    win_rows = min(
        ns,
        int(np.ceil((lower_range_bound + upper_range_bound) / cfg.range_res_m))
        + 2,
    )

    range_bins = jnp.asarray(grids.range_bins(cfg, variant="eps"))
    vel_bins = jnp.asarray(grids.vel_bins(cfg))
    angle_bins = grids.angle_bins(num_angle_bins)
    var = np.asarray(valid_angle_range, float)
    valid_mask = (angle_bins >= var[0]) & (angle_bins <= var[1])
    valid_cols = np.flatnonzero(valid_mask)
    valid_angle_bins = jnp.asarray(angle_bins[valid_mask])
    zero_az_col = int(np.argmin(np.abs(angle_bins[valid_mask])))

    # static DFT factors: Hann-windowed range + chirp transforms, angle pad
    chirp_factors = mxu.dft_factors(loops, window=np.hanning(loops), shift=True)
    az_angle_factors = mxu.aoa_factors(4, num_angle_bins, shift=True)
    el_angle_factors = mxu.aoa_factors(4, num_angle_bins, shift=False)

    az_sets = tuple(np.asarray(s, int) for s in ODS_AZ_SETS_VIRTUAL)
    el_sets = tuple(np.asarray(s, int) for s in ODS_EL_SETS_VIRTUAL)
    base_key = jax.random.PRNGKey(seed)

    # All four sub-array responses ride ONE stacked contraction chain instead
    # of four separate materialize-and-reduce passes: the antenna-set
    # axis is a leading batch dim, the valid-angle column subset is baked into
    # the angle factor constants (so only Av of 64 angle bins are ever
    # computed), and the magnitude + masked range-mean fuse into a single
    # pass over the one [set, W, vel, angle] spectrum.
    set_idx = np.stack([az_sets[0], az_sets[1], el_sets[0], el_sets[1]])  # (4,4)
    ang_c = jnp.stack(
        [az_angle_factors[0][:, valid_cols], az_angle_factors[0][:, valid_cols],
         el_angle_factors[0][:, valid_cols], el_angle_factors[0][:, valid_cols]]
    )  # [4 sets, rx, Av]
    ang_s = jnp.stack(
        [az_angle_factors[1][:, valid_cols], az_angle_factors[1][:, valid_cols],
         el_angle_factors[1][:, valid_cols], el_angle_factors[1][:, valid_cols]]
    )

    def chirp_apply(rng_w: mxu.C2, cc, ss) -> mxu.C2:
        """Chirp (velocity) DFT over all 12 channels at once: [12, W, nv']."""
        re = (jnp.einsum("cwl,lv->cwv", rng_w.re, cc)
              + jnp.einsum("cwl,lv->cwv", rng_w.im, ss))
        im = (jnp.einsum("cwl,lv->cwv", rng_w.im, cc)
              - jnp.einsum("cwl,lv->cwv", rng_w.re, ss))
        return mxu.C2(re, im)

    if response_backend is None:
        response_backend = kernel_route()
    if response_backend not in ("xla", "triton", "interpret"):
        raise ValueError(f"unknown response_backend {response_backend!r}")
    n_virt = cpl * num_rx
    set_idx_t = tuple(tuple(int(v) for v in row) for row in set_idx)
    # kernel factor layout: row s*4+r = (set, antenna)
    fct = ang_c.reshape(-1, ang_c.shape[-1])
    fst = ang_s.reshape(-1, ang_s.shape[-1])

    def set_responses(chv: mxu.C2, rmask, row_scale=None):
        """(az_resp, el_resp) [nv', Av] from the chirp-DFT'd window [12, W, nv']."""
        if response_backend == "xla":
            # the K=4 angle contraction as four broadcast multiply-adds, so
            # XLA fuses contraction, magnitude and the range-row reduction
            # into one pass that never writes the [set, W, vel, angle]
            # spectrum out
            u_re, u_im = chv.re[set_idx], chv.im[set_idx]  # [4, rx, W, nv']
            sp_re = sp_im = 0.0
            for r in range(u_re.shape[1]):
                ur, ui = u_re[:, r, :, :, None], u_im[:, r, :, :, None]
                c = ang_c[:, r, None, None, :]
                s = ang_s[:, r, None, None, :]
                sp_re = sp_re + ur * c + ui * s
                sp_im = sp_im + ui * c - ur * s
            mag = jnp.sqrt(sp_re * sp_re + sp_im * sp_im)  # [4, W, nv', Av]
            resp = jnp.sum(mag * rmask[None, :, None, None], axis=1) \
                / jnp.maximum(jnp.sum(rmask), 1.0)
        else:
            wgt = rmask / jnp.maximum(jnp.sum(rmask), 1.0)
            resp = doppler_az.set_responses(
                chv.re, chv.im, wgt, fct, fst, set_idx=set_idx_t,
                interpret=response_backend == "interpret")  # [4, nv', Av]
        if row_scale is not None:
            resp = resp * row_scale[None, :, None]
        return 0.5 * (resp[0] + resp[1]), 0.5 * (resp[2] + resp[3])

    vmax = cfg.vel_max_m_s
    vel_fs = 1.0 / cfg.vel_res_m_s
    vel_scale = vel_fs / vmax
    nv = loops

    def zero_az_vel(resp, bins, row_valid=None):
        db = 20.0 * jnp.log10(resp + 1e-12)
        db = jnp.maximum(db, jnp.max(db) - peak_threshold_db)
        col = db[:, zero_az_col]
        mask = peaks_ops.local_maxima(col)
        if row_valid is not None:
            mask = mask & row_valid
        best = jnp.argmax(jnp.where(mask, col, -jnp.inf))
        return jnp.where(jnp.any(mask), bins[best], 0.0), jnp.any(mask)

    def row_peaks(resp, bins, row_valid=None):
        db = 20.0 * jnp.log10(resp + 1e-12)
        db = jnp.maximum(db, jnp.max(db) - peak_threshold_db)

        # candidate-restricted prominences: bit-compatible with the dense
        # local_maxima+prominences+argmax composition at ~half the vector
        # ops (ops/peaks.best_prominent_peak)
        best_idx, found = jax.vmap(
            lambda row: peaks_ops.best_prominent_peak(row, 4.0))(db)
        if row_valid is not None:
            found = found & row_valid
        return valid_angle_bins[best_idx], bins, found

    def zoomed_grid(center_vel):
        """Clamped two-half-band zoomed velocity grid + per-side presence.

        Mirrors ``DopplerAzimuthProcessor`` clamping/min-spread/side layout
        (``doppler_azimuth_resp.py:164-246``) with traced values.
        """
        v0 = jnp.maximum(center_vel - precise_vel_bound, -vmax)
        v1 = jnp.minimum(center_vel + precise_vel_bound, vmax)
        spread = 2.0 * min_zoom_fft_vel_span
        need = (v1 - v0) < spread
        dist_hi = jnp.abs(v1 - vmax)
        dist_lo = jnp.abs(v0 + vmax)
        v1 = jnp.where(need & (dist_hi > dist_lo), v0 + spread, v1)
        v0 = jnp.where(need & (dist_lo > dist_hi), v1 - spread, v0)

        neg_stop = jnp.minimum(-1e-4, v1)
        neg_bins = v0 + (neg_stop - v0) * jnp.arange(nv) / nv
        neg_present = v0 <= 0
        pos_start = jnp.maximum(1e-4, v0)
        pos_bins = pos_start + (v1 - pos_start) * jnp.arange(nv) / nv
        pos_present = v1 > 0
        bins = jnp.concatenate([neg_bins, pos_bins])
        neg_ok = neg_present & (
            jnp.abs(jnp.max(neg_bins) - jnp.min(neg_bins)) > min_zoom_fft_vel_span
        )
        pos_ok = pos_present & (
            jnp.abs(jnp.max(pos_bins) - jnp.min(pos_bins)) > min_zoom_fft_vel_span
        )
        row_valid = jnp.concatenate(
            [jnp.broadcast_to(neg_ok, (nv,)), jnp.broadcast_to(pos_ok, (nv,))]
        )
        return bins, row_valid, (neg_bins, neg_ok), (pos_bins, pos_ok)

    def precise_responses(rng_w: mxu.C2, rmask, grid):
        """All four zoomed responses [2*nv, Av] via one stacked chain.

        The two traced zoom half-bands concatenate on the velocity *factor*
        axis (columns of the chirp DFT matrix), so one ``chirp_apply`` +
        ``set_responses`` pass covers both halves of all four sub-arrays;
        an absent half zeroes its response rows — identical to the old
        per-half ``jnp.where(ok, mag, 0)`` since the masked range-mean is
        linear.
        """
        _, _, (neg_bins, neg_ok), (pos_bins, pos_ok) = grid

        def half_factors(lo, hi):
            # historical quirk: ZoomFFT built with fs*2 (ref :153-154);
            # the chirp Hann window folds into the zoom matrix
            return mxu.zoom_dft_factors_dynamic(
                lo * vel_scale, hi * vel_scale, n=nv, m=nv, fs=vel_fs * 2.0,
                window=np.hanning(nv),
            )

        ncc, nss = half_factors(jnp.min(neg_bins) + 2 * vmax,
                                jnp.max(neg_bins) + 2 * vmax)
        pcc, pss = half_factors(jnp.min(pos_bins), jnp.max(pos_bins))
        cc = jnp.concatenate([ncc, pcc], axis=1)
        ss = jnp.concatenate([nss, pss], axis=1)
        row_scale = jnp.concatenate(
            [jnp.broadcast_to(neg_ok.astype(jnp.float32), (nv,)),
             jnp.broadcast_to(pos_ok.astype(jnp.float32), (nv,))]
        )
        chv = chirp_apply(rng_w, cc, ss)
        return set_responses(chv, rmask, row_scale)

    def fit_vy(angles, vels, found, vx, key):
        """Standard / small-vx RANSAC vy fit (reference :346-506).

        The branch choice is data-dependent per frame, and under ``vmap`` a
        ``lax.cond`` lowers to a select that evaluates BOTH branches — i.e.
        4 RANSAC cores per frame for 2 fits (measured ~5.9 of a 23 ms
        batch-1024 dispatch).  The branches differ only in the (y, H,
        threshold) construction and a scalar post-transform, so ONE RANSAC
        runs on branch-selected inputs instead — elementwise identical to
        the cond on whichever branch is taken (same key stream, same trial
        samples).
        """
        use_std = vx >= 0.1
        y = jnp.where(use_std, -vels - vx * jnp.cos(angles), angles)
        h = jnp.where(use_std, jnp.sin(angles), vels - vx)[:, None]
        thr = jnp.where(use_std, 0.15, 0.20)
        res = ransac_linear(h, y, found, key, min_samples=10,
                            residual_threshold=thr, max_trials=20)
        a = res.coef[0]
        vy = jnp.where(
            use_std, a, jnp.where(res.ok & (a != 0.0), -1.0 / a, 0.0)
        )
        return vy, res.r2, res.inlier_fraction

    def frame_front(raw_re, raw_im, altitude):
        lo = jnp.maximum(0.0, altitude - lower_range_bound)
        hi = jnp.minimum(cfg.range_max_m, altitude + upper_range_bound)

        # Static-width range-window slice: only ~W of the ns range rows can
        # satisfy the altitude window, and every excluded row contributes an
        # exact zero to the masked mean — so the chirp/angle DFTs (the
        # dominant stage) run on W rows instead of all ns.  The slice folds into
        # the range DFT itself: selecting output rows == selecting factor
        # matrix columns, so only the W windowed range bins are ever computed
        # (FP-identical dot products to compute-then-slice).
        start = jnp.clip(
            jnp.sum(range_bins < lo).astype(jnp.int32), 0, ns - win_rows
        )
        # A per-frame dynamic_slice of the CONSTANT factor matrix would lower
        # to batched gathers under vmap.  The windowed columns are instead
        # built in-graph: the grid is affine
        # (bin = idx * res) and the DFT column is pure trig of
        # (s * w mod ns) — the modular reduction keeps every f32 angle in
        # [0, 2pi) where cos/sin are accurate (s*w < 2^24 is exact in f32).
        startf = start.astype(jnp.float32)
        j = jnp.arange(win_rows, dtype=jnp.float32)
        bins_w = (startf + j) * cfg.range_res_m
        rmask = ((bins_w >= lo) & (bins_w <= hi)).astype(jnp.float32)
        s_col = jnp.arange(ns, dtype=jnp.float32)[:, None]
        prod = s_col * (startf + j)[None, :]
        ang = (prod - ns * jnp.floor(prod / ns)) * (2.0 * np.pi / ns)
        win_col = jnp.asarray(np.hanning(ns), jnp.float32)[:, None]
        rc_w = jnp.cos(ang) * win_col
        rs_w = jnp.sin(ang) * win_col
        # virtual-array reformat folded into the windowed range DFT: the raw
        # cube reshapes to [rx, sample, loop, cfg] (virtual channel
        # v = cfg*num_rx + rx, processors/virtual_array.py:26-33) and the
        # einsum emits [12, W, chirp] directly — the full virtual cube is
        # never materialized
        r4_re = raw_re[:num_rx].reshape(num_rx, ns, loops, cpl)
        r4_im = raw_im[:num_rx].reshape(num_rx, ns, loops, cpl)
        rng_w = mxu.C2(
            (jnp.einsum("rslf,sw->frwl", r4_re, rc_w)
             + jnp.einsum("rslf,sw->frwl", r4_im, rs_w)).reshape(
                 n_virt, win_rows, loops),
            (jnp.einsum("rslf,sw->frwl", r4_im, rc_w)
             - jnp.einsum("rslf,sw->frwl", r4_re, rs_w)).reshape(
                 n_virt, win_rows, loops),
        )
        chv = chirp_apply(rng_w, *chirp_factors)  # [12, W, nv]
        return rng_w, rmask, chv

    def frame_back(rng_w, rmask, az_resp, el_resp, key):
        if stop_after == "responses":
            return az_resp, el_resp

        def vx_from(az_r, el_r, bins, row_valid=None):
            az_v, az_found = zero_az_vel(az_r, bins, row_valid)
            el_v, el_found = zero_az_vel(el_r, bins, row_valid)
            return jnp.where(
                az_found & el_found, -0.5 * (az_v + el_v),
                jnp.where(az_found, -az_v, jnp.where(el_found, -el_v, 0.0)),
            )

        vx = vx_from(az_resp, el_resp, vel_bins)
        if stop_after == "vx":
            return vx
        peak_bins, peak_row_valid = vel_bins, None

        if enable_precise:
            grid = zoomed_grid(-vx)
            az_resp, el_resp = precise_responses(rng_w, rmask, grid)
            zoom_bins, zoom_valid = grid[0], grid[1]
            vx = vx_from(az_resp, el_resp, zoom_bins, zoom_valid)
            peak_bins, peak_row_valid = zoom_bins, zoom_valid

        k1, k2 = jax.random.split(key)
        az_a, az_vl, az_f = row_peaks(az_resp, peak_bins, peak_row_valid)
        el_a, el_vl, el_f = row_peaks(el_resp, peak_bins, peak_row_valid)
        if stop_after == "peaks":
            return az_a, az_vl, az_f, el_a, el_f, vx
        az_vy, az_r2, az_in = fit_vy(az_a, az_vl, az_f, vx, k1)
        el_vy, el_r2, el_in = fit_vy(el_a, el_vl, el_f, vx, k2)

        gated_az = jnp.where(
            (az_r2 >= min_r2_threshold) & (az_in >= min_inlier_percent), az_vy, 0.0
        )
        gated_el = jnp.where(
            (el_r2 >= min_r2_threshold) & (el_in >= min_inlier_percent), el_vy, 0.0
        )
        velocity = jnp.stack([gated_az, gated_el, vx])
        return VelocityBatch(velocity, vx, az_r2, el_r2, az_in, el_in)

    def single_frame(raw_re, raw_im, altitude, key):
        rng_w, rmask, chv = frame_front(raw_re, raw_im, altitude)
        az_resp, el_resp = set_responses(chv, rmask)
        return frame_back(rng_w, rmask, az_resp, el_resp, key)

    def batch_fn(raw_re, raw_im, altitude):
        keys = jax.random.split(base_key, raw_re.shape[0])
        return jax.vmap(single_frame)(raw_re, raw_im, altitude, keys)

    return jax.jit(batch_fn)
