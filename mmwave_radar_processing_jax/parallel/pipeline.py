"""Fused frame-batched radar pipeline: raw cubes -> point clouds.

This is the throughput path behind the north-star benchmark (radar frames/s
per chip for range-Doppler + CFAR + AoA): one jitted program that maps a
batch of raw TI ADC frames to fixed-capacity point clouds, vmapped over the
frame axis and sharded over the ``data`` mesh axis for multi-chip scaling.

The GUI/controller layers drive the same processors one frame at a time; this
module exists so offline/production workloads keep the device busy with
thousands of frames per dispatch instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import cfar as cfar_ops, masked
from mmwave_radar_processing_jax.processors.point_cloud import (
    spherical_to_cartesian_flu,
)
from mmwave_radar_processing_jax.processors.range_doppler import range_doppler_map
from mmwave_radar_processing_jax.processors.virtual_array import reformat


class PointCloudBatch(NamedTuple):
    points: jax.Array  # (B, K, 4)
    valid: jax.Array  # (B, K)
    count: jax.Array  # (B,)


def build_point_cloud_pipeline(
    cfg: RadarConfig,
    *,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    cfar_params: Optional[dict] = None,
    max_dets: int = 128,
    num_angle_bins: int = 64,
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    reformat_input: bool = True,
    backend: str = "mxu",
    aoa_precision: str = "fast",
    dataflow: str = "union",
):
    """Compile a ``[B, rx, ns, nc] -> PointCloudBatch`` pipeline function.

    Stages per frame: virtual-array reformat -> windowed RD FFT (all RX) ->
    OS-CFAR 2D -> per-detection AoA FFT -> cartesian conversion.  All constants
    (windows, bins, CFAR geometry, antenna subsets) are baked in at trace time.

    ``backend="mxu"`` (default) uses split-complex DFT-as-matmul kernels — no
    complex dtypes on device, every transform a matmul — and the returned
    function takes ``(raw_re, raw_im)`` float32 planes.  ``backend="xla"``
    uses complex FFT ops and takes one complex array.

    ``aoa_precision`` (on the GPU, a float32 matmul at the default precision
    runs in TF32, which keeps 10 of float32's 23 mantissa bits):

    - ``"fast"`` (default): every DFT and the per-detection one-hot value
      selection at the default precision, i.e. TF32.
    - ``"exact"``: range/Doppler DFTs still TF32, but per-detection values
      are selected with a hi/lo split (bf16 ``hi`` is exact in TF32, the
      ``lo`` remainder loses only its low bits) and the angle transform runs
      at ``Precision.HIGHEST`` — a near-float32 AoA argmax
      (``ops/mxu.rd_values_from_range_dft``).
    - ``"f32"``: the whole decision chain in full float32 — the DFTs that
      feed CFAR and AoA at ``Precision.HIGHEST`` (plain float32 on the GPU;
      ``HIGH`` would still be TF32 there), plus the ``"exact"`` selection.

    On the CPU all three compute in float32.
    """
    if backend == "mxu":
        return _build_pipeline_mxu(
            cfg,
            az_antenna_idxs=az_antenna_idxs,
            el_antenna_idxs=el_antenna_idxs,
            cfar_params=cfar_params,
            max_dets=max_dets,
            num_angle_bins=num_angle_bins,
            shift_az_resp=shift_az_resp,
            shift_el_resp=shift_el_resp,
            reformat_input=reformat_input,
            aoa_precision=aoa_precision,
            dataflow=dataflow,
        )
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    cfar_params = cfar_params or dict(
        num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0
    )
    range_bins = jnp.asarray(grids.range_bins(cfg, variant="eps"))
    vel_bins = jnp.asarray(grids.vel_bins(cfg))
    angle_bins = jnp.asarray(grids.angle_bins(num_angle_bins))
    az_idx = np.asarray(az_antenna_idxs, int)
    el_idx = np.asarray(el_antenna_idxs, int)
    num_rx = cfg.num_rx_antennas
    cpl = cfg.chirp_cfgs_per_loop

    def aoa(raw, idxs, r_i, v_i, shift):
        snap = raw[idxs][:, r_i, v_i].T  # (K, A)
        k = snap.shape[0]
        fft_in = (
            jnp.zeros((k, num_angle_bins), jnp.complex64)
            .at[:, : snap.shape[1]]
            .set(snap)
        )
        spec = jnp.fft.fft(fft_in, axis=1)
        if shift:
            spec = jnp.fft.fftshift(spec, axes=1)
        return angle_bins[jnp.argmax(jnp.abs(spec), axis=1)]

    def single_frame(raw_cube):
        if reformat_input:
            cube = reformat(raw_cube, num_rx=num_rx, cfgs_per_loop=cpl)
        else:
            cube = raw_cube
        rd = range_doppler_map(cube)
        mag = jnp.abs(rd[0])
        det = cfar_ops.os_2d_detect(mag, **cfar_params)
        r_i, v_i, valid, count = masked.mask_to_indices_2d(det, max_dets)
        az = (
            aoa(rd, az_idx, r_i, v_i, shift_az_resp)
            if az_idx.size
            else jnp.zeros(r_i.shape, jnp.float32)
        )
        el = (
            aoa(rd, el_idx, r_i, v_i, shift_el_resp)
            if el_idx.size
            else jnp.zeros(r_i.shape, jnp.float32)
        )
        pts = spherical_to_cartesian_flu(range_bins[r_i], az, el, vel_bins[v_i])
        pts = jnp.where(valid[:, None], pts, 0.0)
        return PointCloudBatch(pts, valid, count)

    return jax.jit(jax.vmap(single_frame))


def _build_pipeline_mxu(
    cfg: RadarConfig,
    *,
    az_antenna_idxs,
    el_antenna_idxs,
    cfar_params,
    max_dets,
    num_angle_bins,
    shift_az_resp,
    shift_el_resp,
    reformat_input,
    aoa_precision="fast",
    dataflow="union",
):
    """Split-complex pipeline: ``(raw_re, raw_im) -> PointCloudBatch``.

    Every spectral transform is a DFT matmul with windows/shifts folded into
    static constants (:mod:`mmwave_radar_processing_jax.ops.mxu`); CFAR and
    compaction are float-only sort/gather kernels.  Bin lookups exploit the
    affine grids (``bin = idx * res + offset``) instead of gathers.

    Dataflow: ONE shared range-DFT'd union cube ``R`` feeds both the CFAR magnitude map (channel
    0's Doppler DFT) and the per-detection AoA values — the virtual-array
    reformat folds into the range-DFT contraction
    (:func:`ops.mxu.range_dft_channels`, no channel-subset intermediate),
    the range-bin selection of the AoA values becomes a *real* one-hot
    contraction on ``R`` (:func:`ops.mxu.rd_values_from_range_dft`, half the
    matmul work of the bilinear form), and detection compaction scans only
    the CFAR interior (edges are False by construction).
    """
    from mmwave_radar_processing_jax.ops import mxu

    # validate the knobs BEFORE any dataflow branch: a typo'd value must
    # never silently run a different path (the same rule this round added to
    # capon_from_covariance / rd_values_from_raw)
    if dataflow not in ("union", "raw", "rawd"):
        raise ValueError(f"unknown dataflow {dataflow!r} "
                         "(expected 'union', 'raw' or 'rawd')")
    if dataflow != "union" and not reformat_input:
        raise ValueError(
            f"dataflow={dataflow!r} operates on the RAW cube and requires "
            "reformat_input=True (pre-reformatted input uses 'union')")
    if aoa_precision not in ("fast", "exact", "f32"):
        raise ValueError(f"unknown aoa_precision {aoa_precision!r}")
    cfar_params = cfar_params or dict(
        num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0
    )
    ns, nc_loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    az_idx = np.asarray(az_antenna_idxs, int)
    el_idx = np.asarray(el_antenna_idxs, int)
    angle_bins = jnp.asarray(grids.angle_bins(num_angle_bins))

    rng_factors, dop_factors = mxu.range_doppler_factors(ns, nc_loops)
    az_factors = mxu.aoa_factors(len(az_idx) or 1, num_angle_bins, shift_az_resp)
    el_factors = mxu.aoa_factors(len(el_idx) or 1, num_angle_bins, shift_el_resp)

    # affine bin grids (exact: the reference grids are arange-generated)
    range_res = cfg.range_res_m
    vel0, vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s

    # union of antenna subsets: per-detection RD values are evaluated once on
    # the shared range-DFT'd cube, then each subset's AoA FFT reads its
    # positions out of the union
    union_idx, az_pos, el_pos, _ = mxu.aoa_union_layout(az_idx, el_idx)
    if union_idx.size and 0 in union_idx:
        chans = tuple(int(v) for v in union_idx)
        ch0_pos, aoa_start = int(np.searchsorted(union_idx, 0)), 0
    else:
        chans = (0,) + tuple(int(v) for v in union_idx)
        ch0_pos, aoa_start = 0, 1
    # CFAR edge rows/cols are False by construction -> compact interior only
    edge_r = cfar_params["num_train"][0] + cfar_params["num_guard"][0]
    edge_d = cfar_params["num_train"][1] + cfar_params["num_guard"][1]
    interior = ((edge_r, edge_d)
                if ns - 2 * edge_r > 0 and nc_loops - 2 * edge_d > 0 else None)

    if dataflow == "rawd" and reformat_input:
        # Round-5 "Doppler-first" dataflow: the per-channel Doppler DFT runs
        # DIRECTLY on the raw cube with the chirp-cfg stride folded into the
        # static factor matrix (``rawD[ch] = raw[rx] @ Dstr_cfg`` — a natural
        # -layout matmul with a static dense RHS; the virtual-array reformat
        # happens implicitly, with NO reshape/stack relayout).  The CFAR map
        # is the range DFT of rawD[ch0]; per-detection AoA values select
        # Doppler columns of rawD with the one-hot (small (ns, K) results)
        # and contract the selected range-DFT factor rows elementwise.  Range
        # and Doppler DFTs commute (separable), so outputs match the union
        # dataflow to float tolerance.
        union_chans2 = tuple(int(v) for v in union_idx)
        # channel 0 always computes (the CFAR map lives there) even when the
        # AoA union doesn't contain it — the detection set must not depend
        # on which antennas do AoA (caught by the round-5 review: with
        # az=(3,4,7) the searchsorted ch0 silently pointed at channel 3)
        chans_rawd = tuple(sorted(set(union_chans2) | {0}))
        dstr = {c: mxu.doppler_factors_strided(dop_factors, c, cpl)
                for c in sorted({int(v) // num_rx for v in chans_rawd})}
        # per-rx STACKED factor matrices: all of an rx's (cfg, cos/sin)
        # Doppler blocks concatenate on the column axis, so the whole rawD
        # cube is ONE natural-layout matmul per rx/plane (8 total) instead of
        # 4 per channel (28) — the static blocks slice back out for free
        rx_cfgs = {}
        for v in chans_rawd:
            rx_cfgs.setdefault(int(v) % num_rx, []).append(int(v) // num_rx)
        rx_stack = {
            rx: jnp.asarray(np.concatenate(
                [np.concatenate([dstr[c][0], dstr[c][1]], axis=1)
                 for c in cfgs], axis=1))
            for rx, cfgs in rx_cfgs.items()
        }
        rc_np, rs_np = np.asarray(rng_factors[0]), np.asarray(rng_factors[1])
        if aoa_precision in ("exact", "f32"):
            rc_hi, rc_lo = mxu._static_hilo(rc_np)
            rs_hi, rs_lo = mxu._static_hilo(rs_np)
        dft_prec2 = (jax.lax.Precision.HIGHEST if aoa_precision == "f32"
                     else None)
        nv2 = nc_loops

        def single_frame(raw_re, raw_im):
            # rawD[ch] for every union channel via the stacked matmuls
            blocks = {}
            for rx, cfgs in rx_cfgs.items():
                ab = jnp.matmul(raw_re[rx], rx_stack[rx],
                                precision=dft_prec2)
                bb = jnp.matmul(raw_im[rx], rx_stack[rx],
                                precision=dft_prec2)
                for i, cfg in enumerate(cfgs):
                    a_c = ab[:, 2 * i * nv2:(2 * i + 1) * nv2]
                    a_s = ab[:, (2 * i + 1) * nv2:(2 * i + 2) * nv2]
                    b_c = bb[:, 2 * i * nv2:(2 * i + 1) * nv2]
                    b_s = bb[:, (2 * i + 1) * nv2:(2 * i + 2) * nv2]
                    blocks[cfg * num_rx + rx] = mxu.C2(a_c + b_s, b_c - a_s)
            # CFAR map: always from channel 0 (whether or not AoA uses it)
            rd0 = mxu.dft_apply(blocks[0], rng_factors,
                                axis=-2, precision=dft_prec2)
            mag = mxu.cabs(rd0)
            det = cfar_ops.os_2d_detect(mag, **cfar_params)
            r_i, v_i, valid, count = masked.mask_to_indices_2d(
                det, max_dets, interior=interior
            )
            oh_r = (r_i[None, :] == jnp.arange(ns)[:, None]).astype(
                jnp.float32)
            oh_v = (v_i[None, :] == jnp.arange(nc_loops)[:, None]).astype(
                jnp.float32)
            if union_chans2:
                rawd_s = mxu.C2(
                    jnp.stack([blocks[v].re for v in union_chans2]),
                    jnp.stack([blocks[v].im for v in union_chans2]),
                )  # (A, ns, nv)
                # the closing contraction feeds the AoA argmax: in
                # exact/f32 it must not re-truncate the carefully-split
                # operands (HIGHEST is cheap at (A, ns, K) sizes)
                vprec = (None if aoa_precision == "fast"
                         else jax.lax.Precision.HIGHEST)
                if aoa_precision == "fast":
                    f_c = rng_factors[0] @ oh_r
                    f_s = rng_factors[1] @ oh_r
                    q_re = jnp.einsum("asv,vk->ask", rawd_s.re, oh_v)
                    q_im = jnp.einsum("asv,vk->ask", rawd_s.im, oh_v)
                else:
                    f_c = rc_hi @ oh_r + rc_lo @ oh_r
                    f_s = rs_hi @ oh_r + rs_lo @ oh_r
                    # exact-in-f32 one-hot column selection (hi/lo split)
                    hi_re = rawd_s.re.astype(jnp.bfloat16).astype(
                        jnp.float32)
                    hi_im = rawd_s.im.astype(jnp.bfloat16).astype(
                        jnp.float32)
                    q_re = (jnp.einsum("asv,vk->ask", hi_re, oh_v)
                            + jnp.einsum("asv,vk->ask",
                                         rawd_s.re - hi_re, oh_v))
                    q_im = (jnp.einsum("asv,vk->ask", hi_im, oh_v)
                            + jnp.einsum("asv,vk->ask",
                                         rawd_s.im - hi_im, oh_v))
                vals = mxu.C2(
                    jnp.einsum("ask,sk->ak", q_re, f_c, precision=vprec)
                    + jnp.einsum("ask,sk->ak", q_im, f_s, precision=vprec),
                    jnp.einsum("ask,sk->ak", q_im, f_c, precision=vprec)
                    - jnp.einsum("ask,sk->ak", q_re, f_s, precision=vprec),
                )
            aoa_prec = None if aoa_precision == "fast" else "highest"
            az = (
                mxu.aoa_peak_angles(vals, az_pos, az_factors, angle_bins,
                                    precision=aoa_prec)
                if az_idx.size
                else jnp.zeros(r_i.shape, jnp.float32)
            )
            el = (
                mxu.aoa_peak_angles(vals, el_pos, el_factors, angle_bins,
                                    precision=aoa_prec)
                if el_idx.size
                else jnp.zeros(r_i.shape, jnp.float32)
            )
            ranges = r_i.astype(jnp.float32) * range_res
            vels = vel0 + v_i.astype(jnp.float32) * vel_res
            pts = spherical_to_cartesian_flu(ranges, az, el, vels)
            pts = jnp.where(valid[:, None], pts, 0.0)
            return PointCloudBatch(pts, valid, count)

        return jax.jit(jax.vmap(single_frame))

    if dataflow == "raw" and reformat_input:
        # Raw dataflow: every consumer contracts the RAW cube directly.
        # The union-cube path reshapes raw to (rx, ns, loops, cpl) and
        # stacks 7 strided channel slices before the range DFT; here the
        # CFAR map is
        # ``(E_w^T raw[0]) @ D0`` with the chirp-cfg stride folded into the
        # static Doppler factors, and per-detection AoA values contract raw
        # against one-hot-selected factor rows — no reformat reshape, no
        # union-cube intermediate, nothing but the raw read + small matmuls.
        dop0_strided = mxu.doppler_factors_strided(dop_factors, 0, cpl)
        union_chans = tuple(int(v) for v in union_idx)
        # "f32" runs the CFAR-map DFTs in full float32 too (the same rule as
        # the union branch's dft_prec)
        dft_prec_raw = (jax.lax.Precision.HIGHEST if aoa_precision == "f32"
                        else None)

        def single_frame(raw_re, raw_im):
            raw = mxu.C2(raw_re, raw_im)
            rd0 = mxu.rd0_map_from_raw(raw, 0, rng_factors, dop0_strided,
                                       precision=dft_prec_raw)
            mag = mxu.cabs(rd0)
            det = cfar_ops.os_2d_detect(mag, **cfar_params)
            r_i, v_i, valid, count = masked.mask_to_indices_2d(
                det, max_dets, interior=interior
            )
            if union_idx.size:
                vals = mxu.rd_values_from_raw(
                    raw, rng_factors, dop_factors, r_i, v_i,
                    channels=union_chans, num_rx=num_rx, cfgs_per_loop=cpl,
                    mode="fast" if aoa_precision == "fast" else "exact",
                )
            aoa_prec = None if aoa_precision == "fast" else "highest"
            az = (
                mxu.aoa_peak_angles(vals, az_pos, az_factors, angle_bins,
                                    precision=aoa_prec)
                if az_idx.size
                else jnp.zeros(r_i.shape, jnp.float32)
            )
            el = (
                mxu.aoa_peak_angles(vals, el_pos, el_factors, angle_bins,
                                    precision=aoa_prec)
                if el_idx.size
                else jnp.zeros(r_i.shape, jnp.float32)
            )
            ranges = r_i.astype(jnp.float32) * range_res
            vels = vel0 + v_i.astype(jnp.float32) * vel_res
            pts = spherical_to_cartesian_flu(ranges, az, el, vels)
            pts = jnp.where(valid[:, None], pts, 0.0)
            return PointCloudBatch(pts, valid, count)

        return jax.jit(jax.vmap(single_frame))

    # "f32": the WHOLE decision chain runs in float32 — range DFT and
    # Doppler map at Precision.HIGHEST (not TF32), exact hi/lo value
    # selection, float32 angle transform.  "exact" fixes only the selection,
    # so its CFAR map and selected values still carry TF32 error.
    dft_prec = jax.lax.Precision.HIGHEST if aoa_precision == "f32" else None
    sel_mode = "exact" if aoa_precision in ("exact", "f32") else "fast"

    def single_frame(raw_re, raw_im):
        if reformat_input:
            # reformat folded into the windowed range DFT: raw cube read
            # once by the contraction, no virtual-cube intermediate
            R = mxu.range_dft_channels(
                mxu.C2(raw_re, raw_im), chans, rng_factors,
                num_rx=num_rx, cfgs_per_loop=cpl, precision=dft_prec,
            )
        else:
            sel = mxu.C2(raw_re[jnp.asarray(chans)],
                         raw_im[jnp.asarray(chans)])
            R = mxu.dft_apply(sel, rng_factors, axis=-2, precision=dft_prec)
        # CFAR detects on antenna 0's magnitude map only; the other channels'
        # RD responses are never materialized — per-detection values come
        # from one-hot contractions of the shared R instead
        rd0 = mxu.dft_apply(
            mxu.C2(R.re[ch0_pos], R.im[ch0_pos]), dop_factors, axis=-1,
            precision=dft_prec,
        )
        mag = mxu.cabs(rd0)
        # detection-only counting CFAR: bit-exact vs the threshold path,
        # no rank selection on the hot path (ops/cfar.py os_2d_detect)
        det = cfar_ops.os_2d_detect(mag, **cfar_params)
        r_i, v_i, valid, count = masked.mask_to_indices_2d(
            det, max_dets, interior=interior
        )
        if union_idx.size:
            sub = mxu.C2(R.re[aoa_start:], R.im[aoa_start:])
            vals = mxu.rd_values_from_range_dft(sub, dop_factors, r_i, v_i,
                                                mode=sel_mode)
        aoa_prec = "highest" if aoa_precision in ("exact", "f32") else None
        az = (
            mxu.aoa_peak_angles(vals, az_pos, az_factors, angle_bins,
                                precision=aoa_prec)
            if az_idx.size
            else jnp.zeros(r_i.shape, jnp.float32)
        )
        el = (
            mxu.aoa_peak_angles(vals, el_pos, el_factors, angle_bins,
                                precision=aoa_prec)
            if el_idx.size
            else jnp.zeros(r_i.shape, jnp.float32)
        )
        ranges = r_i.astype(jnp.float32) * range_res
        vels = vel0 + v_i.astype(jnp.float32) * vel_res
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        pts = jnp.where(valid[:, None], pts, 0.0)
        return PointCloudBatch(pts, valid, count)

    return jax.jit(jax.vmap(single_frame))


def chunk_dispatch(pipeline_fn, num_chunks: int):
    """Amortize the fixed per-program dispatch cost over ``num_chunks`` batches.

    ONE program execution ``lax.scan``-s ``pipeline_fn`` over ``num_chunks``
    leading-axis chunks, so the compiled *step* (and its live working set)
    stays at the batch-1024 shape while any fixed per-execution cost divides
    by ``num_chunks``.

    Semantics: bit-identical to calling ``pipeline_fn`` on each chunk and
    concatenating (asserted in ``tests/test_parallel.py``).  The per-frame
    loop this replaces in the reference is
    ``/root/reference/mmwave_radar_processing/processors/point_cloud_generator.py:108-140``
    (one frame per Python call).

    Args:
        pipeline_fn: frame-batched function; every positional arg shares the
            leading batch axis.
        num_chunks: logical batches per program execution.  The wrapped
            function expects leading axes of ``num_chunks *`` the original
            chunk size.
    """
    if num_chunks <= 1:
        return pipeline_fn

    def wrapped(*args):
        def split(a):
            b = a.shape[0]
            if b % num_chunks:
                raise ValueError(
                    f"leading axis {b} not divisible by num_chunks={num_chunks}"
                )
            return a.reshape((num_chunks, b // num_chunks) + a.shape[1:])

        stacked = tuple(split(a) for a in args)

        def body(carry, xs):
            return carry, pipeline_fn(*xs)

        _, out = jax.lax.scan(body, None, stacked)
        return jax.tree.map(
            lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]), out
        )

    return jax.jit(wrapped)


def chunk_dispatch_unrolled(pipeline_fn, num_chunks: int):
    """Unrolled sibling of :func:`chunk_dispatch`: static slices, no scan.

    The scan form pays dynamic-slice/update machinery per step; here XLA sees
    ``num_chunks`` literal copies of the pipeline over static input slices
    and may schedule across them.  Compile time and code size grow ~K-fold.
    Same bit-identical contract.
    """
    if num_chunks <= 1:
        return pipeline_fn

    def wrapped(*args):
        b = args[0].shape[0]
        if b % num_chunks:
            raise ValueError(
                f"leading axis {b} not divisible by num_chunks={num_chunks}"
            )
        step = b // num_chunks
        outs = [
            pipeline_fn(*(a[i * step:(i + 1) * step] for a in args))
            for i in range(num_chunks)
        ]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)

    return jax.jit(wrapped)


def shard_pipeline(pipeline_fn, mesh: Mesh, axis: str = "data"):
    """Shard a frame-batched pipeline over ``axis`` of the mesh.

    Frames are embarrassingly parallel: the input batch is sharded on its
    leading axis, outputs stay sharded, and XLA inserts no cross-chip
    collectives on the hot path — scaling is bounded by the input feed.
    """
    in_sharding = NamedSharding(mesh, P(axis))
    out_sharding = NamedSharding(mesh, P(axis))

    def wrapped(*args):
        args = tuple(jax.lax.with_sharding_constraint(a, in_sharding) for a in args)
        out = pipeline_fn(*args)
        return jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, out_sharding), out
        )

    return jax.jit(wrapped)
