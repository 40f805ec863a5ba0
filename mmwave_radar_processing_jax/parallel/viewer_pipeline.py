"""Batched device pipeline producing the viewer's per-frame payload tensors.

The interactive controller fans a frame out to ~12 per-frame CPU processors
(``visualization/controller.py``), exactly like the reference
(``backends/mmwave_radar_processor_controller.py:200-245``).  This module
computes the same payload arrays for a WHOLE recording in a handful of
batched split-complex dispatches on the device, so
playback becomes precompute-then-scrub
(:mod:`mmwave_radar_processing_jax.visualization.precompute`).

Per-frame semantics mirror the registry processors exactly (same windows,
shifts, bin subsets — parity asserted in
``tests/test_visualization.py::test_precomputed_payload_parity``):

- ``rd_map``: Hann-windowed RD magnitude of virtual channel ``rx_idx``
  (``processors/range_doppler.range_doppler_map``; reference
  ``range_doppler_resp.py:95-103``).
- ``range_profile``: chirp-0 windowed range-FFT magnitude averaged over all
  virtual channels (``processors/range_resp.coarse_range_fft``; reference
  ``range_resp.py:32-57``).
- ``md_col``: UNwindowed RD magnitude of channel ``rx_idx``, max over the
  gated range rows — one micro-Doppler spectrogram column
  (``processors/micro_doppler.micro_doppler_column``; reference
  ``micro_doppler_resp.py:97-107``).
- ``da_map``: coarse Doppler-azimuth response, valid-angle columns, averaged
  over the range window (``processors/doppler_azimuth.coarse_doppler_azimuth``
  + ``process``; reference ``doppler_azimuth_resp.py:296-334,419-491``).
- ``det_*`` / ``pt_*``: 2D-CFAR detections on ``rd_map`` and the AoA point
  cloud (same formulation as ``parallel/pipeline._build_pipeline_mxu``).

Everything is split-complex (:mod:`ops.mxu`), like the other device
pipelines.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import cfar as cfar_ops, masked, mxu, windows
from mmwave_radar_processing_jax.processors.point_cloud import (
    spherical_to_cartesian_flu,
)


def build_viewer_payload_pipeline(
    cfg: RadarConfig,
    *,
    rx_idx: int = 0,
    num_angle_bins: int = 64,
    da_rx_antennas: Optional[Sequence[int]] = None,
    valid_angle_range: Sequence[float] = (np.deg2rad(-60), np.deg2rad(60)),
    md_target_ranges: Sequence[float] = (0.0, 1.0),
    cfar_type: str = "ca_cfar_2d",
    cfar_params: Optional[dict] = None,
    ra_num_angle_bins: int = 64,
    ra_rx_antennas: Optional[Sequence[int]] = None,
    cfar1d_type: str = "os_cfar_1d",
    cfar1d_params: Optional[dict] = None,
    max_dets_1d: int = 64,
    seq_rng_cfar: Optional[tuple] = None,
    seq_vel_cfar: Optional[tuple] = None,
    include: Optional[Sequence[str]] = None,
    az_antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    el_antenna_idxs: Sequence[int] = (9, 8, 5, 4),
    shift_az_resp: bool = True,
    shift_el_resp: bool = False,
    max_dets: int = 128,
):
    """Compile ``(raw_re, raw_im) [B, rx, ns, nc] -> dict`` of payload arrays.

    Output dict (all leading-axis ``B``): ``rd_map [ns, nloops]``,
    ``range_profile [ns]``, ``md_col [nloops]``, ``da_map [nloops, n_valid]``,
    ``ra_map [ns, ra_num_angle_bins]`` (range-azimuth chirp-0 heatmap,
    ``processors/range_angle.range_angle_map``; reference
    ``range_angle_resp.py:104-120``), 1D-CFAR profile detections
    ``det1d_idx/det1d_valid [max_dets_1d]`` + ``det1d_thr [ns]``
    (``processors/detection.RangeDetector``), 2D detections
    ``det_r/det_v/det_valid [max_dets]``, ``det_count []``,
    ``points [max_dets, 4]``, ``pt_valid [max_dets]``, ``pt_count []``.

    ``include``: output groups to compute (subset of
    ``{"md", "da", "ra", "det2d", "detseq", "det1d"}``; ``rd_map``/
    ``range_profile`` are always produced, ``points`` rides with ``det2d``;
    ``detseq`` is the sequential range->velocity detector group that
    ``visualization/precompute.py`` maps registry keys onto).  Default: all.
    """
    ns, nloops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    n_virtual = cfg.num_virtual_antennas
    all_chans = tuple(range(n_virtual))

    rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    rng_plain = mxu.dft_factors(ns)
    dop_factors = mxu.dft_factors(nloops, window=np.hanning(nloops), shift=True)
    dop_plain = mxu.dft_factors(nloops, shift=True)
    # coarse DA: zero-padded angle DFT over the (possibly Hann-windowed)
    # antenna axis — the antenna window applies only for the standard
    # geometry with virtual antennas (doppler_azimuth.py:201-204); an
    # ``rx_antennas`` subset selects channel rows before the transform
    # (doppler_azimuth.py:221-225)
    da_rx = (np.arange(n_virtual) if da_rx_antennas is None
             else np.asarray(da_rx_antennas, int))
    angle_window = (np.hanning(len(da_rx))
                    if (cfg.array_geometry == "standard"
                        and cfg.virtual_antennas_enabled) else None)
    angle_factors = mxu.dft_factors(
        len(da_rx), num_angle_bins, shift=True, window=angle_window)
    angle_bins = grids.angle_bins(num_angle_bins)
    var = np.asarray(valid_angle_range, float)
    valid_angle_cols = np.flatnonzero(
        (angle_bins >= var[0]) & (angle_bins <= var[1]))

    # micro-Doppler range gate on the eps range grid (micro_doppler.py:58-63)
    rb_eps = grids.range_bins(cfg, variant="eps")
    md_mask = jnp.asarray(
        (rb_eps >= md_target_ranges[0]) & (rb_eps <= md_target_ranges[1]))

    cfar_params = dict(cfar_params or dict(
        num_train=(5, 5), num_guard=(3, 2), pfa=1e-3))
    if cfar_type == "os_cfar_2d":
        def detect(mag):  # counting form, bit-exact vs the threshold path
            return cfar_ops.os_2d_detect(
                mag, num_train=tuple(cfar_params["num_train"]),
                num_guard=tuple(cfar_params["num_guard"]),
                rho=float(cfar_params["rho"]),
                alpha=float(cfar_params["alpha"]))
    elif cfar_type == "ca_cfar_2d":
        def detect(mag):
            thr = cfar_ops.ca_2d(
                mag, num_train=tuple(cfar_params["num_train"]),
                num_guard=tuple(cfar_params["num_guard"]),
                pfa=float(cfar_params["pfa"]))[0]
            return mag > thr
    else:
        raise ValueError(f"unknown 2D CFAR kind {cfar_type!r}")

    include = (frozenset(include) if include is not None
               else frozenset({"md", "da", "ra", "det2d", "det1d"}))

    # range-azimuth map: reference windows over the FULL antenna axis before
    # selecting rx_antennas (range_angle.py:74-83), so the per-channel Hann
    # weight is the full-axis window evaluated at each selected index
    ra_rx = (np.arange(n_virtual) if ra_rx_antennas is None
             else np.asarray(ra_rx_antennas, int))
    ra_chan_w = jnp.asarray(np.hanning(n_virtual)[ra_rx], jnp.float32)
    ra_angle_factors = mxu.dft_factors(len(ra_rx), ra_num_angle_bins,
                                       shift=True)

    from mmwave_radar_processing_jax.processors.detection import _threshold_1d

    cfar1d_params = dict(cfar1d_params or dict(
        num_train=5, num_guard=3, rho=0.5, alpha=2))
    threshold_1d = _threshold_1d(cfar1d_type, cfar1d_params)

    # sequential RD detector: row gate by a range-profile CFAR, then a
    # velocity CFAR along each gated row (detection.py:218-244)
    seq_rng_thr = _threshold_1d(*(seq_rng_cfar or (
        "os_cfar_1d", dict(num_train=5, num_guard=3, rho=0.6, alpha=2))))
    seq_vel_thr = _threshold_1d(*(seq_vel_cfar or (
        "os_cfar_1d", dict(num_train=5, num_guard=2, rho=0.7, alpha=3))))

    az_idx = np.asarray(az_antenna_idxs, int)
    el_idx = np.asarray(el_antenna_idxs, int)
    az_pos = np.searchsorted(np.arange(n_virtual), az_idx)
    el_pos = np.searchsorted(np.arange(n_virtual), el_idx)
    az_factors = mxu.aoa_factors(len(az_idx) or 1, num_angle_bins,
                                 shift_az_resp)
    el_factors = mxu.aoa_factors(len(el_idx) or 1, num_angle_bins,
                                 shift_el_resp)
    aoa_angle_bins = jnp.asarray(grids.angle_bins(num_angle_bins))
    range_res = cfg.range_res_m
    vel0, vel_res = -cfg.vel_max_m_s, cfg.vel_res_m_s

    def single_frame(raw_re, raw_im):
        raw = mxu.C2(raw_re, raw_im)
        # windowed range-DFT of every virtual channel, reformat fused in
        R = mxu.range_dft_channels(raw, all_chans, rng_factors,
                                   num_rx=num_rx, cfgs_per_loop=cpl)
        D = mxu.dft_apply(R, dop_factors, axis=-1)  # (A, ns, nloops)
        rd_map = mxu.cabs(mxu.C2(D.re[rx_idx], D.im[rx_idx]))

        # chirp-0 coarse profile over all virtual channels
        range_profile = jnp.mean(
            mxu.cabs(mxu.C2(R.re[..., 0], R.im[..., 0])), axis=0)

        out = {"rd_map": rd_map, "range_profile": range_profile}

        if "md" in include:
            # micro-Doppler column: UNwindowed transforms, channel rx_idx
            U = mxu.range_dft_channels(raw, (rx_idx,), rng_plain,
                                       num_rx=num_rx, cfgs_per_loop=cpl)
            Du = mxu.dft_apply(U, dop_plain, axis=-1)
            md_mag = mxu.cabs(mxu.C2(Du.re[0], Du.im[0]))
            out["md_col"] = jnp.max(
                jnp.where(md_mask[:, None], md_mag, -jnp.inf), axis=0)

        if "da" in include:
            # coarse Doppler-azimuth: angle DFT over the antenna axis of D
            A = mxu.dft_apply(mxu.C2(jnp.moveaxis(D.re[da_rx], 0, -1),
                                     jnp.moveaxis(D.im[da_rx], 0, -1)),
                              angle_factors, axis=-1)  # (ns, nloops, n_ang)
            da = mxu.cabs(A)[:, :, valid_angle_cols]
            out["da_map"] = jnp.mean(da, axis=0)  # full-range window

        if "ra" in include:
            # chirp-0 range-azimuth heatmap off the shared R
            slice0 = mxu.C2(R.re[ra_rx, :, 0] * ra_chan_w[:, None],
                            R.im[ra_rx, :, 0] * ra_chan_w[:, None])
            ra = mxu.dft_apply(mxu.C2(slice0.re.T, slice0.im.T),
                               ra_angle_factors, axis=-1)  # (ns, n_angle)
            out["ra_map"] = mxu.cabs(ra)

        if "det1d" in include:
            thr = threshold_1d(range_profile)
            idx1, valid1, _ = masked.mask_to_indices(
                range_profile > thr, max_dets_1d)
            out.update(det1d_idx=idx1, det1d_valid=valid1, det1d_thr=thr)

        if "detseq" in include:
            row_det = range_profile > seq_rng_thr(range_profile)
            vel_det = jax.vmap(lambda row: row > seq_vel_thr(row))(rd_map)
            seq_r, seq_v, seq_valid, seq_count = masked.mask_to_indices_2d(
                row_det[:, None] & vel_det, max_dets)
            out.update(detseq_r=seq_r, detseq_v=seq_v,
                       detseq_valid=seq_valid, detseq_count=seq_count)

        if "det2d" in include:
            det = detect(rd_map)
            r_i, v_i, det_valid, det_count = masked.mask_to_indices_2d(
                det, max_dets)

            vals = mxu.rd_values_from_range_dft(R, dop_factors, r_i, v_i)
            az = (mxu.aoa_peak_angles(vals, az_pos, az_factors,
                                      aoa_angle_bins)
                  if az_idx.size else jnp.zeros(r_i.shape, jnp.float32))
            el = (mxu.aoa_peak_angles(vals, el_pos, el_factors,
                                      aoa_angle_bins)
                  if el_idx.size else jnp.zeros(r_i.shape, jnp.float32))
            ranges = r_i.astype(jnp.float32) * range_res
            vels = vel0 + v_i.astype(jnp.float32) * vel_res
            pts = spherical_to_cartesian_flu(ranges, az, el, vels)
            pts = jnp.where(det_valid[:, None], pts, 0.0)
            out.update(det_r=r_i, det_v=v_i, det_valid=det_valid,
                       det_count=det_count, points=pts, pt_valid=det_valid,
                       pt_count=det_count)

        return out

    return jax.jit(jax.vmap(single_frame))


def build_ground_detector_stage(
    cfg: RadarConfig,
    *,
    vel_cfar_type: str = "os_cfar_1d",
    vel_cfar_params: Optional[dict] = None,
    max_dets: int = 128,
):
    """Altitude-gated velocity-CFAR detections from precomputed inputs.

    Second stage of the ground-detector precompute: the altitude track comes
    from the sequential ground-scan pipeline
    (``parallel/ground_pipeline.py``, ``stop_after="altitude"``) and the RD
    magnitude maps from :func:`build_viewer_payload_pipeline`; this stage is
    the pure per-frame tail (``processors/detection.RangeDopplerGroundDetector
    .detect_map``/``range_gate``, reference
    ``range_doppler_ground_detector.py:89-120``) vmapped over the recording.

    Returns jitted ``(rd_mag [B, ns, nc], altitude [B]) ->
    (det_r, det_v, det_valid, det_count)``.
    """
    from mmwave_radar_processing_jax.processors.detection import _threshold_1d

    thr = _threshold_1d(vel_cfar_type, dict(vel_cfar_params or dict(
        num_train=16, num_guard=4, rho=0.5, alpha=12)))
    bins = jnp.asarray(grids.range_bins(cfg, variant="eps"))

    def single(rd_mag, altitude_m):
        min_idx = jnp.argmin(jnp.abs(bins - altitude_m))
        max_rng = jnp.minimum(jnp.max(bins),
                              altitude_m / jnp.cos(jnp.deg2rad(60.0)))
        max_idx = jnp.argmin(jnp.abs(bins - max_rng))
        rows = jnp.arange(bins.shape[0])
        gate = (rows >= min_idx) & (rows <= max_idx)
        vel_det = jax.vmap(lambda row: row > thr(row))(rd_mag)
        return masked.mask_to_indices_2d(gate[:, None] & vel_det, max_dets)

    return jax.jit(jax.vmap(single))


def build_dbs_viewer_stage(
    cfg: RadarConfig,
    *,
    num_angle_bins_range_angle_response: int = 64,
    num_angle_bins_dbs_enhanced_response: int = 64,
    min_x_y_vel_dbs: float = 0.25,
    rx_antennas: Optional[Sequence[int]] = None,
):
    """Batched split-complex DBS-enhanced range-angle stage for the viewer.

    Device formulation of ``processors/dbs.RangeAngleProcessorDBSEnhanced``
    (reference ``range_angle_resp_dbs_enhanced.py``): per frame BOTH branches
    are computed — the plain chirp-0 range-angle heatmap (full-antenna window
    then subset selection, reference :117-121 via :104-120) and the
    DBS-sharpened map (3D windowed DFT over the SELECTED antennas, then
    ``resp[nearest coarse angle, :, nearest Doppler bin]`` per output angle,
    reference :137-263) — plus the per-frame speed gate
    ``|v_xy| >= min_x_y_vel_dbs`` (:308-342), so the cache can serve the
    branch the per-frame path would have taken.  All transforms are DFT
    matmuls (no complex dtypes); the per-output-angle Doppler selection is a
    one-hot diagonal reduction with traced velocity, and the static
    coarse-angle gather bakes into a reindex of the angle DFT factors.

    Returns jitted ``(raw_re, raw_im [B, rx, ns, nt], velocity_ned [B, 3])
    -> (ra_map [B, ns, A_ra], dbs_map [B, ns, A_dbs], use_dbs [B])``.
    """
    ns, loops = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    n_virtual = cpl * num_rx
    a_ra = num_angle_bins_range_angle_response
    a_dbs = num_angle_bins_dbs_enhanced_response
    sel = (np.arange(n_virtual) if rx_antennas is None
           else np.asarray(rx_antennas, int))

    rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))
    dop_factors = mxu.dft_factors(loops, window=np.hanning(loops), shift=True)

    # plain RA branch: full-antenna Hann then subset (reference quirk)
    ra_chan_w = jnp.asarray(np.hanning(n_virtual)[sel], jnp.float32)
    ra_angle_factors = mxu.dft_factors(len(sel), a_ra, shift=True)

    # DBS branch: Hann over the SELECTED antennas folded into the angle DFT
    dbs_angle_factors = mxu.dft_factors(
        len(sel), a_ra, shift=True, window=np.hanning(len(sel)))
    coarse_bins = grids.angle_bins(a_ra)
    dbs_bins = np.linspace(coarse_bins[0], coarse_bins[-1], a_dbs)
    # nearest coarse angle per output angle is STATIC: reindex the angle
    # factor columns instead of gathering the spectrum (reference :216-263)
    ang_idx = np.argmin(
        np.abs(coarse_bins[None, :] - dbs_bins[:, None]), axis=1)
    dbs_fac_sel = (jnp.asarray(np.asarray(dbs_angle_factors[0])[:, ang_idx]),
                   jnp.asarray(np.asarray(dbs_angle_factors[1])[:, ang_idx]))
    vel_bins = jnp.asarray(grids.vel_bins(cfg))
    dbs_dirs = jnp.asarray(
        np.stack([np.cos(dbs_bins), np.sin(dbs_bins)], axis=1), jnp.float32)
    chans = tuple(int(v) for v in sel)

    def single(raw_re, raw_im, vel_ned):
        R = mxu.range_dft_channels(
            mxu.C2(raw_re, raw_im), chans, rng_factors,
            num_rx=num_rx, cfgs_per_loop=cpl)  # (A_sel, ns, loops)

        # plain RA off chirp 0
        slice0 = mxu.C2(R.re[:, :, 0] * ra_chan_w[:, None],
                        R.im[:, :, 0] * ra_chan_w[:, None])
        ra = mxu.dft_apply(mxu.C2(slice0.re.T, slice0.im.T),
                           ra_angle_factors, axis=-1)
        ra_map = mxu.cabs(ra)

        # DBS: Doppler DFT then the reindexed angle DFT -> [A_dbs, ns, loops]
        rd = mxu.dft_apply(R, dop_factors, axis=-1)
        sp_re = (jnp.einsum("awv,am->mwv", rd.re, dbs_fac_sel[0])
                 + jnp.einsum("awv,am->mwv", rd.im, dbs_fac_sel[1]))
        sp_im = (jnp.einsum("awv,am->mwv", rd.im, dbs_fac_sel[0])
                 - jnp.einsum("awv,am->mwv", rd.re, dbs_fac_sel[1]))
        mag3d = jnp.sqrt(sp_re * sp_re + sp_im * sp_im)

        dop_vel = -(dbs_dirs @ vel_ned[:2])  # [A_dbs]
        vel_idx = jnp.argmin(
            jnp.abs(vel_bins[None, :] - dop_vel[:, None]), axis=1)
        ohv = (vel_idx[None, :] == jnp.arange(loops)[:, None]).astype(
            jnp.float32)  # [loops, A_dbs]
        dbs_map = jnp.einsum("mwv,vm->wm", mag3d, ohv)

        use_dbs = jnp.linalg.norm(vel_ned[:2]) >= min_x_y_vel_dbs
        return ra_map, dbs_map, use_dbs

    return jax.jit(jax.vmap(single))
