"""Precompute-then-scrub playback: batched device payloads behind the viewer.

The per-frame controller fan-out costs ~381 ms/frame on CPU (12 processors,
``docs/visualization.md``), while the fused device pipelines do the same
math in well under 1 ms/frame — but round 3 never bridged them.  This module
is the bridge: :class:`PrecomputedPlayback` runs the whole recording through
:func:`parallel.viewer_pipeline.build_viewer_payload_pipeline` (plus the
ground-scan pipeline for the stateful altimeter) in a handful of batched
dispatches, caches the per-frame payload arrays on the host, and serves them
to the controller during playback/scrubbing — the processing leg of a tick
becomes a dict lookup.

Semantics: cached payloads represent *sequential playback from frame 0*
(exactly what ``controller.play()`` produces) — for the stateful processors
(micro-Doppler history, altimeter track) a scrub to frame ``i`` shows the
state as if frames ``0..i`` had played in order.  Reference tick model:
``backends/mmwave_radar_processor_controller.py:170`` (50 ms QTimer).

Coverage: the seven registry keys with device-side formulations (see
``COVERED``).  A key whose YAML params use features the batched pipeline
does not implement (e.g. a custom ``range_window`` for Doppler-azimuth,
``rx_idx=-1``) is dropped from coverage and falls back to the per-frame CPU
path — behavior stays correct, only speed differs.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

import numpy as np

from mmwave_radar_processing_jax.utils.logger import get_logger

#: registry keys the batched device pipelines can serve
COVERED = frozenset({
    "range_doppler_resp",
    "range_resp",
    "micro_doppler_resp",
    "doppler_azimuth_resp",
    "range_angle_resp",
    "range_detector",
    "range_doppler_detector_2d",
    "range_doppler_detector_sequential",
    "range_doppler_ground_detector",
    "point_cloud_generator",
    "altimeter",
    "capon_beamformer",
    "bartlett_beamformer",
    "range_angle_resp_dbs_enhanced",
})

#: viewer-pipeline output group needed per key (None = separate pipeline)
_INCLUDE_GROUP = {
    "micro_doppler_resp": "md",
    "doppler_azimuth_resp": "da",
    "range_angle_resp": "ra",
    "range_detector": "det1d",
    "range_doppler_detector_2d": "det2d",
    "range_doppler_detector_sequential": "detseq",
    "point_cloud_generator": "det2d",
}

#: per-key process()/ctor kwargs the batched pipeline honors; any other
#: YAML-provided kwarg drops the key back to the per-frame path
_SUPPORTED_PARAMS = {
    "range_doppler_resp": {"rx_idx"},
    "range_resp": {"chirp_idx"},  # chirp 0 only (the default)
    "micro_doppler_resp": {"rx_idx", "target_ranges", "num_frames_history"},
    "doppler_azimuth_resp": {"num_angle_bins", "valid_angle_range",
                             "rx_antennas"},
    "range_doppler_detector_2d": {"cfar_type", "cfar_params"},
    "point_cloud_generator": {
        "az_antenna_idxs", "el_antenna_idxs", "detector_type",
        "detector_params", "shift_az_resp", "shift_el_resp", "num_angle_bins",
    },
    "altimeter": {"min_altitude_m", "zoom_search_region_m",
                  "altitude_search_limit_m", "range_bias"},
    "range_angle_resp": {"num_angle_bins", "chirp_idx", "rx_antennas",
                         "perform_windowing"},
    "range_detector": {"cfar_type", "cfar_params", "max_dets"},
    "range_doppler_detector_sequential": {
        "rng_cfar_type", "rng_cfar_params", "vel_cfar_type",
        "vel_cfar_params"},
    "range_doppler_ground_detector": {
        "vel_cfar_type", "vel_cfar_params", "altimeter_params"},
    "capon_beamformer": {"antenna_idxs", "num_angle_bins",
                         "diagonal_loading"},
    "bartlett_beamformer": {"antenna_idxs", "num_angle_bins",
                            "diagonal_loading"},
    "range_angle_resp_dbs_enhanced": {
        "num_angle_bins_range_angle_response",
        "num_angle_bins_dbs_enhanced_response", "min_x_y_vel_dbs",
        "rx_antennas"},
}


class PrecomputedPlayback:
    """Recording-wide payload cache built from the batched device pipelines.

    Args:
        controller: a loaded ``MmWaveRadarProcessorController`` (dataset,
            config and processors initialized).
        keys: registry keys to precompute (default: every enabled processor
            key in ``COVERED``).
        batch_size: frames per device dispatch for the stateless pipeline.
    """

    def __init__(self, controller, keys: Optional[Iterable[str]] = None,
                 batch_size: int = 64):
        self.logger = get_logger(__name__)
        self.controller = controller
        self.batch_size = int(batch_size)
        self.cfg = controller.config_model.config
        if self.cfg is None:
            raise ValueError("controller has no config loaded")
        want = set(keys) if keys is not None else set(controller.processors)
        self._keys: Set[str] = set()
        self._params: Dict[str, dict] = {}
        for key in want & COVERED & set(controller.processors):
            params = dict(controller.processor_params.get(key, {}))
            unsupported = set(params) - _SUPPORTED_PARAMS.get(key, set())
            if unsupported:
                self.logger.info(
                    "precompute: %s falls back to per-frame (unsupported "
                    "params %s)", key, sorted(unsupported))
                continue
            if int(params.get("rx_idx", 0)) < 0:
                continue  # rx_idx=-1 (all antennas) stays per-frame
            if (key in ("range_resp", "range_angle_resp")
                    and int(params.get("chirp_idx", 0)) != 0):
                continue  # non-default chirp stays per-frame
            if (key == "range_angle_resp"
                    and not params.get("perform_windowing", True)):
                continue
            self._keys.add(key)
            self._params[key] = params
        self._arrays: Dict[str, np.ndarray] = {}
        self.num_frames = 0
        self.build_seconds: Optional[float] = None

    # ------------------------------------------------------------------ #
    def covers(self, key: str) -> bool:
        return key in self._keys and bool(self._arrays)

    @property
    def covered_keys(self) -> Set[str]:
        return set(self._keys)

    def build(self) -> Set[str]:
        """Run the recording through the device pipelines; cache host arrays.

        Returns the set of covered keys.
        """
        import time

        import jax

        from mmwave_radar_processing_jax.parallel.viewer_pipeline import (
            build_viewer_payload_pipeline,
        )
        from mmwave_radar_processing_jax.utils.platform import (
            enable_compile_cache,
        )

        enable_compile_cache()

        t0 = time.perf_counter()
        ds = self.controller.dataset_model
        n = ds.num_frames
        if n == 0:
            raise ValueError("no dataset loaded")
        frames = np.stack([ds.get_adc_data(i) for i in range(n)])
        raw_re = np.ascontiguousarray(frames.real, np.float32)
        raw_im = np.ascontiguousarray(frames.imag, np.float32)

        kw = {}
        p = self._params
        if "range_doppler_resp" in p or "micro_doppler_resp" in p:
            rx_rd = int(p.get("range_doppler_resp", {}).get("rx_idx", 0))
            rx_md = int(p.get("micro_doppler_resp", {}).get("rx_idx", 0))
            if ("range_doppler_resp" in p and "micro_doppler_resp" in p
                    and rx_rd != rx_md):
                # one shared channel per build; the rarer consumer falls back
                self._keys.discard("micro_doppler_resp")
            kw["rx_idx"] = rx_rd if "range_doppler_resp" in p else rx_md
        if "micro_doppler_resp" in p:
            kw["md_target_ranges"] = tuple(
                p["micro_doppler_resp"].get("target_ranges", (0.0, 1.0)))
        if "doppler_azimuth_resp" in p:
            da = p["doppler_azimuth_resp"]
            kw["num_angle_bins"] = int(da.get("num_angle_bins", 64))
            if "valid_angle_range" in da:
                kw["valid_angle_range"] = tuple(da["valid_angle_range"])
            if da.get("rx_antennas"):
                kw["da_rx_antennas"] = tuple(da["rx_antennas"])
        if "range_doppler_detector_2d" in p:
            det = p["range_doppler_detector_2d"]
            kw["cfar_type"] = det.get("cfar_type", "ca_cfar_2d")
            if det.get("cfar_params"):
                kw["cfar_params"] = dict(det["cfar_params"])
        if "point_cloud_generator" in p:
            pc = p["point_cloud_generator"]
            if int(pc.get("num_angle_bins", 64)) != int(
                    kw.get("num_angle_bins", 64)):
                # the builder shares one angle grid between DA and AoA
                self._keys.discard("point_cloud_generator")
                pc = {}
            for name in ("az_antenna_idxs", "el_antenna_idxs"):
                if name in pc:
                    kw[name] = tuple(pc[name])
            for name in ("shift_az_resp", "shift_el_resp"):
                if name in pc:
                    kw[name] = bool(pc[name])
            dp = pc.get("detector_params") or {}
            if pc.get("detector_type",
                      "range_doppler_detector_2d") != "range_doppler_detector_2d":
                self._keys.discard("point_cloud_generator")
            elif dp:
                kw["cfar_type"] = dp.get("cfar_type", "ca_cfar_2d")
                if dp.get("cfar_params"):
                    kw["cfar_params"] = dict(dp["cfar_params"])

        if "range_angle_resp" in p:
            ra = p["range_angle_resp"]
            kw["ra_num_angle_bins"] = int(ra.get("num_angle_bins", 64))
            if ra.get("rx_antennas"):
                kw["ra_rx_antennas"] = tuple(ra["rx_antennas"])
        if "range_detector" in p:
            rd1 = p["range_detector"]
            kw["cfar1d_type"] = rd1.get("cfar_type", "os_cfar_1d")
            if rd1.get("cfar_params"):
                kw["cfar1d_params"] = dict(rd1["cfar_params"])
            kw["max_dets_1d"] = int(rd1.get("max_dets", 64))
        if "range_doppler_detector_sequential" in p:
            sq = p["range_doppler_detector_sequential"]
            if sq.get("rng_cfar_type") or sq.get("rng_cfar_params"):
                kw["seq_rng_cfar"] = (
                    sq.get("rng_cfar_type", "os_cfar_1d"),
                    dict(sq.get("rng_cfar_params")
                         or dict(num_train=5, num_guard=3, rho=0.6, alpha=2)))
            if sq.get("vel_cfar_type") or sq.get("vel_cfar_params"):
                kw["seq_vel_cfar"] = (
                    sq.get("vel_cfar_type", "os_cfar_1d"),
                    dict(sq.get("vel_cfar_params")
                         or dict(num_train=5, num_guard=2, rho=0.7, alpha=3)))
        if int(kw.get("rx_idx", 0)) != 0:
            # every detector's RD magnitude map is fixed to antenna 0
            # (detection.py:280: rd[..., 0, :, :]); the shared rd_map here
            # follows rx_idx, so non-zero rx_idx drops the detector keys
            for k in ("range_doppler_detector_2d", "point_cloud_generator",
                      "range_doppler_detector_sequential",
                      "range_doppler_ground_detector"):
                self._keys.discard(k)
        kw["include"] = sorted(
            {_INCLUDE_GROUP[k] for k in self._keys if k in _INCLUDE_GROUP})

        fn = build_viewer_payload_pipeline(self.cfg, **kw)

        # Host-fetch batching: every ``np.asarray`` of a device output is a
        # device-to-host round trip, and a per-leaf fetch makes the cache
        # build host-fetch-bound.  Instead (a) each chunk's ~25
        # output leaves are packed into ONE flat f32 device array inside the
        # jitted program (ints/bools round-trip exactly through f32 — all
        # values are bin indices/counts/flags < 2^24), and (b) every chunk of
        # every pipeline is DISPATCHED before anything is fetched, so the
        # FIFO queue overlaps device compute with the fetches.
        leaf_spec = None

        def packed_pipeline(a, b):
            out = fn(a, b)
            parts = [
                out[k].reshape(out[k].shape[0], -1).astype(jnp.float32)
                for k in sorted(out)
            ]
            return jnp.concatenate(parts, axis=1)

        import jax.numpy as jnp

        shapes = jax.eval_shape(fn, raw_re[: min(self.batch_size, n)],
                                raw_im[: min(self.batch_size, n)])
        leaf_spec = [
            (k, tuple(shapes[k].shape[1:]), shapes[k].dtype,
             int(np.prod(shapes[k].shape[1:], dtype=np.int64)) or 1)
            for k in sorted(shapes)
        ]
        packed_jit = jax.jit(packed_pipeline)
        dev_chunks = [
            packed_jit(raw_re[lo:lo + self.batch_size],
                       raw_im[lo:lo + self.batch_size])
            for lo in range(0, n, self.batch_size)
        ]

        dev_beam = {}
        for bkey, method in (("capon_beamformer", "capon"),
                             ("bartlett_beamformer", "bartlett")):
            if bkey not in self._keys:
                continue
            from mmwave_radar_processing_jax.parallel.capon_pipeline import (
                build_capon_pipeline,
            )

            bp = self._params[bkey]
            idxs = bp.get("antenna_idxs")
            if idxs is None:
                idxs = tuple(range(
                    self.cfg.num_virtual_antennas
                    if self.cfg.virtual_antennas_enabled
                    else self.cfg.num_rx_antennas))
            bfn = build_capon_pipeline(
                self.cfg, antenna_idxs=tuple(idxs),
                num_angle_bins=int(bp.get("num_angle_bins", 64)),
                method=method,
                loading=float(bp.get("diagonal_loading", 1e-2)))
            dev_beam[bkey] = [
                bfn(raw_re[lo:lo + self.batch_size],
                    raw_im[lo:lo + self.batch_size])
                for lo in range(0, n, self.batch_size)
            ]

        # DBS-enhanced range-angle: needs per-frame platform velocity; if the
        # dataset carries no odometry the key falls back to the per-frame
        # path (which needs the same velocity and degrades identically)
        dev_dbs = []
        self._dbs_meta = None
        if "range_angle_resp_dbs_enhanced" in self._keys:
            vels = None
            try:
                vels = np.stack([
                    np.asarray(ds.get_velocity_ned(i), np.float32)
                    for i in range(n)
                ])
            except Exception:
                self._keys.discard("range_angle_resp_dbs_enhanced")
            if vels is not None:
                from mmwave_radar_processing_jax.config import grids
                from mmwave_radar_processing_jax.parallel.viewer_pipeline import (
                    build_dbs_viewer_stage,
                )

                dp = self._params["range_angle_resp_dbs_enhanced"]
                a_ra = int(dp.get("num_angle_bins_range_angle_response", 64))
                a_dbs = int(dp.get(
                    "num_angle_bins_dbs_enhanced_response", 64))
                dbs_fn = build_dbs_viewer_stage(
                    self.cfg,
                    num_angle_bins_range_angle_response=a_ra,
                    num_angle_bins_dbs_enhanced_response=a_dbs,
                    min_x_y_vel_dbs=float(dp.get("min_x_y_vel_dbs", 0.25)),
                    rx_antennas=(tuple(dp["rx_antennas"])
                                 if dp.get("rx_antennas") else None),
                )
                dev_dbs = [
                    dbs_fn(raw_re[lo:lo + self.batch_size],
                           raw_im[lo:lo + self.batch_size],
                           vels[lo:lo + self.batch_size])
                    for lo in range(0, n, self.batch_size)
                ]
                # both branches' angle grids + meshes, picked per frame
                rb = grids.range_bins(self.cfg, variant="offset")
                coarse = grids.angle_bins(a_ra)
                fine = np.linspace(coarse[0], coarse[-1], a_dbs)
                self._dbs_meta = {
                    False: (coarse,) + grids.polar_mesh(rb, coarse)[2:],
                    True: (fine,) + grids.polar_mesh(rb, fine)[2:],
                }

        # fetch phase: one round trip per chunk, then unpack on the host
        parts = {k: [] for k, _, _, _ in leaf_spec}
        for dev in dev_chunks:
            flat = np.asarray(dev)
            col = 0
            for k, shape, dtype, width in leaf_spec:
                seg = flat[:, col:col + width]
                col += width
                parts[k].append(
                    seg.reshape((seg.shape[0],) + shape).astype(dtype))
        self._arrays = {k: np.concatenate(v) for k, v in parts.items()}
        for bkey, devs in dev_beam.items():
            self._arrays[bkey] = np.concatenate(
                [np.asarray(d) for d in devs])
        if dev_dbs:
            self._arrays["dbs_ra"] = np.concatenate(
                [np.asarray(d[0]) for d in dev_dbs])
            self._arrays["dbs_map"] = np.concatenate(
                [np.asarray(d[1]) for d in dev_dbs])
            self._arrays["dbs_use"] = np.concatenate(
                [np.asarray(d[2]) for d in dev_dbs])

        if "range_doppler_ground_detector" in self._keys:
            from mmwave_radar_processing_jax.parallel.ground_pipeline import (
                build_ground_point_cloud_pipeline,
            )
            from mmwave_radar_processing_jax.parallel.viewer_pipeline import (
                build_ground_detector_stage,
            )

            gp = self._params["range_doppler_ground_detector"]
            ap = dict(gp.get("altimeter_params") or {})
            precise = bool(ap.pop("precise_est_enabled", True))
            alt_fn = build_ground_point_cloud_pipeline(
                self.cfg,
                min_altitude_m=float(ap.get("min_altitude_m", 0.25)),
                zoom_search_region_m=float(ap.get("zoom_search_region_m",
                                                  0.2)),
                altitude_search_limit_m=float(
                    ap.get("altitude_search_limit_m", 0.4)),
                range_bias=float(ap.get("range_bias", 0.0)),
                precise_est_enabled=precise,
                stop_after="altitude",
            )
            alt_track = np.asarray(
                jax.tree_util.tree_leaves(alt_fn(raw_re, raw_im))[0]
            ).reshape(n)
            stage = build_ground_detector_stage(
                self.cfg,
                vel_cfar_type=gp.get("vel_cfar_type", "os_cfar_1d"),
                vel_cfar_params=gp.get("vel_cfar_params"),
            )
            gr, gv, gvalid, gcount = stage(self._arrays["rd_map"], alt_track)
            self._arrays.update(
                detg_r=np.asarray(gr), detg_v=np.asarray(gv),
                detg_valid=np.asarray(gvalid),
                detg_count=np.asarray(gcount),
                altitude_gd=alt_track)

        if "altimeter" in self._keys:
            from mmwave_radar_processing_jax.parallel.ground_pipeline import (
                build_ground_point_cloud_pipeline,
            )

            ap = self._params["altimeter"]
            gfn = build_ground_point_cloud_pipeline(
                self.cfg,
                min_altitude_m=float(ap.get("min_altitude_m", 0.25)),
                zoom_search_region_m=float(ap.get("zoom_search_region_m", 0.2)),
                altitude_search_limit_m=float(
                    ap.get("altitude_search_limit_m", 0.4)),
                range_bias=float(ap.get("range_bias", 0.0)),
                stop_after="altitude",
            )
            self._arrays["altitude"] = np.asarray(
                jax.tree_util.tree_leaves(gfn(raw_re, raw_im))[0]
            ).reshape(n)

        self.num_frames = n
        self.build_seconds = time.perf_counter() - t0
        self.logger.info(
            "precomputed %d frames for %d views in %.2fs (%.1f ms/frame)",
            n, len(self._keys), self.build_seconds,
            1e3 * self.build_seconds / max(n, 1))
        return self.covered_keys

    # ------------------------------------------------------------------ #
    def payload(self, key: str, idx: int) -> Optional[dict]:
        """Dynamic payload parts for ``key`` at frame ``idx`` (host dict).

        Returns ``None`` when the key is not covered; the controller then
        falls back to the per-frame processor.  Static ``view_keys``
        attributes (bin grids) are filled in by the controller from the live
        processor instance, guaranteeing exact bin parity.
        """
        if not self.covers(key) or not (0 <= idx < self.num_frames):
            return None
        a = self._arrays
        if key == "range_doppler_resp":
            return {"data": a["rd_map"][idx]}
        if key == "range_resp":
            return {"data": a["range_profile"][idx]}
        if key == "micro_doppler_resp":
            proc = self.controller.processors.get(key)
            hist = int(getattr(proc, "num_frames_history", 20))
            nvel = a["md_col"].shape[1]
            data = np.zeros((nvel, hist), np.float32)
            take = min(hist, idx + 1)
            # newest column first (shift-register order, micro_doppler.py:40-45)
            data[:, :take] = a["md_col"][idx - take + 1: idx + 1][::-1].T
            return {"data": data}
        if key == "doppler_azimuth_resp":
            return {"data": a["da_map"][idx]}
        if key == "range_doppler_detector_2d":
            valid = a["det_valid"][idx]
            dets = np.stack([a["det_r"][idx][valid], a["det_v"][idx][valid]],
                            axis=1).astype(int)
            return {"data": dets, "rng_dop_resp": a["rd_map"][idx]}
        if key == "point_cloud_generator":
            valid = a["pt_valid"][idx]
            return {"data": a["points"][idx][valid]}
        if key == "altimeter":
            return {"data": np.asarray(a["altitude"][idx]),
                    "coarse_fft_data": a["range_profile"][idx]}
        if key == "range_angle_resp":
            return {"data": a["ra_map"][idx]}
        if key == "range_detector":
            valid = a["det1d_valid"][idx]
            return {"data": a["det1d_idx"][idx][valid].astype(int),
                    "range_resp": a["range_profile"][idx],
                    "thresholds": a["det1d_thr"][idx]}
        if key in ("capon_beamformer", "bartlett_beamformer"):
            return {"data": a[key][idx]}
        if key == "range_doppler_detector_sequential":
            valid = a["detseq_valid"][idx]
            dets = np.stack([a["detseq_r"][idx][valid],
                             a["detseq_v"][idx][valid]], axis=1).astype(int)
            return {"data": dets, "rng_dop_resp": a["rd_map"][idx]}
        if key == "range_doppler_ground_detector":
            valid = a["detg_valid"][idx]
            dets = np.stack([a["detg_r"][idx][valid],
                             a["detg_v"][idx][valid]], axis=1).astype(int)
            return {"data": dets, "rng_dop_resp": a["rd_map"][idx]}
        if key == "range_angle_resp_dbs_enhanced":
            # branch-dependent payload: the speed gate picks which map the
            # per-frame processor would have produced, and the matching bin
            # grid + cartesian mesh ride along (the live processor's attrs
            # reflect only the LAST frame processed — the cache must carry
            # them per frame)
            use = bool(a["dbs_use"][idx])
            bins, x_s, y_s = self._dbs_meta[use]
            return {"data": a["dbs_map" if use else "dbs_ra"][idx],
                    "angle_bins": bins, "x_s": x_s, "y_s": y_s}
        return None
