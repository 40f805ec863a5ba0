"""Detection pipelines: range detector + the range-Doppler detector family.

Re-design of ``processors/range_detector.py`` and
``processors/range_doppler_detection/``.  The reference detects with Python
loops over dynamically-sized index lists; here every variant produces a full
boolean detection *map* with pure kernels, converted to fixed-capacity padded
``(range_idx, vel_idx)`` sets at the boundary:

- ``RangeDopplerDetector2D``: 2D CFAR straight on the RD magnitude map
  (reference ``range_doppler_detector_2d.py:49-66``).
- ``RangeDopplerDetectorSequential``: 1D range CFAR gates rows, then a 1D
  velocity CFAR runs on *every* row via vmap (the reference loops over only
  detected rows — same result, data-independent shape) and the row gate is
  ANDed in (reference ``range_doppler_detector_sequential.py:72-108``).
- ``RangeDopplerGroundDetector``: altitude from the (stateful) altimeter sets
  a range gate ``[alt, min(range_max, alt/cos 60°)]``; velocity CFAR per gated
  row (reference ``range_doppler_ground_detector.py:72-121``).

Ordering parity: detections are emitted row-major (range-major), matching the
reference's nested loops / ``np.where``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.ops import cfar as cfar_ops, masked
from mmwave_radar_processing_jax.processors.altimeter import Altimeter, AltimeterState
from mmwave_radar_processing_jax.processors.range_doppler import (
    RangeDopplerProcessor,
    range_doppler_map,
)
from mmwave_radar_processing_jax.processors.range_resp import (
    RangeProcessor,
    coarse_range_fft,
)

DEFAULT_MAX_DETS = 256


class Detections(NamedTuple):
    """Fixed-capacity padded detection set over a range-Doppler map."""

    range_idx: jax.Array  # (K,) int32
    vel_idx: jax.Array  # (K,) int32
    valid: jax.Array  # (K,) bool
    count: jax.Array  # () int32


def _threshold_1d(kind: str, params: Dict):
    """Bind a 1D CFAR threshold function from registry-style (kind, params)."""
    if kind == "ca_cfar_1d":
        return lambda x: cfar_ops.ca_1d(
            x, num_train=int(params["num_train"]), num_guard=int(params["num_guard"]),
            pfa=float(params["pfa"]),
        )[0]
    if kind == "os_cfar_1d":
        return lambda x: cfar_ops.os_1d(
            x, num_train=int(params["num_train"]), num_guard=int(params["num_guard"]),
            rho=float(params["rho"]), alpha=float(params["alpha"]),
        )[0]
    if kind == "go_cfar_1d":
        return lambda x: cfar_ops.go_so_1d(
            x, num_train=int(params["num_train"]), num_guard=int(params["num_guard"]),
            pfa=float(params["pfa"]), greatest=True,
        )[0]
    if kind == "so_cfar_1d":
        return lambda x: cfar_ops.go_so_1d(
            x, num_train=int(params["num_train"]), num_guard=int(params["num_guard"]),
            pfa=float(params["pfa"]), greatest=False,
        )[0]
    raise ValueError(f"unknown 1D CFAR kind {kind!r}")


def _threshold_2d(kind: str, params: Dict):
    if kind == "ca_cfar_2d":
        return lambda x: cfar_ops.ca_2d(
            x, num_train=tuple(params["num_train"]), num_guard=tuple(params["num_guard"]),
            pfa=float(params["pfa"]),
        )[0]
    if kind == "os_cfar_2d":
        return lambda x: cfar_ops.os_2d(
            x, num_train=tuple(params["num_train"]), num_guard=tuple(params["num_guard"]),
            rho=float(params["rho"]), alpha=float(params["alpha"]),
        )[0]
    raise ValueError(f"unknown 2D CFAR kind {kind!r}")


# --------------------------------------------------------------------------- #
# range detector (1D)
# --------------------------------------------------------------------------- #
class RangeDetector(RangeProcessor):
    """Range FFT + 1D CFAR (reference ``range_detector.py``)."""

    def __init__(
        self,
        config: RadarConfig,
        cfar_type: str = "os_cfar_1d",
        cfar_params: Optional[Dict] = None,
        max_dets: int = 64,
        **kwargs,
    ):
        super().__init__(config)
        self.cfar_type = cfar_type
        self.cfar_params = cfar_params or dict(num_train=5, num_guard=3, rho=0.5, alpha=2)
        self._threshold = _threshold_1d(cfar_type, self.cfar_params)
        self.max_dets = max_dets
        self.range_resp = None
        self.thresholds = None
        self.dets = None

    def process(self, adc_cube: jax.Array, **kwargs):
        """Detection indices over the coarse range profile (padded set)."""
        self.range_resp = self.coarse_fft(adc_cube, chirp_idx=0)
        self.thresholds = self._threshold(self.range_resp)
        det_mask = self.range_resp > self.thresholds
        idx, valid, count = masked.mask_to_indices(det_mask, self.max_dets)
        self.dets = np.asarray(idx)[np.asarray(valid)]
        return self.dets

    def _map_detections_to_bins(self, dets):
        return np.asarray(self.range_bins)[np.asarray(dets, int)]


# --------------------------------------------------------------------------- #
# range-Doppler detectors
# --------------------------------------------------------------------------- #
class RangeDopplerDetector(RangeDopplerProcessor):
    """Base: computes/caches the full complex RD cube + antenna-0 magnitude."""

    def __init__(self, config: RadarConfig, max_dets: int = DEFAULT_MAX_DETS, **kwargs):
        super().__init__(config)
        self.max_dets = max_dets
        self.rng_dop_resp_raw = None
        self.rng_dop_resp = None
        self.dets = None

    # pure functional core ------------------------------------------------ #
    def detect_map(self, rd_mag: jax.Array, **kw) -> jax.Array:
        """Boolean detection map ``[range, vel]`` — subclass responsibility."""
        raise NotImplementedError

    def detect_inputs(self, adc_cube: jax.Array) -> dict:
        """Extra traced inputs for :meth:`detect_map` (may mutate tracker state)."""
        return {}

    def _compute_range_doppler_response(self, adc_cube: jax.Array):
        self.rng_dop_resp_raw = range_doppler_map(adc_cube)
        self.rng_dop_resp = jnp.abs(self.rng_dop_resp_raw[..., 0, :, :])
        return self.rng_dop_resp_raw, self.rng_dop_resp

    def process(self, adc_cube: jax.Array, **kwargs) -> np.ndarray:
        """(N, 2) ``(range_idx, vel_idx)`` detections (reference API)."""
        kwargs = {**self.detect_inputs(adc_cube), **kwargs}
        self._compute_range_doppler_response(adc_cube)
        det_mask = self.detect_map(self.rng_dop_resp, **kwargs)
        r, v, valid, _ = masked.mask_to_indices_2d(det_mask, self.max_dets)
        valid = np.asarray(valid)
        self.dets = np.stack([np.asarray(r)[valid], np.asarray(v)[valid]], axis=1)
        return self.dets

    def detections(
        self, adc_cube: jax.Array, rng_dop_raw: Optional[jax.Array] = None, **kwargs
    ) -> Detections:
        """Device-resident padded detections (for fused jitted pipelines).

        ``rng_dop_raw`` may be supplied to reuse an already-computed RD cube.
        """
        kwargs = {**self.detect_inputs(adc_cube), **kwargs}
        raw = rng_dop_raw if rng_dop_raw is not None else range_doppler_map(adc_cube)
        det_mask = self.detect_map(jnp.abs(raw[..., 0, :, :]), **kwargs)
        r, v, valid, count = masked.mask_to_indices_2d(det_mask, self.max_dets)
        return Detections(r, v, valid, count)

    def _map_detections_to_bins(self, dets: np.ndarray):
        if dets is None or np.size(dets) == 0:
            z = np.array([])
            return z, z, z, z
        r_idx = np.asarray(dets)[:, 0].astype(int)
        v_idx = np.asarray(dets)[:, 1].astype(int)
        return (
            np.asarray(self.range_bins)[r_idx],
            np.asarray(self.vel_bins)[v_idx],
            r_idx,
            v_idx,
        )

    def reset(self):
        super().reset()
        self.rng_dop_resp_raw = None
        self.rng_dop_resp = None
        self.dets = None


class RangeDopplerDetector2D(RangeDopplerDetector):
    """2D CFAR directly on the RD magnitude map."""

    def __init__(
        self,
        config: RadarConfig,
        cfar_type: str = "ca_cfar_2d",
        cfar_params: Optional[Dict] = None,
        **kwargs,
    ):
        super().__init__(config, **kwargs)
        self.cfar_params = cfar_params or dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3)
        self._threshold = _threshold_2d(cfar_type, self.cfar_params)

    def detect_map(self, rd_mag: jax.Array, **kw) -> jax.Array:
        return rd_mag > self._threshold(rd_mag)


class RangeDopplerDetectorSequential(RangeDopplerDetector):
    """1D range CFAR gating rows, then 1D velocity CFAR along each row."""

    def __init__(
        self,
        config: RadarConfig,
        rng_cfar_type: str = "os_cfar_1d",
        rng_cfar_params: Optional[Dict] = None,
        vel_cfar_type: str = "os_cfar_1d",
        vel_cfar_params: Optional[Dict] = None,
        **kwargs,
    ):
        super().__init__(config, **kwargs)
        self._rng_threshold = _threshold_1d(
            rng_cfar_type, rng_cfar_params or dict(num_train=5, num_guard=3, rho=0.6, alpha=2)
        )
        self._vel_threshold = _threshold_1d(
            vel_cfar_type, vel_cfar_params or dict(num_train=5, num_guard=2, rho=0.7, alpha=3)
        )

    def detect_map(self, rd_mag: jax.Array, range_profile: jax.Array = None, **kw):
        row_det = range_profile > self._rng_threshold(range_profile)  # [range]
        vel_det = jax.vmap(lambda row: row > self._vel_threshold(row))(rd_mag)
        return row_det[:, None] & vel_det

    def detect_inputs(self, adc_cube: jax.Array) -> dict:
        return {"range_profile": coarse_range_fft(adc_cube[..., :, :, 0])}


class RangeDopplerGroundDetector(RangeDopplerDetector):
    """Altitude-gated velocity CFAR for down-facing UAV ground point clouds."""

    def __init__(
        self,
        config: RadarConfig,
        vel_cfar_type: str = "os_cfar_1d",
        vel_cfar_params: Optional[Dict] = None,
        altimeter_params: Optional[Dict] = None,
        **kwargs,
    ):
        super().__init__(config, **kwargs)
        self._vel_threshold = _threshold_1d(
            vel_cfar_type, vel_cfar_params or dict(num_train=16, num_guard=4, rho=0.5, alpha=12)
        )
        altimeter_params = dict(
            altimeter_params
            or dict(
                min_altitude_m=0.25,
                zoom_search_region_m=0.2,
                altitude_search_limit_m=0.4,
                range_bias=0.0,
            )
        )
        self.precise_est_enabled = bool(altimeter_params.pop("precise_est_enabled", True))
        self.altimeter = Altimeter(config, **altimeter_params)

    def range_gate(self, altitude_m: jax.Array) -> jax.Array:
        """Boolean row gate ``[altitude_bin, min(range_max, alt/cos60°)]``.

        Reference ``range_doppler_ground_detector.py:89-103``: nearest-bin
        indices, inclusive; when they coincide the single row stays gated.
        """
        bins = jnp.asarray(self.range_bins)
        min_idx = jnp.argmin(jnp.abs(bins - altitude_m))
        max_rng = jnp.minimum(jnp.max(bins), altitude_m / jnp.cos(jnp.deg2rad(60.0)))
        max_idx = jnp.argmin(jnp.abs(bins - max_rng))
        rows = jnp.arange(bins.shape[0])
        return (rows >= min_idx) & (rows <= max_idx)

    def detect_map(self, rd_mag: jax.Array, altitude_m: jax.Array = None, **kw):
        vel_det = jax.vmap(lambda row: row > self._vel_threshold(row))(rd_mag)
        return self.range_gate(altitude_m)[:, None] & vel_det

    def detect_inputs(self, adc_cube: jax.Array) -> dict:
        """Runs (and advances) the stateful altimeter tracker."""
        altitude = self.altimeter.process(
            adc_cube, precise_est_enabled=self.precise_est_enabled
        )
        return {"altitude_m": altitude}

    def step(self, alt_state: AltimeterState, adc_cube: jax.Array):
        """Functional variant: ``(alt_state, frame) -> (alt_state, Detections)``."""
        alt_state, altitude = self.altimeter.step(
            alt_state, adc_cube, precise_est_enabled=self.precise_est_enabled
        )
        raw = range_doppler_map(adc_cube)
        det_mask = self.detect_map(jnp.abs(raw[..., 0, :, :]), altitude_m=altitude)
        r, v, valid, count = masked.mask_to_indices_2d(det_mask, self.max_dets)
        return alt_state, Detections(r, v, valid, count)

    def reset(self):
        self.altimeter.reset()
        super().reset()


def get_range_doppler_detector_registry() -> Dict[str, type]:
    """Name -> class map (reference ``range_doppler_detection/registry.py``)."""
    return {
        "range_doppler_detector_2d": RangeDopplerDetector2D,
        "range_doppler_detector_sequential": RangeDopplerDetectorSequential,
        "range_doppler_ground_detector": RangeDopplerGroundDetector,
    }
