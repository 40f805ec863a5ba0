"""Point-cloud generation: detections -> batched AoA FFT -> cartesian points.

Re-design of ``processors/point_cloud_generator.py``: the per-detection
angle estimation (gather antenna snapshots at each detected (range, vel) cell,
zero-pad, FFT, argmax) was already batched in the reference (:143-214); here
it additionally runs over a *fixed-capacity* padded detection set so the whole
raw-cube -> point-cloud pipeline is one jitted program with no host syncs.

Output is an ``(K, 4)`` ``(x, y, z, radial_vel)`` array + validity mask in the
FLU frame (x forward, y left, z up), matching ``_convert_to_cartesian``
(:216-248).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import mxu, windows
from mmwave_radar_processing_jax.processors.base import Processor
from mmwave_radar_processing_jax.processors.detection import (
    Detections,
    get_range_doppler_detector_registry,
)


class PointCloud(NamedTuple):
    """Fixed-capacity padded point cloud."""

    points: jax.Array  # (K, 4) float32 (x, y, z, vel)
    valid: jax.Array  # (K,) bool
    count: jax.Array  # () int32


@partial(jax.jit, static_argnames=("num_angle_bins", "shift"))
def aoa_angles(
    rng_dop_raw: jax.Array,
    antenna_idxs: jax.Array,
    range_idx: jax.Array,
    vel_idx: jax.Array,
    angle_bins: jax.Array,
    *,
    num_angle_bins: int,
    shift: bool,
) -> jax.Array:
    """Per-detection angle via zero-padded FFT over an antenna subset.

    Args:
        rng_dop_raw: ``[rx, range, vel]`` complex RD cube (all antennas).
        antenna_idxs: (A,) static antenna subset.
        range_idx / vel_idx: (K,) detection indices (padded entries arbitrary).

    Returns:
        (K,) angles in radians (reference :143-214).
    """
    # (A, K) antenna snapshots -> (K, A)
    snap = rng_dop_raw[antenna_idxs][:, range_idx, vel_idx].T
    k = snap.shape[0]
    fft_in = jnp.zeros((k, num_angle_bins), jnp.complex64).at[:, : snap.shape[1]].set(snap)
    spec = jnp.fft.fft(fft_in, axis=1)
    if shift:
        spec = jnp.fft.fftshift(spec, axes=1)
    return angle_bins[jnp.argmax(jnp.abs(spec), axis=1)]


def capon_aoa_angles(
    rng_slow: "mxu.C2",
    antenna_idxs: np.ndarray,
    range_idx: jax.Array,
    angle_bins: jax.Array,
    steering: "mxu.C2",
    *,
    loading: float = 1e-2,
) -> jax.Array:
    """Per-detection angle via Capon/MVDR on the detection's range row.

    The FFT AoA (:func:`aoa_angles`) uses the single Doppler-cell snapshot —
    its resolution is the 4-element Rayleigh beamwidth.  This estimator
    instead forms the *slow-time* covariance of the detection's range row
    (chirps as snapshots — the same model as
    :class:`~mmwave_radar_processing_jax.processors.beamforming.CaponBeamformerProcessor`)
    and takes the argmax of the loaded MVDR spectrum: moving targets
    decorrelate across chirps, so two sources inside one beamwidth that the
    FFT path merges into a single biased angle resolve into separate lobes
    (pinned numerically in ``tests/test_beamform.py::
    test_capon_resolves_what_bartlett_cannot``).

    Args:
        rng_slow: ``[rx, range, chirp]`` split-complex range-DFT'd cube
            (windowed range transform only — no Doppler transform).
        antenna_idxs: (A,) static antenna subset.
        range_idx: (K,) detection range rows (padded entries arbitrary).
        steering: ``(A, M)`` split-complex steering matrix on the angle grid.

    Returns:
        (K,) angles in radians.
    """
    from mmwave_radar_processing_jax.ops import beamform as bf

    sub_re = rng_slow.re[antenna_idxs]  # (A, R, C)
    sub_im = rng_slow.im[antenna_idxs]
    snaps = mxu.C2(
        jnp.moveaxis(sub_re[:, range_idx], 0, 1),  # (K, A, C)
        jnp.moveaxis(sub_im[:, range_idx], 0, 1),
    )
    r = bf.spatial_covariance(snaps)  # (K, A, A)
    p = bf.capon_from_covariance(r, steering, loading=loading)  # (K, M)
    return angle_bins[jnp.argmax(p, axis=1)]


@jax.jit
def spherical_to_cartesian_flu(
    ranges: jax.Array, az: jax.Array, el: jax.Array, vel: jax.Array
) -> jax.Array:
    """(K, 4) FLU points from spherical detections (reference :216-248)."""
    x = ranges * jnp.cos(el) * jnp.cos(az)
    y = ranges * jnp.cos(el) * jnp.sin(az)
    z = ranges * jnp.sin(el)
    return jnp.stack([x, y, z, vel], axis=1)


class PointCloudGenerator(Processor):
    """Raw ADC cube -> (x, y, z, vel) point cloud via a composed RD detector."""

    def __init__(
        self,
        config: RadarConfig,
        az_antenna_idxs: Sequence[int],
        el_antenna_idxs: Sequence[int],
        detector_type: str = "range_doppler_detector_2d",
        detector_params: Optional[Dict] = None,
        shift_az_resp: bool = True,
        shift_el_resp: bool = False,
        num_angle_bins: int = 64,
        aoa_method: str = "fft",
        diagonal_loading: float = 1e-2,
        **kwargs,
    ):
        """``aoa_method``: per-detection angle estimator — ``"fft"`` (the
        reference's zero-padded snapshot FFT, :143-214) or ``"capon"``
        (slow-time-covariance MVDR at the detection's range row — super-
        resolution beyond the 4-element beamwidth; see
        :func:`capon_aoa_angles`)."""
        super().__init__(config)
        if aoa_method not in ("fft", "capon"):
            raise ValueError(f"unknown aoa_method: {aoa_method!r}")
        self.aoa_method = aoa_method
        self.diagonal_loading = diagonal_loading
        self.az_antenna_idxs = np.asarray(az_antenna_idxs if az_antenna_idxs is not None else [], int)
        self.el_antenna_idxs = np.asarray(el_antenna_idxs if el_antenna_idxs is not None else [], int)
        self.shift_az_resp = shift_az_resp
        self.shift_el_resp = shift_el_resp
        self.num_angle_bins = num_angle_bins
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)

        if aoa_method == "capon":
            from mmwave_radar_processing_jax.ops import beamform as bf

            ns = config.num_adc_samples
            self._rng_factors = mxu.dft_factors(ns, window=windows.hanning(ns))
            self._az_steering = bf.steering_ula(
                grids.phase_shift_bins(num_angle_bins),
                len(self.az_antenna_idxs) or 1)
            self._el_steering = bf.steering_ula(
                grids.phase_shift_bins(num_angle_bins),
                len(self.el_antenna_idxs) or 1)

        registry = get_range_doppler_detector_registry()
        if detector_type not in registry:
            raise ValueError(
                f"Unknown detector type: {detector_type}. Available: {list(registry)}"
            )
        self.detector = registry[detector_type](config, **(detector_params or {}))

    # ------------------------------------------------------------------ #
    def angles_for_detections(self, rng_dop_raw: jax.Array, dets: Detections):
        """(az, el) angles for a padded detection set."""
        ab = jnp.asarray(self.angle_bins)
        if self.az_antenna_idxs.size > 0:
            az = aoa_angles(
                rng_dop_raw, jnp.asarray(self.az_antenna_idxs), dets.range_idx,
                dets.vel_idx, ab, num_angle_bins=self.num_angle_bins,
                shift=self.shift_az_resp,
            )
        else:
            az = jnp.zeros(dets.range_idx.shape, jnp.float32)
        if self.el_antenna_idxs.size > 0:
            el = aoa_angles(
                rng_dop_raw, jnp.asarray(self.el_antenna_idxs), dets.range_idx,
                dets.vel_idx, ab, num_angle_bins=self.num_angle_bins,
                shift=self.shift_el_resp,
            )
        else:
            el = jnp.zeros(dets.range_idx.shape, jnp.float32)
        return az, el

    def _capon_angles_for_detections(self, rng_slow: mxu.C2, dets: Detections):
        """(az, el) via MVDR on each detection's range row (chirp snapshots)."""
        ab = jnp.asarray(self.angle_bins)
        az = (capon_aoa_angles(rng_slow, self.az_antenna_idxs, dets.range_idx,
                               ab, self._az_steering,
                               loading=self.diagonal_loading)
              if self.az_antenna_idxs.size
              else jnp.zeros(dets.range_idx.shape, jnp.float32))
        el = (capon_aoa_angles(rng_slow, self.el_antenna_idxs, dets.range_idx,
                               ab, self._el_steering,
                               loading=self.diagonal_loading)
              if self.el_antenna_idxs.size
              else jnp.zeros(dets.range_idx.shape, jnp.float32))
        return az, el

    def point_cloud(self, adc_cube: jax.Array, **kwargs) -> PointCloud:
        """Pure device pipeline: cube -> padded point cloud (no host syncs)."""
        from mmwave_radar_processing_jax.processors.range_doppler import (
            range_doppler_map,
        )

        raw = range_doppler_map(adc_cube)
        dets = self.detector.detections(adc_cube, rng_dop_raw=raw, **kwargs)
        if self.aoa_method == "capon":
            rng_slow = mxu.dft_apply(mxu.from_complex(adc_cube),
                                     self._rng_factors, axis=-2)
            az, el = self._capon_angles_for_detections(rng_slow, dets)
        else:
            az, el = self.angles_for_detections(raw, dets)
        ranges = jnp.asarray(self.detector.range_bins)[dets.range_idx]
        vels = jnp.asarray(self.detector.vel_bins)[dets.vel_idx]
        pts = spherical_to_cartesian_flu(ranges, az, el, vels)
        pts = jnp.where(dets.valid[:, None], pts, 0.0)
        return PointCloud(pts, dets.valid, dets.count)

    def process(self, adc_cube: jax.Array, **kwargs) -> np.ndarray:
        """Reference-compatible API: (N, 4) numpy point cloud."""
        pc = self.point_cloud(adc_cube, **kwargs)
        valid = np.asarray(pc.valid)
        return np.asarray(pc.points)[valid]

    def reset(self):
        self.detector.reset()
        super().reset()
