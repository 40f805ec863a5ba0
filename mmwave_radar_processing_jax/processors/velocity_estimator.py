"""ADC-domain ego-velocity estimation from Doppler-azimuth responses.

Re-design of ``processors/velocity_estimator.py`` (865 LoC in the
reference).  The estimator:

1. builds azimuth / elevation Doppler-azimuth responses over an
   altitude-centered range window using geometry-specific antenna subsets
   (ODS: two 4-antenna sub-arrays averaged; standard: the 8/4-element line —
   reference :169-259);
2. reads ``vx`` off the zero-azimuth Doppler peak (reference :640-661);
3. optionally recomputes both responses with a zoom FFT centered at ``-vx``
   (precise pass, reference :831-847);
4. fits ``vd = -vx cos(theta) - vy sin(theta)`` to per-row (angle, velocity)
   peaks with RANSAC — the standard model for ``vx >= 0.1``, the inverted
   small-vx model otherwise (reference :346-506);
5. gates the proposed estimate on R^2 / inlier-fraction thresholds
   (reference :597-638).

The response/peak stages are the jitted kernels from
:mod:`~mmwave_radar_processing_jax.processors.doppler_azimuth`; RANSAC is the
deterministic vmapped fit from :mod:`~mmwave_radar_processing_jax.ops.ransac`
(same contract as the reference's sklearn RANSAC, different PRNG stream).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.ops.ransac import ransac_linear
from mmwave_radar_processing_jax.processors.doppler_azimuth import DopplerAzimuthProcessor

# antenna subsets per geometry (reference velocity_estimator.py:169-259)
ODS_AZ_SETS_VIRTUAL = ([0, 3, 4, 7], [1, 2, 5, 6])
ODS_AZ_SETS_PLAIN = ([0, 3], [1, 2])
ODS_EL_SETS_VIRTUAL = ([10, 11, 6, 7], [9, 8, 5, 4])
ODS_EL_SETS_PLAIN = ([1, 0], [3, 4])


class VelocityEstimator(DopplerAzimuthProcessor):
    """Ego-velocity estimator over Doppler-azimuth responses (x fwd, y left)."""

    def __init__(
        self,
        config: RadarConfig,
        lower_range_bound: float,
        upper_range_bound: float,
        precise_vel_bound: float = 0.25,
        valid_angle_range: Sequence[float] = (np.deg2rad(-70), np.deg2rad(70)),
        peak_threshold_dB: float = 30.0,
        x_measurement_only: bool = False,
        min_R2_threshold: float = 0.6,
        min_inlier_percent: float = 0.75,
        seed: int = 42,
        vy_mode: str = "adc",
        **kwargs,
    ):
        """``vy_mode`` (beyond the reference):

        - ``"adc"`` (default): bit-compatible reference behavior — vy from
          the RANSAC row-peak fit of the Doppler-azimuth response
          (reference ``velocity_estimator.py:663-692``).  On standard
          outward geometry this fit is a weak vy estimator: RMSE ~1.58 m/s
          on the 16-recording suite, for BOTH implementations (the row
          peaks constrain mostly the radial component).
        - ``"hybrid_points"`` (standard geometry): keep the deterministic
          ADC zero-azimuth vx readout, but fit vy from the point cloud with
          vx held fixed — a 1D RANSAC on
          ``-vel - u_x*vx = u_y*vy`` (u = normalized 2D direction), the
          same robustness envelope (threshold 0.15, 20 trials, 10 samples).
          ``process`` then needs BOTH ``adc_cube`` and ``points``.
          Measured on the 16-recording suite: vy RMSE 1.58 -> <0.1 m/s
          (tests/test_accuracy_adc.py hybrid leg).  Documented divergence:
          no reference counterpart — its ADC and points paths never share a
          frame.
        """
        super().__init__(
            config, num_angle_bins=64, valid_angle_range=np.asarray(valid_angle_range)
        )
        self.lower_range_bound = lower_range_bound
        self.upper_range_bound = upper_range_bound
        self.precise_vel_bound = precise_vel_bound
        self.peak_threshold_dB = peak_threshold_dB
        self.x_measurement_only = x_measurement_only
        self.min_R2_threshold = min_R2_threshold
        self.min_inlier_percent = min_inlier_percent
        if vy_mode not in ("adc", "hybrid_points"):
            raise ValueError(f"unknown vy_mode {vy_mode!r}")
        if vy_mode == "hybrid_points" and config.array_geometry != "standard":
            raise ValueError("vy_mode='hybrid_points' is standard-geometry "
                             "only (the ODS path estimates vy per sub-array)")
        self.vy_mode = vy_mode
        self._key = jax.random.PRNGKey(seed)

        # latest responses / peaks (reference-compatible attribute surface)
        self.azimuth_response_mag = None
        self.elevation_response_mag = None
        self.precise_azimuth_response_mag = None
        self.precise_elevation_response_mag = None
        self.azimuth_peaks = np.empty((0, 2))
        self.elevation_peaks = np.empty((0, 2))
        self.azimuth_peak_zero_az = np.empty(0)
        self.elevation_peak_zero_az = np.empty(0)

        self.ego_vx_estimate = -1.0
        # Explicit input-path flag for the standard-geometry gate: the
        # reference distinguishes the points path by control flow
        # (velocity_estimator.py:694-721 vs :663-692); a sign test on
        # ego_vx_estimate would mis-gate a genuine small negative vx.
        # Starts True to match the pre-first-frame state (no ADC seen yet).
        self._points_path = True
        self.azimuth_ego_vy_estimate = 0.0
        self.azimuth_estimate_R2 = 0.0
        self.azimuth_inlier_percent = 0.0
        self.elevation_ego_vy_estimate = 0.0
        self.elevation_estimate_R2 = 0.0
        self.elevation_inlier_percent = 0.0
        self.proposed_velocity_estimate = np.empty(0)
        self.current_velocity_estimate = np.array([0.0, 0.0, 0.0])
        self.history_R2_statistics = []
        self.history_inlier_statistics = []

    # ------------------------------------------------------------------ #
    def get_range_window(self, altitude: float = 0.0, sensing_direction: str = "down"):
        """Altitude-centered range window (reference :129-153)."""
        if sensing_direction == "down":
            return np.array(
                [
                    max(0.0, altitude - self.lower_range_bound),
                    min(self.config.range_max_m, altitude + self.upper_range_bound),
                ]
            )
        return np.array([1.0, self.config.range_max_m])

    def _subset_response(
        self, adc_cube, rx_sets, range_window, shift_angle, use_precise, center_vel
    ):
        """Average the Doppler-azimuth responses of the given antenna subsets."""
        precise_range = np.array(
            [center_vel - self.precise_vel_bound, center_vel + self.precise_vel_bound]
        )
        resps, bins, row_valid = [], None, None
        for rx in rx_sets:
            out = super().process(
                adc_cube,
                rx_antennas=rx,
                range_window=range_window,
                shift_angle=shift_angle,
                use_precise_fft=use_precise,
                precise_vel_range=precise_range,
            )
            if use_precise:
                resp, bins, row_valid = out
            else:
                resp = out
            resps.append(resp)
        avg = sum(resps) / len(resps)
        return avg, bins, row_valid

    def _az_sets(self):
        if self.config.array_geometry == "ods":
            return (
                ODS_AZ_SETS_VIRTUAL
                if self.config.virtual_antennas_enabled
                else ODS_AZ_SETS_PLAIN
            )
        n = 8 if self.config.virtual_antennas_enabled else 4
        return (list(range(n)),)

    def _el_sets(self):
        if self.config.array_geometry != "ods":
            raise NotImplementedError(
                "Elevation response requires the ODS array geometry."
            )
        return (
            ODS_EL_SETS_VIRTUAL
            if self.config.virtual_antennas_enabled
            else ODS_EL_SETS_PLAIN
        )

    def compute_azimuth_response(
        self, adc_cube, range_window, use_precise_fft=False, precise_fft_center_vel=0.0
    ):
        resp, bins, row_valid = self._subset_response(
            adc_cube, self._az_sets(), range_window, True, use_precise_fft,
            precise_fft_center_vel,
        )
        if use_precise_fft:
            self.precise_azimuth_response_mag = resp
            self.zoomed_vel_bins = bins
            self.zoomed_vel_valid = row_valid
        else:
            self.azimuth_response_mag = resp

    def compute_elevation_response(
        self, adc_cube, range_window, use_precise_fft=False, precise_fft_center_vel=0.0
    ):
        resp, bins, row_valid = self._subset_response(
            adc_cube, self._el_sets(), range_window, False, use_precise_fft,
            precise_fft_center_vel,
        )
        if use_precise_fft:
            self.precise_elevation_response_mag = resp
            self.zoomed_vel_bins = bins
            self.zoomed_vel_valid = row_valid
        else:
            self.elevation_response_mag = resp

    # ------------------------------------------------------------------ #
    def _peaks_for(self, resp, precise: bool):
        bins = self.zoomed_vel_bins if precise else jnp.asarray(self.vel_bins)
        row_valid = self.zoomed_vel_valid if precise else None
        angles, vels, valid = self.detect_peaks_rows(
            resp, bins, min_threshold_dB=self.peak_threshold_dB, row_valid=row_valid
        )
        valid = np.asarray(valid)
        return np.stack(
            [np.asarray(angles)[valid], np.asarray(vels)[valid]], axis=1
        )

    def _zero_az_for(self, resp, precise: bool):
        bins = self.zoomed_vel_bins if precise else jnp.asarray(self.vel_bins)
        row_valid = self.zoomed_vel_valid if precise else None
        vel, found = self.detect_peak_zero_az(
            resp, bins, min_threshold_dB=self.peak_threshold_dB, row_valid=row_valid
        )
        return np.array([0.0, float(vel)]) if bool(found) else np.empty(0)

    def detect_vel_row_peaks(self, use_precise_response=False):
        az = (
            self.precise_azimuth_response_mag
            if use_precise_response
            else self.azimuth_response_mag
        )
        el = (
            self.precise_elevation_response_mag
            if use_precise_response
            else self.elevation_response_mag
        )
        if az is not None:
            self.azimuth_peaks = self._peaks_for(az, use_precise_response)
        if el is not None:
            self.elevation_peaks = self._peaks_for(el, use_precise_response)

    def detect_vel_zero_az_peaks(self, use_precise_response=False):
        az = (
            self.precise_azimuth_response_mag
            if use_precise_response
            else self.azimuth_response_mag
        )
        el = (
            self.precise_elevation_response_mag
            if use_precise_response
            else self.elevation_response_mag
        )
        if az is not None:
            self.azimuth_peak_zero_az = self._zero_az_for(az, use_precise_response)
        if el is not None:
            self.elevation_peak_zero_az = self._zero_az_for(el, use_precise_response)

    def estimate_ego_vx_velocity(self) -> float:
        """vx from zero-azimuth peaks: ``-mean`` of available sides (ref :640-661)."""
        az, el = self.azimuth_peak_zero_az, self.elevation_peak_zero_az
        if az.shape[0] > 0 and el.shape[0] > 0:
            self.ego_vx_estimate = -0.5 * (az[1] + el[1])
        elif az.shape[0] > 0:
            self.ego_vx_estimate = -az[1]
        elif el.shape[0] > 0:
            self.ego_vx_estimate = -el[1]
        else:
            self.ego_vx_estimate = 0.0
        return self.ego_vx_estimate

    # RANSAC fits ------------------------------------------------------- #
    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def lsq_fit_ego_vy_ransac(self, peaks: np.ndarray):
        if self.ego_vx_estimate >= 0.1:
            return self.lsq_fit_ego_vy_ransac_standard(peaks)
        return self.lsq_fit_ego_vy_ransac_small_vx(peaks)

    def lsq_fit_ego_vy_ransac_standard(self, peaks: np.ndarray):
        """``-vd - vx cos(theta) = vy sin(theta)`` RANSAC fit (ref :409-455)."""
        if peaks is None or len(peaks) == 0:
            return 0.0, 0.0, 0.0
        y = -peaks[:, 1] - self.ego_vx_estimate * np.cos(peaks[:, 0])
        h = np.sin(peaks[:, 0])[:, None]
        res = ransac_linear(
            h, y, np.ones(len(y), bool), self._next_key(),
            min_samples=10, residual_threshold=0.15, max_trials=20,
        )
        return float(res.coef[0]), float(res.r2), float(res.inlier_fraction)

    def lsq_fit_ego_vy_ransac_small_vx(self, peaks: np.ndarray):
        """Inverted small-vx model ``theta = -(1/vy)(vd - vx)`` (ref :457-506)."""
        if peaks is None or len(peaks) == 0:
            return 0.0, 0.0, 0.0
        y = peaks[:, 0]
        h = (peaks[:, 1] - self.ego_vx_estimate)[:, None]
        res = ransac_linear(
            h, y, np.ones(len(y), bool), self._next_key(),
            min_samples=10, residual_threshold=0.20, max_trials=20,
        )
        a = float(res.coef[0])
        ego_vy = -1.0 / a if (res.ok and a != 0.0) else 0.0
        return ego_vy, float(res.r2), float(res.inlier_fraction)

    def lsq_fit_ego_vel_ransac_points(self, points: np.ndarray):
        """2D points fit ``-vel = (p/|p|) . v`` (ref :361-407)."""
        if points.shape[0] == 0:
            return np.zeros(2), 0.0, 0.0
        y = -points[:, 3]
        h = points[:, 0:2] / np.linalg.norm(points[:, 0:2], axis=1, keepdims=True)
        res = ransac_linear(
            h, y, np.ones(len(y), bool), self._next_key(),
            min_samples=10, residual_threshold=0.15, max_trials=20,
        )
        return np.asarray(res.coef), float(res.r2), float(res.inlier_fraction)

    def lsq_fit_ego_vy_ransac_points_fixed_vx(self, points: np.ndarray,
                                              vx: float):
        """Hybrid vy: 1D points RANSAC with the ADC vx held fixed.

        Model: ``vel = -(u . v)`` with ``u = p_2d/|p_2d|`` gives
        ``-vel - u_x*vx = u_y*vy`` — one robust parameter, the reference's
        RANSAC envelope (threshold 0.15, 20 trials, 10 samples).  See
        ``vy_mode`` in the constructor docstring.
        """
        if points.shape[0] == 0:
            return 0.0, 0.0, 0.0
        # fixed-capacity point clouds zero-pad invalid rows
        # (parallel/pipeline.py: ``where(valid, pts, 0)``) — a zero-norm row
        # would NaN the normalization and poison every RANSAC trial, so mask
        # them out instead of dividing by their norm
        norms = np.linalg.norm(points[:, 0:2], axis=1)
        live = norms > 0.0
        u = points[:, 0:2] / np.where(norms, norms, 1.0)[:, None]
        y = np.where(live, -points[:, 3] - u[:, 0] * vx, 0.0)
        h = u[:, 1:2]
        res = ransac_linear(
            h, y, live, self._next_key(),
            min_samples=10, residual_threshold=0.15, max_trials=20,
        )
        return float(res.coef[0]), float(res.r2), float(res.inlier_fraction)

    def lsq_predict_velocity_measurement(self, v, angles_to_predict=None):
        """Predicted vd per angle for an ego velocity [vx, vy] (ref :536-554)."""
        if angles_to_predict is None or np.size(angles_to_predict) == 0:
            angles_to_predict = self.valid_angle_bins
        h = np.stack(
            [np.cos(angles_to_predict), np.sin(angles_to_predict)], axis=-1
        )
        return -h @ np.asarray(v)

    # estimate assembly + gating ---------------------------------------- #
    def estimate_ego_velocity_adc_data(self):
        if not self.x_measurement_only:
            if self.azimuth_peaks.shape[0] > 0:
                (
                    self.azimuth_ego_vy_estimate,
                    self.azimuth_estimate_R2,
                    self.azimuth_inlier_percent,
                ) = self.lsq_fit_ego_vy_ransac(self.azimuth_peaks)
            if self.elevation_peaks.shape[0] > 0:
                (
                    self.elevation_ego_vy_estimate,
                    self.elevation_estimate_R2,
                    self.elevation_inlier_percent,
                ) = self.lsq_fit_ego_vy_ransac(self.elevation_peaks)
            if self.config.array_geometry == "ods":
                self.proposed_velocity_estimate = np.array(
                    [
                        self.azimuth_ego_vy_estimate,
                        self.elevation_ego_vy_estimate,
                        self.ego_vx_estimate,
                    ]
                )
            else:
                self.proposed_velocity_estimate = np.array(
                    [self.ego_vx_estimate, self.azimuth_ego_vy_estimate, 0.0]
                )
        else:
            self.proposed_velocity_estimate = np.array([self.ego_vx_estimate])

    def estimate_ego_velocity_points(self, points: np.ndarray):
        if self.config.array_geometry != "standard":
            raise NotImplementedError(
                "points-based estimation is standard-geometry only (ref :694-721)"
            )
        vel_est, self.azimuth_estimate_R2, self.azimuth_inlier_percent = (
            self.lsq_fit_ego_vel_ransac_points(points)
        )
        if self.x_measurement_only:
            self.proposed_velocity_estimate = np.array([vel_est[0]])
        else:
            self.proposed_velocity_estimate = np.array([vel_est[0], vel_est[1], 0.0])

    def update_and_check_current_vel_measurements(self):
        """R^2 / inlier gates per axis (reference :597-638).

        Intentional divergence: the reference distinguishes the points path
        by the sign test ``ego_vx_estimate < 0.0`` (reference :623, comment
        "used points to estimate vel"), which mis-gates a genuine negative
        vx measured from an ADC cube — the whole estimate is zeroed as if it
        came from points with a failed fit.  We gate on the explicit
        ``_points_path`` input flag instead, so a negative ADC-path vx is
        kept (only vy is R^2-gated, per the ADC branch at reference
        :630-638).  ``tests/test_parity_standard_geometry.py`` pins both
        behaviors.
        """
        if self.x_measurement_only:
            self.current_velocity_estimate[0] = self.proposed_velocity_estimate[0]
            return
        if self.config.array_geometry == "ods":
            if (
                self.azimuth_estimate_R2 >= self.min_R2_threshold
                and self.azimuth_inlier_percent >= self.min_inlier_percent
            ):
                self.current_velocity_estimate[0] = self.proposed_velocity_estimate[0]
            else:
                self.current_velocity_estimate[0] = 0.0
            if (
                self.elevation_estimate_R2 >= self.min_R2_threshold
                and self.elevation_inlier_percent >= self.min_inlier_percent
            ):
                self.current_velocity_estimate[1] = self.proposed_velocity_estimate[1]
            else:
                self.current_velocity_estimate[1] = 0.0
            self.current_velocity_estimate[2] = self.proposed_velocity_estimate[2]
        else:
            if self._points_path:
                if self.azimuth_estimate_R2 >= self.min_R2_threshold:
                    self.current_velocity_estimate = self.proposed_velocity_estimate.copy()
                else:
                    self.current_velocity_estimate = np.zeros(3)
            else:
                if self.azimuth_estimate_R2 >= self.min_R2_threshold:
                    self.current_velocity_estimate[1] = self.proposed_velocity_estimate[1]
                else:
                    self.current_velocity_estimate[1] = 0.0
                self.current_velocity_estimate[0] = self.proposed_velocity_estimate[0]
                self.current_velocity_estimate[2] = 0.0

    def update_history(self, estimated=None, ground_truth=None):
        self.history_R2_statistics.append(
            np.array([self.azimuth_estimate_R2, self.elevation_estimate_R2])
        )
        self.history_inlier_statistics.append(
            np.array([self.azimuth_inlier_percent, self.elevation_inlier_percent])
        )
        super().update_history(estimated, ground_truth)

    # ------------------------------------------------------------------ #
    def process(
        self,
        adc_cube: Optional[np.ndarray] = None,
        points: Optional[np.ndarray] = None,
        altitude: float = 0.0,
        enable_precise_responses: bool = False,
        **kwargs,
    ) -> np.ndarray:
        """Velocity estimate ``[vx, vy, vz]`` (reference ``process`` :785-866).

        ODS output ordering is ``[az_vy, el_vy, vx]`` in the array frame
        (reference :679-684).
        """
        if adc_cube is not None and np.size(adc_cube) > 0:
            self._points_path = False
            range_window = self.get_range_window(
                altitude=altitude, sensing_direction=self.config.array_direction
            )
            self.compute_azimuth_response(adc_cube, range_window)
            if self.config.array_geometry == "ods":
                self.compute_elevation_response(adc_cube, range_window)
            self.detect_vel_zero_az_peaks(use_precise_response=False)
            self.estimate_ego_vx_velocity()

            if enable_precise_responses:
                self.compute_azimuth_response(
                    adc_cube, range_window, use_precise_fft=True,
                    precise_fft_center_vel=-self.ego_vx_estimate,
                )
                if self.config.array_geometry == "ods":
                    self.compute_elevation_response(
                        adc_cube, range_window, use_precise_fft=True,
                        precise_fft_center_vel=-self.ego_vx_estimate,
                    )
                self.detect_vel_zero_az_peaks(use_precise_response=True)
                self.estimate_ego_vx_velocity()

            if not self.x_measurement_only:
                self.detect_vel_row_peaks(use_precise_response=enable_precise_responses)
            self.estimate_ego_velocity_adc_data()
            if (self.vy_mode == "hybrid_points" and points is not None
                    and np.size(points) > 0 and not self.x_measurement_only):
                # hybrid leg: override the weak row-peak vy with the
                # vx-constrained points fit; the standard-geometry gate then
                # R^2-gates vy and keeps the deterministic vx unchanged
                (self.azimuth_ego_vy_estimate,
                 self.azimuth_estimate_R2,
                 self.azimuth_inlier_percent) = (
                    self.lsq_fit_ego_vy_ransac_points_fixed_vx(
                        np.asarray(points), float(self.ego_vx_estimate)))
                self.proposed_velocity_estimate = np.array(
                    [self.ego_vx_estimate, self.azimuth_ego_vy_estimate, 0.0])
        elif points is not None and np.size(points) > 0:
            self._points_path = True
            self.estimate_ego_velocity_points(np.asarray(points))

        self.update_and_check_current_vel_measurements()
        return self.current_velocity_estimate

    def reset(self):
        self.history_R2_statistics = []
        self.history_inlier_statistics = []
        super().reset()
