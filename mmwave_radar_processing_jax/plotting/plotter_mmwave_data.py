"""Per-frame mmWave response plotting (reference ``plotter_mmWave_data.py``).

All methods draw onto a provided ``matplotlib`` Axes (or create one), render
magnitudes in dB with a ``max - min_threshold_dB`` floor, and use the
processors' precomputed mesh grids for physical-unit extents — the same
conventions as the reference (:36-860).  Device arrays are accepted directly;
they are pulled to host at render time only.
"""

from __future__ import annotations

from typing import Optional

import matplotlib.pyplot as plt
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig


def _to_db(mag: np.ndarray, min_threshold_dB: float = 40.0) -> np.ndarray:
    db = 20.0 * np.log10(np.abs(np.asarray(mag)) + 1e-12)
    return np.maximum(db, db.max() - min_threshold_dB)


def _ensure_ax(ax):
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=(5, 4))
    return ax


class PlotterMmWaveData:
    """Dashboard plotting for the processor family."""

    def __init__(
        self,
        config: RadarConfig,
        min_threshold_dB: float = 40.0,
        font_size: int = 10,
    ):
        self.config = config
        self.min_threshold_dB = min_threshold_dB
        self.font_size = font_size

    # heatmaps ----------------------------------------------------------- #
    def plot_range_azimuth_heatmap_cart(self, resp_mag, processor, ax=None,
                                        convert_to_dB: bool = True):
        """Cartesian range-azimuth heatmap on the processor's (x, y) mesh."""
        ax = _ensure_ax(ax)
        data = _to_db(resp_mag, self.min_threshold_dB) if convert_to_dB else np.asarray(resp_mag)
        m = ax.pcolormesh(processor.y_s, processor.x_s, data, shading="gouraud",
                          cmap="viridis")
        ax.set_xlabel("y (m)", fontsize=self.font_size)
        ax.set_ylabel("x (m)", fontsize=self.font_size)
        ax.set_title("Range-Azimuth (cart)", fontsize=self.font_size)
        return m

    def plot_range_azimuth_heatmap_polar(self, resp_mag, processor, ax=None,
                                         convert_to_dB: bool = True):
        ax = _ensure_ax(ax)
        data = _to_db(resp_mag, self.min_threshold_dB) if convert_to_dB else np.asarray(resp_mag)
        extent = [np.rad2deg(processor.angle_bins[0]),
                  np.rad2deg(processor.angle_bins[-1]),
                  processor.range_bins[0], processor.range_bins[-1]]
        m = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                      cmap="viridis")
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("range (m)", fontsize=self.font_size)
        ax.set_title("Range-Azimuth (polar)", fontsize=self.font_size)
        return m

    def plot_range_doppler_heatmap(self, rd_mag, processor, ax=None,
                                   convert_to_dB: bool = True):
        ax = _ensure_ax(ax)
        data = _to_db(rd_mag, self.min_threshold_dB) if convert_to_dB else np.asarray(rd_mag)
        extent = [processor.vel_bins[0], processor.vel_bins[-1],
                  processor.range_bins[0], processor.range_bins[-1]]
        m = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                      cmap="viridis")
        ax.set_xlabel("velocity (m/s)", fontsize=self.font_size)
        ax.set_ylabel("range (m)", fontsize=self.font_size)
        ax.set_title("Range-Doppler", fontsize=self.font_size)
        return m

    def plot_micro_doppler(self, micro_resp, processor, ax=None,
                           convert_to_dB: bool = True):
        ax = _ensure_ax(ax)
        data = _to_db(micro_resp, self.min_threshold_dB) if convert_to_dB else np.asarray(micro_resp)
        extent = [processor.time_bins[0], processor.time_bins[-1],
                  processor.vel_bins[0], processor.vel_bins[-1]]
        m = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                      cmap="viridis")
        ax.set_xlabel("history (s)", fontsize=self.font_size)
        ax.set_ylabel("velocity (m/s)", fontsize=self.font_size)
        ax.set_title("Micro-Doppler", fontsize=self.font_size)
        return m

    def plot_doppler_azimuth(self, resp_mag, processor, ax=None,
                             convert_to_dB: bool = True, peaks=None,
                             gt_predictions=None, vel_bins=None,
                             vd_ground_truth=None, vd_estimated=None,
                             title: str = "Doppler-Azimuth"):
        """Doppler-azimuth map with optional peak / GT / estimate overlays.

        Overlay contract matches the reference ``plot_doppler_az_resp``
        (``plotter_mmWave_data.py:324-425``): ``peaks`` are ``(angle_rad,
        vel)`` rows drawn as red crosses; ``vd_ground_truth`` /
        ``vd_estimated`` are per-valid-angle velocity-measurement curves
        (from ``get_gt_velocity_measurement_predictions`` /
        ``get_estimated_velocity_measurement_predictions``) drawn orange /
        white.  ``gt_predictions`` is a legacy alias of ``vd_ground_truth``.
        """
        ax = _ensure_ax(ax)
        data = _to_db(resp_mag, self.min_threshold_dB) if convert_to_dB else np.asarray(resp_mag)
        vb = np.asarray(vel_bins) if vel_bins is not None else processor.vel_bins
        extent = [np.rad2deg(processor.valid_angle_bins[0]),
                  np.rad2deg(processor.valid_angle_bins[-1]),
                  vb[0], vb[-1]]
        m = ax.imshow(data, aspect="auto", origin="lower", extent=extent,
                      cmap="viridis")
        if peaks is not None and np.size(peaks):
            peaks = np.atleast_2d(np.asarray(peaks))
            ax.scatter(np.rad2deg(peaks[:, 0]), peaks[:, 1], c="r", marker="x",
                       s=20, label="Detected Peaks")
        if vd_ground_truth is None:
            vd_ground_truth = gt_predictions
        angles_deg = np.rad2deg(np.asarray(processor.valid_angle_bins))
        if vd_ground_truth is not None and np.size(vd_ground_truth):
            ax.plot(angles_deg, np.asarray(vd_ground_truth), color="orange",
                    lw=2, label="Ground Truth Velocity")
        if vd_estimated is not None and np.size(vd_estimated):
            ax.plot(angles_deg, np.asarray(vd_estimated), color="white",
                    lw=2, label="Estimated Velocity")
        if ax.get_legend_handles_labels()[0]:
            ax.legend(fontsize=self.font_size - 2)
        ax.set_xlabel("azimuth (deg)", fontsize=self.font_size)
        ax.set_ylabel("velocity (m/s)", fontsize=self.font_size)
        ax.set_ylim(float(vb.min()), float(vb.max()))
        ax.set_title(title, fontsize=self.font_size)
        return m

    def plot_zoomed_doppler_azimuth(self, resp_mag, processor, ax=None,
                                    convert_to_dB: bool = True, peaks=None,
                                    vd_ground_truth=None, vd_estimated=None):
        """Precise (zoom-FFT) Doppler-azimuth map on ``zoomed_vel_bins``.

        Counterpart of the reference ``plot_zoomed_doppler_az_resp``
        (``plotter_mmWave_data.py:427-531``): same overlays as the coarse
        panel but the velocity axis is the zoom grid the precise pass
        produced (``processor.zoomed_vel_bins``).
        """
        if processor.zoomed_vel_bins is None:
            raise ValueError(
                "no zoomed velocity grid: run the processor with "
                "use_precise_fft=True before plotting the zoomed response"
            )
        resp_mag = np.asarray(resp_mag)
        row_valid = getattr(processor, "zoomed_vel_valid", None)
        if row_valid is not None:
            # fixed-capacity zoom rows: blank the invalid rows (they hold
            # padding, not measurements) so the dB floor renders them dark
            resp_mag = np.where(np.asarray(row_valid)[:, None], resp_mag, 0.0)
        return self.plot_doppler_azimuth(
            resp_mag, processor, ax=ax, convert_to_dB=convert_to_dB,
            peaks=peaks, vd_ground_truth=vd_ground_truth,
            vd_estimated=vd_estimated,
            vel_bins=np.asarray(processor.zoomed_vel_bins),
            title="Zoomed Doppler-Azimuth",
        )

    # 1D ----------------------------------------------------------------- #
    def plot_range_profile(self, rng_resp, processor, ax=None,
                           peaks_m=None, peak_vals=None, thresholds=None):
        ax = _ensure_ax(ax)
        db = 20.0 * np.log10(np.abs(np.asarray(rng_resp)) + 1e-12)
        ax.plot(processor.range_bins, db, label="profile")
        if thresholds is not None:
            thr = 20.0 * np.log10(np.maximum(np.asarray(thresholds), 1e-12))
            finite = np.isfinite(thr)
            ax.plot(np.asarray(processor.range_bins)[finite], thr[finite], "--",
                    label="CFAR threshold")
        if peaks_m is not None and np.size(peaks_m):
            vals = peak_vals if peak_vals is not None else np.interp(
                peaks_m, processor.range_bins, db)
            ax.scatter(peaks_m, vals, c="r", marker="x", label="peaks")
        ax.set_xlabel("range (m)", fontsize=self.font_size)
        ax.set_ylabel("magnitude (dB)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_raw_adc(self, adc_cube, ax=None, rx_idx: int = 0, chirp_idx: int = 0):
        ax = _ensure_ax(ax)
        sig = np.asarray(adc_cube)[rx_idx, :, chirp_idx]
        ax.plot(np.real(sig), label="I")
        ax.plot(np.imag(sig), label="Q")
        ax.set_xlabel("sample", fontsize=self.font_size)
        ax.set_title("Raw ADC", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    # time series --------------------------------------------------------- #
    def plot_estimates_vs_gt(self, est_history, gt_history, ax=None,
                             labels=("x", "y", "z"), frame_period_s: float = 0.05):
        ax = _ensure_ax(ax)
        est = np.asarray(est_history)
        gt = np.asarray(gt_history)
        t = np.arange(est.shape[0]) * frame_period_s
        for i, lbl in enumerate(labels[: est.shape[1]]):
            ax.plot(t, est[:, i], label=f"est {lbl}")
            ax.plot(t, gt[:, i], "--", label=f"gt {lbl}")
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("velocity (m/s)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2, ncol=3)
        return ax

    def plot_estimate_error(self, est_history, gt_history, ax=None,
                            frame_period_s: float = 0.05):
        ax = _ensure_ax(ax)
        err = np.linalg.norm(np.asarray(est_history) - np.asarray(gt_history), axis=1)
        t = np.arange(err.shape[0]) * frame_period_s
        ax.plot(t, err)
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("|error| (m/s)", fontsize=self.font_size)
        return ax

    # dashboard ----------------------------------------------------------- #
    def plot_compilation(
        self,
        adc_cube,
        range_doppler=None,
        range_angle=None,
        micro_doppler=None,
        doppler_azimuth=None,
        camera_frame=None,
        zoomed_doppler_azimuth=None,
        processors: Optional[dict] = None,
        fig=None,
    ):
        """2x3 dashboard in the reference's panel layout (:738-860).

        Cells: ``[0,0]`` raw ADC, ``[0,1]`` range-Doppler, ``[0,2]``
        Doppler-azimuth, ``[1,0]`` cartesian range-azimuth, ``[1,1]``
        micro-Doppler, ``[1,2]`` camera.  ``processors`` maps panel name ->
        processor (for bins/meshes); missing panels are left blank.

        Extension beyond the reference compilation: when no camera frame is
        available, ``zoomed_doppler_azimuth`` (the precise zoom-FFT response;
        needs ``processors["zoomed_doppler_azimuth"]`` run with
        ``use_precise_fft=True``) fills the ``[1,2]`` cell instead.
        """
        processors = processors or {}
        if fig is None:
            fig = plt.figure(figsize=(15, 10))
        axes = fig.subplots(2, 3)
        fig.subplots_adjust(wspace=0.3, hspace=0.30)
        self.plot_raw_adc(adc_cube, ax=axes[0, 0])
        if range_doppler is not None:
            self.plot_range_doppler_heatmap(range_doppler,
                                            processors["range_doppler"], ax=axes[0, 1])
        if doppler_azimuth is not None:
            self.plot_doppler_azimuth(doppler_azimuth,
                                      processors["doppler_azimuth"], ax=axes[0, 2])
        if range_angle is not None:
            self.plot_range_azimuth_heatmap_cart(range_angle,
                                                 processors["range_angle"], ax=axes[1, 0])
        if micro_doppler is not None:
            self.plot_micro_doppler(micro_doppler,
                                    processors["micro_doppler"], ax=axes[1, 1])
        if camera_frame is not None:
            axes[1, 2].imshow(np.asarray(camera_frame))
            axes[1, 2].set_title("Frontal Camera View", fontsize=self.font_size)
            axes[1, 2].axis("off")
        elif zoomed_doppler_azimuth is not None:
            self.plot_zoomed_doppler_azimuth(
                zoomed_doppler_azimuth,
                processors["zoomed_doppler_azimuth"], ax=axes[1, 2],
            )
        return fig
