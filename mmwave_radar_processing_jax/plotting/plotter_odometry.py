"""Altimeter + odometry dashboards (reference ``plotter_odometry_data.py``)."""

from __future__ import annotations

import matplotlib.pyplot as plt
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig


class PlotterOdometryData:
    """Altimeter (coarse + zoom profiles, altitude track) and velocity panels."""

    def __init__(self, config: RadarConfig, font_size: int = 10):
        self.config = config
        self.font_size = font_size

    def plot_altimeter_profiles(
        self, coarse_mag, range_bins, zoom_mag=None, zoom_bins=None,
        altitude_m=None, peaks_m=None, ax=None,
    ):
        """Coarse (and optional zoom) range profile with the tracked altitude."""
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4))
        db = 20 * np.log10(np.abs(np.asarray(coarse_mag)) + 1e-12)
        ax.plot(np.asarray(range_bins), db, label="coarse")
        if zoom_mag is not None:
            zdb = 20 * np.log10(np.abs(np.asarray(zoom_mag)) + 1e-12)
            ax.plot(np.asarray(zoom_bins), zdb, label="zoom")
        if peaks_m is not None and np.size(peaks_m):
            ax.axvline(np.min(peaks_m), color="g", ls=":", label="ground peak")
        if altitude_m is not None:
            ax.axvline(altitude_m, color="r", ls="--", label="altitude")
        ax.set_xlabel("range (m)", fontsize=self.font_size)
        ax.set_ylabel("magnitude (dB)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_altitude_history(self, est_history, gt_history=None, ax=None,
                              frame_period_s: float = 0.05):
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4))
        est = np.asarray(est_history)
        t = np.arange(est.shape[0]) * frame_period_s
        ax.plot(t, est, label="estimated")
        if gt_history is not None:
            ax.plot(t, np.asarray(gt_history), "--", label="ground truth")
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("altitude (m)", fontsize=self.font_size)
        ax.legend(fontsize=self.font_size - 2)
        return ax

    def plot_altitude_error(self, est_history, gt_history, ax=None,
                            frame_period_s: float = 0.05):
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4))
        err = np.asarray(est_history) - np.asarray(gt_history)
        t = np.arange(err.shape[0]) * frame_period_s
        ax.plot(t, err)
        ax.axhline(0.0, color="k", lw=0.5)
        ax.set_xlabel("time (s)", fontsize=self.font_size)
        ax.set_ylabel("altitude error (m)", fontsize=self.font_size)
        return ax

    def plot_velocity_panels(self, est_history, gt_history, fig=None,
                             frame_period_s: float = 0.05):
        """Per-axis velocity estimate vs ground truth, 3 stacked panels."""
        if fig is None:
            fig = plt.figure(figsize=(8, 8))
        axes = fig.subplots(3, 1, sharex=True)
        est = np.asarray(est_history)
        gt = np.asarray(gt_history)
        t = np.arange(est.shape[0]) * frame_period_s
        for i, lbl in enumerate("xyz"):
            axes[i].plot(t, est[:, i], label="est")
            axes[i].plot(t, gt[:, i], "--", label="gt")
            axes[i].set_ylabel(f"v{lbl} (m/s)", fontsize=self.font_size)
            axes[i].legend(fontsize=self.font_size - 2)
        axes[-1].set_xlabel("time (s)", fontsize=self.font_size)
        fig.tight_layout()
        return fig
