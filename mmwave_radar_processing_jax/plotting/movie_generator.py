"""Movie export: per-frame PNG rendering -> mp4 (reference ``movie_generator.py``).

The base class renders one matplotlib figure per dataset frame into a temp
directory and encodes with imageio/ffmpeg.  ``MmWaveDataMovieGenerator``
replicates the reference dashboard movie (``movies_mmWave_data.py``): ADC +
range-Doppler + range-azimuth + micro-Doppler + Doppler-azimuth per frame,
with NED velocity pulled from odometry columns 8:11.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

# NB: no ``matplotlib.use("Agg")`` here — forcing a backend at import time
# hijacks the notebook inline backend for every consumer of the plotting
# package (headless environments already default to Agg).
import matplotlib.pyplot as plt
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.utils.logger import get_logger


def _ffmpeg_available() -> bool:
    try:
        import imageio_ffmpeg  # noqa: F401

        return True
    except ImportError:
        import shutil as _sh

        return _sh.which("ffmpeg") is not None


def _open_writer_path(out_path: str, logger) -> str:
    """mp4 when an encoder exists, otherwise fall back to GIF."""
    if out_path.endswith(".mp4") and not _ffmpeg_available():
        fallback = out_path[:-4] + ".gif"
        logger.warning("no ffmpeg encoder available; writing %s instead", fallback)
        return fallback
    return out_path


def _open_writer(out_path: str, fps: int):
    import imageio.v2 as imageio

    if out_path.endswith(".gif"):
        return imageio.get_writer(out_path, duration=1.0 / fps)
    # reference encode settings: libx264 quality 8 (video_exporter.py:66)
    return imageio.get_writer(out_path, fps=fps, codec="libx264", quality=8)


class MovieGenerator:
    """Render frames to PNGs, then encode an mp4 (GIF fallback without ffmpeg)."""

    def __init__(self, temp_dir: Optional[str] = None, fps: int = 20):
        self.temp_dir = temp_dir
        self.fps = fps
        self._own_temp = temp_dir is None
        self.frame_paths = []
        self.logger = get_logger(__name__)

    def initialize_temp_directory(self):
        if self._own_temp:
            self.temp_dir = tempfile.mkdtemp(prefix="mmwave_movie_")
        else:
            os.makedirs(self.temp_dir, exist_ok=True)
        self.frame_paths = []

    def save_frame(self, fig, idx: int):
        path = os.path.join(self.temp_dir, f"frame_{idx:06d}.png")
        fig.savefig(path, dpi=80)
        plt.close(fig)
        self.frame_paths.append(path)

    def generate_movie_frame(self, idx: int):
        """Subclass hook: build and return the figure for frame ``idx``."""
        raise NotImplementedError

    def generate_movie_frames(self, num_frames: int, start: int = 0):
        self.initialize_temp_directory()
        for i in range(start, num_frames):
            fig = self.generate_movie_frame(i)
            self.save_frame(fig, i)

    def save_movie(self, out_path: str, fps: Optional[int] = None):
        out_path = _open_writer_path(out_path, self.logger)
        writer = _open_writer(out_path, fps or self.fps)
        import imageio.v2 as imageio

        try:
            for path in self.frame_paths:
                writer.append_data(imageio.imread(path))
        finally:
            writer.close()
        self.logger.info("wrote movie %s (%d frames)", out_path,
                         len(self.frame_paths))
        return out_path

    def cleanup(self):
        if self._own_temp and self.temp_dir and os.path.isdir(self.temp_dir):
            shutil.rmtree(self.temp_dir)


class MmWaveDataMovieGenerator(MovieGenerator):
    """Dashboard movie over a CpslDS dataset (reference ``movies_mmWave_data.py``)."""

    def __init__(self, config: RadarConfig, dataset, plotter, processors: dict,
                 reformatter=None, **kwargs):
        super().__init__(**kwargs)
        self.config = config
        self.dataset = dataset
        self.plotter = plotter
        self.processors = processors
        self.reformatter = reformatter

    def _velocity_ned(self, idx: int) -> np.ndarray:
        """Mean odometry velocity, columns 8:11 (reference :62-69)."""
        if not getattr(self.dataset, "vehicle_odom_enabled", False):
            return np.zeros(3)
        odom = self.dataset.get_vehicle_odom_data(idx)
        return np.mean(odom[:, 8:11], axis=0)

    def generate_movie_frame(self, idx: int):
        adc = self.dataset.get_radar_adc_data(idx)
        if self.reformatter is not None:
            adc = np.asarray(self.reformatter.process(adc))

        panels = {}
        if "range_doppler" in self.processors:
            panels["range_doppler"] = self.processors["range_doppler"].process(
                adc, rx_idx=0
            )
        if "range_angle" in self.processors:
            panels["range_angle"] = self.processors["range_angle"].process(adc)
        if "micro_doppler" in self.processors:
            panels["micro_doppler"] = self.processors["micro_doppler"].process(adc)
        if "doppler_azimuth" in self.processors:
            panels["doppler_azimuth"] = self.processors["doppler_azimuth"].process(adc)
        if "zoomed_doppler_azimuth" in self.processors:
            zoom_resp, _, _ = self.processors[
                "zoomed_doppler_azimuth"
            ].process(adc, use_precise_fft=True)
            panels["zoomed_doppler_azimuth"] = zoom_resp

        camera = None
        if getattr(self.dataset, "camera_enabled", False):
            try:
                camera = self.dataset.get_camera_frame(idx)
            except AssertionError:
                camera = None

        return self.plotter.plot_compilation(
            adc,
            range_doppler=panels.get("range_doppler"),
            range_angle=panels.get("range_angle"),
            micro_doppler=panels.get("micro_doppler"),
            doppler_azimuth=panels.get("doppler_azimuth"),
            camera_frame=camera,
            zoomed_doppler_azimuth=panels.get("zoomed_doppler_azimuth"),
            processors=self.processors,
        )

    def generate(self, out_path: str, num_frames: Optional[int] = None):
        n = num_frames or self.dataset.num_frames
        self.generate_movie_frames(n)
        self.save_movie(out_path)
        self.cleanup()


class OdometryMovieGenerator(MovieGenerator):
    """Altimeter + velocity dashboard movie (reference ``movies_odometry.py``).

    Per frame: altimeter profile with the tracked altitude, the altitude
    history vs ground truth, and per-axis velocity panels.
    """

    def __init__(self, config: RadarConfig, dataset, altimeter, plotter,
                 reformatter=None, velocity_estimator=None,
                 point_cloud_generator=None, **kwargs):
        super().__init__(**kwargs)
        self.config = config
        self.dataset = dataset
        self.altimeter = altimeter
        self.plotter = plotter
        self.reformatter = reformatter
        self.velocity_estimator = velocity_estimator
        self.point_cloud_generator = point_cloud_generator
        self.alt_history = []
        self.vel_history = []
        self.gt_vel_history = []

    def generate_movie_frame(self, idx: int):
        adc = self.dataset.get_radar_adc_data(idx)
        if self.reformatter is not None:
            adc = np.asarray(self.reformatter.process(adc))
        altitude = float(self.altimeter.process(adc))
        self.alt_history.append(altitude)

        gt_vel = np.zeros(3)
        if getattr(self.dataset, "vehicle_odom_enabled", False):
            gt_vel = np.mean(self.dataset.get_vehicle_odom_data(idx)[:, 8:11], axis=0)
        if self.velocity_estimator is not None and self.point_cloud_generator is not None:
            pts = self.point_cloud_generator.process(adc)
            vel = np.asarray(self.velocity_estimator.process(points=pts))
        else:
            vel = np.zeros(3)
        self.vel_history.append(vel)
        self.gt_vel_history.append(gt_vel)

        fig = plt.figure(figsize=(12, 8))
        axes = fig.subplots(2, 2)
        self.plotter.plot_altimeter_profiles(
            np.asarray(self.altimeter.coarse_fft_data), self.altimeter.range_bins,
            altitude_m=altitude, ax=axes[0, 0],
        )
        self.plotter.plot_altitude_history(
            self.alt_history, ax=axes[0, 1],
            frame_period_s=self.config.frame_period_s,
        )
        est = np.asarray(self.vel_history)
        gt = np.asarray(self.gt_vel_history)
        axes[1, 0].plot(est[:, 0], label="est vx")
        axes[1, 0].plot(gt[:, 0], "--", label="gt vx")
        axes[1, 0].legend(fontsize=8)
        axes[1, 1].plot(np.linalg.norm(est - gt, axis=1))
        axes[1, 1].set_title("velocity |error|", fontsize=9)
        fig.tight_layout()
        return fig


class SyntheticArrayMovieGenerator(MovieGenerator):
    """Synthetic-aperture dashboard movie
    (reference ``movies_synthetic_array_data*.py``): feeds the beamformer the
    mean vehicle velocity per frame and renders geometry / beamformed slice /
    cartesian image / array pattern."""

    def __init__(self, config: RadarConfig, dataset, processor, plotter,
                 **kwargs):
        super().__init__(**kwargs)
        self.config = config
        self.dataset = dataset
        self.processor = processor
        self.plotter = plotter

    def _vehicle_vel(self, idx: int) -> np.ndarray:
        if getattr(self.dataset, "vehicle_vel_enabled", False):
            vel = np.asarray(self.dataset.get_vehicle_vel_data(idx))
            return np.mean(np.atleast_2d(vel), axis=0)[:3]
        if getattr(self.dataset, "vehicle_odom_enabled", False):
            return np.mean(self.dataset.get_vehicle_odom_data(idx)[:, 8:11], axis=0)
        return np.zeros(3)

    def generate_movie_frame(self, idx: int):
        adc = self.dataset.get_radar_adc_data(idx)
        vel = self._vehicle_vel(idx)
        resp = self.processor.process(adc, current_vel=vel)

        lidar = None
        if getattr(self.dataset, "lidar_enabled", False):
            lidar = self.dataset.get_lidar_point_cloud_raw(idx)

        if resp.size == 0:
            fig, ax = plt.subplots(figsize=(12, 8))
            ax.text(0.5, 0.5,
                    f"frame {idx}: velocity gate not satisfied\nvel={np.round(vel, 3)}",
                    ha="center", va="center")
            ax.axis("off")
            return fig
        pattern = self.processor.compute_synthetic_array_pattern(
            self.processor.array_geometry
        )
        return self.plotter.plot_compilation(
            self.processor, resp, pattern=pattern, lidar_points=lidar
        )
