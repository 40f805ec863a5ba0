"""Plotting layer: plotters render, movie generators produce frames/files."""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest

from mmwave_radar_processing_jax.analysis import VelocityAnalyzer
from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.data.cpsl_dataset import (
    CpslDS,
    make_odom_rows,
    write_dataset,
)
from mmwave_radar_processing_jax.plotting import (
    AnalysisPlotter,
    MmWaveDataMovieGenerator,
    OdometryMovieGenerator,
    PlotterMmWaveData,
    PlotterOdometryData,
    PlotterSyntheticArrayData,
    SyntheticArrayMovieGenerator,
)
from mmwave_radar_processing_jax.processors import (
    Altimeter,
    MicroDopplerProcessor,
    RangeAngleProcessor,
    RangeDopplerProcessor,
    VirtualArrayReformatter,
)
from mmwave_radar_processing_jax.processors.synthetic_array import (
    SyntheticArrayBeamformerProcessor,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, flagship_config):
    root = str(tmp_path_factory.mktemp("plotds") / "rec")
    rng = np.random.default_rng(0)
    frames, odom = [], []
    vel = np.array([0.2, 0.01, 0.0])
    for i in range(4):
        scene = Scene(
            targets=[PointTarget(range_m=0.6 + 0.05 * i, rcs=4.0),
                     PointTarget(range_m=1.5, azimuth_rad=0.3, rcs=2.0,
                                 velocity_m_s=0.4)],
            noise_sigma=0.03,
        )
        frames.append(simulate_frame(flagship_config, scene, rng))
        odom.append(make_odom_rows(vel))
    write_dataset(root, np.stack(frames), odom=np.stack(odom))
    return CpslDS(root)


def test_plotters_render(flagship_config, dataset):
    var = VirtualArrayReformatter(flagship_config)
    adc = np.asarray(var.process(dataset.get_radar_adc_data(0)))
    rd = RangeDopplerProcessor(flagship_config)
    ra = RangeAngleProcessor(flagship_config)
    plotter = PlotterMmWaveData(flagship_config)

    fig, ax = plt.subplots()
    plotter.plot_range_doppler_heatmap(rd.process(adc, rx_idx=0), rd, ax=ax)
    plotter.plot_range_azimuth_heatmap_cart(ra.process(adc), ra, ax=ax)
    plotter.plot_raw_adc(adc, ax=ax)
    plt.close(fig)

    # analysis summary figure
    an = VelocityAnalyzer()
    gt = np.random.default_rng(0).standard_normal((30, 3))
    an.analyze(gt + 0.1, gt)
    fig = AnalysisPlotter().plot_summary(an)
    plt.close(fig)


def test_doppler_azimuth_panels_with_overlays(flagship_config, dataset):
    """Coarse + zoomed Doppler-azimuth panels with peak/GT/estimate overlays
    (reference plot_doppler_az_resp :324-425 / plot_zoomed_doppler_az_resp
    :427-531)."""
    from mmwave_radar_processing_jax.processors import DopplerAzimuthProcessor

    var = VirtualArrayReformatter(flagship_config)
    adc = np.asarray(var.process(dataset.get_radar_adc_data(0)))
    da = DopplerAzimuthProcessor(flagship_config)

    coarse = np.asarray(da.process(adc))
    angles = np.asarray(da.valid_angle_bins)
    vd_gt = 0.3 * np.cos(angles)
    vd_est = 0.28 * np.cos(angles)
    peaks = np.array([[angles[len(angles) // 2], 0.3]])
    plotter = PlotterMmWaveData(flagship_config)

    fig, ax = plt.subplots()
    plotter.plot_doppler_azimuth(coarse, da, ax=ax, peaks=peaks,
                                 vd_ground_truth=vd_gt, vd_estimated=vd_est)
    labels = ax.get_legend_handles_labels()[1]
    assert {"Detected Peaks", "Ground Truth Velocity",
            "Estimated Velocity"} <= set(labels)
    plt.close(fig)

    # zoomed panel requires the precise pass first
    fig, ax = plt.subplots()
    with pytest.raises(ValueError, match="use_precise_fft"):
        plotter.plot_zoomed_doppler_azimuth(coarse, da, ax=ax)
    zoom_resp, zoom_bins, _ = da.process(adc, use_precise_fft=True)
    plotter.plot_zoomed_doppler_azimuth(np.asarray(zoom_resp), da, ax=ax,
                                        vd_ground_truth=vd_gt,
                                        vd_estimated=vd_est)
    lo, hi = ax.get_ylim()
    zb = np.asarray(zoom_bins)
    assert lo == pytest.approx(zb.min()) and hi == pytest.approx(zb.max())
    plt.close(fig)


def test_mmwave_movie_generator(flagship_config, dataset, tmp_path):
    from mmwave_radar_processing_jax.processors import DopplerAzimuthProcessor

    plotter = PlotterMmWaveData(flagship_config)
    gen = MmWaveDataMovieGenerator(
        flagship_config, dataset, plotter,
        processors={
            "range_doppler": RangeDopplerProcessor(flagship_config),
            "range_angle": RangeAngleProcessor(flagship_config),
            "micro_doppler": MicroDopplerProcessor(flagship_config,
                                                   num_frames_history=4),
            "doppler_azimuth": DopplerAzimuthProcessor(flagship_config),
            "zoomed_doppler_azimuth": DopplerAzimuthProcessor(flagship_config),
        },
        reformatter=VirtualArrayReformatter(flagship_config),
        fps=5,
    )
    out = gen.generate(str(tmp_path / "m.mp4"), num_frames=2) or str(
        tmp_path / "m.gif"
    )
    produced = [p for p in (str(tmp_path / "m.mp4"), str(tmp_path / "m.gif"))
                if os.path.exists(p)]
    assert produced and os.path.getsize(produced[0]) > 1000


def test_odometry_movie_generator(flagship_config, dataset, tmp_path):
    gen = OdometryMovieGenerator(
        flagship_config, dataset,
        altimeter=Altimeter(flagship_config, min_altitude_m=0.25,
                            zoom_search_region_m=0.2,
                            altitude_search_limit_m=0.4),
        plotter=PlotterOdometryData(flagship_config),
        reformatter=VirtualArrayReformatter(flagship_config),
        fps=5,
    )
    gen.generate_movie_frames(2)
    assert len(gen.frame_paths) == 2
    gen.save_movie(str(tmp_path / "odo.mp4"))
    gen.cleanup()
    assert any(os.path.exists(str(tmp_path / f"odo.{e}")) for e in ("mp4", "gif"))


def test_synthetic_array_movie_generator(flagship_config, dataset, tmp_path):
    proc = SyntheticArrayBeamformerProcessor(
        flagship_config, num_frames=2,
        min_vel=np.array([0.15, 0.0, 0.0]),
        max_vel=np.array([0.3, 0.05, 0.05]),
    )
    gen = SyntheticArrayMovieGenerator(
        flagship_config, dataset, proc,
        plotter=PlotterSyntheticArrayData(flagship_config), fps=5,
    )
    gen.generate_movie_frames(3)
    assert len(gen.frame_paths) == 3
    gen.cleanup()
