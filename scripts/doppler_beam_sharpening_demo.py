#!/usr/bin/env python
"""Doppler beam sharpening demo on simulated forward motion.

Re-design of the reference ``scripts/doppler_deam_sharpening_demo.py`` [sic]:
simulates a moving platform observing static scatterers, renders the plain
range-angle response next to the DBS-sharpened response.

Example:
    python scripts/doppler_beam_sharpening_demo.py --out /tmp/dbs.png
"""

import argparse
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_jax.config import load_cfg
from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.plotting import PlotterMmWaveData
from mmwave_radar_processing_jax.processors.dbs import RangeAngleProcessorDBSEnhanced
from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter
from mmwave_radar_processing_jax.utils.logger import setup_logger


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--out", default="/tmp/dbs_demo.png")
    p.add_argument("--vx", type=float, default=0.5)
    args = p.parse_args()

    logger = setup_logger()
    cfg = load_cfg(args.config, "ods", "down")
    rng = np.random.default_rng(0)
    vel = np.array([args.vx, 0.0, 0.0])

    # static scatterers: Doppler = -cos(angle)*vx as seen from the moving platform
    targets = []
    for az_deg in (-35, -15, 0, 20, 40):
        az = np.deg2rad(az_deg)
        r = rng.uniform(1.0, 3.0)
        u = np.array([np.cos(az), np.sin(az), 0.0])
        targets.append(
            PointTarget(range_m=r, azimuth_rad=az, velocity_m_s=-float(u @ vel),
                        rcs=3.0, phase_rad=rng.uniform(0, 2 * np.pi))
        )
    raw = simulate_frame(cfg, Scene(targets=targets, noise_sigma=0.03), rng)
    virt = np.asarray(VirtualArrayReformatter(cfg).process(raw))

    proc = RangeAngleProcessorDBSEnhanced(
        cfg, num_angle_bins_range_angle_response=64,
        num_angle_bins_dbs_enhanced_response=100, min_x_y_vel_dbs=0.25,
    )
    rx = [0, 3, 4, 7]
    plain = np.asarray(proc.process_no_dbs(virt, rx_antennas=rx))
    sharpened = np.asarray(proc.process_dbs_enhanced(virt, vel, rx_antennas=rx))

    plotter = PlotterMmWaveData(cfg)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    proc.compute_mesh_grid()
    plotter.plot_range_azimuth_heatmap_polar(plain, proc, ax=axes[0])
    axes[0].set_title("Range-Angle (no DBS)")
    proc.compute_mesh_grid_dbs_enhanced()
    plotter.plot_range_azimuth_heatmap_polar(sharpened, proc, ax=axes[1])
    axes[1].set_title(f"DBS-sharpened (vx={args.vx} m/s)")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    logger.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
