#!/usr/bin/env python
"""Inspect one frame of a dataset: processor dashboard to screen or file.

Re-design of the reference ``scripts/view_radar_data.py``: loads a dataset +
radar config, processes one frame through the spectral processors, and renders
the 2x3 compilation dashboard.

Example:
    python scripts/view_radar_data.py --dataset /tmp/sim_radvel \
        --radar-config configs/6843_RadVel_ods_20Hz.cfg --frame 10 \
        --out /tmp/frame10.png
"""

import argparse
import os
import sys

import matplotlib

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_jax.config import load_cfg
from mmwave_radar_processing_jax.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_jax.plotting import PlotterMmWaveData
from mmwave_radar_processing_jax.processors import (
    DopplerAzimuthProcessor,
    MicroDopplerProcessor,
    RangeAngleProcessor,
    RangeDopplerProcessor,
    VirtualArrayReformatter,
)
from mmwave_radar_processing_jax.utils.logger import setup_logger


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--radar-config", default="configs/6843_RadVel_ods_20Hz.cfg")
    p.add_argument("--array-geometry", default="ods")
    p.add_argument("--array-direction", default="down")
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--out", default=None, help="save the dashboard PNG here")
    args = p.parse_args()

    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logger = setup_logger()
    cfg = load_cfg(args.radar_config, args.array_geometry, args.array_direction)
    logger.info("\n%s", cfg.overview())

    dataset = CpslDS(args.dataset)
    logger.info("dataset: %d frames", dataset.num_frames)

    reformatter = VirtualArrayReformatter(cfg)
    processors = {
        "range_doppler": RangeDopplerProcessor(cfg),
        "range_angle": RangeAngleProcessor(cfg),
        "micro_doppler": MicroDopplerProcessor(cfg),
        "doppler_azimuth": DopplerAzimuthProcessor(cfg),
    }

    adc = np.asarray(reformatter.process(dataset.get_radar_adc_data(args.frame)))
    plotter = PlotterMmWaveData(cfg)
    fig = plotter.plot_compilation(
        adc,
        range_doppler=processors["range_doppler"].process(adc, rx_idx=0),
        range_angle=processors["range_angle"].process(adc),
        micro_doppler=processors["micro_doppler"].process(adc),
        doppler_azimuth=processors["doppler_azimuth"].process(adc),
        processors=processors,
    )
    if args.out:
        fig.savefig(args.out, dpi=100)
        logger.info("wrote %s", args.out)
    else:
        plt.show()


if __name__ == "__main__":
    main()
