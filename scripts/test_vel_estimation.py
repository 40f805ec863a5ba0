#!/usr/bin/env python
"""Ego-velocity estimation analysis over one dataset (headline RadVel flow).

Re-design of the reference ``scripts/test_vel_estimation.py``: raw ADC frames
-> virtual-array reformat -> ground-gated point clouds -> points-based RANSAC
ego velocity -> per-axis error statistics vs odometry ground truth, configured
by a YAML analyzer config (``analyzer_configs/velocity_analysis_config.yaml``
format, including the frame-transformation matrices).

Example:
    python scripts/simulate_dataset.py --out /tmp/sim_radvel --frames 120
    python scripts/test_vel_estimation.py \
        --config analyzer_configs/velocity_analysis_config.yaml \
        --dataset /tmp/sim_radvel
"""

import argparse
import os
import sys

import numpy as np
import yaml

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_jax.utils.env import load_env, resolve_dir

load_env()

from mmwave_radar_processing_jax.analysis import VelocityAnalyzer
from mmwave_radar_processing_jax.config import load_cfg
from mmwave_radar_processing_jax.data.cpsl_dataset import CpslDS
from mmwave_radar_processing_jax.point_cloud_processing import VelocityEstimator
from mmwave_radar_processing_jax.processors.point_cloud import PointCloudGenerator
from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter
from mmwave_radar_processing_jax.utils.logger import setup_logger


def _resolve_radar_cfg(radar_cfg_file: str, yaml_path: str) -> str:
    """Resolve a relative radar .cfg: CONFIG_DIRECTORY, YAML-relative, repo."""
    if os.path.isabs(radar_cfg_file):
        return radar_cfg_file
    candidates = [
        resolve_dir(radar_cfg_file, "CONFIG_DIRECTORY"),
        os.path.join(os.path.dirname(os.path.abspath(yaml_path)), "..",
                     "configs", radar_cfg_file),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "configs", radar_cfg_file),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return candidates[-1]


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="analyzer_configs/velocity_analysis_config.yaml")
    p.add_argument("--dataset", default=None,
                   help="override the dataset path from the YAML")
    p.add_argument("--radar-config", default=None)
    p.add_argument("--start-idx", type=int, default=None)
    p.add_argument("--end-idx", type=int, default=None)
    p.add_argument("--plot-out", default=None,
                   help="write the analysis summary figure here")
    args = p.parse_args()

    logger = setup_logger()
    with open(args.config) as f:
        params = yaml.safe_load(f)

    root = os.path.join(os.path.dirname(os.path.abspath(args.config)), "..")
    dataset_path = args.dataset or resolve_dir(
        os.path.join(params["dataset"]["path"], params["dataset"]["name"]),
        "DATASET_DIRECTORY",
    )
    radar_cfg_file = _resolve_radar_cfg(
        args.radar_config or params["radar"]["config_file"], args.config
    )

    cfg = load_cfg(
        radar_cfg_file,
        params["radar"].get("array_geometry", "standard"),
        params["radar"].get("array_direction", "down"),
    )
    logger.info("\n%s", cfg.overview())

    dataset = CpslDS(dataset_path)
    reformatter = VirtualArrayReformatter(cfg)

    pc_params = params["processors"]["point_cloud_generator"]
    generator = PointCloudGenerator(cfg, **pc_params)

    ve_params = params["processors"].get("velocity_estimator", {})
    estimator = VelocityEstimator(
        cfg,
        min_R2_threshold=ve_params.get("min_r2_threshold", 0.6),
        min_inlier_percent=ve_params.get("min_inlier_percent", 0.75),
    )

    trans = params.get("transformation", {})
    uav_mat = np.asarray(trans.get("uav_vel_matrix", np.eye(3)))
    gt_mat = np.asarray(trans.get("gt_vel_matrix", np.eye(3)))

    analysis = params.get("analysis", {})
    start = args.start_idx if args.start_idx is not None else analysis.get("start_idx", 0)
    end = args.end_idx if args.end_idx is not None else min(
        analysis.get("end_idx", dataset.num_frames), dataset.num_frames
    )

    ests, gts = [], []
    for i in range(start, end):
        adc = np.asarray(reformatter.process(dataset.get_radar_adc_data(i)))
        points = generator.process(adc)
        vel = estimator.process(points=points)
        gt = np.mean(dataset.get_vehicle_odom_data(i)[:, 8:11], axis=0)
        ests.append(uav_mat @ vel)
        gts.append(gt_mat @ gt)
        estimator.update_history(ests[-1], gts[-1])
        if (i - start) % 50 == 0:
            logger.info("frame %d/%d vel=%s", i, end, np.round(ests[-1], 3))

    analyzer = VelocityAnalyzer()
    analyzer.analyze(np.array(ests), np.array(gts),
                     error_method=analysis.get("error_method", "signed"))
    report = analyzer.generate_report()
    print("\n==== velocity error report ====")
    print(report.to_string())

    if args.plot_out:
        import matplotlib

        matplotlib.use("Agg")
        from mmwave_radar_processing_jax.plotting import AnalysisPlotter

        fig = AnalysisPlotter().plot_summary(analyzer)
        fig.savefig(args.plot_out, dpi=100)
        logger.info("wrote %s", args.plot_out)

    return report


if __name__ == "__main__":
    main()
