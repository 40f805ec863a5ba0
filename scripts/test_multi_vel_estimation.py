#!/usr/bin/env python
"""Aggregate ego-velocity error analysis over multiple datasets.

Re-design of the reference ``scripts/test_multi_vel_estimation.py``: runs the
single-dataset analysis flow over every dataset listed in a multi-dataset YAML
and prints per-dataset + pooled error reports.

YAML format:
    datasets:
      - path: /tmp/sim_a
      - path: /tmp/sim_b
    radar: { config_file: ..., array_geometry: ..., array_direction: ... }
    processors: { ... same as velocity_analysis_config ... }
    analysis: { start_idx: ..., end_idx: ..., error_method: signed }
    transformation: { uav_vel_matrix: ..., gt_vel_matrix: ... }
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


def analyze_dataset(cfg, dataset_path, params, logger):
    dataset = CpslDS(dataset_path)
    reformatter = VirtualArrayReformatter(cfg)
    generator = PointCloudGenerator(cfg, **params["processors"]["point_cloud_generator"])
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
    start = analysis.get("start_idx", 0)
    end = min(analysis.get("end_idx", dataset.num_frames), dataset.num_frames)

    ests, gts = [], []
    for i in range(start, end):
        adc = np.asarray(reformatter.process(dataset.get_radar_adc_data(i)))
        vel = estimator.process(points=generator.process(adc))
        gt = np.mean(dataset.get_vehicle_odom_data(i)[:, 8:11], axis=0)
        ests.append(uav_mat @ vel)
        gts.append(gt_mat @ gt)
    return np.array(ests), np.array(gts)


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
    p.add_argument("--config", required=True)
    args = p.parse_args()

    logger = setup_logger()
    with open(args.config) as f:
        params = yaml.safe_load(f)

    radar_cfg_file = _resolve_radar_cfg(params["radar"]["config_file"],
                                        args.config)
    cfg = load_cfg(
        radar_cfg_file,
        params["radar"].get("array_geometry", "standard"),
        params["radar"].get("array_direction", "down"),
    )

    all_est, all_gt = [], []
    method = params.get("analysis", {}).get("error_method", "signed")
    for entry in params["datasets"]:
        path = entry["path"] if isinstance(entry, dict) else entry
        logger.info("analyzing %s", path)
        est, gt = analyze_dataset(cfg, path, params, logger)
        analyzer = VelocityAnalyzer()
        analyzer.analyze(est, gt, error_method=method)
        print(f"\n==== {os.path.basename(path)} ====")
        print(analyzer.generate_report().to_string())
        all_est.append(est)
        all_gt.append(gt)

    pooled = VelocityAnalyzer()
    pooled.analyze(np.concatenate(all_est), np.concatenate(all_gt),
                   error_method=method)
    print("\n==== pooled over all datasets ====")
    print(pooled.generate_report().to_string())


if __name__ == "__main__":
    main()
