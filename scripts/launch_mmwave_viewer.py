#!/usr/bin/env python
"""Launch the mmWave viewer: Qt GUI when available, headless playback otherwise.

Re-design of the reference ``scripts/launch_mmwave_viewer.py``.  The MVC
backend (controller + registry + views) is Qt-free; when PyQt6 is installed a
windowed shell embeds the matplotlib views, otherwise ``--export-movie`` runs
the identical pipeline headless and writes the rendered dashboard movie.

Example (headless):
    python scripts/launch_mmwave_viewer.py \
        --dataset-params gui_configs/dataset_params.yaml \
        --processor-params gui_configs/processor_params.yaml \
        --export-movie /tmp/viewer.mp4 --frames 50
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_jax.utils.env import load_env

load_env()

from mmwave_radar_processing_jax.utils.logger import setup_logger
from mmwave_radar_processing_jax.visualization import (
    MmWaveRadarProcessorController,
    get_default_registry,
)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-params", default="gui_configs/dataset_params.yaml")
    p.add_argument("--processor-params", default="gui_configs/processor_params.yaml")
    p.add_argument("--export-movie", default=None,
                   help="headless: render the dashboard movie to this path")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--views", nargs="*", default=None,
                   help="processor keys to render (default: first four)")
    args = p.parse_args()

    logger = setup_logger()
    controller = MmWaveRadarProcessorController(
        registry=get_default_registry(),
        dataset_params_path=args.dataset_params,
        processor_params_path=args.processor_params,
    )

    try:
        import PyQt6  # noqa: F401

        have_qt = True
    except ImportError:
        have_qt = False

    if have_qt and not args.export_movie:
        from mmwave_radar_processing_jax.visualization.qt_shell import run_qt_viewer

        run_qt_viewer(controller)
        return

    if not args.export_movie:
        logger.info("PyQt6 not available: running headless playback "
                    "(use --export-movie to save the rendering)")
        n = args.frames or controller.dataset_model.num_frames
        controller.play(0, n)
        logger.info("processed %d frames", n)
        return

    from mmwave_radar_processing_jax.visualization.video_exporter import VideoExporter

    exporter = VideoExporter(controller, view_keys=args.views)
    n = exporter.export(args.export_movie, 0, args.frames)
    logger.info("exported %d frames", n)


if __name__ == "__main__":
    main()
