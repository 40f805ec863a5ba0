"""Measure viewer playback rate with 4 live cells.

The reference GUI targets a 50 ms tick (20 FPS) with four live pyqtgraph
cells (``mmwave_radar_processor_controller.py:170``).  This script measures
what the viewer's rendering tiers actually sustain:

- ``--backend matplotlib`` (default): headless-capable — drives
  ``ShellLogic`` + matplotlib views on Agg canvases, full canvas draw per
  frame per cell (what playback/export does).  Runs in this container.
- ``--backend pyqtgraph``: the real-time tier (ImageItem + OpenGL cloud);
  requires pyqtgraph + a Qt platform.  Measured by pumping the real window's
  timer tick.

Usage:
    python scripts/measure_playback_rate.py [--frames 60] [--backend matplotlib]

Prints one JSON line {"backend", "frames", "fps", "ms_per_tick", "cells"}.
"""

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import matplotlib

import numpy as np


def build_controller(root: str, n_frames: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mmwave_radar_processing_jax as mrp
    from mmwave_radar_processing_jax.data import (
        PointTarget,
        Scene,
        simulate_frame,
    )
    from mmwave_radar_processing_jax.data.cpsl_dataset import (
        make_odom_rows,
        write_dataset,
    )
    from mmwave_radar_processing_jax.visualization import (
        MmWaveRadarProcessorController,
        get_default_registry,
    )

    rng = np.random.default_rng(0)
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "6843_RadVel_ods_20Hz.cfg")
    cfg = mrp.load_cfg(cfg_path, "ods", "down")
    frames, odom = [], []
    for i in range(n_frames):
        scene = Scene(targets=[
            PointTarget(range_m=1.0 + 0.3 * (i % 3), azimuth_rad=0.2,
                        velocity_m_s=0.4, rcs=4.0)], noise_sigma=0.04)
        frames.append(simulate_frame(cfg, scene, rng))
        odom.append(make_odom_rows(np.array([0.2, 0.0, 0.0])))
    write_dataset(os.path.join(root, "rec"), np.stack(frames),
                  odom=np.stack(odom))

    registry = get_default_registry()
    ctl = MmWaveRadarProcessorController(registry=registry)
    ctl.load_dataset(os.path.join(root, "rec"))
    ctl.load_config(cfg_path, "ods", "down")
    ctl.init_processors()
    return ctl, cfg_path


KEYS = ["range_doppler_resp", "range_resp", "micro_doppler_resp",
        "doppler_azimuth_resp"]


def measure_matplotlib(ctl, n_frames: int):
    """(fps_with_draws, fps_processing_only) — isolates the render tier."""
    import matplotlib.pyplot as plt

    from mmwave_radar_processing_jax.visualization.shell_logic import ShellLogic

    logic = ShellLogic(ctl, num_cells=4, initial_keys=list(KEYS))
    figs = []
    for cell, key in enumerate(KEYS):
        fig, ax = plt.subplots(figsize=(5, 4))
        figs.append(fig)
        logic.bind_cell_view(cell, logic.view_class_for(key)(ax=ax))

    def run(with_draws: bool) -> float:
        logic.set_render_callback(
            (lambda cell: figs[cell].canvas.draw()) if with_draws
            else (lambda cell: None))
        ctl.process_next_frame(0)  # warm the jit caches
        t0 = time.perf_counter()
        for i in range(n_frames):
            ctl.process_next_frame(i % ctl.dataset_model.num_frames)
        return n_frames / (time.perf_counter() - t0)

    return run(True), run(False)


def measure_pyqtgraph(ctl, n_frames: int) -> float:
    from PyQt6 import QtWidgets

    from mmwave_radar_processing_jax.visualization.qt_shell import (
        build_main_window,
    )

    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
    win = build_main_window(ctl, view_keys=list(KEYS), backend="pyqtgraph")
    win.show()
    app.processEvents()
    ctl.process_next_frame(0)
    t0 = time.perf_counter()
    for i in range(n_frames):
        ctl.process_next_frame(i % ctl.dataset_model.num_frames)
        app.processEvents()
    dt = time.perf_counter() - t0
    win.close()
    return n_frames / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--build-frames", type=int, default=8,
                    help="recording length for the controller/dataset; the "
                         "precompute build cost is per-frame amortized, so "
                         "measure it at a realistic length (e.g. 64)")
    ap.add_argument("--backend", choices=["matplotlib", "pyqtgraph"],
                    default="matplotlib")
    ap.add_argument("--precompute", action="store_true",
                    help="precompute-then-scrub mode: run the recording "
                         "through the batched device pipelines once "
                         "(controller.enable_precomputed_playback), then "
                         "serve playback ticks from the host cache — the "
                         "device-backed playback path")
    ap.add_argument("--only-selected", action="store_true",
                    help="enable only the 4 displayed view keys (the "
                         "reference's 4-live-cell scenario, "
                         "mmwave_radar_processor_controller.py:170) instead "
                         "of the full 12-processor registry fan-out")
    args = ap.parse_args()

    if args.backend == "matplotlib":
        matplotlib.use("Agg")

    fps_proc = None
    build_s = covered = None
    with tempfile.TemporaryDirectory() as td:
        ctl, _ = build_controller(td, n_frames=args.build_frames)
        if args.only_selected:
            for key in list(ctl.processors):
                if key not in KEYS:
                    del ctl.processors[key]
        if args.precompute:
            covered = sorted(ctl.enable_precomputed_playback())
            build_s = ctl.playback_cache.build_seconds
        if args.backend == "matplotlib":
            fps, fps_proc = measure_matplotlib(ctl, args.frames)
        else:
            fps = measure_pyqtgraph(ctl, args.frames)
    out = {
        "backend": args.backend,
        "frames": args.frames,
        "fps": round(fps, 2),
        "ms_per_tick": round(1000.0 / fps, 2),
        "cells": len(KEYS),
        "precompute": bool(args.precompute),
        "only_selected": bool(args.only_selected),
    }
    if fps_proc is not None:
        out["fps_processing_only"] = round(fps_proc, 2)
        out["processing_ms_per_tick"] = round(1000.0 / fps_proc, 2)
        out["render_ms_per_tick"] = round(1000.0 / fps - 1000.0 / fps_proc, 2)
    if args.precompute:
        out["covered_keys"] = covered
        out["precompute_build_s"] = round(build_s, 2)
        out["precompute_build_ms_per_frame"] = round(
            1e3 * build_s / ctl.dataset_model.num_frames, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
