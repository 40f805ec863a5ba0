#!/usr/bin/env python
"""Manual CFAR verification on synthetic oracles (prints a pass/fail table).

Equivalent of the reference ``tests/verify_detectors_manual.py``: exponential
noise with planted targets; every CFAR variant must detect the target and keep
its false-alarm count reasonable.  Optionally renders the threshold plots.

Example:
    python scripts/verify_detectors.py --plot-out /tmp/cfar.png
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mmwave_radar_processing_jax.detectors import get_detector_registry


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plot-out", default=None)
    args = p.parse_args()

    rng = np.random.default_rng(args.seed)
    x1 = rng.exponential(1.0, 120)
    x1[50] += 30.0
    x2 = rng.exponential(1.0, (64, 64))
    x2[20, 30] += 40.0

    registry = get_detector_registry()
    cases = [
        ("ca_cfar_1d", dict(num_train=8, num_guard=2, pfa=1e-3), x1, 50),
        ("go_cfar_1d", dict(num_train=8, num_guard=2, pfa=1e-3), x1, 50),
        ("so_cfar_1d", dict(num_train=8, num_guard=2, pfa=1e-3), x1, 50),
        ("os_cfar_1d", dict(num_train=8, num_guard=2, rho=0.75, alpha=6.0), x1, 50),
        ("ca_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), pfa=1e-3), x2, (20, 30)),
        ("os_cfar_2d", dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0), x2, (20, 30)),
    ]

    print(f"{'detector':<12} {'target hit':<11} {'detections':<11} result")
    all_ok = True
    plots = []
    for name, params, signal, target in cases:
        det = registry[name](**params)
        dets = det.detect(signal)
        hit = target in dets
        ok = hit and len(dets) < signal.size * 0.05
        all_ok &= ok
        print(f"{name:<12} {str(hit):<11} {len(dets):<11} "
              f"{'PASS' if ok else 'FAIL'}")
        plots.append((name, signal, det))

    if args.plot_out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 3, figsize=(15, 8))
        for ax, (name, signal, det) in zip(axes.reshape(-1), plots):
            if signal.ndim == 1:
                ax.plot(signal, label="signal", lw=0.8)
                thr = np.asarray(det.thresholds)
                finite = np.isfinite(thr)
                ax.plot(np.flatnonzero(finite), thr[finite], "--",
                        label="threshold", lw=0.8)
                idx = np.flatnonzero(np.asarray(det.detections))
                ax.scatter(idx, signal[idx], c="r", marker="x", zorder=5)
            else:
                ax.imshow(np.asarray(det.detections), aspect="auto",
                          origin="lower", cmap="gray")
            ax.set_title(name, fontsize=9)
        fig.tight_layout()
        fig.savefig(args.plot_out, dpi=100)
        print(f"wrote {args.plot_out}")

    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
