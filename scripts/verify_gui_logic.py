"""Manual Qt harness: drive the real viewer window through its behaviors.

Interactive counterpart of the headless pytest coverage in
``tests/test_gui_logic.py`` — the reference ships the same split
(``/root/reference/scripts/verify_gui_logic.py``: scripted assertions
against a live QApplication).  Builds a simulated dataset, opens the real
``MainWindow`` (matplotlib backend by default, ``--backend pyqtgraph`` for
the real-time tier), then scripts a verification pass over the live widgets:

1. per-cell view selection + uniqueness (selecting a view already shown in
   another cell clears that cell),
2. hidden-view payload caching with render-on-reveal,
3. dB toggle re-render,
4. a short timed playback.

Requires PyQt6 (and a display / ``QT_QPA_PLATFORM=offscreen``); exits with a
clear message when Qt is absent (this container ships no Qt binding — run on
a workstation).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    try:
        from PyQt6 import QtCore, QtWidgets
    except ImportError:
        print("PyQt6 not installed — this manual harness needs a Qt "
              "environment; the same behaviors are covered headless by "
              "tests/test_gui_logic.py")
        return 0

    import numpy as np

    from mmwave_radar_processing_jax.visualization.qt_shell import (
        build_main_window,
    )
    from scripts.measure_playback_rate import build_controller

    backend = "pyqtgraph" if "--backend=pyqtgraph" in sys.argv or \
        "pyqtgraph" in sys.argv else "matplotlib"

    with tempfile.TemporaryDirectory() as td:
        ctl, _ = build_controller(td, n_frames=8)
        app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])
        win = build_main_window(
            ctl, view_keys=["range_doppler_resp", "range_resp", None, None],
            backend=backend)
        win.resize(1200, 900)
        win.show()
        app.processEvents()

        logic = win.logic

        # 1. uniqueness: select cell 0's view in cell 1 -> cell 0 clears
        key0 = logic.panel.assignments[0]
        combo1 = win.cell_combos[1]
        combo1.setCurrentIndex(combo1.findData(key0))
        app.processEvents()
        assert logic.panel.assignments[1] == key0, "cell 1 selection failed"
        assert logic.panel.assignments[0] is None, "uniqueness not enforced"
        print("[ok] per-cell uniqueness")

        # 2. hidden-view caching: payload for an unselected view caches, then
        # renders on reveal
        hidden = next(k for k in logic.options
                      if k and k not in logic.panel.assignments)
        payload = {"data": np.random.default_rng(0).random((10, 12)) + 0.1,
                   "vel_bins": np.arange(12), "time_bins": np.arange(10)}
        assert logic.on_view_update(hidden, payload) == []
        combo2 = win.cell_combos[2]
        combo2.setCurrentIndex(combo2.findData(hidden))
        app.processEvents()
        assert logic._views[2].latest_payload is not None, "reveal render"
        print("[ok] hidden-view caching + render-on-reveal")

        # 3. dB toggle re-renders every live cell
        win.db_box.setChecked(False)
        app.processEvents()
        win.db_box.setChecked(True)
        app.processEvents()
        print("[ok] dB toggle")

        # 4. timed playback: run the 50 ms tick for 2 s then close
        win.toggle_play()
        QtCore.QTimer.singleShot(2000, app.quit)
        app.exec()
        print(f"[ok] playback ticked to frame {win.frame} "
              f"(backend={backend})")
        win.close()
    print("verify_gui_logic: ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
