"""Manual Qt harness: per-cell view uniqueness with mock views.

Counterpart of ``/root/reference/scripts/verify_unique_view.py``: exercises
the selection/uniqueness logic against the live widget tree with lightweight
mock views (no processors, no dataset), so the combo wiring itself is what
is under test.  The Qt-free core of this behavior is unit-tested headless in
``tests/test_gui_logic.py::test_panel_uniqueness``; run this on a Qt-equipped
workstation to see it live.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    try:
        from PyQt6 import QtWidgets
    except ImportError:
        print("PyQt6 not installed — this manual harness needs a Qt "
              "environment; the uniqueness rule is covered headless by "
              "tests/test_gui_logic.py::test_panel_uniqueness")
        return 0

    from mmwave_radar_processing_jax.visualization.shell_logic import ShellLogic

    class MockController:
        """Just enough controller surface for ShellLogic."""

        class _DS:
            num_frames = 0

        dataset_model = _DS()

        def __init__(self, keys):
            self.registry = {
                k: type("Spec", (), {"enabled": True, "view_key": k})()
                for k in keys
            }
            self._subs = []

        def subscribe_view_updates(self, fn):
            self._subs.append(fn)

    class MockView(QtWidgets.QWidget):
        def __init__(self, parent=None):
            super().__init__(parent)
            lay = QtWidgets.QVBoxLayout(self)
            lay.addWidget(QtWidgets.QLabel("I am a plot", self))
            self.latest_payload = None

        def set_data(self, payload):
            self.latest_payload = payload

        def set_db_mode(self, enabled):
            pass

    keys = ["view1", "view2", "range_doppler_resp", "range_angle_resp",
            "range_resp", "doppler_azimuth_resp"]
    app = QtWidgets.QApplication.instance() or QtWidgets.QApplication([])

    ctl = MockController(keys)
    logic = ShellLogic(ctl, num_cells=4,
                       initial_keys=["range_doppler_resp", None, None, None])
    win = QtWidgets.QMainWindow()
    central = QtWidgets.QWidget()
    grid = QtWidgets.QGridLayout(central)
    combos = []
    for cell in range(4):
        box = QtWidgets.QVBoxLayout()
        combo = QtWidgets.QComboBox()
        for key in logic.options:
            combo.addItem(key or "(none)", key)
        view = MockView()
        box.addWidget(combo)
        box.addWidget(view)
        w = QtWidgets.QWidget()
        w.setLayout(box)
        grid.addWidget(w, cell // 2, cell % 2)
        combos.append(combo)
        logic.bind_cell_view(cell, view)

        def on_change(_i, c=cell, cb=combo):
            for changed in logic.select_view(c, cb.currentData()):
                if changed != c:
                    combos[changed].blockSignals(True)
                    combos[changed].setCurrentIndex(
                        combos[changed].findData(
                            logic.panel.assignments[changed]))
                    combos[changed].blockSignals(False)

        combo.currentIndexChanged.connect(on_change)
        combo.blockSignals(True)
        combo.setCurrentIndex(combo.findData(logic.panel.assignments[cell]))
        combo.blockSignals(False)

    win.setCentralWidget(central)
    win.resize(800, 600)
    win.show()
    app.processEvents()

    # scripted check: select cell 0's view in cell 1 -> cell 0 clears
    combos[1].setCurrentIndex(combos[1].findData("range_doppler_resp"))
    app.processEvents()
    assert logic.panel.assignments[1] == "range_doppler_resp"
    assert logic.panel.assignments[0] is None
    assert combos[0].currentData() is None
    print("verify_unique_view: uniqueness OK — window live; close to exit")
    app.exec()
    return 0


if __name__ == "__main__":
    sys.exit(main())
