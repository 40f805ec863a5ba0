"""GUI-logic suite mirroring the reference ``tests/verify_gui_logic.py``.

The reference runs 12 QApplication tests over its pyqtgraph views and the
ProcessorViewPanel.  Our views render into matplotlib Axes and all shell
wiring lives in the Qt-free :class:`ShellLogic`, so the same behaviors are
pinned headless: per-view payload/dB/colormap semantics, hidden-view payload
caching with render-on-reveal, per-cell uniqueness, and the browse actions.
A final test instantiates the real Qt window offscreen when PyQt6 exists
(not shipped in this container — skipif-guarded).
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import yaml

from mmwave_radar_processing_jax.visualization.views import (
    AltitudeView,
    DopplerAzimuthView,
    MicroDopplerView,
    PointCloud3DView,
    PointCloudView,
    RangeAngleView,
    RangeDetectorView,
    RangeDopplerDetectorView,
    RangeDopplerView,
    RangeResponseView,
)


def _db(x):
    return 20.0 * np.log10(np.maximum(np.abs(x), 1e-12))


def _image_data(view):
    return np.asarray(view.ax.images[-1].get_array())


@pytest.fixture()
def ax():
    fig, ax = plt.subplots()
    yield ax
    plt.close(fig)


# --- per-view payload / dB / colormap semantics (ref tests 1-5) ----------- #
def test_range_angle_view(ax):
    view = RangeAngleView(ax=ax, db_mode=False)
    data = np.random.default_rng(0).random((10, 20))
    payload = {"data": data, "range_bins": np.linspace(0, 10, 10),
               "angle_bins": np.linspace(-1, 1, 20)}
    view.set_data(payload)
    assert view.latest_payload is payload
    np.testing.assert_allclose(_image_data(view), data)
    view.set_db_mode(True)
    np.testing.assert_allclose(_image_data(view), _db(data))
    view.set_colormap("magma")
    assert view.ax.images[-1].get_cmap().name == "magma"


def test_micro_doppler_view(ax):
    view = MicroDopplerView(ax=ax, db_mode=False)
    data = np.random.default_rng(1).random((30, 40))
    view.set_data({"data": data, "vel_bins": np.linspace(-5, 5, 30),
                   "time_bins": np.linspace(0, 2, 40)})
    np.testing.assert_allclose(_image_data(view), data)
    view.set_db_mode(True)
    np.testing.assert_allclose(_image_data(view), _db(data))


def test_doppler_azimuth_view(ax):
    view = DopplerAzimuthView(ax=ax, db_mode=False)
    data = np.random.default_rng(2).random((15, 25))
    view.set_data({"data": data, "vel_bins": np.linspace(-5, 5, 15),
                   "valid_angle_bins": np.linspace(-1, 1, 25)})
    np.testing.assert_allclose(_image_data(view), data)
    # the zoomed grid takes precedence when it matches the data rows
    zoomed = np.linspace(-0.3, 0.3, 15)
    view.set_data({"data": data, "vel_bins": np.linspace(-5, 5, 15),
                   "zoomed_vel_bins": zoomed,
                   "valid_angle_bins": np.linspace(-1, 1, 25)})
    assert view.ax.images[-1].get_extent()[2] == pytest.approx(zoomed[0])


def test_range_doppler_view(ax):
    view = RangeDopplerView(ax=ax, db_mode=True)
    data = np.random.default_rng(3).random((12, 18)) + 0.1
    view.set_data({"data": data, "range_bins": np.linspace(0, 5, 12),
                   "vel_bins": np.linspace(-2, 2, 18)})
    np.testing.assert_allclose(_image_data(view), _db(data))


def test_range_response_view(ax):
    view = RangeResponseView(ax=ax, db_mode=False)
    data = np.random.default_rng(4).random(64) + 0.1
    view.set_data({"data": data, "range_bins": np.linspace(0, 4, 64)})
    line = view.ax.lines[0]
    np.testing.assert_allclose(line.get_ydata(), data)
    view.set_db_mode(True)
    np.testing.assert_allclose(view.ax.lines[0].get_ydata(), _db(data))


# --- detector views (ref tests 6-7, 10) ------------------------------------ #
def test_range_doppler_detector_2d_view(ax):
    view = RangeDopplerDetectorView(ax=ax, db_mode=False)
    resp = np.random.default_rng(5).random((12, 18)) + 0.1
    dets = np.array([[3, 4], [7, 10]])
    view.set_data({"data": dets, "rng_dop_resp": resp,
                   "range_bins": np.linspace(0, 5, 12),
                   "vel_bins": np.linspace(-2, 2, 18)})
    np.testing.assert_allclose(_image_data(view), resp)
    assert view.ax.collections, "detection markers missing"
    marker_xy = view.ax.collections[-1].get_offsets()
    assert marker_xy.shape == (2, 2)


def test_range_detector_view(ax):
    view = RangeDetectorView(ax=ax, db_mode=False)
    resp = np.random.default_rng(6).random(64) + 0.1
    thr = np.full(64, 0.5)
    thr[:5] = np.inf
    view.set_data({"data": np.array([10, 20]), "range_resp": resp,
                   "thresholds": thr, "range_bins": np.linspace(0, 4, 64)})
    assert len(view.ax.lines) == 2  # profile + threshold
    assert view.ax.collections  # detection scatter
    labels = view.ax.get_legend_handles_labels()[1]
    assert {"profile", "threshold", "detections"} <= set(labels)


def test_sequential_ground_detector_view(ax):
    """The sequential/ground detectors reuse the RD-detector view contract
    (ref test_range_doppler_ground_detector_sequential)."""
    view = RangeDopplerDetectorView(ax=ax, db_mode=False)
    resp = np.random.default_rng(7).random((20, 30)) + 0.1
    view.set_data({"data": np.empty((0, 2), int), "rng_dop_resp": resp,
                   "range_bins": np.linspace(0, 5, 20),
                   "vel_bins": np.linspace(-2, 2, 30)})
    np.testing.assert_allclose(_image_data(view), resp)  # no markers, no crash


# --- point cloud + altitude views (ref tests 8-9, 11) ----------------------- #
def test_point_cloud_view(ax):
    view = PointCloudView(ax=ax)
    pts = np.column_stack([np.random.default_rng(8).random((25, 3)),
                           np.linspace(-1, 1, 25)])
    view.set_data({"data": pts})
    xy = view.ax.collections[0].get_offsets()
    np.testing.assert_allclose(np.asarray(xy)[:, 0], pts[:, 1])  # x-axis = y
    view.set_data({"data": np.empty((0, 4))})  # empty cloud must not crash


def test_point_cloud_3d_view():
    fig, ax2d = plt.subplots()
    view = PointCloud3DView(ax=ax2d, min_vel=-0.25, max_vel=0.25)
    assert view.ax.name == "3d"  # 2D axes handed in is replaced in place
    pts = np.column_stack([np.random.default_rng(9).random((30, 3)),
                           np.linspace(-1.0, 1.0, 30)])
    view.set_data({"data": pts})
    sc = view.ax.collections[-1]
    # velocity coloring is clipped to the configured window (ref :66-68,:147)
    clim = sc.get_clim()
    assert clim == (-0.25, 0.25)
    assert np.max(np.asarray(sc.get_array())) <= 0.25 + 1e-9
    assert view._colorbar is not None
    assert view._colorbar.ax.get_ylabel() == "Velocity (m/s)"
    view.set_data(pts)  # raw-array payload form (ref :119-133)
    view.set_data({"data": np.empty((0, 4))})
    plt.close(fig)


def test_altitude_view(ax):
    view = AltitudeView(ax=ax, db_mode=False)
    coarse = np.random.default_rng(10).random(64) + 0.1
    view.set_data({"data": np.array(1.25), "coarse_fft_data": coarse,
                   "range_bins": np.linspace(0, 4, 64)})
    marker = [ln for ln in view.ax.lines if ln.get_linestyle() == "--"]
    assert marker and marker[-1].get_xdata()[0] == pytest.approx(1.25)


def test_pyqtgraph_backend_degrades_gracefully():
    """The optional pyqtgraph tier: clean availability probe + ImportError.

    This container ships no Qt binding, so the module must (a) import
    without pyqtgraph, (b) report unavailability, and (c) raise ImportError
    from the registry builder rather than at package import time.  (The view
    classes themselves are exercised on Qt-equipped machines via
    scripts/verify_gui_logic.py --backend pyqtgraph.)
    """
    from mmwave_radar_processing_jax.visualization import pyqtgraph_views

    if pyqtgraph_views.pyqtgraph_available():
        classes = pyqtgraph_views.get_pg_view_classes()
        from mmwave_radar_processing_jax.visualization.views import VIEW_CLASSES

        assert set(classes) >= set(VIEW_CLASSES) - {
            "sequential_detector", "ground_detector"}
    else:
        with pytest.raises(ImportError):
            pyqtgraph_views.get_pg_view_classes()


def _artist_count(fig):
    return len(fig.axes) + sum(
        len(a.images) + len(a.lines) + len(a.collections) + len(a.texts)
        for a in fig.axes
    )


@pytest.mark.parametrize("view_key", [
    "range_angle", "micro_doppler", "doppler_azimuth", "range_doppler",
    "range_response", "range_doppler_detector", "range_detector",
    "altitude", "point_cloud", "point_cloud_3d",
])
def test_view_redraw_stability(view_key):
    """100 redraws must not leak artists or shrink the plotting axes.

    Playback and movie export call ``update_view`` once per frame on a live
    view; anything created per frame without being cleared (extra colorbars,
    stacked legends, orphan scatters) accumulates.  Regression test for the
    PointCloudView per-frame ``plt.colorbar`` leak, generalized to every
    registered view class.
    """
    from mmwave_radar_processing_jax.visualization.views import VIEW_CLASSES

    rng = np.random.default_rng(13)
    fig, ax = plt.subplots()
    try:
        view = VIEW_CLASSES[view_key](ax=ax)

        def payload(i):
            two_d = rng.random((12, 18)) + 0.1
            prof = rng.random(64) + 0.1
            pts = np.column_stack([rng.random((20, 3)),
                                   np.linspace(-1, 1, 20)])
            return {
                "range_angle": {"data": two_d,
                                "range_bins": np.linspace(0, 5, 12),
                                "angle_bins": np.linspace(-1, 1, 18)},
                "micro_doppler": {"data": two_d,
                                  "vel_bins": np.linspace(-5, 5, 12),
                                  "time_bins": np.linspace(0, 2, 18)},
                "doppler_azimuth": {"data": two_d,
                                    "vel_bins": np.linspace(-5, 5, 12),
                                    "valid_angle_bins": np.linspace(-1, 1, 18)},
                "range_doppler": {"data": two_d,
                                  "range_bins": np.linspace(0, 5, 12),
                                  "vel_bins": np.linspace(-2, 2, 18)},
                "range_response": {"data": prof,
                                   "range_bins": np.linspace(0, 4, 64)},
                "range_doppler_detector": {
                    "data": np.array([[3, 4], [7, 10 + i % 3]]),
                    "rng_dop_resp": two_d,
                    "range_bins": np.linspace(0, 5, 12),
                    "vel_bins": np.linspace(-2, 2, 18)},
                "range_detector": {"data": np.array([10, 20 + i % 5]),
                                   "range_resp": prof,
                                   "thresholds": np.full(64, 0.5),
                                   "range_bins": np.linspace(0, 4, 64)},
                "altitude": {"data": np.array(1.0 + 0.01 * i),
                             "coarse_fft_data": prof,
                             "range_bins": np.linspace(0, 4, 64)},
                "point_cloud": {"data": pts},
                "point_cloud_3d": {"data": pts},
            }[view_key]

        for i in range(5):
            view.set_data(payload(i))
        fig_ = view.ax.figure
        count5, pos5 = _artist_count(fig_), view.ax.get_position().bounds
        for i in range(5, 100):
            view.set_data(payload(i))
        assert _artist_count(fig_) == count5, "artists leak across redraws"
        assert view.ax.get_position().bounds == pytest.approx(pos5), (
            "plot axes shrink across redraws (stacking colorbars?)")
    finally:
        plt.close("all")


# --- panel caching / uniqueness / browse (ref test 12 + control panel) ------ #
@pytest.fixture(scope="module")
def shell(tmp_path_factory, flagship_config):
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
    from mmwave_radar_processing_jax.data.cpsl_dataset import (
        make_odom_rows,
        write_dataset,
    )
    from mmwave_radar_processing_jax.visualization import (
        MmWaveRadarProcessorController,
        get_default_registry,
    )
    from mmwave_radar_processing_jax.visualization.shell_logic import ShellLogic

    root = tmp_path_factory.mktemp("guids")
    rng = np.random.default_rng(0)
    frames, odom = [], []
    for i in range(3):
        scene = Scene(targets=[PointTarget(range_m=1.0, rcs=4.0)],
                      noise_sigma=0.04)
        frames.append(simulate_frame(flagship_config, scene, rng))
        odom.append(make_odom_rows(np.array([0.2, 0.0, 0.0])))
    write_dataset(str(root / "rec"), np.stack(frames), odom=np.stack(odom))

    registry = get_default_registry()
    keep = {"range_doppler_resp", "range_resp", "micro_doppler_resp"}
    for k in registry:
        registry[k].enabled = k in keep
    ctl = MmWaveRadarProcessorController(registry=registry)
    ctl.load_dataset(str(root / "rec"))
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "6843_RadVel_ods_20Hz.cfg")
    logic = ShellLogic(
        ctl, num_cells=4,
        initial_keys=["range_doppler_resp", "range_resp", None, None],
    )
    logic.browse_config(cfg_path, "ods", "down")
    return logic, str(root)


def test_panel_hidden_view_caching(shell):
    """Payloads for unselected views are cached, not rendered; selecting the
    view later renders the cached payload immediately (ref panel :196-216)."""
    logic, _ = shell
    rendered = []
    for cell in range(4):
        key = logic.panel.assignments[cell]
        if key is not None:
            view_cls = logic.view_class_for(key)
            logic.bind_cell_view(cell, view_cls(ax=plt.subplots()[1]))
    logic.set_render_callback(rendered.append)

    payload = {"data": np.random.default_rng(0).random((10, 12)) + 0.1,
               "vel_bins": np.arange(12), "time_bins": np.arange(10)}
    cells = logic.on_view_update("micro_doppler_resp", payload)
    assert cells == []  # hidden -> cached only
    assert logic.panel.latest_payloads["micro_doppler_resp"] is payload
    assert rendered == []

    # reveal in cell 2: cached payload renders right away
    view = logic.view_class_for("micro_doppler_resp")(ax=plt.subplots()[1])
    logic.bind_cell_view(2, view)
    logic.select_view(2, "micro_doppler_resp")
    assert view.latest_payload is payload
    assert rendered == [2]


def test_panel_uniqueness(shell):
    """A view key may occupy at most one cell (ref panel :143-194)."""
    logic, _ = shell
    logic.select_view(0, "range_doppler_resp")
    changed = logic.select_view(3, "range_doppler_resp")
    assert logic.panel.assignments[3] == "range_doppler_resp"
    assert logic.panel.assignments[0] is None
    assert set(changed) == {0, 3}


def test_frame_fanout_renders_selected_cells(shell):
    logic, _ = shell
    logic.select_view(0, "range_doppler_resp")
    view = logic.view_class_for("range_doppler_resp")(ax=plt.subplots()[1])
    logic.bind_cell_view(0, view)
    logic.controller.process_next_frame(0)
    assert view.latest_payload is not None
    assert view.ax.images  # heatmap rendered


def test_browse_actions(shell, tmp_path):
    """Dataset/config/params browse handlers (ref control_panel :110-142)."""
    logic, root = shell
    n = logic.browse_dataset(os.path.join(root, "rec"))
    assert n == 3
    params = {"processors": {"range_doppler_resp": {"rx_idx": 0}}}
    p = tmp_path / "pp.yaml"
    p.write_text(yaml.safe_dump(params))
    logic.browse_processor_params(str(p))
    assert logic.controller.processor_params["range_doppler_resp"] == {"rx_idx": 0}
    assert "range_doppler_resp" in logic.controller.processors


# --- real Qt window (only where PyQt6 exists; not shipped here) ------------- #
def test_qt_main_window_offscreen(shell):
    pytest.importorskip("PyQt6")
    os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
    from PyQt6.QtWidgets import QApplication

    from mmwave_radar_processing_jax.visualization.qt_shell import (
        build_main_window,
    )

    logic, _ = shell
    app = QApplication.instance() or QApplication([])
    win = build_main_window(logic.controller,
                            view_keys=["range_doppler_resp", "range_resp"])
    assert len(win.cell_combos) == 4
    # combobox-driven selection flows through ShellLogic
    combo = win.cell_combos[2]
    combo.setCurrentIndex(combo.findData("micro_doppler_resp"))
    assert win.logic.panel.assignments[2] == "micro_doppler_resp"
    win.close()
    del app


# --- pyqtgraph tier, executed headless via the fake-module shim ------------- #
# (pg_shim.py): every Pg view class's math — dB conversion, [y,x]->[x,y]
# transposes, setRect physical extents, LUT coloring — runs for real; only
# the Qt/GL surface is doubled.  Reference anchors:
# views/range_doppler_view.py:39-78, views/point_cloud_view.py:26-156.
@pytest.fixture()
def pg_classes(monkeypatch):
    import pg_shim

    pg_shim.install(monkeypatch)
    from mmwave_radar_processing_jax.visualization import pyqtgraph_views

    assert pyqtgraph_views.pyqtgraph_available()
    return pyqtgraph_views.get_pg_view_classes()


def _rect_tuple(rect):
    return (rect.x(), rect.y(), rect.width(), rect.height())


def test_pg_registry_covers_matplotlib_tier(pg_classes):
    from mmwave_radar_processing_jax.visualization.views import VIEW_CLASSES

    assert set(pg_classes) >= set(VIEW_CLASSES) - {
        "sequential_detector", "ground_detector"}


def test_pg_heatmap_view_transpose_rect_and_db(pg_classes):
    view = pg_classes["range_angle"](db_mode=False)
    data = np.random.default_rng(0).random((10, 20)) + 0.1
    rb, ab = np.linspace(0, 10, 10), np.linspace(-1, 1, 20)
    payload = {"data": data, "range_bins": rb, "angle_bins": ab}
    view.set_data(payload)
    assert view.latest_payload is payload
    # processor output is [range, angle]; pg images index [x=angle, y=range]
    np.testing.assert_allclose(view.image.image, np.abs(data).T)
    assert view.image.auto_levels is True
    assert _rect_tuple(view.image.rect) == pytest.approx(
        (ab[0], rb[0], ab[-1] - ab[0], rb[-1] - rb[0]))
    assert view.plot.title.endswith("(mag)")
    view.set_db_mode(True)  # re-renders the cached payload in dB
    np.testing.assert_allclose(view.image.image, _db(data.T))
    assert view.plot.title.endswith("(dB)")
    assert view.image.lut is not None  # viridis LUT installed


def test_pg_range_doppler_and_micro_doppler_views(pg_classes):
    data = np.random.default_rng(3).random((12, 18)) + 0.1
    rd = pg_classes["range_doppler"](db_mode=True)
    rd.set_data({"data": data, "range_bins": np.linspace(0, 5, 12),
                 "vel_bins": np.linspace(-2, 2, 18)})
    np.testing.assert_allclose(rd.image.image, _db(data.T))

    md = pg_classes["micro_doppler"](db_mode=False)
    md.set_data({"data": data, "vel_bins": np.linspace(-5, 5, 12),
                 "time_bins": np.linspace(0, 2, 18)})
    np.testing.assert_allclose(md.image.image, np.abs(data).T)


def test_pg_doppler_azimuth_zoomed_bins_precedence(pg_classes):
    view = pg_classes["doppler_azimuth"](db_mode=False)
    data = np.random.default_rng(2).random((15, 25)) + 0.1
    base = {"data": data, "vel_bins": np.linspace(-5, 5, 15),
            "valid_angle_bins": np.linspace(-1, 1, 25)}
    view.set_data(base)
    assert view.image.rect.y() == pytest.approx(-5.0)
    zoomed = np.linspace(-0.3, 0.3, 15)
    view.set_data(dict(base, zoomed_vel_bins=zoomed))
    assert view.image.rect.y() == pytest.approx(zoomed[0])
    # a zoomed grid that does NOT match the data rows is ignored
    view.set_data(dict(base, zoomed_vel_bins=zoomed[:7]))
    assert view.image.rect.y() == pytest.approx(-5.0)


def test_pg_range_response_view(pg_classes):
    view = pg_classes["range_response"](db_mode=False)
    data = np.random.default_rng(4).random(64) + 0.1
    rb = np.linspace(0, 4, 64)
    view.set_data({"data": data, "range_bins": rb})
    np.testing.assert_allclose(view.curve.y, data)
    np.testing.assert_allclose(view.curve.x, rb)
    view.set_db_mode(True)
    np.testing.assert_allclose(view.curve.y, _db(data))


def test_pg_range_doppler_detector_view(pg_classes):
    view = pg_classes["range_doppler_detector"](db_mode=False)
    resp = np.random.default_rng(5).random((12, 18)) + 0.1
    rb, vb = np.linspace(0, 5, 12), np.linspace(-2, 2, 18)
    dets = np.array([[3, 4], [7, 10]])
    view.set_data({"data": dets, "rng_dop_resp": resp,
                   "range_bins": rb, "vel_bins": vb})
    np.testing.assert_allclose(view.image.image, np.abs(resp).T)
    np.testing.assert_allclose(view.markers.x, vb[dets[:, 1]])
    np.testing.assert_allclose(view.markers.y, rb[dets[:, 0]])
    # empty detection set clears the markers without crashing
    view.set_data({"data": np.empty((0, 2), int), "rng_dop_resp": resp,
                   "range_bins": rb, "vel_bins": vb})
    assert view.markers.x.size == 0


def test_pg_range_detector_view(pg_classes):
    view = pg_classes["range_detector"](db_mode=False)
    resp = np.random.default_rng(6).random(64) + 0.1
    thr = np.full(64, 0.5)
    thr[:5] = np.inf  # CFAR edge bins: masked out of the threshold curve
    rb = np.linspace(0, 4, 64)
    dets = np.array([10, 20])
    view.set_data({"data": dets, "range_resp": resp, "thresholds": thr,
                   "range_bins": rb})
    np.testing.assert_allclose(view.curve.y, np.abs(resp))
    assert view.thr_curve.x.size == 59  # only the finite threshold bins
    np.testing.assert_allclose(view.thr_curve.y, np.full(59, 0.5))
    np.testing.assert_allclose(view.markers.x, rb[dets])
    np.testing.assert_allclose(view.markers.y, np.abs(resp)[dets])


def test_pg_altitude_view(pg_classes):
    view = pg_classes["altitude"](db_mode=False)
    coarse = np.random.default_rng(10).random(64) + 0.1
    view.set_data({"data": np.array(1.25), "coarse_fft_data": coarse,
                   "range_bins": np.linspace(0, 4, 64)})
    assert view.marker.value == pytest.approx(1.25)
    np.testing.assert_allclose(view.curve.y, coarse)


def test_pg_point_cloud_3d_view(pg_classes):
    from matplotlib import pyplot as plt

    view = pg_classes["point_cloud_3d"](min_vel=-0.25, max_vel=0.25)
    pts = np.column_stack([np.random.default_rng(9).random((30, 3)),
                           np.linspace(-1.0, 1.0, 30)])
    view.set_data({"data": pts})
    np.testing.assert_allclose(view.scatter.pos, pts[:, :3])
    # velocity -> viridis with clipping to the configured window
    # (ref point_cloud_view.py:66-68,147)
    t = np.clip((pts[:, 3] + 0.25) / 0.5, 0.0, 1.0)
    want = plt.get_cmap("viridis")(np.linspace(0, 1, 256))[
        (t * 255).astype(int)]
    np.testing.assert_allclose(view.scatter.color, want)
    view.set_data({"data": np.empty((0, 4))})  # empty cloud clears, no crash
    assert view.scatter.pos.shape == (0, 3)
    # 2D registry key renders through the same GL class (single ref GL view)
    assert issubclass(pg_classes["point_cloud"], type(view))


def test_pg_point_cloud_colorbar_extents(pg_classes):
    """Colorbar gradient spans exactly [min_vel, max_vel], labeled in m/s —
    the round-2 matplotlib bug class (wrong/leaking bar)."""
    view = pg_classes["point_cloud_3d"](min_vel=-0.5, max_vel=1.5)
    assert _rect_tuple(view._cb_img.rect) == pytest.approx((0, -0.5, 1, 2.0))
    assert view._cb_plot.y_range == pytest.approx((-0.5, 1.5))
    assert view._cb_plot.getAxis("right").label == "Velocity (m/s)"
    # gradient image is the 256-step viridis LUT
    assert view._cb_img.image.shape[1] == 256


