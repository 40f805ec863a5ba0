"""End-to-end ADC-path accuracy: fused velocity pipeline vs live reference.

The accuracy leg of the north star: N simulated down-facing recordings run
through BOTH the fused velocity pipeline and the reference's
``VelocityEstimator.process(adc_cube, altitude)`` ADC path
(``/root/reference/.../velocity_estimator.py:785-872``), then
``VelocityAnalyzer`` summary statistics (Mean/RMSE/90% tail, per axis) are
compared against the same ground truth.  The pipelines must agree per-frame
on the deterministic ``vx`` readout and track each other's error statistics
within a stated bound (RANSAC seeds differ between the implementations).

Estimate-space convention (ODS, down-facing): ``[vy_az, vz_el, vx]`` — the
reference's ``current_velocity_estimate`` layout (:597-621).
"""

import sys

import numpy as np
import pytest

from tests.conftest import REFERENCE_ROOT, requires_reference

from mmwave_radar_processing_jax.analysis import VelocityAnalyzer
from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
    build_velocity_pipeline,
)
from mmwave_radar_processing_jax.processors import VirtualArrayReformatter

pytestmark = requires_reference

sys.path.insert(0, REFERENCE_ROOT)

EGO_VELS = [
    (1.2, 0.3, -0.1),
    (1.0, 0.5, 0.2),
    (1.4, -0.3, 0.0),
    (0.9, 0.4, 0.1),
]
FRAMES_PER_VEL = 4
ALTITUDE = 1.2


@pytest.fixture(scope="module")
def recordings(flagship_config):
    rng = np.random.default_rng(17)
    raws, gts = [], []
    for ego in EGO_VELS:
        for _ in range(FRAMES_PER_VEL):
            scene = ground_scene(flagship_config, altitude_m=ALTITUDE,
                                 ego_vel=np.asarray(ego), num_patches=200,
                                 rng=rng, noise_sigma=0.01)
            raws.append(simulate_frame(flagship_config, scene, rng))
            gts.append([ego[1], ego[2], ego[0]])  # estimate space [vy, vz, vx]
    return np.stack(raws), np.asarray(gts, np.float32)


def _summary(est, gt):
    an = VelocityAnalyzer()
    an.analyze(history_estimated=est, history_gt=gt, error_method="signed")
    return an.generate_report()


def test_adc_velocity_accuracy_tracks_reference(flagship_config, flagship_cfg_path, recordings):
    from mmwave_radar_processing.config_managers.cfgManager import (
        ConfigManager as RefConfigManager,
    )
    from mmwave_radar_processing.processors.velocity_estimator import (
        VelocityEstimator as RefVelocityEstimator,
    )

    raw, gt = recordings
    n = raw.shape[0]

    fn = build_velocity_pipeline(flagship_config, min_r2_threshold=0.2,
                                 min_inlier_percent=0.3)
    ours = np.asarray(
        fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32),
           np.full(n, ALTITUDE, np.float32)).velocity
    )

    ref_cfg = RefConfigManager()
    ref_cfg.load_cfg(str(flagship_cfg_path), "ods", "down")
    var = VirtualArrayReformatter(flagship_config)
    ve = RefVelocityEstimator(ref_cfg, lower_range_bound=0.5,
                              upper_range_bound=0.5, min_R2_threshold=0.2,
                              min_inlier_percent=0.3)
    theirs = np.stack([
        ve.process(adc_cube=np.asarray(var.process(raw[i])),
                   altitude=ALTITUDE).copy()
        for i in range(n)
    ])

    # deterministic vx readout agrees per-frame
    np.testing.assert_allclose(ours[:, 2], theirs[:, 2], atol=1e-4)
    # RANSAC-dependent vy/vz agree within seed noise per frame
    np.testing.assert_allclose(ours[:, :2], theirs[:, :2], atol=0.45)

    rep_ours = _summary(ours, gt)
    rep_ref = _summary(theirs, gt)
    print("\n== fused pipeline ==\n", rep_ours)
    print("== reference ADC path ==\n", rep_ref)

    # summary statistics track the reference within the stated bound
    for axis in ("X", "Y", "Z", "Norm"):
        for stat in ("Mean", "RMSE", "90% Tail"):
            a = float(rep_ours.loc[axis, stat])
            b = float(rep_ref.loc[axis, stat])
            assert abs(a - b) <= 0.15, (
                f"{axis}/{stat}: ours {a:.3f} vs reference {b:.3f}")
    # and the estimates are genuinely informative (vx within 0.15 m/s RMSE
    # of truth for both implementations)
    assert float(rep_ours.loc["Z", "RMSE"]) <= 0.2
    assert float(rep_ref.loc["Z", "RMSE"]) <= 0.2


# --- second geometry: standard/outward (round 4) --------------------------- #
STD_EGO_VELS = [
    (1.0, 0.3),
    (0.8, -0.4),
    (1.2, 0.0),
    (0.6, 0.5),
]
STD_CFG = "1843_RadVel_20Hz.cfg"


def _std_scene_and_points(cfg, ego, rng, n_targets=150):
    """Outward-facing standard-geometry scene + matching (x, y, z, vd) points.

    Targets spread across the azimuth fan at ~zero elevation (the 8-element
    line resolves azimuth only); each radial velocity is ``-u . v_ego`` —
    the geometry both the ADC sub-array path and the 2D points path invert.
    """
    from mmwave_radar_processing_jax.data import PointTarget, Scene

    vx, vy = ego
    targets, pts = [], []
    for _ in range(n_targets):
        az = rng.uniform(-0.95, 0.95)
        el = rng.uniform(-0.03, 0.03)
        r = rng.uniform(1.5, 0.7 * cfg.range_max_m)
        u = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                      np.sin(el)])
        vd = -(u[0] * vx + u[1] * vy)
        targets.append(PointTarget(range_m=r, azimuth_rad=az,
                                   elevation_rad=el, velocity_m_s=vd,
                                   rcs=float(rng.uniform(2.0, 5.0))))
        pts.append([r * u[0], r * u[1], r * u[2],
                    vd + rng.normal(0.0, 0.02)])
    return Scene(targets=targets, noise_sigma=0.01), np.asarray(pts, np.float32)


@pytest.fixture(scope="module")
def std_recordings():
    import os

    from mmwave_radar_processing_jax.config import load_cfg

    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            STD_CFG)
    cfg = load_cfg(cfg_path, array_geometry="standard", array_direction="out")
    rng = np.random.default_rng(23)
    raws, pt_clouds, gts = [], [], []
    for ego in STD_EGO_VELS:
        for _ in range(FRAMES_PER_VEL):
            scene, pts = _std_scene_and_points(cfg, ego, rng)
            raws.append(simulate_frame(cfg, scene, rng))
            pt_clouds.append(pts)
            gts.append([ego[0], ego[1], 0.0])  # standard space [vx, vy, 0]
    return cfg, os.path.abspath(cfg_path), np.stack(raws), pt_clouds, \
        np.asarray(gts, np.float32)


def test_standard_geometry_adc_accuracy_tracks_reference(std_recordings):
    """Outward standard-geometry ADC path: ours vs the live reference.

    Reference anchors: standard sub-array selection
    ``velocity_estimator.py:169-188``, estimate assembly ``[vx, vy, 0]``
    (:679-684 standard branch).
    """
    from mmwave_radar_processing.config_managers.cfgManager import (
        ConfigManager as RefConfigManager,
    )
    from mmwave_radar_processing.processors.velocity_estimator import (
        VelocityEstimator as RefVelocityEstimator,
    )

    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        VelocityEstimator,
    )

    cfg, cfg_path, raw, _, gt = std_recordings
    n = raw.shape[0]
    var = VirtualArrayReformatter(cfg)
    virt = [np.asarray(var.process(raw[i])) for i in range(n)]

    ours_est = VelocityEstimator(cfg, lower_range_bound=0.5,
                                 upper_range_bound=0.5, min_R2_threshold=0.2,
                                 min_inlier_percent=0.3)
    ours = np.stack([
        np.asarray(ours_est.process(adc_cube=virt[i], altitude=0.0)).copy()
        for i in range(n)
    ])

    ref_cfg = RefConfigManager()
    ref_cfg.load_cfg(cfg_path, "standard", "out")
    ve = RefVelocityEstimator(ref_cfg, lower_range_bound=0.5,
                              upper_range_bound=0.5, min_R2_threshold=0.2,
                              min_inlier_percent=0.3)
    theirs = np.stack([
        ve.process(adc_cube=virt[i], altitude=0.0).copy() for i in range(n)
    ])

    # deterministic vx readout agrees per-frame
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], atol=1e-3)

    rep_ours = _summary(ours, gt)
    rep_ref = _summary(theirs, gt)
    print("\n== standard ADC path, ours ==\n", rep_ours)
    print("== standard ADC path, reference ==\n", rep_ref)
    for axis in ("X", "Y", "Norm"):
        for stat in ("Mean", "RMSE", "90% Tail"):
            a = float(rep_ours.loc[axis, stat])
            b = float(rep_ref.loc[axis, stat])
            assert abs(a - b) <= 0.15, (
                f"{axis}/{stat}: ours {a:.3f} vs reference {b:.3f}")
    # vx genuinely informative for both
    assert float(rep_ours.loc["X", "RMSE"]) <= 0.2
    assert float(rep_ref.loc["X", "RMSE"]) <= 0.2


def test_standard_geometry_points_accuracy_tracks_reference(std_recordings):
    """2D points path: ours vs reference ``point_cloud_processing``
    (reference ``vel_estimator.py:76-122`` 2D RANSAC fit)."""
    from mmwave_radar_processing.config_managers.cfgManager import (
        ConfigManager as RefConfigManager,
    )
    from mmwave_radar_processing.point_cloud_processing.vel_estimator import (
        VelocityEstimator as RefPointsEstimator,
    )

    from mmwave_radar_processing_jax.point_cloud_processing.vel_estimator import (
        VelocityEstimator as PointsEstimator,
    )

    cfg, cfg_path, _, pt_clouds, gt = std_recordings
    ref_cfg = RefConfigManager()
    ref_cfg.load_cfg(cfg_path, "standard", "out")

    ours_est = PointsEstimator(cfg, min_R2_threshold=0.2)
    ref_est = RefPointsEstimator(ref_cfg, min_R2_threshold=0.2)
    ours = np.stack([np.asarray(ours_est.process(points=p)).copy()
                     for p in pt_clouds])
    theirs = np.stack([ref_est.process(points=p).copy() for p in pt_clouds])

    rep_ours = _summary(ours, gt)
    rep_ref = _summary(theirs, gt)
    print("\n== standard points path, ours ==\n", rep_ours)
    print("== standard points path, reference ==\n", rep_ref)
    for axis in ("X", "Y", "Norm"):
        for stat in ("Mean", "RMSE", "90% Tail"):
            a = float(rep_ours.loc[axis, stat])
            b = float(rep_ref.loc[axis, stat])
            assert abs(a - b) <= 0.15, (
                f"{axis}/{stat}: ours {a:.3f} vs reference {b:.3f}")
    assert float(rep_ours.loc["Norm", "RMSE"]) <= 0.25
    assert float(rep_ref.loc["Norm", "RMSE"]) <= 0.25


def test_standard_geometry_hybrid_beats_both(std_recordings):
    """Hybrid mode: ADC vx + vx-constrained points vy beats both references.

    Round-5 mandate: the standard-geometry ADC vy leg is only as good as the
    reference's weak row-peak fit (RMSE ~1.58 m/s on BOTH implementations);
    the points path achieves ~0.003 on the same scenes.  The documented
    ``vy_mode="hybrid_points"`` fuses the deterministic ADC zero-azimuth vx
    with a vx-constrained 1D points RANSAC for vy — same 16-recording suite,
    vy RMSE must land at least 5x under the mandated 0.3 m/s bar while vx
    stays bit-compatible with the parity mode.
    """
    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        VelocityEstimator,
    )

    cfg, cfg_path, raw, pt_clouds, gt = std_recordings
    n = raw.shape[0]
    var = VirtualArrayReformatter(cfg)
    virt = [np.asarray(var.process(raw[i])) for i in range(n)]

    kwargs = dict(lower_range_bound=0.5, upper_range_bound=0.5,
                  min_R2_threshold=0.2, min_inlier_percent=0.3)
    hybrid_est = VelocityEstimator(cfg, vy_mode="hybrid_points", **kwargs)
    hybrid = np.stack([
        np.asarray(hybrid_est.process(adc_cube=virt[i], points=pt_clouds[i],
                                      altitude=0.0)).copy()
        for i in range(n)
    ])
    parity_est = VelocityEstimator(cfg, **kwargs)
    parity = np.stack([
        np.asarray(parity_est.process(adc_cube=virt[i], altitude=0.0)).copy()
        for i in range(n)
    ])

    # vx: identical to the parity mode per frame (deterministic readout)
    np.testing.assert_allclose(hybrid[:, 0], parity[:, 0], atol=1e-6)

    rep_h = _summary(hybrid, gt)
    rep_p = _summary(parity, gt)
    print("\n== standard hybrid (ADC vx + points vy) ==\n", rep_h)
    print("== standard parity ADC mode ==\n", rep_p)
    vy_rmse_h = float(rep_h.loc["Y", "RMSE"])
    vy_rmse_p = float(rep_p.loc["Y", "RMSE"])
    # the mandated bar is <= 0.3; demand a decisive margin
    assert vy_rmse_h <= 0.06, vy_rmse_h
    # and it genuinely beats the parity/reference row-peak fit on this suite
    assert vy_rmse_h < 0.25 * vy_rmse_p, (vy_rmse_h, vy_rmse_p)
    assert float(rep_h.loc["Norm", "RMSE"]) <= \
        float(rep_p.loc["Norm", "RMSE"])

    # misconfiguration guards
    import pytest as _pytest

    with _pytest.raises(ValueError, match="unknown vy_mode"):
        VelocityEstimator(cfg, vy_mode="typo", **kwargs)
