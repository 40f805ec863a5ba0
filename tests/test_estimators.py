"""Ego-velocity estimators + analysis layer.

Parity where the math is deterministic (responses, peaks, analyzers, gates);
behavioral recovery tests for the RANSAC-based estimates (different PRNG
streams than sklearn, same contract).
"""

import sys

import numpy as np
import pytest

from tests.conftest import REFERENCE_ROOT, requires_reference, reference_available

from mmwave_radar_processing_jax.analysis import VelocityAnalyzer
from mmwave_radar_processing_jax.data import Scene, ground_scene, simulate_frame
from mmwave_radar_processing_jax.point_cloud_processing import (
    VehicleVelEstimator,
    VelocityEstimator as PointsVelocityEstimator,
)
from mmwave_radar_processing_jax.processors.velocity_estimator import VelocityEstimator
from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter

if reference_available():
    sys.path.insert(0, REFERENCE_ROOT)


def _ground_points(rng, ego_vel, n=120, n_out=20, planar=False):
    """Ground point cloud: vel = -(p/|p|) . ego_vel + outliers.

    ``planar=True`` keeps points in the z=0 plane so the 2D estimators'
    model (velocity from the normalized 2D direction) holds exactly.
    """
    dirs = rng.standard_normal((n, 3))
    if planar:
        dirs[:, 2] = 0.0
    else:
        dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5  # below the sensor-ish
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = rng.uniform(0.5, 3.0, n)
    p = dirs * r[:, None]
    vel = -dirs @ np.asarray(ego_vel) + 0.02 * rng.standard_normal(n)
    out = rng.choice(n, n_out, replace=False)
    vel[out] += rng.uniform(0.5, 2.0, n_out) * rng.choice([-1, 1], n_out)
    return np.column_stack([p, vel])


def test_points_velocity_estimator_ods(flagship_config, rng):
    est = PointsVelocityEstimator(flagship_config, min_R2_threshold=0.6,
                                  min_inlier_percent=0.6)
    ego = np.array([0.4, -0.2, 1.0])
    pts = _ground_points(rng, ego)
    out = est.process(points=pts)
    np.testing.assert_allclose(out, ego, atol=0.05)
    assert est.estimated_R2 > 0.9

    # gate behavior: garbage points keep the last valid estimate
    garbage = _ground_points(rng, ego)
    garbage[:, 3] = rng.uniform(-2, 2, garbage.shape[0])
    out2 = est.process(points=garbage)
    np.testing.assert_allclose(out2, out)  # unchanged


def test_points_velocity_estimator_standard(flagship_cfg_path, rng):
    from mmwave_radar_processing_jax.config import load_cfg

    cfg = load_cfg(str(flagship_cfg_path), array_geometry="standard")
    est = PointsVelocityEstimator(cfg, min_R2_threshold=0.5, min_inlier_percent=0.5)
    ego2d = np.array([0.8, -0.3])
    pts = _ground_points(rng, np.array([ego2d[0], ego2d[1], 0.0]), planar=True)
    out = est.process(points=pts)
    np.testing.assert_allclose(out[:2], ego2d, atol=0.06)
    assert out[2] == 0.0


def test_vehicle_vel_estimator(rng):
    est = VehicleVelEstimator(points_per_fit=7, max_iters=100, fit_thresh=0.05,
                              num_close_pts=10, static_vel_thresh=0.2)
    ego = np.array([1.0, -0.5])
    # environment velocity measured = -ego in radial projection
    pts = _ground_points(rng, np.array([ego[0], ego[1], 0.0]), planar=True)
    out = est.estimate_ego_vel(pts, only_2D=True)
    assert out.shape == (2,)
    np.testing.assert_allclose(out, ego, atol=0.08)

    # static prefilter path
    out2 = est.estimate_ego_vel(pts, initial_ego_vel_est=out, only_2D=True)
    np.testing.assert_allclose(out2, ego, atol=0.08)

    # too few points -> empty
    assert est.estimate_ego_vel(pts[:5]).size == 0


@requires_reference
def test_adc_velocity_estimator_responses_parity(flagship_config, flagship_cfg_path):
    """The deterministic parts (responses, zero-az vx) match the reference."""
    from mmwave_radar_processing.config_managers.cfgManager import ConfigManager
    from mmwave_radar_processing.processors.velocity_estimator import (
        VelocityEstimator as RefVE,
    )
    from mmwave_radar_processing.processors.virtual_array_reformater import (
        VirtualArrayReformatter as RefVAR,
    )

    ref_cfg = ConfigManager()
    ref_cfg.load_cfg(str(flagship_cfg_path), array_geometry="ods", array_direction="down")

    altitude = 1.2
    ego = np.array([0.3, 0.1, 0.8])  # sim-frame ego velocity (x=boresight/down)
    scene = ground_scene(flagship_config, altitude_m=altitude, ego_vel=ego,
                         num_patches=64, rng=np.random.default_rng(5), noise_sigma=0.03)
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(6)).astype(
        np.complex128
    )
    virt = np.asarray(RefVAR(ref_cfg).process(raw))

    kwargs = dict(lower_range_bound=0.5, upper_range_bound=0.5)
    ref_ve = RefVE(ref_cfg, **kwargs)
    ours_ve = VelocityEstimator(flagship_config, **kwargs)

    ref_out = ref_ve.process(adc_cube=virt, altitude=altitude)
    ours_out = ours_ve.process(adc_cube=virt, altitude=altitude)

    # responses are deterministic -> parity
    np.testing.assert_allclose(
        np.asarray(ours_ve.azimuth_response_mag),
        ref_ve.azimuth_response_mag,
        rtol=3e-4, atol=3e-4 * np.max(ref_ve.azimuth_response_mag),
    )
    np.testing.assert_allclose(
        np.asarray(ours_ve.elevation_response_mag),
        ref_ve.elevation_response_mag,
        rtol=3e-4, atol=3e-4 * np.max(ref_ve.elevation_response_mag),
    )
    # zero-azimuth vx readout is deterministic -> exact bin parity
    np.testing.assert_allclose(ours_ve.ego_vx_estimate, ref_ve.ego_vx_estimate,
                               atol=1e-6)
    # row peaks agree
    np.testing.assert_allclose(
        np.sort(ours_ve.azimuth_peaks, axis=0),
        np.sort(ref_ve.azimuth_peaks, axis=0),
        atol=1e-6,
    )
    # RANSAC estimates share the contract: both within a few cm/s of each other
    np.testing.assert_allclose(ours_out, ref_out, atol=0.08)


def test_adc_velocity_estimator_recovers_vx(flagship_config):
    """Behavioral: zero-azimuth Doppler reads out the boresight velocity."""
    altitude = 1.2
    ego = np.array([0.5, 0.0, 0.0])  # pure boresight motion
    scene = ground_scene(flagship_config, altitude_m=altitude, ego_vel=ego,
                         num_patches=64, rng=np.random.default_rng(2), noise_sigma=0.03)
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(3))
    virt = VirtualArrayReformatter(flagship_config).process(raw)
    ve = VelocityEstimator(flagship_config, lower_range_bound=0.5, upper_range_bound=0.5)
    ve.process(adc_cube=np.asarray(virt), altitude=altitude)
    # vx estimate = -zero-az peak vel; ground recedes at +0.5 when moving down
    assert abs(ve.ego_vx_estimate - 0.5) < 0.1, ve.ego_vx_estimate


def test_velocity_analyzer_report():
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((50, 3))
    est = gt + 0.1 * rng.standard_normal((50, 3))
    an = VelocityAnalyzer()
    an.analyze(est, gt, error_method="signed")
    report = an.generate_report()
    assert list(report.index) == ["X", "Y", "Z", "Norm"]
    assert set(report.columns) == {"Mean", "Median", "RMSE", "90% Tail"}
    np.testing.assert_allclose(
        report.loc["X", "RMSE"], np.sqrt(np.mean((est[:, 0] - gt[:, 0]) ** 2))
    )
    assert report.loc["Norm", "Mean"] > 0


@requires_reference
def test_ransac_statistical_parity(flagship_cfg_path):
    """End-to-end velocity-error statistics match the reference's sklearn RANSAC.

    Our RANSAC uses a different PRNG stream than sklearn (contract-level
    parity only per frame), so this pins the *statistical* contract instead:
    over N simulated point-cloud frames fed identically to both estimators
    (ref ``lsq_fit_ego_vel_ransac_points``, velocity_estimator.py:379-386,
    and the R^2 gates :427-434 / :597-638), the VelocityAnalyzer
    Mean/RMSE/90%-tail error statistics agree within 0.02 m/s.
    """
    from mmwave_radar_processing.config_managers.cfgManager import ConfigManager
    from mmwave_radar_processing.processors.velocity_estimator import (
        VelocityEstimator as RefVE,
    )
    from mmwave_radar_processing_jax.config import load_cfg

    ref_cfg = ConfigManager()
    ref_cfg.load_cfg(str(flagship_cfg_path), array_geometry="standard",
                     array_direction="down")
    cfg = load_cfg(str(flagship_cfg_path), array_geometry="standard",
                   array_direction="down")

    kwargs = dict(lower_range_bound=0.5, upper_range_bound=0.5)
    ref_ve = RefVE(ref_cfg, **kwargs)
    ours_ve = VelocityEstimator(cfg, **kwargs)

    rng = np.random.default_rng(11)
    n_frames = 40
    ref_est, ours_est, gts = [], [], []
    for _ in range(n_frames):
        ego2d = rng.uniform(-1.0, 1.0, 2)
        gt = np.array([ego2d[0], ego2d[1], 0.0])
        pts = _ground_points(rng, gt, planar=True)
        ref_est.append(np.array(ref_ve.process(points=pts), float).copy())
        ours_est.append(np.array(ours_ve.process(points=pts), float).copy())
        gts.append(gt)
    ref_est, ours_est, gts = map(np.array, (ref_est, ours_est, gts))

    ref_an, ours_an = VelocityAnalyzer(), VelocityAnalyzer()
    ref_an.analyze(ref_est, gts, error_method="absolute")
    ours_an.analyze(ours_est, gts, error_method="absolute")
    ref_report = ref_an.generate_report()
    ours_report = ours_an.generate_report()
    # both recover the planted velocities...
    assert ref_report.loc["Norm", "RMSE"] < 0.1
    assert ours_report.loc["Norm", "RMSE"] < 0.1
    # ...and the error statistics agree to 2 cm/s across every cell
    np.testing.assert_allclose(ours_report.values, ref_report.values, atol=0.02)


@requires_reference
def test_velocity_analyzer_parity(rng):
    from mmwave_radar_processing.analysis.velocity_analyzer import (
        VelocityAnalyzer as RefVA,
    )

    gt = rng.standard_normal((40, 3))
    est = gt + 0.2 * rng.standard_normal((40, 3))
    ours, ref = VelocityAnalyzer(), RefVA()
    ours.analyze(est, gt, "signed")
    ref.analyze(est, gt, "signed")
    np.testing.assert_allclose(
        ours.generate_report().values, ref.generate_report().values, rtol=1e-12
    )


def test_hybrid_vy_tolerates_zero_padded_points(flagship_cfg_path, rng):
    """Fixed-capacity zero-padded point rows must not NaN the hybrid fit.

    Round-5 review regression: the framework's own point clouds zero invalid
    rows; normalizing a zero row produced NaN directions that poisoned every
    RANSAC trial.
    """
    from mmwave_radar_processing_jax.config import load_cfg
    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        VelocityEstimator,
    )

    cfg = load_cfg(str(flagship_cfg_path).replace(
        "6843_RadVel_ods_20Hz", "1843_RadVel_20Hz"),
        array_geometry="standard", array_direction="out")
    ego = np.array([0.9, 0.3, 0.0])
    pts = _ground_points(rng, ego, n=80, n_out=5, planar=True)
    padded = np.concatenate([pts, np.zeros((48, 4), pts.dtype)])

    est = VelocityEstimator(cfg, lower_range_bound=0.5, upper_range_bound=0.5,
                            min_R2_threshold=0.2, min_inlier_percent=0.3,
                            vy_mode="hybrid_points")
    vy, r2, inl = est.lsq_fit_ego_vy_ransac_points_fixed_vx(padded, ego[0])
    assert np.isfinite([vy, r2, inl]).all()
    assert abs(vy - ego[1]) < 0.08
    # unpadded agreement: the zero rows are excluded, not merely survived
    vy2, _, _ = est.lsq_fit_ego_vy_ransac_points_fixed_vx(pts, ego[0])
    assert abs(vy - vy2) < 0.05
