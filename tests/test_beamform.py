"""Capon / Bartlett covariance beamforming: numpy-oracle parity + physics.

The reference has no Capon/Bartlett path (its AoA is a zero-padded FFT,
``point_cloud_generator.py:143-214``), so parity here is against a direct
numpy complex-arithmetic oracle, plus physical checks on simulated scenes:
peaks land on the planted targets on the exact reference angle grid, and
Capon resolves targets Bartlett cannot.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mmwave_radar_processing_jax.config import grids
from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
from mmwave_radar_processing_jax.data.simulator import ods_geometry
from mmwave_radar_processing_jax.ops import beamform as bf, mxu
from mmwave_radar_processing_jax.processors.beamforming import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
    ODS_AZ_IDXS,
    ODS_EL_IDXS,
    l_array_positions,
)
from mmwave_radar_processing_jax.processors.virtual_array import (
    VirtualArrayReformatter,
)


# ------------------------------------------------------------------ oracles
def np_covariance(x: np.ndarray) -> np.ndarray:
    return x @ x.conj().swapaxes(-1, -2) / x.shape[-1]


def np_bartlett(x: np.ndarray, steer: np.ndarray) -> np.ndarray:
    r = np_covariance(x)
    return np.real(np.einsum("am,...ab,bm->...m", steer.conj(), r, steer))


def np_capon(x: np.ndarray, steer: np.ndarray, loading: float) -> np.ndarray:
    r = np_covariance(x)
    a = r.shape[-1]
    tr = np.trace(r, axis1=-2, axis2=-1).real[..., None, None]
    r = r + (loading * tr / a + 1e-12) * np.eye(a)
    y = np.linalg.solve(r, np.broadcast_to(steer, r.shape[:-2] + steer.shape))
    denom = np.real(np.einsum("am,...am->...m", steer.conj(), y))
    return 1.0 / denom


def random_snapshots(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def steer_np(steering: mxu.C2) -> np.ndarray:
    return np.asarray(steering.re) + 1j * np.asarray(steering.im)


# ------------------------------------------------------------------ parity
def test_spatial_covariance_matches_numpy(rng):
    x = random_snapshots(rng, (5, 12, 70))
    r = bf.spatial_covariance(mxu.from_complex(x))
    np.testing.assert_allclose(
        mxu.to_complex(r), np_covariance(x), rtol=1e-5, atol=1e-5
    )


def test_bartlett_paths_agree_and_match_numpy(rng):
    x = random_snapshots(rng, (7, 12, 70))
    steering = bf.steering_ula(grids.phase_shift_bins(64), 12)
    c2 = mxu.from_complex(x)

    from_snap = np.asarray(bf.bartlett_from_snapshots(c2, steering))
    from_cov = np.asarray(
        bf.bartlett_from_covariance(bf.spatial_covariance(c2), steering)
    )
    oracle = np_bartlett(x, steer_np(steering))
    np.testing.assert_allclose(from_snap, from_cov, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(from_snap, oracle, rtol=1e-4, atol=1e-3)


def test_capon_matches_numpy_oracle(rng):
    x = random_snapshots(rng, (4, 8, 40))
    steering = bf.steering_ula(grids.phase_shift_bins(48), 8)
    got = np.asarray(
        bf.capon_from_covariance(
            bf.spatial_covariance(mxu.from_complex(x)), steering, loading=1e-2
        )
    )
    oracle = np_capon(x, steer_np(steering), 1e-2)
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-5)


def test_capon_rejects_unknown_method(rng):
    """A typo'd or retired method string must raise, not silently run 'solve'.

    'pallas' named a kernel that no longer exists; it, or a typo such as
    'liv', must not fall through to the slow solve path.
    """
    import pytest

    x = random_snapshots(rng, (2, 4, 8))
    steering = bf.steering_ula(grids.phase_shift_bins(16), 4)
    r = bf.spatial_covariance(mxu.from_complex(x))
    for bad in ("pallas", "liv", ""):
        with pytest.raises(ValueError, match="unknown method"):
            bf.capon_from_covariance(r, steering, method=bad)


def test_point_cloud_capon_aoa(flagship_config):
    """PointCloudGenerator(aoa_method="capon") recovers a planted azimuth.

    The Capon-AoA option estimates each detection's angle from the MVDR
    spectrum of its range row (slow-time covariance) instead of the
    single-snapshot FFT; both must localize a clean planted target to the
    same grid neighborhood.
    """
    from mmwave_radar_processing_jax.processors import (
        PointCloudGenerator,
        VirtualArrayReformatter,
    )

    scene = Scene(targets=[
        PointTarget(range_m=1.5, azimuth_rad=0.25, velocity_m_s=0.3, rcs=4.0)
    ], noise_sigma=0.03)
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(11))
    virt = VirtualArrayReformatter(flagship_config).process(raw)

    kw = dict(az_antenna_idxs=list(ODS_AZ_IDXS), el_antenna_idxs=[9, 8, 5, 4],
              detector_type="range_doppler_detector_2d",
              detector_params=dict(cfar_type="os_cfar_2d",
                                   cfar_params=dict(num_train=(5, 5),
                                                    num_guard=(3, 2),
                                                    rho=0.7, alpha=4.0)))
    pts_fft = PointCloudGenerator(flagship_config, aoa_method="fft",
                                  **kw).process(virt)
    pts_cap = PointCloudGenerator(flagship_config, aoa_method="capon",
                                  **kw).process(virt)
    assert pts_fft.shape[0] and pts_cap.shape[0]

    def strongest_az(pts):
        # brightest detection = closest to the planted range
        i = int(np.argmin(np.abs(np.linalg.norm(pts[:, :3], axis=1) - 1.5)))
        return np.arctan2(pts[i, 1], pts[i, 0])

    az_f, az_c = strongest_az(pts_fft), strongest_az(pts_cap)
    assert abs(az_c - 0.25) < 0.1, az_c
    assert abs(az_c - az_f) < 0.1


def test_capon_large_aperture_cholesky_branch(rng):
    """n = 2A > 24 exercises the batched jnp.linalg.cholesky fallback.

    ``capon_from_covariance`` switches from the unrolled Cholesky to
    ``jnp.linalg.cholesky`` + ``cho_solve`` when the real embedding exceeds
    24 (ops/beamform.py) — a 16-antenna aperture (n=32) pins that branch
    against the same numpy oracle so it isn't dead-until-broken.
    """
    n_ant = 16  # 2A = 32 > 24
    x = random_snapshots(rng, (3, n_ant, 50))
    steering = bf.steering_ula(grids.phase_shift_bins(48), n_ant)
    got = np.asarray(
        bf.capon_from_covariance(
            bf.spatial_covariance(mxu.from_complex(x)), steering, loading=1e-2
        )
    )
    oracle = np_capon(x, steer_np(steering), 1e-2)
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("batch", [8, 13])
def test_bartlett_snapshots_matches_covariance(rng, batch):
    """mean_k |a^H x_k|^2 (the pipelines' Bartlett path) == a^H R a."""
    x = random_snapshots(rng, (batch, 12, 70))
    steering = bf.steering_ula(grids.phase_shift_bins(64), 12)
    c2 = mxu.from_complex(x)
    got = np.asarray(bf.bartlett_from_snapshots(c2, steering))
    ref = np.asarray(bf.bartlett_from_covariance(bf.spatial_covariance(c2),
                                                 steering))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------ physics
def test_ula_grid_convention_matches_reference_aoa():
    """A plane wave at azimuth ``az`` peaks at the reference grid bin ``az``."""
    az = 0.35
    n = np.arange(4)
    x = np.exp(-1j * np.pi * n * np.sin(az))[:, None].astype(np.complex64)
    steering = bf.steering_ula(grids.phase_shift_bins(64), 4)
    p = np.asarray(bf.bartlett_from_snapshots(mxu.from_complex(x), steering))
    angle_bins = grids.angle_bins(64)
    est = angle_bins[int(np.argmax(p))]
    assert abs(est - az) < np.pi / 63  # within one grid step


@pytest.mark.parametrize("cls", [BartlettBeamformerProcessor,
                                 CaponBeamformerProcessor])
def test_heatmap_peaks_on_planted_target(flagship_config, cls):
    scene = Scene(targets=[
        PointTarget(range_m=1.5, azimuth_rad=0.25, velocity_m_s=0.0, rcs=4.0)
    ])
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(3))
    virt = VirtualArrayReformatter(flagship_config).process(raw)
    proc = cls(flagship_config, antenna_idxs=ODS_AZ_IDXS)
    heat = np.asarray(proc.process(virt))
    assert heat.shape == (len(proc.range_bins), 64)
    r_i, a_i = np.unravel_index(np.argmax(heat), heat.shape)
    assert abs(proc.range_bins[r_i] - 1.5) < 2 * flagship_config.range_res_m
    assert abs(proc.angle_bins[a_i] - 0.25) < 2 * np.pi / 63


def test_capon_resolves_what_bartlett_cannot(flagship_config):
    """Two targets one Bartlett beamwidth apart: Capon separates them.

    With a 4-element ULA the Rayleigh beamwidth is ~2/4 rad; plant two equal
    targets 0.3 rad apart in the same range bin and compare the spectrum at
    the midpoint: Capon shows a dip (two resolved lobes), Bartlett does not.
    Distinct Dopplers decorrelate the sources across slow-time snapshots —
    coherent (equal-velocity) sources would give a rank-1 covariance that no
    inverse-covariance method can separate without spatial smoothing.
    """
    az1, az2 = -0.15, 0.15
    scene = Scene(targets=[
        PointTarget(range_m=1.5, azimuth_rad=az1, rcs=4.0, velocity_m_s=0.35),
        PointTarget(range_m=1.5, azimuth_rad=az2, rcs=4.0, velocity_m_s=-0.45,
                    phase_rad=1.3),
    ], noise_sigma=0.02)
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(5))
    virt = VirtualArrayReformatter(flagship_config).process(raw)

    bart = BartlettBeamformerProcessor(flagship_config, antenna_idxs=ODS_AZ_IDXS)
    capon = CaponBeamformerProcessor(flagship_config, antenna_idxs=ODS_AZ_IDXS,
                                     diagonal_loading=1e-3)
    r_i = int(np.argmin(np.abs(bart.range_bins - 1.5)))
    angle_bins = bart.angle_bins

    def depth(power_row):
        """Peak-to-midpoint ratio (>1 means two resolved lobes)."""
        i1 = int(np.argmin(np.abs(angle_bins - az1)))
        i2 = int(np.argmin(np.abs(angle_bins - az2)))
        mid = int(np.argmin(np.abs(angle_bins - 0.0)))
        lo, hi = min(i1, i2), max(i1, i2)
        side = max(power_row[lo], power_row[hi])
        return side / power_row[mid]

    bart_depth = depth(np.asarray(bart.process(virt))[r_i])
    capon_depth = depth(np.asarray(capon.process(virt))[r_i])
    assert capon_depth > 1.5, f"Capon failed to resolve (depth {capon_depth:.2f})"
    assert capon_depth > 2 * bart_depth


def test_azimuth_elevation_heatmap_full_aperture(flagship_config):
    """Full 12-element planar Capon az-el heatmap peaks on the target."""
    az_t, el_t = 0.3, -0.2
    scene = Scene(targets=[
        PointTarget(range_m=1.5, azimuth_rad=az_t, elevation_rad=el_t, rcs=4.0)
    ])
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(7))
    virt = VirtualArrayReformatter(flagship_config).process(raw)
    ys, zs = ods_geometry().virtual_offsets(4, [0, 1, 2])
    positions = np.stack([ys, zs], axis=1)

    proc = CaponBeamformerProcessor(flagship_config)
    r_i = int(np.argmin(np.abs(proc.range_bins - 1.5)))
    heat = proc.azimuth_elevation_heatmap(
        virt, r_i, positions=positions, num_az_bins=64, num_el_bins=32
    )
    assert heat.shape == (64, 32)
    a_i, e_i = np.unravel_index(np.argmax(heat), heat.shape)
    az_grid, el_grid = grids.angle_bins(64), grids.angle_bins(32)
    assert abs(az_grid[a_i] - az_t) < 2 * np.pi / 63
    assert abs(el_grid[e_i] - el_t) < 2 * np.pi / 31


def test_azimuth_elevation_heatmap_l_array_boresight(flagship_config):
    """L-array fallback geometry: boresight target peaks at (0, 0)."""
    scene = Scene(targets=[
        PointTarget(range_m=1.0, azimuth_rad=0.0, elevation_rad=0.0, rcs=4.0)
    ])
    raw = simulate_frame(flagship_config, scene, np.random.default_rng(9))
    virt = VirtualArrayReformatter(flagship_config).process(raw)
    proc = BartlettBeamformerProcessor(flagship_config)
    r_i = int(np.argmin(np.abs(proc.range_bins - 1.0)))
    heat = proc.azimuth_elevation_heatmap(virt, r_i)
    a_i, e_i = np.unravel_index(np.argmax(heat), heat.shape)
    az_grid, el_grid = grids.angle_bins(64), grids.angle_bins(32)
    assert abs(az_grid[a_i]) < 2 * np.pi / 63
    assert abs(el_grid[e_i]) < 2 * np.pi / 31


@pytest.mark.parametrize("method,cls", [
    ("capon", CaponBeamformerProcessor),
    ("bartlett", BartlettBeamformerProcessor),
])
def test_capon_pipeline_matches_processor(flagship_config, method, cls):
    """The fused batch pipeline equals the per-frame processor object."""
    from mmwave_radar_processing_jax.parallel import build_capon_pipeline

    scenes = [
        Scene(targets=[PointTarget(range_m=1.0 + 0.2 * i, azimuth_rad=0.1 * i,
                                   velocity_m_s=0.2 * (i % 2), rcs=3.0)])
        for i in range(3)
    ]
    from mmwave_radar_processing_jax.data import simulate_frames

    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    fn = build_capon_pipeline(flagship_config, antenna_idxs=ODS_AZ_IDXS,
                              method=method, loading=1e-2)
    batch = np.asarray(fn(np.real(raw).astype(np.float32),
                          np.imag(raw).astype(np.float32)))

    var = VirtualArrayReformatter(flagship_config)
    proc = cls(flagship_config, antenna_idxs=ODS_AZ_IDXS, diagonal_loading=1e-2)
    for i in range(3):
        single = np.asarray(proc.process(var.process(raw[i])))
        np.testing.assert_allclose(batch[i], single, rtol=1e-4,
                                   atol=1e-4 * single.max())


def test_l_array_positions_ods():
    idxs, pos = l_array_positions(ODS_AZ_IDXS, ODS_EL_IDXS)
    assert len(idxs) == 7  # 4 az + 4 el - shared element 4
    lookup = dict(zip(idxs.tolist(), map(tuple, pos.tolist())))
    # az row: ULA in y at constant z (anchored by shared element 4 at z=3)
    assert [lookup[i][0] for i in ODS_AZ_IDXS] == [0.0, 1.0, 2.0, 3.0]
    assert len({lookup[i][1] for i in ODS_AZ_IDXS}) == 1
    # el column: ULA in z at constant y=2 (element 4's azimuth coordinate)
    assert [lookup[i][1] for i in ODS_EL_IDXS] == [0.0, 1.0, 2.0, 3.0]
    assert len({lookup[i][0] for i in ODS_EL_IDXS}) == 1


def test_capon_linv_matches_solve():
    """Round-4 fused Capon (L^{-1} + one matmul) == the solve formulation.

    ``a^H R^{-1} a = ||L^{-1} a||^2`` exactly; float32 paths agree to
    rounding (measured ~3e-7 relative on the flagship shapes).
    """
    import jax.numpy as jnp

    from mmwave_radar_processing_jax.ops import beamform as bf
    from mmwave_radar_processing_jax.ops.mxu import C2

    rng = np.random.default_rng(7)
    for a_n, m in ((4, 64), (8, 48), (12, 64)):
        x = C2(jnp.asarray(rng.standard_normal((31, a_n, 40)), jnp.float32),
               jnp.asarray(rng.standard_normal((31, a_n, 40)), jnp.float32))
        r = bf.spatial_covariance(x)
        st = bf.steering_ula(
            np.linspace(-np.pi, np.pi, m, endpoint=False), a_n)
        p_new = np.asarray(bf.capon_from_covariance(r, st, loading=1e-2,
                                                    method="linv"))
        p_old = np.asarray(bf.capon_from_covariance(r, st, loading=1e-2,
                                                    method="solve"))
        np.testing.assert_allclose(p_new, p_old, rtol=5e-5)


def _capon_pipeline_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (2, cfg.num_rx_antennas, cfg.num_adc_samples,
             cfg.chirps_per_frame)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_capon_pipeline_linv_matches_solve(flagship_config):
    """build_capon_pipeline capon_method='linv' == 'solve' end to end."""
    from mmwave_radar_processing_jax.parallel.capon_pipeline import (
        build_capon_pipeline,
    )

    rr, ri = _capon_pipeline_inputs(flagship_config, 9)
    a = np.asarray(build_capon_pipeline(flagship_config,
                                        capon_method="linv")(rr, ri))
    b = np.asarray(build_capon_pipeline(flagship_config,
                                        capon_method="solve")(rr, ri))
    np.testing.assert_allclose(a, b, rtol=5e-5)


def test_bartlett_pipeline_matches_covariance_oracle(flagship_config):
    """The pipeline's Bartlett maps == a^H R a on its own range DFT."""
    import jax.numpy as jnp

    from mmwave_radar_processing_jax.config import grids
    from mmwave_radar_processing_jax.ops import windows
    from mmwave_radar_processing_jax.ops.mxu import C2
    from mmwave_radar_processing_jax.parallel.capon_pipeline import (
        build_capon_pipeline,
    )

    cfg = flagship_config
    rr, ri = _capon_pipeline_inputs(cfg, 3)
    idxs = (0, 3, 4, 7)
    got = np.asarray(build_capon_pipeline(cfg, antenna_idxs=idxs,
                                          method="bartlett")(rr, ri))
    virt = jnp.stack([VirtualArrayReformatter(cfg).process(rr[b] + 1j * ri[b])
                      for b in range(rr.shape[0])])[:, list(idxs)]
    ns = cfg.num_adc_samples
    rng_f = mxu.dft_factors(ns, window=windows.hanning(ns))
    rng_dft = mxu.dft_apply(mxu.from_complex(virt), rng_f, axis=-2)
    snaps = C2(jnp.moveaxis(rng_dft.re, 1, 2), jnp.moveaxis(rng_dft.im, 1, 2))
    st = bf.steering_ula(grids.phase_shift_bins(64), len(idxs))
    want = np.asarray(bf.bartlett_from_covariance(
        bf.spatial_covariance(snaps), st))
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-4 * want.max())
