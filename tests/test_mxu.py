"""MXU split-complex core: DFT matmuls match FFTs; MXU pipeline matches XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frames
from mmwave_radar_processing_jax.ops import mxu


def test_dft_matches_fft(rng):
    x = (rng.standard_normal((5, 63)) + 1j * rng.standard_normal((5, 63))).astype(
        np.complex64
    )
    out = mxu.dft_apply(mxu.from_complex(x), mxu.dft_factors(63), axis=-1)
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(mxu.to_complex(out), ref, rtol=1e-4, atol=1e-4)


def test_dft_shift_window_pad(rng):
    x = (rng.standard_normal((4, 70)) + 1j * rng.standard_normal((4, 70))).astype(
        np.complex64
    )
    w = np.hanning(70)
    out = mxu.dft_apply(
        mxu.from_complex(x), mxu.dft_factors(70, shift=True, window=w), axis=-1
    )
    ref = np.fft.fftshift(np.fft.fft(x * w, axis=-1), axes=-1)
    np.testing.assert_allclose(mxu.to_complex(out), ref, rtol=1e-4, atol=1e-4)

    # zero-padded rectangular DFT (AoA style): 4 antennas -> 64 bins
    y = x[:, :4]
    out = mxu.dft_apply(mxu.from_complex(y), mxu.dft_factors(4, 64, shift=True), axis=-1)
    pad = np.zeros((4, 64), complex)
    pad[:, :4] = y
    ref = np.fft.fftshift(np.fft.fft(pad, axis=-1), axes=-1)
    np.testing.assert_allclose(mxu.to_complex(out), ref, rtol=1e-4, atol=1e-4)


def test_zoom_dft_matches_scipy(rng):
    n, m, f1, f2, fs = 70, 70, 3.0, 9.5, 16.3
    x = (rng.standard_normal((6, n)) + 1j * rng.standard_normal((6, n))).astype(
        np.complex64
    )
    ref = scipy.signal.ZoomFFT(n, [f1, f2], m=m, fs=fs)(x, axis=-1)
    factors = mxu.zoom_dft_factors_dynamic(
        jnp.float32(f1), jnp.float32(f2), n=n, m=m, fs=fs
    )
    out = mxu.dft_apply(mxu.from_complex(x), factors, axis=-1)
    np.testing.assert_allclose(mxu.to_complex(out), ref, rtol=2e-3, atol=2e-3)


def test_reformat_channels_matches_full_reformat(rng):
    """Strided per-channel slices == rows of the full virtual cube."""
    from mmwave_radar_processing_jax.processors.virtual_array import (
        reformat, reformat_channels,
    )

    raw = rng.standard_normal((4, 63, 210)).astype(np.float32)
    full = np.asarray(reformat(jnp.asarray(raw), num_rx=4, cfgs_per_loop=3))
    chans = (0, 3, 4, 5, 7, 8, 9)
    sub = np.asarray(reformat_channels(
        jnp.asarray(raw), channels=chans, num_rx=4, cfgs_per_loop=3))
    np.testing.assert_array_equal(sub, full[list(chans)])


def test_rd_values_at_matches_full_map(rng):
    """Bilinear per-cell evaluation == gathering from the full RD cube."""
    cube = (
        rng.standard_normal((8, 63, 70)) + 1j * rng.standard_normal((8, 63, 70))
    ).astype(np.complex64)
    factors = mxu.range_doppler_factors(63, 70)
    full = mxu.range_doppler_map_mxu(mxu.from_complex(cube), *factors)
    r_idx = np.array([0, 5, 17, 33, 62, 62, 8, 0])
    v_idx = np.array([0, 69, 12, 41, 69, 0, 33, 7])
    vals = mxu.rd_values_at(
        mxu.from_complex(cube), *factors, jnp.asarray(r_idx), jnp.asarray(v_idx)
    )
    ref = mxu.to_complex(full)[:, r_idx, v_idx]
    got = mxu.to_complex(vals)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_range_dft_channels_matches_reformat_then_dft(rng):
    """Fused reformat+range-DFT == reformat, slice channels, DFT."""
    from mmwave_radar_processing_jax.processors.virtual_array import reformat

    raw = (
        rng.standard_normal((4, 63, 210)) + 1j * rng.standard_normal((4, 63, 210))
    ).astype(np.complex64)
    chans = (0, 3, 4, 5, 7, 8, 9)
    factors = mxu.dft_factors(63, window=np.hanning(63))
    full = mxu.from_complex(reformat(jnp.asarray(raw), num_rx=4, cfgs_per_loop=3))
    ch = np.asarray(chans)
    ref = mxu.dft_apply(mxu.C2(full.re[ch], full.im[ch]), factors, axis=-2)
    got = mxu.range_dft_channels(
        mxu.from_complex(raw), chans, factors, num_rx=4, cfgs_per_loop=3
    )
    np.testing.assert_allclose(mxu.to_complex(got), mxu.to_complex(ref),
                               rtol=1e-5, atol=1e-4)


def test_rd_values_from_range_dft_matches_bilinear(rng):
    """One-hot selection on the range-DFT'd cube == the bilinear form."""
    cube = (
        rng.standard_normal((7, 63, 70)) + 1j * rng.standard_normal((7, 63, 70))
    ).astype(np.complex64)
    factors = mxu.range_doppler_factors(63, 70)
    r_idx = jnp.asarray(np.array([0, 5, 17, 33, 62, 62, 8, 0]))
    v_idx = jnp.asarray(np.array([0, 69, 12, 41, 69, 0, 33, 7]))
    old = mxu.rd_values_at(mxu.from_complex(cube), *factors, r_idx, v_idx)
    R = mxu.dft_apply(mxu.from_complex(cube), factors[0], axis=-2)
    new = mxu.rd_values_from_range_dft(R, factors[1], r_idx, v_idx)
    ref = mxu.to_complex(old)
    np.testing.assert_allclose(mxu.to_complex(new), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_range_doppler_mxu_matches_reference_kernel(flagship_config, rng):
    from mmwave_radar_processing_jax.processors.range_doppler import range_doppler_map

    cube = (
        rng.standard_normal((12, 63, 70)) + 1j * rng.standard_normal((12, 63, 70))
    ).astype(np.complex64)
    ref = np.asarray(range_doppler_map(cube))
    factors = mxu.range_doppler_factors(63, 70)
    out = mxu.range_doppler_map_mxu(mxu.from_complex(cube), *factors)
    np.testing.assert_allclose(
        mxu.to_complex(out), ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max()
    )


def test_mxu_pipeline_matches_xla(flagship_config):
    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )

    scenes = [
        Scene(targets=[
            PointTarget(range_m=1.2 + 0.2 * i, azimuth_rad=0.15 * (i - 1),
                        velocity_m_s=0.3 * (i - 1), rcs=3.0)
        ])
        for i in range(4)
    ]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)

    xla_fn = build_point_cloud_pipeline(flagship_config, max_dets=64, backend="xla")
    mxu_fn = build_point_cloud_pipeline(flagship_config, max_dets=64, backend="mxu")

    ref = xla_fn(raw)
    out = mxu_fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32))

    np.testing.assert_array_equal(np.asarray(out.count), np.asarray(ref.count))
    np.testing.assert_allclose(
        np.asarray(out.points), np.asarray(ref.points), rtol=1e-4, atol=1e-4
    )


def test_sharded_split_beamformer_matches_dense(flagship_config, rng):
    from mmwave_radar_processing_jax.parallel import make_mesh
    from mmwave_radar_processing_jax.parallel.sharded_beamform import (
        build_sharded_beamformer,
    )
    from mmwave_radar_processing_jax.processors.synthetic_array import beamform
    from mmwave_radar_processing_jax.ops import windows
    from jax.sharding import NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs virtual 8-device mesh")
    mesh = make_mesh({"data": 4, "model": 2})
    ns, elements, n_angles = 63, 32, 24
    data = (rng.standard_normal((ns, elements))
            + 1j * rng.standard_normal((ns, elements))).astype(np.complex64)
    positions = (rng.standard_normal((3, elements)) * 0.01).astype(np.float32)
    theta = np.linspace(-0.5, 0.5, n_angles)
    steering = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)],
                        axis=1).astype(np.float32)
    rng_win = jnp.asarray(windows.hanning(ns))
    elem_win = jnp.asarray(windows.hamming(elements))
    lam = flagship_config.lambda_m

    dense = np.asarray(beamform(jnp.asarray(data), jnp.asarray(positions),
                                jnp.asarray(steering), lam, rng_win, elem_win))

    fn = build_sharded_beamformer(mesh, lambda_m=lam, split_complex=True)
    sh = NamedSharding(mesh, P(None, "model"))
    with mesh:
        out_re, out_im = fn(
            jax.device_put(np.real(data).astype(np.float32), sh),
            jax.device_put(np.imag(data).astype(np.float32), sh),
            jax.device_put(positions, sh),
            jnp.asarray(steering), rng_win, elem_win,
        )
    out = np.asarray(out_re) + 1j * np.asarray(out_im)
    np.testing.assert_allclose(out, dense, rtol=1e-3,
                               atol=1e-3 * np.abs(dense).max())


def test_fused_velocity_pipeline_matches_object_api(flagship_config):
    """Device-resident RadVel pipeline vs the object-API estimator."""
    from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )
    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        VelocityEstimator,
    )
    from mmwave_radar_processing_jax.processors.virtual_array import (
        VirtualArrayReformatter,
    )

    rng = np.random.default_rng(4)
    ego = np.array([0.5, 0.12, -0.05])
    altitude = 1.2
    raws, alts = [], []
    for _ in range(3):
        scene = ground_scene(flagship_config, altitude_m=altitude, ego_vel=ego,
                             num_patches=64, rng=rng, noise_sigma=0.03)
        raws.append(simulate_frame(flagship_config, scene, rng))
        alts.append(altitude)
    raw = np.stack(raws)

    fn = build_velocity_pipeline(flagship_config, lower_range_bound=0.5,
                                 upper_range_bound=0.5, min_r2_threshold=0.2,
                                 min_inlier_percent=0.3)
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32),
             np.asarray(alts, np.float32))

    var = VirtualArrayReformatter(flagship_config)
    ve = VelocityEstimator(flagship_config, lower_range_bound=0.5,
                           upper_range_bound=0.5, min_R2_threshold=0.2,
                           min_inlier_percent=0.3)
    for i in range(3):
        virt = np.asarray(var.process(raw[i]))
        ref_vel = ve.process(adc_cube=virt, altitude=altitude).copy()
        # deterministic parts agree exactly
        np.testing.assert_allclose(float(out.vx[i]), ve.ego_vx_estimate, atol=1e-5)
        # vx recovered near truth (ground recedes at +vx when moving down)
        assert abs(float(out.vx[i]) - ego[0]) < 0.12
        # RANSAC-dependent parts agree within seed noise
        np.testing.assert_allclose(np.asarray(out.velocity[i]), ref_vel, atol=0.3)


def test_synthetic_aperture_scan_matches_object_api(flagship_config, rng):
    """Scan pipeline == object-API beamformer on a steady-track recording."""
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.beamform_pipeline import (
        build_synthetic_aperture_pipeline,
    )
    from mmwave_radar_processing_jax.processors.synthetic_array import (
        SyntheticArrayBeamformerProcessor,
    )

    np_rng = np.random.default_rng(9)
    vel = np.array([0.2, 0.01, 0.0])
    frames = []
    for i in range(5):
        scene = Scene(targets=[PointTarget(range_m=1.3, azimuth_rad=0.2, rcs=4.0)],
                      noise_sigma=0.02)
        frames.append(simulate_frame(flagship_config, scene, np_rng))
    raw = np.stack(frames)
    vels = np.tile(vel, (5, 1))

    kwargs = dict(num_frames=3,
                  az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 40)),
                  el_angle_bins_rad=np.array([0.0]),
                  min_vel=np.array([0.15, 0.0, 0.0]),
                  max_vel=np.array([0.3, 0.05, 0.05]),
                  max_vel_stdev=np.array([0.1, 0.1, 0.1]))
    fn = build_synthetic_aperture_pipeline(flagship_config, **kwargs)
    mags, oks = fn(np.real(raw).astype(np.float32),
                   np.imag(raw).astype(np.float32), vels)

    proc = SyntheticArrayBeamformerProcessor(flagship_config, **kwargs)
    for i in range(5):
        resp = proc.process(raw[i], current_vel=vel)
        assert bool(oks[i]) == proc.array_geometry_valid
        if proc.array_geometry_valid:
            ref_mag = np.abs(resp)
            np.testing.assert_allclose(
                np.asarray(mags[i]), ref_mag, rtol=2e-3,
                atol=2e-3 * ref_mag.max(),
            )
    assert bool(oks[-1])  # steady track validates once the buffer fills


def test_velocity_pipeline_stop_after_stages(flagship_config):
    """The stage-bisection knob returns prefix outputs equal to the full run."""
    from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )

    rng = np.random.default_rng(9)
    scene = ground_scene(flagship_config, altitude_m=1.2,
                         ego_vel=np.array([0.8, 0.2, 0.0]), num_patches=64,
                         rng=rng, noise_sigma=0.03)
    raw = np.stack([simulate_frame(flagship_config, scene, rng)
                    for _ in range(2)])
    rr = np.real(raw).astype(np.float32)
    ri = np.imag(raw).astype(np.float32)
    alts = np.full(2, 1.2, np.float32)

    full = build_velocity_pipeline(flagship_config)(rr, ri, alts)
    vx = build_velocity_pipeline(flagship_config, stop_after="vx")(rr, ri, alts)
    np.testing.assert_array_equal(np.asarray(vx), np.asarray(full.vx))
    az_resp, el_resp = build_velocity_pipeline(
        flagship_config, stop_after="responses")(rr, ri, alts)
    nv = flagship_config.frame.loops
    assert az_resp.shape[:2] == (2, nv) and el_resp.shape[:2] == (2, nv)
    peaks = build_velocity_pipeline(
        flagship_config, stop_after="peaks")(rr, ri, alts)
    assert peaks[0].shape == (2, nv)  # az row-peak angles


def test_fused_velocity_pipeline_precise(flagship_config):
    """Precise (zoom) path matches the object API's enable_precise_responses."""
    from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )
    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        VelocityEstimator,
    )
    from mmwave_radar_processing_jax.processors.virtual_array import (
        VirtualArrayReformatter,
    )

    rng = np.random.default_rng(12)
    ego = np.array([0.5, 0.1, 0.0])
    altitude = 1.2
    scene = ground_scene(flagship_config, altitude_m=altitude, ego_vel=ego,
                         num_patches=64, rng=rng, noise_sigma=0.03)
    raw = simulate_frame(flagship_config, scene, rng)[None]

    fn = build_velocity_pipeline(flagship_config, lower_range_bound=0.5,
                                 upper_range_bound=0.5, enable_precise=True,
                                 min_r2_threshold=0.2, min_inlier_percent=0.3)
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32),
             np.asarray([altitude], np.float32))

    var = VirtualArrayReformatter(flagship_config)
    ve = VelocityEstimator(flagship_config, lower_range_bound=0.5,
                           upper_range_bound=0.5, min_R2_threshold=0.2,
                           min_inlier_percent=0.3)
    virt = np.asarray(var.process(raw[0]))
    ref_vel = ve.process(adc_cube=virt, altitude=altitude,
                         enable_precise_responses=True)
    # precise vx readout matches the object API (within float32 of the
    # zoom grid; the zoomed bin spacing is ~0.007 m/s)
    np.testing.assert_allclose(float(out.vx[0]), ve.ego_vx_estimate, atol=0.02)
    assert abs(float(out.vx[0]) - ego[0]) < 0.1
    np.testing.assert_allclose(np.asarray(out.velocity[0]), ref_vel, atol=0.3)


def test_spectral_maps_pipeline_matches_object_api(flagship_config, rng):
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frames
    from mmwave_radar_processing_jax.parallel.spectral_pipeline import (
        build_spectral_maps_pipeline,
    )
    from mmwave_radar_processing_jax.processors import (
        DopplerAzimuthProcessor,
        RangeAngleProcessor,
        RangeDopplerProcessor,
        VirtualArrayReformatter,
    )

    scenes = [
        Scene(targets=[PointTarget(range_m=1.0 + 0.3 * i, azimuth_rad=0.2 - 0.2 * i,
                                   velocity_m_s=0.4 * (i - 1), rcs=3.0)])
        for i in range(3)
    ]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    fn = build_spectral_maps_pipeline(flagship_config)
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32))

    var = VirtualArrayReformatter(flagship_config)
    rd = RangeDopplerProcessor(flagship_config)
    ra = RangeAngleProcessor(flagship_config)
    da = DopplerAzimuthProcessor(flagship_config)
    for i in range(3):
        virt = np.asarray(var.process(raw[i]))
        ref_rd = np.asarray(rd.process(virt, rx_idx=0))
        ref_ra = np.asarray(ra.process(virt, rx_antennas=[0, 3, 4, 7]))
        ref_da = np.asarray(da.process(virt, rx_antennas=[0, 3, 4, 7]))
        np.testing.assert_allclose(np.asarray(out.range_doppler[i]), ref_rd,
                                   rtol=2e-3, atol=2e-3 * ref_rd.max())
        np.testing.assert_allclose(np.asarray(out.range_angle[i]), ref_ra,
                                   rtol=2e-3, atol=2e-3 * ref_ra.max())
        np.testing.assert_allclose(np.asarray(out.doppler_azimuth[i]), ref_da,
                                   rtol=2e-3, atol=2e-3 * ref_da.max())


def test_micro_doppler_pipeline_matches_object_api(flagship_config, rng):
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frames
    from mmwave_radar_processing_jax.parallel.spectral_pipeline import (
        build_micro_doppler_pipeline,
    )
    from mmwave_radar_processing_jax.processors import (
        MicroDopplerProcessor,
        VirtualArrayReformatter,
    )

    scenes = [
        Scene(targets=[PointTarget(range_m=0.8, velocity_m_s=0.3 * i, rcs=3.0)])
        for i in range(4)
    ]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    fn = build_micro_doppler_pipeline(flagship_config, target_ranges=(0.5, 2.0),
                                      num_frames_history=5)
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32))

    var = VirtualArrayReformatter(flagship_config)
    md = MicroDopplerProcessor(flagship_config, target_ranges=[0.5, 2.0],
                               num_frames_history=5)
    for i in range(4):
        ref = np.asarray(md.process(np.asarray(var.process(raw[i])), rx_idx=0))
    np.testing.assert_allclose(np.asarray(out[-1]), ref, rtol=2e-3,
                               atol=2e-3 * ref.max())


def test_dbs_pipeline_matches_object_api(flagship_config, rng):
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frames
    from mmwave_radar_processing_jax.parallel.spectral_pipeline import (
        build_dbs_pipeline,
    )
    from mmwave_radar_processing_jax.processors.dbs import (
        RangeAngleProcessorDBSEnhanced,
    )
    from mmwave_radar_processing_jax.processors import VirtualArrayReformatter

    scenes = [
        Scene(targets=[PointTarget(range_m=1.5, azimuth_rad=0.3,
                                   velocity_m_s=-0.4, rcs=3.0)])
        for _ in range(2)
    ]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    vels = np.array([[0.5, 0.2, 0.0], [0.05, 0.02, 0.0]], np.float32)  # fast, slow
    fn = build_dbs_pipeline(flagship_config, num_dbs_angle_bins=100)
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32), vels)

    var = VirtualArrayReformatter(flagship_config)
    proc = RangeAngleProcessorDBSEnhanced(
        flagship_config, num_angle_bins_range_angle_response=64,
        num_angle_bins_dbs_enhanced_response=100, min_x_y_vel_dbs=0.25,
    )
    rx = [0, 3, 4, 7]
    virt0 = np.asarray(var.process(raw[0]))
    ref_fast = np.asarray(proc.process(virt0, velocity_ned=vels[0], rx_antennas=rx))
    np.testing.assert_allclose(np.asarray(out[0]), ref_fast, rtol=2e-3,
                               atol=2e-3 * ref_fast.max())

    # slow frame: fallback equals plain range-angle resampled onto the DBS grid
    virt1 = np.asarray(var.process(raw[1]))
    ref_slow = np.asarray(proc.process_no_dbs(virt1, rx_antennas=rx))
    angle_bins = proc.angle_bins_no_dbs_enhancement
    near = np.argmin(np.abs(angle_bins[None, :]
                            - proc.angle_bins_dbs_enhanced[:, None]), axis=1)
    np.testing.assert_allclose(np.asarray(out[1]), ref_slow[:, near], rtol=2e-3,
                               atol=2e-3 * ref_slow.max())


def test_strip_map_pipeline_matches_object_api(flagship_config, rng):
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frames
    from mmwave_radar_processing_jax.parallel.spectral_pipeline import (
        build_strip_map_pipeline,
    )
    from mmwave_radar_processing_jax.processors import StripMapSARProcessor

    scenes = [Scene(targets=[PointTarget(range_m=1.0, azimuth_rad=0.1, rcs=3.0)])
              for _ in range(2)]
    raw = simulate_frames(flagship_config, scenes).astype(np.complex64)
    fn = build_strip_map_pipeline(flagship_config)
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32))

    proc = StripMapSARProcessor(flagship_config)
    cropped = proc.process(raw[0], vel_m_per_s=0.25, sensor_height_m=0.24,
                           max_SAR_distance=1.5)
    full = np.asarray(out[0])
    ref_crop = np.abs(cropped)
    ours_crop = full[proc.valid_ranges_slice, proc.valid_angles_slice]
    np.testing.assert_allclose(ours_crop, ref_crop, rtol=2e-3,
                               atol=2e-3 * ref_crop.max())


def test_velocity_response_backends_agree(flagship_config):
    """Pallas fused response kernel == plain XLA form on the full pipeline.

    Exercises the kernel (Pallas interpreter on the CPU) end-to-end through
    ``build_velocity_pipeline(response_backend="interpret")`` against the XLA
    formulation on identical frames — the deterministic outputs (vx, R^2,
    inlier fractions) must agree to float32 reassociation noise.
    """
    from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.velocity_pipeline import (
        build_velocity_pipeline,
    )

    rng = np.random.default_rng(21)
    raws = [
        simulate_frame(flagship_config,
                       ground_scene(flagship_config, 1.2, np.array([0.5, 0.1, 0.0]),
                                    num_patches=48, rng=rng), rng)
        for _ in range(2)
    ]
    raw = np.stack(raws)
    re = np.real(raw).astype(np.float32)
    im = np.imag(raw).astype(np.float32)
    alts = np.full(2, 1.2, np.float32)

    kw = dict(min_r2_threshold=0.2, min_inlier_percent=0.3)
    out_x = build_velocity_pipeline(flagship_config, response_backend="xla",
                                    **kw)(re, im, alts)
    out_p = build_velocity_pipeline(flagship_config,
                                    response_backend="interpret",
                                    **kw)(re, im, alts)
    np.testing.assert_allclose(np.asarray(out_p.vx), np.asarray(out_x.vx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_p.velocity),
                               np.asarray(out_x.velocity), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_p.az_r2),
                               np.asarray(out_x.az_r2), rtol=1e-3, atol=1e-3)

    # precise (zoom) path through the kernel as well
    out_xp = build_velocity_pipeline(flagship_config, response_backend="xla",
                                     enable_precise=True, **kw)(re, im, alts)
    out_pp = build_velocity_pipeline(flagship_config,
                                     response_backend="interpret",
                                     enable_precise=True, **kw)(re, im, alts)
    np.testing.assert_allclose(np.asarray(out_pp.vx), np.asarray(out_xp.vx),
                               rtol=1e-4, atol=1e-4)


def _doppler_az_numpy(u_re, u_im, wgt, fct, fst, set_idx):
    """float64 re-derivation: resp[s, v, a] = sum_w wgt |sum_r u F|."""
    u = np.asarray(u_re, np.float64) + 1j * np.asarray(u_im, np.float64)
    n_rx = len(set_idx[0])
    out = np.zeros((len(set_idx), u.shape[-1], fct.shape[-1]))
    for s, chans in enumerate(set_idx):
        spec = 0
        for r, ch in enumerate(chans):
            # kernel convention: re' = fc*re + fs*im, im' = fc*im - fs*re
            f = fct[n_rx * s + r] - 1j * fst[n_rx * s + r]
            spec = spec + u[ch][:, :, None] * f[None, None, :]
        out[s] = np.einsum("wva,w->va", np.abs(spec), wgt)
    return out


def test_doppler_az_kernel_matches_numpy():
    """Unit oracle for ops.pallas.doppler_az against a numpy re-derivation."""
    from mmwave_radar_processing_jax.ops.pallas.doppler_az import set_responses

    rng = np.random.default_rng(3)
    n_ch, w, nv, av = 12, 5, 16, 9
    set_idx = ((0, 3, 4, 7), (1, 2, 5, 6), (10, 11, 6, 7), (9, 8, 5, 4))
    u_re = rng.standard_normal((n_ch, w, nv)).astype(np.float32)
    u_im = rng.standard_normal((n_ch, w, nv)).astype(np.float32)
    wgt = rng.uniform(0, 1, w).astype(np.float32)
    fct = rng.standard_normal((16, av)).astype(np.float32)
    fst = rng.standard_normal((16, av)).astype(np.float32)
    out = set_responses(u_re, u_im, wgt, fct, fst, set_idx=set_idx,
                        interpret=True)
    ref = _doppler_az_numpy(u_re, u_im, wgt, fct, fst, set_idx)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("nv", [16, 70, 140])
def test_doppler_az_kernel_flagship_widths(batch, nv):
    """Kernel (interpreter) at flagship widths, vmapped over frames.

    ``nv=70`` is the coarse velocity axis (not a multiple of the kernel's
    velocity block, so the last block is masked), ``nv=140`` the precise
    path's two zoom half-bands, ``nv=16`` exactly one block; the vmapped
    batch becomes a grid axis, with batches of one and of several frames.
    """
    import jax

    from mmwave_radar_processing_jax.ops.pallas.doppler_az import set_responses
    from mmwave_radar_processing_jax.processors.velocity_estimator import (
        ODS_AZ_SETS_VIRTUAL,
        ODS_EL_SETS_VIRTUAL,
    )

    set_idx = tuple(tuple(int(c) for c in s)
                    for s in (*ODS_AZ_SETS_VIRTUAL, *ODS_EL_SETS_VIRTUAL))
    rng = np.random.default_rng(nv + batch)
    w, av = 19, 60
    u_re = rng.standard_normal((batch, 12, w, nv)).astype(np.float32)
    u_im = rng.standard_normal((batch, 12, w, nv)).astype(np.float32)
    wgt = rng.uniform(0, 1, (batch, w)).astype(np.float32)
    wgt /= wgt.sum(axis=1, keepdims=True)
    fct = rng.standard_normal((16, av)).astype(np.float32)
    fst = rng.standard_normal((16, av)).astype(np.float32)
    out = np.asarray(jax.vmap(lambda a, b, c: set_responses(
        a, b, c, fct, fst, set_idx=set_idx, interpret=True))(u_re, u_im, wgt))
    assert out.shape == (batch, 4, nv, av)
    for f in range(batch):
        ref = _doppler_az_numpy(u_re[f], u_im[f], wgt[f], fct, fst, set_idx)
        np.testing.assert_allclose(out[f], ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_full_pipeline_combines_products(flagship_config):
    from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.full_pipeline import build_full_pipeline
    from mmwave_radar_processing_jax.parallel import (
        build_point_cloud_pipeline,
        build_velocity_pipeline,
    )

    rng = np.random.default_rng(6)
    ego = np.array([0.5, 0.1, 0.0])
    raws = [
        simulate_frame(flagship_config,
                       ground_scene(flagship_config, 1.2, ego, num_patches=48,
                                    rng=rng), rng)
        for _ in range(2)
    ]
    raw = np.stack(raws)
    re = np.real(raw).astype(np.float32)
    im = np.imag(raw).astype(np.float32)
    alts = np.full(2, 1.2, np.float32)

    full = build_full_pipeline(flagship_config, max_dets=64)
    pc, vel = full(re, im, alts)

    ref_pc = build_point_cloud_pipeline(flagship_config, max_dets=64,
                                        backend="mxu")(re, im)
    ref_vel = build_velocity_pipeline(flagship_config)(re, im, alts)

    np.testing.assert_array_equal(np.asarray(pc.count), np.asarray(ref_pc.count))
    np.testing.assert_allclose(np.asarray(pc.points), np.asarray(ref_pc.points),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vel.velocity),
                               np.asarray(ref_vel.velocity), rtol=1e-5, atol=1e-5)


def test_ground_pipeline_matches_object_api(flagship_config):
    """Fused ground-detector pipeline == Altimeter+GroundDetector+PCG chain."""
    from mmwave_radar_processing_jax.data import ground_scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.ground_pipeline import (
        build_ground_point_cloud_pipeline,
    )
    from mmwave_radar_processing_jax.processors import (
        PointCloudGenerator,
        VirtualArrayReformatter,
    )

    rng = np.random.default_rng(3)
    ego = np.array([0.4, 0.1, 0.0])
    raws = []
    alt = 0.4
    for i in range(4):
        alt = min(1.2, alt + 0.15)
        scene = ground_scene(flagship_config, altitude_m=alt, ego_vel=ego,
                             num_patches=48, rng=rng, noise_sigma=0.03)
        raws.append(simulate_frame(flagship_config, scene, rng))
    raw = np.stack(raws)

    params = dict(num_train=12, num_guard=4, rho=0.5, alpha=8.0)
    fn = build_ground_point_cloud_pipeline(
        flagship_config, vel_cfar_params=params, max_dets=128,
    )
    out = fn(np.real(raw).astype(np.float32), np.imag(raw).astype(np.float32))

    var = VirtualArrayReformatter(flagship_config)
    pcg = PointCloudGenerator(
        flagship_config,
        az_antenna_idxs=[0, 3, 4, 7], el_antenna_idxs=[9, 8, 5, 4],
        detector_type="range_doppler_ground_detector",
        detector_params=dict(
            vel_cfar_type="os_cfar_1d", vel_cfar_params=params,
            altimeter_params=dict(min_altitude_m=0.25, zoom_search_region_m=0.2,
                                  altitude_search_limit_m=0.4, range_bias=0.0,
                                  precise_est_enabled=True),
        ),
    )
    for i in range(4):
        virt = np.asarray(var.process(raw[i]))
        ref_pts = pcg.process(virt)
        ours_valid = np.asarray(out.valid[i])
        ours_pts = np.asarray(out.points[i])[ours_valid]
        assert ours_pts.shape == ref_pts.shape, (i, ours_pts.shape, ref_pts.shape)
        np.testing.assert_allclose(ours_pts, ref_pts, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(
            float(out.altitude[i]),
            pcg.detector.altimeter.current_altitude_corrected_m,
            atol=5e-3,
        )


def test_pointcloud_precision_modes_and_dataflows_agree(flagship_config):
    """Every (dataflow, aoa_precision) combination produces the same points.

    On CPU there is no bf16 truncation, so "fast", "exact", and the round-5
    "f32" chain (Precision.HIGH DFTs + exact hi/lo selection) must agree to
    float tolerance; the alternative ``dataflow="raw"`` formulation
    (reformat folded into strided static Doppler factors,
    ``ops/mxu.rd_values_from_raw``) must match the union-cube dataflow too.
    Pins the contract that the knobs trade SPEED, never results (on exact
    hardware).
    """
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )

    cfg = flagship_config
    rng = np.random.default_rng(3)
    frames = []
    for i in range(4):
        scene = Scene(
            targets=[
                PointTarget(range_m=1.1 + 0.15 * i, azimuth_rad=0.3,
                            velocity_m_s=0.5, rcs=3.0),
                PointTarget(range_m=2.4, azimuth_rad=-0.35,
                            velocity_m_s=-0.7, rcs=2.5),
            ],
            noise_sigma=0.05,
        )
        frames.append(simulate_frame(cfg, scene, rng))
    raw = np.stack(frames)
    rr = raw.real.astype(np.float32)
    ri = raw.imag.astype(np.float32)

    kw = dict(az_antenna_idxs=(0, 3, 4, 7), el_antenna_idxs=(9, 8, 5, 4),
              cfar_params=dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7,
                               alpha=4.0),
              max_dets=128, backend="mxu")
    base = build_point_cloud_pipeline(cfg, dataflow="union",
                                      aoa_precision="fast", **kw)(rr, ri)
    assert int(np.asarray(base.count).sum()) > 0
    for dataflow in ("union", "raw", "rawd"):
        for precision in ("fast", "exact", "f32"):
            if (dataflow, precision) == ("union", "fast"):
                continue
            out = build_point_cloud_pipeline(
                cfg, dataflow=dataflow, aoa_precision=precision, **kw)(rr, ri)
            np.testing.assert_array_equal(np.asarray(out.count),
                                          np.asarray(base.count),
                                          err_msg=f"{dataflow}/{precision}")
            np.testing.assert_allclose(
                np.asarray(out.points), np.asarray(base.points),
                rtol=1e-4, atol=1e-4, err_msg=f"{dataflow}/{precision}")


def test_rd_values_from_raw_matches_union_cube(flagship_config, rng):
    """``rd_values_from_raw`` == one-hot selection on the range-DFT'd cube."""
    from mmwave_radar_processing_jax.ops import mxu

    cfg = flagship_config
    ns, nl = cfg.num_adc_samples, cfg.frame.loops
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    chans = (0, 3, 4, 5, 7, 8, 9)
    rng_factors, dop_factors = mxu.range_doppler_factors(ns, nl)
    raw = mxu.C2(
        rng.standard_normal((num_rx, ns, nl * cpl)).astype(np.float32),
        rng.standard_normal((num_rx, ns, nl * cpl)).astype(np.float32),
    )
    r_idx = np.asarray([5, 20, 33, 60], np.int32)
    v_idx = np.asarray([0, 10, 35, 69], np.int32)

    R = mxu.range_dft_channels(raw, chans, rng_factors,
                               num_rx=num_rx, cfgs_per_loop=cpl)
    want = mxu.rd_values_from_range_dft(R, dop_factors, r_idx, v_idx,
                                        mode="fast")
    for mode in ("fast", "exact"):
        got = mxu.rd_values_from_raw(
            raw, rng_factors, dop_factors, r_idx, v_idx,
            channels=chans, num_rx=num_rx, cfgs_per_loop=cpl, mode=mode)
        np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                                   rtol=1e-4, atol=1e-4, err_msg=mode)
        np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                                   rtol=1e-4, atol=1e-4, err_msg=mode)

    import pytest

    with pytest.raises(ValueError, match="unknown rd-values mode"):
        mxu.rd_values_from_raw(raw, rng_factors, dop_factors, r_idx, v_idx,
                               channels=chans, num_rx=num_rx,
                               cfgs_per_loop=cpl, mode="typo")


def test_doppler_factors_strided_layout():
    """Strided factors place dop rows at cfg::cpl and zeros elsewhere."""
    from mmwave_radar_processing_jax.ops import mxu

    dc, ds = mxu.dft_factors(8, window=np.hanning(8), shift=True)
    for cfg_idx in (0, 1, 2):
        oc, os_ = mxu.doppler_factors_strided((dc, ds), cfg_idx, 3)
        assert isinstance(oc, np.ndarray)  # numpy on purpose (trace-safe)
        assert oc.shape == (24, 8)
        np.testing.assert_array_equal(oc[cfg_idx::3], np.asarray(dc))
        mask = np.ones(24, bool)
        mask[cfg_idx::3] = False
        assert np.all(oc[mask] == 0.0) and np.all(os_[mask] == 0.0)


def test_rawd_cfar_channel_independent_of_aoa_union(flagship_config):
    """rawd detections must not depend on which antennas do AoA.

    Round-5 review regression: with channel 0 absent from the az/el union,
    the rawd CFAR map silently used another channel's response (searchsorted
    insertion point), changing the detection set vs the union dataflow.
    """
    from mmwave_radar_processing_jax.data import PointTarget, Scene, simulate_frame
    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )

    cfg = flagship_config
    rng = np.random.default_rng(8)
    raw = np.stack([simulate_frame(cfg, Scene(
        targets=[PointTarget(range_m=1.4, azimuth_rad=0.2,
                             velocity_m_s=0.4, rcs=3.0)],
        noise_sigma=0.05), rng) for _ in range(2)])
    rr, ri = raw.real.astype(np.float32), raw.imag.astype(np.float32)
    kw = dict(az_antenna_idxs=(3, 4, 7), el_antenna_idxs=(9, 8, 5),
              cfar_params=dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7,
                               alpha=4.0),
              max_dets=64, backend="mxu")
    o = build_point_cloud_pipeline(cfg, dataflow="union", **kw)(rr, ri)
    n = build_point_cloud_pipeline(cfg, dataflow="rawd", **kw)(rr, ri)
    np.testing.assert_array_equal(np.asarray(o.count), np.asarray(n.count))
    np.testing.assert_allclose(np.asarray(o.points), np.asarray(n.points),
                               rtol=1e-4, atol=1e-4)


def test_pipeline_knob_validation(flagship_config):
    """Typo'd dataflow/precision values raise instead of silently degrading."""
    import pytest

    from mmwave_radar_processing_jax.parallel.pipeline import (
        build_point_cloud_pipeline,
    )

    with pytest.raises(ValueError, match="unknown dataflow"):
        build_point_cloud_pipeline(flagship_config, dataflow="rawD")
    with pytest.raises(ValueError, match="unknown aoa_precision"):
        build_point_cloud_pipeline(flagship_config, dataflow="raw",
                                   aoa_precision="exactt")
    with pytest.raises(ValueError, match="requires reformat_input"):
        build_point_cloud_pipeline(flagship_config, dataflow="rawd",
                                   reformat_input=False)
