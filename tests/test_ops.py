"""Ops layer: chirp-z / zoom FFT, peak finding, CFAR maps, RANSAC.

Golden sources: scipy (ZoomFFT, find_peaks, peak_prominences) and sklearn
(RANSACRegressor) run on the same inputs, plus independent numpy oracles for
CFAR written directly from the textbook definitions.
"""

import numpy as np
import pytest
import scipy.signal

from mmwave_radar_processing_jax.ops import cfar, czt, masked, peaks, ransac


# --------------------------------------------------------------------------- #
# masked sets
# --------------------------------------------------------------------------- #
def test_mask_to_indices():
    mask = np.array([0, 1, 0, 0, 1, 1, 0, 1], dtype=bool)
    idx, valid, count = masked.mask_to_indices(mask, 6)
    assert count == 4
    np.testing.assert_array_equal(np.asarray(idx)[np.asarray(valid)], [1, 4, 5, 7])

    # overflow clamps to capacity, keeps ascending order
    idx, valid, count = masked.mask_to_indices(np.ones(10, bool), 4)
    assert count == 4
    np.testing.assert_array_equal(np.asarray(idx), [0, 1, 2, 3])


def test_mask_to_indices_randomized_exactness(rng):
    """approx_min_k(recall=1.0) compaction == np.where, many densities/sizes."""
    for n in (63, 120, 4410):
        for density in (0.0, 0.005, 0.05, 0.5, 1.0):
            mask = rng.random(n) < density
            for cap in (7, 128, n + 9):
                idx, valid, count = masked.mask_to_indices(mask, cap)
                ref = np.flatnonzero(mask)[:cap]
                assert int(count) == min(mask.sum(), cap)
                np.testing.assert_array_equal(
                    np.asarray(idx)[np.asarray(valid)], ref)


def test_mask_to_indices_2d_row_major():
    mask = np.zeros((4, 5), bool)
    mask[1, 3] = mask[2, 0] = mask[3, 4] = True
    rows, cols, valid, count = masked.mask_to_indices_2d(mask, 8)
    ref_r, ref_c = np.where(mask)
    assert count == 3
    np.testing.assert_array_equal(np.asarray(rows)[np.asarray(valid)], ref_r)
    np.testing.assert_array_equal(np.asarray(cols)[np.asarray(valid)], ref_c)


def test_mask_to_indices_2d_interior_matches_full(rng):
    """Interior-only compaction == full compaction on edge-False masks."""
    for er, ed in [(8, 7), (0, 16), (3, 0)]:
        mask = rng.random((63, 70)) < 0.03
        if er:
            mask[:er, :] = False
            mask[-er:, :] = False
        if ed:
            mask[:, :ed] = False
            mask[:, -ed:] = False
        full = masked.mask_to_indices_2d(mask, 32)
        fast = masked.mask_to_indices_2d(mask, 32, interior=(er, ed))
        for a, b in zip(full, fast):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# chirp-z / zoom FFT
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,m,f1,f2,fs", [
    (63, 63, 10.0, 20.0, 100.0),
    (63, 40, 3.0, 9.5, 16.0),
    (70, 70, 0.5, 7.0, 32.258),
    (128, 64, -12.0, 12.0, 64.0),
])
def test_zoom_fft_matches_scipy(rng, n, m, f1, f2, fs):
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    ref = scipy.signal.ZoomFFT(n, [f1, f2], m=m, fs=fs)(x, axis=-1)
    ours = np.asarray(czt.zoom_fft(x, n=n, m=m, f1=f1, f2=f2, fs=fs, axis=-1))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)

    ours_dyn = np.asarray(
        czt.zoom_fft_dynamic(x, np.float32(f1), np.float32(f2), n=n, m=m, fs=fs, axis=-1)
    )
    np.testing.assert_allclose(ours_dyn, ref, rtol=3e-3, atol=3e-3)


def test_zoom_fft_axis(rng):
    x = (rng.standard_normal((5, 63, 7)) + 1j * rng.standard_normal((5, 63, 7))).astype(
        np.complex64
    )
    ref = scipy.signal.ZoomFFT(63, [2.0, 11.0], fs=30.0)(x, axis=1)
    ours = np.asarray(czt.zoom_fft(x, n=63, f1=2.0, f2=11.0, fs=30.0, axis=1))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------- #
# peaks
# --------------------------------------------------------------------------- #
def _smooth_signal(rng, n=128):
    x = rng.standard_normal(n)
    kernel = np.hanning(9)
    return np.convolve(x, kernel / kernel.sum(), mode="same")


def test_local_maxima_matches_scipy(rng):
    for _ in range(20):
        x = _smooth_signal(rng)
        ref, _ = scipy.signal.find_peaks(x)
        ours = np.flatnonzero(np.asarray(peaks.local_maxima(x)))
        np.testing.assert_array_equal(ours, ref)


def test_prominences_match_scipy(rng):
    for _ in range(20):
        x = _smooth_signal(rng)
        pk, _ = scipy.signal.find_peaks(x)
        ref_prom = scipy.signal.peak_prominences(x, pk)[0]
        mask = np.zeros(len(x), bool)
        mask[pk] = True
        ours = np.asarray(peaks.prominences(x, mask))[pk]
        # ours runs in float32 under jit; compare at float32 precision
        np.testing.assert_allclose(ours, ref_prom, rtol=1e-5, atol=1e-6)


def test_prominences_ansv_bit_identical_to_dense(rng):
    """The O(N log N) ANSV variant must equal the production path BIT-FOR-BIT.

    Every op in both formulations is a comparison, min, or max (no rounding),
    so exact equality is the contract — including ties/plateaus (rounded
    values) and monotone runs (the binary-descent worst case).  The ANSV
    variant is a recorded negative result (see its docstring); this test
    keeps it honest as documentation.
    """
    import jax

    for n in [2, 3, 5, 16, 17, 31, 32, 33, 60, 63, 64, 70, 128, 140, 255]:
        for trial in range(8):
            x = rng.standard_normal(n).astype(np.float32)
            if trial % 3 == 0:
                x = np.round(x)  # force exact ties
            if trial % 5 == 0:
                x = np.sort(x)  # monotone: nearest-higher always at distance 1
            m = np.asarray(peaks.local_maxima(x))
            dense = np.asarray(peaks.prominences(x, m))
            fast = np.asarray(peaks.prominences_ansv(x, m))
            np.testing.assert_array_equal(fast, dense)
    # vmapped exactly as the velocity pipeline's row_peaks uses it
    X = rng.standard_normal((70, 60)).astype(np.float32)

    def per_row(row):
        m = peaks.local_maxima(row)
        return peaks.prominences_ansv(row, m), peaks.prominences(row, m)

    fast, dense = jax.vmap(per_row)(X)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(dense))


def test_find_peaks_with_prominence(rng):
    for _ in range(10):
        x = 10 * _smooth_signal(rng)
        ref, _ = scipy.signal.find_peaks(x, prominence=4.0)
        idx, valid, count = peaks.find_peaks(x, capacity=64, min_prominence=4.0)
        ours = np.asarray(idx)[np.asarray(valid)]
        np.testing.assert_array_equal(ours, ref)


def test_top_peaks_within_threshold():
    # reference semantics: prominence-6dB peaks within threshold of max, top-k desc
    x = np.zeros(100)
    for center, height in [(10, 40.0), (30, 38.0), (50, 15.0), (70, 36.0), (90, 39.0)]:
        x[center - 3 : center + 4] += height * np.hanning(7)
    idx, vals, valid = peaks.top_peaks_within_threshold(
        x, max_peaks=3, min_prominence=6.0, threshold_db=20.0
    )
    got = sorted(np.asarray(idx)[np.asarray(valid)].tolist())
    assert got == [10, 30, 90] or got == [10, 90, 30]  # 50 is >20dB down, 70 only 4th

    # descending order by value
    v = np.asarray(vals)[np.asarray(valid)]
    assert np.all(np.diff(v) <= 0)


def test_best_peak():
    x = np.array([0.0, 3.0, 1.0, 5.0, 2.0, 4.0, 0.0])
    idx, val, found = peaks.best_peak(x)
    assert found and idx == 3 and val == 5.0
    idx, val, found = peaks.best_peak(np.arange(5.0))
    assert not bool(found)


# --------------------------------------------------------------------------- #
# CFAR — numpy oracles written from the definitions
# --------------------------------------------------------------------------- #
def _oracle_windows_1d(x, w):
    return np.lib.stride_tricks.sliding_window_view(x, w)


def _oracle_ca_1d(x, nt, ng, pfa):
    w = 2 * (nt + ng) + 1
    wins = _oracle_windows_1d(x, w)
    m = np.ones(w, bool)
    m[nt : nt + 2 * ng + 1] = False
    means = wins[:, m].mean(axis=1)
    alpha = 2 * nt * (pfa ** (-1 / (2 * nt)) - 1)
    th = np.full(len(x), np.inf)
    th[nt + ng : nt + ng + len(means)] = alpha * means
    return th


def test_ca_1d(rng):
    x = rng.exponential(1.0, 200)
    th, noise = cfar.ca_1d(x, num_train=8, num_guard=3, pfa=1e-3)
    ref = _oracle_ca_1d(x, 8, 3, 1e-3)
    np.testing.assert_allclose(np.asarray(th), ref, rtol=1e-5)


def test_go_so_1d(rng):
    x = rng.exponential(1.0, 150)
    nt, ng, pfa = 6, 2, 1e-3
    w = 2 * (nt + ng) + 1
    wins = _oracle_windows_1d(x, w)
    ml = wins[:, :nt].mean(axis=1)
    mr = wins[:, nt + 2 * ng + 1 :].mean(axis=1)
    alpha = nt * (pfa ** (-1 / nt) - 1)
    for greatest, comb in [(True, np.maximum), (False, np.minimum)]:
        th, _ = cfar.go_so_1d(x, num_train=nt, num_guard=ng, pfa=pfa, greatest=greatest)
        ref = np.full(len(x), np.inf)
        ref[nt + ng : nt + ng + len(ml)] = alpha * comb(ml, mr)
        np.testing.assert_allclose(np.asarray(th), ref, rtol=1e-5)


def test_os_1d(rng):
    x = rng.exponential(1.0, 180)
    nt, ng, rho, alpha = 5, 3, 0.5, 2.0
    th, noise = cfar.os_1d(x, num_train=nt, num_guard=ng, rho=rho, alpha=alpha)
    w = 2 * (nt + ng) + 1
    wins = _oracle_windows_1d(x, w)
    train = np.concatenate([wins[:, :nt], wins[:, nt + 2 * ng + 1 :]], axis=1)
    k = max(1, min(int(rho * 2 * nt), 2 * nt))
    ref_noise = np.sort(train, axis=1)[:, k - 1]
    ref = np.full(len(x), np.inf)
    ref[nt + ng : nt + ng + len(ref_noise)] = alpha * ref_noise
    np.testing.assert_allclose(np.asarray(th), ref, rtol=1e-5)


def test_ca_2d(rng):
    x = rng.exponential(1.0, (40, 50))
    nt, ng, pfa = (4, 3), (2, 1), 1e-3
    th, _ = cfar.ca_2d(x, num_train=nt, num_guard=ng, pfa=pfa)
    wr, wd = 2 * (nt[0] + ng[0]) + 1, 2 * (nt[1] + ng[1]) + 1
    wins = np.lib.stride_tricks.sliding_window_view(x, (wr, wd))
    m = np.ones((wr, wd), bool)
    m[nt[0] : nt[0] + 2 * ng[0] + 1, nt[1] : nt[1] + 2 * ng[1] + 1] = False
    n_train = m.sum()
    means = (wins * m).sum(axis=(2, 3)) / n_train
    alpha = n_train * (pfa ** (-1 / n_train) - 1)
    ref = np.full(x.shape, np.inf)
    er, ed = nt[0] + ng[0], nt[1] + ng[1]
    ref[er : er + means.shape[0], ed : ed + means.shape[1]] = alpha * means
    np.testing.assert_allclose(np.asarray(th), ref, rtol=1e-5)


def test_os_2d(rng):
    x = rng.exponential(1.0, (35, 45))
    nt, ng, rho, alpha = (5, 5), (3, 2), 0.7, 2.0
    th, _ = cfar.os_2d(x, num_train=nt, num_guard=ng, rho=rho, alpha=alpha)
    wr, wd = 2 * (nt[0] + ng[0]) + 1, 2 * (nt[1] + ng[1]) + 1
    wins = np.lib.stride_tricks.sliding_window_view(x, (wr, wd))
    m = np.ones((wr, wd), bool)
    m[nt[0] : nt[0] + 2 * ng[0] + 1, nt[1] : nt[1] + 2 * ng[1] + 1] = False
    train = wins[..., m]
    n_train = m.sum()
    k = max(1, min(int(rho * n_train), n_train))
    ref_noise = np.sort(train, axis=-1)[..., k - 1]
    ref = np.full(x.shape, np.inf)
    er, ed = nt[0] + ng[0], nt[1] + ng[1]
    ref[er : er + ref_noise.shape[0], ed : ed + ref_noise.shape[1]] = alpha * ref_noise
    np.testing.assert_allclose(np.asarray(th), ref, rtol=1e-5)


def test_cfar_detects_planted_target(rng):
    """Synthetic oracle mirroring the reference's verify_detectors_manual."""
    noise = rng.exponential(1.0, 120)
    noise[50] += 30.0
    for th_fn in (
        lambda x: cfar.ca_1d(x, num_train=8, num_guard=2, pfa=1e-3)[0],
        lambda x: cfar.os_1d(x, num_train=8, num_guard=2, rho=0.75, alpha=6.0)[0],
        lambda x: cfar.go_so_1d(x, num_train=8, num_guard=2, pfa=1e-3, greatest=True)[0],
        lambda x: cfar.go_so_1d(x, num_train=8, num_guard=2, pfa=1e-3, greatest=False)[0],
    ):
        dets = np.flatnonzero(noise > np.asarray(th_fn(noise)))
        assert 50 in dets

    x2 = rng.exponential(1.0, (64, 64))
    x2[20, 30] += 40.0
    th2, _ = cfar.os_2d(x2, num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
    r, c = np.where(x2 > np.asarray(th2))
    assert (20, 30) in set(zip(r.tolist(), c.tolist()))


def test_cfar_plot_detections_debug_helpers(rng):
    """plot_detections renders for 1D and 2D detectors (ref base.py:67-113)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mmwave_radar_processing_jax.detectors import get_detector_registry

    reg = get_detector_registry()
    noise = rng.exponential(1.0, 120)
    noise[50] += 30.0
    d1 = reg["os_cfar_1d"](num_train=8, num_guard=2, rho=0.75, alpha=6.0)
    assert 50 in d1.detect(noise)
    ax = d1.plot_detections(noise)
    assert len(ax.lines) >= 4
    plt.close(ax.figure)

    x2 = rng.exponential(1.0, (64, 64))
    x2[20, 30] += 40.0
    d2 = reg["os_cfar_2d"](num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
    assert (20, 30) in d2.detect(x2)
    ax2 = d2.plot_detections(x2)
    assert ax2.collections  # detection scatter present
    plt.close(ax2.figure)


# --------------------------------------------------------------------------- #
# RANSAC
# --------------------------------------------------------------------------- #
def _velocity_scene(rng, n=200, n_out=40, coef=(1.2, -0.7, 0.3)):
    """Point-cloud-style scene: y = H @ coef with outliers."""
    h = rng.standard_normal((n, 3))
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    y = h @ np.array(coef) + 0.02 * rng.standard_normal(n)
    out_idx = rng.choice(n, n_out, replace=False)
    y[out_idx] += rng.uniform(1.0, 3.0, n_out) * rng.choice([-1, 1], n_out)
    return h, y, np.array(coef)


def test_ransac_recovers_coefficients(rng):
    import jax

    h, y, true_coef = _velocity_scene(rng)
    valid = np.ones(len(y), bool)
    res = ransac.ransac_linear(
        h, y, valid, jax.random.PRNGKey(42),
        min_samples=10, residual_threshold=0.15, max_trials=20,
    )
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.coef), true_coef, atol=0.05)
    assert float(res.r2) > 0.9
    assert float(res.inlier_fraction) > 0.6


def test_ransac_matches_sklearn_contract(rng):
    from sklearn.linear_model import LinearRegression, RANSACRegressor
    import jax

    h, y, _ = _velocity_scene(rng, n=150, n_out=30)
    model = RANSACRegressor(
        estimator=LinearRegression(fit_intercept=False),
        residual_threshold=0.15, random_state=42, max_trials=20, min_samples=10,
    )
    model.fit(h, y)
    sk_coef = model.estimator_.coef_

    res = ransac.ransac_linear(
        h, y, np.ones(len(y), bool), jax.random.PRNGKey(7),
        min_samples=10, residual_threshold=0.15, max_trials=20,
    )
    # different RNG streams, same contract: coefficients agree to inlier noise
    np.testing.assert_allclose(np.asarray(res.coef), sk_coef, atol=0.05)


def test_ransac_masked_and_degenerate(rng):
    import jax

    h, y, true_coef = _velocity_scene(rng, n=80, n_out=10)
    # pad with garbage rows that must be ignored
    h_pad = np.concatenate([h, 100 * np.ones((40, 3))])
    y_pad = np.concatenate([y, -50 * np.ones(40)])
    valid = np.concatenate([np.ones(80, bool), np.zeros(40, bool)])
    res = ransac.ransac_linear(
        h_pad, y_pad, valid, jax.random.PRNGKey(0),
        min_samples=10, residual_threshold=0.15, max_trials=20,
    )
    np.testing.assert_allclose(np.asarray(res.coef), true_coef, atol=0.08)
    assert not np.asarray(res.inlier_mask)[80:].any()

    # too few valid points -> graceful zero fallback (reference ValueError path)
    res = ransac.ransac_linear(
        h_pad, y_pad, np.zeros(120, bool), jax.random.PRNGKey(0),
        min_samples=10, residual_threshold=0.15, max_trials=20,
    )
    assert not bool(res.ok)
    np.testing.assert_array_equal(np.asarray(res.coef), 0.0)


# --------------------------------------------------------------------------- #
# detection-only counting CFAR
# --------------------------------------------------------------------------- #

def test_os_2d_detect_bit_exact_vs_threshold_path():
    """count(alpha*t < x) >= k  ==  x > alpha*rank_k  (ties included)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    # quantized values force exact ties across training windows
    x = (np.round(rng.exponential(1.0, (4, 63, 70)) * 8) / 8).astype(np.float32)
    p = dict(num_train=(5, 5), num_guard=(3, 2), rho=0.7, alpha=4.0)
    thr, _ = jax.vmap(lambda m: cfar.os_2d(m, **p))(x)
    ref_mask = np.asarray(x > np.asarray(thr))
    det = np.asarray(cfar.os_2d_detect(jnp.asarray(x), **p))
    np.testing.assert_array_equal(det, ref_mask)
    assert det.sum() > 0


def test_os_1d_detect_bit_exact_vs_threshold_path():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = (np.round(rng.exponential(1.0, (8, 256)) * 4) / 4).astype(np.float32)
    p = dict(num_train=12, num_guard=4, rho=0.5, alpha=2.5)
    thr, _ = jax.vmap(lambda m: cfar.os_1d(m, **p))(x)
    ref_mask = np.asarray(x > np.asarray(thr))
    det = np.asarray(cfar.os_1d_detect(jnp.asarray(x), **p))
    np.testing.assert_array_equal(det, ref_mask)
    assert det.sum() > 0


def test_os_detect_small_input_all_false():
    import jax.numpy as jnp

    assert not np.asarray(
        cfar.os_1d_detect(jnp.ones(5), num_train=4, num_guard=2, rho=0.5, alpha=2.0)
    ).any()
    assert not np.asarray(
        cfar.os_2d_detect(jnp.ones((5, 5)), num_train=(3, 3), num_guard=(1, 1),
                          rho=0.5, alpha=2.0)
    ).any()


def test_zoom_fft_fir_localizes_tones():
    """demod->FIR->decimate->zoom DFT: in-band tone found, out-of-band killed."""
    import jax.numpy as jnp

    from mmwave_radar_processing_jax.ops import zoom_fir
    from mmwave_radar_processing_jax.ops.mxu import C2, cabs

    fs, n, decim, m = 1000.0, 2048, 8, 64
    f_center = 200.0
    band_w = fs / decim  # 125 Hz analysis band around 200 Hz
    # bin-centered in-band tone (rectangular zoom-DFT window nulls leakage at
    # the other bins, so the floor isolates FIR stopband rejection)
    f_in = f_center - band_w / 2 + 40 * band_w / m
    f_out = 350.0     # far outside; aliases into band after decimation
    j = np.arange(n) / fs
    tone = np.exp(2j * np.pi * f_in * j) + np.exp(2j * np.pi * f_out * j)
    x = C2(jnp.asarray(tone.real, jnp.float32), jnp.asarray(tone.imag, jnp.float32))

    band = band_w
    out = zoom_fir.zoom_fft_fir(
        x, f_center=f_center, fs=fs, decim=decim, num_taps=65, m=m,
        f1=-band / 2, f2=band / 2,
    )
    mag = np.asarray(cabs(out))
    freqs = f_center + (-band / 2 + np.arange(m) * band / m)
    peak_f = freqs[np.argmax(mag)]
    assert abs(peak_f - f_in) <= band / m, (peak_f, f_in)
    # the out-of-band tone is suppressed by the FIR stopband
    inband = mag.max()
    far_mask = np.abs(freqs - f_in) > 4 * band / m
    assert mag[far_mask].max() < 0.05 * inband


def test_zoom_fft_fir_batch_and_guards():
    import jax.numpy as jnp
    import pytest

    from mmwave_radar_processing_jax.ops import zoom_fir
    from mmwave_radar_processing_jax.ops.mxu import C2

    rng = np.random.default_rng(0)
    x = C2(jnp.asarray(rng.standard_normal((3, 256)), jnp.float32),
           jnp.asarray(rng.standard_normal((3, 256)), jnp.float32))
    out = zoom_fir.zoom_fft_fir(x, f_center=0.0, fs=2.0, decim=4, num_taps=33,
                                m=16, f1=-0.25, f2=0.25)
    assert out.re.shape == (3, 16)
    with pytest.raises(ValueError, match="multiple of decim"):
        zoom_fir.zoom_fft_fir(
            C2(x.re[:, :255], x.im[:, :255]), f_center=0.0, fs=2.0, decim=4,
            num_taps=33, m=16, f1=-0.25, f2=0.25,
        )
    with pytest.raises(ValueError, match="odd"):
        zoom_fir.lowpass_taps(32, 0.25, 2.0)


def test_best_prominent_peak_matches_dense(rng):
    """Candidate-restricted prominence pick == dense mask+argmax, bitwise.

    Sweeps random rows, rows with ties/plateaus, monotone rows, and rows
    where high-value peaks FAIL the prominence gate while lower ones pass.
    """
    from mmwave_radar_processing_jax.ops import peaks as p

    import jax.numpy as jnp

    def dense(row, thr):
        m = p.local_maxima(row)
        m = m & (p.prominences(row, m) >= thr)
        return (int(jnp.argmax(jnp.where(m, row, -jnp.inf))), bool(jnp.any(m)))

    cases = []
    for n in (8, 59, 64):
        for _ in range(40):
            cases.append(rng.standard_normal(n).astype(np.float32) * 10)
        # quantized rows force exact value ties
        cases.append(np.round(rng.standard_normal(n) * 2).astype(np.float32))
        cases.append(np.arange(n, dtype=np.float32))          # monotone
        cases.append(np.zeros(n, np.float32))                 # flat
        shoulder = np.zeros(n, np.float32)                    # high shoulder
        shoulder[n // 2] = 10.0
        shoulder[n // 2 + 1] = 9.5                            # fails gate
        shoulder[2] = 3.0                                     # passes gate
        cases.append(shoulder)
    for thr in (4.0, 0.5):
        for row in cases:
            want = dense(jnp.asarray(row), thr)
            got_i, got_f = p.best_prominent_peak(jnp.asarray(row), thr)
            assert (int(got_i), bool(got_f)) == want, (thr, row[:8], want)


def test_top_peaks_candidate_path_matches_dense(rng):
    """Candidate-restricted top_peaks_within_threshold == dense formulation."""
    import jax.numpy as jnp

    from mmwave_radar_processing_jax.ops import peaks as p

    def dense(x_db, max_peaks, min_prominence, threshold_db):
        mask = p.local_maxima(x_db)
        mask = mask & (p.prominences(x_db, mask) >= min_prominence)
        vals = jnp.where(mask, x_db, -jnp.inf)
        mask = mask & (x_db >= jnp.max(vals) - threshold_db)
        vals = jnp.where(mask, x_db, -jnp.inf)
        top_vals, top_idx = jax.lax.top_k(vals, max_peaks)
        valid = jnp.isfinite(top_vals)
        return top_idx, jnp.where(valid, top_vals, 0.0), valid

    import jax

    for n in (8, 63, 70):
        rows = [rng.standard_normal(n).astype(np.float32) * 8
                for _ in range(30)]
        rows.append(np.round(rng.standard_normal(n) * 2).astype(np.float32))
        rows.append(np.zeros(n, np.float32))
        for row in rows:
            for mp, pr, thr in ((3, 6.0, 20.0), (2, 6.0, 20.0),
                                (3, 0.5, 5.0)):
                wi, wv, wm = dense(jnp.asarray(row), mp, pr, thr)
                gi, gv, gm = p.top_peaks_within_threshold(
                    jnp.asarray(row), mp, pr, thr)
                np.testing.assert_array_equal(np.asarray(gm),
                                              np.asarray(wm), err_msg=str(row[:6]))
                m = np.asarray(wm)
                np.testing.assert_array_equal(np.asarray(gi)[m],
                                              np.asarray(wi)[m])
                np.testing.assert_array_equal(np.asarray(gv)[m],
                                              np.asarray(wv)[m])
