"""Split-complex DFT-as-matmul kernels — the matmul compute core.

Two facts drive this module:

1. The radar pipeline's transform sizes are tiny (63 samples, 70 chirps, 64
   angle bins).  At these sizes an O(N^2) DFT *matmul* is a batched
   ``[batch, N] x [N, M]`` contraction the matrix units run well, the
   spectral window folds into the matrix for free, and fftshift is a static
   column permutation of the same constant.  (Whether cuFFT beats it on the
   GPU is an open measurement.)
2. Complex matmuls lower to four real matmuls anyway, so all kernels here
   operate on an explicit split representation ``C2(re, im)`` of float32
   planes.

The zoom FFT collapses too: a chirp-z transform is just the DTFT evaluated on
an arbitrary frequency grid, so instead of Bluestein's two FFTs it becomes a
single rectangular DFT matmul whose (possibly traced) frequencies are computed
in-graph — exact, simpler, and faster at these sizes.

Numerical note: float32 DFT matmuls agree with ``np.fft`` to ~1e-6 relative
at N <= 256, well inside the pipeline's parity tolerances (validated in
tests/test_mxu.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class C2(NamedTuple):
    """Split complex array: two same-shape float planes."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape


def from_complex(x) -> C2:
    """Split a (numpy or jax) complex array into float32 planes."""
    x = np.asarray(x) if not isinstance(x, jax.Array) else x
    return C2(
        jnp.asarray(np.real(x) if isinstance(x, np.ndarray) else jnp.real(x),
                    jnp.float32),
        jnp.asarray(np.imag(x) if isinstance(x, np.ndarray) else jnp.imag(x),
                    jnp.float32),
    )


def to_complex(c: C2) -> np.ndarray:
    """Host complex64 view (for tests / presentation)."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def cmul(a: C2, b: C2) -> C2:
    return C2(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cabs(c: C2) -> jax.Array:
    return jnp.sqrt(c.re * c.re + c.im * c.im)


def cabs2(c: C2) -> jax.Array:
    """Squared magnitude (cheaper when only ordering matters)."""
    return c.re * c.re + c.im * c.im


def cscale(c: C2, s) -> C2:
    return C2(c.re * s, c.im * s)


def cexp(phase: jax.Array) -> C2:
    """``exp(j*phase)`` from a real phase array."""
    return C2(jnp.cos(phase), jnp.sin(phase))


# --------------------------------------------------------------------------- #
# DFT matrices (static constants)
# --------------------------------------------------------------------------- #
def dft_factors(
    n_in: int,
    n_out: Optional[int] = None,
    *,
    shift: bool = False,
    window: Optional[np.ndarray] = None,
    inverse: bool = False,
):
    """Real (cos, sin) factors of a (rectangular) DFT matrix.

    ``X[k] = sum_{j < n_in} w[j] * x[j] * exp(-2j*pi*k*j/n_out)`` — i.e. a
    zero-padded ``n_out``-point DFT of ``n_in`` inputs.  ``shift`` permutes the
    output bins to fftshift order; ``window`` folds a spectral window into the
    matrix; ``inverse`` builds the conjugate/scaled inverse transform.

    Returns float32 ``(C, S)`` with ``M = C - jS`` (or ``C + jS`` scaled by
    ``1/n_out`` for the inverse), shaped ``(n_in, n_out)``.
    """
    n_out = n_out or n_in
    j = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    if shift:
        k = (k + n_out // 2) % n_out
    ang = 2 * np.pi * j * k / n_out
    c, s = np.cos(ang), np.sin(ang)
    if window is not None:
        c = c * window[:, None]
        s = s * window[:, None]
    if inverse:
        c, s = c / n_out, -s / n_out
    return jnp.asarray(c, jnp.float32), jnp.asarray(s, jnp.float32)


def dft_apply(x: C2, factors, axis: int = -1, *, precision=None) -> C2:
    """Apply a DFT (cos, sin) factor pair along ``axis`` — two real matmuls.

    With ``M = C - jS``: ``re' = re@C + im@S``, ``im' = im@C - re@S``
    (or the ``+`` convention for inverse factors, already folded into S).

    ``precision``: forwarded to the matmuls.  The GPU's default precision
    runs float32 matmuls in TF32 (~1e-3 relative error); pass ``"highest"``
    for true float32 where a downstream discrete decision (argmax over angle
    bins) would otherwise flip vs the CPU oracle — on tiny transforms it is
    cheap.
    """
    c, s = factors
    re = jnp.moveaxis(x.re, axis, -1)
    im = jnp.moveaxis(x.im, axis, -1)
    out_re = (jnp.matmul(re, c, precision=precision)
              + jnp.matmul(im, s, precision=precision))
    out_im = (jnp.matmul(im, c, precision=precision)
              - jnp.matmul(re, s, precision=precision))
    return C2(jnp.moveaxis(out_re, -1, axis), jnp.moveaxis(out_im, -1, axis))


def zoom_dft_factors_dynamic(
    f1: jax.Array, f2: jax.Array, *, n: int, m: int, fs: float,
    window: Optional[np.ndarray] = None,
):
    """Traced-band rectangular DTFT factors for a zoom transform.

    Frequencies ``f_k = f1 + k*(f2-f1)/m`` (scipy ``ZoomFFT`` endpoint=False
    convention); band edges may be traced scalars — the matrix values are
    computed in-graph with static shape ``(n, m)``.  ``window`` folds a static
    spectral window over the input samples into the matrix.
    """
    jv = jnp.arange(n, dtype=jnp.float32)[:, None]
    kv = jnp.arange(m, dtype=jnp.float32)[None, :]
    freqs = f1 + kv * (f2 - f1) / m
    ang = 2 * jnp.pi * jv * freqs / fs
    c, s = jnp.cos(ang), jnp.sin(ang)
    if window is not None:
        w = jnp.asarray(window, jnp.float32)[:, None]
        c, s = c * w, s * w
    return c, s


# --------------------------------------------------------------------------- #
# radar-specific fused transforms
# --------------------------------------------------------------------------- #
def range_doppler_factors(ns: int, nc: int):
    """Windowed range DFT + windowed, fftshifted Doppler DFT constants."""
    return (
        dft_factors(ns, window=np.hanning(ns)),
        dft_factors(nc, window=np.hanning(nc), shift=True),
    )


def range_doppler_map_mxu(cube: C2, rng_factors, dop_factors) -> C2:
    """``[..., rx, ns, nc]`` split cube -> windowed, Doppler-shifted RD cube.

    Two matmuls replacing window + fft2 + fftshift
    (reference ``range_doppler_resp.py:95-103``).
    """
    x = dft_apply(cube, rng_factors, axis=-2)
    return dft_apply(x, dop_factors, axis=-1)


def aoa_factors(n_antennas: int, num_angle_bins: int, shift: bool):
    """Zero-padded angle DFT: rectangular ``(n_antennas, num_angle_bins)``."""
    return dft_factors(n_antennas, num_angle_bins, shift=shift)


def aoa_union_layout(az_idx: np.ndarray, el_idx: np.ndarray):
    """Channel-subset layout shared by the fused point-cloud pipelines.

    Returns ``(union_idx, az_pos, el_pos, needed)``: the sorted union of the
    two antenna subsets, each subset's positions within that union, and the
    channel tuple to extract from the raw cube — channel 0 first (the CFAR
    map antenna) followed by the union (so a pipeline indexes ``sub_all[0]``
    for CFAR and ``sub_all[1:]`` for AoA).
    """
    az_idx = np.asarray(az_idx, int)
    el_idx = np.asarray(el_idx, int)
    union_idx = np.unique(np.concatenate([az_idx, el_idx])) if (
        az_idx.size or el_idx.size) else np.zeros(0, int)
    az_pos = np.searchsorted(union_idx, az_idx)
    el_pos = np.searchsorted(union_idx, el_idx)
    needed = (0,) + tuple(int(v) for v in union_idx)
    return union_idx, az_pos, el_pos, needed


def aoa_peak_angles(vals: C2, pos, factors, angle_bins: jax.Array,
                    precision=None) -> jax.Array:
    """Per-detection AoA: zero-padded angle DFT of ``vals[pos]`` -> argmax bin.

    ``vals``: ``(U, K)`` per-detection snapshot values on the antenna union
    (from :func:`rd_values_at`); ``pos``: this subset's positions in the
    union (reference ``point_cloud_generator.py:143-214``).  ``precision``
    forwards to the tiny angle transform — pass ``"highest"`` with
    ``rd_values_from_range_dft(mode="exact")`` so the argmax input is not
    re-rounded (TF32 on the GPU).
    """
    snap = C2(vals.re[pos].T, vals.im[pos].T)  # (K, A)
    spec = dft_apply(snap, factors, axis=-1, precision=precision)
    return angle_bins[jnp.argmax(cabs2(spec), axis=1)]


def range_dft_channels(
    raw: C2, channels, rng_factors, *, num_rx: int, cfgs_per_loop: int,
    precision=None,
) -> C2:
    """Virtual-array reformat fused into the windowed range DFT.

    The TDM chirp order is ``chirp = loop*cfgs_per_loop + cfg`` and virtual
    channel ``v = cfg*num_rx + rx`` (``processors/virtual_array.py:26-33``),
    so selecting a virtual channel of the reformatted cube is a pure
    reindexing of the raw cube — and the range DFT that always follows can
    contract the raw samples directly.  This folds the channel-subset
    extraction (``reformat_channels``) into the DFT matmul itself: the raw
    cube is read once by the contraction and no channel-subset intermediate
    is ever materialized.

    Args:
        raw: ``(rx, ns, loops*cfgs_per_loop)`` split-complex raw ADC cube.
        channels: static virtual channel indices to produce.
        rng_factors: ``(C, S)`` range DFT factors from :func:`dft_factors`
            (shape ``(ns, n_range_out)`` — pass column-sliced factors to
            compute a range-bin subset only).

    Returns:
        ``C2`` of shape ``(len(channels), n_range_out, loops)`` — equal to
        ``dft_apply(reformat(raw)[channels], rng_factors, axis=-2)``.
    """
    rc, rs = rng_factors
    ns = raw.re.shape[-2]
    loops = raw.re.shape[-1] // cfgs_per_loop
    r4_re = raw.re[:num_rx].reshape(num_rx, ns, loops, cfgs_per_loop)
    r4_im = raw.im[:num_rx].reshape(num_rx, ns, loops, cfgs_per_loop)
    sel_re = jnp.stack(
        [r4_re[int(v) % num_rx, :, :, int(v) // num_rx] for v in channels]
    )  # (A, ns, loops)
    sel_im = jnp.stack(
        [r4_im[int(v) % num_rx, :, :, int(v) // num_rx] for v in channels]
    )
    out_re = (jnp.einsum("asl,sw->awl", sel_re, rc, precision=precision)
              + jnp.einsum("asl,sw->awl", sel_im, rs, precision=precision))
    out_im = (jnp.einsum("asl,sw->awl", sel_im, rc, precision=precision)
              - jnp.einsum("asl,sw->awl", sel_re, rs, precision=precision))
    return C2(out_re, out_im)


def rd_values_from_range_dft(
    R: C2, dop_factors, r_idx: jax.Array, v_idx: jax.Array,
    *, mode: str = "fast",
) -> C2:
    """Per-detection RD values from an already range-transformed cube.

    Same result as :func:`rd_values_at` but starting from
    ``R = range-DFT(cube)`` (e.g. the :func:`range_dft_channels` output that
    the CFAR map shares): the range-bin selection is a *real* one-hot
    contraction and the Doppler factor columns are one-hot-selected the same
    way.  Selecting output columns of a DFT equals selecting factor-matrix
    columns, so this matches the bilinear form.

    ``mode``:

    - ``"fast"`` (default): one-hot contractions at the device's default
      matmul precision.  On the GPU that is TF32, which rounds the selected
      values to ~3 significant digits, so an AoA argmax between two
      near-equal bins can flip against the CPU float32 oracle.
    - ``"exact"``: each selection runs twice at default precision on a
      hi/lo split of its operand (``hi = bf16(x)`` passes through the
      one-hot exactly; ``lo = x - hi`` carries the residual, rounded only in
      its low bits), and the final tiny Doppler contraction runs f32.
      Restores CPU-faithful discrete decisions down to the error of ``R``
      itself.

    Args:
        R: ``(A, W, L)`` split-complex range-DFT'd cube (range bins on W).
        dop_factors: ``(C, S)`` Doppler factors, shape ``(L, n_vel)``.
        r_idx, v_idx: ``(K,)`` int range/Doppler bin indices.

    Returns:
        ``C2`` of shape ``(A, K)``.
    """
    dc, ds = dop_factors
    W = R.re.shape[-2]
    oh_r = (r_idx[None, :] == jnp.arange(W)[:, None]).astype(jnp.float32)
    oh_v = (v_idx[None, :] == jnp.arange(dc.shape[1])[:, None]).astype(
        jnp.float32)

    if mode == "fast":
        t_c, t_s = dc @ oh_v, ds @ oh_v  # (L, K)
        u_re = jnp.einsum("awl,wk->alk", R.re, oh_r)
        u_im = jnp.einsum("awl,wk->alk", R.im, oh_r)
        val_re = (jnp.einsum("alk,lk->ak", u_re, t_c)
                  + jnp.einsum("alk,lk->ak", u_im, t_s))
        val_im = (jnp.einsum("alk,lk->ak", u_im, t_c)
                  - jnp.einsum("alk,lk->ak", u_re, t_s))
        return C2(val_re, val_im)
    if mode != "exact":
        raise ValueError(f"unknown rd-values mode {mode!r}")

    def split(x):
        h = x.astype(jnp.bfloat16).astype(jnp.float32)
        return h, x - h

    def sel_rows(x):  # exact-in-f32 one-hot row selection, 2 default passes
        h, l = split(x)
        return (jnp.einsum("awl,wk->alk", h, oh_r)
                + jnp.einsum("awl,wk->alk", l, oh_r))

    def sel_cols(x):
        h, l = split(x)
        return (jnp.einsum("lv,vk->lk", h, oh_v)
                + jnp.einsum("lv,vk->lk", l, oh_v))

    u_re, u_im = sel_rows(R.re), sel_rows(R.im)
    t_c, t_s = sel_cols(dc), sel_cols(ds)
    # the remaining Doppler contraction is tiny (A x K x L) — f32 precision
    # costs nothing and keeps the downstream argmax decisions CPU-faithful
    hi = jax.lax.Precision.HIGHEST
    val_re = (jnp.einsum("alk,lk->ak", u_re, t_c, precision=hi)
              + jnp.einsum("alk,lk->ak", u_im, t_s, precision=hi))
    val_im = (jnp.einsum("alk,lk->ak", u_im, t_c, precision=hi)
              - jnp.einsum("alk,lk->ak", u_re, t_s, precision=hi))
    return C2(val_re, val_im)


def doppler_factors_strided(dop_factors, cfg_idx: int, cfgs_per_loop: int):
    """Expand ``(L, V)`` Doppler factors to the raw ``(L*cpl, V)`` chirp layout.

    TDM chirp order is ``chirp = loop*cpl + cfg`` (``virtual_array.py``), so a
    virtual channel's Doppler transform over loops equals a contraction over
    RAW chirps with a factor matrix that is zero except at rows
    ``cfg_idx::cpl``.  Folding the stride into the (static) factor matrix lets
    the Doppler DFT run directly on un-reformatted raw data — no reshape, no
    strided slice, no virtual-cube intermediate (the reshape/stack relayout
    is what ``scripts/ab_rangedft.py`` compares against).
    """
    dc, ds = dop_factors
    nl = dc.shape[0]
    out_c = np.zeros((nl * cfgs_per_loop, dc.shape[1]), np.float32)
    out_s = np.zeros((nl * cfgs_per_loop, ds.shape[1]), np.float32)
    out_c[cfg_idx::cfgs_per_loop, :] = np.asarray(dc)
    out_s[cfg_idx::cfgs_per_loop, :] = np.asarray(ds)
    # numpy (not jnp) on purpose: this helper runs inside traced pipelines,
    # where jnp.asarray would stage the constant into a tracer and break the
    # static hi/lo splitting downstream
    return out_c, out_s


def rd0_map_from_raw(raw: C2, rx: int, rng_factors, dop_strided,
                     precision=None) -> C2:
    """One virtual channel's windowed RD map straight from the raw cube.

    ``(E_w^T raw[rx]) @ D_strided`` — two clean matmul chains, no reformat
    reshape and no range-DFT intermediate in HBM (XLA fuses the pair).
    Equal to ``range_doppler_map_mxu(reformat(raw)[chan])`` for the channel
    ``chan = cfg*num_rx + rx`` whose strided factors were built by
    :func:`doppler_factors_strided` (float tolerance: summation order
    differs).
    """
    rc, rs = rng_factors
    d0c, d0s = dop_strided
    p = precision
    t_re = (jnp.einsum("sc,sw->wc", raw.re[rx], rc, precision=p)
            + jnp.einsum("sc,sw->wc", raw.im[rx], rs, precision=p))
    t_im = (jnp.einsum("sc,sw->wc", raw.im[rx], rc, precision=p)
            - jnp.einsum("sc,sw->wc", raw.re[rx], rs, precision=p))
    return C2(jnp.matmul(t_re, d0c, precision=p)
              + jnp.matmul(t_im, d0s, precision=p),
              jnp.matmul(t_im, d0c, precision=p)
              - jnp.matmul(t_re, d0s, precision=p))


#: static hi/lo bf16 split of a factor matrix — hi passes a default-precision
#: (TF32) matmul exactly (a bf16 value fits TF32), lo carries the residual
def _static_hilo(m: np.ndarray):
    hi = np.asarray(m, np.float32).astype(jnp.bfloat16).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(np.asarray(m, np.float32) - hi)


def rd_values_from_raw(
    raw: C2, rng_factors, dop_factors, r_idx: jax.Array, v_idx: jax.Array,
    *, channels, num_rx: int, cfgs_per_loop: int, mode: str = "fast",
) -> C2:
    """Per-detection RD values straight from the raw cube (no union cube).

    ``val[a, k] = sum_{s,c} raw[rx_a, s, j_a + c*cpl] * F[s, k] * H[c, k]``
    with ``F = (C - jS)_rng[:, r_k]`` (one-hot-selected range-DFT rows) and
    ``H = (C - jS)_dop[:, v_k]``.  Evaluation order: ``P[rx] = raw[rx]^T F``
    (one clean ``(nt, ns) x (ns, K)`` matmul per rx/plane — the only
    O(ns*nt*K) term, and it reads the raw cube directly), then per channel a
    strided slice of ``P`` contracts with ``H`` elementwise.  Compared
    with the union-cube path this removes the reformat reshape, the
    7-channel stacking, and the R materialization entirely.

    ``mode``:

    - ``"fast"``: default-precision matmuls (TF32 on the GPU).  The raw
      operand is rounded but the error then *averages* over the 63-sample
      contraction instead of landing on the selected values.
    - ``"exact"``: the factor-selection matmuls run on static hi/lo splits
      (exact), and the ``P`` matmuls at ``Precision.HIGHEST`` (float32);
      the trailing elementwise contraction is float32.  CPU-faithful AoA
      decisions.

    Args:
        raw: ``(num_rx, ns, nt)`` split-complex raw cube.
        channels: static virtual channel indices (``v = cfg*num_rx + rx``).

    Returns:
        ``C2`` of shape ``(len(channels), K)``.
    """
    rc, rs = rng_factors
    dc, ds = dop_factors
    w, nv = rc.shape[1], dc.shape[1]
    oh_r = (r_idx[None, :] == jnp.arange(w)[:, None]).astype(jnp.float32)
    oh_v = (v_idx[None, :] == jnp.arange(nv)[:, None]).astype(jnp.float32)

    # per-chirp-cfg Doppler factors expanded to the raw 210-chirp layout
    # (static, zeros off-stride): the chirp-cfg selection lives in the
    # factor matrix, never as a strided slice (strided slices relayout
    # whole planes).
    cfgs_needed = sorted({int(v) // num_rx for v in channels})
    dstr = {c: doppler_factors_strided((dc, ds), c, cfgs_per_loop)
            for c in cfgs_needed}

    if mode == "fast":
        f_c, f_s = rc @ oh_r, rs @ oh_r  # (ns, K)
        h = {c: (dstr[c][0] @ oh_v, dstr[c][1] @ oh_v)  # (nt, K)
             for c in cfgs_needed}
        prec = None
    elif mode == "exact":
        rch, rcl = _static_hilo(rc)
        rsh, rsl = _static_hilo(rs)
        f_c = rch @ oh_r + rcl @ oh_r
        f_s = rsh @ oh_r + rsl @ oh_r
        h = {}
        for c in cfgs_needed:
            dch, dcl = _static_hilo(dstr[c][0])
            dsh, dsl = _static_hilo(dstr[c][1])
            h[c] = (dch @ oh_v + dcl @ oh_v, dsh @ oh_v + dsl @ oh_v)
        prec = jax.lax.Precision.HIGHEST
    else:
        raise ValueError(f"unknown rd-values mode {mode!r}")

    # Q-first contraction order: contract the
    # CHIRP axis first — ``Q = raw[rx] @ H_cfg`` is a natural-layout matmul
    # (raw LHS contracts its lane axis) with a SMALL (ns, K) result, and the
    # remaining sample contraction is a tiny diagonal reduction against the
    # selected range-DFT rows.  The sample-first order (``P = F^T raw``)
    # materializes (K, nt) planes per rx — ~0.9 GB per batch-1024 dispatch
    # of memory traffic that this order never creates.
    vals_re, vals_im = [], []
    for v in channels:
        rx, cfg = int(v) % num_rx, int(v) // num_rx
        ar, ai = raw.re[rx], raw.im[rx]  # (ns, nt)
        h_c, h_s = h[cfg]  # (nt, K)
        q_re = (jnp.einsum("st,tk->sk", ar, h_c, precision=prec)
                + jnp.einsum("st,tk->sk", ai, h_s, precision=prec))
        q_im = (jnp.einsum("st,tk->sk", ai, h_c, precision=prec)
                - jnp.einsum("st,tk->sk", ar, h_s, precision=prec))
        vals_re.append(jnp.sum(q_re * f_c + q_im * f_s, axis=0))
        vals_im.append(jnp.sum(q_im * f_c - q_re * f_s, axis=0))
    return C2(jnp.stack(vals_re), jnp.stack(vals_im))


def rd_values_at(
    cube: C2, rng_factors, dop_factors, r_idx: jax.Array, v_idx: jax.Array
) -> C2:
    """Range-Doppler values of selected cells as bilinear DFT forms.

    ``val[a, k] = sum_c ( sum_s cube[a, s, c] * M_rng[s, r_k] ) * M_dop[c, v_k]``
    — exactly the ``(r_k, v_k)`` entries of ``range_doppler_map_mxu(cube)``,
    evaluated *without materializing the full multi-channel RD cube*.  For the
    point-cloud pipeline this is the difference between computing and writing
    12 channels' RD planes to device memory just to gather K cells back, and
    two small matmuls per frame.

    Column selection is a one-hot matmul (``M[:, idx] == M @ onehot(idx)``) —
    no gathers anywhere.  Contraction order (range axis first,
    then Doppler) mirrors :func:`range_doppler_map_mxu`.

    Args:
        cube: ``(A, ns, nc)`` split-complex antenna cube (already windowed by
            the factor matrices, like ``range_doppler_map_mxu``).
        r_idx, v_idx: ``(K,)`` int range/Doppler bin indices.

    Returns:
        ``C2`` of shape ``(A, K)``.
    """
    rc, rs = rng_factors
    dc, ds = dop_factors
    oh_r = (r_idx[None, :] == jnp.arange(rc.shape[1])[:, None]).astype(jnp.float32)
    oh_v = (v_idx[None, :] == jnp.arange(dc.shape[1])[:, None]).astype(jnp.float32)
    s_c, s_s = rc @ oh_r, rs @ oh_r  # (ns, K)
    t_c, t_s = dc @ oh_v, ds @ oh_v  # (nc, K)
    # range contraction: u = x @ (S_c - j S_s) per detection column
    u_re = jnp.einsum("asc,sk->ack", cube.re, s_c) + jnp.einsum(
        "asc,sk->ack", cube.im, s_s)
    u_im = jnp.einsum("asc,sk->ack", cube.im, s_c) - jnp.einsum(
        "asc,sk->ack", cube.re, s_s)
    # Doppler contraction
    val_re = jnp.einsum("ack,ck->ak", u_re, t_c) + jnp.einsum(
        "ack,ck->ak", u_im, t_s)
    val_im = jnp.einsum("ack,ck->ak", u_im, t_c) - jnp.einsum(
        "ack,ck->ak", u_re, t_s)
    return C2(val_re, val_im)
