"""Synthetic-aperture beamforming sharded over aperture elements.

The coherent multi-frame aperture grows with ``num_frames * chirps`` elements
— the domain's version of "long context" (SURVEY.md §5.7).  To scale it, the
element axis is sharded over the ``model`` mesh axis: each chip forms the
partial beam sum over its element shard (a local matmul), and one
``psum`` over the ``model`` axis produces the full beamformed response before
the batched range FFT.  Cross-device traffic is exactly one ``[ns, A]`` complex
all-reduce per dispatch, independent of aperture length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def build_sharded_beamformer(
    mesh: Mesh,
    *,
    lambda_m: float,
    axis: str = "model",
    split_complex: bool = False,
):
    """Build an element-sharded beamformer.

    ``data`` is ``[ns, E]`` and ``positions`` ``[3, E]``, both sharded on the
    element axis; ``steering`` ``[A, 3]`` and the windows are replicated.  The
    returned response is replicated (post-``psum``).

    ``split_complex=True`` takes/returns float32 (re, im) planes and performs
    the range transform as a DFT matmul — for runtimes without complex dtype
    support and for matmul-everything execution
    (:mod:`mmwave_radar_processing_jax.ops.mxu`).
    """
    if split_complex:
        from mmwave_radar_processing_jax.ops import mxu

        def local_sc(data_re, data_im, positions, steering, range_window,
                     element_window):
            phase = 2 * jnp.pi * (steering @ positions) / lambda_m  # (A, E)
            ph = mxu.cexp(phase)
            wr = data_re * element_window[None, :]
            wi = data_im * element_window[None, :]
            # (ns, E) @ (E, A) complex matmul as four real matmuls
            part_re = wr @ ph.re.T - wi @ ph.im.T
            part_im = wr @ ph.im.T + wi @ ph.re.T
            bf_re = jax.lax.psum(part_re, axis)
            bf_im = jax.lax.psum(part_im, axis)
            ns = bf_re.shape[0]
            factors = mxu.dft_factors(ns, window=None)
            out = mxu.dft_apply(
                mxu.C2(bf_re * range_window[:, None], bf_im * range_window[:, None]),
                factors,
                axis=0,
            )
            return out.re, out.im

        return jax.jit(
            shard_map(
                local_sc,
                mesh=mesh,
                in_specs=(P(None, axis), P(None, axis), P(None, axis),
                          P(None, None), P(None), P(axis)),
                out_specs=(P(None, None), P(None, None)),
            )
        )

    def local(data, positions, steering, range_window, element_window):
        phases = jnp.exp(1j * 2 * jnp.pi * (steering @ positions) / lambda_m)
        partial_sum = (data * element_window[None, :]) @ phases.T  # local matmul
        beamformed = jax.lax.psum(partial_sum, axis)  # one all-reduce
        return jnp.fft.fft(beamformed * range_window[:, None], axis=0)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, axis), P(None, axis), P(None, None), P(None), P(axis)),
            out_specs=P(None, None),
        )
    )


def build_snapshot_sharded_capon(
    mesh: Mesh,
    *,
    loading: float = 1e-2,
    method: str = "capon",
    axis: str = "model",
):
    """Capon/Bartlett spectra with the *snapshot* (chirp) axis sharded.

    Long coherent dwells scale the snapshot count, not the antenna count; the
    sample covariance ``R = X X^H / K`` is a sum over snapshots, so each chip
    forms the partial covariance of its chirp shard (local matmuls) and
    one ``[..., A, A]`` ``psum`` over ``axis`` assembles the full ``R`` —
    cross-device traffic independent of dwell length, the covariance analog of the
    element-sharded beam ``psum`` above.  The tiny solve + spectrum then run
    replicated.

    Returns ``fn(xr, xi, steer_re, steer_im) -> power``: ``x`` is
    ``[N, A, K]`` split-complex snapshots sharded on ``K``; steering
    ``(A, M)`` replicated; output ``[N, M]`` replicated, numerically equal to
    the unsharded :func:`ops.beamform.capon_from_covariance` /
    :func:`ops.beamform.bartlett_from_covariance` of the full covariance.
    """
    from mmwave_radar_processing_jax.ops import beamform as bf
    from mmwave_radar_processing_jax.ops.mxu import C2

    if method not in ("capon", "bartlett"):
        raise ValueError(f"unknown method {method!r}")

    def local(xr, xi, steer_re, steer_im):
        k_total = xr.shape[-1] * jax.lax.axis_size(axis)
        xr_t = jnp.swapaxes(xr, -1, -2)
        xi_t = jnp.swapaxes(xi, -1, -2)
        rr = (xr @ xr_t + xi @ xi_t) / k_total  # partial covariance
        ri = (xi @ xr_t - xr @ xi_t) / k_total
        r = C2(jax.lax.psum(rr, axis), jax.lax.psum(ri, axis))
        steering = C2(steer_re, steer_im)
        if method == "bartlett":
            return bf.bartlett_from_covariance(r, steering)
        return bf.capon_from_covariance(r, steering, loading=loading)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, None, axis), P(None, None, axis),
                      P(None, None), P(None, None)),
            out_specs=P(None, None),
        )
    )
