"""Overlap-save sharded spectral zoom (demod -> FIR -> decimate -> zoom DFT).

Companion to :mod:`parallel/halo_cfar` for the *spectral* stages (SURVEY §5.8
item ii: "overlap-save boundary samples for sharded FFT/FIR stages").  When a
long sample/chirp axis is sharded across chips, Bluestein's CZT cannot run
locally (its chirp kernel spans the whole axis), but the FIR formulation of
the same zoom (:mod:`ops/zoom_fir`) is local except for ``num_taps - 1``
boundary samples.  Each shard:

    1. demodulates its chunk with the *global-index* demod factors
       (a static table, sliced by ``axis_index`` at trace time),
    2. receives its left neighbor's last ``num_taps - 1`` demodulated samples
       via ``ppermute`` (the overlap-save halo; shard 0 keeps the unsharded
       zero padding),
    3. runs the identical valid-mode tap loop as the unsharded op,
    4. decimates locally (global stride alignment holds because the per-shard
       length is a multiple of ``decim``),
    5. reassembles the short decimated signal (``n/decim`` samples) on every
       chip — each shard scatters its chunk into its global slot and a
       ``psum`` over the axis fills the rest (adding zeros is exact, and
       unlike ``all_gather`` the psum's replication is statically provable
       to the shard_map checker) — then applies the zoom-DFT matmul
       replicated.

Because steps 1-4 execute the same floating-point operations in the same
order as :func:`ops.zoom_fir.zoom_fft_fir`, the sharded result is
**bit-identical** to the unsharded one (pinned in ``tests/test_parallel.py``).

Halo traffic per shard is ``(num_taps - 1) * 8`` bytes per signal row — vs
the full axis for a gathered CZT — so the stage scales with the aperture
instead of replicating it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mmwave_radar_processing_jax.ops.mxu import C2, dft_apply
from mmwave_radar_processing_jax.ops import zoom_fir


def _left_halo(x_local: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Prepend the left neighbor's last ``halo`` samples (zeros on shard 0).

    The causal FIR only looks backward, so overlap-save needs a *left* halo
    only — half the traffic of the symmetric CFAR exchange.
    """
    if x_local.shape[-1] < halo:
        raise ValueError(
            f"overlap-save needs samples_per_shard >= num_taps - 1 (= {halo})"
            f" on the sharded axis, got {x_local.shape[-1]}; use fewer shards"
            f" or a shorter filter"
        )
    n = jax.lax.axis_size(axis_name)
    right_edge = x_local[..., -halo:]
    from_left = jax.lax.ppermute(
        right_edge, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    # shard 0's ppermute slot arrives zeroed — exactly the unsharded op's
    # causal zero padding, so no edge fixup is needed.
    return jnp.concatenate([from_left, x_local], axis=-1)


def build_sharded_zoom_fir(
    mesh: Mesh,
    *,
    n: int,
    f_center: float,
    fs: float,
    decim: int,
    num_taps: int,
    m: int,
    f1: float,
    f2: float,
    axis: str = "model",
):
    """Build ``fn(x: C2[..., n]) -> C2[..., m]`` with the sample axis sharded.

    The input's last axis is split over mesh axis ``axis``; leading (batch)
    axes stay replicated.  Output is the replicated ``m``-bin zoom spectrum,
    bit-identical to ``ops.zoom_fir.zoom_fft_fir`` with the same parameters.
    """
    n_shards = mesh.shape[axis]
    if n % n_shards != 0:
        raise ValueError(f"n={n} must divide over {n_shards} shards")
    local_n = n // n_shards
    if local_n % decim != 0:
        raise ValueError(
            f"samples_per_shard={local_n} must be a multiple of decim={decim}"
            f" so local decimation stays globally stride-aligned"
        )
    halo = num_taps - 1
    taps = zoom_fir.lowpass_taps(num_taps, fs / (2 * decim), fs)
    dr_full, di_full = zoom_fir.demod_factors(n, f_center, fs)
    factors = zoom_fir.zoom_dft_factors(
        n // decim, m, f1, f2, fs / decim,
        delay=(num_taps - 1) / 2 / decim,
    )

    def local(xr, xi):
        idx = jax.lax.axis_index(axis)
        start = idx * local_n
        dr = jax.lax.dynamic_slice_in_dim(jnp.asarray(dr_full), start, local_n)
        di = jax.lax.dynamic_slice_in_dim(jnp.asarray(di_full), start, local_n)
        d_re = xr * dr - xi * di
        d_im = xr * di + xi * dr
        ext_re = _left_halo(d_re, halo, axis)
        ext_im = _left_halo(d_im, halo, axis)
        f_re = zoom_fir._fir_valid(ext_re, taps)
        f_im = zoom_fir._fir_valid(ext_im, taps)
        dec_re = f_re[..., ::decim]
        dec_im = f_im[..., ::decim]
        local_n2 = local_n // decim

        def assemble(dec):
            zeros = jnp.zeros(dec.shape[:-1] + (n // decim,), dec.dtype)
            slot = jax.lax.dynamic_update_slice_in_dim(
                zeros, dec, idx * local_n2, axis=-1
            )
            return jax.lax.psum(slot, axis)

        out = dft_apply(C2(assemble(dec_re), assemble(dec_im)), factors)
        return out.re, out.im

    batch_spec = P(None, axis)

    fn = jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(batch_spec, batch_spec),
            out_specs=(P(None, None), P(None, None)),
        )
    )

    def wrapped(x: C2) -> C2:
        re, im = fn(x.re, x.im)
        return C2(re, im)

    return wrapped
