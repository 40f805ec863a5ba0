"""Fused Doppler-azimuth response kernel: angle DFT + |.| + masked range-mean.

The velocity pipeline needs, per frame, the four antenna-sub-array responses

``resp[s, v, a] = sum_w wgt[w] * | sum_r u[ch(s,r), w, v] * F[s,r,a] |``

(reference ``doppler_azimuth_resp.py:296-334``: zero-padded angle DFT of each
4-antenna sub-array, magnitude, then the altitude-window mean over range
rows; ``wgt`` is the range mask divided by its sum).  Unfused, the
``[set, W, vel, angle]`` spectrum is written and read back once per frame;
here it never leaves registers.

Layout (Pallas, Triton route):

- one program per (frame, sub-array set, block of :data:`BLOCK_V` velocity
  bins); the frame axis comes from ``jax.vmap`` over :func:`set_responses`,
  which Pallas turns into a grid dimension;
- inside the program a loop over the ``W`` range rows accumulates the
  weighted magnitude into one ``[BLOCK_V, Av']`` register tile (``Av``
  padded to a power of two, the last velocity block masked; loads and the
  store are masked);
- the K=4 angle contraction is four broadcast multiply-adds per row: the
  set's four rx coefficient vectors are loaded once per program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: velocity bins per program and launch parameters, chosen on the card at
#: the flagship widths (see CHANGES.md for the sweep)
BLOCK_V = 16
NUM_WARPS = 1
NUM_STAGES = 1


def _kernel(chan_ref, u_re_ref, u_im_ref, wgt_ref, fc_ref, fs_ref, out_ref, *,
            n_rx, win_rows, nv, av, block_v):
    s = pl.program_id(0)
    v = pl.program_id(1) * block_v + jnp.arange(block_v)
    a = jnp.arange(pl.next_power_of_2(av))
    vmask = v < nv
    amask = a < av
    chans = [chan_ref[s, r] for r in range(n_rx)]
    fc = [plgpu.load(fc_ref.at[s * n_rx + r, a], mask=amask, other=0.0)[None, :]
          for r in range(n_rx)]
    fs = [plgpu.load(fs_ref.at[s * n_rx + r, a], mask=amask, other=0.0)[None, :]
          for r in range(n_rx)]

    def row(w, acc):
        sp_re = sp_im = None
        for r in range(n_rx):
            ur = plgpu.load(u_re_ref.at[chans[r], w, v], mask=vmask,
                            other=0.0)[:, None]
            ui = plgpu.load(u_im_ref.at[chans[r], w, v], mask=vmask,
                            other=0.0)[:, None]
            t_re = ur * fc[r] + ui * fs[r]
            t_im = ui * fc[r] - ur * fs[r]
            sp_re = t_re if sp_re is None else sp_re + t_re
            sp_im = t_im if sp_im is None else sp_im + t_im
        return acc + wgt_ref[w] * jnp.sqrt(sp_re * sp_re + sp_im * sp_im)

    acc = lax.fori_loop(0, win_rows, row,
                        jnp.zeros((v.shape[0], a.shape[0]), jnp.float32))
    plgpu.store(out_ref.at[s, v[:, None], a[None, :]], acc,
                mask=vmask[:, None] & amask[None, :])


@partial(jax.jit, static_argnames=("set_idx", "interpret"))
def set_responses(
    u_re: jax.Array,
    u_im: jax.Array,
    wgt: jax.Array,
    fct: jax.Array,
    fst: jax.Array,
    *,
    set_idx,
    interpret: bool = False,
) -> jax.Array:
    """All sub-array responses of one frame (vmap over frames).

    Args:
        u_re, u_im: ``[n_channels, W, nv]`` chirp-DFT'd range-window spectrum.
        wgt: ``[W]`` range-window weights (mask already divided by its sum —
            the kernel computes a weighted sum, not a mean).
        fct, fst: ``[n_sets*n_rx, Av]`` angle DFT factors, row
            ``s*n_rx + r`` = sub-array ``s``'s antenna ``r`` (cos / sin
            planes, ``M = C - jS`` convention of :func:`ops.mxu.dft_factors`).
        set_idx: static tuple-of-tuples: channel index per (set, rx).
        interpret: run the kernel in the Pallas interpreter (tests only).

    Returns:
        ``[n_sets, nv, Av]`` float32 responses.
    """
    n_sets, n_rx = len(set_idx), len(set_idx[0])
    _, win_rows, nv = u_re.shape
    av = fct.shape[-1]
    chan = jnp.asarray(np.asarray(set_idx, np.int32))
    block_v = min(BLOCK_V, pl.next_power_of_2(nv))
    kern = partial(_kernel, n_rx=n_rx, win_rows=win_rows, nv=nv, av=av,
                   block_v=block_v)
    return pl.pallas_call(
        kern,
        grid=(n_sets, pl.cdiv(nv, block_v)),
        out_shape=jax.ShapeDtypeStruct((n_sets, nv, av), jnp.float32),
        in_specs=[pl.no_block_spec] * 6,
        out_specs=pl.no_block_spec,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="doppler_az_responses",
    )(chan, u_re, u_im, wgt, fct, fst)
