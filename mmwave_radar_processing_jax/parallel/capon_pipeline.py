"""Fused frame-batched Capon / Bartlett heatmap pipeline.

One jitted program mapping a batch of raw TI ADC frames to range-azimuth
beamforming power maps: virtual-array reformat -> windowed range DFT
(matmul) -> per-range-bin snapshot covariance -> Capon (loaded real-embedded
Cholesky solve) or Bartlett (steering contraction) spectrum on the reference
angle grid.  Split-complex throughout, and batch-sharded over the ``data``
mesh axis like the point-cloud pipeline (``parallel/pipeline.py``).

This is the "Capon/Bartlett beamforming azimuth-elevation heatmaps (virtual
array, 6843 ods)" north-star config (BASELINE.json); the ``bench.py --metric
capon`` entry times it.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import beamform as bf, mxu, windows


def build_capon_pipeline(
    cfg: RadarConfig,
    *,
    antenna_idxs: Sequence[int] = (0, 3, 4, 7),
    num_angle_bins: int = 64,
    method: str = "capon",
    loading: float = 1e-2,
    reformat_input: bool = True,
    capon_method: str = "linv",
):
    """Compile ``(raw_re, raw_im) [B, rx, ns, nc] -> [B, ns, angles]`` power.

    ``method``: ``"capon"`` (MVDR, covariance + Cholesky solve) or
    ``"bartlett"`` (steering contraction straight from the snapshots,
    :func:`ops.beamform.bartlett_from_snapshots`).

    ``capon_method``: ``"linv"`` (unrolled ``L^-1`` + one matmul) or
    ``"solve"`` (unrolled substitution), as in
    :func:`ops.beamform.capon_from_covariance`.
    """
    if method not in ("capon", "bartlett"):
        raise ValueError(f"unknown method {method!r}")
    ns = cfg.num_adc_samples
    num_rx, cpl = cfg.num_rx_antennas, cfg.chirp_cfgs_per_loop
    idxs = np.asarray(list(antenna_idxs), int)
    rng_factors = mxu.dft_factors(ns, window=windows.hanning(ns))
    steering = bf.steering_ula(grids.phase_shift_bins(num_angle_bins),
                               len(idxs))

    chans = tuple(int(v) for v in idxs)

    def pipeline(raw_re: jax.Array, raw_im: jax.Array) -> jax.Array:
        if reformat_input:
            # reformat folded into the range DFT: only the selected antennas'
            # chirp slices are ever touched, no 12-channel virtual-cube
            # materialization (ops/mxu.range_dft_channels)
            rng = jax.vmap(
                lambda rr, ri: mxu.range_dft_channels(
                    mxu.C2(rr, ri), chans, rng_factors,
                    num_rx=num_rx, cfgs_per_loop=cpl,
                )
            )(raw_re, raw_im)
        else:
            sel = mxu.C2(raw_re[:, idxs], raw_im[:, idxs])  # [B, A, ns, K]
            rng = mxu.dft_apply(sel, rng_factors, axis=-2)
        # snapshots per (frame, range bin): [B, ns, A, K]
        snaps = mxu.C2(jnp.moveaxis(rng.re, 1, 2), jnp.moveaxis(rng.im, 1, 2))
        if method == "bartlett":
            return bf.bartlett_from_snapshots(snaps, steering)
        r = bf.spatial_covariance(snaps)
        return bf.capon_from_covariance(r, steering, loading=loading,
                                        method=capon_method)

    return jax.jit(pipeline)
