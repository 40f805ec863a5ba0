"""Device-resident synthetic-aperture pipeline: ``lax.scan`` over a recording.

Streams frames through the multi-frame synthetic-aperture beamformer as one
jitted scan — ring-buffer state on device, split-complex math throughout
(steering matmul + windowed range DFT), no complex dtypes — producing a
``[T, range, az, el]`` magnitude stack plus the per-frame validity gate.

Mirrors :class:`~mmwave_radar_processing_jax.processors.synthetic_array.SyntheticArrayBeamformerProcessor`
(identical geometry / gate / beamforming math, shared pure functions) but
processes whole recordings per dispatch instead of frame-at-a-time objects.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.ops import mxu, windows
from mmwave_radar_processing_jax.processors.synthetic_array import (
    chained_geometry,
    velocity_gate,
)


def build_synthetic_aperture_pipeline(
    cfg: RadarConfig,
    *,
    receiver_idx: int = 0,
    chirp_cfg_idx: int = 0,
    num_frames: int = 3,
    stride: int = 1,
    az_angle_bins_rad=np.deg2rad(np.linspace(-30, 30, 60)),
    el_angle_bins_rad=np.array([0.0]),
    min_vel=np.array([0.15, 0.0, 0.0]),
    max_vel=np.array([0.3, 0.05, 0.05]),
    max_vel_stdev=np.array([0.1, 0.1, 0.1]),
):
    """Compile ``(raw_re[T,...], raw_im[T,...], vels[T,3]) -> (mag, valid)``.

    Returns magnitudes ``[T, range, n_az, n_el]`` (zeroed where the velocity
    gate rejects the aperture, mirroring the reference's empty return) and the
    ``[T]`` validity mask.
    """
    ns = cfg.num_adc_samples
    az = np.asarray(az_angle_bins_rad, float)
    el = np.asarray(el_angle_bins_rad, float)
    lam = cfg.lambda_m

    chirp_cfg_idxs = np.tile(
        np.arange(cfg.frame.start_index, cfg.frame.end_index + 1), cfg.frame.loops
    )
    valid = chirp_cfg_idxs == chirp_cfg_idx
    valid_idx = np.flatnonzero(valid)[::stride]
    n_chirps = len(valid_idx)
    chirp_times_s = jnp.asarray(
        (np.arange(cfg.chirps_per_frame - 1, -1, -1) * -cfg.chirp_period_us)[
            valid_idx
        ]
        * 1e-6,
        jnp.float32,
    )
    frame_dt = cfg.frame.periodicity_ms * 1e-3

    th, ph = np.meshgrid(az, el, indexing="ij")
    steering = jnp.asarray(
        np.stack(
            [np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph), np.sin(ph)], axis=-1
        ).reshape(-1, 3),
        jnp.float32,
    )  # (A, 3)

    elem_win = jnp.asarray(windows.hamming(num_frames * n_chirps))
    rng_factors = mxu.dft_factors(ns, window=np.hanning(ns))

    def step(state, frame):
        adc_re, adc_im, vel_hist = state
        f_re, f_im, vel = frame
        sel_re = f_re[receiver_idx][:, valid_idx]
        sel_im = f_im[receiver_idx][:, valid_idx]
        adc_re = jnp.concatenate([adc_re[1:], sel_re[None]], axis=0)
        adc_im = jnp.concatenate([adc_im[1:], sel_im[None]], axis=0)
        vel_hist = jnp.concatenate([vel_hist[1:], vel[None]], axis=0)

        ok = velocity_gate(vel_hist, min_vel, max_vel, max_vel_stdev)
        geometry = chained_geometry(vel_hist, chirp_times_s, frame_dt)  # (F,3,C)
        positions = jnp.transpose(geometry, (1, 0, 2)).reshape(3, -1)  # (3, E)
        data_re = jnp.transpose(adc_re, (1, 0, 2)).reshape(ns, -1)  # (ns, E)
        data_im = jnp.transpose(adc_im, (1, 0, 2)).reshape(ns, -1)

        phase = 2 * jnp.pi * (steering @ positions) / lam  # (A, E)
        ph_c = mxu.cexp(phase)
        wr = data_re * elem_win[None, :]
        wi = data_im * elem_win[None, :]
        bf_re = wr @ ph_c.re.T - wi @ ph_c.im.T  # (ns, A) matmuls
        bf_im = wr @ ph_c.im.T + wi @ ph_c.re.T
        spec = mxu.dft_apply(mxu.C2(bf_re, bf_im), rng_factors, axis=0)
        mag = mxu.cabs(spec).reshape(ns, len(az), len(el))
        mag = jnp.where(ok, mag, 0.0)
        return (adc_re, adc_im, vel_hist), (mag, ok)

    def pipeline(raw_re, raw_im, vels):
        init = (
            jnp.zeros((num_frames, ns, n_chirps), jnp.float32),
            jnp.zeros((num_frames, ns, n_chirps), jnp.float32),
            jnp.zeros((num_frames, 3), jnp.float32),
        )
        _, (mags, oks) = jax.lax.scan(
            step, init, (raw_re, raw_im, vels.astype(jnp.float32))
        )
        return mags, oks

    return jax.jit(pipeline)
