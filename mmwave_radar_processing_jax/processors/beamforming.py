"""Capon / Bartlett range-azimuth heatmap processors.

The reference builds range-angle maps with a zero-padded antenna FFT
(``range_angle_resp.py:104-120``) and per-detection AoA with a snapshot FFT
(``point_cloud_generator.py:143-214``).  These processors add the classical
covariance beamformers on the same grids — Bartlett (identical resolution to
the FFT map, evaluated on the exact quirky ``arcsin(delta_phi/pi)`` angle
grid) and Capon/MVDR (super-resolution via the loaded inverse-covariance
solve).  Both are north-star items for this build (BASELINE.json "Capon /
Bartlett beamforming azimuth-elevation heatmaps (virtual array, 6843 ods)").

Snapshot model: after a windowed range DFT, each range bin's snapshots are its
chirps — ``X_r[a, k]`` for antenna subset ``a`` and slow-time index ``k`` —
so the covariance averages over Doppler diversity exactly where the
doppler-azimuth path takes its 2D FFT (``doppler_azimuth_resp.py:296-334``).

All device math is split-complex (:mod:`ops.mxu`); the object API accepts
complex cubes and splits on entry, so it runs on CPU and complex-capable
backends alike, while the batched pipelines feed ``C2`` planes directly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig, grids
from mmwave_radar_processing_jax.ops import beamform as bf, mxu, windows
from mmwave_radar_processing_jax.processors.base import Processor

# Flagship 6843 ODS antenna subsets (hardcoded in the reference consumers,
# e.g. velocity_estimator.py:182-188 / gui_configs processor_params.yaml).
ODS_AZ_IDXS = (0, 3, 4, 7)
ODS_EL_IDXS = (9, 8, 5, 4)


def l_array_positions(
    az_idxs: Sequence[int], el_idxs: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint (y, z) element positions for two crossed lambda/2 ULAs.

    The reference never states element coordinates — only that ``az_idxs``
    forms a half-wavelength ULA along azimuth and ``el_idxs`` one along
    elevation (the FFT AoA treats each subset as uniform phase progression).
    Those two constraints pin a unique *relative* geometry when the subsets
    share an element: the azimuth row sits at that element's elevation
    coordinate and the elevation column at its azimuth coordinate — an
    L-shaped array.  For the ODS sets ``(0,3,4,7)`` / ``(9,8,5,4)`` the shared
    element 4 anchors the row at ``z=3`` and the column at ``y=2``.

    Returns:
        ``(antenna_idxs, positions)`` — unique element indices (az subset
        first, then unshared el elements) and ``(A, 2)`` positions in
        half-wavelength units ``(y, z)``.
    """
    az = list(az_idxs)
    el = list(el_idxs)
    shared = [e for e in el if e in az]
    y_col = float(az.index(shared[0])) if shared else 0.0
    z_row = float(el.index(shared[0])) if shared else 0.0

    idxs, pos = [], []
    for i, a in enumerate(az):
        idxs.append(a)
        pos.append((float(i), z_row))
    for i, e in enumerate(el):
        if e in az:
            continue
        idxs.append(e)
        pos.append((y_col, float(i)))
    return np.asarray(idxs, int), np.asarray(pos, np.float32)


class _CovarianceBeamformerProcessor(Processor):
    """Shared machinery: snapshots, steering, grids, view payload attrs."""

    #: subclasses set the spectrum estimator
    _method = "bartlett"

    def __init__(
        self,
        config: RadarConfig,
        antenna_idxs: Optional[Sequence[int]] = None,
        num_angle_bins: int = 64,
        diagonal_loading: float = 1e-2,
        **kwargs,
    ):
        super().__init__(config)
        if antenna_idxs is None:
            antenna_idxs = range(config.num_virtual_antennas
                                 if config.virtual_antennas_enabled
                                 else config.num_rx_antennas)
        self.antenna_idxs = np.asarray(list(antenna_idxs), int)
        self.num_angle_bins = num_angle_bins
        self.diagonal_loading = diagonal_loading

        ns = config.num_adc_samples
        self.range_bins = grids.range_bins(config, variant="eps")
        self.phase_shifts = grids.phase_shift_bins(num_angle_bins)
        self.angle_bins = grids.angle_bins(num_angle_bins)
        # same cartesian mesh payload as RangeAngleProcessor so the
        # range-angle view renders these maps unchanged
        self.thetas, self.rhos, self.x_s, self.y_s = grids.polar_mesh(
            self.range_bins, self.angle_bins
        )
        self._rng_factors = mxu.dft_factors(ns, window=windows.hanning(ns))
        self._steering = bf.steering_ula(self.phase_shifts,
                                         len(self.antenna_idxs))

    # ------------------------------------------------------------------ #
    def snapshots(self, cube: mxu.C2) -> mxu.C2:
        """``[rx, ns, nc]`` split cube -> per-range-bin snapshots ``[ns, A, K]``.

        Windowed range DFT along samples (one matmul), antenna subset
        select, then axes reordered so range bins batch the covariance.
        """
        sel = mxu.C2(cube.re[self.antenna_idxs], cube.im[self.antenna_idxs])
        rng = mxu.dft_apply(sel, self._rng_factors, axis=-2)  # [A, ns, K]
        return mxu.C2(jnp.moveaxis(rng.re, 0, 1), jnp.moveaxis(rng.im, 0, 1))

    def heatmap(self, cube: mxu.C2) -> jax.Array:
        """``[range_bins, angle_bins]`` float32 power map (device array)."""
        snaps = self.snapshots(cube)
        if self._method == "bartlett":
            return bf.bartlett_from_snapshots(snaps, self._steering)
        r = bf.spatial_covariance(snaps)
        return bf.capon_from_covariance(
            r, self._steering, loading=self.diagonal_loading
        )

    def azimuth_elevation_heatmap(
        self,
        adc_cube,
        range_idx: int,
        az_idxs: Sequence[int] = ODS_AZ_IDXS,
        el_idxs: Sequence[int] = ODS_EL_IDXS,
        num_az_bins: int = 64,
        num_el_bins: int = 32,
        antenna_idxs: Optional[Sequence[int]] = None,
        positions: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Joint (azimuth, elevation) spectrum at one range gate.

        The azimuth-elevation heatmap named in the build target.  Geometry:
        pass explicit ``antenna_idxs`` + ``positions`` (``(A, 2)`` in
        half-wavelength ``(y, z)`` units, e.g. from
        ``data.simulator.ArrayGeometry.virtual_offsets``) for a full-aperture
        planar beamform; otherwise the crossed-ULA (L-array) geometry is
        reconstructed from the az/el subsets via :func:`l_array_positions`
        (the only geometry derivable from the reference's hardcoded index
        sets).  Angle grids are the reference ``arcsin``-convention bins.

        Returns:
            ``(num_az_bins, num_el_bins)`` numpy power map.
        """
        cube = self._as_c2(adc_cube)
        if positions is not None:
            if antenna_idxs is None:
                antenna_idxs = range(cube.re.shape[0])
            idxs = np.asarray(list(antenna_idxs), int)
            pos = np.asarray(positions, np.float32)
        else:
            idxs, pos = l_array_positions(az_idxs, el_idxs)
        az_grid = grids.angle_bins(num_az_bins)
        el_grid = grids.angle_bins(num_el_bins)
        steering = bf.steering_planar(pos, az_grid, el_grid)

        sel = mxu.C2(cube.re[idxs], cube.im[idxs])
        rng = mxu.dft_apply(sel, self._rng_factors, axis=-2)
        snaps = mxu.C2(rng.re[:, range_idx, :], rng.im[:, range_idx, :])
        if self._method == "bartlett":
            power = bf.bartlett_from_snapshots(snaps, steering)
        else:
            r = bf.spatial_covariance(snaps)
            power = bf.capon_from_covariance(
                r, steering, loading=self.diagonal_loading
            )
        return np.asarray(power).reshape(num_az_bins, num_el_bins)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _as_c2(adc_cube) -> mxu.C2:
        if isinstance(adc_cube, mxu.C2):
            return adc_cube
        return mxu.from_complex(adc_cube)

    def process(self, adc_cube, **kwargs) -> jax.Array:
        """Reference-style API: complex (or C2) cube -> power heatmap."""
        return self.heatmap(self._as_c2(adc_cube))


class BartlettBeamformerProcessor(_CovarianceBeamformerProcessor):
    """Conventional (Bartlett) beamformer range-azimuth heatmap."""

    _method = "bartlett"


class CaponBeamformerProcessor(_CovarianceBeamformerProcessor):
    """Capon/MVDR super-resolution range-azimuth heatmap."""

    _method = "capon"
