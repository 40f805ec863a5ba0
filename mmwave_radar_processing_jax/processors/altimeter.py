"""Altimeter: tracked height-above-ground from the range profile.

Re-design of the reference ``Altimeter`` (``processors/altimeter.py``):
the frame-to-frame tracked altitude becomes an explicit scalar state threaded
through a pure :func:`step`, so recordings process under one ``lax.scan`` and
the tracking gate (`abs(peak - current) <= search_limit`) stays on-device.
The zoom-FFT refinement around the tracked peak uses the traced-band chirp-z
transform, so the moving window never retriggers compilation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mmwave_radar_processing_jax.config import RadarConfig
from mmwave_radar_processing_jax.ops import peaks as peaks_ops
from mmwave_radar_processing_jax.processors.range_resp import RangeProcessor, coarse_range_fft


class AltimeterState(NamedTuple):
    altitude_measured_m: jax.Array  # () float32, radar-measured altitude


class Altimeter(RangeProcessor):
    """Stateful ground-range tracker (coarse peaks + zoom refinement).

    Reference behavior matched (``altimeter.py:42-140``): among prominent
    coarse peaks, the *lowest* peak that is above ``min_altitude_m`` and within
    ``altitude_search_limit_m`` of the previous estimate is the ground; the
    optional precise pass re-estimates it with a zoom FFT in a
    ``±zoom_search_region_m`` window; ``range_bias`` is added to the output.
    """

    def __init__(
        self,
        config: RadarConfig,
        min_altitude_m: float,
        zoom_search_region_m: float,
        altitude_search_limit_m: float,
        range_bias: float = 0.0,
        **kwargs,
    ):
        super().__init__(config)
        self.min_altitude_m = float(min_altitude_m)
        self.zoom_search_region_m = float(zoom_search_region_m)
        self.altitude_search_limit_m = float(altitude_search_limit_m)
        self.range_bias = float(range_bias)
        self.state = self.init_state()
        self.coarse_fft_data = None

    def init_state(self) -> AltimeterState:
        return AltimeterState(jnp.asarray(self.min_altitude_m, jnp.float32))

    # ------------------------------------------------------------------ #
    def _find_ground_peak(self, peak_ranges, peak_valid, current):
        """Lowest valid peak within the tracking gate, else -1 (ref :42-63)."""
        ok = (
            peak_valid
            & (peak_ranges >= self.min_altitude_m)
            & (jnp.abs(peak_ranges - current) <= self.altitude_search_limit_m)
        )
        gp = jnp.min(jnp.where(ok, peak_ranges, jnp.inf))
        return jnp.where(jnp.isfinite(gp), gp, -1.0)

    def step(
        self,
        state: AltimeterState,
        adc_cube: jax.Array,
        precise_est_enabled: bool = True,
    ):
        """``(state, frame) -> (state, corrected_altitude_m)``."""
        current = state.altitude_measured_m
        coarse = coarse_range_fft(adc_cube[..., :, :, 0])
        coarse_db = 20.0 * jnp.log10(coarse + 1e-12)
        rng_bins = jnp.asarray(self.range_bins)
        idx, _, valid = peaks_ops.top_peaks_within_threshold(
            coarse_db, max_peaks=3, min_prominence=6.0, threshold_db=20.0
        )
        peak_ranges = jnp.where(valid, rng_bins[idx], 0.0)
        ground_peak = self._find_ground_peak(peak_ranges, valid, current)

        if not precise_est_enabled:
            measured = jnp.where(ground_peak >= 0, ground_peak, current)
        else:
            def refine(gp):
                lo = jnp.maximum(1e-6, gp - self.zoom_search_region_m)
                hi = jnp.minimum(float(np.max(self.range_bins)) - 1e-6,
                                 gp + self.zoom_search_region_m)
                zoom_mag, zoom_bins = self.zoom_fft(adc_cube, lo, hi, chirp_idx=0)
                zdb = 20.0 * jnp.log10(zoom_mag + 1e-12)
                zidx, _, zvalid = peaks_ops.top_peaks_within_threshold(
                    zdb, max_peaks=2, min_prominence=6.0, threshold_db=20.0
                )
                zranges = jnp.where(zvalid, zoom_bins[zidx], 0.0)
                refined = self._find_ground_peak(zranges, zvalid, current)
                return jnp.where(refined > 0, refined, current)

            measured = jax.lax.cond(
                ground_peak >= 0, refine, lambda _: current, ground_peak
            )

        new_state = AltimeterState(measured)
        corrected = measured + self.range_bias
        return new_state, corrected

    def scan(self, adc_frames: jax.Array, precise_est_enabled: bool = True):
        """Process ``[frames, rx, samples, chirps]`` with one ``lax.scan``."""
        def body(state, frame):
            return self.step(state, frame, precise_est_enabled)

        return jax.lax.scan(body, self.init_state(), adc_frames)

    # reference-compatible mutating API -------------------------------- #
    @property
    def current_altitude_measured_m(self) -> float:
        return float(self.state.altitude_measured_m)

    @property
    def current_altitude_corrected_m(self) -> float:
        return float(self.state.altitude_measured_m) + self.range_bias

    def process(self, adc_cube: jax.Array, precise_est_enabled: bool = True, **kwargs):
        self.coarse_fft_data = coarse_range_fft(adc_cube[..., :, :, 0])
        self.state, corrected = self.step(self.state, adc_cube, precise_est_enabled)
        return corrected

    def reset(self) -> None:
        self.state = self.init_state()
        super().reset()
