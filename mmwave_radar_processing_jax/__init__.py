"""mmwave_radar_processing_jax — a JAX (XLA/Pallas) mmWave radar processing framework for NVIDIA GPUs.

A from-scratch, accelerator-first re-design of the capabilities of the reference
``mmwave_radar_processing`` library (TI IWR1843/IWR6843 FMCW ADC-cube processing):

- ``config``   — TI mmWave-SDK ``.cfg`` parsing + derived radar performance params
                 (reference: ``config_managers/cfgManager.py``).
- ``ops``      — pure jittable kernels: windowed FFTs, chirp-z (zoom) FFT, CFAR
                 threshold maps, peak finding, batched RANSAC.
- ``processors`` — the signal-processing pipeline stages (range, range-Doppler,
                 range-angle, Doppler-azimuth, micro-Doppler, altimeter, point
                 clouds, ego-velocity, DBS, SAR, synthetic-aperture beamforming),
                 re-designed as pure shape-static functions over batched frame
                 tensors with explicit state pytrees.
- ``detectors`` — CFAR detector objects (CA/GO/SO/OS, 1D/2D) + registry.
- ``parallel`` — ``jax.sharding`` mesh pipelines: frame/channel sharding, CFAR
                 halo exchange, beamforming partial-sum collectives.
- ``data``     — CPSL-dataset-compatible loader + synthetic FMCW scene simulator.
- ``analysis`` — velocity-error statistics (Mean/Median/RMSE/90% tail).
- ``plotting`` / ``visualization`` — matplotlib dashboards, movie export, and a
                 backend-gated GUI registry/controller stack.

Design stance: everything on the device path is traced once under ``jit`` with
static shapes; dynamic detection counts become fixed-capacity masked tensors;
stateful stages carry explicit ``(state, frame) -> (state, out)`` pytrees.
"""

__version__ = "0.1.0"

from mmwave_radar_processing_jax.config import RadarConfig, load_cfg

__all__ = ["RadarConfig", "load_cfg", "__version__"]
