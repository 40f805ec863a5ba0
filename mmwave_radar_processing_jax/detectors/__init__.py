"""CFAR detector objects + registry (CA/GO/SO/OS, 1D and 2D).

Object facades over the pure threshold-map kernels in
:mod:`mmwave_radar_processing_jax.ops.cfar`, mirroring the reference's
``detectors/`` package API (``detect`` + cached ``thresholds`` /
``detections`` / ``noise_estimates``, registry names from
``detector_registry.py:15-27``).
"""

from mmwave_radar_processing_jax.detectors.cfar_detectors import (
    BaseCFAR1D,
    BaseCFAR2D,
    CaCFAR1D,
    CaCFAR2D,
    GoCFAR1D,
    OsCFAR1D,
    OsCFAR2D,
    SoCFAR1D,
    get_detector_registry,
)

__all__ = [
    "BaseCFAR1D",
    "BaseCFAR2D",
    "CaCFAR1D",
    "CaCFAR2D",
    "GoCFAR1D",
    "SoCFAR1D",
    "OsCFAR1D",
    "OsCFAR2D",
    "get_detector_registry",
]
