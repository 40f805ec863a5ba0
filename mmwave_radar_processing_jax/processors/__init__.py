"""Signal-processing pipeline stages (accelerator-native re-design).

Each reference processor class (``mmwave_radar_processing/processors/``)
becomes here a thin config-bound object whose ``process`` methods are pure,
shape-static jitted functions over device arrays.  Stateless stages are plain
functions of the ADC cube; stateful stages (altimeter tracking, micro-Doppler
history, synthetic-aperture ring buffers) expose ``init_state()`` and a
functional ``step(state, ...) -> (state, out)`` suitable for ``lax.scan`` over
frame sequences.  Every stage also accepts a leading batch axis via ``vmap``
for throughput-mode processing of many frames at once.
"""

from mmwave_radar_processing_jax.processors.virtual_array import VirtualArrayReformatter
from mmwave_radar_processing_jax.processors.range_resp import RangeProcessor
from mmwave_radar_processing_jax.processors.range_doppler import RangeDopplerProcessor
from mmwave_radar_processing_jax.processors.range_angle import RangeAngleProcessor
from mmwave_radar_processing_jax.processors.doppler_azimuth import DopplerAzimuthProcessor
from mmwave_radar_processing_jax.processors.micro_doppler import MicroDopplerProcessor
from mmwave_radar_processing_jax.processors.altimeter import Altimeter
from mmwave_radar_processing_jax.processors.detection import (
    RangeDetector,
    RangeDopplerDetector2D,
    RangeDopplerDetectorSequential,
    RangeDopplerGroundDetector,
    get_range_doppler_detector_registry,
)
from mmwave_radar_processing_jax.processors.point_cloud import PointCloudGenerator
from mmwave_radar_processing_jax.processors.velocity_estimator import VelocityEstimator
from mmwave_radar_processing_jax.processors.dbs import RangeAngleProcessorDBSEnhanced
from mmwave_radar_processing_jax.processors.strip_map_sar import StripMapSARProcessor
from mmwave_radar_processing_jax.processors.synthetic_array import (
    SyntheticArrayBeamformerProcessor,
)
from mmwave_radar_processing_jax.processors.beamforming import (
    BartlettBeamformerProcessor,
    CaponBeamformerProcessor,
)

__all__ = [
    "VirtualArrayReformatter",
    "RangeProcessor",
    "RangeDopplerProcessor",
    "RangeAngleProcessor",
    "DopplerAzimuthProcessor",
    "MicroDopplerProcessor",
    "Altimeter",
    "RangeDetector",
    "RangeDopplerDetector2D",
    "RangeDopplerDetectorSequential",
    "RangeDopplerGroundDetector",
    "get_range_doppler_detector_registry",
    "PointCloudGenerator",
    "VelocityEstimator",
    "RangeAngleProcessorDBSEnhanced",
    "StripMapSARProcessor",
    "SyntheticArrayBeamformerProcessor",
    "BartlettBeamformerProcessor",
    "CaponBeamformerProcessor",
]
