"""stvd — spatial-temporal attention video captioning in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``tuyunbin/Video-Description-with-Spatial-Temporal-Attention``
(ACM MM 2017).  See SURVEY.md for the reference's structure and
PERF.md for targets and measurements.
"""

from .config import Config, DataConfig, DecodeConfig, ModelConfig, TrainConfig, preset, validate

__version__ = "0.1.0"
__all__ = [
    "Config", "ModelConfig", "TrainConfig", "DecodeConfig", "DataConfig",
    "preset", "validate",
]
