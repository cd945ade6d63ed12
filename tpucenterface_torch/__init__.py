"""tpucenterface_torch: the PyTorch/CUDA port of `tpucenterface`.

A second package beside the JAX one, with the same module layout and names;
each module's docstring names the JAX `file::function` it mirrors. It imports
torch and numpy, never jax, flax or `tpucenterface`. Hand-written CUDA
kernels live in `csrc/` and are built with nvcc at first use
(`kernels/build.py`).
"""

from tpucenterface_torch.config import (
    DecodeConfig,
    DetectorConfig,
    ModelConfig,
    PreprocessConfig,
    preset,
)
from tpucenterface_torch.detector import Detections, Detector

__all__ = [
    "Detector",
    "Detections",
    "DetectorConfig",
    "ModelConfig",
    "DecodeConfig",
    "PreprocessConfig",
    "preset",
]
