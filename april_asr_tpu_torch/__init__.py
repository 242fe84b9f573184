"""april_asr_tpu_torch: the PyTorch/CUDA port of april_asr_tpu.

A second package beside the JAX one, with the same module layout and names.
It imports torch and numpy only (never jax, ml_dtypes or april_asr_tpu).
The streaming engine's kernels are hand-written CUDA for sm_90a
(`csrc/`, built with nvcc on first use); on CPU tensors every kernel's plain
PyTorch version runs instead. Entry points run on CUDA unless the caller
passes device="cpu".
"""

from .config import DecodeConfig, EngineConfig, FbankOptions

__all__ = ["DecodeConfig", "EngineConfig", "FbankOptions", "Model", "Session", "Result", "Token"]


def __getattr__(name):
    if name in ("Model", "Session", "Result", "Token"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
