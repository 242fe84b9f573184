"""april_asr_tpu_torch: the PyTorch/CUDA port of april_asr_tpu.

A second package beside the JAX one, with the same module layout and names.
It imports torch and numpy only (never jax, ml_dtypes or april_asr_tpu).
The streaming engine's kernels are hand-written CUDA for sm_90a
(`csrc/`, built with nvcc on first use); on CPU tensors every kernel's plain
PyTorch version runs instead. Entry points run on CUDA unless the caller
passes device="cpu".

The public surface mirrors the reference Python binding: `Model`, `Session`,
`Token`, `Result`, plus `init()` in place of `aam_api_init` (reference:
src/init.c:33-51).
"""

from .config import DecodeConfig, EngineConfig, FbankOptions, MeshConfig
from .version import APRIL_VERSION, __version__

__all__ = ["APRIL_VERSION", "DecodeConfig", "EngineConfig", "FbankOptions", "MeshConfig", "Model",
           "Session", "Result", "Token", "__version__", "init"]


def init(version: int = APRIL_VERSION) -> None:
    """Optional explicit init, mirroring aam_api_init: validates the
    requested API version (there is no global backend handle to set up)."""
    if version != APRIL_VERSION:
        raise ValueError(f"unsupported API version {version}, expected {APRIL_VERSION}")


def __getattr__(name):
    if name in ("Model", "Session", "Result", "Token"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
