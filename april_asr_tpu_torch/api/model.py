"""Model API mirroring the reference Python binding's Model class
(port of april_asr_tpu/api/model.py; reference
bindings/python/april_asr/_april.py:59-96, april_api.h:58-74)."""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from ..config import DecodeConfig, EngineConfig
from ..models.lstm_transducer import cast_weights, quantize_weights
from ..models.loader import ModelRuntime, load_model

log = logging.getLogger(__name__)


def apply_precision(weights, precision: Optional[str]):
    """The serving precision policy: "f32" (or None/"": the weights as
    loaded), "bf16" (matrix weights cast to bf16, f32 accumulation), or
    "int8" (per-channel int8 copies of the encoder layer matrices, quantized
    from the f32 originals, then the matrices cast to bf16). As in the JAX
    package, the interpreter's weights ({"enc", "dec", "joi"} of
    initializers) serve only as loaded: "bf16" and "int8" raise
    AttributeError there, "int8" after its warning that no matrix
    quantizes."""
    if precision in (None, "", "f32", "float32"):
        return weights
    if precision in ("bf16", "bfloat16"):
        return cast_weights(weights, torch.bfloat16)
    if precision == "int8":
        w = quantize_weights(weights)  # quantizes from the f32 originals
        if not any(k.endswith("_q8") for k in w):
            log.warning("precision=int8: no quantizable encoder matrices found for this "
                        "model family; serving with bf16 numerics")
        return cast_weights(w, torch.bfloat16)
    raise ValueError(f"unknown precision {precision!r} (f32 | bf16 | int8)")


class Model:
    """A loaded `.april` speech-to-text model on one device. Sessions
    created from the same Model share its weights and engine programs."""

    def __init__(
        self,
        path: str | os.PathLike,
        prefer_native: bool = True,
        precision: Optional[str] = None,
        device=None,
    ):
        """The JAX Model's arguments, in its order, then `device`.
        `prefer_native` is passed to `load_model` (a native-form model
        ignores it). `precision` selects the serving numerics: "f32", "bf16"
        or "int8" (see `apply_precision`); it defaults to the APRIL_PRECISION
        environment variable, else the weights as loaded (f32). `device`
        defaults to CUDA; pass "cpu" to run the kernels' plain PyTorch
        versions."""
        self._rt: ModelRuntime = load_model(path, prefer_native, device=device)
        precision = precision or os.environ.get("APRIL_PRECISION")
        self._rt.weights = apply_precision(self._rt.weights, precision)
        self._engines: Dict[Tuple[int, int], object] = {}
        self._lock = threading.Lock()

    def get_name(self) -> str:
        return self._rt.name

    def get_description(self) -> str:
        return self._rt.description

    def get_language(self) -> str:
        return self._rt.language

    def get_sample_rate(self) -> int:
        return self._rt.sample_rate

    @property
    def runtime(self) -> ModelRuntime:
        return self._rt

    def _get_program(self, batch: int, cfg: Optional[EngineConfig] = None,
                     dcfg: Optional[DecodeConfig] = None):
        """Cached engine program shared across sessions of the same shape."""
        from ..engine.step import build_engine

        cfg = cfg or EngineConfig()
        dcfg = dcfg or DecodeConfig()
        key = (batch, cfg.chunk_samples)
        with self._lock:
            prog = self._engines.get(key)
            if prog is None:
                prog = build_engine(self._rt, batch, cfg, dcfg)
                self._engines[key] = prog
            return prog
