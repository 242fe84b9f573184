"""Model export to `.april` (port of april_asr_tpu/models/export.py, the
LSTM family), with two output forms:

  * ONNX form (model type 1): three opset-11 graphs built by io/onnx_build.py,
    the reference library's format; the same bytes as the JAX package's.
  * native form (model type 64): a single safetensors blob of the f32
    weights plus dims metadata, the fastest to load.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..io.container import (
    MODEL_LSTM_TRANSDUCER_STATELESS,
    MODEL_NATIVE_TRANSDUCER_TPU,
    AprilContainer,
    write_container,
)
from ..io.onnx_build import build_transducer_graphs
from ..io.params import ModelParameters
from ..io.safetensors import save_safetensors_bytes
from .lstm_transducer import TransducerDims, is_derived


def make_model_parameters(
    dims: TransducerDims, tokens: List[bytes], blank_id: int = 0, sample_rate: int = 16000
) -> ModelParameters:
    return ModelParameters(
        batch_size=1,
        segment_size=dims.segment_size,
        segment_step=dims.segment_step,
        mel_features=dims.mel,
        sample_rate=sample_rate,
        frame_shift_ms=10,
        frame_length_ms=25,
        round_pow2=True,
        mel_low=20,
        mel_high=0,
        snip_edges=False,
        blank_id=blank_id,
        tokens=tokens,
    )


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_april(
    path,
    dims: TransducerDims,
    params: Dict[str, object],
    model_params: ModelParameters,
    name: str = "Exported Model",
    description: str = "Exported by april_asr_tpu_torch",
    language: str = "en-us",
    form: str = "native",
) -> None:
    """Write a `.april` from a weights dict (tensors or arrays); derived
    entries (decoder tables, int8 copies) are not written.

    form="native": the port's default, type 64 (safetensors payload).
    form="onnx": reference-compatible, type 1 (3 ONNX networks)."""
    np_params = {k: _np(v) for k, v in params.items() if not is_derived(k)}
    if form == "onnx":
        networks = list(build_transducer_graphs(dims, np_params))
        model_type = MODEL_LSTM_TRANSDUCER_STATELESS
    elif form == "native":
        meta = {"dims": dataclasses.asdict(dims), "arch": "lstm"}
        networks = [save_safetensors_bytes(np_params, metadata=meta)]
        model_type = MODEL_NATIVE_TRANSDUCER_TPU
    else:
        raise ValueError(f"unknown export form {form!r}")
    container = AprilContainer(
        language=language,
        name=name,
        description=description,
        model_type=model_type,
        params=model_params,
        networks=networks,
    )
    write_container(path, container)
