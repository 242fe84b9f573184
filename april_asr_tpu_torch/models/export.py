"""Model export to `.april` (port of april_asr_tpu/models/export.py), native
form only: a single safetensors blob of the f32 weights plus dims metadata
(model type 64). The ONNX form waits for the ONNX slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..io.container import MODEL_NATIVE_TRANSDUCER_TPU, AprilContainer, write_container
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
    """Write a native-form `.april` from a weights dict (tensors or arrays);
    derived entries (decoder tables, int8 copies) are not written."""
    if form != "native":
        raise NotImplementedError(
            "only form='native' is ported; the ONNX form (io/onnx_build.py) "
            "waits for the ONNX slice"
        )
    np_params = {k: _np(v) for k, v in params.items() if not is_derived(k)}
    meta = {"dims": dataclasses.asdict(dims), "arch": "lstm"}
    container = AprilContainer(
        language=language,
        name=name,
        description=description,
        model_type=MODEL_NATIVE_TRANSDUCER_TPU,
        params=model_params,
        networks=[save_safetensors_bytes(np_params, metadata=meta)],
    )
    write_container(path, container)
