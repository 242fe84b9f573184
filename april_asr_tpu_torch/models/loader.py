"""Model loading: `.april` file -> device-resident weights and the batched
model functions the engine calls (port of april_asr_tpu/models/loader.py,
native form only).

Native containers (model type 64, `MODEL_NATIVE_TRANSDUCER_TPU`) carry one
safetensors blob of the LSTM transducer's f32 weights plus dims metadata.
ONNX-form containers (type 1) need the ONNX importer and interpreter, which
belong to a later slice of the port and raise NotImplementedError here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict

import torch

from ..config import FbankOptions
from ..device import exact_float_math, resolve_device
from ..io.container import (
    MODEL_LSTM_TRANSDUCER_STATELESS,
    MODEL_NATIVE_TRANSDUCER_TPU,
    read_container,
)
from ..io.params import ModelParameters, VocabTables, build_vocab_tables
from ..io.safetensors import load_safetensors_bytes
from .lstm_transducer import (
    TransducerDims,
    decoder_joiner_argmax,
    decoder_step,
    encoder_chunk,
    encoder_embed,
    encoder_embed_front,
    encoder_recurrent,
    encoder_step,
    joiner_argmax,
    joiner_logits,
    precompute_decoder_tables,
)

ONNX_SLICE_MSG = (
    "ONNX-form .april models need the ONNX importer/interpreter "
    "(io/onnx_model.py, ops/onnx2jax.py), which a later slice of the port "
    "brings; load a native-form model"
)


@dataclasses.dataclass
class ModelRuntime:
    """Batched model functions plus metadata (the native LSTM family), with
    the blank id and dims bound as in the JAX package's loader.

    encoder_embed(w, x[N, seg, mel]) -> [N, d]
    encoder_embed_front(w, front[S, W, mel], P, step) -> [P, S, d] | None
        (every pull window from the front buffer; None: stack the windows)
    encoder_chunk(w, y[P, S, d], h[L, S, d], c[L, S, H], can[P, S]) -> (eout[P, S, J], h', c')
    encoder_recurrent(w, y[S, d], h, c, gate[S] | None) -> (eout[S, J], h', c')
    encoder_step(w, x[S, seg, mel], h, c) -> (eout[S, J], h', c')   (ungated)
    decoder_step(w, context[S, ctx]) -> dout[S, J]
    joiner(w, eout[S, J], dout[S, J]) -> logits[S, V]
    joiner_argmax(w, eout, dout) -> (max_idx[S], max_val[S], blank_val[S])
    decoder_joiner_argmax(w, context, need_dec[S], dout, eout)
        -> (max_idx, max_val, blank_val, dout'[S, J])
    """

    name: str
    description: str
    language: str
    params: ModelParameters
    fbank_opts: FbankOptions
    vocab: VocabTables
    dims: TransducerDims
    kind: str
    weights: Dict[str, torch.Tensor]
    device: torch.device
    encoder_embed: Callable
    encoder_embed_front: Callable
    encoder_chunk: Callable
    encoder_recurrent: Callable
    encoder_step: Callable
    decoder_step: Callable
    joiner: Callable
    joiner_argmax: Callable
    decoder_joiner_argmax: Callable
    state_shapes: tuple

    @property
    def sample_rate(self) -> int:
        return self.fbank_opts.sample_freq

    @property
    def blank_id(self) -> int:
        return self.params.blank_id


def _fbank_opts_from_params(p: ModelParameters) -> FbankOptions:
    """Reference april_model.c:84-97 (snip_edges/remove_dc/preemph forced)."""
    return FbankOptions(
        sample_freq=p.sample_rate,
        frame_shift_ms=p.frame_shift_ms,
        frame_length_ms=p.frame_length_ms,
        num_bins=p.mel_features,
        round_pow2=p.round_pow2,
        mel_low=p.mel_low,
        mel_high=p.mel_high,
        snip_edges=True,
        pull_segment_count=p.segment_size,
        pull_segment_step=p.segment_step,
        remove_dc_offset=True,
        preemph_coeff=0.97,
    )


def native_runtime(
    name: str, description: str, language: str, p: ModelParameters,
    dims: TransducerDims, weights: Dict[str, torch.Tensor], device,
) -> ModelRuntime:
    """A runtime over native f32 weights already on `device`."""
    weights = precompute_decoder_tables(weights, dims)
    blank = p.blank_id
    return ModelRuntime(
        name=name,
        description=description,
        language=language,
        params=p,
        fbank_opts=_fbank_opts_from_params(p),
        vocab=build_vocab_tables(p),
        dims=dims,
        kind="native",
        weights=weights,
        device=torch.device(device),
        encoder_embed=encoder_embed,
        encoder_embed_front=encoder_embed_front,
        encoder_chunk=encoder_chunk,
        encoder_recurrent=encoder_recurrent,
        encoder_step=encoder_step,
        decoder_step=lambda w, ctx: decoder_step(w, ctx, dims),
        joiner=joiner_logits,
        joiner_argmax=lambda w, e, d: joiner_argmax(w, e, d, blank),
        decoder_joiner_argmax=lambda w, ctx, nd, dout, e: decoder_joiner_argmax(
            w, ctx, nd, dout, e, blank, dims
        ),
        state_shapes=((dims.layers, dims.d_model), (dims.layers, dims.hidden)),
    )


def load_model(path: str | os.PathLike, prefer_native: bool = True, device=None) -> ModelRuntime:
    """Load a native-form .april model onto `device` (CUDA unless the
    caller passes device="cpu"). `prefer_native` is the JAX signature's:
    the native form ignores it, as the JAX loader's native branch does, and
    an ONNX-form container raises whatever its value."""
    dev = resolve_device(device)
    exact_float_math()
    container = read_container(path)
    if container.model_type == MODEL_LSTM_TRANSDUCER_STATELESS:
        raise NotImplementedError(ONNX_SLICE_MSG)
    if container.model_type != MODEL_NATIVE_TRANSDUCER_TPU:
        raise ValueError(f"model has unknown type {container.model_type}")
    tensors, meta = load_safetensors_bytes(container.networks[0])
    arch = meta.get("arch", "lstm")
    if arch != "lstm":
        raise NotImplementedError(f"the {arch} family is not ported yet")
    dims_kw = {k: (tuple(v) if k == "conv_channels" else v) for k, v in meta["dims"].items()}
    dims = TransducerDims(**dims_kw)
    p = container.params
    if p.token_count != dims.vocab:
        raise ValueError(f"params token count {p.token_count} != model vocab {dims.vocab}")
    weights = {k: torch.from_numpy(v.copy()).to(dev) for k, v in tensors.items()}
    return native_runtime(
        container.name, container.description, container.language, p, dims, weights, dev
    )
