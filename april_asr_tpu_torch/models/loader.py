"""Model loading: `.april` file -> device-resident weights and the batched
model functions the engine calls (port of april_asr_tpu/models/loader.py,
the LSTM family).

Native containers (model type 64, `MODEL_NATIVE_TRANSDUCER_TPU`) carry one
safetensors blob of the LSTM transducer's f32 weights plus dims metadata.
ONNX-form containers (type 1, the reference's own format: encoder, decoder
and joiner graphs) load as the JAX loader loads them (april_model.c:24-107):

  1. parse the three graphs (io/onnx_model.py) and lower them to the
     vmapped batch-1 interpreter (ops/onnx2torch.py),
  2. try native weight extraction (models/extract.py) and VERIFY it on the
     runtime's device: the native one-step encoder (kernel 12 on CUDA),
     decoder and joiner against the interpreter on JAX's random inputs,
  3. serve the native runtime (`kind="native"`, the port's kernels) where it
     agrees, else the interpreter (`kind="interp"`); `prefer_native=False`
     skips 2.

Each runtime's `load_seconds` splits its load into read, parse, extract,
upload and verify.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import FbankOptions
from ..device import exact_float_math, resolve_device
from ..io.container import (
    MODEL_LSTM_TRANSDUCER_STATELESS,
    MODEL_NATIVE_TRANSDUCER_TPU,
    AprilContainer,
    read_container,
)
from ..io.onnx_model import parse_model
from ..io.params import ModelParameters, VocabTables, build_vocab_tables
from ..io.safetensors import load_safetensors_bytes
from ..ops.onnx2torch import lower_graph
from .extract import ExtractionError, extract_transducer
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

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ModelRuntime:
    """Batched model functions plus metadata, with the blank id and dims
    bound as in the JAX package's loader.

    encoder_step(w, x[S, seg, mel], h[L, S, dh], c[L, S, dc]) -> (eout[S, J], h', c')   (ungated)
    decoder_step(w, context[S, ctx]) -> dout[S, J]
    joiner(w, eout[S, J], dout[S, J]) -> logits[S, V]

    The native LSTM family (`kind="native"`) also has:
    encoder_embed(w, x[N, seg, mel]) -> [N, d]
    encoder_embed_front(w, front[S, W, mel], P, step) -> [P, S, d] | None
        (every pull window from the front buffer; None: stack the windows)
    encoder_chunk(w, y[P, S, d], h[L, S, d], c[L, S, H], can[P, S]) -> (eout[P, S, J], h', c')
    encoder_recurrent(w, y[S, d], h, c, gate[S] | None) -> (eout[S, J], h', c')
    joiner_argmax(w, eout, dout) -> (max_idx[S], max_val[S], blank_val[S])
    decoder_joiner_argmax(w, context, need_dec[S], dout, eout)
        -> (max_idx, max_val, blank_val, dout'[S, J])
    The interpreter (`kind="interp"`, weights {"enc", "dec", "joi"} of
    initializers) has none of them: the engine steps it pull by pull and
    decodes from its logits.
    """

    name: str
    description: str
    language: str
    params: ModelParameters
    fbank_opts: FbankOptions
    vocab: VocabTables
    dims: TransducerDims
    kind: str  # "native" | "interp"
    weights: Dict
    device: torch.device
    encoder_step: Callable
    decoder_step: Callable
    joiner: Callable
    state_shapes: tuple  # ((L, dh), (L, dc)) per-session h/c trailing shapes
    encoder_embed: Optional[Callable] = None
    encoder_embed_front: Optional[Callable] = None
    encoder_chunk: Optional[Callable] = None
    encoder_recurrent: Optional[Callable] = None
    joiner_argmax: Optional[Callable] = None
    decoder_joiner_argmax: Optional[Callable] = None
    # seconds of the load by stage: read, parse, extract, upload, verify
    load_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # an ONNX-form load's verification: {output: max abs native - interp}
    verify_max_diff: Dict[str, float] = dataclasses.field(default_factory=dict)

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
        encoder_step=encoder_step,
        decoder_step=lambda w, ctx: decoder_step(w, ctx, dims),
        joiner=joiner_logits,
        state_shapes=((dims.layers, dims.d_model), (dims.layers, dims.hidden)),
        encoder_embed=encoder_embed,
        encoder_embed_front=encoder_embed_front,
        encoder_chunk=encoder_chunk,
        encoder_recurrent=encoder_recurrent,
        joiner_argmax=lambda w, e, d: joiner_argmax(w, e, d, blank),
        decoder_joiner_argmax=lambda w, ctx, nd, dout, e: decoder_joiner_argmax(
            w, ctx, nd, dout, e, blank, dims
        ),
    )


def _interp_runtime_fns(enc_graph, dec_graph, joi_graph):
    """Vmapped batch-1 interpreter functions with engine-facing layouts (JAX
    loader.py:127-158, `torch.func.vmap` in place of `jax.vmap`, the same
    in/out axes). Returns (weights, encoder, decoder, joiner); the weights
    are CPU tensors."""
    vmap = torch.func.vmap
    enc_fn, enc_w = lower_graph(enc_graph)
    dec_fn, dec_w = lower_graph(dec_graph)
    joi_fn, joi_w = lower_graph(joi_graph)
    weights = {"enc": enc_w, "dec": dec_w, "joi": joi_w}

    def enc_one(w, x1, h1, c1):
        # x1 [seg, mel]; h1 [L, dh]; c1 [L, dc]
        e, h2, c2 = enc_fn(w, x1[None], h1[:, None], c1[:, None])
        return e[0, 0], h2[:, 0], c2[:, 0]

    def encoder(w, x, h, c):
        return vmap(enc_one, in_dims=(None, 0, 1, 1), out_dims=(0, 1, 1))(w["enc"], x, h, c)

    def dec_one(w, ctx1):
        # ONNX indices are int64 (the JAX loader casts to int32: same values)
        (d,) = dec_fn(w, ctx1[None].long())
        return d[0, 0]

    def decoder(w, ctx):
        return vmap(dec_one, in_dims=(None, 0))(w["dec"], ctx)

    def joi_one(w, e1, d1):
        (logits,) = joi_fn(w, e1[None, None], d1[None, None])
        return logits.reshape(-1)

    def joiner(w, eout, dout):
        return vmap(joi_one, in_dims=(None, 0, 0))(w["joi"], eout, dout)

    return weights, encoder, decoder, joiner


def _verify_native(dims, native_w, interp_fns, seed=0, atol=2e-4) -> tuple:
    """Compare native vs interpreter on random inputs (JAX loader.py:203-234:
    the same inputs, S = 2, and tolerance), both on the weights' device.
    Returns (None if they agree else a description of the first mismatch,
    {output: max abs difference} of every output compared)."""
    interp_w, ienc, idec, ijoi = interp_fns
    dev = native_w["join_t"].device
    rng = np.random.default_rng(seed)
    S = 2
    x = rng.normal(size=(S, dims.segment_size, dims.mel)).astype(np.float32)
    h = (rng.normal(size=(dims.layers, S, dims.d_model)) * 0.1).astype(np.float32)
    c = (rng.normal(size=(dims.layers, S, dims.hidden)) * 0.1).astype(np.float32)
    ctx = rng.integers(0, dims.vocab, size=(S, dims.context)).astype(np.int32)
    x, h, c, ctx = (torch.from_numpy(a).to(dev) for a in (x, h, c, ctx))

    diffs = {}

    def close(name, a, b) -> bool:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        diffs[name] = float(np.max(np.abs(a - b)))
        return bool(np.allclose(a, b, atol=atol, rtol=1e-3))

    with torch.no_grad():
        ne, nh, nc = encoder_step(native_w, x, h, c)
        ie, ih, ic = ienc(interp_w, x, h, c)
        for name, a, b in (("encoder_out", ne, ie), ("h", nh, ih), ("c", nc, ic)):
            if not close(name, a, b):
                return f"{name} mismatch (max diff {diffs[name]:.3e})", diffs
        nd = decoder_step(native_w, ctx, dims)
        idv = idec(interp_w, ctx)
        if not close("decoder_out", nd, idv):
            return "decoder_out mismatch", diffs
        nl = joiner_logits(native_w, ne, nd)
        il = ijoi(interp_w, ie, idv)
        if not close("logits", nl, il):
            return "logits mismatch", diffs
    return None, diffs


def load_model(path: str | os.PathLike, prefer_native: bool = True, device=None) -> ModelRuntime:
    """Load a .april model onto `device` (CUDA unless the caller passes
    device="cpu"): the aam_create_model equivalent. `prefer_native=False`
    serves an ONNX-form model through the interpreter without trying the
    extraction; a native-form model ignores it, as in the JAX loader."""
    dev = resolve_device(device)
    exact_float_math()
    t0 = time.perf_counter()
    container = read_container(path)
    read_s = time.perf_counter() - t0
    if container.model_type == MODEL_NATIVE_TRANSDUCER_TPU:
        rt = _load_native_container(container, dev)
    elif container.model_type != MODEL_LSTM_TRANSDUCER_STATELESS or container.network_count != 3:
        # reference: april_model.c:36-40
        raise ValueError(
            f"model has unknown type {container.model_type} or wrong network "
            f"count {container.network_count}"
        )
    else:
        rt = _load_onnx_container(container, prefer_native, dev)
    rt.load_seconds = {"read": read_s, **rt.load_seconds}
    return rt


def _load_onnx_container(container: AprilContainer, prefer_native: bool, dev) -> ModelRuntime:
    """The ONNX branch of the JAX loader (loader.py:237-368)."""
    p = container.params
    secs = {}
    t = time.perf_counter()
    enc_graph = parse_model(container.networks[0]).graph
    dec_graph = parse_model(container.networks[1]).graph
    joi_graph = parse_model(container.networks[2]).graph

    # Shape cross-checks, reference april_model.c:74-102.
    x_shape = enc_graph.input_shapes.get("x") or enc_graph.input_shapes.get(enc_graph.inputs[0])
    if x_shape is not None:
        if x_shape[0] != p.batch_size or x_shape[1] != p.segment_size or x_shape[2] != p.mel_features:
            raise ValueError(f"encoder x shape {x_shape} inconsistent with params")
    h_shape = enc_graph.input_shapes.get("h") or enc_graph.input_shapes.get(enc_graph.inputs[1])
    c_shape = enc_graph.input_shapes.get("c") or enc_graph.input_shapes.get(enc_graph.inputs[2])

    interp_w, enc, dec, joi = _interp_runtime_fns(enc_graph, dec_graph, joi_graph)
    secs["parse"] = time.perf_counter() - t
    t = time.perf_counter()
    interp_w = {g: {k: v.to(dev) for k, v in ws.items()} for g, ws in interp_w.items()}
    secs["upload"] = time.perf_counter() - t

    kind = "interp"
    dims = None
    weights: Dict = interp_w
    diffs: Dict[str, float] = {}
    if prefer_native:
        try:
            t = time.perf_counter()
            dims, native_np = extract_transducer(
                enc_graph, dec_graph, joi_graph,
                segment_size=p.segment_size, segment_step=p.segment_step, mel=p.mel_features,
            )
            secs["extract"] = time.perf_counter() - t
            t = time.perf_counter()
            native_w = precompute_decoder_tables(
                {k: torch.from_numpy(np.array(v)).to(dev) for k, v in native_np.items()}, dims)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs["upload"] += time.perf_counter() - t
            t = time.perf_counter()
            mismatch, diffs = _verify_native(dims, native_w, (interp_w, enc, dec, joi))
            secs["verify"] = time.perf_counter() - t
            if mismatch is None:
                kind = "native"
                weights = native_w
                log.info("model %s: native extraction verified", container.name)
            else:
                log.warning(
                    "model %s: native extraction failed verification (%s); using interpreter path",
                    container.name, mismatch,
                )
                dims = None
        except ExtractionError as e:
            log.info(
                "model %s: graphs don't match native architecture (%s); using interpreter path",
                container.name, e,
            )

    if kind == "native":
        if p.token_count != dims.vocab:
            raise ValueError(f"params token count {p.token_count} != model vocab {dims.vocab}")
        rt = native_runtime(container.name, container.description, container.language, p,
                            dims, weights, dev)
        rt.load_seconds, rt.verify_max_diff = secs, diffs
        return rt

    # Interpreter path: dims for state allocation from graph input shapes.
    if h_shape is None or c_shape is None:
        raise ValueError("encoder graph lacks h/c input shapes")
    logits_shape = joi_graph.output_shapes.get(joi_graph.outputs[0])
    vocab = p.token_count
    if logits_shape is not None and logits_shape[-1] != vocab:
        # reference: april_model.c:102
        raise ValueError(f"joiner logits dim {logits_shape[-1]} != token count {vocab}")
    dims = TransducerDims(
        mel=p.mel_features,
        segment_size=p.segment_size,
        segment_step=p.segment_step,
        d_model=h_shape[2],
        hidden=c_shape[2],
        joiner_dim=0,
        vocab=vocab,
        layers=h_shape[0],
        context=p.token_count and (dec_graph.input_shapes.get(dec_graph.inputs[0], [1, 2])[1]),
    )
    return ModelRuntime(
        name=container.name,
        description=container.description,
        language=container.language,
        params=p,
        fbank_opts=_fbank_opts_from_params(p),
        vocab=build_vocab_tables(p),
        dims=dims,
        kind="interp",
        weights=weights,
        device=dev,
        encoder_step=enc,
        decoder_step=dec,
        joiner=joi,
        state_shapes=((dims.layers, dims.d_model), (dims.layers, dims.hidden)),
        load_seconds=secs,
        verify_max_diff=diffs,
    )


def _load_native_container(container: AprilContainer, dev) -> ModelRuntime:
    """Native checkpoint form: a single safetensors network blob. The `arch`
    metadata selects the model family; only "lstm" is ported."""
    t = time.perf_counter()
    tensors, meta = load_safetensors_bytes(container.networks[0])
    arch = meta.get("arch", "lstm")
    if arch != "lstm":
        raise NotImplementedError(f"the {arch} family is not ported yet")
    dims_kw = {k: (tuple(v) if k == "conv_channels" else v) for k, v in meta["dims"].items()}
    dims = TransducerDims(**dims_kw)
    p = container.params
    if p.token_count != dims.vocab:
        raise ValueError(f"params token count {p.token_count} != model vocab {dims.vocab}")
    parse_s = time.perf_counter() - t
    t = time.perf_counter()
    weights = {k: torch.from_numpy(v.copy()).to(dev) for k, v in tensors.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rt = native_runtime(
        container.name, container.description, container.language, p, dims, weights, dev
    )
    rt.load_seconds = {"parse": parse_s, "upload": time.perf_counter() - t}
    return rt
