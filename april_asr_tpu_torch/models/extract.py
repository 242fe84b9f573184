"""Extract native transducer weights from the ONNX graphs in a .april file
(the port's copy of april_asr_tpu/models/extract.py, which imports no JAX:
the same pattern matchers, so the port extracts exactly the graphs the JAX
package extracts, with the same param names and arrays).

The reference hands these graphs to ONNXRuntime (src/april_model.c:57-59);
here they are pattern-matched into the native batched model
(models/lstm_transducer.py) so the hot path runs as fused, stacked-layer scans
instead of a literal op-by-op graph replay. Extraction is *verified*: the
loader compares native outputs against the generic ONNX interpreter on random
inputs and falls back to the (vmapped) interpreter when the graph
doesn't match the known architecture — so any valid .april file still runs.

Two encoder graph forms are recognized:
  * unrolled form — traced projection-LSTM cells as MatMul/Sigmoid/Tanh ops
    (what torch.onnx produces for this architecture; torch cannot export
    nn.LSTM with proj_size as an LSTM op)
  * LSTM-op form — ONNX LSTM nodes (what this framework's own exporter emits)

Gate order convention: native layout is i f g o (torch); the ONNX LSTM op's
iofc order is permuted during extraction.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..io.onnx_model import OnnxGraph
from .lstm_transducer import TransducerDims


class ExtractionError(ValueError):
    pass


def _init_lookup(graph: OnnxGraph) -> Dict[str, np.ndarray]:
    """Initializers plus Identity aliases of initializers (torch's exporter
    deduplicates equal-valued parameters by routing them through Identity
    nodes)."""
    lookup = dict(graph.initializers)
    for node in graph.nodes:
        if node.op_type == "Identity" and node.inputs and node.outputs:
            src = lookup.get(node.inputs[0])
            if src is not None:
                lookup[node.outputs[0]] = src
    return lookup


def _matmul_weights(graph: OnnxGraph) -> List[Tuple[str, np.ndarray]]:
    """(weight name, array) for every MatMul/Gemm whose rhs is an initializer,
    in topological order. Gemm weights are normalized to right-multiplication
    layout [in, out]."""
    inits = _init_lookup(graph)
    out = []
    for node in graph.nodes:
        if node.op_type == "MatMul" and len(node.inputs) == 2:
            w = inits.get(node.inputs[1])
            if w is not None and w.ndim == 2:
                out.append((node.inputs[1], w))
        elif node.op_type == "Gemm":
            w = inits.get(node.inputs[1])
            if w is not None and w.ndim == 2:
                if node.attrs.get("transB", 0):
                    w = w.T
                out.append((node.inputs[1], w))
    return out


def _bias_adds(graph: OnnxGraph) -> List[np.ndarray]:
    """1-D initializer operands of Add nodes, topo order (Linear biases and
    the LSTM gate bias)."""
    inits = _init_lookup(graph)
    out = []
    for node in graph.nodes:
        if node.op_type != "Add":
            continue
        for name in node.inputs:
            arr = inits.get(name)
            if arr is not None and arr.ndim == 1:
                out.append(arr)
    return out


def _scalar_adds(graph: OnnxGraph) -> List[float]:
    """Scalar initializer operands of Add nodes (BasicNorm eps values)."""
    inits = _init_lookup(graph)
    out = []
    for node in graph.nodes:
        if node.op_type != "Add":
            continue
        for name in node.inputs:
            arr = inits.get(name)
            if arr is not None and arr.ndim == 0:
                out.append(float(arr))
    return out


def _convs(graph: OnnxGraph) -> List[Tuple[np.ndarray, np.ndarray | None, dict]]:
    inits = _init_lookup(graph)
    out = []
    for node in graph.nodes:
        if node.op_type == "Conv":
            w = inits.get(node.inputs[1])
            b = inits.get(node.inputs[2]) if len(node.inputs) > 2 else None
            if w is None:
                raise ExtractionError("Conv weight is not an initializer")
            out.append((w, b, node.attrs))
    return out


def extract_encoder(graph: OnnxGraph) -> Tuple[dict, dict]:
    """Returns (partial params, inferred dims fields)."""
    if any(n.op_type == "LSTM" for n in graph.nodes):
        return _extract_encoder_lstm_op(graph)
    return _extract_encoder_unrolled(graph)


def _extract_encoder_unrolled(graph: OnnxGraph) -> Tuple[dict, dict]:
    convs = _convs(graph)
    if len(convs) != 3:
        raise ExtractionError(f"expected 3 subsampling convs, got {len(convs)}")
    (c1w, c1b, a1), (c2w, c2b, a2), (c3w, c3b, a3) = convs
    if list(a1.get("strides", [1, 1])) != [1, 1] or list(a1.get("pads", [0] * 4)) != [1, 1, 1, 1]:
        raise ExtractionError("conv1 attrs mismatch")
    if list(a2.get("strides", [])) != [2, 2] or list(a3.get("strides", [])) != [2, 2]:
        raise ExtractionError("conv2/3 stride mismatch")

    mms = _matmul_weights(graph)
    if len(mms) < 7 or (len(mms) - 2) % 5 != 0:
        raise ExtractionError(f"unexpected matmul count {len(mms)}")
    L = (len(mms) - 2) // 5
    embed_w = mms[0][1]
    enc_proj = mms[-1][1]
    d = embed_w.shape[1]

    w_ih, w_hh, w_hr, ff1, ff2 = [], [], [], [], []
    for layer in range(L):
        grp = [mms[1 + layer * 5 + j][1] for j in range(5)]
        a, b, r, f1, f2 = grp
        if a.shape[0] != d or a.shape != b.shape:
            raise ExtractionError(f"layer {layer}: gate weight shapes {a.shape} {b.shape}")
        H4 = a.shape[1]
        if H4 % 4:
            raise ExtractionError("gate dim not divisible by 4")
        if r.shape != (H4 // 4, d):
            raise ExtractionError(f"layer {layer}: proj shape {r.shape}")
        if f1.shape[0] != d or f2.shape[1] != d or f1.shape[1] != f2.shape[0]:
            raise ExtractionError(f"layer {layer}: ffn shapes {f1.shape} {f2.shape}")
        w_ih.append(a)
        w_hh.append(b)
        w_hr.append(r)
        ff1.append(f1)
        ff2.append(f2)

    biases = _bias_adds(graph)
    # topo order: embed_out_b, then per layer [gate bias, ff1_b, ff2_b], enc_proj_b
    if len(biases) != 2 + 3 * L:
        raise ExtractionError(f"unexpected bias count {len(biases)}")
    embed_b = biases[0]
    gate_b = [biases[1 + i * 3] for i in range(L)]
    ff1_b = [biases[2 + i * 3] for i in range(L)]
    ff2_b = [biases[3 + i * 3] for i in range(L)]
    proj_b = biases[-1]

    eps = _scalar_adds(graph)
    if len(eps) != L:
        raise ExtractionError(f"expected {L} norm eps scalars, got {len(eps)}")

    hidden = w_ih[0].shape[1] // 4
    params = {
        "conv1_w": c1w, "conv1_b": c1b,
        "conv2_w": c2w, "conv2_b": c2b,
        "conv3_w": c3w, "conv3_b": c3b,
        "embed_out_w": embed_w, "embed_out_b": embed_b,
        "w_ih_t": np.stack(w_ih),
        "w_hh_t": np.stack(w_hh),
        "bias": np.stack(gate_b),
        "w_hr_t": np.stack(w_hr),
        "ff1_t": np.stack(ff1),
        "ff1_b": np.stack(ff1_b),
        "ff2_t": np.stack(ff2),
        "ff2_b": np.stack(ff2_b),
        "norm_eps": np.array(eps, np.float32),
        "enc_proj_t": enc_proj, "enc_proj_b": proj_b,
    }
    dims = {
        "d_model": d,
        "hidden": hidden,
        "ffn": ff1[0].shape[1],
        "layers": L,
        "joiner_dim": enc_proj.shape[1],
        "conv_channels": (c1w.shape[0], c2w.shape[0], c3w.shape[0]),
    }
    return params, dims


def _extract_encoder_lstm_op(graph: OnnxGraph) -> Tuple[dict, dict]:
    """Encoder built from ONNX LSTM nodes (this framework's exporter form).

    The LSTM op packs W/R as [1, 4H, in] in iofc order; native layout is
    pre-transposed [in, 4H] in ifgo order.
    """
    convs = _convs(graph)
    if len(convs) != 3:
        raise ExtractionError(f"expected 3 subsampling convs, got {len(convs)}")
    (c1w, c1b, _), (c2w, c2b, _), (c3w, c3b, _) = convs

    def iofc_to_ifgo(w4h: np.ndarray) -> np.ndarray:
        h = w4h.shape[0] // 4
        i, o, f, g = (w4h[k * h : (k + 1) * h] for k in range(4))
        return np.concatenate([i, f, g, o], axis=0)

    lstm_nodes = [n for n in graph.nodes if n.op_type == "LSTM"]
    L = len(lstm_nodes)
    w_ih, w_hh, gate_b = [], [], []
    for n in lstm_nodes:
        W = graph.initializers[n.inputs[1]][0]  # [4H, d]
        R = graph.initializers[n.inputs[2]][0]  # [4H, H->d proj? no: H]
        B = graph.initializers[n.inputs[3]][0] if len(n.inputs) > 3 and n.inputs[3] else None
        H4 = W.shape[0]
        w_ih.append(iofc_to_ifgo(W).T)
        w_hh.append(iofc_to_ifgo(R).T)
        if B is not None:
            bb = B[:H4] + B[H4:]
            gate_b.append(iofc_to_ifgo(bb[:, None])[:, 0])
        else:
            gate_b.append(np.zeros(H4, np.float32))

    mms = _matmul_weights(graph)
    # embed_out, then per layer [w_hr, ff1, ff2], then enc_proj
    if len(mms) != 2 + 3 * L:
        raise ExtractionError(f"unexpected matmul count {len(mms)} for {L} LSTM layers")
    embed_w = mms[0][1]
    enc_proj = mms[-1][1]
    w_hr = [mms[1 + i * 3][1] for i in range(L)]
    ff1 = [mms[2 + i * 3][1] for i in range(L)]
    ff2 = [mms[3 + i * 3][1] for i in range(L)]

    biases = _bias_adds(graph)
    if len(biases) != 2 + 2 * L:
        raise ExtractionError(f"unexpected bias count {len(biases)}")
    embed_b = biases[0]
    ff1_b = [biases[1 + i * 2] for i in range(L)]
    ff2_b = [biases[2 + i * 2] for i in range(L)]
    proj_b = biases[-1]

    eps = _scalar_adds(graph)
    if len(eps) != L:
        raise ExtractionError(f"expected {L} norm eps scalars, got {len(eps)}")

    d = embed_w.shape[1]
    params = {
        "conv1_w": c1w, "conv1_b": c1b,
        "conv2_w": c2w, "conv2_b": c2b,
        "conv3_w": c3w, "conv3_b": c3b,
        "embed_out_w": embed_w, "embed_out_b": embed_b,
        "w_ih_t": np.stack(w_ih),
        "w_hh_t": np.stack(w_hh),
        "bias": np.stack(gate_b),
        "w_hr_t": np.stack(w_hr),
        "ff1_t": np.stack(ff1),
        "ff1_b": np.stack(ff1_b),
        "ff2_t": np.stack(ff2),
        "ff2_b": np.stack(ff2_b),
        "norm_eps": np.array(eps, np.float32),
        "enc_proj_t": enc_proj, "enc_proj_b": proj_b,
    }
    dims = {
        "d_model": d,
        "hidden": w_ih[0].shape[1] // 4,
        "ffn": ff1[0].shape[1],
        "layers": L,
        "joiner_dim": enc_proj.shape[1],
        "conv_channels": (c1w.shape[0], c2w.shape[0], c3w.shape[0]),
    }
    return params, dims


def extract_decoder(graph: OnnxGraph) -> Tuple[dict, dict]:
    inits = _init_lookup(graph)
    embed = None
    for node in graph.nodes:
        if node.op_type == "Gather":
            arr = inits.get(node.inputs[0])
            if arr is not None and arr.ndim == 2:
                embed = arr
                break
    if embed is None:
        raise ExtractionError("decoder embedding not found")

    convs = _convs(graph)
    if len(convs) != 1:
        raise ExtractionError(f"expected 1 decoder conv, got {len(convs)}")
    conv_w, conv_b, attrs = convs[0]
    if conv_b is not None and np.any(conv_b):
        raise ExtractionError("decoder conv bias unsupported")
    groups = int(attrs.get("group", 1))

    mms = _matmul_weights(graph)
    if len(mms) != 1:
        raise ExtractionError(f"expected 1 decoder matmul, got {len(mms)}")
    proj = mms[0][1]
    biases = _bias_adds(graph)
    if len(biases) != 1:
        raise ExtractionError(f"expected 1 decoder bias, got {len(biases)}")

    if not any(n.op_type == "Relu" for n in graph.nodes):
        raise ExtractionError("decoder relu not found")

    params = {
        "dec_embed": embed,
        "dec_conv_w": conv_w,
        "dec_proj_t": proj,
        "dec_proj_b": biases[0],
    }
    dims = {
        "vocab": embed.shape[0],
        "context": conv_w.shape[2],
        "decoder_groups": groups,
    }
    return params, dims


def extract_joiner(graph: OnnxGraph) -> Tuple[dict, dict]:
    if not any(n.op_type == "Tanh" for n in graph.nodes):
        raise ExtractionError("joiner tanh not found")
    mms = _matmul_weights(graph)
    if len(mms) != 1:
        raise ExtractionError(f"expected 1 joiner matmul, got {len(mms)}")
    biases = _bias_adds(graph)
    if len(biases) != 1:
        raise ExtractionError(f"expected 1 joiner bias, got {len(biases)}")
    return (
        {"join_t": mms[0][1], "join_b": biases[0]},
        {"vocab": mms[0][1].shape[1], "joiner_dim": mms[0][1].shape[0]},
    )


def extract_transducer(
    enc_graph: OnnxGraph,
    dec_graph: OnnxGraph,
    joi_graph: OnnxGraph,
    segment_size: int,
    segment_step: int,
    mel: int,
) -> Tuple[TransducerDims, Dict[str, np.ndarray]]:
    """Full extraction; raises ExtractionError if any graph doesn't match."""
    enc_p, enc_d = extract_encoder(enc_graph)
    dec_p, dec_d = extract_decoder(dec_graph)
    joi_p, joi_d = extract_joiner(joi_graph)

    if dec_d["vocab"] != joi_d["vocab"]:
        raise ExtractionError("decoder/joiner vocab mismatch")
    if enc_d["joiner_dim"] != joi_d["joiner_dim"]:
        raise ExtractionError("encoder/joiner dim mismatch")

    dims = TransducerDims(
        mel=mel,
        segment_size=segment_size,
        segment_step=segment_step,
        d_model=enc_d["d_model"],
        hidden=enc_d["hidden"],
        ffn=enc_d["ffn"],
        joiner_dim=enc_d["joiner_dim"],
        vocab=dec_d["vocab"],
        layers=enc_d["layers"],
        context=dec_d["context"],
        decoder_groups=dec_d["decoder_groups"],
        conv_channels=enc_d["conv_channels"],
    )
    params = {**enc_p, **dec_p, **joi_p}
    params = {
        k: np.asarray(v, np.float32) if v is not None else None
        for k, v in params.items()
    }
    # Fill missing conv biases with zeros.
    for cname, ch in (("conv1_b", dims.conv_channels[0]),
                      ("conv2_b", dims.conv_channels[1]),
                      ("conv3_b", dims.conv_channels[2])):
        if params.get(cname) is None:
            params[cname] = np.zeros(ch, np.float32)
    return dims, params
