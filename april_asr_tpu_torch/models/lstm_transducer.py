"""Native batched LSTM-transducer forward (port of
april_asr_tpu/models/lstm_transducer.py): the conv embed, the chunk and
one-step encoders, the stateless decoder and the joiner.

The step's conv embed runs kernel 16 from the front buffer at bf16 conv
weights (`encoder_embed_front`); the stacked-window `encoder_embed` serves
f32 weights and the one-step encoder.

Parameters are a flat dict of tensors with the JAX package's key names and
layouts (pre-transposed matrices, stacked [L, ...] layer leaves). The chunk
encoder (the engine's step) is layer-major. With int8 copies of the layer
matrices (`quantize_weights`) each layer is kernel 2 (recurrent core) then
kernel 3 (residual + FFN + BasicNorm); with f32 or bf16 weights each layer
is one call of kernel 10 (`lstm_layer_chunk_fused`), at every P, where the
JAX package takes its XLA path below P = 12 (`CHUNK_MIN_PULLS`): the same
function with f32 sums in another order.

The one-step encoder (`encoder_step`/`encoder_recurrent`, the engine's
per-pull path and so every flush) runs one kernel per layer, kernel 7
(`lstm_layer_fused_i8`) with int8 copies, else kernel 12
(`lstm_layer_fused`), as the JAX package does at 128-multiple widths. The
per-pull decode runs `decoder_joiner_argmax`: kernel 8 where the JAX gate
`dj_supported` passes, else the decoder step and kernel 9. Its
tensor-parallel form (`_lstm_stack_step_tp`, `encoder_recurrent_tp`,
`encoder_step_tp`) runs one process's model shard: kernels 18 and 20
(float) or 19 and 21 (int8) per layer, with the partial sums all-reduced
over the model group (parallel/mesh.py).

The int8 helpers `_q8_rows`/`_q8_mm` live beside the kernels' plain
versions (ops/lstm_kernels.py `_rowq8`, `_q8_mm`). Products the JAX package
leaves to XLA stay plain PyTorch here: `dot_wd` rounds the activation to the
weight dtype and accumulates in f32, so a bf16 weight sees a bf16-rounded
operand and an f32 sum, exactly as
`jnp.dot(x.astype(w.dtype), w, preferred_element_type=f32)` computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.activations import dot_wd, double_swish
from ..ops.conv_embed_kernels import EMBED_KEYS, conv_embed_windows, front_embed_supported
from ..ops.decode_kernels import dj_supported
from ..ops.joiner_kernels import (
    decoder_joiner_argmax_fused,
    joiner_argmax_fused,
    joiner_logits_plain,
)
from ..ops.lstm_float_kernels import lstm_layer_chunk_fused, lstm_layer_fused
from ..ops.lstm_kernels import (
    LAYER_I8_KEYS,
    ffn_norm_i8,
    lstm_layer_chunk_rec_stream2_i8,
    lstm_layer_fused_i8,
)
from ..ops.lstm_tp_kernels import (
    ffn_mid_i8,
    ffn_partial,
    lstm_gate_cell_proj,
    lstm_gates_cell_i8,
    rowq8_global,
)


@dataclasses.dataclass(frozen=True)
class TransducerDims:
    mel: int = 80
    segment_size: int = 9
    segment_step: int = 4
    d_model: int = 512
    hidden: int = 1024
    ffn: int = 2048
    joiner_dim: int = 512
    vocab: int = 500
    layers: int = 12
    context: int = 2
    decoder_groups: int = 128
    conv_channels: Tuple[int, int, int] = (8, 32, 32)

    @property
    def conv_freq_out(self) -> int:
        return ((self.mel - 1) // 2 - 1) // 2

    @property
    def subsampled_t(self) -> int:
        t = self.segment_size
        t = (t - 3) // 2 + 1
        t = (t - 3) // 2 + 1
        return t


Params = Dict[str, torch.Tensor]

DERIVED_KEYS = frozenset({"dec_table"})
QUANT_TARGETS = ("w_ih_t", "w_hh_t", "w_hr_t", "ff1_t", "ff2_t")


def is_derived(key: str) -> bool:
    """True for inference-only derived params (decoder tables, int8 copies
    and scales) that are never exported or dtype-cast."""
    return key in DERIVED_KEYS or key.endswith("_q8") or key.endswith("_q8s")


def init_transducer_params(seed: int, dims: TransducerDims, device="cpu") -> Params:
    """Random f32 init with the JAX package's shapes and scales, drawn from a
    numpy generator (the values differ from `jax.random`'s)."""
    rng = np.random.default_rng(seed)
    d, H, F, J, V, L = dims.d_model, dims.hidden, dims.ffn, dims.joiner_dim, dims.vocab, dims.layers
    c1, c2, c3 = dims.conv_channels

    def w(shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    p = {
        "conv1_w": w((c1, 1, 3, 3), 0.3), "conv1_b": z(c1),
        "conv2_w": w((c2, c1, 3, 3), 0.1), "conv2_b": z(c2),
        "conv3_w": w((c3, c2, 3, 3), 0.1), "conv3_b": z(c3),
        "embed_out_w": w((c3 * dims.conv_freq_out, d)), "embed_out_b": z(d),
        "w_ih_t": w((L, d, 4 * H), 0.05), "w_hh_t": w((L, d, 4 * H), 0.05),
        "bias": z(L, 4 * H), "w_hr_t": w((L, H, d), 0.05),
        "ff1_t": w((L, d, F)), "ff1_b": z(L, F),
        "ff2_t": w((L, F, d)), "ff2_b": z(L, d),
        "norm_eps": np.full((L,), 0.25, np.float32),
        "enc_proj_t": w((d, J)), "enc_proj_b": z(J),
        "dec_embed": w((V, d), 0.5),
        "dec_conv_w": w((d, d // dims.decoder_groups, dims.context), 0.3),
        "dec_proj_t": w((d, J)), "dec_proj_b": z(J),
        "join_t": w((J, V)), "join_b": z(V),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in p.items()}


def cast_weights(params: Params, dtype) -> Params:
    """Cast matrix/embedding weights (ndim >= 2, f32, not derived) to
    `dtype`; biases, norm eps and derived tables stay f32."""
    return {
        k: v.to(dtype) if v.ndim >= 2 and not is_derived(k) and v.dtype == torch.float32 else v
        for k, v in params.items()
    }


def quantize_weights(params: Params) -> Params:
    """Add per-output-channel symmetric int8 copies `<name>_q8` (int8) and
    `<name>_q8s` (f32 [L, 1, out]) of the encoder layer matrices, calibrated
    on the stored originals (call before cast_weights)."""
    out = dict(params)
    for name in QUANT_TARGETS:
        if name not in params or name + "_q8" in params:
            continue
        w = params[name].float()
        amax = w.abs().amax(dim=-2, keepdim=True)
        s = torch.clamp_min(amax, 1e-12) * (1.0 / 127.0)
        out[name + "_q8"] = torch.round(w / s).to(torch.int8)
        out[name + "_q8s"] = s
    return out


def is_quantized(params: Params) -> bool:
    return "w_ih_t_q8" in params


def conv_subsample(params: Params, x: torch.Tensor) -> torch.Tensor:
    """[S, T, mel] -> [S, T', d_model] via the 3-conv stack (NCHW / OIHW)."""
    h = x[:, None, :, :]

    def conv(h, wname, bname, stride, pad):
        w = params[wname]
        y = torch.nn.functional.conv2d(
            h.to(w.dtype).float(), w.float(), stride=stride, padding=pad
        )
        return double_swish(y + params[bname].float()[None, :, None, None])

    h = conv(h, "conv1_w", "conv1_b", 1, 1)
    h = conv(h, "conv2_w", "conv2_b", 2, 0)
    h = conv(h, "conv3_w", "conv3_b", 2, 0)
    s, ch, t, f = h.shape
    h = h.permute(0, 2, 1, 3).reshape(s, t, ch * f)
    return dot_wd(h, params["embed_out_w"]) + params["embed_out_b"].float()


def encoder_embed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Stateless front half of the encoder: [N, segment, mel] -> [N, d_model]."""
    return conv_subsample(params, x)[:, 0, :]


def encoder_embed_front(params: Params, front: torch.Tensor, P: int, step: int):
    """Every pull window's embedding straight from the front buffer,
    [S, W, mel] -> [P, S, d_model], by kernel 16 (`conv_embed_windows`), or
    None where the engine stacks the windows for `encoder_embed` instead.

    Two rules, on shapes and dtypes only. The geometry must pass the JAX
    package's `front_embed_supported` (any S: the kernel takes ragged
    session tiles). The conv and projection weights must be bf16 (int8 and
    bf16 serving), where the kernel's bf16 rounding points are those of the
    stacked embed; at f32 weights it returns None, since the kernel rounds
    every activation to bf16 where the f32 embed does not (2e-2 apart, the
    bound of the JAX package's own kernel test) and the f32 engine keeps its
    exact parity with the JAX package. The JAX package holds the kernel
    behind APRIL_CONV_EMBED_KERNEL only because its TPU compiler hangs on it
    (lstm_transducer.py:721-727); the port reads no such variable."""
    S, W, mel = front.shape
    seg = W - (P - 1) * step
    if any(params[k].dtype != torch.bfloat16 for k in EMBED_KEYS):
        return None
    if not front_embed_supported(seg, mel, P, step, W, S, block_s=1):
        return None
    return conv_embed_windows(params, front, P=P, step=step, seg=seg)


def _n_pulls(gate):
    """A [P, S] prefix mask as per-session live-step counts [S] int32."""
    return None if gate is None else gate.to(torch.int32).sum(dim=0, dtype=torch.int32)


def _lstm_stack_chunk(params: Params, y, h, c, gate=None):
    """Layer-major whole-chunk float stack (f32 or bf16 weights): one call
    of kernel 10 per layer. `gate` [P, S] must be a per-session prefix mask;
    masked steps keep the carried h/c and give garbage y rows that the
    decode masks off."""
    n_pulls = _n_pulls(gate)
    hs, cs = [], []
    for l in range(params["w_ih_t"].shape[0]):
        y, h_new, c_new = lstm_layer_chunk_fused(
            y, h[l], c[l],
            params["w_ih_t"][l], params["w_hh_t"][l], params["bias"][l], params["w_hr_t"][l],
            params["ff1_t"][l], params["ff1_b"][l], params["ff2_t"][l], params["ff2_b"][l],
            params["norm_eps"][l],
            n_pulls,
        )
        hs.append(h_new)
        cs.append(c_new)
    return y, torch.stack(hs), torch.stack(cs)


def _lstm_stack_chunk_q8(params: Params, y, h, c, gate=None):
    """Layer-major whole-chunk int8 stack: for every layer, kernel 2 over all
    P steps, then kernel 3 over the P*S rows. `gate` as `_lstm_stack_chunk`."""
    P, S, d = y.shape
    L = params["w_ih_t_q8"].shape[0]
    n_pulls = _n_pulls(gate)
    hs, cs = [], []
    for l in range(L):
        hseq, h_new, c_new = lstm_layer_chunk_rec_stream2_i8(
            y, h[l], c[l],
            params["w_ih_t_q8"][l], params["w_ih_t_q8s"][l],
            params["w_hh_t_q8"][l], params["w_hh_t_q8s"][l],
            params["bias"][l],
            params["w_hr_t_q8"][l], params["w_hr_t_q8s"][l],
            n_pulls,
        )
        y = ffn_norm_i8(
            y.reshape(P * S, d), hseq.reshape(P * S, d),
            params["ff1_t_q8"][l], params["ff1_t_q8s"][l], params["ff1_b"][l],
            params["ff2_t_q8"][l], params["ff2_t_q8s"][l], params["ff2_b"][l],
            params["norm_eps"][l],
        ).reshape(P, S, d)
        hs.append(h_new)
        cs.append(c_new)
    return y, torch.stack(hs), torch.stack(cs)


def encoder_chunk(params: Params, y, h, c, can=None):
    """Whole-chunk streaming encoder: y [P, S, d] embedded pulls, can
    optional [P, S] prefix mask -> (eout [P, S, J], h', c')."""
    stack = _lstm_stack_chunk_q8 if is_quantized(params) else _lstm_stack_chunk
    y, h_new, c_new = stack(params, y.contiguous(), h, c, can)
    eout = dot_wd(y, params["enc_proj_t"]) + params["enc_proj_b"].float()
    return eout, h_new, c_new


STEP_I8_KEYS = LAYER_I8_KEYS
STEP_KEYS = ("w_ih_t", "w_hh_t", "bias", "w_hr_t", "ff1_t", "ff1_b", "ff2_t", "ff2_b",
              "norm_eps")


def _lstm_stack_step(params: Params, x, h, c, gate=None):
    """One timestep through all L layers: x [S, d], h [L, S, d], c [L, S, H]
    -> (y [S, d], h', c'), one cooperative launch of kernel 7 (int8 copies,
    csrc/lstm_mma.cu) or kernel 12 (f32 or bf16 weights,
    csrc/lstm_mma_float.cu) per layer. `gate` (optional [S]) keeps the carried h/c of masked
    sessions, blended as the kernels do."""
    q = is_quantized(params)
    layer = lstm_layer_fused_i8 if q else lstm_layer_fused
    keys = STEP_I8_KEYS if q else STEP_KEYS
    hs, cs = [], []
    for l in range(h.shape[0]):
        x, h_new, c_new = layer(x, h[l], c[l], *(params[k][l] for k in keys), gate)
        hs.append(h_new)
        cs.append(c_new)
    return x, torch.stack(hs), torch.stack(cs)


def encoder_recurrent(params: Params, y, h, c, gate=None):
    """Recurrent back half: embedded [S, d] -> (eout [S, J], h', c');
    `gate` (optional [S]) keeps the carried h/c of masked sessions (their
    eout is still computed; the decode masks it)."""
    y, h_new, c_new = _lstm_stack_step(params, y.contiguous(), h, c, gate)
    eout = dot_wd(y, params["enc_proj_t"]) + params["enc_proj_b"].float()
    return eout, h_new, c_new


def encoder_step(params: Params, x, h, c):
    """One streaming encoder step, ungated: a [S, segment, mel] window ->
    (eout [S, J], h', c')."""
    return encoder_recurrent(params, encoder_embed(params, x), h, c)


def tp_q8_contract(v, wq8, ws, mesh):
    """int8 contraction over a LOCAL (model-sharded) activation axis, exact
    against the single-device path: v quantized with the model-global row
    scale (`rowq8_global`: the int8 values of the full-row quantization),
    the exact int32 product per shard (float64 holds every partial sum),
    the INT32 partials all-reduced (integer addition is associative, so the
    sum is the single-device accumulator), then one f32 dequantization.
    Dequantizing before the all-reduce would leave f32 partial sums ulps
    from the single-device ones, which the next step's re-quantization can
    amplify to a full int8 step (JAX lstm_transducer.py:803-820)."""
    vq, s = rowq8_global(v, mesh)
    acc = (vq.double() @ wq8.double()).to(torch.int32)
    return mesh.all_reduce(acc, "sum").float() * (s * ws)


def _basic_norm(x, eps):
    """x * rsqrt(mean(x^2) + eps) (icefall BasicNorm inference form), the
    sum of squares taken in the order of the kernels' BasicNorm
    (csrc/ffn_norm.cuh `basic_norm_rows`): lane j of 32 adds x_k^2 for
    k = j, j + 32, ... in turn, a butterfly adds the 32 lanes, then the sum
    is divided by d. So the TP layer's norm is kernel 7's bit for bit, and
    the TP int8 layer decodes as the single-device one: int8 re-quantization
    turns an ulp of the norm into whole int8 steps that 12 layers amplify
    (chip_smoke's `tp` phase)."""
    S, d = x.shape
    sq = torch.nn.functional.pad(x * x, (0, -d % 32)).reshape(S, -1, 32)
    ss = sq[:, 0]
    for j in range(1, sq.shape[1]):
        ss = ss + sq[:, j]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, lane ^ o]
    mean = ss[:, :1] / torch.tensor(float(d), device=x.device)
    return x * torch.rsqrt(mean + eps.float())


def _lstm_stack_step_tp(params: Params, x, h, c, mesh, gate=None):
    """Tensor-parallel `_lstm_stack_step`: one timestep through all L layers
    on this process's model shard (parallel/mesh.py `TPMesh`).

    Layout (parallel/tp.py gate-shuffled slices): x and h are replicated
    [S, d] / [L, S, d]; c is the local [L, S, H/m] hidden slice; w_ih_t,
    w_hh_t and bias are the local gate-shuffled [., d, 4H/m] slices (a
    standard smaller LSTMP layer per shard); w_hr_t [., H/m, d] and ff1/ff2
    carry the local hidden/ffn slices. Two all-reduces per layer cross the
    model group: the recurrent projection partial (before the residual and
    the FFN) and the FFN partial (before the second bias and the BasicNorm).
    Float weights: kernel 18, all_reduce(hp), y = x + h_new, kernel 20,
    all_reduce. int8 copies: kernel 19, then `tp_q8_contract` of hc through
    w_hr, y = x + h_new, kernel 21, `tp_q8_contract` of mid through ff2.
    h_new is gated by select after y is formed from the ungated h_new; the
    kernels blend c. Numerics match the single-device path up to f32
    reduction order (float); at int8 every product is exact and the norm
    sums in the kernels' order, so on the card each layer equals kernel 7's
    bit for bit."""
    q = is_quantized(params)
    hs, cs = [], []
    for l in range(h.shape[0]):
        h_l, c_l = h[l], c[l]
        if q:
            hc, c_new = lstm_gates_cell_i8(
                x, h_l, c_l, params["w_ih_t_q8"][l], params["w_ih_t_q8s"][l],
                params["w_hh_t_q8"][l], params["w_hh_t_q8s"][l], params["bias"][l], gate)
            h_new = tp_q8_contract(hc, params["w_hr_t_q8"][l], params["w_hr_t_q8s"][l], mesh)
            y = x + h_new
            mid = ffn_mid_i8(y, params["ff1_t_q8"][l], params["ff1_t_q8s"][l], params["ff1_b"][l])
            ff_sum = tp_q8_contract(mid, params["ff2_t_q8"][l], params["ff2_t_q8s"][l], mesh)
        else:
            hp, c_new = lstm_gate_cell_proj(
                x, h_l, c_l, params["w_ih_t"][l], params["w_hh_t"][l], params["bias"][l],
                params["w_hr_t"][l], gate)
            h_new = mesh.all_reduce(hp, "sum")
            y = x + h_new
            ff_sum = mesh.all_reduce(
                ffn_partial(y, params["ff1_t"][l], params["ff1_b"][l], params["ff2_t"][l]), "sum")
        x = _basic_norm(y + (ff_sum + params["ff2_b"][l].float()), params["norm_eps"][l])
        if gate is not None:
            h_new = torch.where(gate[:, None], h_new, h_l)
        hs.append(h_new)
        cs.append(c_new)
    return x, torch.stack(hs), torch.stack(cs)


def encoder_recurrent_tp(params: Params, y, h, c, mesh, gate=None):
    """Tensor-parallel `encoder_recurrent`: the LSTM stack on this shard with
    the all-reduces; the small enc->joiner projection is replicated."""
    y, h_new, c_new = _lstm_stack_step_tp(params, y.contiguous(), h, c, mesh, gate)
    eout = dot_wd(y, params["enc_proj_t"]) + params["enc_proj_b"].float()
    return eout, h_new, c_new


def encoder_step_tp(params: Params, x, h, c, mesh):
    """Tensor-parallel `encoder_step`, ungated: a [S, segment, mel] window
    -> (eout [S, J], h', c' (this shard's))."""
    return encoder_recurrent_tp(params, encoder_embed(params, x), h, c, mesh)


def precompute_decoder_tables(params: Params, dims: TransducerDims) -> Params:
    """Add the derived `dec_table` [ctx, V, d]: the grouped context conv is
    linear per position, so its pre-ReLU output is a sum of per-position
    token table rows."""
    if "dec_table" in params:
        return params
    V, d = params["dec_embed"].shape
    groups = dims.decoder_groups
    gin = gout = d // groups
    emb = params["dec_embed"].float().reshape(V, groups, gin)
    w = params["dec_conv_w"].float().reshape(groups, gout, gin, dims.context)
    table = torch.einsum("vgi,goik->kvgo", emb, w).reshape(dims.context, V, d)
    out = dict(params)
    out["dec_table"] = table.contiguous()
    return out


def decoder_step(params: Params, context: torch.Tensor, dims: TransducerDims) -> torch.Tensor:
    """Stateless decoder from the precomputed tables: [S, ctx] -> [S, J]."""
    ctx = context.long()
    pre = params["dec_table"][0][ctx[:, 0]]
    for k in range(1, dims.context):
        pre = pre + params["dec_table"][k][ctx[:, k]]
    y = torch.relu(pre)
    return dot_wd(y, params["dec_proj_t"]) + params["dec_proj_b"].float()



def joiner_logits(params: Params, eout: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """[S, J] + [S, J] -> [S, vocab] logits (the tanh joiner)."""
    return joiner_logits_plain(eout, dout, params["join_t"], params["join_b"])


def joiner_argmax(params: Params, eout: torch.Tensor, dout: torch.Tensor, blank_id: int):
    """(max_idx, max_val, blank_val) of the joiner without the [S, vocab]
    logits: kernel 9 on CUDA, at any vocabulary size."""
    return joiner_argmax_fused(eout, dout, params["join_t"], params["join_b"], blank_id=blank_id)


def decoder_joiner_argmax(params: Params, ctx, need_dec, dout, eout, blank_id: int,
                          dims: TransducerDims):
    """One round of the lazy-dout decode: refresh dout where `need_dec`,
    then the joiner and argmax. Kernel 8 where the JAX gate passes, else the
    decoder step, the `need_dec` select and kernel 9, as the JAX package
    does. Returns (max_idx, max_val, blank_val, dout')."""
    S, J = eout.shape
    w_t = params["join_t"]
    if dj_supported(S, J, params["dec_table"].shape[2], dims.context,
                    vocab=w_t.shape[1], w_itemsize=w_t.element_size()):
        return decoder_joiner_argmax_fused(
            ctx, need_dec, dout, eout, params["dec_table"], params["dec_proj_t"],
            params["dec_proj_b"], w_t, params["join_b"], blank_id=blank_id,
        )
    new_dout = decoder_step(params, ctx, dims)
    dout = torch.where(need_dec[:, None], new_dout, dout)
    mi, mv, bv = joiner_argmax(params, eout, dout, blank_id)
    return mi, mv, bv, dout
