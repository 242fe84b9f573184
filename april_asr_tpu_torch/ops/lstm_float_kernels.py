"""Kernel 10: the float whole-layer chunk of the encoder, and kernel 12: one
float timestep of a whole layer (f32 or bf16 weights).

Port of `lstm_layer_chunk_fused` (april_asr_tpu/ops/lstm_pallas.py,
`_chunk_kernel`): one residual LSTMP layer over P steps,

    gates = dot(x_t, w_ih) + dot(h, w_hh) + b       (the TPU kernel's order:
    c' = sig(f) * c + sig(i) * tanh(g)               both sums, then the bias)
    h' = dot(sig(o) * tanh(c'), w_hr)
    y_t = BasicNorm(x_t + h' + ff2(DoubleSwish(ff1(x_t + h'))))

with the tanh-form sigmoid (ops/activations.py). Every dot rounds its
activation to the weight dtype and accumulates in f32
(`jnp.dot(x.astype(wd), w, preferred_element_type=f32)`): f32 weights give
true f32 products, bf16 weights bf16-rounded activations times bf16 weights.
`n_pulls` [S] is a prefix gate: step t is live for session s iff
t < n_pulls[s]; masked steps keep h/c and give finite garbage y rows that the
decode masks off.

No step's FFN feeds the recurrence, so the plain version and the CUDA kernel
(csrc/lstm_chunk.cu) both run the recurrence over all P steps first and the
residual + FFN + BasicNorm over the P*S rows after; the values are the same
as the TPU kernel's step-by-step order. `lstm_layer_chunk_fused` takes the
plain version for CPU tensors and launches the kernel for CUDA tensors (one
C call launches both halves; counted as `lstm_chunk_f32` or
`lstm_chunk_bf16`); it never falls back.

Kernel 12, `lstm_layer_fused`, ports `lstm_layer_fused` (`_layer_kernel`):
the same layer for one timestep of S sessions (the per-pull encoder and the
flush), with an optional gate column that keeps the carried h/c as the
arithmetic blend `g * new + (1 - g) * old`, as the TPU kernel computes it.
CUDA tensors launch csrc/lstm_step.cu (counted as `lstm_step_f32` or
`lstm_step_bf16`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build
from .activations import dot_wd, double_swish, sigmoid
from .lstm_kernels import _bias_flag, _check, _gate_arg, _gate_blend


def lstm_layer_chunk_plain(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                           n_pulls=None):
    P, S, d = x.shape
    H = c.shape[1]
    b = bias.float()
    hseq = []
    for t in range(P):
        gates = dot_wd(x[t], w_ih) + dot_wd(h, w_hh) + b
        i, f, g, o = gates.split(H, dim=-1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        h_new = dot_wd(sigmoid(o) * torch.tanh(c_new), w_hr)
        hseq.append(h_new)
        if n_pulls is None:
            h, c = h_new, c_new
        else:
            live = (t < n_pulls)[:, None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
    y = ffn_norm_float_plain(x.reshape(P * S, d), torch.stack(hseq).reshape(P * S, d),
                             ff1, ff1_b, ff2, ff2_b, eps)
    return y.reshape(P, S, d), h, c


def ffn_norm_float_plain(x, hseq, ff1, ff1_b, ff2, ff2_b, eps):
    """[R, d] rows -> BasicNorm(y + ff2(DoubleSwish(ff1(y)))), y = x + hseq."""
    y = x.float() + hseq
    mid = double_swish(dot_wd(y, ff1) + ff1_b.float())
    yn = y + (dot_wd(mid, ff2) + ff2_b.float())
    return yn * torch.rsqrt((yn * yn).mean(dim=-1, keepdim=True) + eps.float())


def lstm_layer_chunk_cuda(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                          n_pulls=None):
    P, S, d = x.shape
    H = c.shape[1]
    F = ff1.shape[1]
    wd = w_ih.dtype
    if wd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_chunk: weights must be float32 or bfloat16, got {wd}")
    if d % 4 or H % 4 or F % 4:
        raise ValueError("lstm_chunk: d_model, hidden and ffn must be multiples of 4")
    _check(x, torch.float32, (P, S, d), "lstm_chunk x")
    _check(h, torch.float32, (S, d), "lstm_chunk h")
    _check(c, torch.float32, (S, H), "lstm_chunk c")
    for w, shape, what in ((w_ih, (d, 4 * H), "w_ih"), (w_hh, (d, 4 * H), "w_hh"),
                           (w_hr, (H, d), "w_hr"), (ff1, (d, F), "ff1"), (ff2, (F, d), "ff2")):
        _check(w, wd, shape, f"lstm_chunk {what}")
        if w.data_ptr() % 16:
            raise ValueError(f"lstm_chunk {what}: weights must be 16-byte aligned")
    for b, n, what in ((bias, 4 * H, "bias"), (ff1_b, F, "ff1_b"), (ff2_b, d, "ff2_b")):
        _check(b.reshape(-1), b.dtype, (n,), f"lstm_chunk {what}")
    _check(eps.reshape(-1), torch.float32, (1,), "lstm_chunk eps")
    if n_pulls is None:
        n_pulls = torch.full((S,), P, dtype=torch.int32, device=x.device)
    _check(n_pulls, torch.int32, (S,), "lstm_chunk n_pulls")
    hseq = torch.empty((P, S, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    w_bf16 = int(wd == torch.bfloat16)
    fn = cuda_build.bind("lstm_chunk", "lstm_chunk", 17, 9)
    cuda_build.COUNTS["lstm_chunk_bf16" if w_bf16 else "lstm_chunk_f32"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
        ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        hseq.data_ptr(), h2.data_ptr(), c2.data_ptr(), y.data_ptr(),
        P, S, d, H, F, w_bf16, _bias_flag(bias, "lstm_chunk"),
        _bias_flag(ff1_b, "lstm_chunk"), _bias_flag(ff2_b, "lstm_chunk"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, "lstm_chunk")
    return y, h2, c2


def lstm_layer_chunk_fused(
    x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
    n_pulls: Optional[torch.Tensor] = None,
):
    """x [P, S, d], h [S, d], c [S, H] f32, n_pulls optional [S] i32 prefix
    lengths -> (y [P, S, d], h' [S, d], c' [S, H]), all f32."""
    args = (x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps, n_pulls)
    if x.device.type == "cpu":
        return lstm_layer_chunk_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_chunk: unsupported device {x.device}")
    return lstm_layer_chunk_cuda(*args)


def lstm_layer_fused_plain(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                           gate=None):
    H = c.shape[1]
    gates = dot_wd(x, w_ih) + dot_wd(h, w_hh) + bias.float()
    i, f, g, o = gates.split(H, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    h_new = dot_wd(sigmoid(o) * torch.tanh(c_new), w_hr)
    y = ffn_norm_float_plain(x, h_new, ff1, ff1_b, ff2, ff2_b, eps)
    return y, _gate_blend(gate, h_new, h), _gate_blend(gate, c_new, c)


def lstm_layer_fused_cuda(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                          gate=None):
    S, d = x.shape
    H = c.shape[1]
    F = ff1.shape[1]
    wd = w_ih.dtype
    if wd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"lstm_step: weights must be float32 or bfloat16, got {wd}")
    if d % 4 or H % 4 or F % 4:
        raise ValueError("lstm_step: d_model, hidden and ffn must be multiples of 4")
    _check(x, torch.float32, (S, d), "lstm_step x")
    _check(h, torch.float32, (S, d), "lstm_step h")
    _check(c, torch.float32, (S, H), "lstm_step c")
    for w, shape, what in ((w_ih, (d, 4 * H), "w_ih"), (w_hh, (d, 4 * H), "w_hh"),
                           (w_hr, (H, d), "w_hr"), (ff1, (d, F), "ff1"), (ff2, (F, d), "ff2")):
        _check(w, wd, shape, f"lstm_step {what}")
        if w.data_ptr() % 16:
            raise ValueError(f"lstm_step {what}: weights must be 16-byte aligned")
    for b, n, what in ((bias, 4 * H, "bias"), (ff1_b, F, "ff1_b"), (ff2_b, d, "ff2_b")):
        _check(b.reshape(-1), b.dtype, (n,), f"lstm_step {what}")
    _check(eps.reshape(-1), torch.float32, (1,), "lstm_step eps")
    g = _gate_arg(gate, S, "lstm_step")
    dev = x.device
    hc = torch.empty((S, H), dtype=torch.float32, device=dev)
    hn = torch.empty((S, d), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    w_bf16 = int(wd == torch.bfloat16)
    fn = cuda_build.bind("lstm_step", "lstm_step_float", 18, 8)
    cuda_build.COUNTS["lstm_step_bf16" if w_bf16 else "lstm_step_f32"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
        ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        hc.data_ptr(), hn.data_ptr(), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        S, d, H, F, w_bf16, _bias_flag(bias, "lstm_step"),
        _bias_flag(ff1_b, "lstm_step"), _bias_flag(ff2_b, "lstm_step"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "lstm_step")
    return y, h2, c2


def lstm_layer_fused(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps, gate=None):
    """One float layer timestep: x, h [S, d], c [S, H] f32, gate optional
    [S] -> (y [S, d], h' [S, d], c' [S, H]), all f32."""
    args = (x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps, gate)
    if x.device.type == "cpu":
        return lstm_layer_fused_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step: unsupported device {x.device}")
    return lstm_layer_fused_cuda(*args)
