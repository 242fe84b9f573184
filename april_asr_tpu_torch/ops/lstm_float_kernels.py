"""Kernel 10: the float whole-layer chunk of the encoder, and kernel 12: one
float timestep of a whole layer (f32 or bf16 weights).

Port of `lstm_layer_chunk_fused` (april_asr_tpu/ops/lstm_pallas.py,
`_chunk_kernel`): one residual LSTMP layer over P steps,

    gates = dot(x_t, w_ih) + dot(h, w_hh) + b       (the TPU kernel's order:
    c' = sig(f) * c + sig(i) * tanh(g)               both sums, then the bias)
    h' = dot(sig(o) * tanh(c'), w_hr)
    y_t = BasicNorm(x_t + h' + ff2(DoubleSwish(ff1(x_t + h'))))

with the tanh-form sigmoid (ops/activations.py), the BasicNorm's mean over
`norm_d` columns where a model's d_model is zero-padded to a multiple of 4
(ops/widths.py; None: the whole row). Every dot rounds its
activation to the weight dtype and accumulates in f32
(`jnp.dot(x.astype(wd), w, preferred_element_type=f32)`): f32 weights give
true f32 products, bf16 weights bf16-rounded activations times bf16 weights.
`n_pulls` [S] is a prefix gate: step t is live for session s iff
t < n_pulls[s]; masked steps keep h/c and give finite garbage y rows that the
decode masks off.

No step's FFN feeds the recurrence, so the plain version and the CUDA kernel
both run the recurrence over all P steps first and the residual + FFN +
BasicNorm over the P*S rows after; the values are the same as the TPU
kernel's step-by-step order. `lstm_layer_chunk_fused` takes the plain
version for CPU tensors and launches the kernel for CUDA tensors; it never
falls back. The kernel is csrc/lstm_chunk_mma.cu, one persistent
cooperative launch a layer on kernel 12's phases (per step the gate and
projection items, then the ff1 and ff2 items over the P*S rows and the
norm), planned by ops/lstm_mma.py `device_chunk_plan` (counted as
`lstm_chunk_mma_f32` or `lstm_chunk_mma_bf16`). The two-kernel version it
replaced (csrc/lstm_chunk.cu) stays as `lstm_layer_chunk_simt`, counted as
`lstm_chunk_simt`: chip_smoke.py's yardstick, launched by no serving path.

Kernel 12, `lstm_layer_fused`, ports `lstm_layer_fused` (`_layer_kernel`):
the same layer for one timestep of S sessions (the per-pull encoder and the
flush), with an optional gate column that keeps the carried h/c as the
arithmetic blend `g * new + (1 - g) * old`, as the TPU kernel computes it.
CUDA tensors launch csrc/lstm_mma_float.cu, one persistent cooperative
kernel a call (bf16 products on `mma.sync`, f32 on FFMA register tiles),
planned by ops/lstm_mma.py `device_float_plan` (counted as `lstm_step_f32`
or `lstm_step_bf16`). The three-pass kernel it replaced (csrc/lstm_step.cu
`lstm_step_float`) stays as `lstm_layer_fused_simt`, counted as
`lstm_step_float_simt`: chip_smoke.py's yardstick, launched by no serving
path.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_build, lstm_mma
from .activations import dot_wd, double_swish, sigmoid
from .lstm_kernels import (
    _bias_flag,
    _check,
    _gate_arg,
    _gate_blend,
    _norm_width,
    _smem_check,
    basic_norm_plain,
)


def lstm_layer_chunk_plain(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                           n_pulls=None, *, norm_d=None):
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
                             ff1, ff1_b, ff2, ff2_b, eps, norm_d)
    return y.reshape(P, S, d), h, c


def ffn_norm_float_plain(x, hseq, ff1, ff1_b, ff2, ff2_b, eps, norm_d=None):
    """[R, d] rows -> BasicNorm(y + ff2(DoubleSwish(ff1(y)))), y = x + hseq,
    the norm's mean over norm_d columns (all where None)."""
    y = x.float() + hseq
    mid = double_swish(dot_wd(y, ff1) + ff1_b.float())
    return basic_norm_plain(y + (dot_wd(mid, ff2) + ff2_b.float()), eps, norm_d)


def _check_vec(t: torch.Tensor, n: int, dtypes, what: str) -> None:
    """A contiguous vector (any shape) of n values of one of `dtypes`."""
    if t.dtype not in dtypes or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{what}: expected {n} contiguous values of {dtypes}, got {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()}")


def _chunk_args(what: str, x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                n_pulls):
    """Checks kernel 10's operands without making a view (a few us a call);
    returns (P, S, d, H, F, n_pulls as int32 [S])."""
    P, S, d = x.shape
    H = c.shape[1]
    F = ff1.shape[1]
    wd = w_ih.dtype
    if wd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: weights must be float32 or bfloat16, got {wd}")
    if d % 4 or H % 4 or F % 4:
        raise ValueError(f"{what}: d_model, hidden and ffn must be multiples of 4")
    _check(x, torch.float32, (P, S, d), f"{what} x")
    _check(h, torch.float32, (S, d), f"{what} h")
    _check(c, torch.float32, (S, H), f"{what} c")
    for w, shape, name in ((w_ih, (d, 4 * H), "w_ih"), (w_hh, (d, 4 * H), "w_hh"),
                           (w_hr, (H, d), "w_hr"), (ff1, (d, F), "ff1"), (ff2, (F, d), "ff2")):
        _check(w, wd, shape, f"{what} {name}")
        if w.data_ptr() % 16:
            raise ValueError(f"{what} {name}: weights must be 16-byte aligned")
    floats = (torch.float32, torch.bfloat16)
    for b, n, name in ((bias, 4 * H, "bias"), (ff1_b, F, "ff1_b"), (ff2_b, d, "ff2_b")):
        _check_vec(b, n, floats, f"{what} {name}")
    _check_vec(eps, 1, (torch.float32,), f"{what} eps")
    if n_pulls is None:
        n_pulls = torch.full((S,), P, dtype=torch.int32, device=x.device)
    _check(n_pulls, torch.int32, (S,), f"{what} n_pulls")
    return P, S, d, H, F, n_pulls


def lstm_layer_chunk_cuda(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                          n_pulls=None, stamps=None, norm_d=None):
    """Kernel 10: one cooperative launch of csrc/lstm_chunk_mma.cu, planned
    by ops/lstm_mma.py `device_chunk_plan`, its scratch (hc [S, H], mid
    [P * S, F] f32) in one workspace. `stamps` (int64 [nb, 4 P + 6], or
    None) receives each block's phase times (tools/profile_lstm_mma.py)."""
    P, S, d, H, F, n_pulls = _chunk_args("lstm_chunk", x, h, c, w_ih, w_hh, bias, w_hr, ff1,
                                         ff1_b, ff2, ff2_b, eps, n_pulls)
    if x.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("lstm_chunk x, h: rows must be 16-byte aligned")
    w_bf16 = int(w_ih.dtype == torch.bfloat16)
    dev = x.device
    plan = lstm_mma.device_chunk_plan(S, P, d, H, F, 2 if w_bf16 else 4, dev)
    ws = torch.empty(lstm_mma.chunk_scratch(plan), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_chunk_mma", "lstm_chunk_float_mma", 19, 36)
    cuda_build.COUNTS["lstm_chunk_mma_bf16" if w_bf16 else "lstm_chunk_mma_f32"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
        ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        y.data_ptr(), h2.data_ptr(), c2.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * S * H,
        None if stamps is None else stamps.data_ptr(),
        P, S, d, H, F, w_bf16, _bias_flag(bias, "lstm_chunk"), _bias_flag(ff1_b, "lstm_chunk"),
        _bias_flag(ff2_b, "lstm_chunk"), *plan.ints(), _norm_width(norm_d, d, "lstm_chunk"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _smem_check(rc, "lstm_chunk", f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def lstm_layer_chunk_simt_cuda(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                               n_pulls=None):
    """The two-kernel chunk layer that kernel 10 replaced (csrc/lstm_chunk.cu
    `lstm_chunk`: the recurrence on 4-session blocks, then the 16-row FFN
    tiles); chip_smoke.py's yardstick. No serving path launches it."""
    P, S, d, H, F, n_pulls = _chunk_args("lstm_chunk_simt", x, h, c, w_ih, w_hh, bias, w_hr,
                                         ff1, ff1_b, ff2, ff2_b, eps, n_pulls)
    hseq = torch.empty((P, S, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    w_bf16 = int(w_ih.dtype == torch.bfloat16)
    fn = cuda_build.bind("lstm_chunk", "lstm_chunk", 17, 9)
    cuda_build.COUNTS["lstm_chunk_simt"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
        ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        hseq.data_ptr(), h2.data_ptr(), c2.data_ptr(), y.data_ptr(),
        P, S, d, H, F, w_bf16, _bias_flag(bias, "lstm_chunk_simt"),
        _bias_flag(ff1_b, "lstm_chunk_simt"), _bias_flag(ff2_b, "lstm_chunk_simt"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, "lstm_chunk_simt", f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def lstm_layer_chunk_simt(*args, norm_d=None):
    """`lstm_layer_chunk_fused`'s contract on the two-kernel chunk layer
    (CUDA tensors; the plain version for CPU tensors). The kernel's norm
    spans the whole width, so `norm_d` may only name it."""
    x = args[0]
    if x.device.type == "cpu":
        return lstm_layer_chunk_plain(*args, norm_d=norm_d)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_chunk_simt: unsupported device {x.device}")
    if norm_d not in (None, x.shape[2]):
        raise ValueError(f"lstm_chunk_simt: a norm over {norm_d} of {x.shape[2]} columns "
                         "(padded widths) is not this kernel's")
    return lstm_layer_chunk_simt_cuda(*args)


def lstm_layer_chunk_fused(
    x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
    n_pulls: Optional[torch.Tensor] = None, *, norm_d: Optional[int] = None,
):
    """x [P, S, d], h [S, d], c [S, H] f32, n_pulls optional [S] i32 prefix
    lengths -> (y [P, S, d], h' [S, d], c' [S, H]), all f32."""
    args = (x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps, n_pulls)
    if x.device.type == "cpu":
        return lstm_layer_chunk_plain(*args, norm_d=norm_d)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_chunk: unsupported device {x.device}")
    return lstm_layer_chunk_cuda(*args, norm_d=norm_d)


def lstm_layer_fused_plain(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                           gate=None, *, norm_d=None):
    H = c.shape[1]
    gates = dot_wd(x, w_ih) + dot_wd(h, w_hh) + bias.float()
    i, f, g, o = gates.split(H, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    h_new = dot_wd(sigmoid(o) * torch.tanh(c_new), w_hr)
    y = ffn_norm_float_plain(x, h_new, ff1, ff1_b, ff2, ff2_b, eps, norm_d)
    return y, _gate_blend(gate, h_new, h), _gate_blend(gate, c_new, c)


def _step_float_args(what: str, x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                     gate):
    """Checks kernel 12's operands; returns (S, d, H, F, gate as f32 or None)."""
    S, d = x.shape
    H = c.shape[1]
    F = ff1.shape[1]
    wd = w_ih.dtype
    if wd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: weights must be float32 or bfloat16, got {wd}")
    if d % 4 or H % 4 or F % 4:
        raise ValueError(f"{what}: d_model, hidden and ffn must be multiples of 4")
    _check(x, torch.float32, (S, d), f"{what} x")
    _check(h, torch.float32, (S, d), f"{what} h")
    _check(c, torch.float32, (S, H), f"{what} c")
    for w, shape, name in ((w_ih, (d, 4 * H), "w_ih"), (w_hh, (d, 4 * H), "w_hh"),
                           (w_hr, (H, d), "w_hr"), (ff1, (d, F), "ff1"), (ff2, (F, d), "ff2")):
        _check(w, wd, shape, f"{what} {name}")
        if w.data_ptr() % 16:
            raise ValueError(f"{what} {name}: weights must be 16-byte aligned")
    for b, n, name in ((bias, 4 * H, "bias"), (ff1_b, F, "ff1_b"), (ff2_b, d, "ff2_b")):
        _check(b.reshape(-1), b.dtype, (n,), f"{what} {name}")
    _check(eps.reshape(-1), torch.float32, (1,), f"{what} eps")
    return S, d, H, F, _gate_arg(gate, S, what)


def lstm_layer_fused_cuda(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                          gate=None, stamps=None, norm_d=None):
    """Kernel 12: one cooperative launch of csrc/lstm_mma_float.cu, its
    scratch (hc [S, H], y [S, d], mid [S, F] f32) in one workspace.
    `stamps` (int64 [nb, 10], or None) receives each block's phase times
    (tools/profile_lstm_mma.py)."""
    S, d, H, F, g = _step_float_args("lstm_step", x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b,
                                     ff2, ff2_b, eps, gate)
    for t, what in ((x, "x"), (h, "h")):
        if t.data_ptr() % 16:
            raise ValueError(f"lstm_step {what}: rows must be 16-byte aligned")
    w_bf16 = int(w_ih.dtype == torch.bfloat16)
    plan = lstm_mma.device_float_plan(S, d, H, F, 2 if w_bf16 else 4, x.device)
    dev = x.device
    ws = torch.empty(S * (H + d + F), dtype=torch.float32, device=dev)
    hc, yf, mid = ws[: S * H], ws[S * H : S * (H + d)], ws[S * (H + d) :]
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_mma_float", "lstm_step_float_mma", 20, 35)
    cuda_build.COUNTS["lstm_step_bf16" if w_bf16 else "lstm_step_f32"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
        ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        y.data_ptr(), h2.data_ptr(), c2.data_ptr(), hc.data_ptr(), yf.data_ptr(), mid.data_ptr(),
        None if stamps is None else stamps.data_ptr(),
        S, d, H, F, w_bf16, _bias_flag(bias, "lstm_step"), _bias_flag(ff1_b, "lstm_step"),
        _bias_flag(ff2_b, "lstm_step"), *plan.ints(), _norm_width(norm_d, d, "lstm_step"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _smem_check(rc, "lstm_step", f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def lstm_layer_fused_simt_cuda(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                               gate=None):
    """The three-pass CUDA-core step that kernel 12 replaced
    (csrc/lstm_step.cu `lstm_step_float`: gate pass, projection pass, 4-row
    FFN pass); chip_smoke.py's yardstick. No serving path launches it."""
    entry = "lstm_step_float_simt"
    S, d, H, F, g = _step_float_args(entry, x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2,
                                     ff2_b, eps, gate)
    wd = w_ih.dtype
    dev = x.device
    hc = torch.empty((S, H), dtype=torch.float32, device=dev)
    hn = torch.empty((S, d), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    w_bf16 = int(wd == torch.bfloat16)
    fn = cuda_build.bind("lstm_step", "lstm_step_float", 18, 8)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
        ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        hc.data_ptr(), hn.data_ptr(), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        S, d, H, F, w_bf16, _bias_flag(bias, entry),
        _bias_flag(ff1_b, entry), _bias_flag(ff2_b, entry),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, entry)
    return y, h2, c2


def lstm_layer_fused_simt(*args):
    """`lstm_layer_fused`'s contract on the three-pass step (CUDA tensors;
    the plain version for CPU tensors)."""
    x = args[0]
    if x.device.type == "cpu":
        return lstm_layer_fused_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step_float_simt: unsupported device {x.device}")
    return lstm_layer_fused_simt_cuda(*args)


def lstm_layer_fused(x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps, gate=None, *,
                     norm_d=None):
    """One float layer timestep: x, h [S, d], c [S, H] f32, gate optional
    [S] -> (y [S, d], h' [S, d], c' [S, H]), all f32."""
    args = (x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps, gate)
    if x.device.type == "cpu":
        return lstm_layer_fused_plain(*args, norm_d=norm_d)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step: unsupported device {x.device}")
    return lstm_layer_fused_cuda(*args, norm_d=norm_d)
