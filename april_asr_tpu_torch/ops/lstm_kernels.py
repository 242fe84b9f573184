"""Kernels 2 and 3: the int8 split-form LSTM layer of the chunk encoder, and
kernel 7: one int8 timestep of a whole layer.

Ports of `lstm_layer_chunk_rec_stream2_i8` (`_rec_stream2_kernel_i8`),
`ffn_norm_i8` (`_ffn_norm_kernel_i8`) and `lstm_layer_fused_i8`
(`_layer_kernel_i8`) in april_asr_tpu/ops/lstm_pallas.py.

* `lstm_layer_chunk_rec_i8`: the recurrent core of one layer over P steps.
  Per step: `_rowq8` of x_t and of h, the int8 gate dots against w_ih/w_hh,
  the f32 cell with the tanh-form sigmoid, `_rowq8` of hc and the int8
  projection. A prefix mask `t < n_pulls` keeps the carried h/c. Returns
  (hseq [P, S, d], h', c').
* `ffn_norm_i8`: y = x + hseq, int8 ff1, DoubleSwish, int8 ff2, residual,
  then BasicNorm `y * rsqrt(mean(y^2) + eps)` over flattened rows.
* `lstm_layer_fused_i8`: one timestep of the whole layer (the per-pull
  encoder and the flush): `_rowq8` of x, h, hc, y and mid, exact int32
  dots, the cell, the projection, then `ffn_norm_i8`'s residual, FFN and
  norm. An optional gate column keeps the carried h/c as the arithmetic
  blend `g * new + (1 - g) * old`, as the TPU kernel computes it.

Per-row activation quantization (`_rowq8`): s = max(amax, 1e-30) * (1/127),
q = round_half_even(x * (1/s)) -- the reciprocal is multiplied, never divided
by, exactly as the JAX package does. Integer dots are exact; they are
dequantized as acc * (s_row * s_col).

Each wrapper takes the plain PyTorch version for CPU tensors and launches
csrc/lstm_i8.cu (kernels 2, 3) or csrc/lstm_step.cu (kernel 7) for CUDA
tensors; it never falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_build
from .activations import sigmoid


def _rowq8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization: f32 [m, k] ->
    (integer-valued f32 [m, k], f32 scale [m, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    q = torch.round(x * torch.reciprocal(s))
    return q, s


def _int_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as f32 (float64 holds every partial sum
    exactly; the f32 cast then rounds like an int32 -> f32 conversion)."""
    return (q.double() @ w.double()).float()


def _q8_mm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """x f32 [m, k] @ (wq int8 [k, n] * ws [1, n]) with dynamic row quant."""
    q, s = _rowq8(x.float())
    return _int_dot(q, wq) * (s * ws)


def lstm_rec_plain(x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s):
    P, S, d = x.shape
    H = c.shape[1]
    gx = _q8_mm(x.reshape(P * S, d), w_ih_q, w_ih_s.reshape(1, -1)).reshape(P, S, 4 * H)
    b = bias.float().reshape(1, -1)
    hseq = []
    for t in range(P):
        gates = gx[t] + _q8_mm(h, w_hh_q, w_hh_s.reshape(1, -1)) + b
        i, f, g, o = gates.split(H, dim=-1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        hc = sigmoid(o) * torch.tanh(c_new)
        h_new = _q8_mm(hc, w_hr_q, w_hr_s.reshape(1, -1))
        hseq.append(h_new)
        if n_pulls is None:
            h, c = h_new, c_new
        else:
            live = (t < n_pulls)[:, None]
            h = torch.where(live, h_new, h)
            c = torch.where(live, c_new, c)
    return torch.stack(hseq), h, c


def _bias_flag(b: torch.Tensor, what: str) -> int:
    if b.dtype == torch.bfloat16:
        return 1
    if b.dtype == torch.float32:
        return 0
    raise ValueError(f"{what}: bias must be float32 or bfloat16, got {b.dtype}")


def _check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def lstm_rec_cuda(x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s):
    P, S, d = x.shape
    H = c.shape[1]
    if d % 4 or H % 4:
        raise ValueError("lstm_rec_i8: d_model and hidden must be multiples of 4")
    _check(x, torch.float32, (P, S, d), "lstm_rec_i8 x")
    _check(h, torch.float32, (S, d), "lstm_rec_i8 h")
    _check(c, torch.float32, (S, H), "lstm_rec_i8 c")
    _check(w_ih_q, torch.int8, (d, 4 * H), "lstm_rec_i8 w_ih")
    _check(w_hh_q, torch.int8, (d, 4 * H), "lstm_rec_i8 w_hh")
    _check(w_hr_q, torch.int8, (H, d), "lstm_rec_i8 w_hr")
    for s, n_out in ((w_ih_s, 4 * H), (w_hh_s, 4 * H), (w_hr_s, d)):
        _check(s.reshape(-1), torch.float32, (n_out,), "lstm_rec_i8 scale")
    _check(bias.reshape(-1), bias.dtype, (4 * H,), "lstm_rec_i8 bias")
    if n_pulls is None:
        n_pulls = torch.full((S,), P, dtype=torch.int32, device=x.device)
    _check(n_pulls, torch.int32, (S,), "lstm_rec_i8 n_pulls")
    hseq = torch.empty((P, S, d), dtype=torch.float32, device=x.device)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_i8", "lstm_rec_i8", 14, 5)
    cuda_build.COUNTS["lstm_rec_i8"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        w_ih_q.data_ptr(), w_ih_s.data_ptr(), w_hh_q.data_ptr(), w_hh_s.data_ptr(),
        bias.data_ptr(), w_hr_q.data_ptr(), w_hr_s.data_ptr(),
        hseq.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        P, S, d, H, _bias_flag(bias, "lstm_rec_i8"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, "lstm_rec_i8")
    return hseq, h2, c2


def lstm_layer_chunk_rec_i8(
    x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
    n_pulls: Optional[torch.Tensor] = None,
):
    """x [P, S, d], h [S, d], c [S, H], n_pulls optional [S] i32 prefix
    lengths -> (hseq [P, S, d], h' [S, d], c' [S, H])."""
    if x.device.type == "cpu":
        return lstm_rec_plain(x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_rec_i8: unsupported device {x.device}")
    return lstm_rec_cuda(x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)


def ffn_norm_plain(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps):
    y = x.float() + hseq
    mid = _q8_mm(y, ff1_q, ff1_s.reshape(1, -1)) + ff1_b.float().reshape(1, -1)
    mid = mid * sigmoid(mid - 1.0)
    ff = _q8_mm(mid, ff2_q, ff2_s.reshape(1, -1)) + ff2_b.float().reshape(1, -1)
    yn = y + ff
    return yn * torch.rsqrt((yn * yn).mean(dim=-1, keepdim=True) + eps.float())


def ffn_norm_cuda(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps):
    R, d = x.shape
    F = ff1_q.shape[1]
    if d % 4 or F % 4:
        raise ValueError("ffn_norm_i8: d_model and ffn must be multiples of 4")
    _check(x, torch.float32, (R, d), "ffn_norm_i8 x")
    _check(hseq, torch.float32, (R, d), "ffn_norm_i8 hseq")
    _check(ff1_q, torch.int8, (d, F), "ffn_norm_i8 ff1")
    _check(ff2_q, torch.int8, (F, d), "ffn_norm_i8 ff2")
    _check(ff1_s.reshape(-1), torch.float32, (F,), "ffn_norm_i8 ff1 scale")
    _check(ff2_s.reshape(-1), torch.float32, (d,), "ffn_norm_i8 ff2 scale")
    _check(ff1_b.reshape(-1), ff1_b.dtype, (F,), "ffn_norm_i8 ff1 bias")
    _check(ff2_b.reshape(-1), ff2_b.dtype, (d,), "ffn_norm_i8 ff2 bias")
    _check(eps.reshape(-1), torch.float32, (1,), "ffn_norm_i8 eps")
    y = torch.empty_like(x)
    fn = cuda_build.bind("lstm_i8", "ffn_norm_i8", 10, 5)
    cuda_build.COUNTS["ffn_norm_i8"] += 1
    rc = fn(
        x.data_ptr(), hseq.data_ptr(), ff1_q.data_ptr(), ff1_s.data_ptr(),
        ff1_b.data_ptr(), ff2_q.data_ptr(), ff2_s.data_ptr(), ff2_b.data_ptr(),
        eps.data_ptr(), y.data_ptr(),
        R, d, F, _bias_flag(ff1_b, "ffn_norm_i8"), _bias_flag(ff2_b, "ffn_norm_i8"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, "ffn_norm_i8")
    return y


def ffn_norm_i8(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps):
    """x/hseq [R, d] -> BasicNorm((x + hseq) + FFN(x + hseq)) [R, d]."""
    if x.device.type == "cpu":
        return ffn_norm_plain(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_norm_i8: unsupported device {x.device}")
    return ffn_norm_cuda(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)


def _gate_blend(gate, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """`gt * new + (1 - gt) * old` for a [S] gate (None: new)."""
    if gate is None:
        return new
    g = gate.float()[:, None]
    return g * new + (1.0 - g) * old


def lstm_layer_fused_i8_plain(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                              ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None):
    H = c.shape[1]
    x = x.float()
    gates = (
        _q8_mm(x, w_ih_q, w_ih_s.reshape(1, -1)) + _q8_mm(h, w_hh_q, w_hh_s.reshape(1, -1))
        + bias.float().reshape(1, -1)
    )
    i, f, g, o = gates.split(H, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    hc = sigmoid(o) * torch.tanh(c_new)
    h_new = _q8_mm(hc, w_hr_q, w_hr_s.reshape(1, -1))
    y = ffn_norm_plain(x, h_new, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    return y, _gate_blend(gate, h_new, h), _gate_blend(gate, c_new, c)


def _gate_arg(gate, S: int, what: str):
    """The gate as a contiguous f32 [S] tensor, or None (ungated)."""
    if gate is None:
        return None
    g = gate.to(torch.float32).contiguous()
    _check(g, torch.float32, (S,), f"{what} gate")
    return g


def lstm_layer_fused_i8_cuda(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                             ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None):
    S, d = x.shape
    H = c.shape[1]
    F = ff1_q.shape[1]
    if d % 4 or H % 4 or F % 4:
        raise ValueError("lstm_step_i8: d_model, hidden and ffn must be multiples of 4")
    _check(x, torch.float32, (S, d), "lstm_step_i8 x")
    _check(h, torch.float32, (S, d), "lstm_step_i8 h")
    _check(c, torch.float32, (S, H), "lstm_step_i8 c")
    for w, shape, what in ((w_ih_q, (d, 4 * H), "w_ih"), (w_hh_q, (d, 4 * H), "w_hh"),
                           (w_hr_q, (H, d), "w_hr"), (ff1_q, (d, F), "ff1"), (ff2_q, (F, d), "ff2")):
        _check(w, torch.int8, shape, f"lstm_step_i8 {what}")
        if w.data_ptr() % 4:
            raise ValueError(f"lstm_step_i8 {what}: weights must be 4-byte aligned")
    for s, n_out in ((w_ih_s, 4 * H), (w_hh_s, 4 * H), (w_hr_s, d), (ff1_s, F), (ff2_s, d)):
        _check(s.reshape(-1), torch.float32, (n_out,), "lstm_step_i8 scale")
    for b, n in ((bias, 4 * H), (ff1_b, F), (ff2_b, d)):
        _check(b.reshape(-1), b.dtype, (n,), "lstm_step_i8 bias")
    _check(eps.reshape(-1), torch.float32, (1,), "lstm_step_i8 eps")
    g = _gate_arg(gate, S, "lstm_step_i8")
    dev = x.device
    hc = torch.empty((S, H), dtype=torch.float32, device=dev)
    hn = torch.empty((S, d), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_step", "lstm_step_i8", 23, 7)
    cuda_build.COUNTS["lstm_step_i8"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
        w_ih_q.data_ptr(), w_ih_s.data_ptr(), w_hh_q.data_ptr(), w_hh_s.data_ptr(),
        bias.data_ptr(), w_hr_q.data_ptr(), w_hr_s.data_ptr(),
        ff1_q.data_ptr(), ff1_s.data_ptr(), ff1_b.data_ptr(),
        ff2_q.data_ptr(), ff2_s.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(),
        hc.data_ptr(), hn.data_ptr(), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        S, d, H, F, _bias_flag(bias, "lstm_step_i8"), _bias_flag(ff1_b, "lstm_step_i8"),
        _bias_flag(ff2_b, "lstm_step_i8"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "lstm_step_i8")
    return y, h2, c2


def lstm_layer_fused_i8(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                        ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None):
    """One int8 layer timestep: x, h [S, d], c [S, H] f32, gate optional [S]
    -> (y [S, d], h' [S, d], c' [S, H]), all f32."""
    args = (x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
            ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate)
    if x.device.type == "cpu":
        return lstm_layer_fused_i8_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step_i8: unsupported device {x.device}")
    return lstm_layer_fused_i8_cuda(*args)
