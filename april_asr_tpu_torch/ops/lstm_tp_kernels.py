"""Kernels 18-21: one model shard's pieces of the tensor-parallel LSTM
encoder layer step (port of april_asr_tpu/ops/lstm_tp_pallas.py).

Under tensor parallelism the whole-layer kernels (7, 12) cannot be used as
they are: the recurrent projection and the FFN produce PARTIAL [S, d] sums
that must be all-reduced over the model group before the residual add and
the BasicNorm, and a kernel cannot contain a collective. So the layer splits
into local kernels with the all-reduces between them
(models/lstm_transducer.py `_lstm_stack_step_tp`):

    float:  lstm_gate_cell_proj (18): gates, cell, hp = hc @ w_hr_local
            all_reduce(hp) -> h_new;  y = x + h_new
            ffn_partial (20): DoubleSwish(y @ ff1_local + b1) @ ff2_local
            all_reduce -> + ff2_b, BasicNorm
    int8:   lstm_gates_cell_i8 (19): gates and cell -> hc
            hc quantized against the model-global row scale (`rowq8_global`),
            the exact int32 w_hr product all-reduced as int32
            ffn_mid_i8 (21): DoubleSwish(y @ ff1_local + b1) -> mid
            mid the same way through ff2, then + ff2_b, BasicNorm

The weights are the gate-shuffled shard slices (parallel/tp.py): shard k's
w_ih/w_hh/bias slice is [i_k | f_k | g_k | o_k], a standard layer of hidden
width Hs = H/m. x, h and y are replicated rows, so the in-kernel _rowq8 of
x, h and y is the single-device quantization exactly.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
csrc/lstm_tp.cu for CUDA tensors (counted as `tp_gcp_f32`/`tp_gcp_bf16`,
`tp_gc_i8`, `tp_ffn_f32`/`tp_ffn_bf16` and `tp_ffn_mid_i8`), at any S (the
TPU kernels tile S by block_s; these take ragged session tiles); it never
falls back. `gate` (optional [S]) blends c inside the kernels as
`gt * c_new + (1 - gt) * c`; the outputs hp and hc are ungated.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .activations import dot_wd, double_swish, sigmoid
from .lstm_kernels import _bias_flag, _check, _gate_arg, _gate_blend, _q8_mm


def tp_smem(d: int, Hs: int, Fs: int, wbytes: int) -> dict:
    """Bytes of shared memory of each pass of kernels 18 and 20 (wbytes 4 or
    2: f32 activations) or 19 and 21 (wbytes 1: int8 activations) at one
    shard's widths, as csrc/lstm_step.cuh `launch_gates` and csrc/lstm_tp.cu
    `launch_cols` compute them: the gate pass (32 sessions' x and h rows,
    two staged 32-row chunks of 64 units' four gates) and each column pass
    (16 sessions' rows of depth K, a 32 x 64 weight chunk)."""
    a = 1 if wbytes == 1 else 4
    gates = 4 * 2 * 32 + a * 2 * 32 * (d + 16) + wbytes * 2 * 32 * 4 * 64
    cols = lambda K: 4 * 16 + a * 16 * (K + 16) + wbytes * 32 * 64  # noqa: E731
    if wbytes == 1:
        return {"gates": gates, "ff1": cols(d)}
    return {"gates": gates, "projection": cols(Hs), "ff1": cols(d), "ff2": cols(Fs)}


def _gates_cell(gates: torch.Tensor, c: torch.Tensor, gate):
    H = c.shape[1]
    i, f, g, o = gates.split(H, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    return sigmoid(o) * torch.tanh(c_new), _gate_blend(gate, c_new, c)


def lstm_gate_cell_proj_plain(x, h, c, w_ih, w_hh, bias, w_hr, gate=None):
    hc, c2 = _gates_cell(dot_wd(x, w_ih) + dot_wd(h, w_hh) + bias.float(), c, gate)
    return dot_wd(hc, w_hr), c2


def lstm_gates_cell_i8_plain(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, gate=None):
    gates = (_q8_mm(x.float(), w_ih_q, w_ih_s.reshape(1, -1))
             + _q8_mm(h, w_hh_q, w_hh_s.reshape(1, -1)) + bias.float().reshape(1, -1))
    return _gates_cell(gates, c, gate)


def ffn_partial_plain(y, ff1, ff1_b, ff2):
    return dot_wd(double_swish(dot_wd(y, ff1) + ff1_b.float()), ff2)


def ffn_mid_i8_plain(y, ff1_q, ff1_s, ff1_b):
    return double_swish(_q8_mm(y.float(), ff1_q, ff1_s.reshape(1, -1))
                        + ff1_b.float().reshape(1, -1))


def _check_mats(what: str, mats, dtype, align: int) -> None:
    for w, shape, name in mats:
        _check(w, dtype, shape, f"{what} {name}")
        if w.data_ptr() % align:
            raise ValueError(f"{what} {name}: weights must be {align}-byte aligned")


def _check_rows(what: str, S: int, d: int, H: int, x, h, c) -> None:
    if d % 4 or H % 4:
        raise ValueError(f"{what}: d_model and the shard's hidden width must be multiples of 4")
    _check(x, torch.float32, (S, d), f"{what} x")
    _check(h, torch.float32, (S, d), f"{what} h")
    _check(c, torch.float32, (S, H), f"{what} c")


def _float_flag(w: torch.Tensor, what: str) -> int:
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: weights must be float32 or bfloat16, got {w.dtype}")
    return int(w.dtype == torch.bfloat16)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def lstm_gate_cell_proj_cuda(x, h, c, w_ih, w_hh, bias, w_hr, gate=None):
    S, d = x.shape
    Hs = c.shape[1]
    what = "tp_gate_cell_proj"
    w_bf16 = _float_flag(w_ih, what)
    _check_rows(what, S, d, Hs, x, h, c)
    _check_mats(what, ((w_ih, (d, 4 * Hs), "w_ih"), (w_hh, (d, 4 * Hs), "w_hh"),
                       (w_hr, (Hs, d), "w_hr")), w_ih.dtype, 16)
    _check(bias.reshape(-1), bias.dtype, (4 * Hs,), f"{what} bias")
    g = _gate_arg(gate, S, what)
    hc = torch.empty((S, Hs), dtype=torch.float32, device=x.device)
    hp = torch.empty_like(x)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_tp", what, 11, 5)
    cuda_build.COUNTS["tp_gcp_bf16" if w_bf16 else "tp_gcp_f32"] += 1
    rc = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
            w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), w_hr.data_ptr(),
            hc.data_ptr(), hp.data_ptr(), c2.data_ptr(),
            S, d, Hs, w_bf16, _bias_flag(bias, what), _stream(x))
    cuda_build.check(rc, what)
    return hp, c2


def lstm_gates_cell_i8_cuda(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, gate=None):
    S, d = x.shape
    Hs = c.shape[1]
    what = "tp_gates_cell_i8"
    _check_rows(what, S, d, Hs, x, h, c)
    _check_mats(what, ((w_ih_q, (d, 4 * Hs), "w_ih"), (w_hh_q, (d, 4 * Hs), "w_hh")),
                torch.int8, 4)
    for s, name in ((w_ih_s, "w_ih scale"), (w_hh_s, "w_hh scale")):
        _check(s.reshape(-1), torch.float32, (4 * Hs,), f"{what} {name}")
    _check(bias.reshape(-1), bias.dtype, (4 * Hs,), f"{what} bias")
    g = _gate_arg(gate, S, what)
    hc = torch.empty_like(c)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_tp", what, 11, 4)
    cuda_build.COUNTS["tp_gc_i8"] += 1
    rc = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
            w_ih_q.data_ptr(), w_ih_s.data_ptr(), w_hh_q.data_ptr(), w_hh_s.data_ptr(),
            bias.data_ptr(), hc.data_ptr(), c2.data_ptr(),
            S, d, Hs, _bias_flag(bias, what), _stream(x))
    cuda_build.check(rc, what)
    return hc, c2


def ffn_partial_cuda(y, ff1, ff1_b, ff2):
    S, d = y.shape
    Fs = ff1.shape[1]
    what = "tp_ffn_partial"
    w_bf16 = _float_flag(ff1, what)
    if d % 4 or Fs % 4:
        raise ValueError(f"{what}: d_model and the shard's ffn width must be multiples of 4")
    _check(y, torch.float32, (S, d), f"{what} y")
    _check_mats(what, ((ff1, (d, Fs), "ff1"), (ff2, (Fs, d), "ff2")), ff1.dtype, 16)
    _check(ff1_b.reshape(-1), ff1_b.dtype, (Fs,), f"{what} ff1_b")
    mid = torch.empty((S, Fs), dtype=torch.float32, device=y.device)
    out = torch.empty_like(y)
    fn = cuda_build.bind("lstm_tp", what, 6, 5)
    cuda_build.COUNTS["tp_ffn_bf16" if w_bf16 else "tp_ffn_f32"] += 1
    rc = fn(y.data_ptr(), ff1.data_ptr(), ff1_b.data_ptr(), ff2.data_ptr(), mid.data_ptr(),
            out.data_ptr(), S, d, Fs, w_bf16, _bias_flag(ff1_b, what), _stream(y))
    cuda_build.check(rc, what)
    return out


def ffn_mid_i8_cuda(y, ff1_q, ff1_s, ff1_b):
    S, d = y.shape
    Fs = ff1_q.shape[1]
    what = "tp_ffn_mid_i8"
    if d % 4 or Fs % 4:
        raise ValueError(f"{what}: d_model and the shard's ffn width must be multiples of 4")
    _check(y, torch.float32, (S, d), f"{what} y")
    _check_mats(what, ((ff1_q, (d, Fs), "ff1"),), torch.int8, 4)
    _check(ff1_s.reshape(-1), torch.float32, (Fs,), f"{what} ff1 scale")
    _check(ff1_b.reshape(-1), ff1_b.dtype, (Fs,), f"{what} ff1_b")
    mid = torch.empty((S, Fs), dtype=torch.float32, device=y.device)
    fn = cuda_build.bind("lstm_tp", what, 5, 4)
    cuda_build.COUNTS["tp_ffn_mid_i8"] += 1
    rc = fn(y.data_ptr(), ff1_q.data_ptr(), ff1_s.data_ptr(), ff1_b.data_ptr(), mid.data_ptr(),
            S, d, Fs, _bias_flag(ff1_b, what), _stream(y))
    cuda_build.check(rc, what)
    return mid


def _dispatch(what: str, t: torch.Tensor, plain, cuda, *args):
    if t.device.type == "cpu":
        return plain(*args)
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return cuda(*args)


def lstm_gate_cell_proj(x, h, c, w_ih_t, w_hh_t, bias, w_hr_t, gate=None):
    """Kernel 18: x, h [S, d] (replicated), c [S, Hs] (this shard's), the
    shard's f32 or bf16 w_ih_t/w_hh_t [d, 4Hs], bias [4Hs], w_hr_t [Hs, d]
    -> (hp [S, d] f32, ungated: the caller all-reduces, then gates it;
    c' [S, Hs], blended by `gate`)."""
    return _dispatch("tp_gate_cell_proj", x, lstm_gate_cell_proj_plain, lstm_gate_cell_proj_cuda,
                     x, h, c, w_ih_t, w_hh_t, bias, w_hr_t, gate)


def lstm_gates_cell_i8(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, gate=None):
    """Kernel 19: the int8 gates and cell -> (hc [S, Hs] f32, ungated;
    c' [S, Hs], blended by `gate`). The caller quantizes hc against the
    model-global row scale and runs the w_hr product outside the kernel."""
    return _dispatch("tp_gates_cell_i8", x, lstm_gates_cell_i8_plain, lstm_gates_cell_i8_cuda,
                     x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, gate)


def ffn_partial(y, ff1_t, ff1_b, ff2_t):
    """Kernel 20: y [S, d] -> the partial FFN sum [S, d] over this shard's
    ffn slice (ff1_t [d, Fs], ff1_b [Fs], ff2_t [Fs, d]); the second bias
    and the BasicNorm come after the all-reduce."""
    return _dispatch("tp_ffn_partial", y, ffn_partial_plain, ffn_partial_cuda,
                     y, ff1_t, ff1_b, ff2_t)


def ffn_mid_i8(y, ff1_q, ff1_s, ff1_b):
    """Kernel 21: y [S, d] -> DoubleSwish(y @ ff1_local + b_local) [S, Fs],
    with y quantized per row in the kernel."""
    return _dispatch("tp_ffn_mid_i8", y, ffn_mid_i8_plain, ffn_mid_i8_cuda,
                     y, ff1_q, ff1_s, ff1_b)


def rowq8_global(x: torch.Tensor, mesh):
    """Per-row symmetric int8 quantization with the row amax taken across
    the model group (all_reduce MAX; `mesh` None: this process holds the
    whole row): the same int8 values as the single-device full-row _rowq8,
    so TP int8 serving decodes like single-device int8. Returns
    (integer-valued f32 q, f32 scale [S, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if mesh is not None:
        amax = mesh.all_reduce(amax, "max")
    s = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    return torch.round(x * torch.reciprocal(s)), s
