"""The int8 LSTM layer kernels: the recurrent cores 2, 13 and 14 of the
split chunk layer, kernel 3 (its batched FFN and norm), kernel 11 (the
unsplit chunk layer) and kernel 7 (one timestep of a whole layer).

Ports of april_asr_tpu/ops/lstm_pallas.py `lstm_layer_chunk_rec_stream2_i8`
(`_rec_stream2_kernel_i8`), `lstm_layer_chunk_rec_i8` (`_rec_kernel_i8`),
`lstm_layer_chunk_rec_stream_i8` (`_rec_stream_kernel_i8`), `ffn_norm_i8`
(`_ffn_norm_kernel_i8`), `lstm_layer_chunk_fused_i8` (`_chunk_kernel_i8`)
and `lstm_layer_fused_i8` (`_layer_kernel_i8`).

* `lstm_layer_chunk_rec_stream2_i8` (kernel 2, the engine's),
  `lstm_layer_chunk_rec_i8` (13) and `lstm_layer_chunk_rec_stream_i8` (14):
  one function, the recurrent core of one layer over P steps, on two
  schedules (csrc/lstm_mma.cu; csrc/lstm_hoist.cu, which 13 and 14 share,
  their CUDA-core templates kept in csrc/lstm_i8.cu). Per step: `_rowq8` of x_t
  and of h, the int8 gate dots against w_ih/w_hh, the f32 cell with the
  tanh-form sigmoid, `_rowq8` of hc and the int8 projection. A prefix mask `t < n_pulls` keeps
  the carried h/c. Returns (hseq [P, S, d] ungated, h', c').
* `ffn_norm_i8`: y = x + hseq, int8 ff1, DoubleSwish, int8 ff2, residual,
  then BasicNorm `y * rsqrt(mean(y^2) + eps)` over flattened rows.

* `lstm_layer_chunk_fused_i8` (kernel 11): the recurrent core, then
  `ffn_norm_i8` over the P * S rows (no step's FFN feeds the recurrence):
  (y [P, S, d], h', c'), y from the ungated h_new. On the card kernel 14's
  launches with kernel 3's passes as phases of the cooperative one
  (csrc/lstm_hoist.cu); its template (csrc/lstm_chunk_i8.cu) runs the FFN
  inside the time loop, as the TPU kernel does.
* `lstm_layer_fused_i8`: one timestep of the whole layer (the per-pull
  encoder and the flush): `_rowq8` of x, h, hc, y and mid, exact int32
  dots, the cell, the projection, then `ffn_norm_i8`'s residual, FFN and
  norm. An optional gate column keeps the carried h/c as the arithmetic
  blend `g * new + (1 - g) * old`, as the TPU kernel computes it.

Per-row activation quantization (`_rowq8`): s = max(amax, 1e-30) * (1/127),
q = round_half_even(x * (1/s)) -- the reciprocal is multiplied, never divided
by, exactly as the JAX package does. Integer dots are exact; they are
dequantized as acc * (s_row * s_col).

Kernels 3 and 7 take `norm_d`, the width of the BasicNorm's mean where a
model's d_model is zero-padded to a multiple of 4 (ops/widths.py); None
means the whole row.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel (csrc/lstm_mma.cu: 2, 7; csrc/ffn_mma.cu: 3; csrc/lstm_hoist.cu:
13, 14, 11) for CUDA tensors; it never falls back. Kernels 2
and 7 are persistent int8 tensor-core kernels, one cooperative launch each,
planned by ops/lstm_mma.py `device_plan`; they equal kernel 13's CUDA-core
template and the three-pass step that preceded kernel 7
(`lstm_layer_fused_i8_simt`, kept for chip_smoke.py's bit-exact check) bit
for bit. Kernels 13 and 14 are one kernel (`_rec_hoist_cuda`): the x-side
gate product over all P * S rows in tensor-core tiles, then kernel 2's
persistent recurrence with only w_hh and w_hr stationary (planned by
`rec_hoist_plan`); where that plan has no launch they take their CUDA-core
templates (`lstm_layer_chunk_rec_i8_simt`, `_stream_i8_simt`, chosen by
shape, never on an error). Where the widths leave kernels 2 and 7 no plan,
their calls take kernel 14 and the three-pass step (ops/lstm_mma.py
`int8_routes`, chosen from the widths before any launch). Kernel 3 is five
tiled int8 tensor-core passes (`ffn_norm_cuda`,
planned by ops/lstm_mma.py `ffn_plan`) with no width limit; it equals the
CUDA-core kernel it replaced (`ffn_norm_i8_simt`, kept for chip_smoke.py)
bit for bit. Kernel 11 is one cooperative launch after kernel 14's phase
A (`_chunk_hoist_cuda`, planned by `lstm_mma.chunk_hoist_plan`): kernel
14's recurrence, then kernel 3's five passes as phases; where that plan has
no launch, its CUDA-core template (`lstm_layer_chunk_fused_i8_simt`,
csrc/lstm_chunk_i8.cu, chosen by shape). Kernels 2, 13 and 14
share one plain version, `lstm_rec_plain`; kernel 11's composes it with
`ffn_norm_plain`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import cuda_build, lstm_mma
from .activations import sigmoid

# the params' int8 layer leaves, in the layer kernels' argument order
LAYER_I8_KEYS = ("w_ih_t_q8", "w_ih_t_q8s", "w_hh_t_q8", "w_hh_t_q8s", "bias",
                 "w_hr_t_q8", "w_hr_t_q8s", "ff1_t_q8", "ff1_t_q8s", "ff1_b",
                 "ff2_t_q8", "ff2_t_q8s", "ff2_b", "norm_eps")


def _rowq8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization: f32 [m, k] ->
    (integer-valued f32 [m, k], f32 scale [m, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    q = torch.round(x * torch.reciprocal(s))
    return q, s


def basic_norm_plain(yn: torch.Tensor, eps: torch.Tensor, norm_d: Optional[int] = None):
    """BasicNorm `yn * rsqrt(mean(yn^2) + eps)`, the mean over the first
    norm_d columns (the whole row where None)."""
    v = yn if norm_d is None or norm_d == yn.shape[-1] else yn[..., :norm_d]
    return yn * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps.float())


def _norm_width(norm_d: Optional[int], d: int, what: str) -> int:
    """The kernels' `dn`: norm_d, or d where None."""
    dn = d if norm_d is None else int(norm_d)
    if not 0 < dn <= d:
        raise ValueError(f"{what}: norm_d must be in [1, {d}], got {norm_d}")
    return dn


def _int_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as f32 (float64 holds every partial sum
    exactly; the f32 cast then rounds like an int32 -> f32 conversion)."""
    return (q.double() @ w.double()).float()


def _q8_mm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, dot=_int_dot) -> torch.Tensor:
    """x f32 [m, k] @ (wq int8 [k, n] * ws [1, n]) with dynamic row quant;
    `dot` computes the exact integer product as f32."""
    q, s = _rowq8(x.float())
    return dot(q, wq) * (s * ws)


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


def _check_i8_weights(what: str, lead: tuple, d: int, H: int, rec, ffn=None) -> None:
    """The recurrent weights `rec` (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias,
    w_hr_q, w_hr_s) and optionally `ffn` (ff1_q, ff1_s, ff1_b, ff2_q, ff2_s,
    ff2_b, eps) of one layer (`lead` ()) or a stack of layers (`lead` (L,)):
    int8 matrices 4-byte aligned (the kernels read char4 strips), f32 scales,
    f32 or bf16 biases, an f32 eps per layer."""
    if d % 4 or H % 4 or (ffn is not None and ffn[0].shape[-1] % 4):
        raise ValueError(f"{what}: d_model, hidden and ffn must be multiples of 4")
    n = math.prod(lead)
    w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s = rec
    mats = [(w_ih_q, (d, 4 * H), "w_ih"), (w_hh_q, (d, 4 * H), "w_hh"), (w_hr_q, (H, d), "w_hr")]
    scales = [(w_ih_s, 4 * H), (w_hh_s, 4 * H), (w_hr_s, d)]
    biases = [(bias, 4 * H)]
    if ffn is not None:
        ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps = ffn
        F = ff1_q.shape[-1]
        mats += [(ff1_q, (d, F), "ff1"), (ff2_q, (F, d), "ff2")]
        scales += [(ff1_s, F), (ff2_s, d)]
        biases += [(ff1_b, F), (ff2_b, d)]
        _check(eps.reshape(-1), torch.float32, (n,), f"{what} eps")
    for w, shape, name in mats:
        _check(w, torch.int8, lead + shape, f"{what} {name}")
        if w.data_ptr() % 4:
            raise ValueError(f"{what} {name}: weights must be 4-byte aligned")
    for s, n_out in scales:
        _check(s.reshape(-1), torch.float32, (n * n_out,), f"{what} scale")
    for b, n_out in biases:
        _check(b.reshape(-1), b.dtype, (n * n_out,), f"{what} bias")
        _bias_flag(b, what)


def _n_pulls_arg(n_pulls, S: int, P: int, device, what: str) -> torch.Tensor:
    if n_pulls is None:
        return torch.full((S,), P, dtype=torch.int32, device=device)
    _check(n_pulls, torch.int32, (S,), f"{what} n_pulls")
    return n_pulls


def _smem_check(rc: int, what: str, shape: str) -> None:
    """A C entry returns minus the shared-memory bytes a block would need
    where they exceed this device's limit."""
    if rc < 0:
        raise ValueError(f"{what}: {shape} needs {-rc} bytes of shared memory per block, more "
                         "than this device allows one block")
    cuda_build.check(rc, what)


def _rec_cuda(entry: str, x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s):
    """The CUDA-core templates of kernels 13 and 14 (csrc/lstm_i8.cu,
    `entry` "lstm_rec_i8_simt" or "lstm_rec_stream_i8_simt")."""
    P, S, d = x.shape
    H = c.shape[1]
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    _check_i8_weights(entry, (), d, H, rec)
    _check(x, torch.float32, (P, S, d), f"{entry} x")
    _check(h, torch.float32, (S, d), f"{entry} h")
    _check(c, torch.float32, (S, H), f"{entry} c")
    if entry == "lstm_rec_stream_i8_simt" and x.data_ptr() % 16:
        raise ValueError(f"{entry} x: must be 16-byte aligned (cp.async copies)")
    n_pulls = _n_pulls_arg(n_pulls, S, P, x.device, entry)
    hseq = torch.empty((P, S, d), dtype=torch.float32, device=x.device)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_i8", entry, 14, 5)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        w_ih_q.data_ptr(), w_ih_s.data_ptr(), w_hh_q.data_ptr(), w_hh_s.data_ptr(),
        bias.data_ptr(), w_hr_q.data_ptr(), w_hr_s.data_ptr(),
        hseq.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        P, S, d, H, _bias_flag(bias, entry),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, entry, f"P={P}, d={d}, hidden={H}")
    return hseq, h2, c2


def _rec_mma_cuda(x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                  stamps=None):
    """Kernel 2: one cooperative launch of csrc/lstm_mma.cu's recurrent
    core, its scratch in one workspace (`lstm_mma.scratch_layout`).
    `stamps` (int64 [nb, 3 + 8 P], or None) receives each block's phase
    times (tools/profile_lstm_mma.py)."""
    entry = "lstm_rec_stream2_i8"
    P, S, d = x.shape
    H = c.shape[1]
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    _check_i8_weights(entry, (), d, H, rec)
    _check(x, torch.float32, (P, S, d), f"{entry} x")
    _check(h, torch.float32, (S, d), f"{entry} h")
    _check(c, torch.float32, (S, H), f"{entry} c")
    n_pulls = _n_pulls_arg(n_pulls, S, P, x.device, entry)
    plan = lstm_mma.device_plan(S, d, H, 0, x.device)
    hseq = torch.empty((P, S, d), dtype=torch.float32, device=x.device)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    nbytes, offsets = lstm_mma.scratch_layout(plan, P)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = cuda_build.bind("lstm_mma", entry, 21, 17)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in rec), hseq.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        *(ws.data_ptr() + o for o in offsets), None if stamps is None else stamps.data_ptr(),
        P, S, d, H, _bias_flag(bias, entry), plan.sp, plan.dp, plan.hp, plan.ub, plan.nb,
        *plan.gate.ints(), *plan.proj.ints(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, entry, f"d={d}, hidden={H}")
    return hseq, h2, c2


def _rec_hoist_cuda(entry: str, x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q,
                    w_hr_s, plan=None, stamps=None):
    """Kernels 14 and 13 (`entry` "lstm_rec_stream_i8" or "lstm_rec_i8",
    the count it adds to): csrc/lstm_hoist.cu's phase A (x quantized, the
    x-side gate product into gx [P][S][4H]) and phase B (one cooperative
    launch of the recurrence), planned by `lstm_mma.rec_hoist_plan`, the
    scratch in one workspace (`lstm_mma.hoist_scratch`). `plan` (None: the
    device's `rec_hoist_plan`) and `stamps` (int64 [nb, 3 + 8 P], or None:
    each block's phase B times) serve tools/profile_lstm_mma.py."""
    P, S, d = x.shape
    H = c.shape[1]
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    _check_i8_weights(entry, (), d, H, rec)
    _check(x, torch.float32, (P, S, d), f"{entry} x")
    _check(h, torch.float32, (S, d), f"{entry} h")
    _check(c, torch.float32, (S, H), f"{entry} c")
    n_pulls = _n_pulls_arg(n_pulls, S, P, x.device, entry)
    plan = plan or lstm_mma.device_hoist_plan(S, d, H, x.device)
    hseq = torch.empty((P, S, d), dtype=torch.float32, device=x.device)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    nbytes, offsets = lstm_mma.hoist_scratch(plan, P)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = cuda_build.bind("lstm_hoist", "lstm_rec_hoist_i8", 22, 18)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in rec), hseq.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        *(ws.data_ptr() + o for o in offsets), None if stamps is None else stamps.data_ptr(),
        P, S, d, H, _bias_flag(bias, entry), plan.sp, plan.dp, plan.hp,
        lstm_mma._up(P * S, lstm_mma.FFN_TILE), plan.ub, plan.nb, *plan.gate.ints(),
        *plan.proj.ints(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, entry, f"d={d}, hidden={H}")
    return hseq, h2, c2


def _rec(entry: str, x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s, n_pulls):
    args = (x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    if x.device.type == "cpu":
        return lstm_rec_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    (P, S, d), H = x.shape, c.shape[1]
    if entry.endswith("_simt"):
        return _rec_cuda(entry, *args)
    if entry == "lstm_rec_stream2_i8":
        # kernel 2 where its stationary weights fit, else kernel 14 (the
        # same function bit for bit; ops/lstm_mma.py `rec_route`)
        if lstm_mma.device_route("rec", S, d, H, 0, x.device) == "mma":
            return _rec_mma_cuda(*args)
        entry = "lstm_rec_stream_i8"
    # kernels 13 and 14 where their plan has a launch, else their CUDA-core
    # templates: chosen by shape (ops/lstm_mma.py `hoist_route`)
    if lstm_mma.device_route("hoist", S, d, H, 0, x.device) == "hoist":
        return _rec_hoist_cuda(entry, *args)
    return _rec_cuda(entry + "_simt", *args)


def lstm_layer_chunk_rec_stream2_i8(
    x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
    n_pulls: Optional[torch.Tensor] = None,
):
    """Kernel 2, the engine's recurrent core: x [P, S, d], h [S, d], c [S, H],
    n_pulls optional [S] i32 prefix lengths -> (hseq [P, S, d], h' [S, d],
    c' [S, H]). One persistent launch: every step's x rows quantized first,
    the layer's weights stationary in shared memory, int8 tensor-core dots.
    Where those weights do not fit a block, kernel 14 (counted as
    `lstm_rec_stream_i8`)."""
    return _rec("lstm_rec_stream2_i8", x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q,
                w_hr_s, n_pulls)


def lstm_layer_chunk_rec_i8(
    x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
    n_pulls: Optional[torch.Tensor] = None,
):
    """Kernel 13: kernel 2's contract with the whole chunk's x consumed
    before the time loop (csrc/lstm_hoist.cu, as kernel 14; no limit on P
    but the gx scratch). Where its plan has no launch, its CUDA-core
    template (`lstm_layer_chunk_rec_i8_simt`)."""
    return _rec("lstm_rec_i8", x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                n_pulls)


def lstm_layer_chunk_rec_stream_i8(
    x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
    n_pulls: Optional[torch.Tensor] = None,
):
    """Kernel 14: kernel 2's contract as a hoisted x-side gate product and
    one persistent recurrence launch (csrc/lstm_hoist.cu). Where its plan
    has no launch, its CUDA-core template
    (`lstm_layer_chunk_rec_stream_i8_simt`)."""
    return _rec("lstm_rec_stream_i8", x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q,
                w_hr_s, n_pulls)


def lstm_layer_chunk_rec_i8_simt(
    x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
    n_pulls: Optional[torch.Tensor] = None,
):
    """Kernel 13's CUDA-core template (csrc/lstm_i8.cu `<2, X_STAGED>`,
    counted as `lstm_rec_i8_simt`): every step's `_rowq8(x)` staged in the
    block's shared memory at its start (raises ValueError with the bytes
    where a P does not fit); the plain version for CPU tensors."""
    return _rec("lstm_rec_i8_simt", x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q,
                w_hr_s, n_pulls)


def lstm_layer_chunk_rec_stream_i8_simt(
    x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
    n_pulls: Optional[torch.Tensor] = None,
):
    """Kernel 14's CUDA-core template (csrc/lstm_i8.cu `<4, X_ASYNC>`,
    counted as `lstm_rec_stream_i8_simt`): 4-session tiles, x_{t+1} copied
    by cp.async while step t computes (x must be 16-byte aligned); the
    plain version for CPU tensors."""
    return _rec("lstm_rec_stream_i8_simt", x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q,
                w_hr_s, n_pulls)


def ffn_norm_plain(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, dot=_int_dot,
                   norm_d=None):
    y = x.float() + hseq
    mid = _q8_mm(y, ff1_q, ff1_s.reshape(1, -1), dot) + ff1_b.float().reshape(1, -1)
    mid = mid * sigmoid(mid - 1.0)
    ff = _q8_mm(mid, ff2_q, ff2_s.reshape(1, -1), dot) + ff2_b.float().reshape(1, -1)
    return basic_norm_plain(y + ff, eps, norm_d)


def _ffn_args(what: str, x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps):
    """Checks kernel 3's operands; returns (R, d, F)."""
    R, d = x.shape
    F = ff1_q.shape[1]
    _check(x, torch.float32, (R, d), f"{what} x")
    _check(hseq, torch.float32, (R, d), f"{what} hseq")
    _check(ff1_q, torch.int8, (d, F), f"{what} ff1")
    _check(ff2_q, torch.int8, (F, d), f"{what} ff2")
    _check(ff1_s.reshape(-1), torch.float32, (F,), f"{what} ff1 scale")
    _check(ff2_s.reshape(-1), torch.float32, (d,), f"{what} ff2 scale")
    _check(ff1_b.reshape(-1), ff1_b.dtype, (F,), f"{what} ff1 bias")
    _check(ff2_b.reshape(-1), ff2_b.dtype, (d,), f"{what} ff2 bias")
    _check(eps.reshape(-1), torch.float32, (1,), f"{what} eps")
    return R, d, F


def ffn_norm_cuda(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, norm_d=None):
    """Kernel 3 (csrc/ffn_mma.cu): the five tensor-core passes of
    `lstm_mma.ffn_plan` (cached, `ffn_launch`) in stream order, its scratch
    in one workspace from the caching allocator."""
    what = "ffn_norm_i8"
    R, d, F = _ffn_args(what, x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    plan, nbytes, offsets = lstm_mma.ffn_launch(R, d, F)
    if x.data_ptr() % 16 or hseq.data_ptr() % 16:
        raise ValueError(f"{what}: x and hseq must be 16-byte aligned (float4 rows)")
    for w, name in ((ff1_q, "ff1"), (ff2_q, "ff2")):
        if w.data_ptr() % 4:
            raise ValueError(f"{what} {name}: weights must be 4-byte aligned")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    fn = cuda_build.bind("ffn_mma", "ffn_norm_mma", 16, 8)
    cuda_build.COUNTS[what] += 1
    rc = fn(
        x.data_ptr(), hseq.data_ptr(), ff1_q.data_ptr(), ff1_s.data_ptr(), ff1_b.data_ptr(),
        ff2_q.data_ptr(), ff2_s.data_ptr(), ff2_b.data_ptr(), eps.data_ptr(), out.data_ptr(),
        *(ws.data_ptr() + o for o in offsets),
        R, d, F, plan.dp, plan.fp, _bias_flag(ff1_b, what), _bias_flag(ff2_b, what),
        _norm_width(norm_d, d, what), torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, what)
    return out


def ffn_norm_i8_simt(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, rows=16):
    """The CUDA-core kernel 3 that csrc/ffn_mma.cu replaced (csrc/lstm_i8.cu
    `ffn_norm_i8_simt`: row tiles of `rows` = 16, 8 or 4, the [rows][F] mid
    tile in shared memory), counted as `ffn_norm_i8_simt`: the yardstick
    chip_smoke.py holds kernel 3 to, bit for bit (CUDA tensors; the plain
    version for CPU tensors)."""
    what = "ffn_norm_i8_simt"
    if x.device.type == "cpu":
        return ffn_norm_plain(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    R, d, F = _ffn_args(what, x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    if d % 4 or F % 4:
        raise ValueError(f"{what}: d_model and ffn must be multiples of 4")
    y = torch.empty_like(x)
    fn = cuda_build.bind("lstm_i8", what, 10, 6)
    cuda_build.COUNTS[what] += 1
    rc = fn(
        x.data_ptr(), hseq.data_ptr(), ff1_q.data_ptr(), ff1_s.data_ptr(),
        ff1_b.data_ptr(), ff2_q.data_ptr(), ff2_s.data_ptr(), ff2_b.data_ptr(),
        eps.data_ptr(), y.data_ptr(),
        R, d, F, _bias_flag(ff1_b, what), _bias_flag(ff2_b, what), rows,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, what, f"d={d}, ffn={F}, {rows} rows")
    return y


def ffn_norm_i8(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, *, norm_d=None):
    """Kernel 3: x/hseq [R, d] -> BasicNorm((x + hseq) + FFN(x + hseq))
    [R, d], its mean over norm_d columns (all where None); the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return ffn_norm_plain(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps,
                              norm_d=norm_d)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_norm_i8: unsupported device {x.device}")
    return ffn_norm_cuda(x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, norm_d)


def lstm_chunk_i8_plain(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                        ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls=None):
    P, S, d = x.shape
    hseq, h2, c2 = lstm_rec_plain(x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias,
                                  w_hr_q, w_hr_s)
    y = ffn_norm_plain(x.reshape(P * S, d), hseq.reshape(P * S, d),
                       ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    return y.reshape(P, S, d), h2, c2


def _chunk_args(what: str, x, h, c, rec, ffn, n_pulls):
    """Checks kernel 11's operands; returns (P, S, d, H, F, n_pulls as i32)."""
    P, S, d = x.shape
    H = c.shape[1]
    F = ffn[0].shape[1]
    _check_i8_weights(what, (), d, H, rec, ffn)
    _check(x, torch.float32, (P, S, d), f"{what} x")
    _check(h, torch.float32, (S, d), f"{what} h")
    _check(c, torch.float32, (S, H), f"{what} c")
    return P, S, d, H, F, _n_pulls_arg(n_pulls, S, P, x.device, what)


def _chunk_hoist_cuda(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                      ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls=None, plan=None,
                      stamps=None):
    """Kernel 11 (csrc/lstm_hoist.cu `lstm_chunk_hoist_i8`): kernel 14's
    phase A, then one cooperative launch of its phase B and kernel 3's five
    passes, planned by `lstm_mma.chunk_hoist_plan`, the scratch in one
    workspace (`ChunkPlan.scratch`). `plan` (None: the device's) and
    `stamps` (int64 [nb, 13 + 8 P], or None: each block's phase times)
    serve tools/profile_lstm_mma.py."""
    entry = "lstm_chunk_i8"
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    ffn = (ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    P, S, d, H, F, n_pulls = _chunk_args(entry, x, h, c, rec, ffn, n_pulls)
    if x.data_ptr() % 16:
        raise ValueError(f"{entry} x: must be 16-byte aligned (float4 rows)")
    plan = plan or lstm_mma.device_chunk_hoist_plan(S, P, d, H, F, x.device)
    rp = plan.rec
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    nbytes, offsets = plan.scratch()
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = cuda_build.bind("lstm_hoist", "lstm_chunk_hoist_i8", 36, 22)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in rec + ffn), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        *(ws.data_ptr() + o for o in offsets), None if stamps is None else stamps.data_ptr(),
        P, S, d, H, F, _bias_flag(bias, entry), _bias_flag(ff1_b, entry),
        _bias_flag(ff2_b, entry), rp.sp, rp.dp, rp.hp, plan.ffn.fp, plan.ffn.rp, rp.ub, plan.nb,
        *rp.gate.ints(), *rp.proj.ints(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, entry, f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def _chunk_simt_cuda(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                     ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls=None):
    """Kernel 11's CUDA-core template (csrc/lstm_chunk_i8.cu: one block a
    2-session tile for all P steps, the FFN inside the time loop)."""
    entry = "lstm_chunk_i8_simt"
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    ffn = (ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    P, S, d, H, F, n_pulls = _chunk_args(entry, x, h, c, rec, ffn, n_pulls)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_chunk_i8", "lstm_chunk_i8", 21, 8)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in rec + ffn),
        y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        P, S, d, H, F, _bias_flag(bias, entry), _bias_flag(ff1_b, entry),
        _bias_flag(ff2_b, entry),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, entry, f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def lstm_layer_chunk_fused_i8(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                              ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls=None):
    """Kernel 11, the whole int8 chunk layer: x [P, S, d], h [S, d], c [S, H],
    n_pulls optional [S] i32 -> (y [P, S, d], h' [S, d], c' [S, H]). y comes
    from the ungated h_new; h/c are kept where t >= n_pulls. On CUDA one
    persistent launch after kernel 14's phase A (csrc/lstm_hoist.cu); where
    its plan has no launch, its template (`lstm_layer_chunk_fused_i8_simt`),
    chosen by shape (ops/lstm_mma.py `chunk_route`)."""
    args = (x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
            ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls)
    if x.device.type == "cpu":
        return lstm_chunk_i8_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_chunk_i8: unsupported device {x.device}")
    (P, S, d), H, F = x.shape, c.shape[1], ff1_q.shape[-1]
    if lstm_mma.device_route("chunk", S, d, H, F, x.device) == "hoist":
        return _chunk_hoist_cuda(*args)
    return _chunk_simt_cuda(*args)


def lstm_layer_chunk_fused_i8_simt(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                                   ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls=None):
    """Kernel 11's CUDA-core template (csrc/lstm_chunk_i8.cu, counted as
    `lstm_chunk_i8_simt`): the TPU kernel's schedule, each step's FFN inside
    the time loop; the plain version for CPU tensors."""
    args = (x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
            ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, n_pulls)
    if x.device.type == "cpu":
        return lstm_chunk_i8_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_chunk_i8_simt: unsupported device {x.device}")
    return _chunk_simt_cuda(*args)


def _gate_blend(gate, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """`gt * new + (1 - gt) * old` for a [S] gate (None: new)."""
    if gate is None:
        return new
    g = gate.float()[:, None]
    return g * new + (1.0 - g) * old


def lstm_layer_fused_i8_plain(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                              ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None, *,
                              norm_d=None):
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
    y = ffn_norm_plain(x, h_new, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, norm_d=norm_d)
    return y, _gate_blend(gate, h_new, h), _gate_blend(gate, c_new, c)


def _gate_arg(gate, S: int, what: str):
    """The gate as a contiguous f32 [S] tensor, or None (ungated)."""
    if gate is None:
        return None
    g = gate.to(torch.float32).contiguous()
    _check(g, torch.float32, (S,), f"{what} gate")
    return g


def _step_args(what: str, x, h, c, rec, ffn, gate):
    """Checks kernel 7's operands; returns (S, d, H, F, gate as f32 or None)."""
    S, d = x.shape
    H = c.shape[1]
    F = ffn[0].shape[1]
    _check_i8_weights(what, (), d, H, rec, ffn)
    _check(x, torch.float32, (S, d), f"{what} x")
    _check(h, torch.float32, (S, d), f"{what} h")
    _check(c, torch.float32, (S, H), f"{what} c")
    return S, d, H, F, _gate_arg(gate, S, what)


def lstm_layer_fused_i8_cuda(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                             ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None,
                             stamps=None, norm_d=None):
    """Kernel 7: one cooperative launch of csrc/lstm_mma.cu's layer step,
    its scratch in one workspace (`lstm_mma.scratch_layout`). `stamps`
    (int64 [nb, 18], or None) receives each block's phase times
    (tools/profile_lstm_mma.py)."""
    entry = "lstm_step_i8"
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    ffn = (ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    S, d, H, F, g = _step_args(entry, x, h, c, rec, ffn, gate)
    plan = lstm_mma.device_plan(S, d, H, F, x.device)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    nbytes, offsets = lstm_mma.scratch_layout(plan)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = cuda_build.bind("lstm_mma", entry, 32, 25)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
        *(t.data_ptr() for t in rec + ffn), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        *(ws.data_ptr() + o for o in offsets), None if stamps is None else stamps.data_ptr(),
        S, d, H, F, _bias_flag(bias, entry), _bias_flag(ff1_b, entry), _bias_flag(ff2_b, entry),
        plan.sp, plan.dp, plan.hp, plan.fp, plan.ub, plan.nb, *plan.gate.ints(), *plan.proj.ints(),
        *plan.ff1.ints(), _norm_width(norm_d, d, entry),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, entry, f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def lstm_layer_fused_i8_simt_cuda(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                                  ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None,
                                  norm_d=None):
    """The three-pass CUDA-core step that kernel 7 replaced
    (csrc/lstm_step.cu `lstm_step_i8_simt`: gate pass, projection pass,
    4-row FFN pass); the oracle chip_smoke.py holds kernel 7 to, bit for
    bit, and kernel 7's route where kernel 7 has no plan."""
    entry = "lstm_step_i8_simt"
    rec = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s)
    ffn = (ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps)
    S, d, H, F, g = _step_args(entry, x, h, c, rec, ffn, gate)
    dev = x.device
    hc = torch.empty((S, H), dtype=torch.float32, device=dev)
    hn = torch.empty((S, d), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_step", entry, 23, 8)
    cuda_build.COUNTS[entry] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), None if g is None else g.data_ptr(),
        *(t.data_ptr() for t in rec + ffn),
        hc.data_ptr(), hn.data_ptr(), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        S, d, H, F, _bias_flag(bias, entry), _bias_flag(ff1_b, entry), _bias_flag(ff2_b, entry),
        _norm_width(norm_d, d, entry), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, entry)
    return y, h2, c2


def lstm_layer_fused_i8_simt(*args):
    """`lstm_layer_fused_i8`'s contract on the three-pass step (CUDA
    tensors; the plain version for CPU tensors)."""
    x = args[0]
    if x.device.type == "cpu":
        return lstm_layer_fused_i8_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step_i8_simt: unsupported device {x.device}")
    return lstm_layer_fused_i8_simt_cuda(*args)


def lstm_layer_fused_i8(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                        ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None, *, norm_d=None):
    """One int8 layer timestep: x, h [S, d], c [S, H] f32, gate optional [S]
    -> (y [S, d], h' [S, d], c' [S, H]), all f32, the norm's mean over
    norm_d columns (all where None). On CUDA kernel 7, or where its weights
    do not fit a block the three-pass step (counted as
    `lstm_step_i8_simt`)."""
    args = (x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
            ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate)
    if x.device.type == "cpu":
        return lstm_layer_fused_i8_plain(*args, norm_d=norm_d)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_step_i8: unsupported device {x.device}")
    # kernel 7 where its stationary weights fit, else the three-pass step
    # (the same function bit for bit; ops/lstm_mma.py `step_route`)
    (S, d), H, F = x.shape, c.shape[1], ff1_q.shape[-1]
    if lstm_mma.device_route("step", S, d, H, F, x.device) == "mma":
        return lstm_layer_fused_i8_cuda(*args, norm_d=norm_d)
    return lstm_layer_fused_i8_simt_cuda(*args, norm_d=norm_d)
