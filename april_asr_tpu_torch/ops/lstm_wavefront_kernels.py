"""Kernel 15: a slab of int8 residual LSTMP layers on the wavefront schedule.

Port of april_asr_tpu/ops/lstm_wavefront_pallas.py. `lstm_slab_wavefront_i8`
runs Lk stacked layers (FFN and BasicNorm included) over a [P, S, d] chunk
on the anti-diagonal schedule: at diagonal D every layer l with
0 <= D - l < P does its step t = D - l, so the layers' recurrences overlap.
`stack_wavefront_i8` runs the whole stack as slabs of `slab` layers that
hand off through one [P, S, d] tensor.

On the card the slab is one cooperative launch (csrc/lstm_wavefront_hoist.cu,
`_wavefront_hoist_cuda`, planned by ops/lstm_mma.py `wavefront_plan`): per
diagonal the gate tiles, hcq, the projection tiles and kernel 3's five
passes over every live layer at once, on int8 tensor-core tiles, a grid
barrier after each phase, the inter-layer ring double-buffered by diagonal
parity. Its plan has a launch at every shape the wrapper takes. The
CUDA-core template it replaced (csrc/lstm_wavefront.cu: one launch per
diagonal, blocks of 2 sessions x 1 layer) stays as
`lstm_wavefront_i8_simt`, the reference that chip_smoke.py holds it to bit
for bit.

The function is the layer-major stack's (kernel 11 per layer, or kernels 2 +
3): the same per-row quantization and op order, so only the schedule
differs. y is computed from the ungated h_new; a layer's h/c are kept where
t >= n_pulls. The plain version (`lstm_slab_wavefront_plain`) is that
layer-major stack over the slab.

The wrappers take the plain version for CPU tensors and launch a kernel for
CUDA tensors; they never fall back.
"""

from __future__ import annotations

import torch

from . import cuda_build, lstm_mma
from .lstm_kernels import (
    LAYER_I8_KEYS,
    _bias_flag,
    _check,
    _check_i8_weights,
    _n_pulls_arg,
    _smem_check,
    lstm_chunk_i8_plain,
)


def lstm_slab_wavefront_plain(x, h, c, *weights, n_pulls=None):
    """The layer-major stack over the slab: each layer's whole chunk in turn."""
    y, hs, cs = x, [], []
    for l in range(h.shape[0]):
        y, h2, c2 = lstm_chunk_i8_plain(y, h[l], c[l], *(w[l] for w in weights), n_pulls)
        hs.append(h2)
        cs.append(c2)
    return y, torch.stack(hs), torch.stack(cs)


def _slab_args(what: str, x, h, c, weights, n_pulls):
    """Checks kernel 15's operands; returns (P, S, d, H, F, Lk, n_pulls as i32)."""
    P, S, d = x.shape
    Lk, _, H = c.shape
    rec, ffn = weights[:7], weights[7:]
    _check_i8_weights(what, (Lk,), d, H, rec, ffn)
    _check(x, torch.float32, (P, S, d), f"{what} x")
    _check(h, torch.float32, (Lk, S, d), f"{what} h")
    _check(c, torch.float32, (Lk, S, H), f"{what} c")
    return P, S, d, H, ffn[0].shape[-1], Lk, _n_pulls_arg(n_pulls, S, P, x.device, what)


def _flags(weights, what: str):
    return tuple(_bias_flag(weights[k], what) for k in (4, 9, 12))


def _wavefront_hoist_cuda(x, h, c, *weights, n_pulls=None, stamps=None):
    """Kernel 15 (csrc/lstm_wavefront_hoist.cu `lstm_wavefront_hoist_i8`):
    one cooperative launch over the slab's diagonals, planned by
    `lstm_mma.wavefront_plan` for the device, the scratch in one workspace
    (`WavefrontPlan.scratch`). `stamps` (int64 [nb, plan.n_stamps], or
    None: each block's phase times) serves tools/profile_lstm_mma.py."""
    what = "lstm_wavefront_i8"
    P, S, d, H, F, Lk, n_pulls = _slab_args(what, x, h, c, weights, n_pulls)
    if x.data_ptr() % 16:
        raise ValueError(f"{what} x: must be 16-byte aligned (float4 rows)")
    plan = lstm_mma.device_wavefront_plan(S, P, d, H, F, Lk, x.device)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    nbytes, offsets = plan.scratch()
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = cuda_build.bind("lstm_wavefront_hoist", "lstm_wavefront_hoist_i8", 33, 14)
    cuda_build.COUNTS[what] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in weights), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        *(ws.data_ptr() + o for o in offsets), None if stamps is None else stamps.data_ptr(),
        P, S, d, H, F, Lk, *_flags(weights, what), plan.sp, plan.dp, plan.hp, plan.fp, plan.nb,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, what, f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def _wavefront_simt_cuda(x, h, c, *weights, n_pulls=None):
    """Kernel 15's CUDA-core template (csrc/lstm_wavefront.cu: one launch
    per diagonal, blocks of 2 sessions x 1 layer running `layer_step_i8`,
    the ring [2, Lk, S, d] double-buffered by diagonal parity)."""
    what = "lstm_wavefront_i8_simt"
    P, S, d, H, F, Lk, n_pulls = _slab_args(what, x, h, c, weights, n_pulls)
    ring = torch.empty((2, Lk, S, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    fn = cuda_build.bind("lstm_wavefront", "lstm_wavefront_i8", 22, 9)
    cuda_build.COUNTS[what] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in weights),
        ring.data_ptr(), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        P, S, d, H, F, Lk, *_flags(weights, what),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, what, f"d={d}, hidden={H}, ffn={F}")
    return y, h2, c2


def lstm_slab_wavefront_i8(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                           ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, norm_eps, n_pulls=None):
    """x [P, S, d] f32 slab input, h [Lk, S, d], c [Lk, S, H], the stacked
    per-layer int8 weights (leading dim Lk, `quantize_weights` layout),
    n_pulls optional [S] i32 -> (y [P, S, d], h2 [Lk, S, d], c2 [Lk, S, H]).
    On CUDA one cooperative launch (csrc/lstm_wavefront_hoist.cu)."""
    weights = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
               ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, norm_eps)
    if x.device.type == "cpu":
        return lstm_slab_wavefront_plain(x, h, c, *weights, n_pulls=n_pulls)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_wavefront_i8: unsupported device {x.device}")
    return _wavefront_hoist_cuda(x, h, c, *weights, n_pulls=n_pulls)


def lstm_wavefront_i8_simt(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                           ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, norm_eps, n_pulls=None):
    """Kernel 15's CUDA-core template (csrc/lstm_wavefront.cu, counted as
    `lstm_wavefront_i8_simt`), on `lstm_slab_wavefront_i8`'s arguments: the
    reference the new launch is held to on the card; the plain version for
    CPU tensors."""
    weights = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
               ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, norm_eps)
    if x.device.type == "cpu":
        return lstm_slab_wavefront_plain(x, h, c, *weights, n_pulls=n_pulls)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_wavefront_i8_simt: unsupported device {x.device}")
    return _wavefront_simt_cuda(x, h, c, *weights, n_pulls=n_pulls)


def stack_wavefront_i8(params, x, h, c, n_pulls=None, *, slab: int = 6):
    """The whole L-layer stack as sequential wavefront slabs (default 6 + 6
    for the 12-layer encoder); `params` holds the `quantize_weights` int8
    copies. Returns (y [P, S, d], h' [L, S, d], c' [L, S, H])."""
    L = params["w_ih_t_q8"].shape[0]
    y, hs, cs = x, [], []
    for l0 in range(0, L, slab):
        l1 = min(l0 + slab, L)
        y, h2, c2 = lstm_slab_wavefront_i8(
            y, h[l0:l1], c[l0:l1], *(params[k][l0:l1] for k in LAYER_I8_KEYS), n_pulls
        )
        hs.append(h2)
        cs.append(c2)
    return y, torch.cat(hs), torch.cat(cs)
