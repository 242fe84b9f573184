"""Kernel 15: a slab of int8 residual LSTMP layers on the wavefront schedule.

Port of april_asr_tpu/ops/lstm_wavefront_pallas.py. `lstm_slab_wavefront_i8`
runs Lk stacked layers (FFN and BasicNorm included) over a [P, S, d] chunk
on the anti-diagonal schedule: at diagonal D every layer l with
0 <= D - l < P does its step t = D - l, so the layers' recurrences overlap
(csrc/lstm_wavefront.cu: one launch per diagonal, the inter-layer ring
double-buffered by diagonal parity). `stack_wavefront_i8` runs the whole
stack as slabs of `slab` layers that hand off through one [P, S, d] tensor.

The function is the layer-major stack's (kernel 11 per layer, or kernels 2 +
3): the same per-row quantization and op order, so only the schedule
differs. y is computed from the ungated h_new; a layer's h/c are kept where
t >= n_pulls. The plain version (`lstm_slab_wavefront_plain`) is that
layer-major stack over the slab.

The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import torch

from . import cuda_build
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


def lstm_slab_wavefront_cuda(x, h, c, *weights, n_pulls=None):
    P, S, d = x.shape
    Lk, _, H = c.shape
    rec, ffn = weights[:7], weights[7:]
    _check_i8_weights("lstm_wavefront_i8", (Lk,), d, H, rec, ffn)
    _check(x, torch.float32, (P, S, d), "lstm_wavefront_i8 x")
    _check(h, torch.float32, (Lk, S, d), "lstm_wavefront_i8 h")
    _check(c, torch.float32, (Lk, S, H), "lstm_wavefront_i8 c")
    n_pulls = _n_pulls_arg(n_pulls, S, P, x.device, "lstm_wavefront_i8")
    ring = torch.empty((2, Lk, S, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h2 = torch.empty_like(h)
    c2 = torch.empty_like(c)
    bias, ff1_b, ff2_b = weights[4], weights[9], weights[12]
    fn = cuda_build.bind("lstm_wavefront", "lstm_wavefront_i8", 22, 9)
    cuda_build.COUNTS["lstm_wavefront_i8"] += 1
    rc = fn(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), n_pulls.data_ptr(),
        *(t.data_ptr() for t in weights),
        ring.data_ptr(), y.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        P, S, d, H, ffn[0].shape[-1], Lk, _bias_flag(bias, "lstm_wavefront_i8"),
        _bias_flag(ff1_b, "lstm_wavefront_i8"), _bias_flag(ff2_b, "lstm_wavefront_i8"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _smem_check(rc, "lstm_wavefront_i8", f"d={d}, hidden={H}, ffn={ffn[0].shape[-1]}")
    return y, h2, c2


def lstm_slab_wavefront_i8(x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                           ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, norm_eps, n_pulls=None):
    """x [P, S, d] f32 slab input, h [Lk, S, d], c [Lk, S, H], the stacked
    per-layer int8 weights (leading dim Lk, `quantize_weights` layout),
    n_pulls optional [S] i32 -> (y [P, S, d], h2 [Lk, S, d], c2 [Lk, S, H])."""
    weights = (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
               ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, norm_eps)
    if x.device.type == "cpu":
        return lstm_slab_wavefront_plain(x, h, c, *weights, n_pulls=n_pulls)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_wavefront_i8: unsupported device {x.device}")
    return lstm_slab_wavefront_cuda(x, h, c, *weights, n_pulls=n_pulls)


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
