"""Kernels 16 and 17: the conv embed of every pull window straight from the
front buffer.

Ports of `conv_embed_windows` (kernel 16, `_win_kernel`) and
`conv_embed_from_front` (kernel 17, `_kernel`) of
april_asr_tpu/ops/conv_embed_pallas.py. Both map the un-stacked front buffer
[S, W, mel] (W = (P-1)*step + seg) to every window's embedding [P, S, d],
each window zero-padded on its own, as `conv_subsample` over the stacked
windows computes it, with the TPU kernels' numerics: activations rounded to
bf16 before each product (x, the conv1 taps, the conv1 activations, y2, y3)
and f32 sums. At bf16 conv weights these are exactly the rounding points of
the stacked embed. Kernel 16 recomputes conv1 per window; kernel 17 computes
it once per buffer row and corrects each window's edge rows, so the two agree
to f32 rounding, not bit for bit.

One CUDA kernel serves both entries (csrc/conv_embed.cu), each entry with
its own launch count (`conv_embed`, `conv_embed_front`). The plain version,
which a CPU tensor takes, is the stacked windows through `conv_subsample`
with the conv and projection weights as bf16: the same function. A CUDA
tensor launches the kernel or raises, with the bytes where a shape exceeds
the kernel's shared-memory plan; it never falls back.

The im2col weight forms (w2k, w3k) and the (freq, ch)-ordered projection
weight are derived once per weights dict (`embed_weight_forms`), zero-padded
to the widths the kernel takes (conv channels 2 and 3 to multiples of 8,
d_model to an even width; ops/widths.py): a padded channel's activations
are DoubleSwish(0) = 0, and the padded output columns are cut off.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cuda_build
from .widths import round_up, zero_pad

EMBED_KEYS = ("conv1_w", "conv2_w", "conv3_w", "embed_out_w")
_BIAS_KEYS = ("conv1_b", "conv2_b", "conv3_b", "embed_out_b")


def front_embed_supported(seg: int, mel: int, P: int, step: int, W: int, S: int,
                          block_s: int = 8) -> bool:
    """The JAX package's geometry gate (conv_embed_pallas.py
    `front_embed_supported`): the 3x3 conv stack (pad 1 stride 1, then two
    valid stride 2) must collapse a window's time axis to one output row,
    and S must split into whole blocks of `block_s` sessions. The CUDA
    kernel takes any S; its callers pass block_s=1."""
    if seg < 3 or (seg - 3) % 2 or mel < 5:
        return False
    t2 = (seg - 3) // 2 + 1
    if t2 < 3 or (t2 - 3) // 2 + 1 != 1:
        return False
    return W == (P - 1) * step + seg and S % block_s == 0 and P >= 1


_FORMS: Dict[tuple, tuple] = {}


def embed_weight_forms(params) -> Dict[str, torch.Tensor]:
    """The kernel's weight forms, derived once per weights dict (cached by
    the identity of its conv and projection weights and biases): the
    bf16-rounded conv1
    taps [c1, 9] f32, w2k [9*c1, c2] and w3k [9*c2, c3] bf16 with rows
    ordered (dt, df, cin), the projection weight [f3*c3, d] bf16 with rows
    ordered (freq, ch) (the stored rows are (ch, freq)), and f32 biases;
    c2 and c3 zero-padded to multiples of 8 and d to an even width."""
    src = tuple(params[k] for k in EMBED_KEYS + _BIAS_KEYS)
    key = tuple(id(t) for t in src)
    hit = _FORMS.get(key)
    if hit is not None:
        return hit[1]
    c1, c2, c3 = (params[k].shape[0] for k in EMBED_KEYS[:3])
    w_out = params["embed_out_w"]
    f3, d = w_out.shape[0] // c3, w_out.shape[1]
    c2p, c3p, dp = round_up(c2, 8), round_up(c3, 8), round_up(d, 2)
    bf = torch.bfloat16
    w2 = zero_pad(params["conv2_w"].permute(2, 3, 1, 0), (3, 3, c1, c2p))
    w3 = zero_pad(params["conv3_w"].permute(2, 3, 1, 0), (3, 3, c2p, c3p))
    wo = zero_pad(w_out.reshape(c3, f3, d), (c3p, f3, dp))
    forms = {
        "w1": params["conv1_w"].reshape(c1, 9).to(bf).float().contiguous(),
        "b1": params["conv1_b"].float().contiguous(),
        "w2k": w2.reshape(9 * c1, c2p).to(bf).contiguous(),
        "b2": zero_pad(params["conv2_b"].float(), (c2p,)).contiguous(),
        "w3k": w3.reshape(9 * c2p, c3p).to(bf).contiguous(),
        "b3": zero_pad(params["conv3_b"].float(), (c3p,)).contiguous(),
        "wo": wo.permute(1, 0, 2).reshape(f3 * c3p, dp).to(bf).contiguous(),
        "bo": zero_pad(params["embed_out_b"].float(), (dp,)).contiguous(),
    }
    if len(_FORMS) >= 16:
        _FORMS.clear()
    _FORMS[key] = (src, forms)  # holding `src` keeps its ids from being reused
    return forms


def conv_embed_plain(params, front: torch.Tensor, P: int, step: int, seg: int) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the stacked windows through
    `conv_subsample` on bf16 conv and projection weights -> [P, S, d]."""
    from ..models.lstm_transducer import conv_subsample

    S, _, mel = front.shape
    p = dict(params)
    for k in EMBED_KEYS:
        p[k] = params[k].to(torch.bfloat16)
    windows = torch.stack([front[:, j * step : j * step + seg] for j in range(P)])
    return conv_subsample(p, windows.reshape(P * S, seg, mel))[:, 0, :].reshape(P, S, -1)


def _conv_embed_cuda(params, front: torch.Tensor, P: int, step: int, seg: int,
                     from_front: bool) -> torch.Tensor:
    name = "conv_embed_front" if from_front else "conv_embed"
    S, W, mel = front.shape
    if front.dtype != torch.float32 or not front.is_contiguous():
        raise ValueError(f"{name}: front must be contiguous float32")
    if not front_embed_supported(seg, mel, P, step, W, S, block_s=1):
        raise ValueError(f"{name}: unsupported geometry seg={seg} mel={mel} P={P} step={step} W={W}")
    w = embed_weight_forms(params)
    c1, c2, c3 = w["w1"].shape[0], w["w2k"].shape[1], w["w3k"].shape[1]
    d = w["wo"].shape[1]  # the padded widths (`embed_weight_forms`)
    for k, t in w.items():
        if t.device != front.device:
            raise ValueError(f"{name}: weight {k} on {t.device}, front on {front.device}")
    d_model = params["embed_out_w"].shape[1]
    out = torch.empty((P, S, d), dtype=torch.float32, device=front.device)
    if S == 0:
        return out[..., :d_model]
    fn = cuda_build.bind("conv_embed", "conv_embed", 10, 11)
    rc = fn(
        front.data_ptr(), w["w1"].data_ptr(), w["b1"].data_ptr(), w["w2k"].data_ptr(),
        w["b2"].data_ptr(), w["w3k"].data_ptr(), w["b3"].data_ptr(), w["wo"].data_ptr(),
        w["bo"].data_ptr(), out.data_ptr(),
        S, W, mel, P, step, seg, c1, c2, c3, d, int(from_front),
        torch.cuda.current_stream(front.device).cuda_stream,
    )
    if rc < 0:
        raise ValueError(
            f"{name}: mel={mel} c=({c1}, {c2}, {c3}) P={P} need {-rc} bytes of shared memory per "
            "block, more than this device allows one block"
        )
    cuda_build.check(rc, name)
    cuda_build.COUNTS[name] += 1
    return out if d == d_model else out[..., :d_model].contiguous()


def _dispatch(params, front, P, step, seg, from_front):
    if front.device.type == "cpu":
        return conv_embed_plain(params, front, P, step, seg)
    if front.device.type != "cuda":
        raise ValueError(f"conv_embed: unsupported device {front.device}")
    return _conv_embed_cuda(params, front, P, step, seg, from_front)


def conv_embed_windows(params, front: torch.Tensor, *, P: int, step: int, seg: int) -> torch.Tensor:
    """Kernel 16: [S, W, mel] front -> [P, S, d], conv1 per window."""
    return _dispatch(params, front, P, step, seg, from_front=False)


def conv_embed_from_front(params, front: torch.Tensor, *, P: int, step: int, seg: int) -> torch.Tensor:
    """Kernel 17: [S, W, mel] front -> [P, S, d], conv1 once per buffer row
    with each window's edge rows corrected."""
    return _dispatch(params, front, P, step, seg, from_front=True)
