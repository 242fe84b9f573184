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
it as if once per buffer row and corrects each window's edge rows, so the
two agree to f32 rounding, not bit for bit.

Both on the card are csrc/conv_embed_tile.cu (counts `conv_embed`,
`conv_embed_front`): a persistent conv-stack launch over groups of windows,
planned by `conv_embed_plan` (`front` for kernel 17, which stages each
window's rows from the one above it and runs the CUDA-core kernel's
full-buffer conv1 chain per window), then a tiled projection launch; its
every sum is the CUDA-core kernel's fmaf chain in its order, so the outputs
are equal bit for bit. That kernel, csrc/conv_embed.cu, stays as
`conv_embed_simt` / `conv_embed_front_simt` (counts of the same names) for
the shapes no plan holds. The route reads shapes only. The plain version,
which a CPU tensor takes, is the stacked windows through `conv_subsample`
with the conv and projection weights as bf16: the same function. A CUDA
tensor launches a kernel or raises; it never falls back.

The im2col weight forms (w2k, w3k), the (freq, ch)-ordered projection weight
and its f32 copy for the tiled kernel are derived once per weights dict
(`embed_weight_forms`), zero-padded to the widths the kernels take (conv
channels 2 and 3 to multiples of 8, d_model to an even width; ops/widths.py):
a padded channel's activations are DoubleSwish(0) = 0, and the padded output
columns are cut off.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

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
    ordered (freq, ch) (the stored rows are (ch, freq)), the same widened to
    f32 with its columns zero-padded to a multiple of PJ_BN ("wo32", the
    tiled kernel's), and f32 biases; c2 and c3 zero-padded to multiples of 8
    and d to an even width."""
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
    forms["wo32"] = zero_pad(forms["wo"].float(), (f3 * c3p, round_up(dp, PJ_BN))).contiguous()
    if len(_FORMS) >= 16:
        _FORMS.clear()
    _FORMS[key] = (src, forms)  # holding `src` keeps its ids from being reused
    return forms


# Kernel 16 on the H100 (csrc/conv_embed_tile.cu). The conv stack: CT_NT
# threads a block, conv1's CT_R1 and conv2's CT_R2 rows that conv3 reads,
# CT_CG output channels a lane, CT_PP2 (conv2) and CT_PP3 (conv3) positions
# a lane, conv1 widths CT_C1. The projection: PJ_BM x PJ_BN output tiles,
# PJ_BK k a ring stage, PJ_RING stages behind PJ_BARS bytes of mbarriers.
# Stamps: CE_NSTAMP slots a block row.
CT_NT, CT_R1, CT_R2, CT_CG, CT_PP2, CT_PP3, CT_C1 = 384, 7, 3, 8, 4, 2, (4, 8)
PJ_BM, PJ_BN, PJ_BK, PJ_RING, PJ_BARS = 128, 128, 8, 6, 128
CE_NSTAMP = 7
# the plan's cost model, in one thread's issue slots: a DoubleSwish (its
# tanhf) and a block barrier with the wait for the slowest warp
DSWISH_COST, BARRIER_COST = 20, 400


def _al16(n: int) -> int:
    return -(-n // 16) * 16


def conv_tile_dims(mel: int, c2: int) -> tuple:
    """csrc/conv_embed_tile.cu `ct_dims`: (f2, f3, h1, h2, p2, ws2): conv2's
    and conv3's frequencies, the half widths of conv1's and conv2's even /
    odd frequency planes, conv2's position pitch in bf16 (an odd number of
    16-byte runs) and its window stride in bf16 (likewise)."""
    f2 = (mel - 3) // 2 + 1
    f3 = (f2 - 3) // 2 + 1
    h2 = (f2 + 1) // 2
    p2 = 8 * ((c2 // 8) | 1)
    return f2, f3, (mel + 1) // 2, h2, p2, 6 * h2 * p2 + 8


def staged_rows(seg: int, front: bool) -> int:
    """The front rows csrc/conv_embed_tile.cu stages a window: kernel 16 its
    seg rows; kernel 17 the CT_R1 + 2 buffer rows its conv1 rows 0..CT_R1-1
    read, from the one above the window (at seg 7 the last is the one
    below it; at seg 9 the window's last row, which no conv1 row that conv3
    reads touches, is left out)."""
    return CT_R1 + 2 if front else seg


def conv_embed_smem(nw: int, mel: int, seg: int, c1: int, c2: int, c3: int,
                    front: bool = False) -> int:
    """csrc/conv_embed_tile.cu `ct_layout`: the conv stack's shared-memory
    bytes for groups of nw windows: conv1's taps, the biases, w2 and w3 as
    f32; per window the staged rows (f32, `staged_rows`) or conv2's output
    (bf16), which share a region, and conv1's output (bf16)."""
    _, _, h1, _, _, ws2 = conv_tile_dims(mel, c2)
    weights = (_al16(9 * c1 * 4) + _al16(c1 * 4) + _al16(c2 * 4) + _al16(c3 * 4)
               + _al16(9 * c1 * c2 * 4) + _al16(9 * c2 * c3 * 4))
    rows = _al16(nw * max(staged_rows(seg, front) * (mel + 2) * 4, ws2 * 2))
    return weights + rows + _al16(nw * CT_R1 * 2 * h1 * c1 * 2)


def proj_smem() -> int:
    """csrc/conv_embed_tile.cu `pj_smem`: the projection's mbarriers and
    ring."""
    return PJ_BARS + PJ_RING * PJ_BK * (PJ_BM + PJ_BN) * 4


@dataclasses.dataclass(frozen=True)
class ConvEmbedPlan:
    nw: int         # windows a group
    groups: int     # ceil(P S / nw)
    blocks: int     # persistent conv-stack blocks
    smem: int       # the conv stack's shared memory a block
    mtiles: int     # projection row tiles: ceil(P S / PJ_BM)
    ntiles: int     # projection column tiles
    cols: int       # the f32 weight's columns: ntiles * PJ_BN


def _group_cost(nw: int, mel: int, seg: int, c1: int, c2: int, c3: int,
                front: bool = False) -> int:
    """One group's issue slots on a thread of the conv stack, phase by
    phase as the kernel deals its items: the staged rows (`staged_rows`)
    and conv1 items over the threads, conv2's and conv3's warp items over
    the CT_NT / 32 warps."""
    f2, f3 = conv_tile_dims(mel, c2)[:2]
    up = lambda n, k: -(-n // k)  # noqa: E731
    warps = CT_NT // 32
    stage = up(nw * staged_rows(seg, front) * (mel + 2), CT_NT) * 4
    conv1 = up(nw * CT_R1 * mel, CT_NT) * c1 * (9 + DSWISH_COST)
    items2 = up(nw * CT_R2 * f2, 32 * CT_PP2) * (c2 // CT_CG)
    conv2 = up(items2, warps) * CT_PP2 * CT_CG * (9 * c1 + DSWISH_COST)
    items3 = up(nw * f3, 32 * CT_PP3) * (c3 // CT_CG)
    conv3 = up(items3, warps) * CT_PP3 * CT_CG * (9 * c2 + DSWISH_COST)
    return stage + conv1 + conv2 + conv3 + 4 * BARRIER_COST


@functools.lru_cache(maxsize=None)
def conv_embed_plan(S: int, P: int, mel: int, seg: int, c1: int, c2: int, c3: int, d: int,
                    front: bool = False) -> Optional[ConvEmbedPlan]:
    """Kernel 16's (or with `front`, kernel 17's) launches on
    csrc/conv_embed_tile.cu for S sessions of P windows at the padded widths
    of `embed_weight_forms` (c2, c3 multiples of 8, d even), or None where
    the kernel does not take the shapes (conv1 widths other than CT_C1, a
    geometry off the JAX gate) or no block holds one window's
    intermediates; the route then takes `conv_embed_simt` (or
    `conv_embed_front_simt`). Of the group sizes whose shared memory fits,
    the one with the least rounds x `_group_cost` over the persistent blocks
    (one an SM, at most one a group); on a tie the larger group."""
    # seg 7 or 9 and mel >= 5: the geometries `front_embed_supported` passes
    if (c1 not in CT_C1 or c2 % CT_CG or c3 % CT_CG or c2 < CT_CG or c3 < CT_CG or d % 2
            or S < 1 or P < 1 or seg not in (7, 9) or mel < 5):
        return None
    M = P * S
    best, best_cost = None, None
    for nw in range(1, M + 1):
        smem = conv_embed_smem(nw, mel, seg, c1, c2, c3, front)
        if smem > cuda_build.SMEM_PER_BLOCK:
            break
        groups = -(-M // nw)
        blocks = min(groups, cuda_build.SM_COUNT)
        cost = -(-groups // blocks) * _group_cost(nw, mel, seg, c1, c2, c3, front)
        if best_cost is None or cost <= best_cost:
            best, best_cost = (nw, groups, blocks, smem), cost
    if best is None:
        return None
    ntiles = -(-d // PJ_BN)
    return ConvEmbedPlan(*best, mtiles=-(-M // PJ_BM), ntiles=ntiles, cols=ntiles * PJ_BN)


def embed_plan_for(params, S: int, P: int, mel: int, seg: int, front: bool = False
                   ) -> Optional[ConvEmbedPlan]:
    """`conv_embed_plan` at the padded widths of `params`' weight forms: the
    route of kernel 16 (or 17, `front`) for a CUDA front of S sessions and P
    windows (None: `conv_embed_simt` / `conv_embed_front_simt`)."""
    w = embed_weight_forms(params)
    return conv_embed_plan(S, P, mel, seg, w["w1"].shape[0], w["w2k"].shape[1],
                           w["w3k"].shape[1], w["wo"].shape[1], front)


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


def _cuda_forms(params, front: torch.Tensor, P: int, step: int, seg: int, name: str):
    """The checks every CUDA entry makes, and the weight forms."""
    S, W, mel = front.shape
    if front.dtype != torch.float32 or not front.is_contiguous():
        raise ValueError(f"{name}: front must be contiguous float32")
    if not front_embed_supported(seg, mel, P, step, W, S, block_s=1):
        raise ValueError(f"{name}: unsupported geometry seg={seg} mel={mel} P={P} step={step} W={W}")
    w = embed_weight_forms(params)
    for k, t in w.items():
        if t.device != front.device:
            raise ValueError(f"{name}: weight {k} on {t.device}, front on {front.device}")
    return w


def _simt(params, front: torch.Tensor, P: int, step: int, seg: int,
          from_front: bool) -> torch.Tensor:
    """csrc/conv_embed.cu on a CUDA front, one block per (session, 9
    windows): kernel 16, or with `from_front` kernel 17."""
    name = "conv_embed_front_simt" if from_front else "conv_embed_simt"
    w = _cuda_forms(params, front, P, step, seg, name)
    S, W, mel = front.shape
    c1, c2, c3 = w["w1"].shape[0], w["w2k"].shape[1], w["w3k"].shape[1]
    d = w["wo"].shape[1]  # the padded widths (`embed_weight_forms`)
    d_model = params["embed_out_w"].shape[1]
    out = torch.empty((P, S, d), dtype=torch.float32, device=front.device)
    if S == 0:
        return out[..., :d_model]
    fn = cuda_build.bind("conv_embed", "conv_embed_simt", 10, 11)
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


def conv_embed_simt(params, front: torch.Tensor, *, P: int, step: int, seg: int) -> torch.Tensor:
    """Kernel 16 on the CUDA cores (csrc/conv_embed.cu, count
    `conv_embed_simt`): the route for shapes `conv_embed_plan` does not
    hold."""
    return _simt(params, front, P, step, seg, from_front=False)


def conv_embed_front_simt(params, front: torch.Tensor, *, P: int, step: int, seg: int
                          ) -> torch.Tensor:
    """Kernel 17 on the CUDA cores (csrc/conv_embed.cu with `from_front`,
    count `conv_embed_front_simt`): the route for shapes the `front` plan
    does not hold."""
    return _simt(params, front, P, step, seg, from_front=True)


def conv_embed_tile(params, front: torch.Tensor, *, P: int, step: int, seg: int,
                    plan: ConvEmbedPlan, stamps: Optional[torch.Tensor] = None,
                    from_front: bool = False) -> torch.Tensor:
    """Kernel 16 (or with `from_front`, kernel 17, on a `front` plan) on
    csrc/conv_embed_tile.cu on `plan` (count `conv_embed`, or
    `conv_embed_front`); with `stamps` (int64 [plan.blocks + plan.mtiles *
    plan.ntiles, CE_NSTAMP], zeroed), each block's phase clock
    (tools/profile_embed.py)."""
    name = "conv_embed_front" if from_front else "conv_embed"
    w = _cuda_forms(params, front, P, step, seg, name)
    S, W, mel = front.shape
    c1, c2, c3 = w["w1"].shape[0], w["w2k"].shape[1], w["w3k"].shape[1]
    d = w["wo"].shape[1]
    d_model = params["embed_out_w"].shape[1]
    K = w["wo"].shape[0]
    if front.data_ptr() % 16:  # the staging reads 16-byte vectors
        front = front.clone()
    y3t = torch.empty(plan.mtiles * K * PJ_BM, dtype=torch.float32, device=front.device)
    out = torch.empty((P, S, d), dtype=torch.float32, device=front.device)
    fn = cuda_build.bind("conv_embed_tile", "conv_embed_tile", 12, 15)
    rc = fn(
        front.data_ptr(), w["w1"].data_ptr(), w["b1"].data_ptr(), w["w2k"].data_ptr(),
        w["b2"].data_ptr(), w["w3k"].data_ptr(), w["b3"].data_ptr(), w["wo32"].data_ptr(),
        w["bo"].data_ptr(), y3t.data_ptr(), out.data_ptr(),
        0 if stamps is None else stamps.data_ptr(),
        S, W, mel, P, step, seg, c1, c2, c3, d, plan.cols, plan.nw, plan.blocks, plan.smem,
        int(from_front), torch.cuda.current_stream(front.device).cuda_stream,
    )
    if rc < 0:
        raise RuntimeError(f"{name}: csrc/conv_embed_tile.cu refuses S={S} P={P} mel={mel} "
                           f"seg={seg} c=({c1}, {c2}, {c3}) d={d} on {plan} "
                           f"({'shape' if rc == -1 else 'shared-memory bytes'})")
    cuda_build.check(rc, f"{name} (S={S}, P={P}, {plan})")
    cuda_build.COUNTS[name] += 1
    return out if d == d_model else out[..., :d_model].contiguous()


def _dispatch(params, front, P, step, seg, from_front):
    if front.device.type == "cpu":
        return conv_embed_plain(params, front, P, step, seg)
    if front.device.type != "cuda":
        raise ValueError(f"conv_embed: unsupported device {front.device}")
    S, _, mel = front.shape
    plan = embed_plan_for(params, S, P, mel, seg, from_front) if S else None
    if plan is None:
        simt = conv_embed_front_simt if from_front else conv_embed_simt
        return simt(params, front, P=P, step=step, seg=seg)
    return conv_embed_tile(params, front, P=P, step=step, seg=seg, plan=plan,
                           from_front=from_front)


def conv_embed_windows(params, front: torch.Tensor, *, P: int, step: int, seg: int) -> torch.Tensor:
    """Kernel 16: [S, W, mel] front -> [P, S, d], conv1 per window; on the
    card csrc/conv_embed_tile.cu on its plan, else `conv_embed_simt`."""
    return _dispatch(params, front, P, step, seg, from_front=False)


def conv_embed_from_front(params, front: torch.Tensor, *, P: int, step: int, seg: int) -> torch.Tensor:
    """Kernel 17: [S, W, mel] front -> [P, S, d], conv1 as if once per buffer
    row with each window's edge rows corrected; on the card
    csrc/conv_embed_tile.cu on its `front` plan, else
    `conv_embed_front_simt`."""
    return _dispatch(params, front, P, step, seg, from_front=True)
