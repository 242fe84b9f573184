"""Kernels 8 and 9: one round of the greedy decode's joiner and argmax.

Ports of april_asr_tpu/ops/joiner_pallas.py:

* `joiner_argmax_fused` (kernel 9, `_kernel`): logits =
  wd(tanh(eout + dout)) @ join_t + join_b, where wd(.) rounds to the type
  of `join_t` (bf16 or f32) and the sum is f32; returns (max_idx, max_val,
  blank_val) with the blank column excluded from the max (NEG_INF, first
  index on ties). Any vocabulary size, unpadded.
* `decoder_joiner_argmax_fused` (kernel 8, `_dj_kernel`): first the lazy
  decoder refresh, pre = dec_table[0][c0] + dec_table[1][c1] (exact f32 row
  gathers, which is what the TPU kernel's one-hot f32 contraction computes),
  new = wd(relu(pre)) @ dec_proj_t + dec_proj_b, and the blend
  dout' = nd * new + (1 - nd) * dout with nd = need_dec as f32; then kernel
  9's joiner and argmax on dout'. Returns (max_idx, max_val, blank_val,
  dout').

The plain versions are the decode's only joiner and refresh: the whole-chunk
decode's plain version (ops/decode_kernels.py) runs them too. Each wrapper
takes the plain version for CPU tensors and launches a kernel for CUDA
tensors; it never falls back. Kernel 9 is csrc/joiner_stream.cu, one
cooperative launch on the plan of ops/joiner_plan.py `joiner_plan`
(counted as `joiner_argmax`/`joiner_argmax_f32` by weight type), and where
that plan has none (J not a multiple of 32) the CUDA-core kernels it
replaced, csrc/joiner.cu's `joiner_argmax` (counted as
`joiner_argmax_simt`/`joiner_argmax_simt_f32`); the two are equal bit for
bit. Kernel 8 is
csrc/dec_joiner_cluster.cu, one launch of thread-block clusters on the
plan of ops/decode_kernels.py `dj_plan` (counted as
`dec_joiner`/`dec_joiner_f32`), and where no block holds a cluster slice
(narrow models with large vocabularies) the CUDA-core kernels it replaced,
csrc/joiner.cu's `dec_joiner_simt` (counted as
`dec_joiner_simt`/`dec_joiner_simt_f32`). The two are equal bit for bit up
to the blend of a row that does not refresh (csrc/dec_joiner_cluster.cu).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..decode.greedy import NEG_INF
from . import cuda_build, decode_kernels
from . import joiner_plan as JP
from .activations import dot_wd
from .lstm_kernels import _check


def joiner_logits_plain(eout, dout, w_t, b):
    """[S, J] + [S, J] -> [S, V] logits: wd(tanh(eout + dout)) @ w_t + b."""
    return dot_wd(torch.tanh(eout + dout), w_t) + b.float()


def joiner_argmax_plain(eout, dout, w_t, b, blank_id: int):
    logits = joiner_logits_plain(eout, dout, w_t, b)
    V = logits.shape[1]
    masked = torch.where(
        torch.arange(V, device=logits.device)[None, :] == blank_id,
        torch.tensor(NEG_INF, dtype=torch.float32, device=logits.device),
        logits,
    )
    return masked.argmax(dim=1).to(torch.int32), masked.amax(dim=1), logits[:, blank_id]


def decoder_refresh(ctx, dec_table, dec_proj_t, dec_proj_b):
    """The 2-token decoder from its tables: [S, 2] -> [S, J]."""
    pre = dec_table[0][ctx[:, 0].long()] + dec_table[1][ctx[:, 1].long()]
    return dot_wd(torch.relu(pre), dec_proj_t) + dec_proj_b.float()


def decoder_joiner_argmax_plain(ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b,
                                w_t, b, blank_id: int):
    nd = need_dec.float()[:, None]
    new = decoder_refresh(ctx, dec_table, dec_proj_t, dec_proj_b)
    dout = nd * new + (1.0 - nd) * dout
    mi, mv, bv = joiner_argmax_plain(eout, dout, w_t, b, blank_id)
    return mi, mv, bv, dout


def _weight_type(w_t, what: str) -> int:
    """1 for f32 weights, 0 for bf16; raises for any other type."""
    if w_t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: join_t must be bfloat16 or float32, got {w_t.dtype}")
    return int(w_t.dtype == torch.float32)


def _outputs(S: int, dev):
    """max_idx, max_val, blank_val, and the kernel's [S] argmax-key scratch."""
    return (torch.empty(S, dtype=torch.int32, device=dev),
            torch.empty(S, dtype=torch.float32, device=dev),
            torch.empty(S, dtype=torch.float32, device=dev),
            torch.empty(S, dtype=torch.int64, device=dev))


def joiner_argmax_simt(eout, dout, w_t, b, blank_id: int):
    """csrc/joiner.cu's three stream operations (a memset of the argmax
    keys, the joiner tiles with their atomic keys, the finalization):
    kernel 9's route where `joiner_plan` has none."""
    S, J = eout.shape
    V = w_t.shape[1]
    w_f32 = _weight_type(w_t, "joiner_argmax_simt")
    for t, dt, shape, what in ((eout, torch.float32, (S, J), "eout"),
                               (dout, torch.float32, (S, J), "dout"),
                               (w_t, w_t.dtype, (J, V), "join_t"), (b, torch.float32, (V,), "join_b")):
        _check(t, dt, shape, f"joiner_argmax_simt {what}")
    mi, mv, bv, keys = _outputs(S, eout.device)
    fn = cuda_build.bind("joiner", "joiner_argmax", 8, 5)
    cuda_build.COUNTS["joiner_argmax_simt_f32" if w_f32 else "joiner_argmax_simt"] += 1
    rc = fn(
        eout.data_ptr(), dout.data_ptr(), w_t.data_ptr(), b.data_ptr(),
        mi.data_ptr(), mv.data_ptr(), bv.data_ptr(), keys.data_ptr(), S, J, V, blank_id, w_f32,
        torch.cuda.current_stream(eout.device).cuda_stream,
    )
    cuda_build.check(rc, "joiner_argmax_simt")
    return mi, mv, bv


_STREAM_FORMS: Dict[tuple, tuple] = {}
_STREAM_BUFS: Dict[tuple, tuple] = {}
_STREAM_FN: dict = {}  # the kernel's ctypes handle, bound once


def stream_weight_form(w_t, b, Vc: int) -> torch.Tensor:
    """W's column slices [ceil(V / Vc)][J][Vc] f32 as csrc/joiner_stream.cu's
    blocks read them (slice i: columns [i Vc, (i + 1) Vc), zero past V; bf16
    weights widened exactly), so that a slice's chunks of KC rows are
    contiguous; laid out once per weights and slice width, cached by the
    identity of `w_t` and `b`, whose checks (type, shape, contiguity) run
    only when the form is made."""
    key = (id(w_t), id(b), Vc)
    hit = _STREAM_FORMS.get(key)
    if hit is not None:
        return hit[1]
    J, V = w_t.shape
    _weight_type(w_t, "joiner_argmax")
    _check(w_t, w_t.dtype, (J, V), "joiner_argmax join_t")
    _check(b, torch.float32, (V,), "joiner_argmax join_b")
    n_vs = -(-V // Vc)
    wp = torch.zeros((J, n_vs * Vc), dtype=torch.float32, device=w_t.device)
    wp[:, :V] = w_t
    form = wp.view(J, n_vs, Vc).permute(1, 0, 2).contiguous()
    if len(_STREAM_FORMS) >= 16:
        _STREAM_FORMS.clear()
    _STREAM_FORMS[key] = ((w_t, b), form)  # holding the sources keeps their ids from reuse
    return form


def _stream_buffers(dev, S: int, J: int, TS: int, n_st: int) -> tuple:
    """The kernel's [S + 1] u64 argmax keys (the last its ticket), zero and
    left zero by every launch, and its t scratch [n_st][J][TS] f32, kept per
    device and shape. A key buffer serves one stream at a time: calls of one
    shape on two streams at once would share it."""
    key = (dev, S, J, TS)
    hit = _STREAM_BUFS.get(key)
    if hit is None:
        hit = _STREAM_BUFS[key] = (torch.zeros(S + 1, dtype=torch.int64, device=dev),
                                   torch.empty(n_st * J * TS, dtype=torch.float32, device=dev))
    return hit


def joiner_argmax_stream(eout, dout, w_t, b, blank_id: int, *, plan, stamps=None):
    """csrc/joiner_stream.cu on `plan` (ops/joiner_plan.py `joiner_plan`):
    one launch, no memset, no finalization kernel. `stamps` (int64
    [plan.blocks, 5 + 3 plan.rounds] on the card, or None) takes each
    block's phase stamps (tools/profile_decode.py)."""
    S, J = eout.shape
    V = w_t.shape[1]
    if (plan.S, plan.J, plan.V) != (S, J, V):
        raise ValueError(f"joiner_argmax: a plan for S={plan.S}, J={plan.J}, V={plan.V} given "
                         f"S={S}, J={J}, V={V}")
    for t, what in ((eout, "eout"), (dout, "dout")):
        if t.dtype != torch.float32 or t.shape != eout.shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"joiner_argmax: {what} must be contiguous 16-byte aligned f32 "
                             f"[{S}, {J}], got {t.dtype} {tuple(t.shape)}")
    wf = stream_weight_form(w_t, b, plan.Vc)
    keys, tbuf = _stream_buffers(eout.device, S, J, plan.TS, plan.n_st)
    out = torch.empty(3 * S, dtype=torch.int32, device=eout.device)
    mi, mv, bv = out[:S], out[S:2 * S].view(torch.float32), out[2 * S:].view(torch.float32)
    fn = _STREAM_FN.get("fn")
    if fn is None:
        fn = _STREAM_FN["fn"] = cuda_build.bind("joiner_stream", "joiner_stream", 10, 12)
    w_f32 = int(w_t.dtype == torch.float32)
    rc = fn(
        eout.data_ptr(), dout.data_ptr(), wf.data_ptr(), b.data_ptr(), mi.data_ptr(),
        mv.data_ptr(), bv.data_ptr(), tbuf.data_ptr(), keys.data_ptr(),
        None if stamps is None else stamps.data_ptr(), S, J, V, blank_id, w_f32, plan.ti,
        int(plan.w_resident), plan.Vc, plan.TS, plan.rounds, plan.blocks, plan.smem,
        torch.cuda.current_stream(eout.device).cuda_stream,
    )
    if rc < 0:
        raise ValueError(f"joiner_argmax: the kernel's layout needs {-rc} bytes of shared memory, "
                         f"the plan {plan.smem} ({plan})")
    cuda_build.check(rc, "joiner_argmax")
    cuda_build.COUNTS["joiner_argmax_f32" if w_f32 else "joiner_argmax"] += 1
    return mi, mv, bv


def joiner_argmax_cuda(eout, dout, w_t, b, blank_id: int):
    """Kernel 9 on the card's plan, else (J not a multiple of 32) the
    CUDA-core kernels; the choice reads shapes only."""
    S, J = eout.shape
    plan = JP.device_joiner_plan(S, J, w_t.shape[1], w_t.element_size(), eout.device.index or 0)
    if plan is None:
        return joiner_argmax_simt(eout, dout, w_t, b, blank_id)
    return joiner_argmax_stream(eout, dout, w_t, b, blank_id, plan=plan)


def joiner_argmax_fused(eout, dout, w_t, b, *, blank_id: int):
    """eout/dout [S, J] f32, w_t [J, V], b [V] -> (max_idx [S] i32,
    max_val [S], blank_val [S])."""
    if eout.device.type == "cpu":
        return joiner_argmax_plain(eout, dout, w_t, b, blank_id)
    if eout.device.type != "cuda":
        raise ValueError(f"joiner_argmax: unsupported device {eout.device}")
    return joiner_argmax_cuda(eout, dout, w_t, b, blank_id)


def _dj_checks(ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b, w_t, b,
               what: str, nd_dtype):
    """Kernel 8's argument checks; (S, J, d, V, w_f32)."""
    S, J = eout.shape
    V = w_t.shape[1]
    d = dec_table.shape[2]
    w_f32 = _weight_type(w_t, what)
    for t, dt, shape, name in (
        (ctx, torch.int32, (S, 2), "context"), (need_dec, nd_dtype, (S,), "need_dec"),
        (dout, torch.float32, (S, J), "dout"), (eout, torch.float32, (S, J), "eout"),
        (dec_table, torch.float32, (2, V, d), "dec_table"), (dec_proj_t, w_t.dtype, (d, J), "dec_proj_t"),
        (dec_proj_b, torch.float32, (J,), "dec_proj_b"), (w_t, w_t.dtype, (J, V), "join_t"),
        (b, torch.float32, (V,), "join_b"),
    ):
        _check(t, dt, shape, f"{what} {name}")
    return S, J, d, V, w_f32


def decoder_joiner_argmax_simt(ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b,
                               w_t, b, blank_id: int):
    """csrc/joiner.cu's three kernels (`dec_joiner_simt`: the refresh of
    every session and its blend, the joiner tiles with their atomic argmax
    keys, the finalization): kernel 8's route where `dj_plan` has none."""
    nd = need_dec.to(torch.float32).contiguous()
    S, J, d, V, w_f32 = _dj_checks(ctx, nd, dout, eout, dec_table, dec_proj_t, dec_proj_b, w_t,
                                   b, "dec_joiner_simt", torch.float32)
    mi, mv, bv, keys = _outputs(S, eout.device)
    dout2 = torch.empty_like(dout)
    fn = cuda_build.bind("joiner", "dec_joiner_simt", 14, 6)
    cuda_build.COUNTS["dec_joiner_simt_f32" if w_f32 else "dec_joiner_simt"] += 1
    rc = fn(
        ctx.data_ptr(), nd.data_ptr(), dout.data_ptr(), eout.data_ptr(), dec_table.data_ptr(),
        dec_proj_t.data_ptr(), dec_proj_b.data_ptr(), w_t.data_ptr(), b.data_ptr(),
        mi.data_ptr(), mv.data_ptr(), bv.data_ptr(), dout2.data_ptr(), keys.data_ptr(),
        S, J, d, V, blank_id, w_f32,
        torch.cuda.current_stream(eout.device).cuda_stream,
    )
    cuda_build.check(rc, "dec_joiner_simt")
    return mi, mv, bv, dout2


_FORMS: Dict[tuple, tuple] = {}
_CLUSTER_FN: dict = {}  # the cluster kernel's ctypes handle, bound once


def dj_weight_forms(dec_proj_t, w_t, plan) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The cluster kernel's slices of W and dec_proj as its blocks hold them
    in shared memory, laid out once per weights and plan (cached by the
    identity of the two tensors and the slicing): W's columns [C Vc][J +
    KPAD] and, where the plan keeps dec_proj resident, its columns [C Jc][d +
    KPAD] (else None: its columns stream from `dec_proj_t` itself), each
    column's weights contiguous, zero past the matrix and in the KPAD
    tail, so block r's slice is the contiguous rows [r Vc, (r + 1) Vc)."""
    key = (id(dec_proj_t), id(w_t), plan.C, plan.Vc, plan.Jc, plan.dp_smem)
    hit = _FORMS.get(key)
    if hit is not None:
        return hit[1]

    def columns(m, n_cols):
        K, N = m.shape
        out = torch.zeros((n_cols, K + decode_kernels.KPAD), dtype=m.dtype, device=m.device)
        out[:N, :K] = m.t()
        return out

    forms = (columns(w_t, plan.C * plan.Vc),
             columns(dec_proj_t, plan.C * plan.Jc) if plan.dp_smem else None)
    if len(_FORMS) >= 16:
        _FORMS.clear()
    _FORMS[key] = ((dec_proj_t, w_t), forms)  # holding the sources keeps their ids from reuse
    return forms


def decoder_joiner_argmax_cluster(ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b,
                                  w_t, b, blank_id: int, *, plan, stamps=None):
    """csrc/dec_joiner_cluster.cu on `plan` (ops/decode_kernels.py
    `dj_plan`); `stamps` (int64 [plan.blocks, 12] on the card, or None) takes
    each block's phase stamps (tools/profile_decode.py)."""
    nd = need_dec if need_dec.dtype == torch.bool else need_dec.to(torch.bool)
    S, J, d, V, w_f32 = _dj_checks(ctx, nd, dout, eout, dec_table, dec_proj_t, dec_proj_b, w_t,
                                   b, "dec_joiner", torch.bool)
    if (plan.S, plan.V, plan.J) != (S, V, J):
        raise ValueError(f"dec_joiner: a plan for S={plan.S}, V={plan.V}, J={plan.J} given "
                         f"S={S}, V={V}, J={J}")
    if (dout.data_ptr() | eout.data_ptr() | dec_table.data_ptr() | dec_proj_t.data_ptr()) % 16:
        raise ValueError("dec_joiner: dout, eout, dec_table and dec_proj_t must be 16-byte "
                         "aligned")
    wf, dpf = dj_weight_forms(dec_proj_t, w_t, plan)
    out = torch.empty(3 * S, dtype=torch.int32, device=eout.device)
    mi, mv, bv = out[:S], out[S:2 * S].view(torch.float32), out[2 * S:].view(torch.float32)
    dout2 = torch.empty_like(dout)
    fn = _CLUSTER_FN.get("fn")
    if fn is None:
        fn = _CLUSTER_FN["fn"] = cuda_build.bind("dec_joiner_cluster", "dec_joiner_cluster", 15,
                                                 12)
    rc = fn(
        ctx.data_ptr(), nd.data_ptr(), dout.data_ptr(), eout.data_ptr(), dec_table.data_ptr(),
        dec_proj_t.data_ptr(), None if dpf is None else dpf.data_ptr(), dec_proj_b.data_ptr(),
        wf.data_ptr(), b.data_ptr(), mi.data_ptr(), mv.data_ptr(), bv.data_ptr(),
        dout2.data_ptr(), None if stamps is None else stamps.data_ptr(),
        S, J, d, V, blank_id, w_f32, plan.C, plan.TS, plan.Vc, plan.Jc, int(plan.dp_smem),
        plan.smem, torch.cuda.current_stream(eout.device).cuda_stream,
    )
    if rc < 0:
        raise ValueError(f"dec_joiner: the kernel's layout needs {-rc} bytes of shared memory, "
                         f"the plan {plan.smem} ({plan})")
    cuda_build.check(rc, "dec_joiner")
    cuda_build.COUNTS["dec_joiner_f32" if w_f32 else "dec_joiner"] += 1
    return mi, mv, bv, dout2


def decoder_joiner_argmax_cuda(ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b,
                               w_t, b, blank_id: int):
    """The cluster kernel on the card's plan, else (no block holds a slice)
    the CUDA-core kernels; the choice reads shapes only."""
    S, J = eout.shape
    plan = decode_kernels.device_dj_plan(S, J, dec_table.shape[2], w_t.shape[1],
                                         w_t.element_size(), eout.device.index or 0)
    args = (ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b, w_t, b, blank_id)
    if plan is None:
        return decoder_joiner_argmax_simt(*args)
    return decoder_joiner_argmax_cluster(*args, plan=plan)


def decoder_joiner_argmax_fused(ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b,
                                w_t, b, *, blank_id: int):
    """ctx [S, 2] i32, need_dec [S] bool, dout/eout [S, J] f32, dec_table
    [2, V, d] f32, dec_proj_t [d, J] and w_t [J, V] bf16 or f32 ->
    (max_idx [S] i32, max_val [S], blank_val [S], dout' [S, J])."""
    args = (ctx, need_dec, dout, eout, dec_table, dec_proj_t, dec_proj_b, w_t, b, blank_id)
    if eout.device.type == "cpu":
        return decoder_joiner_argmax_plain(*args)
    if eout.device.type != "cuda":
        raise ValueError(f"dec_joiner: unsupported device {eout.device}")
    return decoder_joiner_argmax_cuda(*args)
