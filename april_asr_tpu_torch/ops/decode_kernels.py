"""Kernel 4: the whole chunk's greedy decode in one launch, and the gates
that choose between it and the per-pull decode.

Port of `chunk_decode_fused` (april_asr_tpu/ops/decode_pallas.py,
`_chunk_decode_kernel`). For each of P pulls and up to 3 masked rounds
(early-emit ramp 1, 0, 0): the lazy decoder refresh (dec-table rows of the
2-token context, ReLU, dec_proj), the joiner tanh(eout + dout) @ W + b, the
blank-excluded argmax, and every heuristic of `decode_step_pre`. The decode
state stays on chip across pulls; only per-pull event records and the final
state are written out. Each pull adds stride_ms to the time of sessions
that pull (`can`), as the engine's per-pull loop does. `dec_proj_t` and
`join_t` may be bf16 (int8 and bf16 serving) or f32 (serving as loaded); the
CUDA kernel is instantiated for both and counts under `chunk_decode` and
`chunk_decode_f32`.

`chunk_decode` takes the plain PyTorch version (per pull and round, kernel
8's plain version then `decode_step_pre`) for CPU tensors and launches
csrc/chunk_decode.cu for CUDA tensors; it never falls back.

`chunk_decode_supported` and `dj_supported` are the port's copies of the
JAX package's gates (decode_pallas.py `chunk_decode_supported`,
joiner_pallas.py `dj_supported`): the engine's step runs kernel 4 only where
the first passes, and the per-pull decode runs kernel 8 only where the
second passes (else kernel 9). They keep JAX's formulas, which bound the
vocabulary-sized operands by the TPU's VMEM budget, so the port takes the
same route as the JAX package for every model. They drop JAX's
`S % block_s` term, since the CUDA kernels take ragged session tiles, and
size the budget's activation tiles at JAX's block for S, or 128 sessions
where JAX has none. They read only shapes, never the device.

`chunk_decode_block_fits` is the port's own shape rule beside them: kernel
4's block keeps a [V] logits row per session in shared memory, so the step
also sends to the per-pull decode the shapes the JAX gate passes but the
H100's 232,448 bytes per block cannot hold (narrow models, d or J of 128 or
256, above ~13.9k to 14.2k tokens).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..decode import greedy
from . import cuda_build
from .joiner_kernels import decoder_joiner_argmax_plain

EVENT_KEYS = ("ops", "tok", "logprob", "flags", "time_ms", "final_k")

_VMEM_BUDGET = 56 * 1024 * 1024  # the JAX gates' bound on resident bytes
SMEM_PER_BLOCK = 232_448  # the H100's opt-in shared memory per block
CHUNK_DECODE_TSD = 4  # sessions per block of kernel 4 (TSD, csrc/chunk_decode.cu)


def _gate_block_s(S: int) -> int:
    """JAX's session block for S (`_pick_block_s`), or 128 where it has none."""
    return next((b for b in (512, 256, 128) if S % b == 0), 128)


def chunk_decode_supported(S: int, J: int, d: int, context: int, vocab: int) -> bool:
    """True where the JAX package runs its whole-chunk decode kernel for
    these shapes (less its `S % block_s` term): 2-token context,
    128-multiple widths, and the vocabulary-sized operands within its
    budget. At d = J = 512 kernel 4's shared memory holds every vocabulary
    this passes; narrower models (d or J of 128 or 256) pass vocabularies
    it cannot hold, which `chunk_decode_block_fits` refuses."""
    if not (context == 2 and J % 128 == 0 and d % 128 == 0):
        return False
    Vp = -(-vocab // 128) * 128 if vocab else 0
    resident = 2 * Vp * d * 4 + J * Vp * 4 + d * J * 4 + _gate_block_s(S) * (6 * J + 64) * 4
    return resident <= _VMEM_BUDGET


def chunk_decode_smem(J: int, d: int, vocab: int, tokens: int) -> int:
    """Shared-memory bytes of one kernel 4 block (its C entry's formula):
    TSD sessions' dout [J], work row [max(J, d)], logits [V] and token
    window [T], 4 bytes each."""
    return 4 * CHUNK_DECODE_TSD * (J + max(J, d) + vocab + tokens)


def chunk_decode_block_fits(J: int, d: int, vocab: int, tokens: int) -> bool:
    """True where one kernel 4 block fits the H100's shared memory; the
    step takes the whole-chunk decode only where this and
    `chunk_decode_supported` both hold. Reads shapes only."""
    return chunk_decode_smem(J, d, vocab, tokens) <= SMEM_PER_BLOCK


def dj_supported(S: int, J: int, d: int, context: int, vocab: int = 0, w_itemsize: int = 4) -> bool:
    """True where the JAX package runs kernel 8 (`decoder_joiner_argmax_fused`)
    for these shapes (less its `S % block_s` term); elsewhere its per-pull
    decode runs the decoder step and kernel 9."""
    if not (context == 2 and J % 128 == 0 and d % 128 == 0):
        return False
    if vocab:
        Vp = -(-vocab // 128) * 128
        resident = (2 * Vp * d * 4 + J * Vp * w_itemsize + d * J * w_itemsize
                    + _gate_block_s(S) * (4 * J + 16) * 4)
        if resident > _VMEM_BUDGET:
            return False
    return True


def chunk_decode_plain(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b,
                       vt, *, blank_id, stride_ms, emit_ramp, dcfg):
    P = eouts.shape[0]
    dstate = dict(dstate)
    per_pull = []
    for p in range(P):
        can_p = can[p]
        dstate["time_ms"] = (dstate["time_ms"] + stride_ms * can_p.to(torch.int32)).to(torch.int32)
        done = ~can_p
        rounds = []
        for ee in emit_ramp:
            mi, mv, bv, dstate["dout"] = decoder_joiner_argmax_plain(
                dstate["context"], dstate["need_dec"], dstate["dout"], eouts[p],
                dec_table, dec_proj_t, dec_proj_b, w_t, b, blank_id,
            )
            dstate, evt, is_blank, need_dec = greedy.decode_step_pre(
                dstate, mi, mv, bv, ~done, ee, blank_id, vt, dcfg
            )
            dstate["need_dec"] = need_dec
            done = done | is_blank
            rounds.append(evt)
        per_pull.append({k: torch.stack([e[k] for e in rounds], dim=1) for k in EVENT_KEYS})
    events = {k: torch.stack([e[k] for e in per_pull], dim=0) for k in EVENT_KEYS}
    return dstate, events


def chunk_decode_cuda(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b,
                      vt, *, blank_id, stride_ms, emit_ramp, dcfg):
    P, S, J = eouts.shape
    d = dec_table.shape[2]
    V = w_t.shape[1]
    T = dcfg.max_active_tokens
    R = len(emit_ramp)
    dev = eouts.device
    if R != 3 or dec_table.shape[0] != 2:
        raise ValueError("chunk_decode: needs 3 rounds and a 2-token context")
    wd = w_t.dtype
    if wd not in (torch.bfloat16, torch.float32):
        raise ValueError(f"chunk_decode: join_t must be bfloat16 or float32, got {wd}")
    checks = (
        (eouts, torch.float32, (P, S, J)), (dec_table, torch.float32, (2, V, d)),
        (dec_proj_t, wd, (d, J)), (w_t, wd, (J, V)),
        (dec_proj_b, torch.float32, (J,)), (b, torch.float32, (V,)),
        (dstate["dout"], torch.float32, (S, J)),
        (dstate["context"], torch.int32, (S, 2)),
        (dstate["token_words"], torch.int32, (S, T)),
    )
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"chunk_decode: expected contiguous {dt} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    can_i = i32(can)
    nd_i = i32(dstate["need_dec"])
    sil_i = i32(dstate["emitted_silence"])
    scal_in = [i32(dstate[k]) for k in ("head", "last_call", "time_ms", "last_emit_ms")]
    tmask = greedy.vocab_mask_on(vt, dev)
    out_ctx = torch.empty_like(dstate["context"])
    out_dout = torch.empty_like(dstate["dout"])
    out_words = torch.empty_like(dstate["token_words"])
    out_scal = [torch.empty(S, dtype=torch.int32, device=dev) for _ in range(6)]
    ev = {k: torch.empty((P, S, R), dtype=torch.float32 if k == "logprob" else torch.int32,
                         device=dev) for k in EVENT_KEYS}
    w_f32 = int(wd == torch.float32)
    fn = cuda_build.bind("chunk_decode", "chunk_decode", 32, 9, 8)
    rc = fn(
        eouts.data_ptr(), can_i.data_ptr(),
        dstate["context"].data_ptr(), dstate["dout"].data_ptr(), nd_i.data_ptr(),
        dstate["token_words"].data_ptr(), *[t.data_ptr() for t in scal_in], sil_i.data_ptr(),
        dec_table.data_ptr(), dec_proj_t.data_ptr(), dec_proj_b.data_ptr(),
        w_t.data_ptr(), b.data_ptr(), tmask.data_ptr(),
        out_ctx.data_ptr(), out_dout.data_ptr(), out_words.data_ptr(),
        *[t.data_ptr() for t in out_scal],
        *[ev[k].data_ptr() for k in EVENT_KEYS],
        P, S, J, d, V, T, blank_id, stride_ms, w_f32,
        *[float(x) for x in emit_ramp],
        float(dcfg.punctuation_margin), float(dcfg.confident_margin),
        float(dcfg.confident_logprob_penalty), float(dcfg.long_silence_ms),
        float(dcfg.silence_decay_ms),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc < 0:
        raise ValueError(
            f"chunk_decode: V={V}, J={J}, d={d}, T={T} need {-rc} bytes of shared memory per "
            "block, more than this device allows one block; the engine's step sends such "
            "shapes to the per-pull decode (chunk_decode_block_fits)"
        )
    cuda_build.check(rc, "chunk_decode")
    cuda_build.COUNTS["chunk_decode_f32" if w_f32 else "chunk_decode"] += 1
    nd, head, last_call, time_ms, last_emit, sil = out_scal
    state = dict(dstate)
    state.update(
        context=out_ctx, dout=out_dout, need_dec=nd != 0, token_words=out_words,
        head=head, last_call=last_call, time_ms=time_ms, last_emit_ms=last_emit,
        emitted_silence=sil != 0,
    )
    return state, ev


def chunk_decode(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
                 blank_id: int, stride_ms: int, emit_ramp, dcfg) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """eouts [P, S, J], can [P, S] bool -> (dstate', events {key: [P, S, 3]}).
    State keys as decode/greedy.init_decode_state; `dout_init` passes through."""
    kw = dict(blank_id=blank_id, stride_ms=stride_ms, emit_ramp=tuple(emit_ramp), dcfg=dcfg)
    args = (eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt)
    if eouts.device.type == "cpu":
        return chunk_decode_plain(*args, **kw)
    if eouts.device.type != "cuda":
        raise ValueError(f"chunk_decode: unsupported device {eouts.device}")
    return chunk_decode_cuda(*args, **kw)
