"""Batched frame-synchronous greedy transducer decode (port of
april_asr_tpu/decode/greedy.py).

`decode_step` is one aas_process_logits step from [S, V] logits (the
interpreter's route): `greedy_prologue` takes them to (max_idx, max_val,
blank_val), then `decode_step_pre`. `decode_step_pre` is one
aas_process_logits step (src/april_session.c:306-429)
over the session batch from the joiner prologue (max_idx, max_val,
blank_val): early-emit ramp, repeat guard, punctuation margin, digit-dot
exception, sentence-forced finalize, 72-token window with word-split
finalize, silence decay, confident-blank with dedup, 2200 ms reset. It is
the plain reference that the whole-chunk decode kernel
(ops/decode_kernels.py) is held against. Token id and flags share one int32
word (id | flags << FLAG_SHIFT); per-token string tests are one packed
bitmask table.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import DecodeConfig
from ..io.params import VocabTables
from . import events as ev

NEG_INF = -1e30
FLAG_SHIFT = 16
MASK_WB, MASK_EOS, MASK_PUNCT, MASK_DIGIT, MASK_DOT = 1, 2, 4, 8, 16


def vocab_tables_device(vt: VocabTables) -> Dict[str, np.ndarray]:
    """Per-token properties packed into one int32 bitmask table."""
    mask = (
        np.asarray(vt.word_boundary, np.int32) * MASK_WB
        | np.asarray(vt.end_sentence, np.int32) * MASK_EOS
        | np.asarray(vt.punctuation, np.int32) * MASK_PUNCT
        | np.asarray(vt.starts_digit, np.int32) * MASK_DIGIT
        | np.asarray(vt.is_dot, np.int32) * MASK_DOT
    )
    return {"mask": mask}


def vocab_mask_on(vt: Dict[str, np.ndarray], dev) -> torch.Tensor:
    """The packed vocab bitmask as an int32 tensor on `dev`, copied once and
    kept in `vt` beside the host array."""
    key = f"mask@{dev}"
    t = vt.get(key)
    if t is None:
        t = vt[key] = torch.as_tensor(vt["mask"], dtype=torch.int32).to(dev)
    return t


_F32_CONSTS: Dict[tuple, torch.Tensor] = {}


def _f32_on(v: float, dev) -> torch.Tensor:
    """A 0-dim f32 tensor of v on `dev`, copied once: the decode step's
    thresholds, without a host-to-device copy per call (a tensor, not a
    Python scalar: CUDA divides by a host scalar through its reciprocal)."""
    key = (float(v), str(dev))
    t = _F32_CONSTS.get(key)
    if t is None:
        t = _F32_CONSTS[key] = torch.tensor(v, dtype=torch.float32, device=dev)
    return t


def init_decode_state(
    batch: int, context_size: int, joiner_dim: int, blank_id: int, cfg: DecodeConfig,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """Per-session decode state, [S, ...] leaves (april_session.h:44-66);
    emitted_silence starts true (april_session.c:64)."""
    T = cfg.max_active_tokens
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "context": torch.full((batch, context_size), blank_id, **i32),
        "dout": torch.zeros((batch, joiner_dim), dtype=torch.float32, device=device),
        "dout_init": torch.zeros(batch, dtype=torch.bool, device=device),
        "need_dec": torch.zeros(batch, dtype=torch.bool, device=device),
        "token_words": torch.zeros((batch, T), **i32),
        "head": torch.zeros(batch, **i32),
        "last_call": torch.zeros(batch, **i32),
        "emitted_silence": torch.ones(batch, dtype=torch.bool, device=device),
        "time_ms": torch.zeros(batch, **i32),
        "last_emit_ms": torch.zeros(batch, **i32),
    }


def _row_gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, 1, idx.long()[:, None])[:, 0]


def _shift_left(words: torch.Tensor, shift: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """memmove semantics (april_session.c:245-250): entries [0, head-shift)
    take words[i+shift] (circularly, as the JAX barrel roll does); the rest
    keep their stale values."""
    T = words.shape[1]
    pos = torch.arange(T, device=words.device)[None, :]
    src = torch.remainder(pos + shift[:, None].long(), T)
    moved = torch.gather(words, 1, src)
    live = pos < (head - shift)[:, None]
    return torch.where(live, moved, words)


def _w(cond, a, b):
    return torch.where(cond, a, b)


def greedy_prologue(logits: torch.Tensor, blank_id: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[S, V] logits -> (max_idx, max_val, blank_val), the only three values
    the greedy heuristics consume (april_session.c:311-320): the best
    non-blank token (first of equals), its logit, and the blank's."""
    V = logits.shape[1]
    vocab_iota = torch.arange(V, device=logits.device)[None, :]
    masked = torch.where(vocab_iota == blank_id, NEG_INF, logits)
    return masked.argmax(dim=1).to(torch.int32), masked.amax(dim=1), logits[:, blank_id]


def decode_step(
    state, logits, active, early_emit: float, blank_id: int, vt: Dict[str, np.ndarray],
    cfg: DecodeConfig,
) -> Tuple[dict, dict, torch.Tensor, torch.Tensor]:
    """One aas_process_logits step over the batch (logits form)."""
    max_idx, max_val, blank_val = greedy_prologue(logits, blank_id)
    return decode_step_pre(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg)


def decode_step_pre(
    state, max_idx, max_val, blank_val, active, early_emit: float, blank_id: int,
    vt: Dict[str, np.ndarray], cfg: DecodeConfig,
) -> Tuple[dict, dict, torch.Tensor, torch.Tensor]:
    """One aas_process_logits step over the batch. Returns (new_state,
    events, is_blank, need_decoder)."""
    T = cfg.max_active_tokens
    S = max_idx.shape[0]
    dev = max_idx.device
    state = dict(state)
    i32 = torch.int32
    zero = torch.zeros(S, dtype=i32, device=dev)
    evt = {"ops": zero, "tok": zero, "logprob": torch.zeros(S, device=dev),
           "flags": zero, "time_ms": zero, "final_k": zero}
    pos = torch.arange(T, device=dev)[None, :]
    t_mask = vocab_mask_on(vt, dev)
    max_idx = max_idx.to(i32)
    f32 = lambda v: _f32_on(v, dev)  # noqa: E731

    last_ctx = state["context"][:, -1]
    was_cleared = last_ctx == blank_id
    is_equal_prev = last_ctx == max_idx
    eff_emit = _w(is_equal_prev, f32(0.0), f32(early_emit))
    is_blank = (blank_val - eff_emit) > max_val

    mask_max = t_mask[max_idx.long()]
    wb = (mask_max & MASK_WB) != 0
    eos = (mask_max & MASK_EOS) != 0
    punct = (mask_max & MASK_PUNCT) != 0

    head = state["head"]
    words = state["token_words"]
    prev_word = _row_gather(words, torch.clamp_min(head - 1, 0))
    prev_tok = prev_word & ((1 << FLAG_SHIFT) - 1)
    prev_flags = prev_word >> FLAG_SHIFT
    mask_prev = t_mask[prev_tok.long()]
    digit_exc = punct & (head > 0) & ((mask_prev & MASK_DIGIT) != 0) & ((mask_max & MASK_DOT) != 0)
    eos = eos & ~digit_exc
    punct = punct & ~digit_exc
    tok_flags = (wb.to(i32) * ev.FLAG_WORD_BOUNDARY) | (eos.to(i32) * ev.FLAG_SENTENCE_END)

    boost = ~was_cleared & punct & ~is_equal_prev & (max_val > blank_val - f32(cfg.punctuation_margin))
    is_blank = is_blank & ~boost
    nb = active & ~is_blank
    bl = active & is_blank

    # ---- non-blank path (:361-400)
    state["last_emit_ms"] = _w(nb, state["time_ms"], state["last_emit_ms"])
    new_context = torch.cat([state["context"][:, 1:], max_idx[:, None]], dim=1)
    state["context"] = _w(nb[:, None], new_context, state["context"])
    need_decoder = nb
    is_final = nb & (head >= T - 1)

    check = nb & (head > 0) & wb
    prev_is_eos = (mask_prev & MASK_EOS) != 0
    fix_prev = check & prev_is_eos & ((prev_flags & ev.FLAG_SENTENCE_END) == 0)
    fix_mask = (pos == torch.clamp_min(head - 1, 0)[:, None]) & fix_prev[:, None]
    words = _w(fix_mask, words | (ev.FLAG_SENTENCE_END << FLAG_SHIFT), words)
    evt["ops"] = evt["ops"] | (fix_prev.to(i32) * ev.OP_FIX_PREV_EOS)
    is_final = is_final | (check & prev_is_eos)

    wb_bits = (words >> FLAG_SHIFT) & ev.FLAG_WORD_BOUNDARY
    cand = _w((wb_bits != 0) & (pos > 2) & (pos <= head[:, None] - 1), pos.expand(S, -1), -1)
    start_of_word = cand.amax(dim=1).to(i32)

    full_fin = is_final & (head > 0) & (wb | (start_of_word < 0))
    shift_fin = is_final & (head > 0) & ~wb & (start_of_word >= 0)

    evt["ops"] = evt["ops"] | (full_fin.to(i32) * ev.OP_FINAL)
    evt["final_k"] = _w(full_fin, head, evt["final_k"])
    state["last_call"] = _w(full_fin, head, state["last_call"])
    head = _w(full_fin, zero, head)

    evt["ops"] = evt["ops"] | (shift_fin.to(i32) * ev.OP_FINAL)
    evt["final_k"] = _w(shift_fin, start_of_word, evt["final_k"])
    shift = _w(shift_fin, start_of_word, zero)
    words = _shift_left(words, shift, head)
    head = _w(shift_fin, head - start_of_word, head)

    no_room = nb & (head >= T - 1)
    evt["ops"] = evt["ops"] | (no_room.to(i32) * ev.OP_RESET_TOKENS)
    head = _w(no_room, zero, head)

    new_word = max_idx | (tok_flags << FLAG_SHIFT)
    append_mask = (pos == torch.clamp(head, 0, T - 1)[:, None]) & nb[:, None]
    words = _w(append_mask, new_word[:, None], words)
    head = _w(nb, head + 1, head)
    evt["ops"] = evt["ops"] | (nb.to(i32) * (ev.OP_APPEND | ev.OP_PARTIAL))
    evt["tok"] = _w(nb, max_idx, evt["tok"])
    evt["logprob"] = _w(nb, max_val, evt["logprob"])
    evt["flags"] = _w(nb, tok_flags, evt["flags"])
    evt["time_ms"] = _w(active, state["time_ms"], evt["time_ms"])
    state["last_call"] = _w(nb, head, state["last_call"])
    state["emitted_silence"] = state["emitted_silence"] & ~nb

    # ---- blank path (:401-426)
    t_since = (state["time_ms"] - state["last_emit_ms"]).float()
    decayed = max_val - t_since / f32(cfg.silence_decay_ms)
    confident = ~is_equal_prev & (decayed > blank_val - f32(cfg.confident_margin))
    long_sil = t_since >= f32(cfg.long_silence_ms)

    ls = bl & long_sil
    fin_do = ls & (head > 0)
    evt["ops"] = evt["ops"] | (fin_do.to(i32) * ev.OP_FINAL)
    evt["final_k"] = _w(fin_do, head, evt["final_k"])
    state["last_call"] = _w(fin_do, head, state["last_call"])
    head = _w(fin_do, zero, head)

    do_clear = ls & (state["context"][:, 0] != blank_id)
    state["context"] = _w(do_clear[:, None], torch.full_like(state["context"], blank_id), state["context"])
    need_decoder = need_decoder | do_clear

    sil_do = ls & ~state["emitted_silence"]
    evt["ops"] = evt["ops"] | (sil_do.to(i32) * ev.OP_SILENCE)
    state["emitted_silence"] = state["emitted_silence"] | ls

    conf = bl & ~long_sil & confident
    stale_tok = _row_gather(words, torch.clamp(head, 0, T - 1)) & ((1 << FLAG_SHIFT) - 1)
    dedup = (state["last_call"] == head + 1) & (stale_tok == max_idx)
    conf_emit = conf & ~dedup
    conf_mask = (pos == torch.clamp(head, 0, T - 1)[:, None]) & conf_emit[:, None]
    words = _w(conf_mask, new_word[:, None], words)
    evt["ops"] = evt["ops"] | (conf_emit.to(i32) * (ev.OP_APPEND | ev.OP_PARTIAL | ev.OP_POP))
    evt["tok"] = _w(conf_emit, max_idx, evt["tok"])
    evt["logprob"] = _w(conf_emit, max_val - f32(cfg.confident_logprob_penalty), evt["logprob"])
    evt["flags"] = _w(conf_emit, tok_flags, evt["flags"])
    state["last_call"] = _w(conf_emit, head + 1, state["last_call"])

    bare = bl & ~long_sil & ~confident & (state["last_call"] != head)
    evt["ops"] = evt["ops"] | (bare.to(i32) * ev.OP_PARTIAL)
    state["last_call"] = _w(bare, head, state["last_call"])

    state["token_words"] = words
    state["head"] = head
    state = {k: (v.to(i32) if v.dtype == torch.int64 else v) for k, v in state.items()}
    evt = {k: (v.to(i32) if v.dtype == torch.int64 else v) for k, v in evt.items()}
    return state, evt, is_blank, need_decoder
