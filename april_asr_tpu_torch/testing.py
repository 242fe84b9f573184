"""Test and smoke-run helpers: the vocabulary of april_asr_tpu/testing.py
that random-weight models use, and a recorder of the plain greedy decode's
decision margins."""

from __future__ import annotations

from typing import List

import numpy as np


def default_tokens(vocab: int, blank_id: int = 0) -> List[bytes]:
    """A plausible SentencePiece-like vocabulary for testing: blank, word
    pieces with/without leading space, punctuation, digits."""
    base = [
        b"<blk>", b" the", b" a", b" and", b" to", b" of", b" in", b" it",
        b" is", b" was", b" i", b" he", b" that", b" you", b" his", b" on",
        b"s", b"ing", b"ed", b"er", b"ly", b"tion", b"es", b"re", b"an",
        b"ar", b"or", b"en", b"al", b"le", b".", b",", b"!", b"?", b"'",
        b"0", b"1", b"2", b"3", b"9", b" one", b" two", b" ten", b" time",
        b" hand", b" day", b" way", b" man", b" world", b" great", b" old",
        b" right", b" elephant", b" cool", b" water", b" sound", b" place",
        b"ous", b"ment", b"ness", b"ful", b"ted", b"ter", b"ver",
    ]
    toks = list(base[:vocab])
    i = 0
    while len(toks) < vocab:
        toks.append(f"tok{i}".encode())
        i += 1
    toks[blank_id] = b"<blk>"
    return toks


class DecisionMargins:
    """Records, for every round of the plain greedy decode (the plain joiner
    `ops/joiner_kernels.joiner_argmax_plain`, then `decode_step_pre`, in the
    whole-chunk decode and in the per-pull `inner_decode` alike) and every
    session, the smallest margin by which a float decision was taken: blank
    against the best token (with the early-emit bonus), the best token
    against the second best, and the punctuation and confident-blank
    thresholds where they applied (inf for sessions not decoding in that
    round). Int8 re-quantization turns an f32 ulp into a logit shift of
    about 1e-3, so two implementations may take a decision apart only where
    its margin is small; parity checks use this to show that the first
    event where two streams part was a near-tie.

        with DecisionMargins() as m:
            engine.tick()
        m.per_cell(n_cells)  # [n_cells, S], rounds in event-cell order
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.cells = []

    def per_cell(self, n_cells: int) -> np.ndarray:
        """Margins of the rounds since the last reset, padded with inf to
        `n_cells` (the flush's closing event group takes no decision)."""
        m = np.stack(self.cells)
        pad = np.full((n_cells - m.shape[0], m.shape[1]), np.inf)
        return np.concatenate([m, pad])

    def __enter__(self):
        from .decode import greedy
        from .ops import joiner_kernels as jk

        self._mods = (jk, greedy)
        self._orig = (jk.joiner_argmax_plain, greedy.decode_step_pre)
        self._gap = None
        orig_prologue, orig_step = self._orig

        def prologue(eout, dout, w_t, b, blank_id):
            logits = jk.joiner_logits_plain(eout, dout, w_t, b)
            logits[:, blank_id] = float("-inf")
            top2 = logits.topk(2, dim=1).values
            self._gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            return orig_prologue(eout, dout, w_t, b, blank_id)

        def step(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg):
            self._record(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg)
            return orig_step(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg)

        jk.joiner_argmax_plain, greedy.decode_step_pre = prologue, step
        return self

    def __exit__(self, *exc):
        jk, greedy = self._mods
        jk.joiner_argmax_plain, greedy.decode_step_pre = self._orig

    def _record(self, state, mi, mv, bv, active, early_emit, blank_id, vt, cfg):
        from .decode.greedy import MASK_PUNCT

        f = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
        mi, mv, bv = mi.cpu().numpy(), f(mv), f(bv)
        last = state["context"][:, -1].cpu().numpy()
        eq = last == mi
        eff = np.where(eq, 0.0, early_emit)
        margin = np.minimum(np.abs(bv - eff - mv), self._gap)
        punct = (np.asarray(vt["mask"])[mi] & MASK_PUNCT) != 0
        boost_live = punct & (last != blank_id) & ~eq
        margin = np.where(boost_live, np.minimum(margin, np.abs(mv - (bv - cfg.punctuation_margin))), margin)
        t_since = f(state["time_ms"] - state["last_emit_ms"])
        blank = (bv - eff > mv) & ~(boost_live & (mv > bv - cfg.punctuation_margin))
        conf_live = blank & ~eq & (t_since < cfg.long_silence_ms)
        decayed = mv - t_since / cfg.silence_decay_ms
        margin = np.where(conf_live, np.minimum(margin, np.abs(decayed - (bv - cfg.confident_margin))), margin)
        self.cells.append(np.where(active.cpu().numpy(), margin, np.inf))


# A logit margin under which two implementations may take a decision apart.
# Int8 re-quantization turns an f32 ulp at a rounding boundary into one int8
# step, the steps compound through the recurrent state, and two
# implementations' encoder states are only held to p99 < 0.05 (the
# cross-implementation bound of tests/test_lstm_int8.py:69-80); a logit
# moves by as much.
NEAR_TIE = 0.05
EVENT_FIELDS = ("ops", "tok", "flags", "final_k")
INT_DECODE = ("context", "token_words", "head", "last_call", "time_ms", "last_emit_ms",
              "need_dec", "emitted_silence")


def capture_events(prog, unpack, sink: list) -> None:
    """Wrap prog.step and prog.flush so every call's events, unpacked by
    `unpack` (an engine/step.py `unpack_events_np`), are appended to sink."""
    for name in ("step", "flush"):
        fn = getattr(prog, name)

        def wrapped(*a, fn=fn):
            state, packed = fn(*a)
            sink.append(unpack(packed))
            return state, packed

        setattr(prog, name, wrapped)


def check_parting(step, ev_ref, ev, cells, recs_ref, recs, dec_ref, dec, parted: dict) -> None:
    """One engine step of a lockstep comparison of two engines on the same
    audio. A session whose event cells (pull-major, round-minor) first
    differ in this step is entered in `parted` as (step, cell, margin) and
    must have been decided by less than NEAR_TIE there (`cells` [n, S] from
    DecisionMargins on the plain side); a session still in step must have
    equal callbacks `recs` and integer decode state (`dec`: INT_DECODE keys
    to host arrays). Raises AssertionError otherwise."""
    for s in range(ev_ref["ops"].shape[0]):
        if s in parted:
            continue
        differ = np.zeros(np.asarray(ev_ref["ops"][s]).size, bool)
        for f in EVENT_FIELDS:
            differ |= (np.asarray(ev_ref[f][s]) != np.asarray(ev[f][s])).reshape(-1)
        if differ.any():
            first = int(np.argmax(differ))
            parted[s] = (step, first, float(cells[first, s]))
            if cells[first, s] >= NEAR_TIE:
                raise AssertionError(
                    f"session {s} parted at step {step}, event cell {first}, where the "
                    f"plain decode's margin was {cells[first, s]:.4f} >= {NEAR_TIE}")
            continue
        if recs_ref[s] != recs[s]:
            raise AssertionError(f"session {s}: callbacks differ while the events agree")
        for key in INT_DECODE:
            if not np.array_equal(dec_ref[key][s], dec[key][s]):
                raise AssertionError(f"session {s}: decode state {key} differs while the events agree")
