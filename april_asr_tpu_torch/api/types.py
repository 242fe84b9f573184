"""Public result/token types, mirroring the reference Python binding
(reference: bindings/python/april_asr/_april.py:11-57)."""

from __future__ import annotations

from enum import IntEnum
from typing import List

from ..decode.scalar import ScalarToken
from ..io.params import ModelParameters


class Result(IntEnum):
    """Result type passed to session handlers (_april.py:11-30,
    AprilResultType april_api.h:86-106)."""

    PARTIAL_RECOGNITION = 1
    FINAL_RECOGNITION = 2
    ERROR_CANT_KEEP_UP = 3
    SILENCE = 4
    # Framework extension (JAX api/types.py:20-24): the session's device
    # state was lost to a contained engine failure and reset (the reference
    # would abort() the process, ort_util.h:29-38). The session remains
    # usable from fresh state.
    SESSION_ERROR = 5


class Token:
    """A decoded token: text chunk with its own formatting (leading space =
    new word), log probability, flags, and emission time (_april.py:32-57)."""

    token: str
    logprob: float
    word_boundary: bool
    sentence_end: bool
    time: float

    def __init__(self, token: str, logprob: float, flags: int, time_ms: int):
        self.token = token
        self.logprob = float(logprob)
        self.word_boundary = (flags & 1) != 0
        self.sentence_end = (flags & 2) != 0
        self.time = float(time_ms) / 1000.0
        self.flags = flags
        self.time_ms = time_ms

    def __repr__(self):
        return f"Token({self.token!r}, lp={self.logprob:.2f}, t={self.time:.2f}s)"


def tokens_from_scalar(params: ModelParameters, toks: List[ScalarToken]) -> List[Token]:
    return [
        Token(params.token_str(t.token_id), t.logprob, t.flags, t.time_ms)
        for t in toks
    ]
