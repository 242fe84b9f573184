"""PARAMS block parsing and tokenizer tables.

Parses the `PARAMS\\0\\0` blob embedded in `.april` model files with the same
field order and validation ranges as the reference (reference: src/params.c:46-111,
layout written by extra/export-april.py:344-366). Tokens are SentencePiece
pieces with `\\u2581` already replaced by a space at export time
(export-april.py:364).

Beyond the reference, this module also precomputes per-vocab boolean tables
(word boundary, punctuation classes, leading digit) so the decode heuristics of
src/april_session.c:306-429 can run as pure vectorized integer ops on TPU.
"""

from __future__ import annotations

import dataclasses
import io as _stdio
from typing import BinaryIO, List

import numpy as np

from .binio import BinaryFormatError, read_exact, read_i32, write_i32

PARAMS_MAGIC = b"PARAMS\0\0"


@dataclasses.dataclass
class ModelParameters:
    """Mirror of the reference's ModelParameters (src/params.h:26-46)."""

    batch_size: int
    segment_size: int
    segment_step: int
    mel_features: int
    sample_rate: int
    frame_shift_ms: int
    frame_length_ms: int
    round_pow2: bool
    mel_low: int
    mel_high: int
    snip_edges: bool
    blank_id: int
    tokens: List[bytes]

    @property
    def token_count(self) -> int:
        return len(self.tokens)

    def token_str(self, i: int) -> str:
        return self.tokens[i].decode("utf-8", errors="replace")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise BinaryFormatError(f"params validation failed: {what}")


def read_params(f: BinaryIO) -> ModelParameters:
    """Parse a PARAMS blob (reference: read_params_from_fd, src/params.c:46-111)."""
    magic = read_exact(f, 8)
    if magic != PARAMS_MAGIC:
        raise BinaryFormatError("bad PARAMS magic")

    batch_size = read_i32(f)
    segment_size = read_i32(f)
    segment_step = read_i32(f)
    mel_features = read_i32(f)
    sample_rate = read_i32(f)

    frame_shift_ms = read_i32(f)
    frame_length_ms = read_i32(f)
    round_pow2 = read_i32(f) != 0
    mel_low = read_i32(f)
    mel_high = read_i32(f)
    snip_edges = read_i32(f) != 0

    token_count = read_i32(f)
    blank_id = read_i32(f)

    # Same validation ranges as src/params.c:71-82.
    _check(batch_size == 1, "batch_size must be 1")
    _check(0 < segment_size < 100, "segment_size range")
    _check(0 < segment_step < 100 and segment_step <= segment_size, "segment_step range")
    _check(0 < mel_features < 256, "mel_features range")
    _check(0 < sample_rate < 144000, "sample_rate range")
    _check(0 < token_count < 16384, "token_count range")
    _check(0 <= blank_id < token_count, "blank_id range")
    _check(0 < frame_shift_ms <= frame_length_ms, "frame_shift range")
    _check(0 < frame_length_ms <= 5000, "frame_length range")
    _check(0 < mel_low < sample_rate, "mel_low range")
    _check(mel_high == 0 or mel_high > mel_low, "mel_high range")

    tokens = []
    for _ in range(token_count):
        n = read_i32(f)
        _check(0 <= n < 4096, "token length range")
        tokens.append(read_exact(f, n))

    return ModelParameters(
        batch_size=batch_size,
        segment_size=segment_size,
        segment_step=segment_step,
        mel_features=mel_features,
        sample_rate=sample_rate,
        frame_shift_ms=frame_shift_ms,
        frame_length_ms=frame_length_ms,
        round_pow2=round_pow2,
        mel_low=mel_low,
        mel_high=mel_high,
        snip_edges=snip_edges,
        blank_id=blank_id,
        tokens=tokens,
    )


def write_params(params: ModelParameters) -> bytes:
    """Serialize a PARAMS blob in the reference layout (export-april.py:344-366)."""
    f = _stdio.BytesIO()
    f.write(PARAMS_MAGIC)
    write_i32(f, params.batch_size)
    write_i32(f, params.segment_size)
    write_i32(f, params.segment_step)
    write_i32(f, params.mel_features)
    write_i32(f, params.sample_rate)
    write_i32(f, params.frame_shift_ms)
    write_i32(f, params.frame_length_ms)
    write_i32(f, 1 if params.round_pow2 else 0)
    write_i32(f, params.mel_low)
    write_i32(f, params.mel_high)
    write_i32(f, 1 if params.snip_edges else 0)
    write_i32(f, params.token_count)
    write_i32(f, params.blank_id)
    for tok in params.tokens:
        write_i32(f, len(tok))
        f.write(tok)
    return f.getvalue()


@dataclasses.dataclass(frozen=True)
class VocabTables:
    """Per-vocab boolean/float tables backing the decode heuristics on device.

    Each entry vectorizes a string test from src/april_session.c:
      word_boundary: token[0] == ' '                    (:338)
      single_char:   token has byte length 1            (:340)
      end_sentence:  single char in {'.', '!', '?'}     (:341)
      punctuation:   end_sentence or single-char ','    (:342)
      starts_digit:  token[0] in '0'..'9'               (:347)
    """

    word_boundary: np.ndarray  # bool [V]
    single_char: np.ndarray  # bool [V]
    end_sentence: np.ndarray  # bool [V]
    punctuation: np.ndarray  # bool [V]
    starts_digit: np.ndarray  # bool [V]
    is_dot: np.ndarray  # bool [V] (token == ".")


def build_vocab_tables(params: ModelParameters) -> VocabTables:
    v = params.token_count
    word_boundary = np.zeros(v, dtype=bool)
    single_char = np.zeros(v, dtype=bool)
    end_sentence = np.zeros(v, dtype=bool)
    punctuation = np.zeros(v, dtype=bool)
    starts_digit = np.zeros(v, dtype=bool)
    is_dot = np.zeros(v, dtype=bool)
    for i, tok in enumerate(params.tokens):
        if len(tok) == 0:
            continue
        first = tok[0:1]
        word_boundary[i] = first == b" "
        single_char[i] = len(tok) == 1
        end_sentence[i] = single_char[i] and first in (b".", b"!", b"?")
        punctuation[i] = end_sentence[i] or (single_char[i] and first == b",")
        starts_digit[i] = b"0" <= first <= b"9"
        is_dot[i] = single_char[i] and first == b"."
    return VocabTables(
        word_boundary=word_boundary,
        single_char=single_char,
        end_sentence=end_sentence,
        punctuation=punctuation,
        starts_digit=starts_digit,
        is_dot=is_dot,
    )
