"""Result codes and the token record of the host-side decode mirror (the
parts of april_asr_tpu/decode/scalar.py that the engine and API use; the
scalar oracle decoder itself stays in the JAX package's tests)."""

from __future__ import annotations

import dataclasses

RESULT_PARTIAL = 1
RESULT_FINAL = 2
RESULT_CANT_KEEP_UP = 3
RESULT_SILENCE = 4
# the session's state was lost to a contained engine failure and reset
# (engine/batch.py `_contain`, `scrub`); the reference aborts instead
RESULT_SESSION_ERROR = 5


@dataclasses.dataclass
class ScalarToken:
    token_id: int
    logprob: float
    flags: int
    time_ms: int
