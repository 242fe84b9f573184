"""Synchronous Session mirroring the reference binding's Session (port of
april_asr_tpu/api/session.py; reference _april.py:110-179,
april_api.h:176-196).

feed_pcm16 runs the engine on the caller's thread and the callbacks fire
before it returns (the reference's sync path, april_session.c:479-480).
The asynchronous modes (native ring, time stretcher), speaker-state
snapshots and beam sessions belong to later slices of the port.
"""

from __future__ import annotations

import os
from typing import Callable, List

import numpy as np

from ..engine.batch import BatchEngine
from .model import Model
from .types import Result, Token, tokens_from_scalar

SessionCallback = Callable[[Result, List[Token]], None]


class Session:
    """A speech recognition session bound to a Model (batch-1 engine)."""

    def __init__(
        self,
        model: Model,
        callback: SessionCallback,
        asynchronous: bool = False,
        no_rt: bool = False,
        speaker_name: str = "",
        beam: int = 0,
    ):
        if callback is None:
            # reference: april_session.c:81-85
            raise ValueError("a handler is required, please provide a handler")
        if asynchronous:
            raise NotImplementedError("asynchronous sessions are not ported yet")
        if speaker_name:
            raise NotImplementedError("speaker-state sessions are not ported yet")
        if beam >= 2:
            raise NotImplementedError("beam sessions are not ported yet")
        self.model = model
        self.callback = callback
        self._params = model.runtime.params
        self._engine = BatchEngine(model.runtime, batch=1, prog=model._get_program(batch=1))
        self._slot = self._engine.alloc(self._on_result)
        self._closed = False

    def _on_result(self, result_type: int, scalar_tokens) -> None:
        self.callback(Result(result_type), tokens_from_scalar(self._params, scalar_tokens))

    def feed_pcm16(self, data) -> None:
        """Feed PCM16 mono samples (bytes or int16 array) at the model's
        sample rate (aas_feed_pcm16, april_api.h:180-183)."""
        if self._closed:
            raise ValueError("session is closed")
        if isinstance(data, (bytes, bytearray)):
            pcm = np.frombuffer(data, dtype="<i2")
        else:
            pcm = np.asarray(data, np.int16)
        debug_path = os.environ.get("APRIL_DEBUG_SAVE_AUDIO")
        if debug_path:
            # golden-input capture hook: append the float waveform exactly as
            # the frontend sees it (reference APRIL_DEBUG_SAVE_AUDIO,
            # april_session.c:496-537; here env-gated at runtime)
            with open(debug_path, "ab") as f:
                (pcm.astype(np.float32) / 32768.0).tofile(f)
        self._engine.feed(self._slot, pcm)
        while self._engine.pending(self._slot) > 0:
            if not self._engine.tick():
                break

    def flush(self) -> None:
        """Process remaining samples and force a final result (aas_flush)."""
        if self._closed:
            raise ValueError("session is closed")
        mask = np.zeros(self._engine.batch, bool)
        mask[self._slot] = True
        self._engine.flush(mask)

    def get_rt_speedup(self) -> float:
        """Realtime speedup estimate; 1.0 for synchronous sessions, as in
        the reference (aas_realtime_get_speedup, april_api.h:188-192)."""
        return 1.0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._engine.free(self._slot)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
