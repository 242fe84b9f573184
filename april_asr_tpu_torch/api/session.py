"""Session mirroring the reference binding's Session (port of
april_asr_tpu/api/session.py; reference _april.py:110-179,
april_api.h:176-196).

Modes:
  * sync (default): feed_pcm16 runs the engine on the caller's thread and
    the callbacks fire before it returns (april_session.c:479-480).
  * asynchronous: feed_pcm16 pushes the block into an SPSC ring of 3 s of
    audio (native/`AudioRing`) and returns; a worker thread drains the ring
    into the engine, ticks it and fires the callbacks from its own thread
    (reference proc_thread.c). A block that does not fit is dropped and the
    handler gets ERROR_CANT_KEEP_UP on the caller's thread
    (audio_provider.c:59-64).
  * asynchronous and not no_rt (ASYNC_RT): get_rt_speedup() reads the
    engine's realtime-speedup estimate (`BatchEngine.rt_speedup`: an EMA of
    1.1 tick time / chunk time, april_session.c:456-473, scaled by the
    session's staged backlog), and every 2 s the session sets the time
    stretcher (native/`TimeStretcher`) to it, so a session that falls
    behind consumes its audio faster.

A worker that fails (a callback that raises, an engine that cannot
recover) delivers SESSION_ERROR to the handler and ends; feed_pcm16 and
flush then raise, as flush does when the worker has not flushed in 60 s.

speaker_name: the reference reserves per-speaker state but never
implemented it (april_api.h:78-81). As in the JAX package, closing the
session snapshots its state under the speaker key and a new session with the
same key resumes from it (engine/speaker.py; the snapshot files are the JAX
package's). Beam sessions belong to a later slice of the port.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..decode.scalar import RESULT_CANT_KEEP_UP, RESULT_SESSION_ERROR
from ..engine.batch import BatchEngine
from ..native import AudioRing, TimeStretcher
from .model import Model
from .types import Result, Token, tokens_from_scalar

SessionCallback = Callable[[Result, List[Token]], None]

log = logging.getLogger(__name__)


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
        if beam >= 2:
            raise NotImplementedError("beam sessions are not ported yet")
        self.model = model
        self.callback = callback
        self.asynchronous = asynchronous
        self.force_realtime = asynchronous and not no_rt
        self.speaker_name = speaker_name
        self._params = model.runtime.params
        self._engine = BatchEngine(model.runtime, batch=1, prog=model._get_program(batch=1))
        self._slot = self._engine.alloc(self._on_result)
        self._closed = False
        if speaker_name:
            self._try_restore_speaker()

        self._queue: "queue.Queue[tuple]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._ring: Optional[AudioRing] = None
        self._stretcher: Optional[TimeStretcher] = None
        self._worker_error: Optional[BaseException] = None
        self._last_speed_update = time.monotonic()
        if asynchronous:
            rate = model.get_sample_rate()
            self._ring = AudioRing(3 * rate)  # 3 s, as audio_provider.c:31-40
            if self.force_realtime:
                self._stretcher = TimeStretcher(rate)
            self._worker = threading.Thread(target=self._worker_loop, name="april-session",
                                            daemon=True)
            self._worker.start()

    def _on_result(self, result_type: int, scalar_tokens) -> None:
        self.callback(Result(result_type), tokens_from_scalar(self._params, scalar_tokens))

    # -- public API ----------------------------------------------------------

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
        if self.asynchronous:
            self._check_worker()
            # lock-free handoff to the worker; on overflow the whole block is
            # dropped and the handler fires on the caller's thread
            # (april_session.c:480-493)
            if not self._ring.push(pcm):
                self.callback(Result(RESULT_CANT_KEEP_UP), [])
                return
            self._queue.put(("audio",))
        else:
            self._engine.feed(self._slot, pcm)
            self._drain_sync()

    def flush(self) -> None:
        """Process remaining samples and force a final result (aas_flush);
        an asynchronous session waits up to 60 s for its worker, and raises
        where the worker failed or did not flush in that time."""
        if self._closed:
            raise ValueError("session is closed")
        if self.asynchronous:
            self._check_worker()
            done = threading.Event()
            self._queue.put(("flush", done))
            deadline = time.monotonic() + 60.0
            while not done.wait(0.05):
                if not self._worker.is_alive() or time.monotonic() > deadline:
                    break
            self._check_worker()
            if not done.is_set():
                raise TimeoutError("the session's worker did not flush within 60 s")
        else:
            self._engine.flush(self._mask())

    def get_rt_speedup(self) -> float:
        """Realtime speedup estimate (aas_realtime_get_speedup,
        april_api.h:188-192): 1.0 unless ASYNC_RT, else how much faster
        than realtime the session must run to keep up (the engine's tick
        EMA, scaled by this session's backlog: BatchEngine.rt_speedup)."""
        return self._engine.rt_speedup(self._slot) if self.force_realtime else 1.0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._worker is not None:
            self._queue.put(("stop",))
            self._worker.join(timeout=10.0)
        if self.speaker_name:
            self._save_speaker()
        self._engine.free(self._slot)
        if self._ring is not None:
            self._ring.close()
        if self._stretcher is not None:
            self._stretcher.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals -------------------------------------------------------------

    def _mask(self) -> np.ndarray:
        mask = np.zeros(self._engine.batch, bool)
        mask[self._slot] = True
        return mask

    def _drain_sync(self) -> None:
        while self._engine.pending(self._slot) > 0:
            if not self._engine.tick():
                break

    def _check_worker(self) -> None:
        if self._worker_error is not None:
            raise RuntimeError("the session's worker failed") from self._worker_error

    def _worker_loop(self) -> None:
        # the worker launches the model's kernels: on the model's card
        dev = self.model.runtime.device
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                self._serve()
        except Exception as e:  # noqa: BLE001 - the worker reports, then ends
            log.error("session worker failed (%s: %s)", type(e).__name__, e)
            self._worker_error = e
            try:
                self.callback(Result(RESULT_SESSION_ERROR), [])
            except Exception:  # noqa: BLE001 - the handler itself failed
                pass

    def _serve(self) -> None:
        while True:
            try:
                msg = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._ring.available or self._engine.pending(self._slot) > 0:
                    self._tick_async()
                continue
            if msg[0] == "stop":
                return
            if msg[0] == "audio":
                self._tick_async()
            elif msg[0] == "flush":
                # a failed flush leaves `done` unset: flush() sees the worker
                # end, after it has recorded its error
                self._drain_ring(flush=True)
                self._engine.flush(self._mask())
                msg[1].set()

    def _drain_ring(self, flush: bool = False) -> None:
        """Move the ring's audio into the engine, stretched in ASYNC_RT mode
        when behind realtime (fbank_set_speed, re-evaluated every 2 s,
        april_session.c:464-473)."""
        pcm = self._ring.pull(self._ring.capacity)
        if self._stretcher is not None:
            now = time.monotonic()
            if now - self._last_speed_update > 2.0:
                self._last_speed_update = now
                self._stretcher.set_speed(max(1.0, self.get_rt_speedup()))
            pcm = self._stretcher.process(pcm, flush=flush)
        if len(pcm):
            self._engine.feed(self._slot, pcm)

    def _tick_async(self) -> None:
        self._drain_ring()
        self._engine.tick()

    # -- speaker state (engine/speaker.py) -------------------------------------

    def _save_speaker(self) -> None:
        from ..engine.speaker import save_speaker_state

        save_speaker_state(self._engine, self._slot, self.model.get_name(), self.speaker_name)

    def _try_restore_speaker(self) -> None:
        from ..engine.speaker import restore_speaker_state

        restore_speaker_state(self._engine, self._slot, self.model.get_name(), self.speaker_name)
