"""Host-side batched session engine on one device: slot allocation, audio
staging, ticks, flush (port of april_asr_tpu/engine/batch.py).

S sessions share one set of device state tensors and one step program; the
host stages incoming PCM16 per slot, runs one step per tick for all slots,
and replays the returned event blob into per-session callbacks. Staged audio
beyond `max_buffered_seconds` is dropped and the session's handler gets
ERROR_CANT_KEEP_UP (reference: audio_provider.c:59-64,
april_session.c:485-492).

A failed step or flush is contained (JAX batch.py:365-446): the programs
leave the state they are given unchanged, so the engine sweeps that state
for non-finite rows, evicts just those slots (SESSION_ERROR) and runs the
program again for the others; only where the retry fails too does every
session restart from fresh state. Failures, retries and recoveries are
logged through `logging` and counted in `CONTAINED` (the JAX package counts
them as metrics). A tensor-parallel engine does not contain: a failure on
one rank re-raises there, since the sweep is a collective that the other
ranks, already in their next step's collectives, would not join.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import DecodeConfig, EngineConfig
from ..decode.scalar import RESULT_CANT_KEEP_UP, RESULT_SESSION_ERROR, ScalarToken
from ..models.loader import ModelRuntime
from .replay import EventReplayer
from .step import EngineProgram, PackedEvents, build_engine, init_engine_state

log = logging.getLogger(__name__)

# Program failures caught by tick or flush ("failures") and restarts of a
# whole engine ("recoveries"), by every engine of this process: plain ints
# until the port has the JAX package's metrics counters. A run that must not
# have failed reads them (testing.engine_run, chip_smoke.py).
CONTAINED = {"failures": 0, "recoveries": 0}
_contained_lock = threading.Lock()


def _count(key: str) -> None:
    with _contained_lock:
        CONTAINED[key] += 1


def replay_packed(packed, slots) -> int:
    """Replay step/flush events into per-slot replayers through the
    pure-Python blob path; the dense tensor is read only for sub-blobs whose
    event count overflowed the compact budget. Returns events applied."""
    from .step import iter_blobs

    if not isinstance(packed, PackedEvents):
        return _replay_dense(_host(packed), slots)
    arr = np.ascontiguousarray(_host(packed.blob), dtype=np.int32)
    n = 0
    dense = None
    for base, sub in iter_blobs(arr):
        S, K = int(sub[1]), int(sub[2])
        if int(sub[4 : 4 + S].sum()) > K:
            if dense is None:
                dense = _host(packed.dense)
            n += _replay_dense(dense[base : base + S], slots[base : base + S])
        else:
            n += _replay_blob(sub, slots[base : base + S])
    return n


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _replay_dense(arr: np.ndarray, slots) -> int:
    from .step import unpack_events_np

    ev = unpack_events_np(arr)
    coords = np.argwhere(ev["ops"] != 0)
    n = 0
    for s, p, j in coords:
        slot = slots[s]
        if slot is None:
            continue
        slot.replayer.apply(
            int(ev["ops"][s, p, j]), int(ev["tok"][s, p, j]), float(ev["logprob"][s, p, j]),
            int(ev["flags"][s, p, j]), int(ev["time_ms"][s, p]), int(ev["final_k"][s, p, j]),
        )
        n += 1
    return n


def _replay_blob(sub: np.ndarray, slots) -> int:
    from .step import unpack_blob_np

    ev = unpack_blob_np(sub)
    n = 0
    stride = ev["stride"]
    base_time, sess = ev["base_time"], ev["session"]
    for k in range(ev["total"]):
        s = int(sess[k])
        slot = slots[s]
        if slot is None:
            continue
        slot.replayer.apply(
            int(ev["ops"][k]), int(ev["tok"][k]), float(ev["logprob"][k]), int(ev["flags"][k]),
            int(base_time[s]) + int(ev["dt"][k]) * stride, int(ev["final_k"][k]),
        )
        n += 1
    return n


class _Slot:
    def __init__(self, replayer: EventReplayer, handler):
        self.replayer = replayer
        self.handler = handler
        self.staged = np.zeros(0, np.int16)
        self.was_flushed = False


class BatchEngine:
    """S-session batched engine over one model on one device, or over one
    model shard of a tensor-parallel mesh."""

    def __init__(
        self,
        rt: ModelRuntime,
        batch: int = 8,
        cfg: EngineConfig | None = None,
        dcfg: DecodeConfig | None = None,
        prog: EngineProgram | None = None,
        mesh=None,
    ):
        """`prog` lets several engines share one program (every batch-1
        Session of a Model reuses the same one).

        `mesh` (parallel.make_mesh, model_parallel m > 1) makes this the
        engine of one model shard: each of the m processes of the default
        process group builds its own BatchEngine with the same model, slots
        and audio, holds its gate-shuffled slice of the encoder weights
        (parallel/tp.py) and its [L, S, H/m] slice of the cell state, and
        all-reduces the layers' partial sums with the others every pull
        (JAX batch.py:221-257). Everything else is replicated, so every
        rank replays the same events to its handlers."""
        self.rt = rt
        if prog is not None and prog.batch != batch:
            raise ValueError(f"program batch {prog.batch} != engine batch {batch}")
        self.prog = prog or build_engine(rt, batch, cfg or EngineConfig(), dcfg or DecodeConfig(),
                                         mesh=mesh)
        self.cfg = self.prog.cfg
        self.dcfg = self.prog.dcfg
        self.batch = batch
        self.mesh = mesh
        if self.prog.tp_axes:
            from ..parallel.tp import prepare_tp_weights

            self.weights = prepare_tp_weights(rt.weights, self.prog.mesh)
        else:
            self.weights = rt.weights
        with torch.no_grad():
            self.state = init_engine_state(self.prog, self.weights)
        self._init_state = _map(self.state, lambda t: t.clone())
        self.slots: List[Optional[_Slot]] = [None] * batch
        self.max_staged = int(self.cfg.max_buffered_seconds * rt.sample_rate)
        # realtime-speedup estimate (april_session.c:456-462: speed_needed =
        # 0.9 old + 0.1 (1.1 elapsed / audio), EMA'd per inference round;
        # here per engine tick over the batched chunk)
        self._speed_ema = 1.0
        self._lock = threading.Lock()
        # serialises every state transition (step, flush, slot reset, speaker
        # snapshots); an RLock because flush drains through tick
        self._step_lock = threading.RLock()

    # -- failure containment -----------------------------------------------

    def _contain(self, exc: Exception, run) -> bool:
        """Per-slot containment of a step or flush failure (JAX batch.py
        `_contain`). The programs leave the state they are given unchanged,
        so the pre-step state survived: sweep it for poisoned slots, evict
        just those, then run the program again (`run(bad)`) for the others,
        whose streams go on as if the failure had not happened. Where the
        sweep or the retry fails too, `_recover`. Returns True when the
        retry produced a result (stored by `run`). On a tensor-parallel
        engine, re-raises `exc` instead."""
        _count("failures")
        if self.prog.tp_axes:
            raise exc
        log.error("engine program failed (%s: %s); scrubbing and retrying",
                  type(exc).__name__, exc)
        try:
            bad = self._scrub_impl()
            if bad:
                log.warning("containment: evicted %d poisoned slot(s)", len(bad))
            run(bad)
            return True
        except Exception as exc2:  # noqa: BLE001 - any program failure
            self._recover(exc2)
            return False

    def _recover(self, exc: Exception) -> None:
        """Last resort after a failed step or flush (JAX batch.py
        `_recover`): the state is rebuilt from the initial template, every
        live session's handler receives SESSION_ERROR, staged audio is
        dropped, and the engine keeps serving. The reference aborts the
        process instead (ort_util.h:29-38)."""
        log.error("engine program failed (%s: %s); recovering", type(exc).__name__, exc)
        _count("recoveries")
        with self._step_lock:
            self.state = _map(self._init_state, lambda t: t.clone())
        with self._lock:
            live = [s for s in self.slots if s is not None]
        for s in live:
            self._evict(s)

    def _evict(self, s: _Slot) -> None:
        """Drop a session's staged audio and decode history and tell its
        handler (outside the staging lock, which a handler may take)."""
        with self._lock:
            s.staged = np.zeros(0, np.int16)
            s.was_flushed = False
            s.replayer = EventReplayer(self.rt.params, s.handler)
        s.handler(RESULT_SESSION_ERROR, [])

    def scrub(self) -> int:
        """Sweep for silent numerical corruption (JAX batch.py `scrub`):
        slots whose carried state (LSTM h and c, decoder output) holds a
        non-finite value are reset to the initial template and their
        handlers get SESSION_ERROR; the other sessions are untouched.
        Returns the number of slots evicted. On a tensor-parallel engine
        every rank calls it together (the verdict is all-reduced); its
        failed programs are not contained."""
        return len(self._scrub_impl())

    def _scrub_impl(self) -> list:
        """scrub()'s body; returns the evicted slot indices."""
        with self._step_lock:
            evicted = [int(i) for i in np.nonzero(self._bad_slots())[0]]
            for i in evicted:
                self._reset_slot_state(i)
                if self.slots[i] is not None:
                    self._evict(self.slots[i])
        return evicted

    def _bad_slots(self) -> np.ndarray:
        """[S] bool: a non-finite h, c or dout row, one reduction on the
        state's device (over every rank's slice of c on a TP engine)."""
        with torch.no_grad():
            st = self.state
            ok = (torch.isfinite(st["h"]).all(dim=2).all(dim=0)
                  & torch.isfinite(st["c"]).all(dim=2).all(dim=0)
                  & torch.isfinite(st["decode"]["dout"]).all(dim=1))
            bad = (~ok).to(torch.int32)
            if self.prog.tp_axes:
                bad = self.prog.mesh.all_reduce(bad, "max")
            return bad.cpu().numpy() != 0

    # -- slot lifecycle ----------------------------------------------------

    def alloc(self, handler: Callable[[int, List[ScalarToken]], None]) -> int:
        """Claim a slot; `handler(result_type, tokens)` receives results."""
        with self._lock:
            for i, s in enumerate(self.slots):
                if s is None:
                    self.slots[i] = _Slot(EventReplayer(self.rt.params, handler), handler)
                    self._reset_slot_state(i)
                    return i
        raise RuntimeError("no free session slots")

    def free(self, slot: int) -> None:
        with self._lock:
            self.slots[slot] = None

    def _reset_slot_state(self, i: int) -> None:
        """Reset one slot's device state to the initial template."""
        with self._step_lock, torch.no_grad():
            st, init = self.state, self._init_state
            for group in ("fbank", "decode"):
                st[group] = dict(st[group])
                for k, v in st[group].items():
                    v = v.clone()
                    v[i] = init[group][k][0]
                    st[group][k] = v
            for k in ("h", "c"):
                v = st[k].clone()
                v[:, i] = init[k][:, 0]
                st[k] = v

    # -- audio path --------------------------------------------------------

    def feed(self, slot: int, pcm16: np.ndarray) -> None:
        """Stage PCM16 samples for a slot (non-blocking)."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} not allocated")
        s.was_flushed = False
        with self._lock:
            if len(s.staged) + len(pcm16) > self.max_staged:
                # bounded-buffer overflow (audio_provider.c:59-64)
                s.handler(RESULT_CANT_KEEP_UP, [])
                log.warning("slot %d: dropping %d samples (can't keep up)", slot, len(pcm16))
                return
            s.staged = np.concatenate([s.staged, np.asarray(pcm16, np.int16)])

    def pending(self, slot: int) -> int:
        s = self.slots[slot]
        return len(s.staged) if s else 0

    def rt_speedup(self, slot: Optional[int] = None) -> float:
        """Per-session realtime-speedup estimate (aas_realtime_get_speedup,
        april_api.h:188-192; JAX batch.py `rt_speedup`): how much faster
        than realtime this session's audio must be consumed for the engine
        to keep up. The base is the tick EMA of 1.1 tick time / chunk time;
        a slot with staged audio must also drain it within the buffer
        bound, so its estimate scales by (1 + backlog / buffer). An ASYNC_RT
        Session reports it and sets its time stretcher from it."""
        v = self._speed_ema
        if slot is not None and 0 <= slot < self.batch:
            s = self.slots[slot]
            if s is not None and self.max_staged > 0:
                v *= 1.0 + len(s.staged) / float(self.max_staged)
        return float(v)

    def tick(self) -> bool:
        """Run one chunk step for all slots with staged audio. Returns True
        if any session had samples to process (and the step, or its retry
        after containment, ran)."""
        chunk = self.cfg.chunk_samples
        audio = np.zeros((self.batch, chunk), np.int16)
        n = np.zeros(self.batch, np.int32)
        with self._lock:
            for i, s in enumerate(self.slots):
                if s is None or len(s.staged) == 0:
                    continue
                take = min(chunk, len(s.staged))
                audio[i, :take] = s.staged[:take]
                s.staged = s.staged[take:]
                n[i] = take
        if not n.any():
            return False
        dev = self.rt.device
        t0 = time.perf_counter()
        with self._step_lock:
            out = {}

            def run(bad=()):
                # evicted slots must not take the chunk the failed step was
                # fed: their streams restarted at SESSION_ERROR
                nn = n
                if len(bad):
                    nn = n.copy()
                    nn[list(bad)] = 0
                out["v"] = self.prog.step(
                    self.weights, self.state,
                    torch.from_numpy(audio).to(dev), torch.from_numpy(nn).to(dev),
                )

            try:
                run()
            except Exception as e:  # noqa: BLE001 - any program failure
                if not self._contain(e, run):
                    return False
            self.state, events = out["v"]
        replay_packed(events, self.slots)
        dt = time.perf_counter() - t0
        chunk_s = chunk / self.rt.sample_rate
        self._speed_ema = (self._speed_ema * 9.0 + (dt * 1.1) / chunk_s) / 10.0
        return True

    def flush(self, slot_mask: np.ndarray) -> None:
        """Run the flush program for the masked slots (aas_flush: drains
        staged audio first, then pads and finalizes)."""
        with self._step_lock:
            while any(
                self.slots[i] is not None and len(self.slots[i].staged) > 0
                for i in range(self.batch) if slot_mask[i]
            ):
                self.tick()
            slot_mask = np.asarray(slot_mask, bool).copy()
            for i in range(self.batch):
                if slot_mask[i] and self.slots[i] is not None:
                    if self.slots[i].was_flushed:
                        slot_mask[i] = False  # guard, april_session.c:548-550
                    else:
                        self.slots[i].was_flushed = True
            if not slot_mask.any():
                return
            out = {}

            def run(bad=()):
                m = slot_mask
                if len(bad):
                    m = slot_mask.copy()
                    m[list(bad)] = False
                out["v"] = self.prog.flush(
                    self.weights, self.state, torch.from_numpy(m).to(self.rt.device)
                )

            try:
                run()
            except Exception as e:  # noqa: BLE001 - any program failure
                if not self._contain(e, run):
                    return
            self.state, events = out["v"]
        replay_packed(events, self.slots)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)
