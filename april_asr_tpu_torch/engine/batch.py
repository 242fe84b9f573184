"""Host-side batched session engine on one device: slot allocation, audio
staging, ticks, flush (port of april_asr_tpu/engine/batch.py).

S sessions share one set of device state tensors and one step program; the
host stages incoming PCM16 per slot, runs one step per tick for all slots,
and replays the returned event blob into per-session callbacks. Staged audio
beyond `max_buffered_seconds` is dropped and the session's handler gets
ERROR_CANT_KEEP_UP (reference: audio_provider.c:59-64,
april_session.c:485-492).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import DecodeConfig, EngineConfig
from ..decode.scalar import RESULT_CANT_KEEP_UP, ScalarToken
from ..models.loader import ModelRuntime
from .replay import EventReplayer
from .step import EngineProgram, PackedEvents, build_engine, init_engine_state

log = logging.getLogger(__name__)


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
        self._lock = threading.Lock()
        self._step_lock = threading.RLock()

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

    def tick(self) -> bool:
        """Run one chunk step for all slots with staged audio. Returns True
        if any session had samples to process."""
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
        with self._step_lock:
            self.state, events = self.prog.step(
                self.weights, self.state,
                torch.from_numpy(audio).to(dev), torch.from_numpy(n).to(dev),
            )
        replay_packed(events, self.slots)
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
            self.state, events = self.prog.flush(
                self.weights, self.state, torch.from_numpy(slot_mask).to(self.rt.device)
            )
        replay_packed(events, self.slots)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)
