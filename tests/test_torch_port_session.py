"""Port parity: the asynchronous Session modes (april_asr_tpu_torch/api/
session.py, JAX api/session.py:106-261).

One tiny random native `.april` (blank logit biased +1.0), written by the
JAX package and loaded by both, at int8 on the CPU:

* An asynchronous `no_rt` Session fed chunk-sized blocks (3 s of 200 ms
  blocks) gives exactly the callback stream of a synchronous Session: the
  worker drains the ring into the same staging, so every tick takes the
  same chunk.
* That stream against the JAX package's asynchronous Session on the same
  model and audio, call by call (every step and the flush), up to a
  decision the port took by a near-tie (`testing.check_parting`, as
  tests/test_torch_port_engine.py holds the engines).
* An ASYNC_RT Session whose ticks are slowed to ~1.4x realtime (as
  tests/test_realtime_degradation.py slows the JAX one; here its step
  program, inside the tick the engine times) reports get_rt_speedup() >
  1.05, sets its time stretcher above 1x after 2 s, drops nothing (no
  ERROR_CANT_KEEP_UP) and ends with a FINAL.
* `BatchEngine.rt_speedup`: the tick EMA and a slot's backlog factor, which
  an ASYNC_RT Session reports.
* A worker that fails (its callback raises, or a tick raises) delivers
  SESSION_ERROR and ends; flush and feed_pcm16 then raise.
* `beam >= 2` still raises.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax

from april_asr_tpu.api import Model as JModel
from april_asr_tpu.api import Session as JSession
from april_asr_tpu.engine.step import unpack_events_np as j_unpack
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.api import Model, Result, Session
from april_asr_tpu_torch.engine import batch as TB
from april_asr_tpu_torch.engine.step import unpack_events_np as t_unpack
from april_asr_tpu_torch.testing import INT_DECODE, DecisionMargins, check_parting

DIMS_KW = dict(d_model=64, hidden=96, ffn=128, joiner_dim=64, vocab=48, layers=2,
               decoder_groups=16, conv_channels=(4, 8, 8))
BLOCK = 3200  # the engines' default chunk: 200 ms at 16 kHz


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def april(tmp_path_factory):
    dims = JM.TransducerDims(**DIMS_KW)
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(5), dims).items()}
    p["join_b"] = p["join_b"].copy()
    p["join_b"][0] += 1.0
    path = str(tmp_path_factory.mktemp("session") / "session.april")
    j_save_april(path, dims, p, j_mmp(dims, default_tokens(dims.vocab)), name="sess",
                 form="native")
    return path


def _pcm(seconds=3, seed=9):
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000.0
    gate = (np.sin(2 * np.pi * 1.3 * t) > -0.2).astype(np.float32)
    x = 0.35 * np.sin(2 * np.pi * 220 * t) * gate + rng.normal(0, 0.05, t.size)
    return (x * 20000).astype(np.int16)


def _run(session_cls, model, pcm, **kw):
    """Feed `pcm` in BLOCK-sample blocks, flush, close: the callbacks."""
    got = []
    sess = session_cls(model, lambda r, toks: got.append(
        (int(r), tuple((t.token, t.time_ms) for t in toks))), **kw)
    for off in range(0, len(pcm), BLOCK):
        sess.feed_pcm16(pcm[off : off + BLOCK].tobytes())
    sess.flush()
    sess.close()
    return got


def test_async_no_rt_equals_sync(april):
    model = Model(april, precision="int8", device="cpu")
    pcm = _pcm()
    sync = _run(Session, model, pcm)
    asyn = _run(Session, model, pcm, asynchronous=True, no_rt=True)
    assert asyn == sync
    assert any(r == int(Result.FINAL_RECOGNITION) for r, _ in sync)
    assert all(r != int(Result.ERROR_CANT_KEEP_UP) for r, _ in asyn)


def _record(prog, unpack, dec_np, sink, margins=None):
    """Wrap prog.step and prog.flush: each call's events, decode state and
    (with `margins`) the plain decode's margins per event cell, taken on the
    thread that runs the call."""
    for name in ("step", "flush"):
        fn = getattr(prog, name)

        def wrapped(*a, fn=fn):
            state, packed = fn(*a)
            ev = unpack(packed)
            cells = None
            if margins is not None:
                cells = margins.per_cell(ev["ops"].shape[1] * ev["ops"].shape[2])
                margins.reset()
            sink.append((ev, cells, {k: dec_np(state["decode"][k]) for k in INT_DECODE}))
            return state, packed

        setattr(prog, name, wrapped)


def test_async_matches_jax_async(april, monkeypatch):
    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    pcm = _pcm()
    tm = Model(april, precision="int8", device="cpu")
    jm = JModel(april, precision="int8")
    tcalls, jcalls = [], []
    _record(jm._get_program(batch=1), j_unpack, np.asarray, jcalls)
    jrec = _run(JSession, jm, pcm, asynchronous=True, no_rt=True)
    with DecisionMargins() as margins:
        _record(tm._get_program(batch=1), t_unpack, lambda t: t.numpy(), tcalls, margins)
        trec = _run(Session, tm, pcm, asynchronous=True, no_rt=True)
    assert len(tcalls) == len(jcalls) == len(pcm) // BLOCK + 1
    parted = {}
    for k, ((jev, _, jdec), (tev, cells, tdec)) in enumerate(zip(jcalls, tcalls)):
        last = k == len(tcalls) - 1
        check_parting(k, jev, tev, cells, [jrec if last else []], [trec if last else []],
                      jdec, tdec, parted, precision="int8")
    assert any(r == int(Result.FINAL_RECOGNITION) for r, _ in jrec)
    print(f"async session vs JAX: parted at near-ties (call, cell, margin): {parted}")


def test_async_rt_behind_realtime_stretches(april, monkeypatch):
    """Step programs slowed to 0.28 s a 0.2 s chunk, blocks fed every 0.3 s."""
    model = Model(april, precision="int8", device="cpu")
    got = []
    sess = Session(model, lambda r, toks: got.append(int(r)), asynchronous=True)
    orig = sess._engine.prog.step

    def slow_step(*a):
        t0 = time.monotonic()
        out = orig(*a)
        dt = time.monotonic() - t0
        if dt < 0.28:
            time.sleep(0.28 - dt)
        return out

    sess._engine.prog = dataclasses.replace(sess._engine.prog, step=slow_step)
    assert threading.current_thread() is not sess._worker
    pcm = _pcm()
    for off in range(0, len(pcm), BLOCK):
        sess.feed_pcm16(pcm[off : off + BLOCK].tobytes())
        time.sleep(0.3)
    speedup = sess.get_rt_speedup()
    assert speedup == sess._engine.rt_speedup(sess._slot)
    stretch = sess._stretcher.speed
    sess.flush()
    sess.close()
    assert not sess._worker.is_alive()
    assert speedup > 1.05, speedup
    assert stretch > 1.0, stretch
    assert int(Result.ERROR_CANT_KEEP_UP) not in got
    assert got and got[-1] in (int(Result.FINAL_RECOGNITION), int(Result.SILENCE))
    assert int(Result.FINAL_RECOGNITION) in got
    print(f"ASYNC_RT behind realtime: rt_speedup {speedup:.3f}, stretcher {stretch:.3f}x, "
          f"{len(got)} callbacks")


def test_engine_rt_speedup(april, monkeypatch):
    """`BatchEngine.rt_speedup` (JAX batch.py:500-513): the tick EMA of 1.1
    tick time / chunk time, scaled for a slot by (1 + backlog / buffer)."""
    from april_asr_tpu_torch.engine.batch import BatchEngine

    model = Model(april, precision="int8", device="cpu")
    eng = BatchEngine(model.runtime, batch=2, prog=model._get_program(batch=2))
    a, b = eng.alloc(lambda r, t: None), eng.alloc(lambda r, t: None)
    assert eng.rt_speedup() == eng.rt_speedup(a) == 1.0
    clock = iter(np.arange(0.0, 10.0, 0.1))  # every perf_counter read 0.1 s on
    monkeypatch.setattr(TB.time, "perf_counter", lambda: float(next(clock)))
    pcm = _pcm(1)
    eng.feed(a, pcm)
    assert eng.tick()
    want = (9.0 + 1.1 * 0.1 / 0.2) / 10.0  # one tick of 0.1 s for 0.2 s of audio
    assert eng.rt_speedup() == pytest.approx(want)
    staged = len(pcm) - BLOCK
    assert eng.rt_speedup(a) == pytest.approx(want * (1 + staged / eng.max_staged))
    assert eng.rt_speedup(b) == pytest.approx(want)


def test_sync_session_speedup_is_one(april):
    model = Model(april, precision="int8", device="cpu")
    sess = Session(model, lambda r, toks: None)
    sess.feed_pcm16(_pcm(1).tobytes())
    assert sess.get_rt_speedup() == 1.0
    sess.close()


@pytest.mark.parametrize("fault", ["callback", "tick"])
def test_failed_worker_reports_and_raises(april, fault):
    """The worker's first result raises in the handler, or its first tick
    raises: the handler gets SESSION_ERROR, the worker ends, and flush (then
    feed_pcm16) raises with the worker's error as the cause, at once
    rather than after the 60 s wait."""
    model = Model(april, precision="int8", device="cpu")
    got = []

    def cb(r, toks):
        got.append(int(r))
        if fault == "callback" and len(got) == 1:
            raise ValueError("handler failed")

    sess = Session(model, cb, asynchronous=True, no_rt=True)
    if fault == "tick":
        def tick():
            raise ValueError("tick failed")

        sess._engine.tick = tick
    pcm = _pcm()
    for off in range(0, len(pcm), BLOCK):
        try:
            sess.feed_pcm16(pcm[off : off + BLOCK].tobytes())
        except RuntimeError:  # the worker has already failed
            break
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker failed") as err:
        sess.flush()
    assert time.monotonic() - t0 < 30.0
    assert isinstance(err.value.__cause__, ValueError)
    assert got[-1] == int(Result.SESSION_ERROR)
    assert not sess._worker.is_alive()
    with pytest.raises(RuntimeError, match="worker failed"):
        sess.feed_pcm16(pcm[:BLOCK].tobytes())
    sess.close()


def test_beam_still_raises(april):
    model = Model(april, precision="int8", device="cpu")
    with pytest.raises(NotImplementedError):
        Session(model, lambda r, toks: None, beam=2)
