"""Port parity: engine failure containment (april_asr_tpu_torch/engine/
batch.py `_contain`, `_recover`, `scrub`), the five cases of the JAX
package's tests/test_elastic.py on the port's engine, and the property
the retry rests on.

The reference aborts the process on any backend error (ort_util.h:29-38).
Here a failed step or flush is retried for the healthy sessions on the
state it was given, a poisoned slot alone is evicted with SESSION_ERROR,
and only a failure of the retry too resets every session. The retry is
sound only if the step and flush programs leave the state they are handed
unchanged: a test holds every leaf of it bit for bit across a step and a
flush, at int8, bf16 and f32.

Every failure caught and every restart is counted (`CONTAINED`), and
`testing.engine_run`, which measured runs go through, refuses a run that
caught one. A tensor-parallel engine does not contain: two gloo ranks
(`testing.RankGroup`), one of whose step programs fails, show that rank
re-raising while the other goes on, and both scrubbing together after.
"""

import dataclasses

import numpy as np
import pytest
import torch

from april_asr_tpu_torch.api.model import apply_precision
from april_asr_tpu_torch.decode.scalar import RESULT_SESSION_ERROR
from april_asr_tpu_torch.engine import batch as TB
from april_asr_tpu_torch.engine.batch import CONTAINED, BatchEngine, _map
from april_asr_tpu_torch.models.export import make_model_parameters, save_april
from april_asr_tpu_torch.models.loader import native_runtime
from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
from april_asr_tpu_torch.testing import RankGroup, default_tokens, engine_run

DIMS = TransducerDims(
    mel=80, segment_size=9, segment_step=4, d_model=32, hidden=64, ffn=64,
    joiner_dim=32, vocab=64, layers=2, context=2, decoder_groups=8,
    conv_channels=(4, 8, 8),
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runtime(precision=None):
    p = init_transducer_params(0, DIMS)
    mp = make_model_parameters(DIMS, default_tokens(DIMS.vocab))
    return native_runtime("elastic", "", "en", mp, DIMS, apply_precision(p, precision), "cpu")


@pytest.fixture(scope="module")
def rt():
    return _runtime()


def _audio(seed, n=9600):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.15, size=n) * 20000).astype(np.int16)


def _engine(rt, S, streams):
    eng = BatchEngine(rt, batch=S)
    for i in range(S):
        eng.alloc(lambda r, toks, i=i: streams[i].append(
            (r, tuple((t.token_id, t.time_ms) for t in toks))))
    return eng


def _fail_calls(eng, name, fail_at):
    """Make the program's `name` raise on the calls numbered in `fail_at`
    (from 1); returns the call counter."""
    orig = getattr(eng.prog, name)
    calls = {"n": 0}

    def bad(*a):
        calls["n"] += 1
        if calls["n"] in fail_at:
            raise RuntimeError("injected device failure")
        return orig(*a)

    eng.prog = dataclasses.replace(eng.prog, **{name: bad})
    return calls


class _Counted:
    """The CONTAINED counts added inside a `with` block."""

    def __enter__(self):
        self.before = dict(CONTAINED)
        return self

    def __exit__(self, *exc):
        self.added = {k: CONTAINED[k] - self.before[k] for k in CONTAINED}


def _poison(eng, slot):
    st = dict(eng.state)
    h = st["h"].clone()
    h[:, slot, :] = float("nan")
    st["h"] = h
    eng.state = st


def test_step_failure_recovers_and_keeps_serving(rt):
    """The step fails and so does its retry: every live session is told,
    and the engine keeps serving from fresh state."""
    S = 4
    streams = [[] for _ in range(S)]
    eng = _engine(rt, S, streams)
    calls = _fail_calls(eng, "step", (2, 3))
    audio = _audio(1)
    for i in range(S):
        eng.feed(i, audio)
    assert eng.tick()
    with _Counted() as n:
        assert eng.tick() is False
    assert n.added == {"failures": 1, "recoveries": 1}
    for i in range(S):
        assert streams[i][-1] == (RESULT_SESSION_ERROR, ())
        assert eng.pending(i) == 0  # staged audio dropped
    n_before = [len(s) for s in streams]
    for i in range(S):
        eng.feed(i, audio)
    while eng.tick():
        pass
    eng.flush(np.ones(S, bool))
    assert calls["n"] > 3
    assert any(len(s) > n_before[i] for i, s in enumerate(streams)), "no callbacks after recovery"


def _run(rt, audio, S, inject=None, poison=None, split=None):
    streams = [[] for _ in range(S)]
    eng = _engine(rt, S, streams)
    first = [a[:split] for a in audio] if split else audio
    for i in range(S):
        eng.feed(i, first[i])
    if split:
        while eng.tick():
            pass
        if poison is not None:
            _poison(eng, poison)
        for i in range(S):
            eng.feed(i, audio[i][split:])
    if inject:
        _fail_calls(eng, *inject)
    while eng.tick():
        pass
    eng.flush(np.ones(S, bool))
    return streams


@pytest.mark.parametrize("program", ["step", "flush"])
def test_transient_failure_contained_no_eviction(rt, program):
    """A transient failure (the retry succeeds) is invisible: no
    SESSION_ERROR, the streams equal an uninterrupted run's."""
    S = 4
    audio = [_audio(7)] * S
    clean = _run(rt, audio, S)
    with _Counted() as n:
        faulted = _run(rt, audio, S, inject=(program, (2 if program == "step" else 1,)))
    assert n.added == {"failures": 1, "recoveries": 0}
    assert faulted == clean
    assert all(RESULT_SESSION_ERROR not in [c[0] for c in s] for s in faulted)


def test_program_failure_contained_per_slot(rt):
    """One poisoned slot and a failed step: only that slot is evicted; the
    healthy sessions' streams equal an uninterrupted run's."""
    S = 4
    audio = [_audio(10 + i) for i in range(S)]
    with _Counted() as n:
        clean = _run(rt, audio, S, split=3200)
    assert n.added == {"failures": 0, "recoveries": 0}
    with _Counted() as n:
        faulted = _run(rt, audio, S, inject=("step", (1,)), poison=2, split=3200)
    assert n.added == {"failures": 1, "recoveries": 0}
    assert [c[0] for c in faulted[2]].count(RESULT_SESSION_ERROR) == 1
    for i in (0, 1, 3):
        assert faulted[i] == clean[i], f"slot {i} stream diverged"
        assert RESULT_SESSION_ERROR not in [c[0] for c in faulted[i]]


def test_scrub_evicts_only_poisoned_slots(rt):
    S = 4
    streams = [[] for _ in range(S)]
    eng = _engine(rt, S, streams)
    audio = _audio(2)
    for i in range(S):
        eng.feed(i, audio[:3200])
    while eng.tick():
        pass
    _poison(eng, 1)
    assert eng.scrub() == 1
    assert streams[1][-1] == (RESULT_SESSION_ERROR, ())
    assert all(RESULT_SESSION_ERROR not in [c[0] for c in streams[i]] for i in (0, 2, 3))
    assert torch.isfinite(eng.state["h"]).all()  # reset to the template
    for i in range(S):
        eng.feed(i, audio[3200:6400])
    while eng.tick():
        pass
    eng.flush(np.ones(S, bool))
    assert len(streams[1]) > 1
    assert streams[0] == streams[2] == streams[3]


def test_scrub_clean_state_is_noop(rt):
    eng = BatchEngine(rt, batch=2)
    calls = []
    eng.alloc(lambda r, toks: calls.append(r))
    eng.feed(0, _audio(3, 3200))
    while eng.tick():
        pass
    assert eng.scrub() == 0
    assert RESULT_SESSION_ERROR not in calls


@pytest.mark.parametrize("program", ["step", "flush"])
def test_engine_run_refuses_a_contained_failure(rt, monkeypatch, program):
    """A measured run (testing.engine_run) whose step or flush failed once
    and was contained raises, although every session's stream is whole."""
    orig = TB.build_engine

    def build_failing(*a, **kw):
        prog = orig(*a, **kw)
        failed = []

        def once(*args, fn=getattr(prog, program)):
            if not failed:
                failed.append(True)
                raise RuntimeError("injected device failure")
            return fn(*args)

        return dataclasses.replace(prog, **{program: once})

    audio = np.stack([np.stack([_audio(40 + k, 3200)] * 2) for k in range(2)])
    args = dict(rt=rt, m=1, device="cpu", audio=audio, ticks=2)
    assert len(engine_run(args)["events"]) == 3
    monkeypatch.setattr(TB, "build_engine", build_failing)
    with pytest.raises(RuntimeError, match="caught program failures"):
        engine_run(args)


@pytest.fixture(scope="module")
def april(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("elastic") / "elastic.april")
    save_april(path, DIMS, init_transducer_params(0, DIMS),
               make_model_parameters(DIMS, default_tokens(DIMS.vocab)), name="elastic")
    return path


def test_tp_failure_on_one_rank_raises_there(april):
    """m = 2 over gloo: rank 0's last step fails after its collectives met.
    Rank 0 re-raises (no sweep: that would be a collective rank 1 is not
    in) and counts the failure; rank 1's tick runs; no session gets
    SESSION_ERROR; then both ranks scrub together and evict nothing."""
    rng = np.random.default_rng(12)
    audio = (rng.normal(0, 0.2, size=(2, 2, 3200)) * 20000).astype(np.int16)
    ranks = RankGroup("april_asr_tpu_torch.testing:contain_run",
                      dict(path=april, precision=None, m=2, audio=audio, fail_rank=0),
                      world=2, timeout=240).join()
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["last"] == "injected failure on one rank"
    assert ranks[1]["last"] == "ticked"
    assert ranks[0]["counted"] == {"failures": 1, "recoveries": 0}
    assert ranks[1]["counted"] == {"failures": 0, "recoveries": 0}
    assert [r["errors"] for r in ranks] == [0, 0]
    assert [r["scrubbed"] for r in ranks] == [0, 0]


@pytest.mark.parametrize("precision", ["int8", "bf16", None])
def test_programs_leave_their_input_state_unchanged(precision):
    """Every leaf of the state handed to prog.step and prog.flush is bit for
    bit what it was before the call (the containment retry reruns on it)."""
    rt = _runtime(precision)
    S = 3
    eng = BatchEngine(rt, batch=S)
    for _ in range(S):
        eng.alloc(lambda r, toks: None)
    for i in range(S):
        eng.feed(i, _audio(20 + i, 4800))
    eng.tick()  # a state with history
    audio = torch.from_numpy(np.stack([_audio(30 + i, 3200) for i in range(S)]))
    n = torch.tensor([3200, 1700, 0], dtype=torch.int32)
    calls = (("step", lambda st: eng.prog.step(eng.weights, st, audio, n)),
             ("flush", lambda st: eng.prog.flush(eng.weights, st, torch.ones(S, dtype=torch.bool))))
    for name, call in calls:
        before = _map(eng.state, lambda t: t.clone())
        new_state, _ = call(eng.state)
        _map_equal(eng.state, before, name)
        assert new_state is not eng.state


def _map_equal(got, want, what, path=""):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _map_equal(got[k], want[k], what, f"{path}/{k}")
        return
    assert torch.equal(got, want), f"{what} changed its input state at {path}"
