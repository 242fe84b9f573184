"""Port parity: the ONNX interpreter's engine against the JAX package's.

A traced icefall-style model (`april_asr_tpu.testing.write_test_april`, the
graph form real `.april` files hold) loaded with prefer_native=False on both
sides: the JAX engine runs its vmapped onnx2jax functions under `lax.scan`,
the port's engine P rounds of `pull_once` over the vmapped onnx2torch
functions, decoding from the joiner's logits (`inner_decode`'s third
branch). S = 4 sessions at 200 ms and 1 s chunks, several ticks of
mixed-length feeds, then a flush. APRIL_PALLAS=1 puts the JAX frontend on
its kernels' route, which at S = 4 (not a multiple of 8) is the f32 DFT on
both sides. After every step the
fbank ring's integer state must be equal and its rows within the
frontend's budget against the float64 oracle (2e-3,
tests/test_torch_port_fbank.py), h/c within the repo's cross-implementation
bound, and each session's events, callbacks and integer decode state equal
up to a decision the port took by a near-tie (testing.NEAR_TIE), as
tests/test_torch_port_engine.py holds the native engines.

Why the ring is not held to kernel 5's 2e-5 / 1e-4 here: the port's
frontend now follows JAX's route (S % 8 != 0 takes the f32 DFT on both
sides, S = 8 kernel 5 on both), and `test_fbank_tone_rows` holds the two
frontends to that bound on this audio at S = 4 and 8. The engine test
keeps the frontend's oracle budget, as its h/c checks keep theirs. An
earlier account put the port's larger distance from the oracle on tone
bursts (5.0e-4 against JAX's 1.6e-4) on a sum order; it was the route: at
S = 4 JAX's gate (`fused_supported`, S % 8 == 0) sent JAX to the f32 DFT
while the port ran kernel 5's bf16x3 split, whose tables carry ~5e-4 on
these bins even summed in f64.
"""

import numpy as np
import pytest
import torch

from april_asr_tpu.api import Model as JModel
from april_asr_tpu.config import EngineConfig as JEngineConfig
from april_asr_tpu.engine.batch import BatchEngine as JBatchEngine
from april_asr_tpu.config import FbankOptions as JFbankOptions
from april_asr_tpu.engine.step import unpack_events_np as j_unpack
from april_asr_tpu.frontend import fbank as jfb
from april_asr_tpu.testing import FixtureConfig, write_test_april
from april_asr_tpu_torch.api import Model, Result
from april_asr_tpu_torch.config import EngineConfig, FbankOptions
from april_asr_tpu_torch.engine.batch import BatchEngine
from april_asr_tpu_torch.engine.step import unpack_events_np as t_unpack
from april_asr_tpu_torch.frontend import fbank as tfb
from april_asr_tpu_torch.frontend.oracle import OracleFbank
from april_asr_tpu_torch.testing import INT_DECODE, DecisionMargins, capture_events, check_parting

S = 4
FRONTEND_BUDGET = 2e-3  # against the float64 oracle (tests/test_torch_port_fbank.py)
CFG = FixtureConfig()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced_april(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("onnx_engine") / "traced.april")
    write_test_april(path, CFG)
    return path


def _assert_stat_close(a, b, mean_tol=5e-3, p99_tol=0.05, name=""):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float(d.mean()) < mean_tol, f"{name}: mean {d.mean():.5f}"
    assert float(np.percentile(d, 99)) < p99_tol, f"{name}: p99 {np.percentile(d, 99):.5f}"


def _audio(n_samples, seed, streams=S):
    """Tone bursts plus noise, one stream per slot."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    out = []
    for i in range(streams):
        gate = (np.sin(2 * np.pi * 1.3 * t + i) > -0.2).astype(np.float32)
        base = 0.35 * np.sin(2 * np.pi * (180 + 60 * i) * t) * gate
        out.append(((base + rng.normal(0, 0.05, n_samples)) * 20000).astype(np.int16))
    return out


@pytest.mark.parametrize("chunk,ticks", [(3200, 5), (16000, 2)])
def test_interp_stream_matches_jax(traced_april, monkeypatch, chunk, ticks):
    monkeypatch.setenv("APRIL_PALLAS", "1")
    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    jm = JModel(traced_april, prefer_native=False)
    tm = Model(traced_april, prefer_native=False, device="cpu")
    assert tm.runtime.kind == jm.runtime.kind == "interp"
    je = JBatchEngine(jm.runtime, batch=S, cfg=JEngineConfig(chunk_samples=chunk))
    te = BatchEngine(tm.runtime, batch=S, cfg=EngineConfig(chunk_samples=chunk))
    assert te.prog.layout.max_pulls_per_step == je.prog.layout.max_pulls_per_step
    jev, tev = [], []
    capture_events(je.prog, j_unpack, jev)
    capture_events(te.prog, t_unpack, tev)
    jrec, trec = [[] for _ in range(S)], [[] for _ in range(S)]
    for eng, recs in ((je, jrec), (te, trec)):
        for i in range(S):
            eng.alloc(lambda r, toks, i=i, recs=recs: recs[i].append(
                (int(r), tuple((int(t.token_id), int(t.time_ms)) for t in toks))))
    waves = _audio(ticks * chunk, seed=chunk)
    parted = {}
    off = 0
    with DecisionMargins() as margins:
        for k in range(ticks + 1):
            margins.reset()
            if k < ticks:
                for i in range(S):
                    # every third feed is short and not hop-aligned
                    n = chunk - 333 if (i + k) % 3 == 0 else chunk
                    je.feed(i, waves[i][off : off + n])
                    te.feed(i, waves[i][off : off + n])
                off += chunk
                je.tick()
                te.tick()
            else:
                je.flush(np.ones(S, bool))
                te.flush(np.ones(S, bool))
            jf, tf = je.state["fbank"], te.state["fbank"]
            for key in ("fifo_len", "fifo_off", "fifo_len_f", "leftover_len"):
                np.testing.assert_array_equal(tf[key].numpy(), np.asarray(jf[key]), err_msg=key)
            np.testing.assert_allclose(tf["fifo"].numpy(), np.asarray(jf["fifo"]), atol=FRONTEND_BUDGET)
            _assert_stat_close(te.state["h"].numpy(), np.asarray(je.state["h"]), name=f"h step {k}")
            _assert_stat_close(te.state["c"].numpy(), np.asarray(je.state["c"]), name=f"c step {k}")
            n_cells = jev[-1]["ops"].shape[1] * jev[-1]["ops"].shape[2]
            check_parting(
                k, jev[-1], tev[-1], margins.per_cell(n_cells), jrec, trec,
                {key: np.asarray(je.state["decode"][key]) for key in INT_DECODE},
                {key: te.state["decode"][key].numpy() for key in INT_DECODE}, parted,
            )
    assert sum(len(r) for r in jrec) > S * ticks  # the decode emitted, not just silence
    assert any(r[0] == int(Result.FINAL_RECOGNITION) for rec in jrec for r in rec)
    print(f"interp chunk {chunk}: sessions parted at near-ties (step, cell, margin): {parted}")


def test_fbank_tone_rows(monkeypatch):
    """Both frontends' rows on the tone bursts above (1 s of 200 ms feeds,
    pulls as the engine takes them) at S = 4, where JAX's gate sends both to
    the f32 DFT (`_frame_dsp`): within the fbank kernels' bound of each
    other (atol 2e-5, rtol 1e-4) and within the frontend's budget of the
    float64 oracle."""
    _tone_rows(monkeypatch, S)


def test_fbank_tone_rows_kernel5(monkeypatch):
    """The same at S = 8 with APRIL_PALLAS=1, where both run kernel 5 (the
    port's plain version, JAX's in interpret mode)."""
    _tone_rows(monkeypatch, 8)


def _tone_rows(monkeypatch, n_streams):
    """Prints each side's largest distance from the oracle and from the
    other, and asserts the bounds above."""
    monkeypatch.setenv("APRIL_PALLAS", "1")
    import jax
    import jax.numpy as jnp

    chunk, n_chunks = 3200, 5
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    tl = tfb.FbankLayout.build(FbankOptions(), chunk)
    waves = [w.astype(np.float32) / 32768.0
             for w in _audio(n_chunks * chunk, seed=chunk, streams=n_streams)]
    jaccept = jax.jit(lambda s, w, n: jfb.fbank_accept_batch(jl, s, w, n, dft_i8=False))
    jadvance = jax.jit(jax.vmap(lambda s, d: jfb.fbank_advance_n(jl, s, d)))
    jst = jax.vmap(lambda _: jfb.fbank_init(jl))(jnp.arange(n_streams))
    tst = tfb.fbank_init(tl, n_streams, "cpu")
    rows_t, rows_j = [[] for _ in range(n_streams)], [[] for _ in range(n_streams)]
    n = np.full(n_streams, chunk, np.int32)
    for k in range(n_chunks):
        w = np.stack([x[k * chunk : (k + 1) * chunk] for x in waves])
        before = tst["fifo_len"].clone()
        jst = jaccept(jst, jnp.asarray(w), jnp.asarray(n))
        tst = tfb.fbank_accept_batch(tl, tst, torch.from_numpy(w), torch.from_numpy(n), False)
        jf = np.asarray(jst["fifo"])
        for s in range(n_streams):
            for i in range(int(before[s]), int(tst["fifo_len"][s])):
                r = (int(tst["fifo_off"][s]) + i) % tl.fifo_rows
                rows_t[s].append(tst["fifo"][s, r].numpy())
                rows_j[s].append(jf[s, r])
        pulls = torch.clamp(torch.div(tst["fifo_len"] - 9, 4, rounding_mode="floor") + 1, min=0)
        tst = tfb.fbank_advance_n(tl, tst, pulls)
        jst = jadvance(jst, jnp.asarray(pulls.numpy()))
    worst = {"port-oracle": 0.0, "jax-oracle": 0.0, "port-jax": 0.0}
    over = 0
    for s in range(n_streams):
        ob = OracleFbank(FbankOptions())
        ob.accept_waveform(waves[s])
        ref, t, j = np.stack(ob.fifo), np.stack(rows_t[s]), np.stack(rows_j[s])
        assert t.shape == j.shape == ref.shape
        worst["port-oracle"] = max(worst["port-oracle"], float(np.abs(t - ref).max()))
        worst["jax-oracle"] = max(worst["jax-oracle"], float(np.abs(j - ref).max()))
        worst["port-jax"] = max(worst["port-jax"], float(np.abs(t - j).max()))
        over += int((~np.isclose(t, j, atol=2e-5, rtol=1e-4)).sum())
    print(f"tone-burst fbank rows at S = {n_streams}, largest differences: {worst}; "
          f"{over} of {n_streams * t.size} entries past atol 2e-5 / rtol 1e-4")
    assert worst["port-oracle"] < FRONTEND_BUDGET and worst["jax-oracle"] < FRONTEND_BUDGET
    assert over == 0


@pytest.mark.parametrize("precision", ["int8", None])
def test_onnx_form_engine_equals_native_form(tmp_path, precision):
    """The same weights written in both forms by the port's save_april: the
    ONNX form extracts (kind "native") to the native form's weights bit for
    bit, and its engine's event blobs equal the native form's, tick by tick
    and through the flush."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.models.export import make_model_parameters, save_april
    from april_asr_tpu_torch.testing import default_tokens

    dims = TM.TransducerDims(d_model=64, hidden=96, ffn=128, joiner_dim=64, vocab=40, layers=2,
                             decoder_groups=16, conv_channels=(4, 8, 8))
    p = TM.init_transducer_params(8, dims)
    p["join_b"][0] += 2.0
    mp = make_model_parameters(dims, default_tokens(dims.vocab))
    models = {}
    for form in ("native", "onnx"):
        path = tmp_path / f"{form}.april"
        save_april(path, dims, p, mp, form=form)
        models[form] = Model(path, precision=precision, device="cpu")
    wn, wo = models["native"].runtime.weights, models["onnx"].runtime.weights
    assert models["onnx"].runtime.kind == "native" and wo.keys() == wn.keys()
    for k in wn:
        assert wo[k].dtype == wn[k].dtype and torch.equal(wo[k], wn[k]), k
    chunk, ticks = 16000, 2
    engines = {f: BatchEngine(m.runtime, batch=S, cfg=EngineConfig(chunk_samples=chunk))
               for f, m in models.items()}
    blobs = {f: [] for f in engines}
    for f, eng in engines.items():
        capture_events(eng.prog, lambda packed: packed.blob.clone(), blobs[f])
        for i in range(S):
            eng.alloc(lambda r, toks: None)
    waves = _audio(ticks * chunk, seed=5)
    for k in range(ticks + 1):
        for eng in engines.values():
            if k < ticks:
                for i in range(S):
                    eng.feed(i, waves[i][k * chunk : (k + 1) * chunk])
                eng.tick()
            else:
                eng.flush(np.ones(S, bool))
    assert len(blobs["onnx"]) == len(blobs["native"]) == ticks + 1
    for a, b in zip(blobs["onnx"], blobs["native"]):
        assert torch.equal(a, b)
    assert any(int(x[4 : 4 + S].sum()) for x in blobs["native"])  # events were emitted
