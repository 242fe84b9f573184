"""Port parity: the slice as a whole (engine step, flush, replay, Session).

* Random-weight stream: one tiny random native `.april` served at int8
  (blank logit biased +2.0, as bench.py does) through the JAX package's
  BatchEngine and the port's, 8 slots, at 1 s and 200 ms chunks, several
  ticks of mixed-length feeds and a flush. APRIL_PALLAS=1 puts the JAX
  frontend on its int8-DFT kernel (interpret mode), the path the port
  always takes; at 8 slots the JAX encoder and decode run their XLA forms,
  which share the kernels' numerics. After every step the fbank ring is
  held to kernel 1's bound (atol 2e-5, rtol 1e-4: both sides accumulate
  the int8 planes exactly and differ only in f32 summation order), h/c to
  the repo's cross-implementation bound `_assert_stat_close`
  (tests/test_lstm_int8.py:69-80: one ulp of tanh can flip an int8
  rounding), and the replayed callbacks and integer decode state must be
  equal up to a decision the port took by a near-tie margin.
* The same stream served as loaded (no precision on either side: f32) and
  at bf16. The JAX frontend runs kernel 5 (interpret mode), the port's
  bf16x3 path; at 8 slots the JAX encoder takes its XLA chunk path (kernel
  10 runs only at 12 <= P <= 56 with S a multiple of 128) and its decode
  the per-pull scan (the chunk decode kernel needs S a multiple of 128):
  the same functions, with f32 sums in another order. The fbank ring is
  held to kernel 5's bound, the rest as at int8.
* Trained model: the tiny tone-coded model trained with the JAX trainer, as
  tests/test_trained_e2e.py does, served by the port's Model at int8, bf16
  and f32 and a synchronous Session, must give exactly the training
  transcripts at every precision; so must its ONNX form, written by the
  port, both extracted (kind "native") and through the interpreter.
"""

import numpy as np
import pytest
import torch

from april_asr_tpu.api import Model as JModel
from april_asr_tpu.config import EngineConfig as JEngineConfig
from april_asr_tpu.engine.batch import BatchEngine as JBatchEngine
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.api import Model, Result, Session
from april_asr_tpu_torch.config import EngineConfig
from april_asr_tpu_torch.engine.batch import BatchEngine

DIMS_KW = dict(d_model=128, hidden=128, ffn=256, joiner_dim=128, vocab=64, layers=2,
               decoder_groups=32, conv_channels=(4, 8, 8))
S = 8


def _assert_stat_close(a, b, mean_tol=5e-3, p99_tol=0.05, name=""):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float(d.mean()) < mean_tol, f"{name}: mean {d.mean():.5f}"
    assert float(np.percentile(d, 99)) < p99_tol, f"{name}: p99 {np.percentile(d, 99):.5f}"


@pytest.fixture(scope="module")
def random_april(tmp_path_factory):
    import jax

    dims = JM.TransducerDims(**DIMS_KW)
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(11), dims).items()}
    p["join_b"] = p["join_b"].copy()
    p["join_b"][0] += 2.0
    path = str(tmp_path_factory.mktemp("engine") / "random.april")
    j_save_april(path, dims, p, j_mmp(dims, default_tokens(dims.vocab)), name="rand", form="native")
    return path


def _audio(n_samples, seed):
    """bench.py-style tone bursts plus noise, one stream per slot."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    out = []
    for i in range(S):
        gate = (np.sin(2 * np.pi * 1.3 * t + i) > -0.2).astype(np.float32)
        base = 0.35 * np.sin(2 * np.pi * (180 + 60 * i) * t) * gate
        out.append(((base + rng.normal(0, 0.05, n_samples)) * 20000).astype(np.int16))
    return out


def _slots(engine, recs):
    for i in range(S):
        engine.alloc(lambda r, toks, i=i: recs[i].append(
            (int(r), tuple((int(t.token_id), int(t.time_ms)) for t in toks))))


@pytest.mark.parametrize("chunk,ticks", [(16000, 3), (3200, 6)])
def test_random_weight_stream_matches_jax(random_april, monkeypatch, chunk, ticks):
    _stream_parity(random_april, monkeypatch, chunk, ticks, "int8")


@pytest.mark.parametrize("precision,chunk,ticks", [(None, 16000, 3), ("bf16", 3200, 6)])
def test_float_stream_matches_jax(random_april, monkeypatch, precision, chunk, ticks):
    _stream_parity(random_april, monkeypatch, chunk, ticks, precision)


def _stream_parity(random_april, monkeypatch, chunk, ticks, precision):
    """Event by event, every session's decode equals the JAX package's up to
    the first event cell where the two part, and the port took that cell's
    decision by less than NEAR_TIE (a near-tie, where an ulp upstream may
    tip it; april_asr_tpu_torch/testing.py states the bound). Random
    weights are chaotic, so bit-identical streams across two programs are
    not a sound expectation (tests/test_tp_shard_map.py:250-263 says the
    same of the JAX package's own int8 paths); a session that parts from
    JAX at a decision taken by a larger margin fails the test, and so does
    any callback or integer decode state that differs while the events
    agree. Returns the sessions that parted, {session: (step, cell,
    margin)}."""
    from april_asr_tpu.engine.step import unpack_events_np as j_unpack
    from april_asr_tpu_torch.engine.step import unpack_events_np as t_unpack
    from april_asr_tpu_torch.testing import (
        INT_DECODE, DecisionMargins, capture_events, check_parting)

    monkeypatch.setenv("APRIL_PALLAS", "1")
    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    jm = JModel(random_april, precision=precision)
    tm = Model(random_april, precision=precision, device="cpu")
    je = JBatchEngine(jm.runtime, batch=S, cfg=JEngineConfig(chunk_samples=chunk))
    te = BatchEngine(tm.runtime, batch=S, cfg=EngineConfig(chunk_samples=chunk))
    assert te.prog.layout.max_pulls_per_step == je.prog.layout.max_pulls_per_step
    jev, tev = [], []
    capture_events(je.prog, j_unpack, jev)
    capture_events(te.prog, t_unpack, tev)
    jrec, trec = [[] for _ in range(S)], [[] for _ in range(S)]
    _slots(je, jrec)
    _slots(te, trec)
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
                    pcm = waves[i][off : off + n]
                    je.feed(i, pcm)
                    te.feed(i, pcm)
                off += chunk
                je.tick()
                te.tick()
            else:
                je.flush(np.ones(S, bool))
                te.flush(np.ones(S, bool))
            jf, tf = je.state["fbank"], te.state["fbank"]
            for key in ("fifo_len", "fifo_off", "fifo_len_f", "leftover_len"):
                np.testing.assert_array_equal(tf[key].numpy(), np.asarray(jf[key]), err_msg=key)
            np.testing.assert_allclose(tf["fifo"].numpy(), np.asarray(jf["fifo"]), atol=2e-5, rtol=1e-4)
            _assert_stat_close(te.state["h"].numpy(), np.asarray(je.state["h"]), name=f"h step {k}")
            _assert_stat_close(te.state["c"].numpy(), np.asarray(je.state["c"]), name=f"c step {k}")
            n_cells = jev[-1]["ops"].shape[1] * jev[-1]["ops"].shape[2]
            check_parting(
                k, jev[-1], tev[-1], margins.per_cell(n_cells), jrec, trec,
                {key: np.asarray(je.state["decode"][key]) for key in INT_DECODE},
                {key: te.state["decode"][key].numpy() for key in INT_DECODE}, parted,
            )
    n_cb = sum(len(r) for r in jrec)
    assert n_cb > S * ticks  # the decode emitted, not just silence
    assert any(r[0] == int(Result.FINAL_RECOGNITION) for rec in jrec for r in rec)
    print(f"{precision} chunk {chunk}: sessions parted at near-ties (step, cell, margin): {parted}")
    return parted


def test_encoder_chunk_matches_jax(random_april, monkeypatch):
    """eouts of the whole int8 chunk encoder (12 kernel calls' worth of
    layers plus the bf16 enc_proj) on the same embedded pulls."""
    import jax.numpy as jnp

    monkeypatch.setenv("APRIL_PALLAS", "1")
    jrt = JModel(random_april, precision="int8").runtime
    trt = Model(random_april, precision="int8", device="cpu").runtime
    rng = np.random.default_rng(2)
    P, d, H, L = 7, DIMS_KW["d_model"], DIMS_KW["hidden"], DIMS_KW["layers"]
    y = rng.normal(size=(P, S, d)).astype(np.float32)
    h = (rng.normal(size=(L, S, d)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(L, S, H)) * 0.3).astype(np.float32)
    can = np.arange(P)[:, None] < rng.integers(0, P + 1, size=S)[None, :]
    je, jh, jc = jrt.encoder_chunk(jrt.weights, jnp.asarray(y), jnp.asarray(h), jnp.asarray(c),
                                   jnp.asarray(can))
    te, th, tc = trt.encoder_chunk(trt.weights, torch.from_numpy(y), torch.from_numpy(h),
                                   torch.from_numpy(c), torch.from_numpy(can))
    live = can[:, :, None]
    _assert_stat_close(np.where(live, te.numpy(), 0), np.where(live, np.asarray(je), 0), name="eout")
    _assert_stat_close(th.numpy(), jh, name="h")
    _assert_stat_close(tc.numpy(), jc, name="c")


# -- trained tone-coded model --------------------------------------------------

WORDS = {"ba": 280.0, "de": 640.0, "ko": 1100.0, "mu": 1700.0, "ri": 2400.0}
RATE = 16000


def _write_corpus(tmp_path, n=12, word_seconds=0.55):
    """n utterances of 2-3 tone-coded words with silence padding (the corpus
    of tests/test_trained_e2e.py)."""
    from april_asr_tpu.io.wav import write_wav

    rng = np.random.default_rng(7)
    keys = sorted(WORDS)
    lines = []
    for i in range(n):
        n_words = 2 + (i % 2)
        picks = [keys[(i * 3 + j * 2) % len(keys)] for j in range(n_words)]
        segs = [np.zeros(int(0.15 * RATE))]
        for w in picks:
            t = np.arange(int(word_seconds * RATE)) / RATE
            tone = 0.4 * np.sin(2 * np.pi * WORDS[w] * t)
            ramp = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.05)
            segs.append(tone * ramp)
            segs.append(np.zeros(int(0.1 * RATE)))
        x = np.concatenate(segs)
        x = x + rng.normal(0, 0.004, x.shape)
        wav = tmp_path / f"utt{i}.wav"
        write_wav(str(wav), (np.clip(x, -1, 1) * 24000).astype(np.int16), RATE)
        lines.append(f"{wav}\t{' '.join(picks)}")
    manifest = tmp_path / "train.tsv"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest, [ln.split("\t") for ln in lines]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from april_asr_tpu.cli.train import main as train_main

    tmp_path = tmp_path_factory.mktemp("port_trained")
    manifest, pairs = _write_corpus(tmp_path)
    native_april = tmp_path / "trained_native.april"
    rc = train_main([
        "--manifest", str(manifest), "--out-dir", str(tmp_path / "exp"),
        "--preset", "tiny", "--steps", "220", "--batch", "6",
        "--lr", "3e-3", "--warmup-steps", "20", "--ckpt-every", "0",
        "--export", str(native_april), "--export-form", "native",
    ])
    assert rc == 0
    return str(native_april), pairs


@pytest.fixture(scope="module")
def trained_onnx(trained, tmp_path_factory):
    """The trained model's ONNX form (the reference's format), written by
    the port's save_april from the native file's weights: no second
    training."""
    from april_asr_tpu_torch.io.container import read_container
    from april_asr_tpu_torch.io.safetensors import load_safetensors_bytes
    from april_asr_tpu_torch.models.export import save_april
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

    c = read_container(trained[0])
    tensors, meta = load_safetensors_bytes(c.networks[0])
    dims = TransducerDims(**{k: (tuple(v) if k == "conv_channels" else v)
                             for k, v in meta["dims"].items()})
    path = tmp_path_factory.mktemp("port_trained_onnx") / "trained_onnx.april"
    save_april(path, dims, tensors, c.params, name=c.name, form="onnx")
    return str(path)


def _decode_all(model, pairs):
    """Each utterance through a synchronous Session in 200 ms feeds and a
    flush: its FINAL texts joined, else its last PARTIAL."""
    from april_asr_tpu.io.wav import read_wav

    hyps = []
    for wav, _ in pairs:
        samples, _ = read_wav(wav)
        finals, partial = [], [""]

        def handler(result, tokens):
            text = "".join(t.token for t in tokens)
            if result == Result.FINAL_RECOGNITION:
                finals.append(text)
            elif result == Result.PARTIAL_RECOGNITION:
                partial[0] = text

        sess = Session(model, handler)
        for off in range(0, len(samples), 3200):
            sess.feed_pcm16(samples[off : off + 3200].tobytes())
        sess.flush()
        sess.close()
        hyps.append((" ".join(finals) if finals else partial[0]).strip())
    return hyps


@pytest.mark.parametrize("precision", ["int8", "bf16", "f32"])
def test_trained_int8_session_exact_transcripts(trained, precision):
    path, pairs = trained
    model = Model(path, precision=precision, device="cpu")
    hyps = _decode_all(model, pairs)
    refs = [ref for _, ref in pairs]
    assert hyps == refs, f"\nhyp: {hyps}\nref: {refs}"


@pytest.mark.parametrize("prefer_native,kind", [(True, "native"), (False, "interp")])
def test_trained_onnx_form_exact_transcripts(trained, trained_onnx, monkeypatch, prefer_native,
                                             kind):
    """The ONNX form, extracted and verified (kind "native") and through the
    interpreter (prefer_native=False), decodes the training transcripts
    exactly, as tests/test_trained_e2e.py:133-154 holds the JAX package."""
    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    model = Model(trained_onnx, prefer_native=prefer_native, device="cpu")
    assert model.runtime.kind == kind
    hyps = _decode_all(model, trained[1])
    refs = [ref for _, ref in trained[1]]
    assert hyps == refs, f"\nhyp: {hyps}\nref: {refs}"


def test_cant_keep_up_drops_audio(random_april):
    """Staging beyond max_buffered_seconds drops the block and fires
    ERROR_CANT_KEEP_UP (audio_provider.c:59-64), as the JAX BatchEngine."""
    tm = Model(random_april, precision="int8", device="cpu")
    eng = BatchEngine(tm.runtime, batch=2, cfg=EngineConfig(max_buffered_seconds=0.5))
    got = []
    slot = eng.alloc(lambda r, toks: got.append(r))
    eng.feed(slot, np.zeros(6000, np.int16))
    eng.feed(slot, np.zeros(3000, np.int16))  # 9000 > 8000 staged samples
    assert got == [int(Result.ERROR_CANT_KEEP_UP)]
    assert eng.pending(slot) == 6000
    eng.free(slot)
    assert eng.pending(slot) == 0
