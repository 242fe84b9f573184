"""Port parity: per-speaker state snapshots (april_asr_tpu_torch/engine/
speaker.py, JAX engine/speaker.py).

* A speaker Session's close writes its rows; a new Session with the same
  speaker key starts from them, bit for bit.
* Across the packages, on the same `.april` (so the same model name) and
  the same `APRIL_SPEAKER_CACHE`: a snapshot the port saves restores into
  the JAX package's engine, and one the JAX package saves into the port's,
  the restored rows equal to the saved ones bit for bit.
* A tensor-parallel engine (m = 2 ranks over gloo, `testing.RankGroup`)
  gathers c over the ranks when it saves: its snapshot equals the
  single-rank engine's on the same stream within the bound
  tests/test_torch_port_tp.py holds the f32 TP stack to (atol = rtol =
  2e-5), and a restore puts each rank's slice of c, and the replicated
  rows, in place bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from april_asr_tpu.api import Model as JModel
from april_asr_tpu.api import Session as JSession
from april_asr_tpu.engine import speaker as JS
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.api import Model, Session
from april_asr_tpu_torch.engine import speaker as TS
from april_asr_tpu_torch.testing import RankGroup, speaker_run

DIMS_KW = dict(d_model=64, hidden=96, ffn=128, joiner_dim=64, vocab=48, layers=2,
               decoder_groups=16, conv_channels=(4, 8, 8))
KEYS = ("h", "c", "context", "dout")
F32_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_torch_port_tp.py
M, S, TICKS, CHUNK = 2, 4, 2, 3200


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def april(tmp_path_factory):
    dims = JM.TransducerDims(**DIMS_KW)
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(8), dims).items()}
    p["join_b"] = p["join_b"].copy()
    p["join_b"][0] += 1.0
    path = str(tmp_path_factory.mktemp("speaker") / "speaker.april")
    j_save_april(path, dims, p, j_mmp(dims, default_tokens(dims.vocab)), name="spk",
                 form="native")
    return path


def _pcm(seconds=1, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000.0
    x = 0.35 * np.sin(2 * np.pi * 200 * t) + rng.normal(0, 0.05, t.size)
    return (x * 20000).astype(np.int16)


def _rows(engine, slot):
    st = engine.state
    return {"h": np.asarray(st["h"])[:, slot], "c": np.asarray(st["c"])[:, slot],
            "context": np.asarray(st["decode"]["context"])[slot],
            "dout": np.asarray(st["decode"]["dout"])[slot]}


def _file(model_name, key, module):
    with np.load(module.speaker_path(model_name, key)) as f:
        assert sorted(f.files) == sorted(KEYS)
        return {k: np.asarray(f[k]) for k in KEYS}


def _speak(session_cls, model, key, pcm):
    sess = session_cls(model, lambda r, toks: None, speaker_name=key)
    for off in range(0, len(pcm), CHUNK):
        sess.feed_pcm16(pcm[off : off + CHUNK].tobytes())
    sess.close()


def _assert_rows_equal(got, want):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_round_trip(april, tmp_path, monkeypatch):
    monkeypatch.setenv("APRIL_SPEAKER_CACHE", str(tmp_path))
    model = Model(april, precision="int8", device="cpu")
    assert TS.speaker_dir() == str(tmp_path)
    _speak(Session, model, "alice", _pcm())
    saved = _file(model.get_name(), "alice", TS)
    assert saved["h"].dtype == saved["c"].dtype == saved["dout"].dtype == np.float32
    assert np.abs(saved["c"]).max() > 0  # the stream moved the state
    sess = Session(model, lambda r, toks: None, speaker_name="alice")
    _assert_rows_equal({k: v.numpy() for k, v in _rows_t(sess._engine, sess._slot).items()}, saved)
    sess.feed_pcm16(_pcm(seed=4).tobytes())  # and it serves on from there
    sess.close()
    fresh = Session(model, lambda r, toks: None, speaker_name="bob")  # no snapshot: fresh
    assert not torch.any(fresh._engine.state["c"])
    fresh.close()


def _rows_t(engine, slot):
    st = engine.state
    return {"h": st["h"][:, slot], "c": st["c"][:, slot],
            "context": st["decode"]["context"][slot], "dout": st["decode"]["dout"][slot]}


def test_port_save_restores_in_jax(april, tmp_path, monkeypatch):
    monkeypatch.setenv("APRIL_SPEAKER_CACHE", str(tmp_path))
    model = Model(april, device="cpu")
    _speak(Session, model, "carol", _pcm(seed=5))
    saved = _file(model.get_name(), "carol", TS)
    jm = JModel(april)
    assert jm.get_name() == model.get_name()
    js = JSession(jm, lambda r, toks: None, speaker_name="carol")
    _assert_rows_equal(_rows(js._engine, js._slot), saved)
    js.close()


def test_jax_save_restores_in_port(april, tmp_path, monkeypatch):
    monkeypatch.setenv("APRIL_SPEAKER_CACHE", str(tmp_path))
    jm = JModel(april)
    _speak(JSession, jm, "dave", _pcm(seed=6))
    saved = _file(jm.get_name(), "dave", JS)
    model = Model(april, device="cpu")
    sess = Session(model, lambda r, toks: None, speaker_name="dave")
    _assert_rows_equal({k: v.numpy() for k, v in _rows_t(sess._engine, sess._slot).items()}, saved)
    sess.close()


def test_tp_snapshot_matches_single_rank(april, tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    audio = (rng.normal(0, 0.2, size=(TICKS, S, CHUNK)) * 20000).astype(np.int16)
    args = dict(path=april, precision=None, audio=audio, model="spk")
    monkeypatch.setenv("APRIL_SPEAKER_CACHE", str(tmp_path / "tp"))
    group = RankGroup("april_asr_tpu_torch.testing:speaker_run", dict(args, m=M), world=M,
                      timeout=240)
    monkeypatch.setenv("APRIL_SPEAKER_CACHE", str(tmp_path / "single"))
    single = speaker_run(dict(args, m=1))
    ranks = group.join()
    assert single["saved"] == [True] * S and single["applied"]
    _assert_rows_equal(single["restored"], single["snapshot"])
    H = DIMS_KW["hidden"]
    n = H // M
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["saved"] == [True] * S and out["applied"]
        snap = out["snapshot"]
        assert snap["c"].shape == single["snapshot"]["c"].shape == (DIMS_KW["layers"], H)
        np.testing.assert_array_equal(snap["context"], single["snapshot"]["context"])
        for k in ("h", "c", "dout"):
            np.testing.assert_allclose(snap[k], single["snapshot"][k], **F32_TOL, err_msg=k)
        got = out["restored"]
        np.testing.assert_array_equal(got["c"], snap["c"][:, r * n : (r + 1) * n])
        for k in ("h", "context", "dout"):
            np.testing.assert_array_equal(got[k], snap[k])
    for k in KEYS:
        np.testing.assert_array_equal(ranks[0]["snapshot"][k], ranks[1]["snapshot"][k])
