"""Port parity: the step's front. Kernels 16 and 17 (the conv embed of every
pull window from the front buffer), kernel 6 (the fbank DSP on pre-formed
frames), the step's route to kernel 16, and the narrow large-vocabulary
route off kernel 4.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do.

* Conv embed: the port's plain version (the stacked windows through its
  `conv_subsample` on bf16 conv weights) against JAX `conv_embed_windows`
  and `conv_embed_from_front` at (S, P) = (4, 5), (8, 1) and (8, 27). At
  bf16 weights both round at the same points and differ in f32 sum order,
  which can flip the bf16 rounding of an activation: at most 1% of elements
  beyond 1e-4, none beyond 2e-2. At f32 weights, atol 2e-2, the bound of
  tests/test_conv_embed_fused.py.
* Kernel 6: the port's plain version against JAX `logmel_rows_fused` at the
  fbank kernel bound, atol 2e-5, rtol 1e-4 (tests/test_fbank_pallas.py),
  on frames formed by `frames_from_buf`, which must equal JAX's
  `_frames_from_buf`.
* The geometry gate equals JAX's `front_embed_supported`.
* The step's route: kernel 16 at int8 and bf16 (no stacked embed), the
  stacked embed at f32 (kernel 16 never called).
* A 1-layer d = J = 128 model with 14,500 tokens: the JAX chunk-decode gate
  passes it, kernel 4's block does not fit the H100 (237,248 bytes of
  232,448), so the port's step decodes pull by pull; its events and state
  match the JAX engine's up to near-tie decisions (testing.NEAR_TIE).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.config import FbankOptions as JFbankOptions
from april_asr_tpu.frontend import fbank as jfb
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.ops import conv_embed_pallas as JCE
from april_asr_tpu.ops import fbank_pallas as JFP
from april_asr_tpu_torch.config import FbankOptions
from april_asr_tpu_torch.frontend import fbank as tfb
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import conv_embed_kernels as TCE
from april_asr_tpu_torch.ops import decode_kernels as TDK
from april_asr_tpu_torch.ops import fbank_kernels as TFK

DIMS = JM.TransducerDims(d_model=64, hidden=64, ffn=64, joiner_dim=64, vocab=64, layers=1,
                         decoder_groups=16, conv_channels=(4, 8, 16))
SEG, STEP, MEL = DIMS.segment_size, DIMS.segment_step, DIMS.mel


def _params(precision, seed=3):
    p = JM.init_transducer_params(jax.random.PRNGKey(seed), DIMS)
    if precision == "bf16":
        p = JM.cast_weights(p, jnp.bfloat16)
    return p, from_jax_params({k: np.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("S,P", [(4, 5), (8, 1), (8, 27)])
def test_conv_embed_plain_matches_jax_interpret(S, P, precision):
    jp, tp = _params(precision)
    W = (P - 1) * STEP + SEG
    front = np.random.default_rng(S * 100 + P).normal(size=(S, W, MEL)).astype(np.float32)
    got = TCE.conv_embed_windows(tp, torch.from_numpy(front), P=P, step=STEP, seg=SEG)
    assert got.shape == (P, S, DIMS.d_model) and torch.isfinite(got).all()
    # the entries' CPU path is the same plain version
    torch.testing.assert_close(
        TCE.conv_embed_from_front(tp, torch.from_numpy(front), P=P, step=STEP, seg=SEG), got,
        atol=0, rtol=0)
    for jfn in (JCE.conv_embed_windows, JCE.conv_embed_from_front):
        want = np.asarray(jfn(jp, jnp.asarray(front), P=P, step=STEP, seg=SEG, block_s=S,
                              interpret=True))
        d = np.abs(got.numpy() - want)
        if precision == "bf16":
            assert float((d > 1e-4).mean()) <= 0.01, f"{jfn.__name__}: {(d > 1e-4).mean():.4f}"
            assert float(d.max()) <= 2e-2, f"{jfn.__name__}: max {d.max():.4g}"
        else:
            assert float(d.max()) <= 2e-2, f"{jfn.__name__}: max {d.max():.4g}"


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_embed_weight_forms_match_jax(precision):
    """The CUDA kernel's weight forms are the JAX kernels' (conv_embed_pallas
    w2k, w3k and the (freq, ch)-ordered projection), bit for bit, derived
    once per weights dict."""
    jp, tp = _params(precision)
    c1, c2, c3 = DIMS.conv_channels
    f3 = DIMS.conv_freq_out
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    want = {
        "w1": bf(np.asarray(jp["conv1_w"], np.float32).reshape(c1, 9)),
        "w2k": bf(jnp.transpose(jp["conv2_w"], (2, 3, 1, 0)).reshape(9 * c1, c2)),
        "w3k": bf(jnp.transpose(jp["conv3_w"], (2, 3, 1, 0)).reshape(9 * c2, c3)),
        "wo": bf(jp["embed_out_w"].reshape(c3, f3, -1).transpose(1, 0, 2).reshape(f3 * c3, -1)),
    }
    forms = TCE.embed_weight_forms(tp)
    assert TCE.embed_weight_forms(tp) is forms
    for k, v in want.items():
        np.testing.assert_array_equal(forms[k].float().numpy(), v, err_msg=k)
    assert forms["w2k"].dtype == forms["w3k"].dtype == forms["wo"].dtype == torch.bfloat16


def test_conv_embed_per_window_padding_matters():
    """Against the whole buffer convolved at once: window 0 shares its top
    zero pad (and conv3 never reads its bottom rows), so it agrees; window 1
    sees a zero pad where the whole-buffer conv sees buffer row 3, so it
    differs. Guards the test above against a plain version without the
    windows' own padding."""
    _, tp = _params("bf16")
    P, S = 5, 4
    W = (P - 1) * STEP + SEG
    front = torch.from_numpy(np.random.default_rng(1).normal(size=(S, W, MEL)).astype(np.float32))
    got = TCE.conv_embed_windows(tp, front, P=P, step=STEP, seg=SEG)
    whole = TM.conv_subsample({k: (v.to(torch.bfloat16) if k in TCE.EMBED_KEYS else v)
                               for k, v in tp.items()}, front)
    assert whole.shape[1] == P
    assert float((got[0] - whole[:, 0]).abs().max()) < 1e-4
    assert float((got[1] - whole[:, 1]).abs().max()) > 1e-2


def test_front_embed_supported_matches_jax():
    n = 0
    for seg in (5, 7, 8, 9, 11):
        for mel in (4, 5, 80):
            for P in (1, 5, 27):
                for step in (2, 4):
                    for dW in (0, 1):
                        for S, block_s in ((8, 8), (6, 8), (3, 1)):
                            W = (P - 1) * step + seg + dW
                            args = (seg, mel, P, step, W, S, block_s)
                            ok = TCE.front_embed_supported(*args)
                            assert ok == JCE.front_embed_supported(*args), args
                            n += ok
    assert n > 0
    assert TCE.front_embed_supported(9, 80, 27, 4, 113, 256, block_s=1)


def test_frames_and_fused_fbank_plain_match_jax_interpret():
    S, chunk = 8, 16000
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    tl = tfb.FbankLayout.build(FbankOptions(), chunk)
    rng = np.random.default_rng(7)
    buf = ((rng.normal(0, 0.25, (S, tl.buf_len)) * 32768).clip(-32768, 32767).astype(np.int16)
           .astype(np.float32) / 32768.0)
    frames = TFK.frames_from_buf(tl, torch.from_numpy(buf))
    jframes = np.asarray(jax.vmap(lambda b: jfb._frames_from_buf(jl, b))(jnp.asarray(buf)))
    assert frames.shape == (S, tl.max_frames, FbankOptions().padded_window_size)
    np.testing.assert_array_equal(frames.numpy(), jframes)
    got = TFK.logmel_rows_fused(tl, frames)
    want = np.asarray(JFP.logmel_rows_fused(jl, jnp.asarray(jframes), block_s=S, interpret=True))
    assert got.shape == want.shape == (S, tl.max_frames, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny_april(tmp_path_factory):
    from april_asr_tpu_torch.models.export import make_model_parameters, save_april
    from april_asr_tpu_torch.testing import default_tokens

    dims = TM.TransducerDims(d_model=128, hidden=128, ffn=128, joiner_dim=128, vocab=64,
                             layers=1, decoder_groups=32, conv_channels=(4, 8, 8))
    path = str(tmp_path_factory.mktemp("front") / "tiny.april")
    save_april(path, dims, TM.init_transducer_params(5, dims),
               make_model_parameters(dims, default_tokens(dims.vocab)), name="tiny")
    return path


@pytest.mark.parametrize("precision,front", [("int8", True), ("bf16", True), (None, False)])
def test_step_embeds_from_front_at_bf16_weights(tiny_april, monkeypatch, precision, front):
    """One BatchEngine tick: kernel 16 straight from the front buffer at
    int8 and bf16, the stacked windows through `encoder_embed` at f32."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine

    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    rt = Model(tiny_april, precision=precision, device="cpu").runtime
    calls = {"front": 0, "stacked": 0}
    orig_windows, orig_embed = TCE.conv_embed_windows, rt.encoder_embed

    def windows(*a, **k):
        calls["front"] += 1
        return orig_windows(*a, **k)

    def embed(w, x):
        calls["stacked"] += 1
        return orig_embed(w, x)

    monkeypatch.setattr(TM, "conv_embed_windows", windows)
    monkeypatch.setattr(rt, "encoder_embed", embed)
    S = 4
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=3200))
    for _ in range(S):
        eng.alloc(lambda r, toks: None)
    pcm = (np.random.default_rng(2).normal(0, 0.3, 3200) * 20000).astype(np.int16)
    for i in range(S):
        eng.feed(i, pcm)
    eng.tick()
    assert calls == ({"front": 1, "stacked": 0} if front else {"front": 0, "stacked": 1})


def test_narrow_large_vocab_takes_per_pull_decode(tmp_path, monkeypatch):
    """d = J = 128, 14,500 tokens, f32 as loaded, 8 slots, 2 ticks of 1 s and
    a flush: the port's step never calls kernel 4, and its events match the
    JAX BatchEngine's."""
    from april_asr_tpu.api import Model as JModel
    from april_asr_tpu.config import EngineConfig as JEngineConfig
    from april_asr_tpu.engine.batch import BatchEngine as JBatchEngine
    from april_asr_tpu.engine.step import unpack_events_np as j_unpack
    from april_asr_tpu.models.export import make_model_parameters, save_april
    from april_asr_tpu.testing import default_tokens
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import DecodeConfig, EngineConfig
    from april_asr_tpu_torch.engine import step as tstep
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.testing import INT_DECODE, DecisionMargins, capture_events, check_parting

    dims = JM.TransducerDims(d_model=128, hidden=128, ffn=128, joiner_dim=128, vocab=14500,
                             layers=1, decoder_groups=32, conv_channels=(4, 8, 8))
    ns, chunk, ticks = 8, 16000, 2
    T = DecodeConfig().max_active_tokens
    assert TDK.chunk_decode_supported(ns, 128, 128, 2, dims.vocab)
    assert TDK.chunk_decode_smem(128, 128, dims.vocab, T) == 237_248
    assert not TDK.chunk_decode_block_fits(128, 128, dims.vocab, T)
    assert TDK.chunk_decode_block_fits(512, 512, 8832, T)  # the flagship's widest vocabulary
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(4), dims).items()}
    p["join_b"] = p["join_b"].copy()
    p["join_b"][0] += 2.0
    path = str(tmp_path / "narrow.april")
    save_april(path, dims, p, make_model_parameters(dims, default_tokens(dims.vocab)), name="n",
               form="native")

    def no_chunk_decode(*a, **k):
        raise AssertionError("the step ran the whole-chunk decode")

    monkeypatch.setattr(tstep, "chunk_decode", no_chunk_decode)
    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    je = JBatchEngine(JModel(path).runtime, batch=ns, cfg=JEngineConfig(chunk_samples=chunk))
    te = BatchEngine(Model(path, device="cpu").runtime, batch=ns, cfg=EngineConfig(chunk_samples=chunk))
    jev, tev = [], []
    capture_events(je.prog, j_unpack, jev)
    capture_events(te.prog, tstep.unpack_events_np, tev)
    jrec, trec = [[] for _ in range(ns)], [[] for _ in range(ns)]
    for eng, recs in ((je, jrec), (te, trec)):
        for i in range(ns):
            eng.alloc(lambda r, toks, i=i, recs=recs: recs[i].append(
                (int(r), tuple((int(t.token_id), int(t.time_ms)) for t in toks))))
    rng = np.random.default_rng(9)
    t = np.arange(ticks * chunk) / 16000.0
    waves = [((0.35 * np.sin(2 * np.pi * (180 + 60 * i) * t) + rng.normal(0, 0.05, t.size))
              * 20000).astype(np.int16) for i in range(ns)]
    parted = {}
    with DecisionMargins() as margins:
        for k in range(ticks + 1):
            margins.reset()
            if k < ticks:
                for i in range(ns):
                    je.feed(i, waves[i][k * chunk : (k + 1) * chunk])
                    te.feed(i, waves[i][k * chunk : (k + 1) * chunk])
                je.tick()
                te.tick()
            else:
                je.flush(np.ones(ns, bool))
                te.flush(np.ones(ns, bool))
            d = np.abs(te.state["h"].numpy() - np.asarray(je.state["h"]))
            assert float(d.mean()) < 5e-3 and float(np.percentile(d, 99)) < 0.05, f"h {k}"
            n_cells = jev[-1]["ops"].shape[1] * jev[-1]["ops"].shape[2]
            check_parting(
                k, jev[-1], tev[-1], margins.per_cell(n_cells), jrec, trec,
                {key: np.asarray(je.state["decode"][key]) for key in INT_DECODE},
                {key: te.state["decode"][key].numpy() for key in INT_DECODE}, parted,
            )
    assert sum(len(r) for r in jrec) > ns  # the decode emitted, not just silence
    print(f"narrow vocab: sessions parted at near-ties (step, cell, margin): {parted}")
