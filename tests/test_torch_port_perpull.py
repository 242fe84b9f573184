"""Port parity: the per-pull path (the one-step encoder, the three-round
inner decode, and so every flush), its kernels 7, 12, 8 and 9, the decode
gates, and a vocabulary too large for the whole-chunk decode.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do.

* Kernel 7 (int8 layer step): both sides quantize per row with the same
  formula and sum the int8 dots exactly, so one layer agrees to f32 ulps
  except where an ulp of tanh/rsqrt flips an int8 rounding:
  `_assert_ulp_close`, the bound of test_torch_port_lstm.py's one-layer test.
* Kernel 12 (float layer step): f32 weights at the repo's f32 bound, atol
  2e-5, rtol 1e-3 (tests/test_lstm_pallas.py:150-160); bf16 weights at
  atol 2e-2, rtol 1e-3, the bound of test_torch_port_float.py's one-layer
  test (an ulp upstream can flip the bf16 rounding of an activation).
* Kernels 8 and 9 at V = 500 (not a multiple of 128): max_val, blank_val
  and dout' are f32 sums in another order, held to 1e-5 with f32 weights;
  with bf16 weights an ulp of tanh can flip the bf16 rounding of
  tanh(eout + dout), moving one joiner term by up to 2^-8 of it, so 1e-3
  (the bound of test_torch_port_decode.py). max_idx must be equal wherever
  the top two non-blank logits differ by more than that bound.
* The one-step encoder (conv embed, L layer steps, enc_proj) under
  APRIL_PALLAS=1 at S = 128, where JAX runs kernel 7 or 12 per layer:
  int8 at the repo's cross-implementation bound `_assert_stat_close`
  (tests/test_lstm_int8.py:69-80), f32 at the f32 bound, bf16 at 5e-2.
* The port's decode gates equal the JAX package's at S = 256.
* A large-vocabulary stream: the JAX gates refuse both the whole-chunk
  decode and kernel 8, so both packages decode pull by pull through the
  decoder step and kernel 9's function; events and state must agree up to
  a near-tie decision (testing.NEAR_TIE), as in test_torch_port_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.ops import decode_pallas as JDP
from april_asr_tpu.ops import joiner_pallas as JJP
from april_asr_tpu.ops import lstm_pallas as JLP
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import decode_kernels as TDK
from april_asr_tpu_torch.ops import joiner_kernels as TJK
from april_asr_tpu_torch.ops.lstm_float_kernels import lstm_layer_fused
from april_asr_tpu_torch.ops.lstm_kernels import lstm_layer_fused_i8

S = 128
DIMS = JM.TransducerDims(
    mel=80, segment_size=9, segment_step=4, d_model=128, hidden=128, ffn=256,
    joiner_dim=128, vocab=500, layers=2, context=2, decoder_groups=32, conv_channels=(4, 8, 8),
)
F32_TOL = dict(atol=2e-5, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=1e-3)


def _assert_stat_close(a, b, mean_tol=5e-3, p99_tol=0.05, name=""):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float(d.mean()) < mean_tol, f"{name}: mean {d.mean():.5f}"
    assert float(np.percentile(d, 99)) < p99_tol, f"{name}: p99 {np.percentile(d, 99):.5f}"


def _assert_ulp_close(a, b, name=""):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float((d > 1e-5).mean()) < 0.01, f"{name}: {(d > 1e-5).mean():.4f} beyond ulps"
    assert float(d.max()) < 0.1, f"{name}: max {d.max():.4f}"


def _params(precision, seed=7):
    """JAX params at the serving precision, and the port's copy."""
    p = JM.precompute_decoder_tables(JM.init_transducer_params(jax.random.PRNGKey(seed), DIMS), DIMS)
    if precision == "int8":
        p = JM.cast_weights(JM.quantize_weights(p), jnp.bfloat16)
    elif precision == "bf16":
        p = JM.cast_weights(p, jnp.bfloat16)
    return p, from_jax_params({k: np.asarray(v) for k, v in p.items()})


def _state(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(S, DIMS.d_model)) * 0.5).astype(np.float32)
    h = (rng.normal(size=(S, DIMS.d_model)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(S, DIMS.hidden)) * 0.3).astype(np.float32)
    gate = rng.random(S) < 0.7
    return x, h, c, gate


@pytest.mark.parametrize("gated", [False, True])
def test_layer_step_i8_plain_matches_jax_interpret(gated):
    jp, tp = _params("int8")
    x, h, c, gate = _state(1)
    jy, jh, jc = JLP.lstm_layer_fused_i8(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), *(jp[k][0] for k in TM.STEP_I8_KEYS),
        jnp.asarray(gate) if gated else None, block_s=S, interpret=True,
    )
    ty, th, tc = lstm_layer_fused_i8(
        torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c),
        *(tp[k][0] for k in TM.STEP_I8_KEYS),
        torch.from_numpy(gate) if gated else None,
    )
    _assert_ulp_close(ty.numpy(), jy, "y")
    _assert_ulp_close(th.numpy(), jh, "h")
    _assert_ulp_close(tc.numpy(), jc, "c")
    if gated:  # masked sessions keep their carried state exactly
        np.testing.assert_array_equal(th.numpy()[~gate], h[~gate])
        np.testing.assert_array_equal(tc.numpy()[~gate], c[~gate])


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_layer_step_float_plain_matches_jax_interpret(prec, gated):
    jp, tp = _params(prec)
    x, h, c, gate = _state(2)
    jy, jh, jc = JLP.lstm_layer_fused(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), *(jp[k][0] for k in TM.STEP_KEYS),
        jnp.asarray(gate) if gated else None, block_s=S, interpret=True,
    )
    ty, th, tc = lstm_layer_fused(
        torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c),
        *(tp[k][0] for k in TM.STEP_KEYS),
        torch.from_numpy(gate) if gated else None,
    )
    tol = F32_TOL if prec == "f32" else BF16_TOL
    for got, want, name in ((ty, jy, "y"), (th, jh, "h"), (tc, jc, "c")):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)
    if gated:
        np.testing.assert_array_equal(th.numpy()[~gate], h[~gate])
        np.testing.assert_array_equal(tc.numpy()[~gate], c[~gate])


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    J, V = DIMS.joiner_dim, DIMS.vocab
    eout = (rng.normal(size=(S, J)) * 2.0).astype(np.float32)
    dout = rng.normal(size=(S, J)).astype(np.float32)
    ctx = rng.integers(0, V, size=(S, 2)).astype(np.int32)
    need_dec = rng.random(S) < 0.5
    return eout, dout, ctx, need_dec


def _check_argmax(got, want, eout, dout, tp, tol):
    """mi equal where the port's top two non-blank logits differ by more
    than tol; mv and bv within tol everywhere."""
    mi, mv, bv = (t.numpy() for t in got)
    logits = TM.joiner_logits(tp, torch.from_numpy(eout), torch.from_numpy(dout)).numpy()
    logits[:, 0] = -np.inf
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(mi[clear], np.asarray(want[0])[clear])
    np.testing.assert_allclose(mv, np.asarray(want[1]), atol=tol, rtol=tol)
    np.testing.assert_allclose(bv, np.asarray(want[2]), atol=tol, rtol=tol)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_joiner_argmax_plain_matches_jax_interpret(prec):
    jp, tp = _params(prec)
    eout, dout, _, _ = _decode_inputs(3)
    want = JJP.joiner_argmax_fused(jnp.asarray(eout), jnp.asarray(dout), jp["join_t"], jp["join_b"],
                                   blank_id=0, block_s=S, interpret=True)
    got = TJK.joiner_argmax_fused(torch.from_numpy(eout), torch.from_numpy(dout), tp["join_t"],
                                  tp["join_b"], blank_id=0)
    _check_argmax(got, want, eout, dout, tp, 1e-5 if prec == "f32" else 1e-3)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_decoder_joiner_argmax_plain_matches_jax_interpret(prec):
    jp, tp = _params(prec)
    eout, dout, ctx, need_dec = _decode_inputs(4)
    want = JJP.decoder_joiner_argmax_fused(
        jnp.asarray(ctx), jnp.asarray(need_dec), jnp.asarray(dout), jnp.asarray(eout),
        jp["dec_table"], jp["dec_proj_t"], jp["dec_proj_b"], jp["join_t"], jp["join_b"],
        blank_id=0, block_s=S, interpret=True,
    )
    got = TJK.decoder_joiner_argmax_fused(
        torch.from_numpy(ctx), torch.from_numpy(need_dec), torch.from_numpy(dout),
        torch.from_numpy(eout), tp["dec_table"], tp["dec_proj_t"], tp["dec_proj_b"], tp["join_t"],
        tp["join_b"], blank_id=0,
    )
    tol = 1e-5 if prec == "f32" else 1e-3
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=tol, rtol=tol)
    np.testing.assert_array_equal(got[3].numpy()[~need_dec], dout[~need_dec])
    _check_argmax(got[:3], want[:3], eout, got[3].numpy(), tp, tol)


@pytest.mark.parametrize("precision", ["int8", "f32", "bf16"])
def test_encoder_step_matches_jax(monkeypatch, precision):
    monkeypatch.setenv("APRIL_PALLAS", "1")
    jp, tp = _params(precision, seed=5)
    rng = np.random.default_rng(6)
    L = DIMS.layers
    x = rng.normal(size=(S, DIMS.segment_size, DIMS.mel)).astype(np.float32)
    h = (rng.normal(size=(L, S, DIMS.d_model)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(L, S, DIMS.hidden)) * 0.3).astype(np.float32)
    je, jh, jc = JM.encoder_step(jp, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    te, th, tc = TM.encoder_step(tp, torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c))
    for got, want, name in ((te, je, "eout"), (th, jh, "h"), (tc, jc, "c")):
        if precision == "int8":
            _assert_stat_close(got.numpy(), want, name=name)
        else:
            tol = F32_TOL if precision == "f32" else dict(atol=5e-2, rtol=1e-3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("w_itemsize", [4, 2])
def test_decode_gates_match_jax(w_itemsize):
    """Over (V, d, J, context) at S = 256, JAX's block for S."""
    n = 0
    for V in (64, 500, 4096, 8832, 8833, 9000, 9100, 10900, 11000, 12000, 13433, 16383):
        for d in (96, 128, 512):
            for J in (128, 320, 512):
                for ctx in (1, 2):
                    args = (256, J, d, ctx)
                    assert TDK.chunk_decode_supported(*args, V) == JDP.chunk_decode_supported(
                        *args, V, block_s=256), (V, d, J, ctx)
                    assert TDK.dj_supported(*args, vocab=V, w_itemsize=w_itemsize) == JJP.dj_supported(
                        *args, block_s=256, vocab=V, w_itemsize=w_itemsize), (V, d, J, ctx)
                    n += TDK.dj_supported(*args, vocab=V, w_itemsize=w_itemsize)
    assert 0 < n < 12 * 3 * 3 * 2
    # the flagship widths: the chunk decode up to 8,832 tokens, kernel 8 further
    assert TDK.chunk_decode_supported(256, 512, 512, 2, 8832)
    assert not TDK.chunk_decode_supported(256, 512, 512, 2, 8833)
    assert not TDK.dj_supported(256, 512, 512, 2, vocab=16383, w_itemsize=w_itemsize)


def test_large_vocab_stream_matches_jax(tmp_path, monkeypatch):
    """A 1-layer model at d = J = 512 with 12,000 tokens, served as loaded
    (f32), 8 slots, 2 ticks of 1 s and a flush. The port's step must take
    the per-pull decode: kernel 4 is never called."""
    from april_asr_tpu.api import Model as JModel
    from april_asr_tpu.config import EngineConfig as JEngineConfig
    from april_asr_tpu.engine.batch import BatchEngine as JBatchEngine
    from april_asr_tpu.engine.step import unpack_events_np as j_unpack
    from april_asr_tpu.models.export import make_model_parameters, save_april
    from april_asr_tpu.testing import default_tokens
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine import step as tstep
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.testing import INT_DECODE, DecisionMargins, capture_events, check_parting

    dims = JM.TransducerDims(d_model=512, hidden=512, ffn=512, joiner_dim=512, vocab=12000, layers=1,
                             conv_channels=(4, 8, 8))
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(3), dims).items()}
    p["join_b"] = p["join_b"].copy()
    p["join_b"][0] += 2.0
    path = str(tmp_path / "vocab.april")
    save_april(path, dims, p, make_model_parameters(dims, default_tokens(dims.vocab)), name="v",
               form="native")
    ns, chunk, ticks = 8, 16000, 2
    assert not TDK.chunk_decode_supported(ns, 512, 512, 2, dims.vocab)
    assert not TDK.dj_supported(ns, 512, 512, 2, vocab=dims.vocab, w_itemsize=4)

    def no_chunk_decode(*a, **k):
        raise AssertionError("the step ran the whole-chunk decode")

    monkeypatch.setattr(tstep, "chunk_decode", no_chunk_decode)
    monkeypatch.setenv("APRIL_PALLAS", "1")
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
            _assert_stat_close(te.state["h"].numpy(), np.asarray(je.state["h"]), name=f"h {k}")
            n_cells = jev[-1]["ops"].shape[1] * jev[-1]["ops"].shape[2]
            check_parting(
                k, jev[-1], tev[-1], margins.per_cell(n_cells), jrec, trec,
                {key: np.asarray(je.state["decode"][key]) for key in INT_DECODE},
                {key: te.state["decode"][key].numpy() for key in INT_DECODE}, parted,
            )
    assert sum(len(r) for r in jrec) > ns  # the decode emitted, not just silence
    print(f"large vocab: sessions parted at near-ties (step, cell, margin): {parted}")
