"""Port parity: kernel 4 (the whole-chunk greedy decode).

The same eouts, pull mask and aged decode state go through the port's plain
`chunk_decode` and the JAX package's `chunk_decode_fused` in interpret mode,
with f32 weights and with the int8 serving weights (bf16 dec_proj and
joiner, f32 dec tables). Decisions are integer logic on the same argmax, so
the events ops/tok/flags/time_ms/final_k and the integer state must be
element-exact in both. With f32 weights logprob and dout are f32 sums taken
in another order and are held to 1e-5, the bound
tests/test_decode_pallas.py:118-139 uses for its own kernel. With bf16
weights the joiner rounds tanh(eout + dout) to bf16 before the product, and
XLA's CPU tanh and PyTorch's differ by an ulp now and then, which flips that
rounding: one term of the joiner sum then moves by up to 2^-8 of
|tanh| * |w| (~3e-4 here), so logprob is held to 1e-3 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.config import DecodeConfig as JDecodeConfig
from april_asr_tpu.decode.greedy import init_decode_state as j_init_decode_state
from april_asr_tpu.decode.greedy import vocab_tables_device as j_vocab_tables
from april_asr_tpu.engine.step import INNER_STEPS_EMIT
from april_asr_tpu.io.params import build_vocab_tables as j_build_vocab_tables
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters
from april_asr_tpu.ops.decode_pallas import chunk_decode_fused
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.config import DecodeConfig
from april_asr_tpu_torch.decode.greedy import vocab_tables_device
from april_asr_tpu_torch.io.params import build_vocab_tables
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops.decode_kernels import chunk_decode

S, V = 128, 40
DIMS = JM.TransducerDims(
    layers=1, d_model=128, hidden=128, ffn=128, joiner_dim=128, vocab=V, decoder_groups=32,
)
STRIDE = 40
INT_STATE = ("context", "token_words", "head", "last_call", "time_ms", "last_emit_ms",
             "need_dec", "emitted_silence")


def _setup(seed, P, bf16):
    p = JM.init_transducer_params(jax.random.PRNGKey(seed), DIMS)
    p = JM.precompute_decoder_tables(p, DIMS)
    if bf16:
        p = JM.cast_weights(p, jnp.bfloat16)
    mp = make_model_parameters(DIMS, default_tokens(V))
    cfg = JDecodeConfig()
    rng = np.random.default_rng(seed)
    # logit-scale eouts so every heuristic branch is reachable
    eouts = (rng.normal(size=(P, S, DIMS.joiner_dim)) * 2.0).astype(np.float32)
    n = rng.integers(0, P + 1, size=S)
    can = np.arange(P)[:, None] < n[None, :]
    T = cfg.max_active_tokens
    st = j_init_decode_state(S, DIMS.context, DIMS.joiner_dim, mp.blank_id, cfg)
    st = {k: np.asarray(v) for k, v in st.items()}
    st["head"] = rng.integers(0, T, size=S).astype(np.int32)
    st["token_words"] = (rng.integers(0, V, size=(S, T))
                         | (rng.integers(0, 4, size=(S, T)) << 16)).astype(np.int32)
    st["time_ms"] = np.full(S, 4000, np.int32)
    st["last_emit_ms"] = rng.integers(0, 4000, size=S).astype(np.int32)
    st["last_call"] = rng.integers(0, T, size=S).astype(np.int32)
    st["context"] = rng.integers(0, V, size=(S, 2)).astype(np.int32)
    st["need_dec"] = rng.random(S) < 0.5
    st["emitted_silence"] = rng.random(S) < 0.5
    st["dout"] = (rng.normal(size=(S, DIMS.joiner_dim))).astype(np.float32)
    return p, mp, cfg, eouts, can, st


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("P", [27, 1])
@pytest.mark.parametrize("seed", [0, 3])
def test_chunk_decode_matches_jax_interpret(seed, P, bf16):
    p, mp, cfg, eouts, can, st = _setup(seed, P, bf16)
    tol = 1e-3 if bf16 else 1e-5
    cfg_key = (
        float(cfg.punctuation_margin), float(cfg.confident_margin),
        float(cfg.confident_logprob_penalty), float(cfg.long_silence_ms),
        float(cfg.silence_decay_ms), int(cfg.max_active_tokens),
    )
    jvt = j_vocab_tables(j_build_vocab_tables(mp))
    want_state, want_ev = chunk_decode_fused(
        jnp.asarray(eouts), jnp.asarray(can), {k: jnp.asarray(v) for k, v in st.items()},
        p["dec_table"], p["dec_proj_t"], p["dec_proj_b"], p["join_t"], p["join_b"], jvt["mask"],
        blank_id=mp.blank_id, stride_ms=STRIDE, emit_ramp=INNER_STEPS_EMIT, cfg_key=cfg_key,
        block_s=128, interpret=True,
    )

    tp = from_jax_params({k: np.asarray(v) for k, v in p.items()})
    from april_asr_tpu_torch.models.export import make_model_parameters as t_mmp

    tvt = vocab_tables_device(build_vocab_tables(t_mmp(DIMS, default_tokens(V))))
    np.testing.assert_array_equal(tvt["mask"], jvt["mask"])
    got_state, got_ev = chunk_decode(
        torch.from_numpy(eouts), torch.from_numpy(can),
        {k: torch.from_numpy(np.array(v)) for k, v in st.items()},
        tp["dec_table"], tp["dec_proj_t"], tp["dec_proj_b"], tp["join_t"], tp["join_b"], tvt,
        blank_id=mp.blank_id, stride_ms=STRIDE, emit_ramp=INNER_STEPS_EMIT,
        dcfg=DecodeConfig(),
    )
    n_events = int((np.asarray(want_ev["ops"]) != 0).sum())
    assert n_events > P * S // 4  # the heuristics were exercised
    for k in ("ops", "tok", "flags", "time_ms", "final_k"):
        np.testing.assert_array_equal(got_ev[k].numpy(), np.asarray(want_ev[k]), err_msg=k)
    np.testing.assert_allclose(got_ev["logprob"].numpy(), np.asarray(want_ev["logprob"]),
                               atol=tol, rtol=tol)
    for k in INT_STATE:
        np.testing.assert_array_equal(got_state[k].numpy(), np.asarray(want_state[k]), err_msg=k)
    np.testing.assert_allclose(got_state["dout"].numpy(), np.asarray(want_state["dout"]),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("budget", [0, 1])
def test_pack_events_blob_bit_identical(budget):
    """The APR4 event blob (engine/step.py:50-80) and the dense tensor are
    the JAX package's bit for bit, with budget 1 forcing the overflow
    layout; the port's host unpack reads the JAX blob the same way."""
    from april_asr_tpu.engine.step import pack_events as j_pack
    from april_asr_tpu.engine.step import unpack_blob_np as j_unpack_blob
    from april_asr_tpu_torch.engine.step import iter_blobs, pack_events, unpack_blob_np

    rng = np.random.default_rng(budget)
    S, R, I = 16, 27, 3
    active = rng.random((S, R, I)) < 0.1  # ~8 events a session: under the auto budget of 17
    base = rng.integers(0, 5000, size=S).astype(np.int32)
    ev = {
        "ops": np.where(active, rng.integers(1, 128, size=(S, R, I)), 0).astype(np.int32),
        "tok": np.where(active, rng.integers(0, 500, size=(S, R, I)), 0).astype(np.int32),
        "logprob": np.where(active, rng.normal(size=(S, R, I)), 0).astype(np.float32),
        "flags": np.where(active, rng.integers(0, 4, size=(S, R, I)), 0).astype(np.int32),
        "time_ms": np.where(active, base[:, None, None] + STRIDE * (1 + np.arange(R))[None, :, None], 0)
        .astype(np.int32),
        "final_k": np.where(active, rng.integers(0, 73, size=(S, R, I)), 0).astype(np.int32),
    }
    want = j_pack({k: jnp.asarray(v) for k, v in ev.items()}, jnp.asarray(base), STRIDE, budget)
    got = pack_events({k: torch.from_numpy(v) for k, v in ev.items()}, torch.from_numpy(base),
                      STRIDE, budget)
    np.testing.assert_array_equal(got.blob.numpy(), np.asarray(want.blob))
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(want.dense))
    (base_slot, sub), = list(iter_blobs(np.asarray(want.blob)))
    a, b = unpack_blob_np(sub), j_unpack_blob(sub)
    assert base_slot == 0 and a["overflow"] == b["overflow"] == (budget == 1)
    for k in ("counts", "base_time", "ops", "flags", "final_k", "tok", "logprob", "dt"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
