"""Port parity: kernels 2 and 3 (the int8 split-form LSTM layer) and the
int8 chunk encoder stack.

The JAX side runs its Pallas kernels in interpret mode
(`lstm_layer_chunk_rec_stream2_i8`, `ffn_norm_i8`,
`_lstm_stack_chunk_pallas`) at 128-divisible dims, as
tests/test_lstm_int8.py does. Both sides quantize per row with the same
formula and accumulate the int8 dots exactly, so one layer agrees to f32
ulps except where a one-ulp tanh/rsqrt difference flips an int8 rounding at
a .5 boundary; the multi-layer stack is held to the repo's own
cross-implementation bound `_assert_stat_close` (mean < 5e-3, p99 < 0.05,
tests/test_lstm_int8.py:69-80) for that reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.ops import lstm_pallas as JLP
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import lstm_kernels as TK

DIMS = JM.TransducerDims(
    mel=80, segment_size=9, segment_step=4, d_model=128, hidden=128, ffn=256,
    joiner_dim=128, vocab=128, layers=6, context=2, decoder_groups=32,
    conv_channels=(4, 8, 8),
)
S = 128
P = 12


def _assert_stat_close(a, b, mean_tol=5e-3, p99_tol=0.05, name=""):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float(d.mean()) < mean_tol, f"{name}: mean {d.mean():.5f}"
    assert float(np.percentile(d, 99)) < p99_tol, f"{name}: p99 {np.percentile(d, 99):.5f}"


def _assert_ulp_close(a, b, name=""):
    """f32-ulp agreement except isolated int8 rounding flips: at most 1% of
    elements beyond 1e-5, none beyond one int8 step of the row scale's
    effect (0.1 at these magnitudes)."""
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float((d > 1e-5).mean()) < 0.01, f"{name}: {(d > 1e-5).mean():.4f} beyond ulps"
    assert float(d.max()) < 0.1, f"{name}: max {d.max():.4f}"


@pytest.fixture(scope="module")
def qparams():
    p = JM.quantize_weights(JM.init_transducer_params(jax.random.PRNGKey(7), DIMS))
    p = JM.cast_weights(p, jnp.bfloat16)  # the int8 serving form: bf16 biases
    jp = {k: np.asarray(v) for k, v in p.items()}
    return p, from_jax_params(jp)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    y = rng.normal(size=(P, S, DIMS.d_model)).astype(np.float32)
    h = (rng.normal(size=(DIMS.layers, S, DIMS.d_model)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(DIMS.layers, S, DIMS.hidden)) * 0.3).astype(np.float32)
    n = rng.integers(0, P + 1, size=S).astype(np.int32)
    return y, h, c, n


def _layer_args(p, l):
    return (p["w_ih_t_q8"][l], p["w_ih_t_q8s"][l], p["w_hh_t_q8"][l], p["w_hh_t_q8s"][l],
            p["bias"][l], p["w_hr_t_q8"][l], p["w_hr_t_q8s"][l])


def test_quantize_and_cast_match_jax_bit_exact(qparams):
    """quantize_weights (from the f32 originals) and the bf16 cast give the
    JAX package's values bit for bit."""
    jp, tp = qparams
    src = JM.init_transducer_params(jax.random.PRNGKey(7), DIMS)
    got = TM.cast_weights(
        TM.quantize_weights(from_jax_params({k: np.asarray(v) for k, v in src.items()})),
        torch.bfloat16,
    )
    assert set(got) == set(tp)
    for k, v in got.items():
        assert v.dtype == tp[k].dtype, k
        np.testing.assert_array_equal(
            v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy(),
            tp[k].view(torch.int16).numpy() if v.dtype == torch.bfloat16 else tp[k].numpy(),
            err_msg=k,
        )


@pytest.mark.parametrize("gated", [False, True])
def test_rec_kernel_one_layer(qparams, inputs, gated):
    jp, tp = qparams
    y, h, c, n = inputs
    n_arg = jnp.asarray(n) if gated else None
    jh, jh2, jc2 = JLP.lstm_layer_chunk_rec_stream2_i8(
        jnp.asarray(y), jnp.asarray(h[0]), jnp.asarray(c[0]), *_layer_args(jp, 0),
        n_arg, block_s=128, interpret=True,
    )
    th, th2, tc2 = TK.lstm_layer_chunk_rec_stream2_i8(
        torch.from_numpy(y), torch.from_numpy(h[0]), torch.from_numpy(c[0]),
        *_layer_args(tp, 0), torch.from_numpy(n) if gated else None,
    )
    _assert_ulp_close(th.numpy(), jh, "hseq")
    _assert_ulp_close(th2.numpy(), jh2, "h")
    _assert_ulp_close(tc2.numpy(), jc2, "c")


def test_ffn_norm_kernel(qparams, inputs):
    jp, tp = qparams
    y, h, _, _ = inputs
    x = y.reshape(P * S, -1)
    hs = np.tile(h[1], (P, 1))
    args = lambda p: (p["ff1_t_q8"][2], p["ff1_t_q8s"][2], p["ff1_b"][2],  # noqa: E731
                      p["ff2_t_q8"][2], p["ff2_t_q8s"][2], p["ff2_b"][2], p["norm_eps"][2])
    want = JLP.ffn_norm_i8(jnp.asarray(x), jnp.asarray(hs), *args(jp), block_r=128, interpret=True)
    got = TK.ffn_norm_i8(torch.from_numpy(x), torch.from_numpy(hs), *args(tp))
    _assert_ulp_close(got.numpy(), want, "y")


@pytest.mark.parametrize("pulls", [P, 1])
def test_stack_matches_jax_kernels(qparams, inputs, pulls):
    """6 layers = 12 kernel calls, with the n_pulls prefix mask."""
    jp, tp = qparams
    y, h, c, n = inputs
    y = y[:pulls]
    gate = np.arange(pulls)[:, None] < np.minimum(n, pulls)[None, :]
    jy, jh, jc = JM._lstm_stack_chunk_pallas(
        jp, jnp.asarray(y), jnp.asarray(h), jnp.asarray(c), jnp.asarray(gate), 128
    )
    ty, th, tc = TM._lstm_stack_chunk_q8(
        tp, torch.from_numpy(y), torch.from_numpy(h), torch.from_numpy(c), torch.from_numpy(gate)
    )
    live = gate[:, :, None]  # masked steps give garbage y in both (callers mask it)
    _assert_stat_close(np.where(live, ty.numpy(), 0), np.where(live, np.asarray(jy), 0), name="y")
    _assert_stat_close(th.numpy(), jh, name="h")
    _assert_stat_close(tc.numpy(), jc, name="c")
