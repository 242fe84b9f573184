"""Port parity: the int8 chunk-layer variants, kernels 11, 13 and 14 (one
layer each) and the wavefront stack (kernel 15), and the two ported
profiling tools that drive them.

The JAX side runs its Pallas kernels in interpret mode
(`lstm_layer_chunk_fused_i8`, `lstm_layer_chunk_rec_i8`,
`lstm_layer_chunk_rec_stream_i8`, `stack_wavefront_i8`), the port its plain
versions. Inputs are drawn with numpy; the weights are the JAX package's,
carried across with `from_jax_params`. One layer (layer 0 of
tests/test_torch_port_lstm.py's weights and inputs, at its shapes) holds
every step's output (hseq, or kernel 11's y) to f32 ulps except isolated
int8 rounding flips (`_assert_ulp_close`, as that file holds kernel 2, the
same function). The state after the 12th step is held to the repo's
cross-implementation bound (`_assert_stat_close`): the JAX kernels 13, 14
and 11 compute their gates in one fused XLA expression, kernel 2 from a
stored x-side term, and the two JAX kernels alone already differ beyond
1e-5 in 0.74% of the final c (1.5% of h and c between the port and kernel
13): each flipped int8 rounding compounds over the recurrence. The
wavefront stack is held to the bound tests/test_lstm_wavefront.py holds
the JAX kernel to (atol 2e-4, rtol 2e-4), at that test's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.ops import lstm_pallas as JLP
from april_asr_tpu.ops import lstm_wavefront_pallas as JWP
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import lstm_kernels as TK
from april_asr_tpu_torch.ops.lstm_wavefront_kernels import stack_wavefront_i8
from april_asr_tpu_torch.tools import profile_chunk_split, profile_wavefront
from test_torch_port_lstm import (  # noqa: F401 (fixtures)
    _assert_stat_close,
    _assert_ulp_close,
    _layer_args,
    inputs,
    qparams,
)

# tests/test_lstm_wavefront.py's shapes
WP, WS, Wd, WH, WF, WL = 7, 16, 16, 32, 24, 4


def _ffn_args(p, l):
    return (p["ff1_t_q8"][l], p["ff1_t_q8s"][l], p["ff1_b"][l],
            p["ff2_t_q8"][l], p["ff2_t_q8s"][l], p["ff2_b"][l], p["norm_eps"][l])


KERNELS = {
    "11": (JLP.lstm_layer_chunk_fused_i8, TK.lstm_layer_chunk_fused_i8, ("y", "h", "c")),
    "13": (JLP.lstm_layer_chunk_rec_i8, TK.lstm_layer_chunk_rec_i8, ("hseq", "h", "c")),
    "14": (JLP.lstm_layer_chunk_rec_stream_i8, TK.lstm_layer_chunk_rec_stream_i8,
           ("hseq", "h", "c")),
}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_chunk_layer_matches_jax_kernel(qparams, inputs, kernel, gated):
    jfn, tfn, names = KERNELS[kernel]
    jp, tp = qparams
    x, h, c, n = inputs
    h, c = h[0], c[0]
    ffn = kernel == "11"

    def args(p):
        return _layer_args(p, 0) + (_ffn_args(p, 0) if ffn else ())

    want = jfn(jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), *args(jp),
               jnp.asarray(n) if gated else None, block_s=128, interpret=True)
    got = tfn(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c), *args(tp),
              torch.from_numpy(n) if gated else None)
    seq, h2, c2 = zip(got, want)
    _assert_ulp_close(seq[0].numpy(), np.asarray(seq[1]), f"kernel {kernel} {names[0]}")
    for (g, w), name in ((h2, "h"), (c2, "c")):
        _assert_stat_close(g.numpy(), np.asarray(w), name=f"kernel {kernel} {name}")


def _wave_setup(seed):
    dims = JM.TransducerDims(layers=WL, d_model=Wd, hidden=WH, ffn=WF, mel=8, vocab=32)
    jp = JM.quantize_weights(JM.init_transducer_params(jax.random.PRNGKey(seed), dims))
    tp = from_jax_params({k: np.asarray(v) for k, v in jp.items()})
    rng = np.random.default_rng(seed + 1)
    x = (rng.normal(size=(WP, WS, Wd)) * 0.5).astype(np.float32)
    h = (rng.normal(size=(WL, WS, Wd)) * 0.1).astype(np.float32)
    c = (rng.normal(size=(WL, WS, WH)) * 0.1).astype(np.float32)
    return jp, tp, x, h, c


@pytest.mark.parametrize("slab", [2, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_wavefront_stack_matches_jax_kernel(slab, gated):
    jp, tp, x, h, c = _wave_setup(0)
    n = np.random.default_rng(0).integers(0, WP + 1, WS).astype(np.int32) if gated else None
    want = JWP.stack_wavefront_i8(jp, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                                  None if n is None else jnp.asarray(n), slab=slab, block_s=8,
                                  interpret=True)
    got = stack_wavefront_i8(tp, torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c),
                             None if n is None else torch.from_numpy(n), slab=slab)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)


def test_wavefront_gating_freezes_state():
    """Sessions with n_pulls = k carry exactly the state of a k-pull chunk."""
    _, tp, x, h, c = _wave_setup(3)
    k = 3
    x, h, c = torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c)
    _, h1, c1 = stack_wavefront_i8(tp, x, h, c, torch.full((WS,), k, dtype=torch.int32), slab=2)
    _, h2, c2 = stack_wavefront_i8(tp, x[:k].contiguous(), h, c, None, slab=2)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-5)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), atol=1e-5)


@pytest.mark.parametrize("tool", [profile_chunk_split, profile_wavefront],
                         ids=["profile_chunk_split", "profile_wavefront"])
def test_tool_reports_every_variant(tool):
    """The tool's entry function at tiny widths on the CPU: every variant
    runs and its reported difference from the shipped stack is within the
    repo's cross-implementation bound (`_assert_stat_close`: mean < 5e-3,
    p99 < 0.05)."""
    res = tool.main(["--tiny", "--device", "cpu", "--S", "8", "--P", "5", "--reps", "1"])
    assert set(res) == set(tool.VARIANTS)
    for name, r in res.items():
        for out, (mx, mean, p99) in r["diff"].items():
            assert np.isfinite(r["ms"]) and mx >= 0, f"{name} {out}"
            assert mean < 5e-3 and p99 < 0.05, f"{name} {out}: mean {mean} p99 {p99}"
