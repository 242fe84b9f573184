"""Port: the launch plan and the phase decomposition of kernel 12, the float
per-pull layer, as one persistent kernel (csrc/lstm_mma_float.cu, planned
by ops/lstm_mma.py `float_step_plan`).

The kernel runs only on the card, where chip_smoke.py holds it to the plain
version (f32 atol/rtol 1e-4, bf16 5e-2 / 1e-3). Here, on the CPU:

* the plan covers every gate column, projection and FFN output (row,
  column) exactly once at f32 and bf16 weights, with a unit's four gates
  in one item, maps every tile onto the block's 256 threads, and keeps its
  shared memory within the H100's, as the C side computes it; it plans
  widths that are multiples of 4 (not of 8: bf16 weight rows then take
  8-byte copies) and refuses other widths and shared memory where nothing
  fits;
* a torch emulation of the kernel's phases, item by item (each item's
  depth split into the plan's chunk and group order, the groups' partial
  tiles summed in group order), matches `lstm_layer_fused_plain` gated and
  ungated: f32 within 1e-5 (the same products summed in another order),
  bf16 within chip_smoke's 5e-2 / 1e-3. The transcendental steps run on
  whole tensors, as in the plain version;
* the emulation matches the JAX kernel `lstm_layer_fused` in interpret mode
  at the bounds of test_torch_port_perpull.py.
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
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.activations import double_swish, sigmoid
from april_asr_tpu_torch.ops.lstm_float_kernels import lstm_layer_fused_plain
from april_asr_tpu_torch.ops.lstm_kernels import _gate_blend

# (S, d, H, F): the flagship flush, chip_smoke's ragged 3, the tools' 2048,
# the reference and narrow models, and small odd row counts
SHAPES = [(256, 512, 1024, 2048), (3, 512, 1024, 2048), (2048, 512, 1024, 2048),
          (8, 128, 128, 256), (8, 128, 128, 128), (37, 64, 40, 24), (130, 96, 200, 160)]
WBYTES = [4, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run thousands of small products: one torch thread
    each, so that test processes sharing the cores do not stall them (under
    load, many threads made these tests ~60x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cover(split, n: int, S: int, nb: int):
    """Every (row, column) of an n-column product in exactly one item."""
    seen = np.zeros((S, n), np.int32)
    for b in range(split.items):
        cols, rows = split.item(b, n, S)
        assert cols.start % split.nc == 0 and rows.start % split.nr == 0
        seen[rows.start : rows.stop, cols.start : cols.stop] += 1
    assert split.item(split.items, n, S) is None
    assert (seen == 1).all(), f"{n} columns: counts {np.unique(seen)}"


def _threads(split, wbytes: int):
    """The tile fills the block's 256 threads (8 warps) exactly, and each
    group's share of a chunk is whole loads (f32) or mma steps (bf16)."""
    kg = LM.FKC // split.ks
    if wbytes == 4:
        assert split.ks * (split.nr // 8) * (split.nc // 8) == 256 and kg % 4 == 0
    else:
        assert split.ntw % 2 == 0 and split.nc % (8 * split.ntw) == 0
        assert split.ks * (split.nr // 16) * (split.nc // (8 * split.ntw)) == 8 and kg % 16 == 0
    assert LM.tile_groups(split.nr, split.nc, wbytes) == (split.ks, split.ntw)


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("wbytes", WBYTES)
@pytest.mark.parametrize("shape", SHAPES)
def test_float_plan_covers_every_output_once(shape, wbytes, n_sm):
    S, d, H, F = shape
    plan = LM.float_step_plan(S, d, H, F, wbytes, n_sm=n_sm)
    assert plan.nb <= n_sm and plan.smem <= LM.SMEM_LIMIT
    assert plan.gate.nc == 4 * plan.ub and plan.gate.ncg == -(-H // plan.ub)
    seen = np.zeros((S, 4 * H), np.int32)
    for b in range(plan.gate.items):
        units, rows, cols = plan.gate_item(b)
        assert units.start % plan.ub == 0 and 0 < len(units) <= plan.ub
        # a unit's four gate columns in one item, in the local order gi * ub + u
        assert cols == [gi * H + u for gi in range(4) for u in units]
        seen[rows.start : rows.stop][:, cols] += 1
    assert plan.gate_item(plan.gate.items) is None
    assert (seen == 1).all()
    for split, n in ((plan.proj, d), (plan.ff1, F), (plan.ff2, d)):
        _cover(split, n, S, plan.nb)
    for split in plan.splits():
        _threads(split, wbytes)
    assert plan.nb == min(n_sm, max(s.items for s in plan.splits()))


def test_float_plan_flagship_bytes():
    """The flagship launches and their shared memory as
    csrc/lstm_mma_float.cu's float_smem computes it: three ring stages of
    the largest (A [nr][72] f32 + B [64][nc + 8] weights), then the largest
    partial tiles [ks][nr][nc] f32."""
    f32 = LM.float_step_plan(256, 512, 1024, 2048, 4)
    bf16 = LM.float_step_plan(256, 512, 1024, 2048, 2)
    assert (f32.ub, f32.nb) == (16, 128) and (bf16.ub, bf16.nb) == (32, 128)
    assert f32.gate.ints() == (128, 64, 64, 128, 2, 0)
    assert bf16.gate.ints() == (64, 128, 32, 128, 1, 8)
    stage = lambda nr, nc, wb: nr * 72 * 4 + 64 * (nc + 8) * wb  # noqa: E731
    for plan, wb in ((f32, 4), (bf16, 2)):
        want = (3 * max(stage(s.nr, s.nc, wb) for s in plan.splits())
                + max(s.ks * s.nr * s.nc * 4 for s in plan.splits()))
        assert plan.smem == want == LM.float_smem(plan.splits(), wb) <= LM.SMEM_LIMIT
    assert f32.smem == 3 * (128 * 288 + 64 * 72 * 4) + 2 * 128 * 64 * 4 == 231_424
    assert bf16.smem == 3 * (64 * 288 + 64 * 136 * 2) + 64 * 128 * 4 == 140_288


@pytest.mark.parametrize("args, why", [
    ((256, 512, 1024, 2048, 4, 132, 60_000), "shared memory"),  # no stage fits
    ((256, 66, 1024, 2048, 4, 132, LM.SMEM_LIMIT), "multiples of 4"),
    ((256, 512, 1022, 2048, 2, 132, LM.SMEM_LIMIT), "multiples of 4"),
    ((0, 512, 1024, 2048, 2, 132, LM.SMEM_LIMIT), "positive"),
    ((256, 512, 1024, 2048, 1, 132, LM.SMEM_LIMIT), "f32 or bf16"),
])
def test_float_plan_raises_where_nothing_fits(args, why):
    S, d, H, F, wb, n_sm, limit = args
    with pytest.raises(ValueError, match=why):
        LM.float_step_plan(S, d, H, F, wb, n_sm=n_sm, smem_limit=limit)


@pytest.mark.parametrize("wbytes", WBYTES)
@pytest.mark.parametrize("S, d, H, F", [(256, 68, 1024, 2048), (256, 512, 1020, 2048),
                                        (37, 68, 260, 196)])
def test_float_plan_takes_multiples_of_4(S, d, H, F, wbytes):
    """Widths that are multiples of 4 but not of 8 plan, each output once."""
    plan = LM.float_step_plan(S, d, H, F, wbytes)
    assert plan.smem <= LM.SMEM_LIMIT and plan.gate.ncg == -(-H // plan.ub)
    for split, n in ((plan.proj, d), (plan.ff1, F), (plan.ff2, d)):
        _cover(split, n, S, plan.nb)


# -- the phases, item by item ----------------------------------------------


def _depth_groups(K: int, ks: int):
    """The depth indices of each of ks groups over a depth K: group g takes
    [kb + g * kg, +kg) of every chunk kb, in chunk order."""
    kg = LM.FKC // ks
    return [torch.tensor([k for kb in range(0, K, LM.FKC)
                          for k in range(kb + g * kg, kb + (g + 1) * kg) if k < K],
                         dtype=torch.long) for g in range(ks)]


def _tile(split, A_parts, W_parts, rows, cols):
    """One item's tile: the depth runs over each (A, W) operand in turn,
    each group's partial product over its indices, the partials summed in
    group order. A is f32, rounded to W's type as the fragments are."""
    parts = [0.0] * split.ks
    for A, W in zip(A_parts, W_parts):
        a = A[rows].to(W.dtype).float()
        w = W[:, cols].float()
        for g, idx in enumerate(_depth_groups(A.shape[1], split.ks)):
            parts[g] = parts[g] + a[:, idx] @ w[idx]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _cols(split, A, W, S, n):
    out = torch.full((S, n), float("nan"))
    for b in range(split.items):
        cols, rows = split.item(b, n, S)
        out[rows.start : rows.stop, cols.start : cols.stop] = _tile(
            split, [A], [W], slice(rows.start, rows.stop), list(cols))
    assert not out.isnan().any()
    return out


def emulate_float_step(plan, x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                       gate=None):
    """Kernel 12's phases: the gate items (x . w_ih then h . w_hh in one
    depth run) and the cell; the projection items, h', y = x + h'; the ff1
    items and DoubleSwish; the ff2 items and the residual; BasicNorm of
    whole rows."""
    S, d = x.shape
    H = c.shape[1]
    gates = torch.full((S, 4 * H), float("nan"))
    for b in range(plan.gate.items):
        _, rows, cols = plan.gate_item(b)
        gates[rows.start : rows.stop, cols] = _tile(
            plan.gate, [x, h], [w_ih, w_hh], slice(rows.start, rows.stop), cols)
    assert not gates.isnan().any()
    gates = gates + bias.float()
    i, f, g, o = gates.split(H, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    hc = sigmoid(o) * torch.tanh(c_new)
    h_new = _cols(plan.proj, hc, w_hr, S, d)
    y = x + h_new
    mid = double_swish(_cols(plan.ff1, y, ff1, S, ff1.shape[1]) + ff1_b.float())
    yn = y + (_cols(plan.ff2, mid, ff2, S, d) + ff2_b.float())
    out = yn * torch.rsqrt((yn * yn).mean(dim=-1, keepdim=True) + eps.float())
    return out, _gate_blend(gate, h_new, h), _gate_blend(gate, c_new, c)


def _layer(seed, d, H, F, wd):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    w = lambda k, n: t(rng.normal(size=(k, n)) / np.sqrt(k)).to(wd)  # noqa: E731
    b = lambda n: t(rng.normal(size=n) * 0.3).to(wd)  # noqa: E731
    return (w(d, 4 * H), w(d, 4 * H), b(4 * H), w(H, d), w(d, F), b(F), w(F, d), b(d),
            torch.tensor([0.25]))


def _state(seed, S, d, H):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(rng.normal(size=(S, d))), t(rng.normal(size=(S, d)) * 0.3),
            t(rng.normal(size=(S, H)) * 0.3), torch.from_numpy(rng.random(S) < 0.5))


TOL = {4: dict(atol=1e-5, rtol=1e-5), 2: dict(atol=5e-2, rtol=1e-3)}
STEP_CASES = [(3, 64, 64, 128, 132), (37, 64, 40, 24, 132), (20, 128, 128, 256, 8),
              (130, 96, 200, 160, 16), (19, 68, 36, 44, 16)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("wbytes", WBYTES)
@pytest.mark.parametrize("S, d, H, F, n_sm", STEP_CASES)
def test_float_step_phases_match_plain(S, d, H, F, n_sm, wbytes, gated):
    wd = torch.float32 if wbytes == 4 else torch.bfloat16
    lw = _layer(1, d, H, F, wd)
    x, h, c, gate = _state(2, S, d, H)
    g = gate if gated else None
    plan = LM.float_step_plan(S, d, H, F, wbytes, n_sm=n_sm)
    got = emulate_float_step(plan, x, h, c, *lw, g)
    want = lstm_layer_fused_plain(x, h, c, *lw, g)
    for gv, wv, k in zip(got, want, ("y", "h", "c")):
        assert torch.isfinite(gv).all(), k
        torch.testing.assert_close(gv, wv, **TOL[wbytes], msg=k)
    if gated:  # masked sessions keep their carried state exactly
        assert torch.equal(got[1][~gate], h[~gate]) and torch.equal(got[2][~gate], c[~gate])


# -- against the JAX kernel in interpret mode -------------------------------

DIMS = JM.TransducerDims(
    mel=80, segment_size=9, segment_step=4, d_model=128, hidden=128, ffn=256,
    joiner_dim=128, vocab=128, layers=1, context=2, decoder_groups=32, conv_channels=(4, 8, 8),
)
S_JAX = 128
JAX_TOL = {"f32": dict(atol=2e-5, rtol=1e-3), "bf16": dict(atol=2e-2, rtol=1e-3)}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_float_step_phases_match_jax_interpret(prec, gated):
    p = JM.init_transducer_params(jax.random.PRNGKey(5), DIMS)
    if prec == "bf16":
        p = JM.cast_weights(p, jnp.bfloat16)
    tp = from_jax_params({k: np.asarray(v) for k, v in p.items()})
    x, h, c, gate = _state(3, S_JAX, DIMS.d_model, DIMS.hidden)
    want = JLP.lstm_layer_fused(
        jnp.asarray(x.numpy()), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()),
        *(p[k][0] for k in TM.STEP_KEYS), jnp.asarray(gate.numpy()) if gated else None,
        block_s=S_JAX, interpret=True)
    plan = LM.float_step_plan(S_JAX, DIMS.d_model, DIMS.hidden, DIMS.ffn,
                              4 if prec == "f32" else 2)
    got = emulate_float_step(plan, x, h, c, *(tp[k][0] for k in TM.STEP_KEYS),
                             gate if gated else None)
    for gv, wv, k in zip(got, want, ("y", "h", "c")):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), err_msg=k, **JAX_TOL[prec])
