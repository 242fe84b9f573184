"""Port: the launch plan and the phase decomposition of kernels 2 and 7 on
the tensor cores (csrc/lstm_mma.cu, planned by ops/lstm_mma.py).

The kernels split a layer's columns over one block per SM and fold each
`_rowq8` row amax across blocks; they run only on the card, where
chip_smoke.py holds them bit for bit to kernel 13 and to the three-pass
step they replaced. Here, on the CPU:

* the plan covers every gate column once, with a unit's four gates in one
  block, and every projection and FFN output (column, row) once, within the
  H100's shared memory and SM count, and refuses where nothing fits;
* a torch emulation of the kernels' phases, following the plan block by
  block (int dots per column slice, per-block partial amaxes folded by max,
  each block quantizing its own slice), equals the plain versions
  `lstm_rec_plain` and `lstm_layer_fused_i8_plain` bit for bit. The
  transcendental steps (the cell, DoubleSwish, the norm) are per element or
  per row on the card; here they run on whole tensors, as in the plain
  versions, because PyTorch's CPU vector and scalar paths of tanh may
  differ by an ulp;
* the emulation agrees with the JAX kernels in interpret mode to f32 ulps
  except isolated int8 rounding flips (`_assert_ulp_close`, the bound of
  test_torch_port_lstm.py's one-layer test).
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
from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.activations import sigmoid
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)


# (S, d, H, F): the flagship step and chunk (S = 256, the chunk tools' 2048,
# chip_smoke's ragged 3), the reference model, tiny and odd widths
SHAPES = [(256, 512, 1024, 2048), (3, 512, 1024, 2048), (2048, 512, 1024, 0), (256, 512, 1024, 0),
          (8, 128, 128, 256), (3, 64, 64, 128), (37, 68, 12, 20), (130, 96, 200, 0)]


def _covers(plan: LM.MmaPlan, split: LM.ColSplit, n: int):
    """Every (padded row, column) of an n-column product in one item."""
    seen = np.zeros((plan.sp, n), np.int32)
    for b in range(plan.nb):
        item = split.item(b, plan.sp)
        if item is None:
            continue
        cols, rows = item
        assert cols.start % 8 == 0 and rows.start % 16 == 0 and len(rows) % 16 == 0
        seen[rows.start : rows.stop, cols.start : cols.stop] += 1
    assert (seen == 1).all(), f"{n} columns: counts {np.unique(seen)}"
    assert split.items <= plan.nb


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_column_once(shape, n_sm):
    S, d, H, F = shape
    try:
        plan = LM.mma_plan(S, d, H, F, n_sm=n_sm)
    except ValueError:
        assert -(-H // 16) > n_sm  # only where even 16-unit gate blocks outnumber the SMs
        return
    assert plan.nb <= n_sm and plan.smem <= LM.SMEM_LIMIT
    assert plan.sp % 16 == 0 and plan.sp - 16 < S <= plan.sp
    seen = np.zeros((plan.sp, 4 * H), np.int32)
    assert plan.gate.items <= plan.nb
    for b in range(plan.nb):
        item = plan.gate_item(b)
        if item is None:
            continue
        units, rows, cols = item
        assert 0 < len(units) <= plan.ub and units.start % 4 == 0
        assert rows.start % 16 == 0 and len(rows) % 16 == 0
        # a unit's four gate columns in one block, in the local order gi * ub + u
        assert cols == [gi * H + u for gi in range(4) for u in units]
        seen[rows.start : rows.stop][:, cols] += 1
    assert (seen == 1).all()
    _covers(plan, plan.proj, d)
    if F:
        _covers(plan, plan.ff1, F)
    else:
        assert plan.ff1 is None


def test_plan_flagship_bytes():
    """The flagship launches (16-unit gate items of 64 columns x 2 row
    halves; the projection and ff2 in 32 pairs of column tiles x 4 row
    quarters; ff1 in 128 pairs of column tiles) and their shared memory, as
    csrc/lstm_mma.cu's rec_smem and step_smem compute it."""
    k2 = LM.mma_plan(256, 512, 1024, 0)
    k7 = LM.mma_plan(256, 512, 1024, 2048)
    assert (k2.ub, k2.nb, k2.gate.ints(), k2.proj.ints()) == (16, 132, (128, 64, 128),
                                                             (2, 64, 32, 128))
    assert k7.proj == k2.proj and k7.ff1.ints() == (2, 256, 128, 128)
    ring = 3 * 128 * 144
    gate = 64 * (2 * 512 + 16) + 8 * 16 * (64 + 8) * 4 + 3 * 64 * 4
    assert k2.smem == gate + 16 * (1024 + 16 + 4) + ring == 176_192
    assert k7.smem == 217_920 == (gate + 16 * (1024 + 16 + 12) + 16 * (512 + 16 + 8)
                                  + 16 * (2048 + 16) + ring)
    # at S = 3 the rows cannot split: 8-unit items, one row tile each
    assert LM.mma_plan(3, 512, 1024, 2048).gate.ints() == (16, 128, 128)


@pytest.mark.parametrize("args, why", [
    ((256, 512, 4096, 0, 8), "gate blocks"),      # 256 16-unit blocks for 8 SMs
    ((256, 4096, 1024, 0, 132), "bytes"),         # a 2 x 4096-byte gate slice per column
    ((256, 510, 1024, 0, 132), "multiples of 4"),
    ((0, 512, 1024, 0, 132), "positive"),
])
def test_plan_raises_where_nothing_fits(args, why):
    S, d, H, F, n_sm = args
    with pytest.raises(ValueError, match=why):
        LM.mma_plan(S, d, H, F, n_sm=n_sm)


# -- the phases, block by block -------------------------------------------


def _q(x, s):
    return torch.round(x * torch.reciprocal(s))


def _scale(amax):
    return torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)


def _fold_amax(v, blocks):
    """The row amax of v [S, n] as the kernels form it: each block's partial
    over its (rows, columns), folded by max (atomicMax on the bits)."""
    amax = torch.zeros(v.shape[0], 1)
    for rows, cols in blocks:
        part = torch.zeros(v.shape[0], 1)
        part[rows] = v[rows][:, cols].abs().amax(dim=-1, keepdim=True)
        amax = torch.maximum(amax, part)
    return _scale(amax)


def _gate_blocks(plan, S):
    """(rows, units) of each gate item, rows cut at S."""
    out = []
    for b in range(plan.nb):
        item = plan.gate_item(b)
        if item is not None and item[1].start < S:
            units, rows, _ = item
            out.append((slice(rows.start, min(rows.stop, S)), list(units)))
    return out


def _item_blocks(plan, split, S):
    out = []
    for b in range(plan.nb):
        item = split.item(b, plan.sp)
        if item is not None and item[1].start < S:
            cols, rows = item
            out.append((slice(rows.start, min(rows.stop, S)), list(cols)))
    return out


def _quant_blocks(v, s, blocks):
    q = torch.full_like(v, float("nan"))
    for rows, cols in blocks:
        q[rows, cols] = _q(v[rows][:, cols], s[rows])
    assert not q.isnan().any()
    return q


def _gates(plan, xq, xs, hq, hs, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias):
    S, H = xq.shape[0], plan.H
    gates = torch.full((S, 4 * H), float("nan"))
    for rows, units in _gate_blocks(plan, S):
        cols = [gi * H + u for gi in range(4) for u in units]
        gx = LK._int_dot(xq[rows], w_ih_q[:, cols]) * (xs[rows] * w_ih_s.reshape(-1)[cols])
        gh = LK._int_dot(hq[rows], w_hh_q[:, cols]) * (hs[rows] * w_hh_s.reshape(-1)[cols])
        gates[rows, cols] = (gx + gh) + bias.float().reshape(-1)[cols]
    assert not gates.isnan().any()
    return gates


def _cols(plan, split, q, s, wq, ws, S, n):
    out = torch.full((S, n), float("nan"))
    for rows, cols in _item_blocks(plan, split, S):
        out[rows, cols] = LK._int_dot(q[rows], wq[:, cols]) * (s[rows] * ws.reshape(-1)[cols])
    assert not out.isnan().any()
    return out


def emulate_rec(plan, x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s):
    """Kernel 2's phases: _rowq8 of whole x and h0 rows; per step the gate
    blocks' dots and the cell, hc's amax folded over gate blocks, each
    block's hcq slice, the projection items, the carried h, h's amax folded
    over the items and each item's hq slice."""
    P, S, d = x.shape
    H = c.shape[1]
    xq, xs = LK._rowq8(x.reshape(P * S, d))
    xq, xs = xq.reshape(P, S, d), xs.reshape(P, S, 1)
    hq, hs = LK._rowq8(h)
    gb, pb = _gate_blocks(plan, S), _item_blocks(plan, plan.proj, S)
    hseq = []
    for t in range(P):
        gates = _gates(plan, xq[t], xs[t], hq, hs, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias)
        i, f, g, o = gates.split(H, dim=-1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        hc = sigmoid(o) * torch.tanh(c_new)
        live = (t < n_pulls)[:, None]
        c = torch.where(live, c_new, c)
        hcs = _fold_amax(hc, gb)
        hcq = _quant_blocks(hc, hcs, gb)
        h_new = _cols(plan, plan.proj, hcq, hcs, w_hr_q, w_hr_s, S, d)
        hseq.append(h_new)
        h = torch.where(live, h_new, h)
        hs = _fold_amax(h, pb)
        hq = _quant_blocks(h, hs, pb)
    return torch.stack(hseq), h, c


def emulate_step(plan, x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
                 ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, gate=None):
    """Kernel 7's phases: _rowq8 of whole x and h rows; the gate blocks and
    the cell; hcq per gate block; the projection items, h', y = x + h';
    yq per item; ff1 per ff1 item with DoubleSwish; mq per ff1 item; ff2
    per projection item with the residual; BasicNorm of whole rows."""
    S, d = x.shape
    H, F = c.shape[1], ff1_q.shape[1]
    xq, xs = LK._rowq8(x)
    hq, hs = LK._rowq8(h)
    gb, pb, fb = (_gate_blocks(plan, S), _item_blocks(plan, plan.proj, S),
                  _item_blocks(plan, plan.ff1, S))
    gates = _gates(plan, xq, xs, hq, hs, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias)
    i, f, g, o = gates.split(H, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    hc = sigmoid(o) * torch.tanh(c_new)
    hcs = _fold_amax(hc, gb)
    h_new = _cols(plan, plan.proj, _quant_blocks(hc, hcs, gb), hcs, w_hr_q, w_hr_s, S, d)
    y = x + h_new
    ys = _fold_amax(y, pb)
    mid = _cols(plan, plan.ff1, _quant_blocks(y, ys, pb), ys, ff1_q, ff1_s, S, F)
    mid = mid + ff1_b.float().reshape(1, -1)
    mid = mid * sigmoid(mid - 1.0)
    ms = _fold_amax(mid, fb)
    ff = _cols(plan, plan.proj, _quant_blocks(mid, ms, fb), ms, ff2_q, ff2_s, S, d)
    yn = y + (ff + ff2_b.float().reshape(1, -1))
    out = yn * torch.rsqrt((yn * yn).mean(dim=-1, keepdim=True) + eps.float())
    return out, LK._gate_blend(gate, h_new, h), LK._gate_blend(gate, c_new, c)


def _layer(seed, d, H, F, bias_dtype):
    """Random int8 layer weights in the serving form (int8 [k][n], f32
    column scales, biases of `bias_dtype`)."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    i8 = lambda k, n: t(rng.integers(-127, 128, size=(k, n)).astype(np.int8))  # noqa: E731
    sc = lambda n, a: t((rng.random(n) * a + a / 4).astype(np.float32))  # noqa: E731
    bi = lambda n: t(rng.normal(size=n).astype(np.float32) * 0.3).to(bias_dtype)  # noqa: E731
    rec = (i8(d, 4 * H), sc(4 * H, 2e-3), i8(d, 4 * H), sc(4 * H, 2e-3), bi(4 * H), i8(H, d),
           sc(d, 4e-3))
    ffn = (i8(d, F), sc(F, 2e-3), bi(F), i8(F, d), sc(d, 2e-3), bi(d), t(np.float32([1e-3])))
    return rec, ffn


def _state(seed, S, d, H, P=None):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    x = t(rng.normal(size=(S, d) if P is None else (P, S, d)).astype(np.float32))
    h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    return x, h, c


def _assert_equal(got, want, names):
    for g, w, k in zip(got, want, names):
        assert torch.equal(g, w), f"{k}: max abs diff {float((g - w).abs().max()):.3g}"


REC_CASES = [(3, 5, 64, 64, 132), (37, 4, 68, 12, 132), (40, 3, 128, 128, 8), (130, 2, 96, 200, 16)]


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S, P, d, H, n_sm", REC_CASES)
def test_rec_phases_equal_plain(S, P, d, H, n_sm, bias_dtype):
    rec, _ = _layer(1, d, H, 4, bias_dtype)
    x, h, c = _state(2, S, d, H, P)
    n_pulls = torch.from_numpy(np.random.default_rng(3).integers(0, P + 1, S).astype(np.int32))
    plan = LM.mma_plan(S, d, H, 0, n_sm=n_sm)
    got = emulate_rec(plan, x, h, c, n_pulls, *rec)
    _assert_equal(got, LK.lstm_rec_plain(x, h, c, n_pulls, *rec), ("hseq", "h", "c"))


STEP_CASES = [(3, 64, 64, 128, 132), (37, 68, 12, 20, 132), (20, 128, 128, 256, 8),
              (130, 96, 200, 160, 16)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S, d, H, F, n_sm", STEP_CASES)
def test_step_phases_equal_plain(S, d, H, F, n_sm, gated):
    rec, ffn = _layer(4, d, H, F, torch.bfloat16)
    x, h, c = _state(5, S, d, H)
    gate = torch.from_numpy(np.random.default_rng(6).random(S) < 0.5) if gated else None
    plan = LM.mma_plan(S, d, H, F, n_sm=n_sm)
    got = emulate_step(plan, x, h, c, *rec, *ffn, gate)
    _assert_equal(got, LK.lstm_layer_fused_i8_plain(x, h, c, *rec, *ffn, gate), ("y", "h", "c"))


# -- against the JAX kernels in interpret mode -----------------------------

DIMS = JM.TransducerDims(
    mel=80, segment_size=9, segment_step=4, d_model=128, hidden=128, ffn=256,
    joiner_dim=128, vocab=128, layers=1, context=2, decoder_groups=32, conv_channels=(4, 8, 8),
)
S_JAX = 128


def _assert_ulp_close(a, b, name=""):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert float((d > 1e-5).mean()) < 0.01, f"{name}: {(d > 1e-5).mean():.4f} beyond ulps"
    assert float(d.max()) < 0.1, f"{name}: max {d.max():.4f}"


@pytest.fixture(scope="module")
def qparams():
    p = JM.quantize_weights(JM.init_transducer_params(jax.random.PRNGKey(8), DIMS))
    p = JM.cast_weights(p, jnp.bfloat16)
    return p, from_jax_params({k: np.asarray(v) for k, v in p.items()})


def test_rec_phases_match_jax_interpret(qparams):
    jp, tp = qparams
    keys = TM.STEP_I8_KEYS[:7]
    P = 3
    x, h, c = _state(9, S_JAX, DIMS.d_model, DIMS.hidden, P)
    n = np.random.default_rng(10).integers(0, P + 1, S_JAX).astype(np.int32)
    want = JLP.lstm_layer_chunk_rec_stream2_i8(
        jnp.asarray(x.numpy()), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()),
        *(jp[k][0] for k in keys), jnp.asarray(n), block_s=S_JAX, interpret=True)
    plan = LM.mma_plan(S_JAX, DIMS.d_model, DIMS.hidden, 0)
    got = emulate_rec(plan, x, h, c, torch.from_numpy(n), *(tp[k][0] for k in keys))
    for g, w, k in zip(got, want, ("hseq", "h", "c")):
        _assert_ulp_close(g.numpy(), w, k)


def test_step_phases_match_jax_interpret(qparams):
    jp, tp = qparams
    x, h, c = _state(11, S_JAX, DIMS.d_model, DIMS.hidden)
    gate = np.random.default_rng(12).random(S_JAX) < 0.7
    want = JLP.lstm_layer_fused_i8(
        jnp.asarray(x.numpy()), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()),
        *(jp[k][0] for k in TM.STEP_I8_KEYS), jnp.asarray(gate), block_s=S_JAX, interpret=True)
    plan = LM.mma_plan(S_JAX, DIMS.d_model, DIMS.hidden, DIMS.ffn)
    got = emulate_step(plan, x, h, c, *(tp[k][0] for k in TM.STEP_I8_KEYS), torch.from_numpy(gate))
    for g, w, k in zip(got, want, ("y", "h", "c")):
        _assert_ulp_close(g.numpy(), w, k)


def test_ptxas_properties_parse():
    """chip_smoke.py's report of the new kernels' registers, shared memory
    and spills reads `-Xptxas -v` output per kernel."""
    from april_asr_tpu_torch.tools import sass_diff

    log = """ptxas info    : Compiling entry function '_Z19lstm_rec_mma_kernelILi4EEv7RecArgs' for 'sm_90a'
ptxas info    : Function properties for _Z19lstm_rec_mma_kernelILi4EEv7RecArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 592 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Used 8 registers, 16 bytes smem
"""
    props = sass_diff.ptxas_properties(log)
    assert props["_Z19lstm_rec_mma_kernelILi4EEv7RecArgs"] == (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 96 registers, used 1 barriers, 592 bytes cmem[0]")
    assert props["_Z1kv"] == "Used 8 registers, 16 bytes smem"
