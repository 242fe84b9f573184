"""Port: the launch plan and the schedule of kernel 10, the float chunk
layer, as one persistent kernel (csrc/lstm_chunk_mma.cu, planned by
ops/lstm_mma.py `float_chunk_plan`).

The kernel runs only on the card, where chip_smoke.py holds it to the plain
version (f32 atol/rtol 1e-4, bf16 5e-2 / 1e-3). Here, on the CPU:

* the plan covers every gate column and projection output of a step's S
  rows, and every FFN output of the chunk's P * S rows, exactly once, maps
  every tile onto the block's 256 threads and keeps its shared memory
  within the H100's, at f32 and bf16 weights, for several P and S;
* a torch emulation of the kernel's schedule (for each step the gate items
  and the cell, the projection items, y_t = x_t + h' and the prefix mask on
  the carried h and c; then the ff1 and ff2 items over the P * S rows and
  BasicNorm of whole rows), each item's depth split into the plan's chunk
  and group order, matches `lstm_layer_chunk_plain` gated and ungated: f32
  within 1e-5 (the same products summed in another order), bf16 within
  chip_smoke's 5e-2 / 1e-3;
* the emulation matches the JAX kernel `lstm_layer_chunk_fused` in
  interpret mode at the bounds of test_torch_port_float.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops.lstm_pallas import lstm_layer_chunk_fused as j_chunk
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.activations import double_swish, sigmoid
from april_asr_tpu_torch.ops.lstm_float_kernels import lstm_layer_chunk_plain
from test_torch_port_lstm_mma_float import (  # noqa: F401 (_one_thread: the module's fixture)
    TOL, WBYTES, _cols, _cover, _layer, _one_thread, _threads, _tile)

# (S, P, d, H, F): the flagship step at 1 s chunks, chip_smoke's ragged 3
# and F1 width, the tools' 2048, the reference model, narrow odd shapes
PLAN_SHAPES = [(256, 27, 512, 1024, 2048), (3, 5, 512, 1024, 2048), (256, 27, 512, 2048, 4096),
               (2048, 27, 512, 1024, 2048), (8, 6, 128, 128, 256), (37, 1, 64, 40, 24),
               (19, 4, 68, 260, 196)]


def _cover_rows(split, n: int, R: int):
    """`_cover` where the rows are few enough to count, else the split's
    arithmetic: whole column groups over n, whole row groups over R."""
    if R * n <= 1 << 22:
        _cover(split, n, R, 0)
        return
    assert split.ncg == -(-n // split.nc) and split.items == split.ncg * -(-R // split.nr)
    cols, rows = split.item(split.items - 1, n, R)
    assert cols.stop == n and rows.stop == R and split.item(split.items, n, R) is None


@pytest.mark.parametrize("wbytes", WBYTES)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_chunk_plan_covers_every_output_once(shape, wbytes):
    S, P, d, H, F = shape
    plan = LM.float_chunk_plan(S, P, d, H, F, wbytes)
    assert plan.P == P and plan.nb <= 132 and plan.smem <= LM.SMEM_LIMIT
    assert plan.smem == LM.float_smem(plan.splits(), wbytes)
    seen = np.zeros((S, 4 * H), np.int32)
    for b in range(plan.gate.items):
        units, rows, cols = plan.gate_item(b)
        assert cols == [gi * H + u for gi in range(4) for u in units]
        seen[rows.start : rows.stop][:, cols] += 1
    assert plan.gate_item(plan.gate.items) is None and (seen == 1).all()
    _cover_rows(plan.proj, d, S)
    _cover_rows(plan.ff1, F, P * S)
    _cover_rows(plan.ff2, d, P * S)
    for split in plan.splits():
        _threads(split, wbytes)
    assert plan.nb == min(132, max(s.items for s in plan.splits()))
    assert LM.chunk_scratch(plan) == S * H + P * S * F


def test_chunk_plan_shares_kernel_12s_step_splits():
    """The gate and projection splits of a chunk are kernel 12's at the same
    S (the time loop runs kernel 12's first two phases)."""
    for wb in WBYTES:
        chunk = LM.float_chunk_plan(256, 27, 512, 1024, 2048, wb)
        step = LM.float_step_plan(256, 512, 1024, 2048, wb)
        assert (chunk.ub, chunk.gate, chunk.proj) == (step.ub, step.gate, step.proj)


@pytest.mark.parametrize("args, why", [
    ((256, 27, 66, 1024, 2048, 4), "multiples of 4"),
    ((256, 27, 512, 1024, 2046, 2), "multiples of 4"),
    ((256, 0, 512, 1024, 2048, 4), "positive"),
    ((256, 27, 512, 1024, 2048, 1), "f32 or bf16"),
])
def test_chunk_plan_refuses(args, why):
    with pytest.raises(ValueError, match=why):
        LM.float_chunk_plan(*args)


# -- the schedule, item by item ---------------------------------------------


def emulate_float_chunk(plan, x, h, c, w_ih, w_hh, bias, w_hr, ff1, ff1_b, ff2, ff2_b, eps,
                        n_pulls=None):
    """Kernel 10's schedule: per step t, the gate items (x_t . w_ih then
    h . w_hh in one depth run) and the cell, the projection items, y_t =
    x_t + h' and the carried h, c selected by t < n_pulls; then the ff1 items
    and DoubleSwish and the ff2 items and the residual over the P * S rows,
    and BasicNorm of whole rows."""
    P, S, d = x.shape
    H = c.shape[1]
    ys = []
    for t in range(P):
        gates = torch.full((S, 4 * H), float("nan"))
        for b in range(plan.gate.items):
            _, rows, cols = plan.gate_item(b)
            gates[rows.start : rows.stop, cols] = _tile(
                plan.gate, [x[t], h], [w_ih, w_hh], slice(rows.start, rows.stop), cols)
        assert not gates.isnan().any()
        i, f, g, o = (gates + bias.float()).split(H, dim=-1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        h_new = _cols(plan.proj, sigmoid(o) * torch.tanh(c_new), w_hr, S, d)
        ys.append(x[t] + h_new)
        live = torch.ones(S, 1, dtype=torch.bool) if n_pulls is None else (t < n_pulls)[:, None]
        h, c = torch.where(live, h_new, h), torch.where(live, c_new, c)
    y = torch.cat(ys)
    R = P * S
    mid = double_swish(_cols(plan.ff1, y, ff1, R, ff1.shape[1]) + ff1_b.float())
    yn = y + (_cols(plan.ff2, mid, ff2, R, d) + ff2_b.float())
    out = yn * torch.rsqrt((yn * yn).mean(dim=-1, keepdim=True) + eps.float())
    return out.reshape(P, S, d), h, c


def _chunk_state(seed, P, S, d, H):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (t(rng.normal(size=(P, S, d))), t(rng.normal(size=(S, d)) * 0.3),
            t(rng.normal(size=(S, H)) * 0.3),
            torch.from_numpy(rng.integers(0, P + 1, size=S).astype(np.int32)))


# (S, P, d, H, F, n_sm): one step, ragged rows, widths not multiples of 8,
# few SMs (many items a block)
CHUNK_CASES = [(3, 1, 64, 64, 128, 132), (11, 3, 64, 40, 24, 132), (20, 4, 68, 36, 44, 8),
               (37, 2, 96, 200, 160, 16)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("wbytes", WBYTES)
@pytest.mark.parametrize("S, P, d, H, F, n_sm", CHUNK_CASES)
def test_chunk_schedule_matches_plain(S, P, d, H, F, n_sm, wbytes, gated):
    wd = torch.float32 if wbytes == 4 else torch.bfloat16
    lw = _layer(1, d, H, F, wd)
    x, h, c, n = _chunk_state(2, P, S, d, H)
    g = n if gated else None
    plan = LM.float_chunk_plan(S, P, d, H, F, wbytes, n_sm=n_sm)
    got = emulate_float_chunk(plan, x, h, c, *lw, g)
    want = lstm_layer_chunk_plain(x, h, c, *lw, g)
    for gv, wv, k in zip(got, want, ("y", "h", "c")):
        assert torch.isfinite(gv).all(), k
        torch.testing.assert_close(gv, wv, **TOL[wbytes], msg=k)
    if gated:  # sessions with no live step keep their carried state exactly
        keep = n == 0
        assert torch.equal(got[1][keep], h[keep]) and torch.equal(got[2][keep], c[keep])


JAX_TOL = {"f32": dict(atol=2e-5, rtol=1e-3), "bf16": dict(atol=2e-2, rtol=1e-3)}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_schedule_matches_jax_interpret(prec, gated):
    """The inputs and scales of test_torch_port_float.py's kernel 10 case
    (tests/test_lstm_pallas.py `_layer_args`), P = 5, S = 32."""
    P, S, d, H, F = 5, 32, 128, 256, 256
    rng = np.random.default_rng(0)
    f = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    x, h, c = f(P, S, d) * 2.0, f(S, d), f(S, H)
    w = [f(d, 4 * H), f(d, 4 * H), f(4 * H), f(H, d), f(d, F), f(F), f(F, d), f(d)]
    n = rng.integers(0, P + 1, S).astype(np.int32)
    jd, td, wb = {"f32": (jnp.float32, torch.float32, 4),
                  "bf16": (jnp.bfloat16, torch.bfloat16, 2)}[prec]
    jw = [jnp.asarray(a).astype(jd) if a.ndim == 2 else jnp.asarray(a) for a in w]
    tw = [torch.from_numpy(a).to(td) if a.ndim == 2 else torch.from_numpy(a) for a in w]
    want = j_chunk(jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), *jw, jnp.float32(0.25),
                   jnp.asarray(n) if gated else None, block_s=S, interpret=True)
    plan = LM.float_chunk_plan(S, P, d, H, F, wb)
    got = emulate_float_chunk(plan, torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(c),
                              *tw, torch.tensor([0.25]), torch.from_numpy(n) if gated else None)
    for gv, wv, k in zip(got, want, ("y", "h", "c")):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), err_msg=k, **JAX_TOL[prec])
