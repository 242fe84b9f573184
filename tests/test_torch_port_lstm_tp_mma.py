"""Port: the launch plans and item decomposition of the tensor-parallel
step's kernels 18 and 19 as one launch each (csrc/lstm_tp_gates.cu,
planned by ops/tp_plan.py).

The kernels run only on the card, where chip_smoke.py holds them bit for
bit to the two-pass kernels they replaced (`*_simt`, csrc/lstm_tp.cu).
Here, on the CPU:

* kernel 18's plan (at either stage depth) covers every (session, hidden
  unit) of the gate phase and every (session, column) of the projection
  exactly once, within the H100's shared memory and SM count (one
  cooperative grid: every block co-resident); kernel 19's covers every
  (session, unit) once at most one block an SM; at the flagship shard the
  plans are the ones measured on the card;
* where no plan fits, the plan is None and the route names the two-pass
  kernel;
* kernel 18's weight forms are the weights, rearranged (a unit's four gates
  side by side) and, at bf16, widened exactly;
* a torch emulation of the kernels' items (kernel 18: the x and h products
  of each gate item from the weight forms, the cell, hc rounded to the
  weight type, each projection item; kernel 19: each item's exact integer
  dots and its scale fold) matches the plain versions (kernel 19 bit for
  bit, kernel 18 to test_torch_port_tp.py's bounds) and the JAX kernels in
  interpret mode. As in test_torch_port_lstm_mma.py, the cell runs on whole
  tensors (PyTorch's CPU tanh paths may differ by an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops import lstm_tp_pallas as JTP
from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_tp_kernels as TK
from april_asr_tpu_torch.ops import tp_plan as TP
from april_asr_tpu_torch.ops.activations import sigmoid
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

SMEM = 232_448  # bytes of shared memory an H100 block may opt in to
N_SM = 132
# (S, d, Hs): the flagship shard at m = 2 and m = 4, the ragged S = 3, the
# chunk tools' 2048, a narrow model
SHAPES = [(256, 512, 512), (256, 512, 256), (3, 512, 512), (2048, 512, 512), (8, 64, 32)]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=1e-3)


def _gcp_counts(plan):
    S, d, Hs = plan.S, plan.d, plan.Hs
    gates = np.zeros((S, Hs), np.int64)
    proj = np.zeros((S, d), np.int64)
    for b in range(plan.nb):
        for units, rows in plan.gate_items(b):
            assert len(units) == plan.ub and len(rows) <= plan.nr1
            gates[rows.start:rows.stop, units.start:min(units.stop, Hs)] += 1
        for cols, rows in plan.proj_items(b):
            assert len(cols) == TP.NC and len(rows) <= TP.NC
            proj[rows.start:rows.stop, cols.start:min(cols.stop, d)] += 1
    return gates, proj


@pytest.mark.parametrize("kc", [32, 64])
@pytest.mark.parametrize("S, d, Hs", SHAPES)
def test_gcp_plan_covers_every_unit_and_column_once(S, d, Hs, kc):
    plan = TP.gcp_plan(S, d, Hs, N_SM, kcs=(kc,))
    assert plan is not None and plan.kc == kc and plan.smem <= SMEM
    assert plan.smem == TP.gcp_smem(plan.ub, kc) and plan.nb <= N_SM
    gates, proj = _gcp_counts(plan)
    assert (gates == 1).all() and (proj == 1).all()


@pytest.mark.parametrize("S, d, Hs", SHAPES)
def test_gc_i8_plan_covers_every_unit_once(S, d, Hs):
    plan = TP.gc_i8_plan(S, d, Hs, N_SM)
    assert plan is not None and plan.smem <= SMEM and plan.nb <= N_SM
    cnt = np.zeros((plan.sp, Hs), np.int64)
    for b in range(plan.nb):
        units, rows = plan.gate.item(b, plan.sp)
        cnt[rows.start:rows.stop, units.start:units.stop] += 1
    assert (cnt == 1).all()
    assert plan.gate.item(plan.nb, plan.sp) is None
    nbytes, offsets = plan.scratch()
    assert all(o % 256 == 0 for o in offsets) and nbytes > offsets[-1]


def test_flagship_plans():
    """The plans measured on the H100 at the m = 2 shard, S = 256: kernel
    18 on one grid of 128 blocks (16-unit x 64-row gate items in 64-deep
    stages), kernel 19 on kernel 7's 16-unit x 64-row gate items."""
    p = TP.gcp_plan(256, 512, 512, N_SM)
    assert (p.ub, p.kc, p.nb, p.smem) == (16, 64, 128, 202_752)
    q = TP.gc_i8_plan(256, 512, 512, N_SM)
    assert (q.ub, q.gate.rows, q.nb, q.smem) == (16, 64, 128, 159_488)


@pytest.mark.parametrize("kind, args, kw", [
    ("gcp", (256, 512, 512), dict(smem_limit=100_000)),
    ("gc_i8", (256, 512, 4096), {}),
    ("gc_i8", (256, 512, 512), dict(smem_limit=60_000)),
])
def test_no_plan_routes_the_two_pass_kernel(kind, args, kw):
    plan = TP.gcp_plan(*args, **kw) if kind == "gcp" else TP.gc_i8_plan(*args, **kw)
    assert plan is None
    assert TP.tp_route(kind, *args, **kw) == "simt"
    assert TP.tp_route(kind, 256, 512, 512) == "fused"


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_weight_forms(wd):
    rng = np.random.default_rng(1)
    d, Hs = 12, 8
    w_ih, w_hh = (torch.from_numpy(rng.normal(size=(d, 4 * Hs)).astype(np.float32)).to(wd)
                  for _ in "ih")
    w_hr = torch.from_numpy(rng.normal(size=(Hs, d)).astype(np.float32)).to(wd)
    wg, wr = TK.tp_weight_forms(w_ih, w_hh, w_hr)
    assert wg.dtype == wr.dtype == torch.float32 and wg.shape == (2, d, Hs, 4)
    for m, w in enumerate((w_ih, w_hh)):
        for g in range(4):
            assert torch.equal(wg[m, :, :, g], w[:, g * Hs:(g + 1) * Hs].float())
    assert torch.equal(wr, w_hr.float())
    assert TK.tp_weight_forms(w_ih, w_hh, w_hr)[0] is wg  # cached
    w_ih.mul_(2)  # an in-place edit makes a new form
    assert torch.equal(TK.tp_weight_forms(w_ih, w_hh, w_hr)[0][0, :, :, 0], w_ih[:, :Hs].float())


def _act(w):
    return (lambda v: v.to(torch.bfloat16).float()) if w.dtype == torch.bfloat16 else (lambda v: v)


def emulate_gcp(plan, x, h, c, w_ih, w_hh, bias, w_hr, gate=None):
    """Kernel 18 item by item: each gate item's x and h products from the
    weight forms (two sums, added in the epilogue with the bias), the cell,
    hc rounded to the weight type, then each projection item."""
    S, d = x.shape
    Hs = c.shape[1]
    wg, wr = TK.tp_weight_forms(w_ih, w_hh, w_hr)
    act = _act(w_ih)
    xa, ha = act(x), act(h)
    ax = torch.full((S, Hs, 4), float("nan"))
    ah = torch.full((S, Hs, 4), float("nan"))
    for b in range(plan.nb):
        for units, rows in plan.gate_items(b):
            u, r = slice(units.start, min(units.stop, Hs)), slice(rows.start, rows.stop)
            ax[r, u] = torch.einsum("rk,kug->rug", xa[r], wg[0][:, u])
            ah[r, u] = torch.einsum("rk,kug->rug", ha[r], wg[1][:, u])
    assert not (ax.isnan().any() or ah.isnan().any())
    i, f, g, o = ((ax + ah) + bias.float().reshape(4, Hs).T).unbind(-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    hc = act(sigmoid(o) * torch.tanh(c_new))
    hp = torch.full((S, d), float("nan"))
    for b in range(plan.nb):
        for cols, rows in plan.proj_items(b):
            cc, r = slice(cols.start, min(cols.stop, d)), slice(rows.start, rows.stop)
            hp[r, cc] = hc[r] @ wr[:, cc]
    assert not hp.isnan().any()
    return hp, LK._gate_blend(gate, c_new, c)


def emulate_gc_i8(plan, x, h, c, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, gate=None):
    """Kernel 19 item by item: whole x and h rows quantized (across the
    grid), each gate item's exact integer dots folded with the row and
    column scales, + b; the cell on whole tensors."""
    S = x.shape[0]
    Hs = c.shape[1]
    xq, xs = LK._rowq8(x)
    hq, hs = LK._rowq8(h)
    gates = torch.full((S, 4 * Hs), float("nan"))
    for b in range(plan.nb):
        units, rows = plan.gate.item(b, plan.sp)
        r = slice(rows.start, min(rows.stop, S))
        if r.start >= S:
            continue
        cols = [gi * Hs + u for gi in range(4) for u in units]
        gx = LK._int_dot(xq[r], w_ih_q[:, cols]) * (xs[r] * w_ih_s.reshape(-1)[cols])
        gh = LK._int_dot(hq[r], w_hh_q[:, cols]) * (hs[r] * w_hh_s.reshape(-1)[cols])
        gates[r, cols] = (gx + gh) + bias.float().reshape(-1)[cols]
    assert not gates.isnan().any()
    i, f, g, o = gates.split(Hs, dim=-1)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    return sigmoid(o) * torch.tanh(c_new), LK._gate_blend(gate, c_new, c)


def _inputs(seed, S, d, Hs):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(S, d)))
    h = t(rng.normal(size=(S, d)) * 0.3)
    c = t(rng.normal(size=(S, Hs)) * 0.3)
    gate = torch.from_numpy(rng.random(S) < 0.5)
    return x, h, c, gate


def _float_weights(seed, d, Hs, wd):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    w = lambda k, n: t(rng.normal(size=(k, n)) / np.sqrt(k)).to(wd)  # noqa: E731
    return w(d, 4 * Hs), w(d, 4 * Hs), t(rng.normal(size=4 * Hs) * 0.3), w(Hs, d)


def _i8_weights(seed, d, Hs, bias_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    q = lambda: t(rng.integers(-127, 128, size=(d, 4 * Hs)).astype(np.int8))  # noqa: E731
    s = lambda: t((rng.random(4 * Hs) * 2e-3 + 5e-4).astype(np.float32))  # noqa: E731
    b = t((rng.normal(size=4 * Hs) * 0.3).astype(np.float32)).to(bias_dtype)
    return q(), s(), q(), s(), b


# (S, d, Hs, n_sm): few SMs, so that blocks walk several items
EMU_CASES = [(8, 64, 32, 132), (37, 68, 20, 8), (130, 96, 200, 16)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S, d, Hs, n_sm", EMU_CASES)
def test_gcp_items_match_plain(S, d, Hs, n_sm, wd, gated):
    x, h, c, gate = _inputs(2, S, d, Hs)
    w = _float_weights(3, d, Hs, wd)
    g = gate if gated else None
    for kc in TP.KCS:
        plan = TP.gcp_plan(S, d, Hs, n_sm, kcs=(kc,))
        got = emulate_gcp(plan, x, h, c, *w, g)
        want = TK.lstm_gate_cell_proj_plain(x, h, c, *w, g)
        for gv, wv in zip(got, want):
            torch.testing.assert_close(gv, wv, **(F32_TOL if wd == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S, d, Hs, n_sm", EMU_CASES)
def test_gc_i8_items_equal_plain(S, d, Hs, n_sm, gated, bias_dtype):
    x, h, c, gate = _inputs(4, S, d, Hs)
    w = _i8_weights(5, d, Hs, bias_dtype)
    g = gate if gated else None
    plan = TP.gc_i8_plan(S, d, Hs, n_sm)
    got = emulate_gc_i8(plan, x, h, c, *w, g)
    want = TK.lstm_gates_cell_i8_plain(x, h, c, *w, g)
    for gv, wv, k in zip(got, want, ("hc", "c'")):
        assert torch.equal(gv, wv), f"{k}: max abs diff {float((gv - wv).abs().max()):.3g}"


S_JAX, D_JAX, HS_JAX = 128, 128, 128  # test_torch_port_tp.py's shard (d 128, hidden 256, m 2)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.float32)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_gcp_items_match_jax_interpret(wd):
    x, h, c, gate = _inputs(6, S_JAX, D_JAX, HS_JAX)
    w = _float_weights(7, D_JAX, HS_JAX, wd)
    plan = TP.gcp_plan(S_JAX, D_JAX, HS_JAX, N_SM)
    got = emulate_gcp(plan, x, h, c, *w, gate)
    want = JTP.lstm_gate_cell_proj(
        jnp.asarray(x.numpy()), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()), _j(w[0]),
        _j(w[1]), jnp.asarray(w[2].numpy()), _j(w[3]), jnp.asarray(gate.numpy()), block_s=S_JAX,
        interpret=True)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                   **(F32_TOL if wd == torch.float32 else BF16_TOL))


def test_gc_i8_items_match_jax_interpret():
    x, h, c, gate = _inputs(8, S_JAX, D_JAX, HS_JAX)
    w = _i8_weights(9, D_JAX, HS_JAX)
    plan = TP.gc_i8_plan(S_JAX, D_JAX, HS_JAX, N_SM)
    got = emulate_gc_i8(plan, x, h, c, *w, gate)
    want = JTP.lstm_gates_cell_i8(
        jnp.asarray(x.numpy()), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()),
        jnp.asarray(w[0].numpy()), jnp.asarray(w[1].numpy()), jnp.asarray(w[2].numpy()),
        jnp.asarray(w[3].numpy()), _j(w[4]), jnp.asarray(gate.numpy()), block_s=S_JAX,
        interpret=True)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5, rtol=1e-5)
