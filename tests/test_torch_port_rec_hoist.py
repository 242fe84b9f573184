"""Port: kernels 14 and 13 as a hoisted x-side gate product plus one
persistent recurrence launch (csrc/lstm_hoist.cu, planned by
ops/lstm_mma.py `rec_hoist_plan`).

Phase A quantizes every x row and multiplies [P * S, d] x [d, 4H] in kernel
3's 128 x 128 tensor-core tiles into gx; phase B is kernel 2's cooperative
recurrence with only w_hh and w_hr stationary, each gate item's four gates
in whole 8-column mma tiles so that a lane runs its units' cells in
registers. The kernel runs only on the card, where chip_smoke.py holds it
bit for bit to the CUDA-core templates it replaced and to kernel 2. Here,
on the CPU:

* the plan covers every gate unit (its four gates in one item) and every
  projection output once, at the flagship, wide (d 1024 / H 4096), ragged
  and padded-odd widths, within the H100's shared memory and SM count, and
  refuses where nothing fits;
* a torch emulation of the two phases, following phase A's tiles and phase
  B's plan block by block (int dots per tile or column slice, per-block
  partial amaxes folded by max, each block quantizing its own slice),
  equals `lstm_rec_plain` bit for bit, gated and ungated;
* the emulation and both port entries agree with the JAX kernels 13 and 14
  in interpret mode to f32 ulps except isolated int8 rounding flips
  (`_assert_ulp_close`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops import lstm_pallas as JLP
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.activations import sigmoid
from test_torch_port_lstm_mma import (  # noqa: F401 (qparams: the module's fixture)
    DIMS,
    S_JAX,
    _assert_equal,
    _assert_ulp_close,
    _cols,
    _fold_amax,
    _gate_blocks,
    _item_blocks,
    _layer,
    _quant_blocks,
    _state,
    qparams,
)
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

# (S, d, H): flagship, wide (S = 256 and 2048), chip_smoke's ragged S = 3,
# padded-odd widths (the d 66 model's layers padded to 68 / 260; a ragged
# unit group at H = 12), tiny
SHAPES = [(256, 512, 1024), (256, 1024, 4096), (2048, 1024, 4096), (3, 512, 1024),
          (3, 1024, 4096), (256, 68, 260), (37, 68, 12), (8, 128, 128), (130, 96, 200)]


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_unit_and_output_once(shape, n_sm):
    S, d, H = shape
    try:
        plan = LM.rec_hoist_plan(S, d, H, n_sm=n_sm)
    except ValueError:
        assert -(-H // 32) > n_sm  # only where even 32-unit gate items outnumber the SMs
        return
    assert plan.nb <= n_sm and plan.smem <= LM.SMEM_LIMIT == 232_448 and plan.F == 0
    assert plan.ub in LM.HOIST_UNITS and plan.gate.items <= plan.nb
    assert plan.sp % 16 == 0 and plan.sp - 16 < S <= plan.sp
    units_seen = np.zeros((plan.sp, H), np.int32)
    for b in range(plan.nb):
        item = plan.gate_item(b)
        if item is None:
            continue
        units, rows, cols = item
        # whole 8-unit mma tiles a gate: the cell stays in a lane's registers
        assert 0 < len(units) <= plan.ub and units.start % 8 == 0 and plan.ub % 8 == 0
        assert rows.start % 16 == 0 and len(rows) % 16 == 0
        assert cols == [gi * H + u for gi in range(4) for u in units]
        units_seen[rows.start : rows.stop, units.start : units.stop] += 1
    assert (units_seen == 1).all()
    seen = np.zeros((plan.sp, d), np.int32)
    for b in range(plan.nb):
        item = plan.proj.item(b, plan.sp)
        if item is not None:
            cols, rows = item
            assert cols.start % 8 == 0 and rows.start % 16 == 0 and len(rows) % 16 == 0
            seen[rows.start : rows.stop, cols.start : cols.stop] += 1
    assert (seen == 1).all() and plan.proj.items <= plan.nb
    # the shared memory as csrc/lstm_hoist.cu's hoist_smem counts it
    nc = 4 * plan.ub
    assert plan.smem == (nc * (plan.dp + 16) + 2 * nc * 4 + plan.proj.ct * 8 * (plan.hp + 20)
                         + 3 * 128 * 144)


def test_plan_bytes():
    """The flagship and wide launches. At the flagship, S = 256, 16-unit
    gate items over 128 rows (one pass, every warp live: 8 mma tiles a
    warp's chain, where 32-unit items over 64 rows give 16 and idle half
    the warps); at S = 2048, 32-unit items over 512 rows (4 passes x 16,
    as 16-unit items over 1024 rows, but half the rows streamed). At d 1024
    / H 4096 only 32-unit items fit the SMs (128 unit groups for 132), over
    every row, the 133 KB w_hh slice leaving room for one-tile projection
    items; kernel 2 has no plan there. Phase A's scratch: gx is 453 MB at
    the wide widths, S = 256, P = 27."""
    flag = LM.rec_hoist_plan(256, 512, 1024)
    assert (flag.ub, flag.nb, flag.gate.ints(), flag.proj.ints(), flag.smem) == (
        16, 132, (128, 64, 128), (2, 64, 32, 128), 106_304)
    assert flag.smem == 64 * (512 + 16) + 2 * 64 * 4 + 16 * (1024 + 16 + 4) + 3 * 128 * 144
    assert LM.rec_hoist_plan(2048, 512, 1024).gate.ints() == (512, 32, 128)
    wide = LM.rec_hoist_plan(256, 1024, 4096)
    assert (wide.ub, wide.nb, wide.gate.ints(), wide.proj.ints(), wide.smem) == (
        32, 132, (256, 128, 128), (1, 256, 128, 128), 222_368)
    assert wide.smem == 128 * (1024 + 16) + 2 * 128 * 4 + 8 * (4096 + 16 + 4) + 3 * 128 * 144
    assert LM.rec_hoist_plan(2048, 1024, 4096).gate.ints() == (2048, 128, 128)
    with pytest.raises(ValueError, match="gate blocks"):
        LM.mma_plan(256, 1024, 4096)
    nbytes, offs = LM.hoist_scratch(wide, 27)
    assert offs[2] - offs[1] == 27 * 256 * 4 * 4096 * 4 == 452_984_832
    assert offs[1] == 6912 * 1024 and nbytes % 256 == 0 and list(offs) == sorted(offs)


@pytest.mark.parametrize("args, why", [
    ((256, 512, 8192, 132), "gate blocks"),   # 256 32-unit items for 132 SMs
    ((256, 512, 1024, 16), "gate blocks"),
    ((256, 8192, 1024, 132), "bytes"),        # an 8-unit item's w_hh slice alone is 263 KB
    ((256, 510, 1024, 132), "multiples of 4"),
    ((0, 512, 1024, 132), "positive"),
])
def test_plan_raises_where_nothing_fits(args, why):
    S, d, H, n_sm = args
    with pytest.raises(ValueError, match=why):
        LM.rec_hoist_plan(S, d, H, n_sm=n_sm)
    if why in ("gate blocks", "bytes"):
        assert LM.hoist_route(S, d, H, n_sm) == "simt"


# -- the two phases, tile by tile and block by block ------------------------


def _phase_a(x, w_ih_q, w_ih_s):
    """Phase A: _rowq8 of every x row (one warp a row), then 128 x 128 tiles
    of the [P * S, d] x [d, 4H] int8 product, gx = float(dot) * (xs * s_ih)."""
    P, S, d = x.shape
    R, N = P * S, w_ih_q.shape[1]
    xq, xs = LK._rowq8(x.reshape(R, d))
    gx = torch.full((R, N), float("nan"))
    T = LM.FFN_TILE
    for r0 in range(0, R, T):
        for c0 in range(0, N, T):
            rows, cols = slice(r0, min(r0 + T, R)), slice(c0, min(c0 + T, N))
            gx[rows, cols] = LK._int_dot(xq[rows], w_ih_q[:, cols]) * (
                xs[rows] * w_ih_s.reshape(1, -1)[:, cols])
    assert not gx.isnan().any()
    return gx.reshape(P, S, N)


def emulate_hoist(plan, x, h, c, n_pulls, w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s):
    """Phase A, then phase B: _rowq8 of whole h0 rows; per step the gate
    items' h-dots, + gx_t, + the bias, the cell, hc's amax folded over gate
    items, each item's hcq slice, the projection items, the carried h, h's
    amax folded over the items and each item's hq slice."""
    P, S, d = x.shape
    H = c.shape[1]
    gx = _phase_a(x, w_ih_q, w_ih_s)
    hq, hs = LK._rowq8(h)
    gb, pb = _gate_blocks(plan, S), _item_blocks(plan, plan.proj, S)
    b = bias.float().reshape(-1)
    hseq = []
    for t in range(P):
        gates = torch.full((S, 4 * H), float("nan"))
        for rows, units in gb:
            cols = [gi * H + u for gi in range(4) for u in units]
            gh = LK._int_dot(hq[rows], w_hh_q[:, cols]) * (hs[rows] * w_hh_s.reshape(-1)[cols])
            gates[rows, cols] = (gx[t][rows][:, cols] + gh) + b[cols]
        assert not gates.isnan().any()
        i, f, g, o = gates.split(H, dim=-1)
        c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        hc = sigmoid(o) * torch.tanh(c_new)
        live = torch.ones(S, 1, dtype=torch.bool) if n_pulls is None else (t < n_pulls)[:, None]
        c = torch.where(live, c_new, c)
        hcs = _fold_amax(hc, gb)
        h_new = _cols(plan, plan.proj, _quant_blocks(hc, hcs, gb), hcs, w_hr_q, w_hr_s, S, d)
        hseq.append(h_new)
        h = torch.where(live, h_new, h)
        hs = _fold_amax(h, pb)
        hq = _quant_blocks(h, hs, pb)
    return torch.stack(hseq), h, c


# (S, P, d, H, n_sm): chip_smoke's ragged S = 3, P = 5; a ragged unit group
# (H = 12) at padded-odd d; rows split over few SMs; 32-unit items at d 96;
# 16-unit items on 4 SMs
REC_CASES = [(3, 5, 64, 64, 132), (37, 4, 68, 12, 132), (40, 3, 128, 128, 8),
             (130, 2, 96, 200, 16), (20, 3, 64, 256, 132), (16, 3, 64, 64, 4)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S, P, d, H, n_sm", REC_CASES)
def test_phases_equal_plain(S, P, d, H, n_sm, gated):
    rec, _ = _layer(21, d, H, 4, torch.bfloat16 if gated else torch.float32)
    x, h, c = _state(22, S, d, H, P)
    n_pulls = (torch.from_numpy(np.random.default_rng(23).integers(0, P + 1, S).astype(np.int32))
               if gated else None)
    plan = LM.rec_hoist_plan(S, d, H, n_sm=n_sm)
    got = emulate_hoist(plan, x, h, c, n_pulls, *rec)
    _assert_equal(got, LK.lstm_rec_plain(x, h, c, n_pulls, *rec), ("hseq", "h", "c"))


def test_phases_cover_every_unit_size():
    """The cases above plan 8-, 16- and 32-unit gate items."""
    assert {LM.rec_hoist_plan(S, d, H, n_sm=n).ub for S, _, d, H, n in REC_CASES} == {8, 16, 32}


# -- against the JAX kernels 13 and 14 in interpret mode ---------------------

JAX_KERNELS = {"13": (JLP.lstm_layer_chunk_rec_i8, LK.lstm_layer_chunk_rec_i8),
               "14": (JLP.lstm_layer_chunk_rec_stream_i8, LK.lstm_layer_chunk_rec_stream_i8)}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("kernel", sorted(JAX_KERNELS))
def test_match_jax_interpret(qparams, kernel, gated):
    jfn, tfn = JAX_KERNELS[kernel]
    jp, tp = qparams
    keys = TM.STEP_I8_KEYS[:7]
    P = 3
    x, h, c = _state(24, S_JAX, DIMS.d_model, DIMS.hidden, P)
    n = np.random.default_rng(25).integers(0, P + 1, S_JAX).astype(np.int32)
    want = jfn(jnp.asarray(x.numpy()), jnp.asarray(h.numpy()), jnp.asarray(c.numpy()),
               *(jp[k][0] for k in keys), jnp.asarray(n) if gated else None, block_s=S_JAX,
               interpret=True)
    n_t = torch.from_numpy(n) if gated else None
    w = tuple(tp[k][0] for k in keys)
    plan = LM.rec_hoist_plan(S_JAX, DIMS.d_model, DIMS.hidden)
    for what, got in (("emulation", emulate_hoist(plan, x, h, c, n_t, *w)),
                      ("entry", tfn(x, h, c, *w, n_t))):
        for g, wv, k in zip(got, want, ("hseq", "h", "c")):
            _assert_ulp_close(g.numpy(), wv, f"kernel {kernel} {what} {k}")


def test_templates_take_the_plain_version_on_the_cpu():
    """The kept CUDA-core templates (`*_simt`) run the plain version for CPU
    tensors, as every wrapper does."""
    rec, _ = _layer(26, 64, 64, 4, torch.bfloat16)
    x, h, c = _state(27, 5, 64, 64, 3)
    want = LK.lstm_rec_plain(x, h, c, None, *rec)
    for fn in (LK.lstm_layer_chunk_rec_i8_simt, LK.lstm_layer_chunk_rec_stream_i8_simt):
        _assert_equal(fn(x, h, c, *rec), want, ("hseq", "h", "c"))
