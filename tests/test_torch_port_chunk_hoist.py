"""Port: kernel 11, the whole int8 chunk layer, as kernel 14's launches with
kernel 3's FFN and norm as phases of the persistent one (csrc/lstm_hoist.cu
`lstm_chunk_hoist_i8`, planned by ops/lstm_mma.py `chunk_hoist_plan`), and
kernel 22 on kernel 14's launches.

Kernel 11 is phase A (x quantized, the x-side gate product), then one
cooperative launch: kernel 14's recurrence with hseq into a scratch, then
kernel 3's passes over the P * S rows, a grid barrier before each (yq, the
ff1 tiles with the row amax folded by atomicMax, mq, the ff2 tiles with
the residual, the norm). The kernel runs only on the card, where
chip_smoke.py holds it bit for bit to its CUDA-core template. Here, on the
CPU:

* a torch emulation, block by block: test_torch_port_rec_hoist.py's
  `emulate_hoist`, then the five phases with each ff1 and ff2 tile on its
  block in the plan's tile order and each block's partial row amax folded
  by max, equals `lstm_chunk_i8_plain` bit for bit at ragged shapes, gated
  and ungated;
* the plan covers each ff1 and ff2 output tile and each row of the yq, mq
  and norm phases once, its shared memory holds phase B and the re-carved
  tile stages, and its scratch keeps every buffer apart;
* the routes name the new launches at the flagship and the templates
  where no plan fits;
* the wrappers of kernels 11 and 22 and their kept templates take the
  plain version on the CPU.
"""

import numpy as np
import pytest
import torch

from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.activations import sigmoid
from april_asr_tpu_torch.tools import profile_chunk_split as PCS
from test_torch_port_ffn_mma import _tile_dot
from test_torch_port_lstm_mma import _assert_equal, _layer, _state
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)
from test_torch_port_rec_hoist import emulate_hoist


def _tiles_by_block(plan, n):
    """Each block's tiles of an n-column product in the order it walks them."""
    by = {}
    for b, rows, cols in plan.tile_blocks(n):
        by.setdefault(b, []).append((slice(rows.start, rows.stop), slice(cols.start, cols.stop)))
    return by


def emulate_chunk(plan, x, h, c, n_pulls, *w):
    """Kernel 11: kernel 14's phases (hseq, h', c'), then the FFN phases over
    the P * S rows: yq of whole rows; each block's ff1 tiles; DoubleSwish;
    each tile's row amax folded into the row's slot by max; mq; each
    block's ff2 tiles with the residual; BasicNorm of whole rows.
    DoubleSwish and the norm run on whole tensors, as in the plain version
    (PyTorch's CPU vector and scalar tanh may differ by an ulp)."""
    rec, (ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps) = w[:7], w[7:]
    hseq, h2, c2 = emulate_hoist(plan.rec, x, h, c, n_pulls, *rec)
    P, S, d = x.shape
    R, F = plan.ffn.R, plan.ffn.F
    y = x.reshape(R, d) + hseq.reshape(R, d)
    yq, ys = LK._rowq8(y)
    acc = torch.full((R, F), float("nan"))
    for tiles in _tiles_by_block(plan, F).values():
        for r, cl in tiles:
            acc[r, cl] = _tile_dot(yq, ff1_q, range(r.start, r.stop), range(cl.start, cl.stop),
                                   plan.ffn.dp)
    assert not acc.isnan().any()
    mid = acc * (ys * ff1_s.reshape(1, -1)) + ff1_b.float().reshape(1, -1)
    mid = mid * sigmoid(mid - 1.0)
    amax = torch.zeros(R, 1)
    for tiles in _tiles_by_block(plan, F).values():
        for r, cl in tiles:
            amax[r] = torch.maximum(amax[r], mid[r, cl].abs().amax(dim=-1, keepdim=True))
    ms = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    mq = torch.round(mid * torch.reciprocal(ms))
    out = torch.full((R, d), float("nan"))
    for tiles in _tiles_by_block(plan, d).values():
        for r, cl in tiles:
            ff = (_tile_dot(mq, ff2_q, range(r.start, r.stop), range(cl.start, cl.stop),
                            plan.ffn.fp) * (ms[r] * ff2_s.reshape(-1)[cl])
                  + ff2_b.float().reshape(-1)[cl])
            out[r, cl] = y[r, cl] + ff
    assert not out.isnan().any()
    out = out * torch.rsqrt((out * out).mean(dim=-1, keepdim=True) + eps.float())
    return out.reshape(P, S, d), h2, c2


# (S, P, d, H, F, n_sm): chip_smoke's ragged S = 3, P = 5; a ragged unit
# group (H = 12) at padded-odd d and F; rows over several tiles on few SMs;
# 32-unit items with an odd F; 16-unit items on 4 SMs; 12 ff1 tiles for
# phase B's 8 blocks (a launch wider than phase B)
CASES = [(3, 5, 64, 64, 128, 132), (37, 4, 68, 12, 20, 132), (40, 4, 128, 128, 256, 8),
         (130, 2, 96, 200, 196, 16), (16, 3, 64, 64, 64, 4), (8, 40, 64, 16, 512, 132)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S, P, d, H, F, n_sm", CASES)
def test_phases_equal_plain(S, P, d, H, F, n_sm, gated):
    rec, ffn = _layer(31, d, H, F, torch.bfloat16 if gated else torch.float32)
    x, h, c = _state(32, S, d, H, P)
    n_pulls = (torch.from_numpy(np.random.default_rng(33).integers(0, P + 1, S).astype(np.int32))
               if gated else None)
    plan = LM.chunk_hoist_plan(S, P, d, H, F, n_sm=n_sm)
    got = emulate_chunk(plan, x, h, c, n_pulls, *rec, *ffn)
    want = LK.lstm_chunk_i8_plain(x, h, c, *rec, *ffn, n_pulls)
    _assert_equal(got, want, ("y", "h", "c"))


def test_phases_cover_every_unit_size():
    """The cases above plan 8-, 16- and 32-unit gate items, and launches
    wider than phase B's."""
    plans = [LM.chunk_hoist_plan(S, P, d, H, F, n_sm=n) for S, P, d, H, F, n in CASES]
    assert {p.rec.ub for p in plans} == {8, 16, 32}
    assert any(p.nb > p.rec.nb for p in plans)


# -- the plan ----------------------------------------------------------------

# (S, P, d, H, F): the flagship at S = 256 and 2048, chip_smoke's ragged S
# = 3, the wide widths, padded-odd widths, ragged rows
PLAN_SHAPES = [(256, 27, 512, 1024, 2048), (2048, 27, 512, 1024, 2048), (3, 5, 512, 1024, 2048),
               (256, 27, 1024, 4096, 8192), (37, 4, 68, 260, 196), (130, 2, 96, 200, 196)]


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("S, P, d, H, F", PLAN_SHAPES)
def test_plan_covers_every_tile_and_row_once(S, P, d, H, F, n_sm):
    try:
        plan = LM.chunk_hoist_plan(S, P, d, H, F, n_sm=n_sm)
    except ValueError:
        assert LM.hoist_route(S, d, H, n_sm) == "simt"  # only where phase B has no plan
        return
    R = P * S
    assert plan.ffn == LM.ffn_plan(R, d, F) and plan.rec == LM.rec_hoist_plan(S, d, H, n_sm)
    assert plan.rec.nb <= plan.nb <= n_sm
    for n in (F, d):  # ff1, ff2
        seen = np.zeros((plan.ffn.rp, n), np.int32)
        blocks = set()
        for b, rows, cols in plan.tile_blocks(n):
            assert 0 <= b < plan.nb and len(rows) <= LM.FFN_TILE and len(cols) <= LM.FFN_TILE
            seen[rows.start : rows.stop, cols.start : cols.stop] += 1
            blocks.add(b)
        assert (seen[:R] == 1).all() and (seen[R:] == 0).all()
        nx, ny = plan.ffn.grid(n)
        assert len(blocks) == min(plan.nb, nx * ny)
    rows = np.zeros(R, np.int32)
    for b, r in plan.row_blocks():  # the yq, mq and norm phases walk the same rows
        assert 0 <= b < plan.nb
        rows[r] += 1
    assert (rows == 1).all()
    # the shared memory: phase B's, and the re-carved two tile stages and row
    # amax slots (csrc/ffn_mma.cuh FM_TILE_SMEM) within it
    tile_smem = 2 * 2 * LM.FFN_TILE * (LM.FFN_KT + 16) + 4 * LM.FFN_TILE
    assert tile_smem == LM.FFN_SMEM == 41_472
    assert plan.smem == max(plan.rec.smem, tile_smem) <= LM.SMEM_LIMIT


def test_plan_scratch_and_bytes():
    """The flagship launch at S = 256, P = 27: phase B's plan (16-unit gate
    items over 128 rows, 106,304 bytes), all 132 SMs; the scratch is kernel
    14's, hseq [P S][d] f32, then kernel 3's, 256-byte aligned and apart
    (gx 113 MB and mid 57 MB above all)."""
    plan = LM.chunk_hoist_plan(256, 27, 512, 1024, 2048)
    assert (plan.nb, plan.smem, plan.rec.ub) == (132, 106_304, 16)
    nbytes, offs = plan.scratch()
    rec_n, rec_offs = LM.hoist_scratch(plan.rec, 27)
    ffn_n, ffn_offs = plan.ffn.scratch()
    R = 27 * 256
    assert offs[:7] == rec_offs and offs[7] == rec_n
    assert offs[8:] == tuple(offs[7] + LM._up(4 * R * 512, 256) + o for o in ffn_offs)
    assert nbytes == offs[8] + ffn_n and len(offs) == 14
    assert all(o % 256 == 0 for o in offs) and list(offs) == sorted(offs)
    assert offs[2] - offs[1] == R * 4 * 1024 * 4 == 113_246_208


@pytest.mark.parametrize("args, why", [
    ((256, 27, 512, 8192, 2048, 132), "gate blocks"),
    ((256, 27, 8192, 1024, 2048, 132), "bytes"),
    ((256, 27, 512, 1024, 2046, 132), "multiples of 4"),
    ((256, 0, 512, 1024, 2048, 132), "positive"),
])
def test_plan_raises_where_nothing_fits(args, why):
    S, P, d, H, F, n_sm = args
    with pytest.raises(ValueError, match=why):
        LM.chunk_hoist_plan(S, P, d, H, F, n_sm=n_sm)


# -- the routes ----------------------------------------------------------------


def test_routes_name_the_new_kernels_and_the_templates():
    """At the flagship (S = 256 and 3) and the wide widths kernel 11 takes
    its persistent launch and kernel 22 kernel 14's; where phase B has no
    plan (H 8192: 256 gate items of 32 units for 132 SMs; d 8192: an 8-unit
    w_hh slice alone is 263 KB), both take their templates."""
    for S, d, H, F in ((256, 512, 1024, 2048), (3, 512, 1024, 2048), (256, 1024, 4096, 8192)):
        assert LM.chunk_route(S, d, H, F) == "hoist"
        assert LM.hoist_route(S, d, H) == "hoist"
        assert LM._route_cached("chunk", S, d, H, F, 132) == "hoist"
    for S, d, H, F in ((256, 512, 8192, 2048), (256, 8192, 1024, 2048)):
        assert LM.chunk_route(S, d, H, F) == "simt"
        assert LM.hoist_route(S, d, H) == "simt"
    assert LM.chunk_route(256, 512, 1024, 2048, n_sm=16) == "simt"


# -- the wrappers on the CPU ---------------------------------------------------


def test_wrappers_take_the_plain_version_on_the_cpu():
    """Kernel 11 and its template, kernel 22 (both template tiles) and its
    template run the plain versions for CPU tensors."""
    rec, ffn = _layer(34, 64, 64, 128, torch.bfloat16)
    x, h, c = _state(35, 5, 64, 64, 3)
    n_pulls = torch.tensor([0, 1, 2, 3, 3], dtype=torch.int32)
    want = LK.lstm_chunk_i8_plain(x, h, c, *rec, *ffn, n_pulls)
    for fn in (LK.lstm_layer_chunk_fused_i8, LK.lstm_layer_chunk_fused_i8_simt):
        _assert_equal(fn(x, h, c, *rec, *ffn, n_pulls), want, ("y", "h", "c"))
    want = LK.lstm_rec_plain(x, h, c, n_pulls, *rec)
    for fn in (PCS.rec_interleave_i8, PCS.rec_interleave_i8_simt):
        for block_s in PCS.INTERLEAVE_TS:
            _assert_equal(fn(x, h, c, *rec, n_pulls, block_s=block_s), want, ("hseq", "h", "c"))
    assert set(PCS.INTERLEAVE_SIMT) == set(PCS.INTERLEAVE_TS)
