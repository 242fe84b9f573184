"""Port: kernel 9 as one cooperative launch (csrc/joiner_stream.cu, planned
by ops/joiner_plan.py `joiner_plan`).

The kernel slices W's V columns over its blocks, each block a slice of Vc
columns for a run of session tiles of TS sessions; t = wd(tanh(eout +
dout)) is computed once a call into a scratch laid out [tile][J][TS] and
streamed, KC rows at a time, through a ring; each thread holds an RC x RS
register tile of fmaf chains; each block reduces its columns to a 64-bit
argmax key a session and merges it with atomicMax, and the last block
writes the outputs. It runs only on the card, where chip_smoke.py holds it
bit for bit to the CUDA-core kernels it replaced (`joiner_argmax_simt`).
Here, on the CPU:

* the plan covers every column and session exactly once, and every thread
  tile's columns and rows every slice and tile position once, at S = 1, 3,
  37, 256 and 2048 x (J, V) = (512, 500), (512, 16,383), (128, 64), (128,
  16,383) at bf16 and f32, within the H100's 232,448 bytes a block (the C
  layout's bytes) and the blocks the card holds at once; it is None exactly
  where the route says "simt";
* a torch emulation of the launch (the scratch written and read in its
  layout, the stages of KC rows, each thread's chains in k order, the keys
  of each thread, block and slice, the last block's decode) against
  `joiner_argmax_plain` and the JAX `joiner_argmax_fused` in interpret mode
  at J = 128, S = 8 (`block_s` 8), V = 500 and 16,383, bf16 and f32 weights.
  Tolerances (as test_torch_port_dec_joiner_cluster.py): max_idx equal
  wherever the plain version's top two non-blank logits differ by more than
  1e-4; max_val and blank_val within 1e-5 of the plain version (f32 sums of
  the same products in another order), and of JAX at f32, within 1e-3 of
  JAX at bf16 (an ulp of tanh can flip a bf16 rounding of the joiner's
  input);
* the keys' merge on constructed logits: ties across slice boundaries and
  inside a slice, and the blank at a slice's first, last and a middle
  column, give the plain argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops import joiner_pallas as JJP
from april_asr_tpu_torch.ops import joiner_plan as JP
from april_asr_tpu_torch.ops.activations import dot_wd
from april_asr_tpu_torch.ops.joiner_kernels import (
    NEG_INF, joiner_argmax_plain, stream_weight_form)
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

# registers a thread of each register tile, as an estimate of what ptxas
# gives the kernel (the card's own occupancy decides there)
H100_REGS = {0: 168, 1: 80, 2: 48, 3: 40}


def h100_fit(tile: int, smem: int, resident: bool, w_bytes: int) -> int:
    """A model of the H100's blocks an SM for 256-thread blocks: the
    shared memory (228 KB an SM, 1 KB reserved a block), the registers and
    at most 8 blocks (2,048 threads)."""
    return max(0, min(8, 233_472 // (smem + 1024), 65_536 // (256 * H100_REGS[tile])))


SHAPES = [(S, J, V, wb) for S in (1, 3, 37, 256, 2048)
          for J, V in ((512, 500), (512, 16383), (128, 64), (128, 16383)) for wb in (2, 4)]


@pytest.mark.parametrize("S, J, V, wb", SHAPES)
def test_joiner_plan_covers_every_column_and_session_once(S, J, V, wb):
    plan = JP.joiner_plan(S, J, V, wb, h100_fit)
    assert plan is not None
    assert JP.joiner_route(S, J, V, wb) == "stream"
    assert JP.joiner_route(S, J, V, wb, h100_fit) == "stream"
    seen = np.zeros(V, np.int32)
    for i in range(plan.n_vs):
        seen[plan.v_slice(i).start:plan.v_slice(i).stop] += 1
    assert (seen == 1).all() and len(plan.v_slice(plan.n_vs - 1)) > 0
    rows = np.zeros(S, np.int32)
    for g in range(plan.n_sg):
        assert 1 <= len(plan.tiles_of(g)) <= plan.rounds
        for r in plan.tiles_of(g):
            rows[plan.tile_rows(r).start:plan.tile_rows(r).stop] += 1
    assert (rows == 1).all()
    # the thread tiles cover each slice column and tile row once
    cols = np.zeros(plan.Vc, np.int32)
    for cg in range(plan.TC):
        cols[plan.columns(cg, wb)] += 1
    assert (cols == 1).all()
    trow = np.zeros(plan.TS, np.int32)
    for sg in range(plan.TSg):
        trow[plan.rows(sg)] += 1
    assert (trow == 1).all()
    assert plan.TC * plan.TSg <= JP.NT and plan.TC & (plan.TC - 1) == 0
    assert plan.smem == JP.joiner_smem(J, plan.Vc, plan.TS, plan.w_resident)
    assert plan.smem <= JP.SMEM_PER_BLOCK
    assert plan.blocks_per_sm == h100_fit(plan.ti, plan.smem, plan.w_resident, wb)
    assert plan.blocks <= plan.blocks_per_sm * JP.SM_COUNT  # every block co-resident


@pytest.mark.parametrize("S, J, V, wb", [(8, 100, 500, 4), (256, 520, 16383, 2), (3, 8, 64, 2)])
def test_joiner_plan_none_where_the_route_says_simt(S, J, V, wb):
    """J not a multiple of KC = 32: no plan, and the route keeps the
    CUDA-core kernels."""
    assert JP.joiner_plan(S, J, V, wb, h100_fit) is None
    assert JP.joiner_route(S, J, V, wb) == "simt"


def test_joiner_plan_at_the_vocab_cells():
    """S = 256, J = 512, V = 16,383: 8 x 8 register tiles, 128 slices of
    128 columns (one block an SM), two tiles of 128 sessions a block, W's
    slice (256 KB as f32) streamed through the ring, at both weight types.
    S = 2048 walks 16 tiles. V = 500 spreads the sessions over the blocks
    too."""
    for wb in (2, 4):
        p = JP.joiner_plan(256, 512, 16383, wb, h100_fit)
        assert (JP.TILES[p.ti], p.Vc, p.TS, p.rounds, p.blocks, p.w_resident) == \
            ((8, 8), 128, 128, 2, 128, False)
        assert p.v_slice(127) == range(16256, 16383)
        p = JP.joiner_plan(2048, 512, 16383, wb, h100_fit)
        assert (p.Vc, p.TS, p.rounds, p.blocks) == (128, 128, 16, 128)
        p = JP.joiner_plan(256, 512, 500, wb, h100_fit)
        assert p.n_sg > 1 and p.blocks >= 64
    p = JP.joiner_plan(256, 512, 16383, 2, h100_fit)
    assert p.staged_bytes == 128 * 2 * (512 * 128 * 4 + 512 * 128 * 4)
    assert p.cycles_per_k == 2 * 2 * 64  # two tiles, two warps a scheduler, 64 FFMA
    # 4 x 4 tiles on 64-column slices: twice the slices, no fewer cycles
    q = JP.plan_for(256, 512, 16383, 2, h100_fit, 1, 16, 16, False)
    assert q.cycles_per_k >= p.cycles_per_k


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
def test_stream_weight_form_lays_out_slices(wd):
    """f32 slices, bf16 weights widened exactly."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(32, 70)).astype(np.float32)).to(wd)
    b = torch.zeros(70)
    form = stream_weight_form(w, b, 16)
    assert form.shape == (5, 32, 16) and form.dtype == torch.float32
    assert torch.equal(form[2], w[:, 32:48].float())
    assert torch.equal(form[4, :, :6], w[:, 64:].float())
    assert not form[4, :, 6:].any()
    assert stream_weight_form(w, b, 16) is form  # cached by identity


def _key(v: np.ndarray, i: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit argmax key (csrc/joiner_stream.cu `argmax_key`):
    the float's order-preserving bits above the inverted column index."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    ord_ = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return (ord_ << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.asarray(i, np.uint64))


def _decode(best: np.ndarray):
    """(max_idx, max_val) of keys, as the last block decodes them."""
    mi = (np.uint64(0xFFFFFFFF) - (best & np.uint64(0xFFFFFFFF))).astype(np.int32)
    o = (best >> np.uint64(32)).astype(np.uint32)
    bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(np.uint32)
    return torch.from_numpy(mi), torch.from_numpy(bits.view(np.float32).copy())


def _emulate(plan, eout, dout, w, b, blank, wb):
    """The launch in torch. Phase 1 writes t into the scratch [n_st][J][TS]
    (sessions past S zero); each block (slice i, group g) walks its tiles,
    reading KC-row stages of the scratch and of W's slice form, each
    thread's chains accumulated k by k in order (f64 products and sums
    rounded to f32 each step, as one fmaf rounds); then each thread's key
    over its columns, the block's over its threads, the keys' maximum over
    the blocks, and the blank logit from the slice that holds it."""
    S, J = eout.shape
    t = torch.tanh(eout + dout).to(w.dtype).float()
    tbuf = torch.zeros(plan.n_st, J, plan.TS)
    for s in range(S):
        tbuf[s // plan.TS, :, s % plan.TS] = t[s]
    form = stream_weight_form(w, b, plan.Vc)
    keys = np.zeros(S, np.uint64)
    bv = torch.full((S,), float("nan"))
    for blk in range(plan.blocks):
        i, g = blk % plan.n_vs, blk // plan.n_vs
        v0 = i * plan.Vc
        for r in plan.tiles_of(g):
            acc = torch.zeros(plan.TS, plan.Vc, dtype=torch.float64)
            for c in range(J // JP.KC):
                tk = tbuf[r, c * JP.KC:(c + 1) * JP.KC].double()
                wk = form[i, c * JP.KC:(c + 1) * JP.KC].double()
                for kk in range(JP.KC):
                    acc = (acc + tk[kk][:, None] * wk[kk][None, :]).float().double()
            v = v0 + np.arange(plan.Vc)
            lg = acc.float().numpy() + np.where(v < plan.V, b.numpy()[np.minimum(v, plan.V - 1)],
                                                 np.float32(0))
            tile = plan.tile_rows(r)
            if v0 <= blank < v0 + plan.Vc:
                bv[tile.start:tile.stop] = torch.from_numpy(lg[:len(tile), blank - v0].copy())
                lg[:, blank - v0] = np.float32(NEG_INF)
            k = np.where(v[None, :] < plan.V, _key(lg, np.broadcast_to(v, lg.shape)), np.uint64(0))
            # each thread's key over its columns, then the block's over its threads
            per_thread = np.stack([k[:, plan.columns(cg, wb)].max(axis=1) for cg in range(plan.TC)])
            sl = slice(tile.start, tile.stop)
            keys[sl] = np.maximum(keys[sl], per_thread.max(axis=0)[:len(tile)])
    mi, mv = _decode(keys)
    return mi, mv, bv


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("V", [500, 16383])
def test_stream_emulation_matches_plain_and_jax_interpret(prec, V):
    """S = 8 at J = 128: the card's plan for the shape (V = 500: 2 x 2
    tiles, sessions over several blocks; 16,383: 128-column slices), blank
    at 0 and inside a later slice."""
    S, J = 8, 128
    rng = np.random.default_rng(V + (prec == "f32"))
    eout = (rng.normal(size=(S, J)) * 2.0).astype(np.float32)
    dout = rng.normal(size=(S, J)).astype(np.float32)
    w = (rng.normal(size=(J, V)) * 0.25).astype(np.float32)
    b = (rng.normal(size=V) * 0.5).astype(np.float32)
    wd = torch.bfloat16 if prec == "bf16" else torch.float32
    jwd = jnp.bfloat16 if prec == "bf16" else jnp.float32
    wb = 2 if prec == "bf16" else 4
    plan = JP.joiner_plan(S, J, V, wb, h100_fit)
    for blank in (0, 300):
        args = (torch.from_numpy(eout), torch.from_numpy(dout), torch.from_numpy(w).to(wd),
                torch.from_numpy(b), blank)
        got = _emulate(plan, *args, wb)
        want = joiner_argmax_plain(*args)
        jax_out = JJP.joiner_argmax_fused(jnp.asarray(eout), jnp.asarray(dout),
                                          jnp.asarray(w).astype(jwd), jnp.asarray(b),
                                          blank_id=blank, block_s=S, interpret=True)
        logits = dot_wd(torch.tanh(args[0] + args[1]), args[2]) + args[3]
        logits[:, blank] = -float("inf")
        top2 = logits.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4
        assert int(clear.sum()) >= S - 1
        jtol = 1e-5 if prec == "f32" else 1e-3
        np.testing.assert_array_equal(got[0].numpy()[clear], want[0].numpy()[clear])
        np.testing.assert_array_equal(got[0].numpy()[clear], np.asarray(jax_out[0])[clear])
        for k in (1, 2):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jax_out[k]), atol=jtol, rtol=0)


@pytest.mark.parametrize("Vc", [16, 128])
@pytest.mark.parametrize("blank", [0, 15, 16, 100, 127, 128, 448, 499])
def test_key_merge_gives_the_plain_argmax(Vc, blank):
    """V = 500 in slices of Vc columns (the last ragged). Random logits,
    then constructed rows: equal maxima in two slices (the lower index
    wins), at a slice's last and the next one's first column, inside one
    slice, the blank's logit the largest, every column equal, the largest
    at a slice's first and at the last column."""
    V = 500
    n_vs = -(-V // Vc)
    rng = np.random.default_rng(Vc + blank)
    lg = rng.normal(size=(9, V)).astype(np.float32)
    top = float(np.abs(lg).max()) + 1.0
    other = lambda i: i if i != blank else i + 1  # noqa: E731
    lg[0, [other(1), other(Vc + 1)]] = top
    lg[1, [other(Vc - 1), other(Vc)]] = top
    lg[2, [other(Vc + 3), other(V - 2)]] = top
    lg[3, [other(5), other(6)]] = top
    lg[4, blank] = top + 1.0
    lg[5, :] = -1.0
    lg[6, other(min(Vc, V - 1))] = top
    lg[7, other(V - 1) if V - 1 != blank else V - 2] = top
    best = np.zeros(9, np.uint64)
    for i in range(n_vs):
        cols = np.arange(i * Vc, min((i + 1) * Vc, V))
        masked = np.where(cols[None, :] == blank, np.float32(NEG_INF), lg[:, cols])
        best = np.maximum(best, _key(masked, np.broadcast_to(cols, masked.shape)).max(axis=1))
    gi, gv = _decode(best)
    t = torch.from_numpy(lg)
    want = torch.where(torch.arange(V)[None, :] == blank, torch.tensor(NEG_INF), t)
    assert torch.equal(gi, want.argmax(dim=1).to(torch.int32))
    assert torch.equal(gv, want.amax(dim=1))
