"""Port: kernel 8 on thread-block clusters (csrc/dec_joiner_cluster.cu,
planned by ops/decode_kernels.py `dj_plan`).

The kernel splits the joiner's V columns and dec_proj's J columns over the
C blocks of a cluster, each cluster a tile of sessions; only the sessions
whose need_dec is set refresh; each block reduces its columns to a 64-bit
argmax key a session, and the keys are merged in rank order. It runs only
on the card, where chip_smoke.py holds it bit for bit to the CUDA-core
kernels it replaced (`dec_joiner_simt`). Here, on the CPU:

* the plan covers every V and J column and every session exactly once at
  S = 1, 3, 256 and 2048 at bf16 and f32 (and at the CPU tests' widths),
  within the H100's 232,448 bytes a block (the C layout's bytes), one item
  a thread in each product, and is None exactly where no block holds a
  slice; the route by shape ("cluster" or "simt");
* a torch emulation of the launch (per tile: the refresh of the need_dec
  rows on each block's Jc columns, the other rows copied, the joiner on
  each block's Vc columns, the keys merged in rank order) against
  `decoder_joiner_argmax_plain` and the JAX `decoder_joiner_argmax_fused` in
  interpret mode at J = d = 128, S = 8 (`block_s` 8), bf16 and f32
  weights. Tolerances: max_idx equal wherever the plain version's top two
  non-blank logits differ by more than 1e-4; against the plain version
  max_val and blank_val within atol 1e-5 (f32 sums of the same products
  in another order) and dout' bit for bit (the same products, the other
  rows copied); against JAX the repo's bounds (test_torch_port_perpull.py):
  1e-5 at f32 weights, 1e-3 at bf16 (an ulp of tanh can flip a bf16
  rounding of the joiner's input);
* the keys' merge on constructed logits: ties across slice boundaries and
  inside a slice, and the blank at a slice's first, last and a middle
  column, give the plain argmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops import joiner_pallas as JJP
from april_asr_tpu_torch.ops import decode_kernels as DK
from april_asr_tpu_torch.ops.activations import dot_wd
from april_asr_tpu_torch.ops.joiner_kernels import NEG_INF, decoder_joiner_argmax_plain
from test_torch_port_chunk_decode_cluster import h100_clusters
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)
from test_torch_port_perpull import DIMS, _params

# (S, J, d, V, weight bytes): the flagship at bf16 and f32 (chip_smoke's S
# = 1, 3, 256, 2048 and a ragged 37), the CPU tests' d = J = 128 models
# (V = 64, 500 and 16,383) and a narrow joiner over a wide vocabulary
SHAPES = [(S, 512, 512, 500, wb) for S in (1, 3, 37, 256, 2048) for wb in (2, 4)] + [
    (8, 128, 128, 64, 4), (8, 128, 128, 500, 2), (256, 128, 128, 500, 4),
    (8, 128, 128, 16383, 4), (256, 128, 128, 16383, 2), (256, 256, 128, 8000, 2),
]


def _fits(J, d, V, wb) -> bool:
    """Some cluster size holds one session's rows and its slices."""
    up = lambda n, m: -(-n // m) * m  # noqa: E731
    for C in DK.CLUSTER_SIZES:
        Vc, Jc = up(up(V, C) // C, 8), up(up(J, C) // C, 4)
        for dp in (True, False):
            if (dp or (d % DK.RING_ROWS == 0 and C * Jc == J and Jc * wb % 16 == 0
                       and Jc <= 256)) and max(Vc, Jc) <= DK.CLUSTER_NT and \
                    DK.dj_smem(1, J, d, Vc, Jc, C, wb, dp) <= DK.SMEM_PER_BLOCK:
                return True
    return False


@pytest.mark.parametrize("S, J, d, V, wb", SHAPES)
def test_dj_plan_covers_every_column_once(S, J, d, V, wb):
    plan = DK.dj_plan(S, J, d, V, wb, h100_clusters)
    assert (plan is None) == (not _fits(J, d, V, wb))
    assert DK.dj_route(S, J, d, V, wb) == ("simt" if plan is None else "cluster")
    if plan is None:
        return
    for n, sl in ((V, plan.v_slice), (J, plan.j_slice)):
        seen = np.zeros(n, np.int32)
        for r in range(plan.C):
            seen[sl(r).start:sl(r).stop] += 1
        assert (seen == 1).all()
    rows = np.zeros(S, np.int32)
    for i in range(plan.clusters):
        rows[plan.tile(i).start:plan.tile(i).stop] += 1
    assert (rows == 1).all() and len(plan.tile(plan.clusters - 1)) > 0
    assert plan.Vc % 8 == 0 and plan.Jc % 4 == 0
    # one item a thread in the refresh and in the joiner
    assert -(-plan.TS // DK.CLUSTER_GS) * max(plan.Vc, plan.Jc) <= DK.CLUSTER_NT
    assert plan.dp_smem or (d % DK.RING_ROWS == 0 and plan.C * plan.Jc == J)
    assert plan.smem == DK.dj_smem(plan.TS, J, d, plan.Vc, plan.Jc, plan.C, wb,
                                   plan.dp_smem) <= DK.SMEM_PER_BLOCK
    mc = h100_clusters(plan.C, plan.smem, plan.dp_smem)
    assert plan.max_clusters == mc
    if plan.waves == 1:
        assert plan.clusters <= mc
    # the tile is the smallest for its waves
    assert -(-S // (plan.TS - 1)) > plan.waves * mc if plan.TS > 1 else True


def test_dj_plan_at_the_flagship():
    """S = 256 at flagship widths: clusters of 8, tiles of 18 sessions, 15
    clusters in one wave; bf16 keeps both slices resident (64 + 64 KB), f32
    keeps W's (128 KB) and streams dec_proj's. S = 2048 takes 5 waves of
    tiles of 28 (74 clusters); S = 1 and 3 one session a cluster."""
    for wb, dp in ((2, True), (4, False)):
        p = DK.dj_plan(256, 512, 512, 500, wb, h100_clusters)
        assert (p.C, p.TS, p.clusters, p.waves, p.Vc, p.Jc, p.dp_smem) == (8, 18, 15, 1, 64, 64, dp)
        assert p.v_slice(7) == range(448, 500)
        p = DK.dj_plan(2048, 512, 512, 500, wb, h100_clusters)
        assert (p.C, p.TS, p.clusters, p.waves) == (8, 28, 74, 5)
        for S in (1, 3):
            p = DK.dj_plan(S, 512, 512, 500, wb, h100_clusters)
            assert (p.C, p.TS, p.clusters) == (8, 1, S)
    # every cluster loads its slices in every call
    p = DK.dj_plan(256, 512, 512, 500, 2, h100_clusters)
    assert DK.dj_staged_bytes(p, 512, 512, 2) == 120 * (64 * 516 * 2) * 2


@pytest.mark.parametrize("S, J, d, V, wb, route", [
    (256, 512, 512, 500, 2, "cluster"),     # the flagship flush, int8 and bf16 serving
    (256, 512, 512, 500, 4, "cluster"),     # f32
    (3, 512, 512, 500, 4, "cluster"),
    (8, 128, 128, 64, 4, "cluster"),        # chip_smoke's reference model
    (8, 128, 128, 16383, 4, "simt"),        # vocab narrow: W's slice alone exceeds a block
    (256, 512, 520, 500, 2, "simt"),        # d not a multiple of 16
])
def test_dj_route_by_shape(S, J, d, V, wb, route):
    assert DK.dj_route(S, J, d, V, wb) == route
    assert DK.dj_route(S, J, d, V, wb, h100_clusters) == route


def test_dj_plan_refuses_where_the_card_places_nothing():
    with pytest.raises(ValueError, match="kernel 8.*places no cluster"):
        DK.dj_plan(256, 512, 512, 500, 2, lambda C, smem, dp: 0)
    assert DK.dj_plan(256, 128, 128, 16383, 4, lambda C, smem, dp: 0) is None


def _key(v: np.ndarray, i: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit argmax key (csrc/dec_joiner_cluster.cu
    `argmax_key`): the float's order-preserving bits above the inverted
    column index."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    ord_ = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return (ord_ << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.asarray(i, np.uint64))


def _key_argmax(logits: torch.Tensor, blank: int, plan):
    """Each block's largest key over its columns (the blank's logit at
    -1e30), merged in rank order by the blocks that hold columns; then
    (max_idx, max_val) as the kernel decodes the key, and the blank's raw
    logit."""
    lg = logits.numpy()
    S = lg.shape[0]
    best = np.zeros(S, np.uint64)
    for r in range(plan.C):
        vs = plan.v_slice(r)
        if len(vs) == 0:
            continue
        cols = np.arange(vs.start, vs.stop)
        masked = np.where(cols[None, :] == blank, np.float32(NEG_INF), lg[:, vs.start:vs.stop])
        part = _key(masked, np.broadcast_to(cols, masked.shape)).max(axis=1)
        best = np.maximum(best, part)
    mi = (np.uint64(0xFFFFFFFF) - (best & np.uint64(0xFFFFFFFF))).astype(np.int32)
    o = (best >> np.uint64(32)).astype(np.uint32)
    bits = np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o)
    mv = bits.astype(np.uint32).view(np.float32)
    return torch.from_numpy(mi), torch.from_numpy(mv.copy()), logits[:, blank]


def _emulate(plan, ctx, nd, dout, eout, dec_table, dp, dpb, w, b, blank):
    """The cluster kernel's launch in torch: per tile of TS sessions, the
    rows whose need_dec is set get each block's Jc columns of the new dout
    blended as dec_refresh blends them (n new + (1 - n) dout, n = 1), the
    other rows keep dout; then a = wd(tanh(eout + dout')), the joiner on
    each block's Vc columns and the keys' merge (`_key_argmax`). The new
    dout's products are taken as the plain version takes them (one product
    over every row: the CPU's sums of a sub-product can differ in their last
    bit), so the emulation holds which rows and columns each block writes,
    and how; the card's sum order is held against dec_joiner_simt's on the
    card."""
    c = ctx.long()
    new = dot_wd(torch.relu(dec_table[0][c[:, 0]] + dec_table[1][c[:, 1]]), dp) + dpb
    out = [[], [], [], []]
    for i in range(plan.clusters):
        rows = plan.tile(i)
        tile = slice(rows.start, rows.stop)
        ref = torch.tensor([s for s in rows if bool(nd[s])], dtype=torch.long)
        d2 = dout[tile].clone()
        if len(ref):
            n = nd[ref].float()[:, None]
            for r in range(plan.C):
                js = slice(plan.j_slice(r).start, plan.j_slice(r).stop)
                d2[ref - rows.start, js] = n * new[ref, js] + (1.0 - n) * dout[ref, js]
        a = torch.tanh(eout[tile] + d2)
        logits = torch.cat([dot_wd(a, w[:, vs.start:vs.stop]) + b[vs.start:vs.stop]
                            for vs in map(plan.v_slice, range(plan.C)) if len(vs)], dim=1)
        for k, t in enumerate((*_key_argmax(logits, blank, plan), d2)):
            out[k].append(t)
    return tuple(torch.cat(t) for t in out)


@pytest.mark.parametrize("prec, C", [("bf16", 8), ("f32", 8), ("bf16", 2), ("f32", 4)])
def test_cluster_emulation_matches_plain_and_jax_interpret(prec, C):
    """S = 8 at J = d = 128, V = 500, tiles of 3 sessions (3 clusters, the
    last of 2); at C = 8 the V slices are 64 columns, the last 52."""
    S, blank = 8, 0
    jp, tp = _params(prec)
    rng = np.random.default_rng(11 + C)
    V = DIMS.vocab
    eout = (rng.normal(size=(S, DIMS.joiner_dim)) * 2.0).astype(np.float32)
    dout = rng.normal(size=(S, DIMS.joiner_dim)).astype(np.float32)
    ctx = rng.integers(0, V, size=(S, 2)).astype(np.int32)
    need_dec = rng.random(S) < 0.5
    need_dec[:2] = (True, False)
    wb = tp["join_t"].element_size()
    plan = DK.dj_plan(S, DIMS.joiner_dim, DIMS.d_model, V, wb,
                      lambda c, smem, dp: 3 if c == C else 0)
    assert (plan.C, plan.TS, plan.clusters) == (C, 3, 3)
    args = (torch.from_numpy(ctx), torch.from_numpy(need_dec), torch.from_numpy(dout),
            torch.from_numpy(eout), tp["dec_table"], tp["dec_proj_t"], tp["dec_proj_b"],
            tp["join_t"], tp["join_b"])
    got = _emulate(plan, *args, blank)
    want = decoder_joiner_argmax_plain(*args, blank)
    jax_out = JJP.decoder_joiner_argmax_fused(
        jnp.asarray(ctx), jnp.asarray(need_dec), jnp.asarray(dout), jnp.asarray(eout),
        jp["dec_table"], jp["dec_proj_t"], jp["dec_proj_b"], jp["join_t"], jp["join_b"],
        blank_id=blank, block_s=S, interpret=True)
    assert torch.equal(got[3], want[3])  # dout', bit for bit
    np.testing.assert_array_equal(got[3].numpy()[~need_dec], dout[~need_dec])
    logits = dot_wd(torch.tanh(args[3] + want[3]), tp["join_t"]) + tp["join_b"]
    logits[:, blank] = -float("inf")
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert bool(clear.all())
    jtol = 1e-5 if prec == "f32" else 1e-3
    np.testing.assert_array_equal(got[0].numpy()[clear], want[0].numpy()[clear])
    np.testing.assert_array_equal(got[0].numpy()[clear], np.asarray(jax_out[0])[clear])
    for k in (1, 2):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jax_out[k]), atol=jtol, rtol=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(jax_out[3]), atol=jtol, rtol=0)


@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("blank", [0, 64, 100, 127, 448, 499])
def test_key_merge_gives_the_plain_argmax(C, blank):
    """V = 500: at C = 8 slices of 64 columns (the last 448-499), at C = 2
    of 256. Random logits, then constructed rows: equal maxima in two
    slices (the lower index wins), at a slice's last and the next one's
    first column, inside one slice, the blank's logit the largest, every
    column equal, the largest at a slice's first column."""
    V = 500
    plan = DK.dj_plan(16, 128, 128, V, 2, lambda c, smem, dp: 16 if c == C else 0)
    assert plan.C == C
    k = plan.Vc
    rng = np.random.default_rng(C + blank)
    lg = torch.from_numpy(rng.normal(size=(9, V)).astype(np.float32))
    top = float(lg.abs().max()) + 1.0
    other = lambda i: i if i != blank else i + 1  # noqa: E731
    lg[0, [other(1), other(k + 1)]] = top       # two slices tie: the lower index
    lg[1, [other(k - 1), other(k)]] = top       # a slice's last and the next one's first
    lg[2, [other(k + 3), other(V - 2)]] = top       # a later slice and the last one
    lg[3, [other(5), other(6)]] = top            # a tie inside one slice
    lg[4, blank] = top + 1.0                     # the blank's logit is excluded
    lg[5, :] = -1.0                              # every column equal
    lg[6, other(min(k, V - 1))] = top            # a slice's first column
    lg[7, other(V - 1) if V - 1 != blank else V - 2] = top  # the last column
    want = torch.where(torch.arange(V)[None, :] == blank, torch.tensor(NEG_INF), lg)
    gi, gv, gb = _key_argmax(lg, blank, plan)
    assert torch.equal(gi, want.argmax(dim=1).to(torch.int32))
    assert torch.equal(gv, want.amax(dim=1)) and torch.equal(gb, lg[:, blank])
