"""Port: kernel 4 on thread-block clusters (csrc/chunk_decode_cluster.cu,
planned by ops/decode_kernels.py `decode_plan`).

The kernel splits the joiner's V columns and dec_proj's J columns over the
C blocks of a cluster, each cluster a tile of sessions; it runs only on the
card, where chip_smoke.py holds it bit for bit to the CUDA-core kernel it
replaced (`chunk_decode_simt`). Here, on the CPU:

* the plan covers every V and J column and every session exactly once,
  within the H100's 232,448 bytes a block (the C layout's bytes), with its
  clusters in one wave of the card's count wherever it claims one, and is
  None exactly where no block holds a slice;
* the blocks' partial argmaxes (blank masked to -1e30, largest, lowest index
  on ties) merged in rank order give `decoder_joiner_argmax_plain`'s
  (max_idx, max_val, blank_val) exactly, ties across slices included;
* a torch emulation of the launch (per tile and round: the sliced refresh,
  the sliced joiner, the merge, the heuristics) gives the JAX
  `chunk_decode_fused`'s events and integer state in interpret mode, at the
  tolerances of test_torch_port_decode.py;
* the step's decode route by shape: every model keeps its route or gains
  kernel 4, none takes kernel 4 where the JAX gate refuses, and a CUDA
  engine whose card places no cluster is refused when it is built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.io.params import build_vocab_tables as j_build_vocab_tables
from april_asr_tpu.decode.greedy import vocab_tables_device as j_vocab_tables
from april_asr_tpu.engine.step import INNER_STEPS_EMIT
from april_asr_tpu.models.export import make_model_parameters
from april_asr_tpu.ops.decode_pallas import chunk_decode_fused
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.api.model import apply_precision
from april_asr_tpu_torch.config import DecodeConfig
from april_asr_tpu_torch.decode import greedy
from april_asr_tpu_torch.decode.greedy import vocab_tables_device
from april_asr_tpu_torch.engine import step as ES
from april_asr_tpu_torch.io.params import build_vocab_tables
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.models.export import make_model_parameters as t_mmp
from april_asr_tpu_torch.models.loader import native_runtime
from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
from april_asr_tpu_torch.ops import decode_kernels as DK
from april_asr_tpu_torch.ops.activations import dot_wd
from april_asr_tpu_torch.ops.joiner_kernels import NEG_INF, decoder_joiner_argmax_plain
from test_torch_port_decode import DIMS, INT_STATE, STRIDE, _setup
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

T = DecodeConfig().max_active_tokens
INT_MAX = 0x7FFFFFFF


def h100_clusters(C: int, smem: int, dp_smem: bool) -> int:
    """The H100's cudaOccupancyMaxActiveClusters for 512-thread blocks, as
    measured on the card (NVIDIA H100 80GB HBM3): 132, 66, 30 and 15
    clusters of 1, 2, 4 and 8 blocks above 116 KB a block, more where two
    or more blocks share an SM."""
    per_sm = max(1, min(4, 232_448 // smem))
    return {1: 132, 2: 66, 4: 30, 8: 15}[C] * per_sm


# (S, J, d, V, weight bytes): the flagship at bf16 and f32 (chip_smoke's S
# = 3, 256, 2048 and a ragged 37), the CPU tests' d = J = 128 models (V =
# 40, 500 and 16,383, which the JAX gate passes), S = 8
SHAPES = [(S, 512, 512, 500, wb) for S in (3, 37, 256, 2048) for wb in (2, 4)] + [
    (128, 128, 128, 40, 2), (8, 128, 128, 40, 4), (256, 128, 128, 500, 2),
    (8, 128, 128, 16383, 2), (256, 128, 128, 16383, 4), (256, 256, 128, 8000, 2),
]


def _fits(J, d, V, wb) -> bool:
    """Some cluster size holds one session's rows and its slices."""
    up = lambda n, m: -(-n // m) * m  # noqa: E731
    for C in DK.CLUSTER_SIZES:
        Vc, Jc = up(up(V, C) // C, 8), up(up(J, C) // C, 4)
        for dp in (True, False):
            if (dp or (d % DK.RING_ROWS == 0 and C * Jc == J and Jc * wb % 16 == 0
                       and Jc <= 256)) and \
                    DK.cluster_smem(1, J, d, V, Vc, Jc, T, C, wb, dp) <= DK.SMEM_PER_BLOCK:
                return True
    return False


@pytest.mark.parametrize("S, J, d, V, wb", SHAPES)
def test_plan_covers_every_column_once(S, J, d, V, wb):
    plan = DK.decode_plan(S, J, d, V, T, wb, h100_clusters)
    assert (plan is None) == (not _fits(J, d, V, wb))
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
    assert plan.dp_smem or (d % DK.RING_ROWS == 0
                            and -(-plan.TS // DK.CLUSTER_GS) * plan.Jc <= DK.CLUSTER_NT)
    assert plan.smem == DK.cluster_smem(plan.TS, J, d, V, plan.Vc, plan.Jc, T, plan.C, wb,
                                        plan.dp_smem) <= DK.SMEM_PER_BLOCK
    mc = h100_clusters(plan.C, plan.smem, plan.dp_smem)
    assert plan.max_clusters == mc
    if plan.waves == 1:
        assert plan.clusters <= mc
    # the tile is the smallest for its waves
    assert -(-S // (plan.TS - 1)) > plan.waves * mc if plan.TS > 1 else True


def test_plan_at_the_flagship():
    """S = 256 at flagship widths: clusters of 8, tiles of 18 sessions, 15
    clusters in one wave; bf16 keeps both slices resident (64 + 64 KB), f32
    keeps W's (128 KB) and streams dec_proj's. S = 2048 takes 6 waves of
    tiles of 23 (90 clusters)."""
    for wb, dp in ((2, True), (4, False)):
        p = DK.decode_plan(256, 512, 512, 500, T, wb, h100_clusters)
        assert (p.C, p.TS, p.clusters, p.waves, p.Vc, p.Jc, p.dp_smem) == (8, 18, 15, 1, 64, 64, dp)
        assert p.v_slice(7) == range(448, 500)
        p = DK.decode_plan(2048, 512, 512, 500, T, wb, h100_clusters)
        assert (p.C, p.TS, p.clusters, p.waves) == (8, 23, 90, 6)
    p = DK.decode_plan(3, 512, 512, 500, T, 2, h100_clusters)
    assert (p.C, p.TS, p.clusters) == (8, 1, 3)


def test_plan_refuses_where_the_card_places_nothing():
    with pytest.raises(ValueError, match="places no cluster"):
        DK.decode_plan(256, 512, 512, 500, T, 2, lambda C, smem, dp: 0)
    assert DK.decode_plan(256, 512, 512, 16383, T, 2, lambda C, smem, dp: 0) is None


def _sliced_argmax(logits: torch.Tensor, blank: int, plan: DK.DecodePlan):
    """The kernel's argmax: per block, its columns' largest logit (the
    blank's at -1e30) at its lowest index, (-inf, INT_MAX) for an empty
    slice; merged in rank order, a partial taken where larger, or equal at
    a lower index; the blank's raw logit from the block that holds it."""
    S = logits.shape[0]
    best = torch.full((S,), -float("inf"))
    bi = torch.full((S,), INT_MAX, dtype=torch.int64)
    bv = None
    for r in range(plan.C):
        vs = plan.v_slice(r)
        if len(vs) == 0:
            pv, pi = torch.full((S,), -float("inf")), torch.full((S,), INT_MAX, dtype=torch.int64)
        else:
            lg = logits[:, vs.start:vs.stop]
            cols = torch.arange(vs.start, vs.stop)
            masked = torch.where(cols[None, :] == blank, torch.tensor(NEG_INF), lg)
            pi = masked.argmax(dim=1)  # the first of equal maxima
            pv = masked.gather(1, pi[:, None])[:, 0]
            pi = pi + vs.start
            if vs.start <= blank < vs.stop:
                bv = lg[:, blank - vs.start]
        take = (pv > best) | ((pv == best) & (pi < bi))
        best, bi = torch.where(take, pv, best), torch.where(take, pi, bi)
    return bi.to(torch.int32), best, bv


def _plan(S, V, C, J=128, d=128, wb=2):
    """A plan of C-block clusters (the others unplaced) at these shapes."""
    p = DK.decode_plan(S, J, d, V, T, wb, lambda c, smem, dp: 3 if c == C else 0)
    assert p.C == C
    return p


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("V, blank", [(40, 0), (500, 0), (500, 63), (500, 64), (501, 500)])
def test_sliced_argmax_equals_the_plain_argmax(V, blank, C):
    """Random logits, then constructed rows: equal maxima in two slices (the
    lower index wins), equal maxima inside one slice, the blank at a slice's
    first and last column (V = 500 at C = 8: slices of 64, the last of 52;
    V = 501: a ragged last slice)."""
    S, J, d = 16, 128, 128
    rng = np.random.default_rng(V + C + blank)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ctx = torch.from_numpy(rng.integers(0, V, size=(S, 2)).astype(np.int32))
    dec_table = t(rng.normal(size=(2, V, d)) * 0.3)
    dp, dpb = t(rng.normal(size=(d, J)) / np.sqrt(d)).bfloat16(), t(rng.normal(size=J) * 0.1)
    w, b = t(rng.normal(size=(J, V)) / np.sqrt(J)).bfloat16(), t(rng.normal(size=V) * 0.1)
    eout, dout = t(rng.normal(size=(S, J)) * 2.0), t(rng.normal(size=(S, J)))
    nd = torch.from_numpy(rng.random(S) < 0.5)
    mi, mv, bv, dout2 = decoder_joiner_argmax_plain(ctx, nd, dout, eout, dec_table, dp, dpb, w, b,
                                                    blank)
    logits = dot_wd(torch.tanh(eout + dout2), w) + b
    plan = _plan(S, V, C)
    got = _sliced_argmax(logits, blank, plan)
    for g, want in zip(got, (mi, mv, bv)):
        assert torch.equal(g, want)
    # constructed rows, against the plain argmax's rule
    k = plan.Vc
    lg = torch.randn(6, V)
    top = float(lg.abs().max()) + 1.0
    last = V - 1 if V - 1 != blank else V - 2
    lg[0, [1, min(k + 1, last)]] = top                   # two slices tie: the lower index
    lg[1, [min(k + 3, last), last]] = top                 # a later slice's first and the last
    lg[2, [2, 3]] = top                                   # a tie inside one slice
    lg[3, blank] = top + 1.0                              # the blank's logit is excluded
    lg[4, :] = -1.0                                       # every column equal
    lg[5, min(k, last)] = top                             # a slice's first column
    want_idx = torch.where(torch.arange(V)[None, :] == blank, torch.tensor(NEG_INF), lg)
    gi, gv, gb = _sliced_argmax(lg, blank, plan)
    assert torch.equal(gi, want_idx.argmax(dim=1).to(torch.int32))
    assert torch.equal(gv, want_idx.amax(dim=1)) and torch.equal(gb, lg[:, blank])


def _emulate(plan, eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
             blank_id, stride_ms, emit_ramp, dcfg):
    """The cluster kernel's launch in torch: per tile of TS sessions and per
    pull and round, each block's Jc columns of the refreshed dout, the joiner
    on each block's Vc columns, the merged argmax (`_sliced_argmax`) and the
    heuristics (`decode_step_pre`) on the tile."""
    P = eouts.shape[0]
    states, events = [], []
    for i in range(plan.clusters):
        rows = slice(plan.tile(i).start, plan.tile(i).stop)
        st = {k: v[rows] for k, v in dstate.items()}
        per_pull = []
        for p in range(P):
            can_p = can[p, rows]
            st["time_ms"] = (st["time_ms"] + stride_ms * can_p.to(torch.int32)).to(torch.int32)
            done = ~can_p
            rounds = []
            for ee in emit_ramp:
                ctx, nd = st["context"].long(), st["need_dec"]
                h = torch.relu(dec_table[0][ctx[:, 0]] + dec_table[1][ctx[:, 1]])
                dout = st["dout"].clone()
                for r in range(plan.C):
                    js = slice(plan.j_slice(r).start, plan.j_slice(r).stop)
                    new = dot_wd(h, dec_proj_t[:, js]) + dec_proj_b[js]
                    dout[:, js] = torch.where(nd[:, None], new, dout[:, js])
                a = torch.tanh(eouts[p, rows] + dout)
                logits = torch.cat([dot_wd(a, w_t[:, vs.start:vs.stop]) + b[vs.start:vs.stop]
                                    for vs in map(plan.v_slice, range(plan.C))], dim=1)
                mi, mv, bv = _sliced_argmax(logits, blank_id, plan)
                st["dout"] = dout
                st, evt, is_blank, need_dec = greedy.decode_step_pre(
                    st, mi, mv, bv, ~done, ee, blank_id, vt, dcfg)
                st["need_dec"] = need_dec
                done = done | is_blank
                rounds.append(evt)
            per_pull.append({k: torch.stack([e[k] for e in rounds], dim=1) for k in DK.EVENT_KEYS})
        states.append(st)
        events.append({k: torch.stack([e[k] for e in per_pull]) for k in DK.EVENT_KEYS})
    state = {k: torch.cat([s[k] for s in states]) for k in dstate}
    return state, {k: torch.cat([e[k] for e in events], dim=1) for k in DK.EVENT_KEYS}


@pytest.mark.parametrize("seed, bf16, C", [(0, True, 8), (0, False, 4), (3, True, 2)])
def test_cluster_emulation_matches_jax_interpret(seed, bf16, C):
    """The inputs of test_chunk_decode_matches_jax_interpret (S = 128, P =
    27, d = J = 128, V = 40), tiles of 43 sessions (3 clusters, the last
    ragged); at C = 8 the V slices are 8 columns and the last three blocks
    hold none."""
    P = 27
    p, mp, cfg, eouts, can, st = _setup(seed, P, bf16)
    tol = 1e-3 if bf16 else 1e-5
    cfg_key = (float(cfg.punctuation_margin), float(cfg.confident_margin),
               float(cfg.confident_logprob_penalty), float(cfg.long_silence_ms),
               float(cfg.silence_decay_ms), int(cfg.max_active_tokens))
    jvt = j_vocab_tables(j_build_vocab_tables(mp))
    want_state, want_ev = chunk_decode_fused(
        jnp.asarray(eouts), jnp.asarray(can), {k: jnp.asarray(v) for k, v in st.items()},
        p["dec_table"], p["dec_proj_t"], p["dec_proj_b"], p["join_t"], p["join_b"], jvt["mask"],
        blank_id=mp.blank_id, stride_ms=STRIDE, emit_ramp=INNER_STEPS_EMIT, cfg_key=cfg_key,
        block_s=128, interpret=True,
    )
    tp = from_jax_params({k: np.asarray(v) for k, v in p.items()})
    tvt = vocab_tables_device(build_vocab_tables(t_mmp(DIMS, default_tokens(DIMS.vocab))))
    plan = _plan(eouts.shape[1], DIMS.vocab, C, wb=2 if bf16 else 4)
    assert (plan.TS, plan.clusters) == (43, 3)
    got_state, got_ev = _emulate(
        plan, torch.from_numpy(eouts), torch.from_numpy(can),
        {k: torch.from_numpy(np.array(v)) for k, v in st.items()},
        tp["dec_table"], tp["dec_proj_t"], tp["dec_proj_b"], tp["join_t"], tp["join_b"], tvt,
        blank_id=mp.blank_id, stride_ms=STRIDE, emit_ramp=INNER_STEPS_EMIT, dcfg=DecodeConfig())
    assert int((np.asarray(want_ev["ops"]) != 0).sum()) > P * eouts.shape[1] // 4
    for k in ("ops", "tok", "flags", "time_ms", "final_k"):
        np.testing.assert_array_equal(got_ev[k].numpy(), np.asarray(want_ev[k]), err_msg=k)
    np.testing.assert_allclose(got_ev["logprob"].numpy(), np.asarray(want_ev["logprob"]),
                               atol=tol, rtol=tol)
    for k in INT_STATE:
        np.testing.assert_array_equal(got_state[k].numpy(), np.asarray(want_state[k]), err_msg=k)
    np.testing.assert_allclose(got_state["dout"].numpy(), np.asarray(want_state["dout"]),
                               atol=tol, rtol=tol)


# (S, J, d, V, weight bytes, the route before the cluster kernel, now): the
# shapes the port's tests and chip phases serve. Before it the step took
# kernel 4 ("chunk") where the JAX gate passed and its block fit.
ROUTES = [
    (256, 512, 512, 500, 2, "chunk", "cluster"),     # flagship, int8 and bf16 serving
    (256, 512, 512, 500, 4, "chunk", "cluster"),     # flagship, f32
    (3, 512, 512, 500, 2, "chunk", "cluster"),
    (2048, 512, 512, 500, 4, "chunk", "cluster"),
    (256, 512, 512, 16383, 2, None, None),           # the vocab cells: the JAX gate refuses
    (256, 512, 512, 16383, 4, None, None),
    (8, 128, 128, 16383, 4, None, None),             # vocab narrow: no block holds it
    (256, 128, 128, 8000, 2, "chunk", "simt"),       # the CUDA-core kernel's block only
    (128, 128, 128, 40, 2, "chunk", "cluster"),      # the CPU tests' model
    (8, 128, 128, 64, 4, "chunk", "cluster"),        # chip_smoke's reference model
    (8, 128, 68, 64, 4, None, None),                 # d = 68: the JAX gate refuses
    (8, 128, 66, 64, 2, None, None),                 # d = 66
]


@pytest.mark.parametrize("S, J, d, V, wb, before, now", ROUTES)
def test_decode_route_by_shape(S, J, d, V, wb, before, now):
    gate = DK.chunk_decode_supported(S, J, d, 2, V)
    assert before == ("chunk" if gate and DK.chunk_decode_block_fits(J, d, V, T) else None)
    assert DK.decode_route(S, J, d, V, T, wb, 2) == now
    assert DK.decode_route(S, J, d, V, T, wb, 2, h100_clusters) == now
    assert now is None or gate  # never kernel 4 where the JAX gate refuses
    assert (before is None) <= (now is None) or now == "cluster"  # kept, or gained kernel 4


def _runtime(precision):
    dims = TransducerDims(d_model=128, hidden=128, ffn=256, joiner_dim=128, vocab=64, layers=1,
                          decoder_groups=32, conv_channels=(4, 8, 8))
    p = init_transducer_params(0, dims)
    mp = make_model_parameters(dims, default_tokens(dims.vocab))
    return native_runtime("t", "", "en-us", mp, dims, apply_precision(p, precision), "cpu")


@pytest.mark.parametrize("precision", [None, "int8"])
def test_build_plans_kernel_4(precision):
    """A CUDA engine plans kernel 4 with the card's cluster occupancy: where
    the card places no cluster of its slices, the engine is refused when it
    is built, with the kernel and the shapes named."""
    rt = _runtime(precision)
    ES.check_kernel_plans(rt, 256, 27, n_sm=132, max_clusters=h100_clusters)
    with pytest.raises(ValueError, match=r"kernel 4 \(J=128, d=128, V=64, T=72"):
        ES.check_kernel_plans(rt, 256, 27, n_sm=132, max_clusters=lambda C, smem, dp: 0)
