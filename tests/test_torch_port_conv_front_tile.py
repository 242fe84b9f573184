"""Port: kernel 17 on the H100 (csrc/conv_embed_tile.cu `conv_front_kernel`,
planned by ops/conv_embed_kernels.py `conv_embed_plan` with `front`).

The kernel runs only on the card, where chip_smoke.py holds it bit for bit
to the CUDA-core kernel it displaces (`conv_embed_front_simt`,
csrc/conv_embed.cu with `from_front`) and by `_embed_close` to its plain
version. Here, on the CPU:

(a) the `front` plan at S in {1, 3, 8, 256, 2048}, the P of the 200 ms and 1
    s chunks (7, 27), seg 7 and 9, at the conv widths CT_C1 (the flagship's
    (8, 32, 32), d 512, and (4, 16, 24), d 66 and 68): within the H100's
    232,448 bytes a block, its staged bytes counting the rows above and
    below a window, groups covering every window once and projection tiles
    covering every output; where kernel 16 has no plan, neither has kernel
    17, so both take their CUDA-core kernels;
(c) a plain-torch emulation of the kernel's two launches
    (test_torch_port_conv_embed_tile.py `emulate_tile` with `from_front`:
    each window's R1 + 2 rows from the one above it, conv1's nine taps, + b1,
    a window's top row less its dt = 0 taps' chain and, at seg 7, its row
    seg - 1 less its dt = 2 taps'; then kernel 16's conv2, conv3 and
    projection) equals, bit for bit, an emulation of csrc/conv_embed.cu's
    from-front order written from the plain version's weight forms (conv1
    once per buffer row of the whole front, the corrections of each
    window's edge rows), on the plan's groups and on groups of 3 windows,
    at seg 9 and 7; both lie within test_torch_port_front.py's bound (at
    most 1% of elements beyond 1e-4, none beyond 2e-2) of JAX
    `conv_embed_from_front` run with interpret=True;
(e) the staged halo: zero above the front's first row and below its last,
    and a window's rows its own session's where a group spans sessions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops import conv_embed_pallas as JCE
from april_asr_tpu_torch.ops import conv_embed_kernels as CE
from april_asr_tpu_torch.ops import cuda_build
from april_asr_tpu_torch.models import lstm_transducer as TM
from test_torch_port_conv_embed_tile import (MEL, R1, STEP, _bf, _dswish, _items, _widths,
                                             emulate_tile, simt_tail, stage_windows)
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

SEGS = (9, 7)


def _params(conv, d, seed=3):
    """The embed's weights from the port's numpy-seeded init, the conv and
    projection weights bf16 as bf16 serving holds them (JAX `cast_weights`
    casts the same keys): (JAX dict, torch dict)."""
    dims = TM.TransducerDims(d_model=d, hidden=64, ffn=64, joiner_dim=64, vocab=64, layers=1,
                             decoder_groups=16 if d % 16 == 0 else 1, conv_channels=conv)
    p = TM.init_transducer_params(seed, dims)
    tp = {k: p[k].to(torch.bfloat16) if k in CE.EMBED_KEYS else p[k]
          for k in CE.EMBED_KEYS + CE._BIAS_KEYS}
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16 if k in CE.EMBED_KEYS
                                                    else jnp.float32)
          for k, v in tp.items()}
    return jp, tp


# -- (a) the plan --------------------------------------------------------------------


@pytest.mark.parametrize("S", (1, 3, 8, 256, 2048))
@pytest.mark.parametrize("P", (7, 27))
@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("c1,c2,c3,d", [(8, 32, 32, 512), (4, 16, 24, 66), (4, 16, 24, 68)])
def test_front_plan_covers_and_fits(S, P, seg, c1, c2, c3, d):
    plan = CE.conv_embed_plan(S, P, MEL, seg, c1, c2, c3, d, front=True)
    assert plan is not None
    assert plan.smem == CE.conv_embed_smem(plan.nw, MEL, seg, c1, c2, c3, front=True)
    assert plan.smem <= cuda_build.SMEM_PER_BLOCK
    # the staged rows: a window's rows from the one above it to the one
    # below its conv1 row R1 - 1, which at seg 7 lies past the window
    assert CE.staged_rows(seg, True) == R1 + 2
    assert CE.staged_rows(seg, False) == seg
    M = P * S
    assert plan.groups == -(-M // plan.nw) and plan.blocks == min(plan.groups, cuda_build.SM_COUNT)
    sizes = [min(plan.nw, M - g * plan.nw) for g in range(plan.groups)]
    assert sum(sizes) == M and min(sizes) >= 1
    walked = sorted(g for b in range(plan.blocks) for g in range(b, plan.groups, plan.blocks))
    assert walked == list(range(plan.groups))
    f2, f3 = CE.conv_tile_dims(MEL, c2)[:2]
    for nw in sorted({plan.nw, sizes[-1]}):
        for n_pos, n_cg, pp in ((nw * CE.CT_R2 * f2, c2 // 8, CE.CT_PP2),
                                (nw * f3, c3 // 8, CE.CT_PP3)):
            got = _items(n_pos, n_cg, pp)
            assert len(got) == len(set(got)) == n_pos * n_cg
    assert plan.mtiles * CE.PJ_BM >= M > (plan.mtiles - 1) * CE.PJ_BM
    assert plan.cols == plan.ntiles * CE.PJ_BN >= d > plan.cols - CE.PJ_BN


def test_front_plan_at_the_engine_shapes():
    # the flagship at S = 256 and 2048 of 1 s: groups of 9, as kernel 16's;
    # a window's 9 staged rows of 82 floats (2,952 bytes) share their region
    # with conv2's output, whose window stride (9,616 bytes) sets its size
    for S in (256, 2048):
        for seg in SEGS:
            assert CE.conv_embed_plan(S, 27, 80, seg, 8, 32, 32, 512, front=True) == \
                CE.conv_embed_plan(S, 27, 80, 9, 8, 32, 32, 512)
    assert CE.staged_rows(7, True) * 82 * 4 == 2952 < 2 * CE.conv_tile_dims(80, 32)[5] == 9616


def test_front_route_refuses_what_the_kernel_cannot_take():
    for c1 in (2, 16):
        assert CE.conv_embed_plan(256, 27, 80, 9, c1, 32, 32, 512, front=True) is None
    assert CE.conv_embed_plan(8, 27, 1000, 9, 8, 32, 32, 512, front=True) is None
    _, tp = _params((4, 12, 20), 67)
    assert CE.embed_plan_for(tp, 8, 27, MEL, 7, front=True) == \
        CE.conv_embed_plan(8, 27, MEL, 7, 4, 16, 24, 68, front=True)
    wide = dict(tp, conv1_w=tp["conv1_w"].repeat(4, 1, 1, 1), conv1_b=tp["conv1_b"].repeat(4),
                conv2_w=tp["conv2_w"].repeat(1, 4, 1, 1))
    assert CE.embed_plan_for(wide, 8, 27, MEL, 9, front=True) is None  # conv_embed_front_simt


# -- (c) the kernel's order, emulated ----------------------------------------------


def emulate_front_simt(w: dict, front: torch.Tensor, P: int, step: int, seg: int,
                       correct: bool = True) -> torch.Tensor:
    """csrc/conv_embed.cu's from-front order from the plain version's weight
    forms: conv1 once per buffer row of the whole front over all nine taps
    ((dt, df) in order, rows -1 and W zero), + b1; a window's top row less
    the chain of its dt = 0 taps, at seg 7 its row seg - 1 less the chain
    of its dt = 2 taps (without `correct`, the leaked taps kept); each
    DoubleSwish and bf16 rounded; then conv2, conv3 and the projection
    (`simt_tail`). [P, S, dp]."""
    S, W, mel = front.shape
    c1 = _widths(w)[0]
    x = torch.nn.functional.pad(_bf(front), (1, 1, 1, 1))  # [S, W + 2, mel + 2]
    w1 = w["w1"]

    def chain(rows, dts):
        acc = torch.zeros(S, len(rows), mel, c1)
        for dt in dts:
            for df in range(3):
                acc = acc + x[:, [r + dt for r in rows], df:df + mel, None] * w1[:, dt * 3 + df]
        return acc

    acc = chain(list(range(W)), range(3)) + w["b1"]  # [S, W, mel, c1]
    a1 = torch.empty(P, S, R1, mel, c1)
    for j in range(P):
        r0 = j * step
        a1[j] = _bf(_dswish(acc[:, r0:r0 + R1]))
        if not correct:
            continue
        a1[j, :, 0] = _bf(_dswish(acc[:, r0] - chain([r0], (0,))[:, 0]))
        if seg - 1 < R1:
            rb = r0 + seg - 1
            a1[j, :, seg - 1] = _bf(_dswish(acc[:, rb] - chain([rb], (2,))[:, 0]))
    return simt_tail(w, a1)


@pytest.mark.parametrize("conv,d,seg", [((4, 8, 16), 64, 9), ((8, 32, 32), 64, 7)])
def test_emulation_equals_simt_order_and_matches_jax_interpret(conv, d, seg):
    S, P = 3, 5
    jp, tp = _params(conv, d)
    W = (P - 1) * STEP + seg
    front = np.random.default_rng(S * 100 + P + seg).normal(size=(S, W, MEL)).astype(np.float32)
    tf = torch.from_numpy(front)
    w = CE.embed_weight_forms(tp)
    plan = CE.embed_plan_for(tp, S, P, MEL, seg, front=True)
    assert plan is not None
    simt = emulate_front_simt(w, tf, P, STEP, seg)
    for nw in sorted({plan.nw, 3, 4}):  # the plan's groups; groups of 3, 4 (the last ragged)
        got = emulate_tile(w, tf, P, STEP, seg, nw, from_front=True)
        assert torch.equal(got, simt), (nw, float((got - simt).abs().max()))
    # the corrections are no no-op: the leaked rows' taps move the windows
    leaked = emulate_front_simt(w, tf, P, STEP, seg, correct=False)
    assert float((leaked - simt).abs().max()) > 1e-3
    want = np.asarray(JCE.conv_embed_from_front(jp, jnp.asarray(front), P=P, step=STEP, seg=seg,
                                                block_s=S, interpret=True))
    assert want.shape == (P, S, d)
    for name, v in (("emulation", simt[..., :d].numpy()),
                    ("plain", CE.conv_embed_from_front(tp, tf, P=P, step=STEP, seg=seg).numpy())):
        diff = np.abs(v - want)
        assert float((diff > 1e-4).mean()) <= 0.01, f"{name}: {(diff > 1e-4).mean():.4f}"
        assert float(diff.max()) <= 2e-2, f"{name}: max {diff.max():.4g}"
    assert not simt[..., d:].any()


@pytest.mark.parametrize("seed,S", [(3, 1), (4, 1), (5, 3)])
def test_seg7_few_windows_within_the_flip_bound(seed, S):
    """chip_smoke holds kernel 17 at seg 7 on runs of fewer than 256 windows
    to `_embed_close`'s flip bound alone: a window statistic (the mean, the
    clean share) on 7-21 windows moves with one flipped rounding. Here, at
    the flagship's conv widths, P = 7 and a front of N(-6, 2) as chip_smoke
    makes it, the kernel's bits (the emulation) and JAX's
    `conv_embed_from_front` run with interpret=True each lie within that
    bound of the plain version; at seed 5, S = 3 JAX's own output parts
    from it by a mean past 2e-4 (printed with -s)."""
    import chip_smoke as CS

    P, seg = 7, 7
    jp, tp = _params((8, 32, 32), 512, seed=seed)
    W = (P - 1) * STEP + seg
    front = (np.random.default_rng(seed * 10 + S).normal(size=(S, W, MEL)) * 2.0 - 6.0
             ).astype(np.float32)
    tf = torch.from_numpy(front)
    plain = CE.conv_embed_plain(tp, tf, P, STEP, seg)
    flip = CS.embed_flip_bound(tp, CS.embed_amax(tp, tf, P, STEP, seg))
    emu = emulate_front_simt(CE.embed_weight_forms(tp), tf, P, STEP, seg)[..., :512]
    jx = torch.from_numpy(np.array(JCE.conv_embed_from_front(
        jp, jnp.asarray(front), P=P, step=STEP, seg=seg, block_s=S, interpret=True)))
    for name, got in (("kernel 17's bits (emulation)", emu), ("JAX interpret", jx)):
        err, stats = CS._embed_close(got, plain, name, flip, window_stats=False)
        print(f"seed {seed} S={S} P={P} seg 7: {name} against the plain version: max {err:.3g} "
              f"({stats})")


# -- (e) the halo --------------------------------------------------------------------


@pytest.mark.parametrize("seg", SEGS)
def test_staged_halo_is_zero_at_the_edges_and_its_own_sessions(seg):
    S, P = 3, 5
    W = (P - 1) * STEP + seg
    # every row of every session distinct (and bf16-exact): 32 s + row + 1
    front = (32.0 * torch.arange(S)[:, None, None] + torch.arange(W)[None, :, None] + 1.0
             ).expand(S, W, MEL).contiguous()
    M, nw = P * S, 4  # groups of 4 windows, sessions fastest: every group spans sessions
    for m0 in range(0, M, nw):
        n = min(nw, M - m0)
        xw = stage_windows(front, m0, n, STEP, seg, from_front=True)
        assert xw.shape == (n, R1 + 2, MEL + 2)
        assert not xw[:, :, 0].any() and not xw[:, :, -1].any()  # the zero columns
        for jl in range(n):
            j, s = divmod(m0 + jl, S)
            for r in range(R1 + 2):
                br = j * STEP + r - 1
                want = 32.0 * s + br + 1.0 if 0 <= br < W else 0.0
                assert bool((xw[jl, r, 1:-1] == want).all()), (m0, jl, r)
            if j == 0:
                assert not xw[jl, 0].any()  # above the front's first row
            if j == P - 1 and seg == 7:
                assert not xw[jl, -1].any()  # below its last row
