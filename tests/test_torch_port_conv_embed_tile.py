"""Port: kernel 16 on the H100 (csrc/conv_embed_tile.cu, planned by
ops/conv_embed_kernels.py `conv_embed_plan`).

The kernel runs only on the card, where chip_smoke.py holds it bit for bit
to the CUDA-core kernel it displaces (`conv_embed_simt`, csrc/conv_embed.cu)
and by `_embed_close` to its plain version. Here, on the CPU:

(a) `conv_embed_plan` at S in {1, 3, 8, 256, 2048} and the P of the 200 ms
    and 1 s chunks (7, 27), at the flagship conv widths (8, 32, 32) and d
    512 and at the zero-padded widths of d 66 and 67 (conv channels (4, 12,
    20) padded to (4, 16, 24)): a plan within the H100's 232,448 bytes a
    block whose groups cover every window once, whose conv2 and conv3 warp
    items cover every output once, and whose projection tiles cover every
    output row and column; shapes it cannot take (conv1 widths of 2 or 16,
    a mel whose window no block holds) have no plan, so they take
    `conv_embed_simt`;
(b) a plain-torch emulation of the kernel's two launches, group by group
    and item by item on the kernel's layouts (the staged rows, conv1's and
    conv2's even / odd frequency planes at their pitches and window
    strides, y3t by 64-row tile, the projection's stages): a product of two
    bf16 values is exact in f32, so `acc + a * b` in f32 is the kernel's
    fmaf. Its outputs equal, bit for bit, an emulation of
    csrc/conv_embed.cu's order written from the plain version's weight
    forms, on the plan's groups and on groups of 3 windows (a ragged last
    group), and both lie within test_torch_port_front.py's bound (at most 1%
    of elements beyond 1e-4, none beyond 2e-2) of JAX `conv_embed_windows`
    run with interpret=True, at (S, P) = (4, 5) and (3, 5), with seeded
    numpy inputs;
(c) the step's route: at int8 and bf16 weights the step calls kernel 16,
    whose route for a CUDA front of those shapes is csrc/conv_embed_tile.cu
    (a plan); at f32 it calls no kernel 16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.ops import conv_embed_pallas as JCE
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import conv_embed_kernels as CE
from april_asr_tpu_torch.ops import cuda_build
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

BASE = JM.TransducerDims(d_model=64, hidden=64, ffn=64, joiner_dim=64, vocab=64, layers=1,
                         decoder_groups=16, conv_channels=(4, 8, 16))
# (conv channels, d_model): the front tests' widths, the flagship's conv
# widths, and conv widths and a d_model that the kernel takes zero-padded
WIDTHS = [((4, 8, 16), 64), ((8, 32, 32), 64), ((4, 12, 20), 67)]
SEG, STEP, MEL = BASE.segment_size, BASE.segment_step, BASE.mel
R1, R2 = CE.CT_R1, CE.CT_R2


def _params(conv, d, seed=3):
    dims = dataclasses.replace(BASE, conv_channels=conv, d_model=d,
                               decoder_groups=16 if d % 16 == 0 else 1)
    p = JM.cast_weights(JM.init_transducer_params(jax.random.PRNGKey(seed), dims), jnp.bfloat16)
    return p, from_jax_params({k: np.asarray(v) for k, v in p.items()})


# -- (a) the plan and the route ----------------------------------------------------


def _items(n_pos: int, n_cg: int, pp: int):
    """(cg, position) of every live lane of the kernel's warp items: item it
    is channel group it % n_cg of position block it // n_cg, lane l's q-th
    position (block pp + q) 32 + l."""
    n_blocks = -(-n_pos // (32 * pp))
    out = []
    for it in range(n_blocks * n_cg):
        cg, pb = it % n_cg, it // n_cg
        for q in range(pp):
            for lane in range(32):
                p = (pb * pp + q) * 32 + lane
                if p < n_pos:
                    out.append((cg, p))
    return out


@pytest.mark.parametrize("S", (1, 3, 8, 256, 2048))
@pytest.mark.parametrize("P", (7, 27))
@pytest.mark.parametrize("c1,c2,c3,d", [(8, 32, 32, 512), (4, 16, 24, 66), (4, 16, 24, 68)])
def test_conv_embed_plan_covers_and_fits(S, P, c1, c2, c3, d):
    plan = CE.conv_embed_plan(S, P, MEL, SEG, c1, c2, c3, d)
    assert plan is not None
    assert plan.smem == CE.conv_embed_smem(plan.nw, MEL, SEG, c1, c2, c3)
    assert plan.smem <= cuda_build.SMEM_PER_BLOCK
    assert CE.proj_smem() <= cuda_build.SMEM_PER_BLOCK
    M = P * S
    # the groups: every window once, each block a persistent walk over them
    assert plan.groups == -(-M // plan.nw) and plan.blocks == min(plan.groups, cuda_build.SM_COUNT)
    sizes = [min(plan.nw, M - g * plan.nw) for g in range(plan.groups)]
    assert sum(sizes) == M and min(sizes) >= 1
    walked = sorted(g for b in range(plan.blocks) for g in range(b, plan.groups, plan.blocks))
    assert walked == list(range(plan.groups))
    # conv2's and conv3's warp items: every (channel group, position) once,
    # in a full group and in the last one
    f2, f3 = CE.conv_tile_dims(MEL, c2)[:2]
    for nw in sorted({plan.nw, sizes[-1]}):
        for n_pos, n_cg, pp in ((nw * R2 * f2, c2 // 8, CE.CT_PP2), (nw * f3, c3 // 8, CE.CT_PP3)):
            got = _items(n_pos, n_cg, pp)
            assert len(got) == len(set(got)) == n_pos * n_cg
    # the projection's tiles: every output row and column, the weight's
    # columns padded to whole tiles
    assert plan.mtiles * CE.PJ_BM >= M > (plan.mtiles - 1) * CE.PJ_BM
    assert plan.cols == plan.ntiles * CE.PJ_BN >= d > plan.cols - CE.PJ_BN


def test_conv_embed_plan_at_the_engine_shapes():
    # S = 256 of 1 s: 768 groups of 9 windows over the 132 SMs (5.8
    # rounds); a group's conv2 is 36 warp items, 3 rounds of the 12 warps,
    # and its conv3 12 items, one round
    plan = CE.conv_embed_plan(256, 27, 80, 9, 8, 32, 32, 512)
    assert (plan.nw, plan.groups, plan.blocks) == (9, 768, 132)
    assert (plan.mtiles, plan.ntiles) == (54, 4)
    f2, f3 = CE.conv_tile_dims(80, 32)[:2]
    assert -(-9 * R2 * f2 // (32 * CE.CT_PP2)) * 4 == 3 * CE.CT_NT // 32
    assert -(-9 * f3 // (32 * CE.CT_PP3)) * 4 == CE.CT_NT // 32
    # S = 2048: groups of 9 too; a block would hold 10 (232,416 bytes), not 11
    plan = CE.conv_embed_plan(2048, 27, 80, 9, 8, 32, 32, 512)
    assert plan.nw == 9
    assert CE.conv_embed_smem(10, 80, 9, 8, 32, 32) == 232_416 <= cuda_build.SMEM_PER_BLOCK
    assert CE.conv_embed_smem(11, 80, 9, 8, 32, 32) > cuda_build.SMEM_PER_BLOCK


def test_conv_embed_route_refuses_what_the_kernel_cannot_take():
    # conv1 widths the kernel is not built for
    for c1 in (2, 16):
        assert CE.conv_embed_plan(256, 27, 80, 9, c1, 32, 32, 512) is None
    # a mel so wide that no block holds one window's intermediates
    assert CE.conv_embed_plan(8, 27, 1000, 9, 8, 32, 32, 512) is None
    # unpadded widths and geometries off the JAX gate
    assert CE.conv_embed_plan(8, 27, 80, 9, 4, 12, 24, 66) is None
    assert CE.conv_embed_plan(8, 27, 80, 9, 4, 16, 24, 67) is None
    assert CE.conv_embed_plan(8, 27, 80, 8, 4, 16, 24, 68) is None
    # the route reads the padded widths of the weight forms
    _, tp = _params((4, 12, 20), 67)
    assert CE.embed_plan_for(tp, 8, 27, MEL, SEG) == CE.conv_embed_plan(8, 27, MEL, SEG, 4, 16, 24, 68)
    wide = dict(tp, conv1_w=tp["conv1_w"].repeat(4, 1, 1, 1), conv1_b=tp["conv1_b"].repeat(4),
                conv2_w=tp["conv2_w"].repeat(1, 4, 1, 1))
    assert CE.embed_plan_for(wide, 8, 27, MEL, SEG) is None  # c1 = 16: conv_embed_simt


# -- (b) the kernel's order, emulated ----------------------------------------------


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dswish(x: torch.Tensor) -> torch.Tensor:
    """The kernels' DoubleSwish, each f32 step rounded: x * (0.5 tanh(0.5 (x
    - 1)) + 0.5)."""
    return x * (0.5 * torch.tanh(0.5 * (x - 1.0)) + 0.5)


def _widths(w: dict) -> tuple:
    return w["w1"].shape[0], w["w2k"].shape[1], w["w3k"].shape[1], w["wo"].shape[1]


def stage_windows(front: torch.Tensor, m0: int, nw: int, step: int, seg: int,
                  from_front: bool = False) -> torch.Tensor:
    """A group's staged rows [nw, rows, mel + 2] as csrc/conv_embed_tile.cu
    stages them: window m = j S + s is session s's rows from j step (kernel
    17: from j step - 1, `CE.staged_rows` of them, zero outside [0, W)),
    bf16-rounded, with a zero column each side."""
    S, W, mel = front.shape
    rows, r0 = CE.staged_rows(seg, from_front), -1 if from_front else 0
    xw = torch.zeros(nw, rows, mel + 2)
    for jl in range(nw):
        j, s = divmod(m0 + jl, S)
        for r in range(rows):
            br = j * step + r0 + r
            if 0 <= br < W:
                xw[jl, r, 1:mel + 1] = _bf(front[s, br])
    return xw


def emulate_tile(w: dict, front: torch.Tensor, P: int, step: int, seg: int, nw_max: int,
                 from_front: bool = False) -> torch.Tensor:
    """csrc/conv_embed_tile.cu on groups of `nw_max` windows, launch by
    launch: the conv stack group by group (phase by phase, conv2 and conv3
    warp item by warp item, each lane's positions and offsets as the kernel
    computes them, on flat buffers in the kernel's layouts), then the
    projection tile by tile, stage by stage. With `from_front`, kernel 17's
    conv stack (`conv_front_kernel`): its staged rows and conv1. [P, S, dp]."""
    S, W, mel = front.shape
    c1, c2, c3, dp = _widths(w)
    f2, f3, h1, h2, p2, ws2 = CE.conv_tile_dims(mel, c2)
    K, M, mp = f3 * c3, P * S, mel + 2
    xn, BM, BN, BK = CE.staged_rows(seg, from_front) * mp, CE.PJ_BM, CE.PJ_BN, CE.PJ_BK
    mtiles, cols = -(-M // BM), -(-dp // BN) * BN
    w1s = w["w1"].t().reshape(-1)  # [9][c1], as staged
    w2s, w3s = w["w2k"].float().reshape(-1), w["w3k"].float().reshape(-1)
    b1, b2, b3 = w["b1"], w["b2"], w["b3"]
    y3t = torch.full((mtiles * K * BM,), float("nan"))  # rows past M: never stored
    for grp in range(-(-M // nw_max)):
        m0 = grp * nw_max
        nw = min(nw_max, M - m0)
        # staging
        xw = stage_windows(front, m0, nw, step, seg, from_front).reshape(-1)
        # conv1: items (window, row, freq), their c1 channels
        i = torch.arange(nw * R1 * mel)
        jl, t, f = i // (R1 * mel), (i % (R1 * mel)) // mel, i % mel
        acc = torch.zeros(len(i), c1)
        tap = lambda dt, df: w1s[(dt * 3 + df) * c1: (dt * 3 + df + 1) * c1]  # noqa: E731
        if from_front:
            # all nine taps over staged rows t .. t + 2, + b1; a window's top
            # row less its dt = 0 taps' chain, at seg 7 its row seg - 1 less
            # its dt = 2 taps'
            for dt in range(3):
                for df in range(3):
                    acc = acc + xw[jl * xn + f + (t + dt) * mp + df][:, None] * tap(dt, df)
            acc = acc + b1
            for dt, rows in ((0, t == 0), (2, (t == seg - 1) & (seg - 1 < R1))):
                e = torch.zeros(len(i), c1)
                for df in range(3):
                    e = e + xw[jl * xn + f + (t + dt) * mp + df][:, None] * tap(dt, df)
                acc = torch.where(rows[:, None], acc - e, acc)
        else:
            for dt in range(3):
                wr = t + dt - 1
                live = ((wr >= 0) & (wr < seg))[:, None]
                for df in range(3):
                    x = xw[jl * xn + f + wr.clamp(0, seg - 1) * mp + df]
                    acc = torch.where(live, acc + x[:, None] * tap(dt, df), acc)
            acc = acc + b1
        a1 = torch.full((nw * R1 * 2 * h1 * c1,), float("nan"))
        dst = (((jl * R1 + t) * 2 + (f & 1)) * h1 + (f >> 1)) * c1
        a1[dst[:, None] + torch.arange(c1)] = _bf(_dswish(acc))
        # conv2: warp items (channel group, position block)
        y2 = torch.full((nw * ws2,), float("nan"))
        n_pos, n_cg, pp = nw * R2 * f2, c2 // 8, CE.CT_PP2
        for it in range(-(-n_pos // (32 * pp)) * n_cg):
            cg, pb = it % n_cg, it // n_cg
            p = (pb * pp + torch.arange(pp)[:, None]) * 32 + torch.arange(32)
            p = p.reshape(-1)
            ok = p < n_pos
            q = torch.where(ok, p, 0)
            jl, r, fo = q // (R2 * f2), (q % (R2 * f2)) // f2, q % f2
            aoff = ((jl * R1 + 2 * r) * 2 * h1 + fo) * c1
            yoff = jl * ws2 + ((r * 2 + (fo & 1)) * h2 + (fo >> 1)) * p2 + cg * 8
            acc = torch.zeros(len(p), 8)
            for tap in range(9):
                dt, df = divmod(tap, 3)
                toff = (dt * 2 * h1 + (df & 1) * h1 + (df >> 1)) * c1
                for ci in range(c1):
                    wv = w2s[(tap * c1 + ci) * c2 + cg * 8: (tap * c1 + ci) * c2 + cg * 8 + 8]
                    acc = acc + a1[aoff + toff + ci][:, None] * wv
            out = _bf(_dswish(acc + b2[cg * 8: cg * 8 + 8]))
            y2[(yoff[ok][:, None] + torch.arange(8)).reshape(-1)] = out[ok].reshape(-1)
        # conv3: warp items over (freq, window) positions, windows fastest
        n_pos, n_cg, pp, nc = nw * f3, c3 // 8, CE.CT_PP3, c2 // 8
        for it in range(-(-n_pos // (32 * pp)) * n_cg):
            cg, pb = it % n_cg, it // n_cg
            p = ((pb * pp + torch.arange(pp)[:, None]) * 32 + torch.arange(32)).reshape(-1)
            ok = p < n_pos
            q = torch.where(ok, p, 0)
            fo, jl = q // nw, q % nw
            m = m0 + jl
            yoff = jl * ws2 + fo * p2
            ooff = ((m // BM) * K + fo * c3 + cg * 8) * BM + m % BM
            acc = torch.zeros(len(p), 8)
            for kc in range(9 * nc):
                tap, cc = divmod(kc, nc)
                dt, df = divmod(tap, 3)
                toff = (dt * 2 * h2 + (df & 1) * h2 + (df >> 1)) * p2 + cc * 8
                for u in range(8):
                    wv = w3s[(kc * 8 + u) * c3 + cg * 8: (kc * 8 + u) * c3 + cg * 8 + 8]
                    acc = acc + y2[yoff + toff + u][:, None] * wv
            out = _bf(_dswish(acc + b3[cg * 8: cg * 8 + 8]))
            y3t[(ooff[ok][:, None] + torch.arange(8) * BM).reshape(-1)] = out[ok].reshape(-1)
    assert not torch.isnan(y3t.reshape(mtiles, K, BM).permute(0, 2, 1).reshape(-1, K)[:M]).any()
    # the projection: tiles of BM rows x BN columns, from bo over k in order
    wo = w["wo32"]
    assert wo.shape == (K, cols) and not wo[:, dp:].any()
    bo = torch.cat([w["bo"], torch.zeros(cols - dp)])
    out = torch.empty(mtiles * BM, cols)
    for mt in range(mtiles):
        for nt in range(cols // BN):
            acc = bo[nt * BN: (nt + 1) * BN].expand(BM, BN).clone()
            for st in range(K // BK):
                A = y3t[(mt * K + st * BK) * BM: (mt * K + st * BK + BK) * BM].reshape(BK, BM)
                B = wo[st * BK: st * BK + BK, nt * BN: (nt + 1) * BN]
                for kk in range(BK):
                    acc = acc + A[kk][:, None] * B[kk]
            out[mt * BM: (mt + 1) * BM, nt * BN: (nt + 1) * BN] = acc
    return out[:M, :dp].reshape(P, S, dp)


def emulate_simt(w: dict, front: torch.Tensor, P: int, step: int, seg: int) -> torch.Tensor:
    """csrc/conv_embed.cu's order from the plain version's weight forms, on
    every window at once: conv1 over (dt, df) skipping the taps outside the
    window, then + b1; conv2 and conv3 from 0 over (dt, df, ci), then the
    bias; each DoubleSwish and bf16 rounded; the projection from bo over k.
    [P, S, dp]."""
    S, W, mel = front.shape
    c1 = _widths(w)[0]
    x = torch.stack([front[:, j * step: j * step + seg] for j in range(P)])  # [P, S, seg, mel]
    x = torch.nn.functional.pad(_bf(x), (1, 1))
    w1 = w["w1"]
    a1 = torch.empty(P, S, R1, mel, c1)
    for t in range(R1):
        acc = torch.zeros(P, S, mel, c1)
        for dt in range(3):
            wr = t + dt - 1
            if wr < 0 or wr >= seg:
                continue
            for df in range(3):
                acc = acc + x[:, :, wr, df: df + mel, None] * w1[:, dt * 3 + df]
        a1[:, :, t] = _bf(_dswish(acc + w["b1"]))
    return simt_tail(w, a1)


def simt_tail(w: dict, a1: torch.Tensor) -> torch.Tensor:
    """csrc/conv_embed.cu after conv1, from its activations a1 [P, S, R1,
    mel, c1]: conv2 and conv3 from 0 over (dt, df, ci), then the bias, each
    DoubleSwish and bf16 rounded; the projection from bo over k. [P, S,
    dp]."""
    P, S, _, mel, c1 = a1.shape
    _, c2, c3, dp = _widths(w)
    f2, f3 = CE.conv_tile_dims(mel, c2)[:2]
    w2, w3 = w["w2k"].float(), w["w3k"].float()
    acc = torch.zeros(P, S, R2, f2, c2)
    for dt in range(3):
        for df in range(3):
            for ci in range(c1):
                a = a1[:, :, dt: dt + 2 * R2 - 1: 2, df: df + 2 * f2 - 1: 2, ci]
                acc = acc + a[..., None] * w2[(dt * 3 + df) * c1 + ci]
    y2 = _bf(_dswish(acc + w["b2"]))
    acc = torch.zeros(P, S, f3, c3)
    for dt in range(3):
        for df in range(3):
            for ci in range(c2):
                acc = acc + y2[:, :, dt, df: df + 2 * f3 - 1: 2, ci, None] * w3[(dt * 3 + df) * c2 + ci]
    y3 = _bf(_dswish(acc + w["b3"])).reshape(P, S, f3 * c3)
    wo = w["wo"].float()
    out = w["bo"].expand(P, S, dp).clone()
    for k in range(f3 * c3):
        out = out + y3[..., k, None] * wo[k]
    return out


@pytest.mark.parametrize("conv,d", WIDTHS)
@pytest.mark.parametrize("S,P", [(4, 5), (3, 5)])
def test_emulation_equals_simt_order_and_matches_jax_interpret(conv, d, S, P):
    jp, tp = _params(conv, d)
    W = (P - 1) * STEP + SEG
    front = np.random.default_rng(S * 100 + P).normal(size=(S, W, MEL)).astype(np.float32)
    tf = torch.from_numpy(front)
    w = CE.embed_weight_forms(tp)
    plan = CE.embed_plan_for(tp, S, P, MEL, SEG)
    assert plan is not None
    simt = emulate_simt(w, tf, P, STEP, SEG)
    for nw in sorted({plan.nw, 3}):  # the plan's groups, and groups of 3 (the last ragged)
        got = emulate_tile(w, tf, P, STEP, SEG, nw)
        assert torch.equal(got, simt), (nw, float((got - simt).abs().max()))
    want = np.asarray(JCE.conv_embed_windows(jp, jnp.asarray(front), P=P, step=STEP, seg=SEG,
                                             block_s=S, interpret=True))
    assert want.shape == (P, S, d)
    for name, v in (("emulation", simt[..., :d].numpy()),
                    ("plain", CE.conv_embed_windows(tp, tf, P=P, step=STEP, seg=SEG).numpy())):
        diff = np.abs(v - want)
        assert float((diff > 1e-4).mean()) <= 0.01, f"{name}: {(diff > 1e-4).mean():.4f}"
        assert float(diff.max()) <= 2e-2, f"{name}: max {diff.max():.4g}"
    # the padded output columns are zero (zero projection columns, zero bias)
    assert not simt[..., d:].any()


# -- (c) the step's route ----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_april(tmp_path_factory):
    from april_asr_tpu_torch.models.export import make_model_parameters, save_april
    from april_asr_tpu_torch.testing import default_tokens

    dims = TM.TransducerDims(d_model=128, hidden=128, ffn=128, joiner_dim=128, vocab=64,
                             layers=1, decoder_groups=32, conv_channels=(4, 8, 8))
    path = str(tmp_path_factory.mktemp("embed_tile") / "tiny.april")
    save_april(path, dims, TM.init_transducer_params(5, dims),
               make_model_parameters(dims, default_tokens(dims.vocab)), name="tiny")
    return path


@pytest.mark.parametrize("precision", ["int8", "bf16", None])
def test_step_routes_kernel16_to_the_tiled_kernel(tiny_april, monkeypatch, precision):
    """One BatchEngine tick: at int8 and bf16 the step calls kernel 16 once,
    and a CUDA front of its shapes would launch csrc/conv_embed_tile.cu on
    its plan; at f32 (as loaded) the step never calls kernel 16."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine

    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    rt = Model(tiny_april, precision=precision, device="cpu").runtime
    routes = []
    orig = TM.conv_embed_windows

    def windows(params, front, *, P, step, seg):
        S, _, mel = front.shape
        plan = CE.embed_plan_for(params, S, P, mel, seg)
        routes.append(("conv_embed", plan.nw) if plan is not None else ("conv_embed_simt", None))
        return orig(params, front, P=P, step=step, seg=seg)

    monkeypatch.setattr(TM, "conv_embed_windows", windows)
    S = 4
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=3200))
    for _ in range(S):
        eng.alloc(lambda r, toks: None)
    pcm = (np.random.default_rng(2).normal(0, 0.3, 3200) * 20000).astype(np.int16)
    for i in range(S):
        eng.feed(i, pcm)
    eng.tick()
    if precision is None:
        assert routes == []
    else:
        assert len(routes) == 1 and routes[0][0] == "conv_embed", routes
