"""Port: kernel 15, the int8 wavefront slab, as one persistent cooperative
launch whose diagonals run every live layer's step as tile phases
(csrc/lstm_wavefront_hoist.cu, planned by ops/lstm_mma.py `wavefront_plan`).

At diagonal D the live layers l (0 <= D - l < P) run their steps as phases
over all of them at once, a grid barrier after each: the gate tiles (layer,
128-row band, 32 hidden units whose four gates are the tile's columns), hcq
by rows, the projection tiles, then kernel 3's passes (yq, ff1 tiles, mq,
ff2 tiles, the norm) over each live layer's rows; the warps that norm a
layer's rows quantize them as the next layer's input, and the same phase
quantizes x[D + 1] and the carried h of every layer live at D + 1. The
kernel runs only on the card, where chip_smoke.py holds it bit for bit to
its CUDA-core template. Here, on the CPU:

* a torch emulation of the launch, diagonal by diagonal and phase by phase:
  the plan's tiles in the launch's order, the per-layer scratch, the
  ring double-buffered by diagonal parity, the mid row amax folded over
  each row's ff1 tiles, every phase ending where the kernel's grid barrier
  does, equals `lstm_slab_wavefront_plain` bit for bit at ragged shapes
  (S = 3, 37 and 130; P below and above Lk; Lk 1 to 3; few SMs), gated and
  ungated. The cell, DoubleSwish and the norm run on tensors laid out as in
  the plain version (PyTorch's CPU vector and scalar tanh may differ by an
  ulp, and which elements take which depends on the layout);
* the plan covers every live (layer, step) once over the diagonals, and at
  each diagonal every gate unit, projection output, ff1 and ff2 output and
  row of the closing row phase once, on blocks within the launch; its shared
  memory (the two tile stages and the gate tile's parked x-side gates, no
  stationary weights) fits at Lk = 4, 6 and 12, S = 256 and 2048;
* by bytes, no weight is worth holding stationary beside those stages: at
  Lk = 4, 6 and 12 and S = 256 and 2048, w_hh and w_hr fit beside them only
  as slices of few hidden units, and at every such grain the hq rows those
  slices must read cost at least the bytes of the streamed tiles;
* both wrappers take the plain version on the CPU.
"""

import numpy as np
import pytest
import torch

from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops import lstm_wavefront_kernels as LW
from april_asr_tpu_torch.ops.activations import sigmoid
from test_torch_port_ffn_mma import _tile_dot
from test_torch_port_lstm_mma import _assert_equal, _layer
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)


def _slab(seed, Lk, d, H, F, bias_dtype):
    """Lk random int8 layers in the serving form, stacked (leading dim Lk)."""
    layers = [sum(_layer(seed + l, d, H, F, bias_dtype), ()) for l in range(Lk)]
    return tuple(torch.stack(ws) for ws in zip(*layers))


def _slab_state(seed, P, S, d, H, Lk):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(rng.normal(size=(P, S, d)).astype(np.float32)),
            t((rng.normal(size=(Lk, S, d)) * 0.3).astype(np.float32)),
            t((rng.normal(size=(Lk, S, H)) * 0.3).astype(np.float32)))


def _at_step(fn, v, t, P):
    """fn over a [P * S, n] tensor holding v [S, n] at step t's rows (zeros
    elsewhere), cut back to those rows: the plain version applies the FFN's
    elementwise functions and the norm to the chunk's P * S rows at once."""
    S = v.shape[0]
    full = torch.zeros((P * S, v.shape[1]))
    full[t * S : (t + 1) * S] = v
    return fn(full)[t * S : (t + 1) * S]


def _nan(*shape):
    return torch.full(shape, float("nan"))


def emulate_wavefront(plan, x, h, c, n_pulls, *w):
    """The launch: h2, c2 from h, c and layer 0's x[0] and h rows quantized;
    then per diagonal the gate tiles (x- and h-side dots, the bias), the
    cell, hcq, the projection tiles (hseq, the carried h), yq, the ff1
    tiles with DoubleSwish and the row amax folded per tile, mq, the ff2
    tiles with the residual, the norm into the ring slot (y[t] for the last
    layer), and the closing row phase's quantizations."""
    (w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias, w_hr_q, w_hr_s,
     ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps) = w
    P, S, d = x.shape
    Lk, _, H = c.shape
    F = ff1_q.shape[-1]
    h2, c2 = h.clone(), c.clone()
    ring, y = _nan(2, Lk, S, d), _nan(P, S, d)
    xq, hq = {0: LK._rowq8(x[0])}, {0: LK._rowq8(h[0])}  # one (codes, scales) a layer
    col = lambda v, l, cols: v[l].float().reshape(-1)[cols]  # noqa: E731
    for D in range(plan.diagonals):
        live = plan.live(D)
        keep = {l: (torch.ones(S, 1, dtype=torch.bool) if n_pulls is None
                    else (D - l < n_pulls)[:, None]) for l in live}
        gates = {l: _nan(S, 4 * H) for l in live}
        for _, l, rows, units in plan.tiles("gates", D):
            cols = [gi * H + u for gi in range(4) for u in units]
            (xv, xs), (hv, hs) = xq[l], hq[l]
            gx = _tile_dot(xv, w_ih_q[l], rows, cols, plan.dp) * (xs[rows] * col(w_ih_s, l, cols))
            gh = _tile_dot(hv, w_hh_q[l], rows, cols, plan.dp) * (hs[rows] * col(w_hh_s, l, cols))
            gates[l][rows.start : rows.stop, cols] = (gx + gh) + col(bias, l, cols)
        hcq = {}
        for l in live:  # the cell in the gate tiles' registers; hc's rows by warps
            assert not gates[l].isnan().any()
            i, f, g, o = gates[l].split(H, dim=-1)
            c_new = sigmoid(f) * c2[l] + sigmoid(i) * torch.tanh(g)
            hcq[l] = LK._rowq8(sigmoid(o) * torch.tanh(c_new))
            c2[l] = torch.where(keep[l], c_new, c2[l])
        hseq = {l: _nan(S, d) for l in live}
        for _, l, rows, cols in plan.tiles("proj", D):
            (hv, hs), r, cl = hcq[l], slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            hseq[l][r, cl] = (_tile_dot(hv, w_hr_q[l], rows, cols, plan.hp)
                              * (hs[r] * col(w_hr_s, l, cl)))
        yv, yq, mid, amax = {}, {}, {}, {}
        for l in live:
            assert not hseq[l].isnan().any()
            h2[l] = torch.where(keep[l], hseq[l], h2[l])
            xin = x[D] if l == 0 else ring[(D - 1) % 2, l - 1]
            yv[l] = xin + hseq[l]
            yq[l] = LK._rowq8(yv[l])
            mid[l], amax[l] = _nan(S, F), torch.zeros(S, 1)
        for _, l, rows, cols in plan.tiles("ff1", D):
            (yv_, ys), r, cl = yq[l], slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            mid[l][r, cl] = (_tile_dot(yv_, ff1_q[l], rows, cols, plan.dp)
                             * (ys[r] * col(ff1_s, l, cl)) + col(ff1_b, l, cl))
        out = {}
        for l in live:
            assert not mid[l].isnan().any()
            mid[l] = _at_step(lambda m: m * sigmoid(m - 1.0), mid[l], D - l, P)
            out[l] = _nan(S, d)
        for _, l, rows, cols in plan.tiles("ff1", D):  # each tile's partial row amax, folded
            r, cl = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            amax[l][r] = torch.maximum(amax[l][r], mid[l][r, cl].abs().amax(-1, keepdim=True))
        ms = {l: torch.clamp_min(amax[l], 1e-30) * (1.0 / 127.0) for l in live}
        mq = {l: torch.round(mid[l] * torch.reciprocal(ms[l])) for l in live}
        for _, l, rows, cols in plan.tiles("ff2", D):
            r, cl = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            ff = (_tile_dot(mq[l], ff2_q[l], rows, cols, plan.fp) * (ms[l][r] * col(ff2_s, l, cl))
                  + col(ff2_b, l, cl))
            out[l][r, cl] = yv[l][r, cl] + ff
        for l in live:
            assert not out[l].isnan().any()
            v = _at_step(lambda o: LK.basic_norm_plain(o, eps[l]), out[l], D - l, P)
            if l == Lk - 1:
                y[D - l] = v
            else:
                ring[D % 2, l] = v
                xq[l + 1] = LK._rowq8(v)
        if D + 1 < P:
            xq[0] = LK._rowq8(x[D + 1])
        for l in plan.live(D + 1):
            hq[l] = LK._rowq8(h2[l])
    return y, h2, c2


# (S, P, d, H, F, Lk, n_sm): chip_smoke's ragged S = 3 (P above Lk); P
# below Lk at a padded-odd d and a ragged unit group (H = 36) on 4 SMs; one
# step over two layers; one layer; two row bands; F over two ragged column
# tiles on 3 SMs
CASES = [(3, 5, 64, 64, 128, 3, 132), (37, 2, 68, 36, 96, 3, 4), (3, 1, 64, 32, 64, 2, 132),
         (37, 4, 64, 40, 160, 1, 8), (130, 2, 64, 32, 64, 2, 16), (5, 3, 128, 68, 196, 2, 3)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S, P, d, H, F, Lk, n_sm", CASES)
def test_launch_equals_plain(S, P, d, H, F, Lk, n_sm, gated):
    w = _slab(41, Lk, d, H, F, torch.bfloat16 if gated else torch.float32)
    x, h, c = _slab_state(42, P, S, d, H, Lk)
    n_pulls = (torch.from_numpy(np.random.default_rng(43).integers(0, P + 1, S).astype(np.int32))
               if gated else None)
    plan = LM.wavefront_plan(S, P, d, H, F, Lk, n_sm=n_sm)
    got = emulate_wavefront(plan, x, h, c, n_pulls, *w)
    want = LW.lstm_slab_wavefront_plain(x, h, c, *w, n_pulls=n_pulls)
    _assert_equal(got, want, ("y", "h", "c"))


# -- the plan ----------------------------------------------------------------

# (S, P, d, H, F, Lk): the flagship slabs of profile_wavefront at S = 256
# and 2048, chip_smoke's ragged S = 3, P = 5 below Lk, the wide widths,
# padded-odd widths
PLAN_SHAPES = [(256, 27, 512, 1024, 2048, Lk) for Lk in (4, 6, 12)] + [
    (2048, 27, 512, 1024, 2048, Lk) for Lk in (4, 6, 12)] + [
    (3, 5, 512, 1024, 2048, 6), (256, 27, 1024, 4096, 8192, 6), (37, 4, 68, 260, 196, 3)]


@pytest.mark.parametrize("n_sm", [132, 16])
@pytest.mark.parametrize("S, P, d, H, F, Lk", PLAN_SHAPES)
def test_plan_covers_every_item_once(S, P, d, H, F, Lk, n_sm):
    plan = LM.wavefront_plan(S, P, d, H, F, Lk, n_sm=n_sm)
    assert 1 <= plan.nb <= n_sm and plan.sp % LM.FFN_TILE == 0 and plan.sp - 128 < S <= plan.sp
    # every (layer, step) is live on exactly one diagonal, t = D - l
    steps = np.zeros((Lk, P), np.int32)
    for D in range(plan.diagonals):
        for l in plan.live(D):
            steps[l, D - l] += 1
    assert (steps == 1).all() and not list(plan.live(plan.diagonals))
    for D in (0, min(P, Lk) - 1, plan.diagonals - 1):  # the first, the widest, the last
        live = plan.live(D)
        for kind, n in (("gates", H), ("proj", d), ("ff1", F), ("ff2", d)):
            seen = np.zeros((Lk, S, n), np.int8)
            for b, l, rows, cols in plan.tiles(kind, D):
                assert 0 <= b < plan.nb and l in live and len(rows) <= 128
                assert len(cols) <= (LM.WF_UNITS if kind == "gates" else LM.FFN_TILE)
                seen[l, rows.start : rows.stop, cols.start : cols.stop] += 1
            assert (seen[list(live)] == 1).all() and seen.sum() == len(live) * S * n
        rows = {}
        for b, kind, l, s in plan.rows(D):
            assert 0 <= b < plan.nb
            rows[(kind, l, s)] = rows.get((kind, l, s), 0) + 1
        want = ([("norm", l, s) for l in live for s in range(S)]
                + [("x", 0, s) for s in range(S) if D + 1 < P]
                + [("h", l, s) for l in plan.live(D + 1) for s in range(S)])
        assert rows == {k: 1 for k in want}
    # no matrix stays in shared memory: two tile stages and the tile's row
    # amax slots (csrc/ffn_mma.cuh FM_TILE_SMEM), then a gate tile's x-side
    # gates, 64 f32 for each of 256 threads
    assert LM.WF_SMEM == LM.FFN_SMEM + 64 * 256 * 4 == 107_008 <= LM.SMEM_LIMIT


def test_plan_bytes_and_scratch():
    """The flagship 6-layer slab at S = 256, P = 27: 32 diagonals, 132
    blocks (384 gate tiles at six live layers), 515 stamps a block; the
    scratch keeps every buffer apart, 256-byte aligned, mid [6][256][2048]
    f32 the largest."""
    plan = LM.wavefront_plan(256, 27, 512, 1024, 2048, 6)
    assert (plan.diagonals, plan.nb, plan.n_stamps) == (32, 132, 515)
    assert (plan.sp, plan.dp, plan.hp, plan.fp) == (256, 512, 1024, 2048)
    assert len(list(plan.tiles("gates", 10))) == 6 * 2 * 32
    assert len(list(plan.tiles("ff1", 10))) == 6 * 2 * 16
    nbytes, offs = plan.scratch()
    assert len(offs) == 11 and all(o % 256 == 0 for o in offs) and list(offs) == sorted(offs)
    assert offs[10] - offs[9] == 6 * 256 * 2048 * 4 and nbytes - offs[10] == 2 * 6 * 256 * 512 * 4
    assert LM.wavefront_plan(3, 5, 512, 1024, 2048, 6).nb == 132  # 5 live x 32 gate tiles
    assert LM.wavefront_plan(3, 1, 64, 32, 64, 2).nb == 1


@pytest.mark.parametrize("args, why", [
    ((256, 27, 512, 1024, 2046, 6), "multiples of 4"),
    ((256, 0, 512, 1024, 2048, 6), "positive"),
    ((256, 27, 512, 1024, 2048, 0), "positive"),
])
def test_plan_raises_where_nothing_fits(args, why):
    with pytest.raises(ValueError, match=why):
        LM.wavefront_plan(*args)


# -- no stationary weights ---------------------------------------------------


@pytest.mark.parametrize("S", [256, 2048])
@pytest.mark.parametrize("Lk, fits", [(4, {2, 4, 8, 16}), (6, {2, 4}), (12, set())])
def test_stationary_recurrent_weights_save_no_bytes(Lk, fits, S):
    """Why every weight streams. Held once across the launch's blocks, w_hh
    and w_hr of the flagship slab would sit beside the WF_SMEM bytes a block
    already holds, cut into slices of u hidden units' four gates (d * 4u
    bytes; w_hr in slices of the same size). They fit only at the grains
    `fits`. A block holding a slice runs its units over all S rows of the
    layer, so it reads every hq row, and across the slab the slices read
    Lk * (H / u) * S * dp bytes of hq from L2 at each full diagonal, where
    the streamed h-side tiles read their hq rows and w_hh, Lk * sp / 128 *
    H / 32 * 2 * 128 * dp bytes: at every grain that fits the slices read at
    least as many, equal at u = 16."""
    d, H, F = 512, 1024, 2048
    plan = LM.wavefront_plan(S, 27, d, H, F, Lk)
    free = LM.SMEM_LIMIT - LM.WF_SMEM
    assert (plan.nb, free) == (132, 125_440)
    streamed = Lk * plan.grid("gates")[1] * plan.grid("gates")[0] * 2 * LM.FFN_TILE * plan.dp
    got = set()
    for u in (2, 4, 8, 16, 32):
        chunk = d * 4 * u
        chunks = Lk * -(-(H * 4 * d + H * d) // chunk)
        if chunks <= plan.nb * (free // chunk):
            got.add(u)
            assert Lk * (H // u) * S * plan.dp >= streamed
    assert got == fits


# -- the wrappers on the CPU ---------------------------------------------------


def test_wrappers_take_the_plain_version_on_the_cpu():
    w = _slab(44, 2, 64, 32, 64, torch.bfloat16)
    x, h, c = _slab_state(45, 3, 5, 64, 32, 2)
    n_pulls = torch.tensor([0, 1, 2, 3, 3], dtype=torch.int32)
    for g in (n_pulls, None):
        want = LW.lstm_slab_wavefront_plain(x, h, c, *w, n_pulls=g)
        for fn in (LW.lstm_slab_wavefront_i8, LW.lstm_wavefront_i8_simt):
            _assert_equal(fn(x, h, c, *w, g), want, ("y", "h", "c"))
