"""Port: the launch plans and item decomposition of the tensor-parallel
step's kernels 20 and 21 as one launch each (csrc/lstm_tp_ffn.cu, planned
by ops/tp_plan.py `ffn_plan` and `mid_plan`).

The kernels run only on the card, where chip_smoke.py holds them bit for
bit to the column-pass kernels they replaced (`*_simt`, csrc/lstm_tp.cu).
Here, on the CPU:

* kernel 20's plan covers every (session, column) of its ff1 phase and of
  its ff2 phase exactly once, and kernel 21's every (session, column) of
  mid, within the H100's shared memory and SM count (one cooperative grid:
  every block co-resident); at the flagship shard the plans are the ones
  measured on the card; the shared memory does not grow with d or Fs;
* where no plan fits, the plan is None and the route names the column-pass
  kernel;
* kernel 20's weights are tiled as its stages take them (the exact
  widening at bf16), laid out once per weights; a plan's scratch workspace
  is laid out once per plan and device;
* a torch emulation of the kernels' items (kernel 20: each ff1 item's
  product of the rounded rows, bias and DoubleSwish, mid rounded to the
  weight type, then each ff2 item; kernel 21: whole rows quantized, each
  item's exact integer dots with the scale fold, bias and DoubleSwish)
  matches the plain versions (kernel 21 bit for bit, kernel 20 to
  test_torch_port_tp.py's bounds) and the JAX kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.ops import lstm_tp_pallas as JTP
from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_tp_kernels as TK
from april_asr_tpu_torch.ops import tp_plan as TP
from april_asr_tpu_torch.ops.activations import double_swish
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

SMEM = 232_448  # bytes of shared memory an H100 block may opt in to
N_SM = 132
# (S, d, Fs): the flagship shard at m = 2 and m = 4, the ragged S = 3, the
# chunk tools' 2048, a narrow shard (d 68 / Fs 100: the padded shard of a
# d 66 / ffn 198 model at m = 2)
SHAPES = [(256, 512, 1024), (256, 512, 512), (3, 512, 1024), (2048, 512, 1024), (8, 68, 100)]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=1e-3)


def _cover(items, S, N):
    cnt = np.zeros((S, N), np.int64)
    for cols, rows in items:
        assert len(rows) >= 1 and rows.stop <= S
        cnt[rows.start:rows.stop, cols.start:min(cols.stop, N)] += 1
    return cnt


@pytest.mark.parametrize("S, d, Fs", SHAPES)
def test_ffn_plan_covers_every_column_once(S, d, Fs):
    plan = TP.ffn_plan(S, d, Fs, N_SM)
    assert plan is not None and plan.smem <= SMEM and plan.nb <= N_SM
    assert plan.smem == TP.ffn_smem(plan.t1, plan.t2)
    for phase, N in ((1, Fs), (2, d)):
        t = plan.t1 if phase == 1 else plan.t2
        assert t.nw <= 8 and t.rm in (1, 2, 4) and t.nq in (1, 2)
        items = [it for b in range(plan.nb) for it in plan.items(phase, b)]
        assert all(len(c) == t.tc and len(r) <= t.tr for c, r in items)
        assert (_cover(items, S, N) == 1).all()


@pytest.mark.parametrize("S, d, Fs", SHAPES)
def test_mid_plan_covers_every_column_once(S, d, Fs):
    plan = TP.mid_plan(S, d, Fs, N_SM)
    assert plan is not None and plan.nb <= N_SM
    assert plan.smem == TP.mid_smem(plan.tr, plan.tc, plan.dp) <= SMEM
    assert plan.dp % 64 == 0 and plan.dp >= d and plan.ntw in (1, 2, 4)
    items = [it for b in range(plan.nb) for it in plan.items(b)]
    assert (_cover(items, S, Fs) == 1).all()
    nbytes, offsets = plan.scratch()
    assert offsets[0] == 0 and offsets[1] >= S * plan.dp and nbytes >= offsets[1] + 4 * S
    assert all(o % 256 == 0 for o in offsets)


def test_ffn_cycles():
    """An item's cost adds its FFMA issue and its shared-memory cycles per 4
    depths: 2 rows x 4 columns a lane on 8 warps issue 64 FFMA cycles a
    scheduler and read 6 LDS.128 of 512 bytes a warp (192 cycles); 4 x 4
    on 2 warps 64 and 64; 4 x 8 on one warp 128 and 48."""
    assert TP.FfnTile(2, 1, 8, 1).cycles(4) == 64 + 192
    assert TP.FfnTile(4, 1, 2, 1).cycles(4) == 64 + 64
    assert TP.FfnTile(4, 2, 1, 1).cycles(512) == 128 * (128 + 48)


def test_flagship_plans():
    """The plans measured on the H100 at the m = 2 shard, S = 256: kernel
    20 on one grid of 128 blocks, ff1 items of 64 x 32 at 4 x 4 a lane and
    ff2 items of 32 x 32 at 2 x 4, both on 4 warps; kernel 21 on 128 items
    of 32 x 64; and at m = 4 (Fs 512)."""
    p = TP.ffn_plan(256, 512, 1024, N_SM)
    assert (p.t1, p.t2, p.nb, p.smem) == (TP.FfnTile(4, 1, 4, 1), TP.FfnTile(2, 1, 4, 1), 128,
                                          76_824)
    q = TP.mid_plan(256, 512, 1024, N_SM)
    assert (q.tr, q.tc, q.nb, q.smem) == (32, 64, 128, 50_816)
    p4 = TP.ffn_plan(256, 512, 512, N_SM)
    assert (p4.t1, p4.t2, p4.nb) == (TP.FfnTile(2, 1, 4, 1), TP.FfnTile(2, 1, 4, 1), 128)
    q4 = TP.mid_plan(256, 512, 512, N_SM)
    assert (q4.tr, q4.tc, q4.nb) == (32, 32, 128)


@pytest.mark.parametrize("d, Fs", [(512, 1024), (1024, 4096), (4096, 16384)])
def test_shared_memory_does_not_grow_with_the_widths(d, Fs):
    """Kernel 20's ring holds tiles of the item shapes alone, so it has a
    plan wherever kernel 18 has one."""
    big = TP.FfnTile(4, 2, 8, 1)
    assert TP.ffn_plan(256, d, Fs, N_SM).smem <= TP.ffn_smem(big, big) <= SMEM
    assert TP.gcp_plan(256, d, Fs // 2, N_SM) is not None


@pytest.mark.parametrize("kind, args, kw", [
    ("ffn", (256, 512, 1024), dict(smem_limit=20_000)),
    ("mid_i8", (256, 512, 1024), dict(smem_limit=30_000)),
    ("ffn", (256, 510, 1024), {}),
    ("mid_i8", (256, 512, 1022), {}),
])
def test_no_plan_routes_the_column_pass_kernel(kind, args, kw):
    assert TP.PLANS[kind](*args, **kw) is None
    assert TP.tp_route(kind, *args, **kw) == "simt"
    assert TP.tp_route(kind, 256, 512, 1024) == "fused"


@pytest.mark.parametrize("tc", [32, 64])
@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_ffn_tile_forms(wd, tc):
    """Kernel 20's weights lie as its stages take them: [column group][depth
    chunk][64][tc] f32, the weights widened exactly, zero past the widths;
    laid out once per weights and widths."""
    rng = np.random.default_rng(1)
    ff1 = torch.from_numpy(rng.normal(size=(100, 68)).astype(np.float32)).to(wd)
    ff2 = torch.from_numpy(rng.normal(size=(68, 100)).astype(np.float32)).to(wd)
    w1, w2 = TK.ffn_tile_forms(ff1, ff2, tc, 32)
    assert w1.dtype == torch.float32 and w1.shape == (-(-68 // tc), 2, 64, tc)
    for w, form, t in ((ff1, w1, tc), (ff2, w2, 32)):
        K, N = w.shape
        back = form.permute(1, 2, 0, 3).reshape(form.shape[1] * 64, form.shape[0] * t)
        assert torch.equal(back[:K, :N], w.float())
        assert not back[K:].any() and not back[:, N:].any()
    assert TK.ffn_tile_forms(ff1, ff2, tc, 32)[0] is w1  # cached
    assert TK.ffn_tile_forms(ff1, ff2, 64 if tc == 32 else 32, 32)[0] is not w1
    ff1.mul_(2)  # an in-place edit makes a new form
    assert torch.equal(TK.ffn_tile_forms(ff1, ff2, tc, 32)[0][0, 0, :, :4], ff1[:64, :4].float())


def test_workspace_is_laid_out_once_per_plan():
    """Kernels 19, 20 and 21 take their scratch from one workspace kept per
    plan and device: the same pointers on every call, at the plan's
    offsets."""
    dev = torch.device("cpu")
    for plan in (TP.gc_i8_plan(256, 512, 512), TP.ffn_plan(256, 512, 1024),
                 TP.mid_plan(256, 512, 1024)):
        ws, ptrs = TK._workspace(plan, dev)
        assert TK._workspace(plan, dev)[0] is ws and TK._workspace(plan, dev)[1] == ptrs
        nbytes, offsets = plan.scratch()
        assert ws.numel() >= nbytes and [p - ws.data_ptr() for p in ptrs] == list(offsets)


def test_launch_state_is_kept_per_shape(monkeypatch):
    """Kernels 18-21 look up their plan, scratch pointers and C plan
    arguments under one key a shape and device (the host's time a call);
    a shape no plan holds keeps the column-pass route."""
    dev = torch.device("cpu")
    monkeypatch.setattr(TK, "_ROUTES", {})
    for kind, fn in TP.PLANS.items():
        monkeypatch.setitem(TK._DEVICE_PLAN, kind, lambda S, d, n, i, fn=fn: fn(S, d, n))
    got = TK._launch("mid_i8", 256, 512, 1024, dev)
    assert got == TK._launch("mid_i8", 256, 512, 1024, dev)
    plan, ptrs, ints = got
    assert plan == TP.mid_plan(256, 512, 1024) and ints == plan.ints()
    assert ptrs == TK._workspace(plan, dev)[1]
    TK._WORK.clear()  # the launch state keeps its workspace alive
    ws = TK._ROUTES[("mid_i8", 256, 512, 1024, dev)][3]
    assert ws.data_ptr() + plan.scratch()[1][1] == ptrs[1]
    assert TK._launch("ffn", 256, 510, 1024, dev) == (None, (), ())
    explicit = TP.ffn_plan(256, 512, 1024, 8)
    assert TK._launch("ffn", 256, 512, 1024, dev, explicit)[0] == explicit
    assert TK._launch("ffn", 256, 512, 1024, dev)[0] == TP.ffn_plan(256, 512, 1024)


def _act(w):
    return (lambda v: v.to(torch.bfloat16).float()) if w.dtype == torch.bfloat16 else (lambda v: v)


def emulate_ffn(plan, y, ff1, ff1_b, ff2):
    """Kernel 20 item by item: each ff1 item's product of the rounded rows
    with the widened weights, + b1, DoubleSwish, rounded to the weight type;
    then each ff2 item's product."""
    S, d = y.shape
    Fs = ff1.shape[1]
    w1, w2 = ff1.float(), ff2.float()
    act = _act(ff1)
    mid = torch.full((S, Fs), float("nan"))
    out = torch.full((S, d), float("nan"))
    for b in range(plan.nb):
        for cols, rows in plan.items(1, b):
            c, r = slice(cols.start, min(cols.stop, Fs)), slice(rows.start, rows.stop)
            mid[r, c] = act(double_swish(act(y[r]) @ w1[:, c] + ff1_b.float()[c]))
    assert not mid.isnan().any()
    for b in range(plan.nb):
        for cols, rows in plan.items(2, b):
            c, r = slice(cols.start, min(cols.stop, d)), slice(rows.start, rows.stop)
            out[r, c] = mid[r] @ w2[:, c]
    assert not out.isnan().any()
    return out


def emulate_mid_i8(plan, y, ff1_q, ff1_s, ff1_b):
    """Kernel 21 item by item: whole rows quantized (_rowq8 is exact where
    it is taken: y is replicated), each item's exact integer dots folded
    with the row and column scales, + b1, DoubleSwish."""
    S = y.shape[0]
    Fs = ff1_q.shape[1]
    yq, ys = LK._rowq8(y)
    mid = torch.full((S, Fs), float("nan"))
    for b in range(plan.nb):
        for cols, rows in plan.items(b):
            c, r = slice(cols.start, min(cols.stop, Fs)), slice(rows.start, rows.stop)
            v = LK._int_dot(yq[r], ff1_q[:, c]) * (ys[r] * ff1_s.reshape(1, -1)[:, c])
            mid[r, c] = double_swish(v + ff1_b.float().reshape(1, -1)[:, c])
    assert not mid.isnan().any()
    return mid


def _y(seed, S, d):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(S, d)).astype(np.float32))


def _float_weights(seed, d, Fs, wd):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return (t(rng.normal(size=(d, Fs)) / np.sqrt(d)).to(wd), t(rng.normal(size=Fs) * 0.3),
            t(rng.normal(size=(Fs, d)) / np.sqrt(Fs)).to(wd))


def _i8_weights(seed, d, Fs, bias_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(rng.integers(-127, 128, size=(d, Fs)).astype(np.int8)),
            t((rng.random(Fs) * 2e-3 + 5e-4).astype(np.float32)),
            t((rng.normal(size=Fs) * 0.3).astype(np.float32)).to(bias_dtype))


# (S, d, Fs, n_sm): few SMs, so that blocks walk several items
EMU_CASES = [(8, 64, 32, 132), (37, 68, 20, 8), (130, 96, 200, 16)]


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S, d, Fs, n_sm", EMU_CASES)
def test_ffn_items_match_plain(S, d, Fs, n_sm, wd):
    y = _y(2, S, d)
    w = _float_weights(3, d, Fs, wd)
    want = TK.ffn_partial_plain(y, *w)
    for nw in (1, 2, 4, 8):  # the best plan on items of each number of warps
        plan = TP.ffn_plan(S, d, Fs, n_sm, tiles=tuple(t for t in TP.FFN_TILES if t.nw == nw))
        got = emulate_ffn(plan, y, *w)
        torch.testing.assert_close(got, want, **(F32_TOL if wd == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S, d, Fs, n_sm", EMU_CASES)
def test_mid_i8_items_equal_plain(S, d, Fs, n_sm, bias_dtype):
    y = _y(4, S, d)
    w = _i8_weights(5, d, Fs, bias_dtype)
    got = emulate_mid_i8(TP.mid_plan(S, d, Fs, n_sm), y, *w)
    want = TK.ffn_mid_i8_plain(y, *w)
    assert torch.equal(got, want), f"max abs diff {float((got - want).abs().max()):.3g}"


S_JAX, D_JAX, FS_JAX = 128, 128, 128  # test_torch_port_tp.py's shard (d 128, ffn 256, m 2)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.float32)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_ffn_items_match_jax_interpret(wd):
    y = _y(6, S_JAX, D_JAX)
    w = _float_weights(7, D_JAX, FS_JAX, wd)
    got = emulate_ffn(TP.ffn_plan(S_JAX, D_JAX, FS_JAX, N_SM), y, *w)
    want = JTP.ffn_partial(jnp.asarray(y.numpy()), _j(w[0]), jnp.asarray(w[1].numpy()),
                           _j(w[2]), block_s=S_JAX, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(F32_TOL if wd == torch.float32 else BF16_TOL))


def test_mid_i8_items_match_jax_interpret():
    y = _y(8, S_JAX, D_JAX)
    w = _i8_weights(9, D_JAX, FS_JAX)
    got = emulate_mid_i8(TP.mid_plan(S_JAX, D_JAX, FS_JAX, N_SM), y, *w)
    want = JTP.ffn_mid_i8(jnp.asarray(y.numpy()), jnp.asarray(w[0].numpy()),
                          jnp.asarray(w[1].numpy()), _j(w[2]), block_s=S_JAX, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
