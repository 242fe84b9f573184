"""Port: kernel 3 as tiled int8 tensor-core passes (csrc/ffn_mma.cu, planned
by ops/lstm_mma.py `ffn_plan`), and the layer kernels at widths that are
not multiples of 4 (zero-padded, ops/widths.py).

Kernel 3 runs only on the card, where chip_smoke.py holds it bit for bit to
the CUDA-core kernel it replaced (`ffn_norm_i8_simt`). Here, on the CPU:

* the plan's tiles cover every (row, column) of ff1 and ff2 exactly once,
  within the H100's shared memory, at the flagship widths, at d 68 / F 196
  and at d 1024 / F 8192, over 3, 6,912, 55,296 and ragged row counts, and
  its scratch layout holds every buffer apart;
* a torch emulation of the five launches, tile by tile (the yq rows, the
  ff1 tiles' integer dots over 64-byte depth stages with the weights' rows
  past the depth zero, the row amax folded over the tiles by max, mq by
  the row scale, the ff2 tiles, the norm) equals `ffn_norm_plain` bit for
  bit. DoubleSwish and the norm run on whole tensors, as in the plain
  version, because PyTorch's CPU vector and scalar paths of tanh may
  differ by an ulp; on the card they are per element and per row;
* the emulation agrees with the JAX kernel `ffn_norm_i8` in interpret mode
  to f32 ulps except isolated int8 rounding flips (`_assert_ulp_close`);
* the emulation at widths padded to multiples of 4, its norm over the
  model's d_model (`norm_d`), equals `ffn_norm_plain` at the model's widths
  bit for bit, its padded columns zero;
* `padded_layers` keeps every layer leaf at multiples of 4 and pads the
  others with zeros, each gate block on its own; the encoder stacks call
  only the kernel wrappers, at padded widths with the model's d_model as
  the norm's, and give the plain layers' results at the model's widths; a
  d = 66 / H 130 / F 198 model, which the JAX package serves through XLA,
  streams through the port's CPU engine with the JAX engine's events (equal
  at f32, parting only at near-ties at int8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.ops import lstm_pallas as JLP
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.engine import step as ES
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import lstm_kernels as LK
from april_asr_tpu_torch.ops import lstm_mma as LM
from april_asr_tpu_torch.ops.activations import sigmoid
from april_asr_tpu_torch.ops.widths import round_up, zero_pad
from test_torch_port_engine import _stream_parity
from test_torch_port_lstm_mma import _assert_ulp_close, _layer
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

WIDTHS = [(512, 2048), (68, 196), (1024, 8192)]
ROWS = [3, 6912, 55296, 1000, 6913]


def _partition(ranges, n: int) -> None:
    """The distinct ranges cover [0, n) end to end, once each."""
    pos = 0
    for r in sorted(set(ranges), key=lambda r: r.start):
        assert r.start == pos and len(r) > 0
        pos = r.stop
    assert pos == n


@pytest.mark.parametrize("d, F", WIDTHS)
@pytest.mark.parametrize("R", ROWS)
def test_plan_covers_every_output_once(R, d, F):
    """Each product's tiles are the grid of a row partition of [0, R) and a
    column partition of its width, each (rows, columns) pair once: every
    (row, column) in exactly one tile."""
    plan = LM.ffn_plan(R, d, F)
    assert plan.smem == LM.FFN_SMEM <= LM.SMEM_LIMIT
    assert plan.rp % LM.FFN_TILE == 0 and plan.rp - LM.FFN_TILE < R <= plan.rp
    assert plan.dp % LM.FFN_KT == 0 and plan.dp - LM.FFN_KT < d <= plan.dp
    assert plan.fp % LM.FFN_KT == 0 and plan.fp - LM.FFN_KT < F <= plan.fp
    for n in (F, d):  # ff1, ff2
        tiles = list(plan.tiles(n))
        nx, ny = plan.grid(n)
        assert len(tiles) == nx * ny == len(set((r.start, c.start) for r, c in tiles))
        assert all(len(r) <= LM.FFN_TILE and len(c) <= LM.FFN_TILE for r, c in tiles)
        _partition([r for r, _ in tiles], R)
        _partition([c for _, c in tiles], n)
        assert {(r.start, c.start) for r, c in tiles} == {
            (r.start, c.start) for r in {r for r, _ in tiles} for c in {c for _, c in tiles}}


@pytest.mark.parametrize("d, F", WIDTHS)
def test_plan_scratch_layout(d, F):
    """The C entry's six scratch buffers, 256-byte aligned and apart, each of
    its size: yq [rp][dp], ys [rp], mid [R][F], amax [rp], mq [rp][fp], ms
    [rp] (mid f32 is 56.6 MB at the flagship's 6,912 rows)."""
    plan = LM.ffn_plan(6912, d, F)
    nbytes, offs = plan.scratch()
    sizes = (plan.rp * plan.dp, 4 * plan.rp, 4 * 6912 * F, 4 * plan.rp, plan.rp * plan.fp,
             4 * plan.rp)
    assert all(o % 256 == 0 for o in offs) and offs[0] == 0
    for o, n, nxt in zip(offs, sizes, offs[1:] + (nbytes,)):
        assert o + n <= nxt
    if (d, F) == (512, 2048):
        assert sizes[2] == 56_623_104 and nbytes == 74_400_768


@pytest.mark.parametrize("args, why", [((0, 512, 2048), "positive"), ((6912, 510, 2048), "of 4"),
                                       ((6912, 512, 2046), "of 4")])
def test_plan_raises(args, why):
    with pytest.raises(ValueError, match=why):
        LM.ffn_plan(*args)


# -- the five launches, tile by tile ----------------------------------------


def _tile_dot(q, w, rows, cols, kp):
    """One tile's int32 accumulator: the depth in 64-byte stages, the A rows
    padded with zeros past the depth and the weights' rows past it loaded as
    zero (an integer dot in any order is exact)."""
    K = w.shape[0]
    a = torch.zeros(len(rows), kp)
    a[:, :K] = q[rows]
    b = torch.zeros(kp, len(cols))
    b[:K] = w[:, cols].float()
    acc = torch.zeros(len(rows), len(cols), dtype=torch.float64)
    for k0 in range(0, kp, LM.FFN_KT):
        acc += a[:, k0 : k0 + LM.FFN_KT].double() @ b[k0 : k0 + LM.FFN_KT].double()
    return acc.float()


def emulate_ffn(plan, x, hseq, ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps, norm_d=None):
    """Kernel 3's launches: yq of whole rows; the ff1 tiles; DoubleSwish;
    each row's amax folded over its ff1 tiles by max; mq by the row scale;
    the ff2 tiles with the residual; BasicNorm of whole rows, its mean over
    the first norm_d columns (all where None)."""
    R, d, F = plan.R, plan.d, plan.F
    y = x + hseq
    yq, ys = LK._rowq8(y)
    acc = torch.full((R, F), float("nan"))
    for rows, cols in plan.tiles(F):
        acc[rows.start : rows.stop, cols.start : cols.stop] = _tile_dot(yq, ff1_q, rows, cols,
                                                                        plan.dp)
    assert not acc.isnan().any()
    mid = acc * (ys * ff1_s.reshape(1, -1)) + ff1_b.float().reshape(1, -1)
    mid = mid * sigmoid(mid - 1.0)
    amax = torch.zeros(R, 1)
    for rows, cols in plan.tiles(F):
        part = mid[rows.start : rows.stop, cols.start : cols.stop].abs().amax(dim=-1, keepdim=True)
        amax[rows.start : rows.stop] = torch.maximum(amax[rows.start : rows.stop], part)
    ms = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    mq = torch.round(mid * torch.reciprocal(ms))
    out = torch.full((R, d), float("nan"))
    for rows, cols in plan.tiles(d):
        r, c = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
        ff = (_tile_dot(mq, ff2_q, rows, cols, plan.fp) * (ms[r] * ff2_s.reshape(-1)[c])
              + ff2_b.float().reshape(-1)[c])
        out[r, c] = y[r, c] + ff
    assert not out.isnan().any()
    v = out if norm_d is None else out[:, :norm_d]
    return out * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps.float())


# (R, d, F): chip_smoke's ragged rows, the reference model, narrow and odd
# multiples of 4, rows over several tiles
CASES = [(3, 64, 128), (15, 68, 196), (300, 128, 256), (130, 96, 200), (257, 36, 52)]


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R, d, F", CASES)
def test_phases_equal_plain(R, d, F, bias_dtype):
    _, ffn = _layer(4, d, 4, F, bias_dtype)
    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.normal(size=(R, d)).astype(np.float32))
    hs = torch.from_numpy((rng.normal(size=(R, d)) * 0.5).astype(np.float32))
    got = emulate_ffn(LM.ffn_plan(R, d, F), x, hs, *ffn)
    want = LK.ffn_norm_plain(x, hs, *ffn)
    assert torch.equal(got, want), f"max abs diff {float((got - want).abs().max()):.3g}"
    # on CPU tensors both wrappers take the plain version
    assert torch.equal(LK.ffn_norm_i8(x, hs, *ffn), want)
    assert torch.equal(LK.ffn_norm_i8_simt(x, hs, *ffn), want)


@pytest.mark.parametrize("R, d, F", [(15, 66, 198), (40, 67, 129), (3, 62, 196)])
def test_phases_at_padded_widths(R, d, F):
    """Widths that are not multiples of 4: the weights zero-padded to the
    next multiples (as models/lstm_transducer.py `padded_layers` pads them),
    the rows likewise, the norm over d (`norm_d`): the model's widths equal
    `ffn_norm_plain` at the model's widths bit for bit, the padded columns
    zero."""
    _, ffn = _layer(4, d, 4, F, torch.bfloat16)
    dp, fp = round_up(d), round_up(F)
    ff1_q, ff1_s, ff1_b, ff2_q, ff2_s, ff2_b, eps = ffn
    padded = (zero_pad(ff1_q, (dp, fp)), zero_pad(ff1_s.reshape(1, F), (1, fp)),
              zero_pad(ff1_b.reshape(F), (fp,)), zero_pad(ff2_q, (fp, dp)),
              zero_pad(ff2_s.reshape(1, d), (1, dp)), zero_pad(ff2_b.reshape(d), (dp,)), eps)
    rng = np.random.default_rng(R)
    x = torch.from_numpy(rng.normal(size=(R, d)).astype(np.float32))
    hs = torch.from_numpy((rng.normal(size=(R, d)) * 0.5).astype(np.float32))
    xp, hp = zero_pad(x, (R, dp)), zero_pad(hs, (R, dp))
    got = emulate_ffn(LM.ffn_plan(R, dp, fp), xp, hp, *padded, norm_d=d)
    want = LK.ffn_norm_plain(x, hs, *ffn)
    assert torch.equal(got[:, :d], want) and not got[:, d:].any()
    assert torch.equal(LK.ffn_norm_i8(xp, hp, *padded, norm_d=d), got)
    with pytest.raises(ValueError, match="norm_d"):
        LK._norm_width(dp + 1, dp, "ffn_norm_i8")


def test_phases_match_jax_interpret():
    """Layer 1 of a quantized JAX model (bf16 biases, the serving form) over
    256 rows, against the JAX kernel in interpret mode."""
    dims = JM.TransducerDims(d_model=128, hidden=128, ffn=256, joiner_dim=128, vocab=128,
                             layers=2, decoder_groups=32, conv_channels=(4, 8, 8))
    jp = JM.init_transducer_params(jax.random.PRNGKey(9), dims)
    jp = JM.cast_weights(JM.quantize_weights(jp), jnp.bfloat16)
    tp = from_jax_params({k: np.asarray(v) for k, v in jp.items()})
    keys = TM.STEP_I8_KEYS[7:]
    rng = np.random.default_rng(12)
    R = 256
    x = rng.normal(size=(R, dims.d_model)).astype(np.float32)
    hs = (rng.normal(size=(R, dims.d_model)) * 0.5).astype(np.float32)
    want = JLP.ffn_norm_i8(jnp.asarray(x), jnp.asarray(hs), *(jp[k][1] for k in keys), block_r=128,
                           interpret=True)
    got = emulate_ffn(LM.ffn_plan(R, dims.d_model, dims.ffn), torch.from_numpy(x),
                      torch.from_numpy(hs), *(tp[k][1] for k in keys))
    _assert_ulp_close(got.numpy(), np.asarray(want), "y")


# -- the layer kernels at widths that are not multiples of 4 ----------------


def test_padded_layers_by_width():
    """Leaves at multiples of 4 are the model's own tensors; others are
    zero-padded copies (each of the four gate blocks of H columns on its
    own), derived once per weights dict; a padded layer holds the model's
    values at their places and zeros elsewhere."""
    for d, H, F in ((64, 128, 256), (68, 132, 196), (66, 130, 198), (67, 129, 197)):
        for precision in (None, "int8"):
            w = _runtime(d, H, F, precision).weights
            pw = TM.padded_layers(w)
            dp, Hp, Fp = round_up(d), round_up(H), round_up(F)
            assert set(pw) == set(TM.STEP_KEYS if precision is None else TM.STEP_I8_KEYS)
            if (dp, Hp, Fp) == (d, H, F):
                assert all(pw[k] is w[k] for k in pw)
                continue
            assert TM.padded_layers(w)["w_hr_t" if precision is None else "w_hr_t_q8"] is \
                pw["w_hr_t" if precision is None else "w_hr_t_q8"]  # derived once
            sizes = {"d": (d, dp), "H": (H, Hp), "F": (F, Fp), "4H": (4 * H, 4 * Hp)}
            for k, t in pw.items():
                axes = TM.LAYER_AXES[k]
                lead = tuple(t.shape[: t.ndim - len(axes)])
                assert t.shape == lead + tuple(sizes[a][1] if a in sizes else a for a in axes), k
                src = w[k]
                if axes and axes[-1] == "4H":  # gate blocks padded on their own
                    t = t.reshape(*t.shape[:-1], 4, Hp)[..., :H]
                    src = src.reshape(*src.shape[:-1], 4, H)
                    assert not pw[k].reshape(*pw[k].shape[:-1], 4, Hp)[..., H:].any(), k
                inner = t[tuple(slice(0, n) for n in src.shape)]
                assert torch.equal(inner, src), k
                assert int(torch.count_nonzero(t)) == int(torch.count_nonzero(src)), k


def _runtime(d, H, F, precision, layers=2):
    from april_asr_tpu_torch.api.model import apply_precision
    from april_asr_tpu_torch.models.export import make_model_parameters
    from april_asr_tpu_torch.models.loader import native_runtime
    from april_asr_tpu_torch.testing import default_tokens as t_tokens

    dims = TM.TransducerDims(d_model=d, hidden=H, ffn=F, joiner_dim=64, vocab=32, layers=layers,
                             decoder_groups=1, conv_channels=(4, 8, 8))
    p = TM.init_transducer_params(0, dims)
    return native_runtime("t", "", "en-us", make_model_parameters(dims, t_tokens(dims.vocab)),
                          dims, apply_precision(p, precision), "cpu")


@pytest.mark.parametrize("precision", [None, "bf16", "int8"])
@pytest.mark.parametrize("d, H, F", [(66, 130, 198), (68, 132, 196), (64, 128, 256)])
def test_stacks_run_the_kernels_at_every_width(d, H, F, precision, monkeypatch):
    """The encoder's chunk and one-step stacks call only the kernel
    wrappers, at widths that are multiples of 4 (the model's, padded where
    they are not) with the model's d_model as the norm's width, and give
    the plain layers' results at the model's widths (int8: to f32 ulps
    except isolated int8 rounding flips; f32 1e-5; bf16 the repo's bf16
    bound); `check_kernel_plans` plans them (a CPU runtime with the H100's
    SM count: the check reads shapes only)."""
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF

    rt = _runtime(d, H, F, precision)
    calls = []
    for name in ("lstm_layer_chunk_fused", "lstm_layer_fused", "lstm_layer_chunk_rec_stream2_i8",
                 "ffn_norm_i8", "lstm_layer_fused_i8"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, fn=fn, name=name, **kw: calls.append(
            (name, a[0].shape[-1], a[2].shape[-1], kw.get("norm_d"))) or fn(*a, **kw))
    w = rt.weights
    S, P, L = 3, 2, 2
    rng = np.random.default_rng(d)
    y = torch.from_numpy(rng.normal(size=(P, S, d)).astype(np.float32))
    h = torch.from_numpy((rng.normal(size=(L, S, d)) * 0.3).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(L, S, H)) * 0.3).astype(np.float32))
    can = torch.ones(P, S, dtype=torch.bool)
    can[1:, 1] = False
    gate = torch.tensor([True, False, True])
    got_c = TM.encoder_chunk(w, y, h, c, can)
    got_s = TM.encoder_recurrent(w, y[0], h, c, gate)
    q = precision == "int8"
    names = ({"lstm_layer_chunk_rec_stream2_i8", "ffn_norm_i8", "lstm_layer_fused_i8"} if q
             else {"lstm_layer_chunk_fused", "lstm_layer_fused"})
    assert {n for n, *_ in calls} == names
    dp, Hp = round_up(d), round_up(H)
    for name, width, third, norm_d in calls:  # third: c's width, or ff1's (kernel 3)
        assert width == dp and third == (round_up(F) if name == "ffn_norm_i8" else Hp), calls
        assert norm_d == (None if name == "lstm_layer_chunk_rec_stream2_i8" else d), calls
    # the plain layers at the model's widths, composed as the stacks compose them
    keys = TM.STEP_I8_KEYS if q else TM.STEP_KEYS
    n_pulls = can.to(torch.int32).sum(0, dtype=torch.int32)
    x, hs, cs = y, [], []
    for l in range(L):
        lw = [w[k][l] for k in keys]
        if q:
            hseq, hn, cn = LK.lstm_rec_plain(x, h[l], c[l], n_pulls, *lw[:7])
            x = LK.ffn_norm_plain(x.reshape(P * S, d), hseq.reshape(P * S, d),
                                  *lw[7:]).reshape(P, S, d)
        else:
            x, hn, cn = LF.lstm_layer_chunk_plain(x, h[l], c[l], *lw, n_pulls)
        hs.append(hn)
        cs.append(cn)
    want_c = (x, torch.stack(hs), torch.stack(cs))
    x, hs, cs = y[0], [], []
    for l in range(L):
        plain = LK.lstm_layer_fused_i8_plain if q else LF.lstm_layer_fused_plain
        x, hn, cn = plain(x, h[l], c[l], *(w[k][l] for k in keys), gate)
        hs.append(hn)
        cs.append(cn)
    want_s = (x, torch.stack(hs), torch.stack(cs))
    for got, want in ((got_c[1:], want_c[1:]), (got_s[1:], want_s[1:])):
        for g, wv in zip(got, want):
            assert g.shape == wv.shape
            if q:
                _assert_ulp_close(g.numpy(), wv.numpy(), "stack")
            else:
                atol, rtol = (1e-5, 1e-5) if precision is None else (5e-2, 1e-3)
                torch.testing.assert_close(g, wv, atol=atol, rtol=rtol)
    assert got_c[0].shape == (P, S, rt.dims.joiner_dim) and got_s[0].shape == (S, rt.dims.joiner_dim)
    ES.check_kernel_plans(rt, 256, 27, n_sm=132)


@pytest.fixture(scope="module")
def april66(tmp_path_factory):
    """A 2-layer random native .april at d 66 / H 130 / F 198, none a
    multiple of 4 (blank logit +2.0, as bench.py does), written by the JAX
    package."""
    dims = JM.TransducerDims(d_model=66, hidden=130, ffn=198, joiner_dim=64, vocab=64, layers=2,
                             decoder_groups=2, conv_channels=(4, 8, 8))
    p = JM.init_transducer_params(jax.random.PRNGKey(13), dims)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["join_b"] = p["join_b"].copy()
    p["join_b"][0] += 2.0
    path = str(tmp_path_factory.mktemp("d66") / "d66.april")
    j_save_april(path, dims, p, j_mmp(dims, default_tokens(dims.vocab)), name="d66", form="native")
    return path


@pytest.mark.parametrize("precision", [None, "int8"])
def test_d66_stream_matches_jax(april66, monkeypatch, precision):
    """The port's CPU engine against the JAX engine on the d = 66 model, 1 s
    chunks, 3 ticks and a flush (tests/test_torch_port_engine.py's check:
    fbank within kernel 1's or 5's bound, h/c within the stack bound, events,
    callbacks and decode state equal up to a near-tie). At f32 no session
    may part."""
    parted = _stream_parity(april66, monkeypatch, 16000, 3, precision)
    if precision is None:
        assert parted == {}
