"""Port: kernel 6 on the H100 (csrc/fbank_frames_tile.cu, planned by
ops/fbank_kernels.py `frames_plan`, its table laid out by `t6_stream`).

The kernel runs only on the card, where chip_smoke.py holds it bit for bit
to the CUDA-core kernel it displaces (`fbank_frames_simt`) and to its plain
version at the fbank bound. Here, on the CPU:

(a) `frames_plan` at the 16 kHz and 8 kHz layouts, S in {1, 3, 8, 256,
    2048}, F of the 200 ms and the 1 s chunk: a plan within the H100's
    232,448 bytes a block whose tiles cover every frame row once, the
    frames' row pitch an odd number of 16-byte runs, the row count that
    fills the SMs' waves best; shapes it cannot take (nfft 512 at 22,050
    Hz) have no plan, so they take `fbank_frames_simt`;
(b) the stage stream, read where the kernel reads it (`t6_columns`' slots),
    round-trips to `fbank_constants`' f32 DFT exactly;
(c) a plain-torch emulation of the kernel block by block (each block's rows
    staged at the kernel's pitch, the rows past the last frame never
    copied, each thread's rows tr + 4 i and columns by slot, one fmaf chain
    a (row, column) over the stream's stages in k order, the power of each
    thread's bins, the mel filter by filter over its own bins) equals, bit
    for bit, an emulation of csrc/fbank_bf16x3.cu `fbank_frames_kernel`'s
    order written from the plain version's tables (every k, every bin of
    every filter). The products are of two f32 values, so `fmaf` rounds
    once (`fmaf`, checked here against exact rationals, near-ties
    included). Both lie within the repo's fbank bound (atol 2e-5, rtol
    1e-4; tests/test_fbank_pallas.py) of `logmel_rows_fused_plain` and of
    the JAX kernel run with interpret=True;
(d) silent frames give exactly log(K_EPS).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.config import FbankOptions as JFbankOptions
from april_asr_tpu.frontend import fbank as jfb
from april_asr_tpu.ops import fbank_pallas as JFP
from april_asr_tpu_torch.config import FbankOptions
from april_asr_tpu_torch.frontend.fbank import FbankLayout
from april_asr_tpu_torch.frontend.oracle import K_EPS
from april_asr_tpu_torch.ops import cuda_build
from april_asr_tpu_torch.ops import fbank_kernels as FK
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

RATES = (16000, 8000)


def _consts(rate: int, seconds: float = 0.2):
    lay = FbankLayout.build(FbankOptions(sample_freq=rate), int(rate * seconds))
    return lay, FK.fbank_constants(lay, "cpu")


def _frames(lay, S: int, seed: int, scale: float = 0.25) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, scale, (S, lay.buf_len)) * 32768).clip(-32768, 32767).astype(np.int16)
    return FK.frames_from_buf(lay, torch.from_numpy(x.astype(np.float32) / 32768.0))


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fmaf, rounded once: a * b is exact in f64; c + a * b rounds in
    f64 and its error is exact (two-sum), which settles the one case the
    f64 rounding can mislead, a sum that lands on an f32 midpoint."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = c64 + p
    bp = s - c64
    err = (c64 - (s - bp)) + (p - bp)
    r = s.float()
    rd = r.double()
    toward = torch.where(s > rd, torch.tensor(float("inf")), torch.tensor(float("-inf")))
    nb = torch.nextafter(r, toward.float())
    at_mid = (s != rd) & (s == (rd + nb.double()) / 2)
    past = ((err > 0) & (nb.double() > rd)) | ((err < 0) & (nb.double() < rd))
    return torch.where(at_mid & past, nb, r)


def test_fmaf_rounds_once():
    f32 = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    # c + a b = 1 + 3 2^-24 - 2^-70: f64 rounds it onto the f32 midpoint,
    # whose tie goes to 1 + 2^-22; rounded once it is 1 + 2^-23
    a, b, c = f32(1 + 2.0 ** -23), f32(2.0 ** -24 * (1 - 2.0 ** -23)), f32(1 + 2.0 ** -23)
    assert float(fmaf(a, b, c)) == 1 + 2.0 ** -23
    assert float((c.double() + a.double() * b.double()).float()) == 1 + 2.0 ** -22
    rng = np.random.default_rng(0)
    n = 2000
    a = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=n) * 10.0 ** rng.integers(-8, 3, n)).astype(np.float32))
    got = fmaf(a, b, c)
    for x, y, z, r in zip(a.tolist(), b.tolist(), c.tolist(), got.tolist()):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        rt = torch.tensor([r], dtype=torch.float32)
        for nb in (torch.nextafter(rt, torch.tensor([np.inf], dtype=torch.float32)),
                   torch.nextafter(rt, torch.tensor([-np.inf], dtype=torch.float32))):
            d_r, d_nb = abs(exact - Fraction(r)), abs(exact - Fraction(float(nb)))
            assert d_r < d_nb or (d_r == d_nb and int(rt.view(torch.int32)) % 2 == 0)


# -- (a) the plan and the route ----------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seconds", (0.2, 1.0))
@pytest.mark.parametrize("S", (1, 3, 8, 256, 2048))
def test_frames_plan_covers_and_fits(rate, seconds, S):
    lay, c = _consts(rate, seconds)
    o = lay.opts
    F, padded, nfft = lay.max_frames, o.padded_window_size, o.num_fft_bins
    assert F == {0.2: 21, 1.0: 101}[seconds]
    plan = FK.frames_plan(S, F, padded, nfft)
    assert plan is not None and plan == FK.frames_plan_for(c, S, F)
    assert plan.rows in FK.T6_ROWS
    wr = 8 // (2 * nfft // 64)  # warp rows: 8 warps of 64 columns over 2 nfft
    assert plan.tile == wr * 4 * plan.rows
    assert plan.smem == FK.frames_smem(plan.tile, padded, nfft) <= cuda_build.SMEM_PER_BLOCK
    # the tiles: every frame row once, the last one ragged where S F is not
    # a multiple of the tile (S = 1 at 200 ms: one tile past 21 rows)
    assert plan.blocks * plan.tile >= S * F > (plan.blocks - 1) * plan.tile
    # the power rows (hi, lo) fit in the frames' space they reuse
    assert plan.tile * nfft * 2 <= plan.tile * (padded + 4)
    # a row pitch of padded + 4 floats: an odd number of 16-byte runs, so 4
    # consecutive rows' float4 reads fall in 4 bank groups
    assert ((padded + 4) // 4) % 2 == 1
    assert len({(r * (padded + 4) // 4) % 8 for r in range(4)}) == 4
    # no other row count fills the SMs' waves better
    n_sm = cuda_build.SM_COUNT
    waves = -(-plan.blocks // n_sm) * (plan.rows + 0.25)
    for R in FK.T6_ROWS:
        assert waves <= -(-(-(-S * F // (wr * 4 * R))) // n_sm) * (R + 0.25)


def test_frames_plan_at_the_engine_shapes():
    # S = 256 sessions of 1 s at 16 kHz: 924 tiles of 28 rows, seven waves
    plan = FK.frames_plan(256, 101, 512, 256)
    assert (plan.rows, plan.tile, plan.blocks) == (7, 28, 7 * cuda_build.SM_COUNT)
    # 8 kHz: two warp rows of 4 column warps each
    assert FK.frames_plan(256, 101, 256, 128).tile == 8 * FK.frames_plan(256, 101, 256, 128).rows


def test_frames_route_refuses_to_plan_what_the_kernel_cannot_take():
    o = FbankOptions(sample_freq=22050)
    lay = FbankLayout.build(o, 22050)
    c = FK.fbank_constants(lay, "cpu")
    assert c["nfft"] == 512
    assert FK.frames_plan_for(c, 8, lay.max_frames) is None  # so the CUDA-core kernel serves it
    assert FK.frames_plan(8, 101, 500, 256) is None  # padded not a multiple of a stage's 8 k
    assert FK.frames_plan(0, 101, 512, 256) is None


# -- (b) the table -------------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
def test_stream_round_trips_to_the_dft(rate):
    lay, c = _consts(rate)
    padded, nfft = c["padded"], c["nfft"]
    cols = FK.t6_columns(nfft)
    assert sorted(cols) == list(range(2 * nfft))  # every column once
    # slot 64 w + 8 j + t: column j of a thread; j even the re, j + 1 the im
    # of the same bin
    s = np.arange(2 * nfft)
    re = s[((s % 64) // 8) % 2 == 0]
    assert (cols[re] < nfft).all() and (cols[re + 8] == cols[re] + nfft).all()
    t6 = c["t6"]
    assert t6.dtype == torch.float32 and t6.is_contiguous()
    assert t6.shape == (padded // FK.T6_SK, 2, 2 * nfft, 4)
    st = t6.permute(0, 1, 3, 2).reshape(padded, 2 * nfft)  # k = 8 stage + 4 run + kk
    assert torch.equal(st, c["dft"][:, torch.from_numpy(cols)])


# -- (c) the kernel's order, emulated ----------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _log_mel(s1, s2, s3) -> torch.Tensor:
    return torch.log(torch.clamp_min((s1 + s2) + s3, float(K_EPS)))


def emulate(c: dict, frames: torch.Tensor) -> torch.Tensor:
    """Kernel 6 as csrc/fbank_frames_tile.cu computes it: rows [S, F, bins].
    Every block's rows go through the same per-element steps, so the blocks
    run side by side here: each block's tile of rows staged at the kernel's
    pitch (the rows past the last frame never copied: NaN, never stored);
    thread (warp row wr, tr)'s rows wr 4 R + tr + 4 i; per stage and run of 4
    k the slot's stream value, acc = fmaf(x, d, acc); then the power of
    each thread's bins by slot, and the mel filter by filter over its own
    bins."""
    S, F, padded = frames.shape
    nfft, bins = c["nfft"], c["bins"]
    plan = FK.frames_plan_for(c, S, F)
    M, pitch = plan.tile, padded + 4
    rows = frames.reshape(S * F, padded)
    staged = torch.full((plan.blocks, M * pitch), float("nan"))
    for blk in range(plan.blocks):
        nrows = min(M, S * F - blk * M)
        for r in range(nrows):
            staged[blk, r * pitch: r * pitch + padded] = rows[blk * M + r]
    # the tile's rows as the threads address them: row wr 4 R + tr + 4 i at
    # xs + (wr 4 R + tr) pitch + 4 i pitch
    R, wr_n = plan.rows, M // (4 * plan.rows)
    order = [wr * 4 * R + tr + 4 * i for wr in range(wr_n) for tr in range(4) for i in range(R)]
    assert sorted(order) == list(range(M))
    x = torch.stack([staged[:, r * pitch: r * pitch + padded] for r in range(M)], dim=1)
    x = x.reshape(plan.blocks * M, padded)
    n = x.shape[0]
    t6 = c["t6"]
    acc = torch.zeros((n, 2 * nfft))
    for t in range(padded // FK.T6_SK):
        for u in range(2):
            for kk in range(4):
                acc = fmaf(x[:, 8 * t + 4 * u + kk: 8 * t + 4 * u + kk + 1],
                           t6[t, u, :, kk], acc)
    cols = FK.t6_columns(nfft)
    s = np.arange(2 * nfft)
    rs = torch.from_numpy(s[((s % 64) // 8) % 2 == 0])  # a thread's column 2 q (re)
    re, im = acc[:, rs], acc[:, rs + 8]                   # and 2 q + 1 (im), 8 slots on
    p = re * re + im * im
    hi = _bf16(p)
    lo = _bf16(p - hi)
    ph, pl = torch.empty((n, nfft)), torch.empty((n, nfft))
    binsel = torch.from_numpy(cols[rs.numpy()])
    ph[:, binsel], pl[:, binsel] = hi, lo
    first, end = np.split(c["tc_mel_plan"].numpy()[:2 * bins], 2)
    mh, ml = c["mel_hi"].float(), c["mel_lo"].float()
    out = torch.empty((n, bins))
    for m in range(bins):
        s1, s2, s3 = (torch.zeros(n) for _ in range(3))
        for j in range(first[m], end[m]):
            s1 = s1 + ph[:, j] * mh[j, m]
            s2 = s2 + ph[:, j] * ml[j, m]
            s3 = s3 + pl[:, j] * mh[j, m]
        out[:, m] = _log_mel(s1, s2, s3)
    real = out[:S * F]
    assert not torch.isnan(real).any()
    return real.reshape(S, F, bins)


def simt_order(c: dict, frames: torch.Tensor) -> torch.Tensor:
    """csrc/fbank_bf16x3.cu `fbank_frames_kernel`'s order from the plain
    version's tables: each (row, column) one fmaf chain from +0 over k =
    0 .. padded - 1 on `c["dft"]` in its own column order, the power, and
    every bin of every mel filter."""
    S, F, padded = frames.shape
    nfft = c["nfft"]
    x = frames.reshape(S * F, padded)
    acc = torch.zeros((S * F, 2 * nfft))
    for k in range(padded):
        acc = fmaf(x[:, k:k + 1], c["dft"][k], acc)
    re, im = acc[:, :nfft], acc[:, nfft:]
    p = re * re + im * im
    hi = _bf16(p)
    lo = _bf16(p - hi)
    mh, ml = c["mel_hi"].float(), c["mel_lo"].float()
    s1, s2, s3 = (torch.zeros((S * F, c["bins"])) for _ in range(3))
    for j in range(nfft):
        s1 = s1 + hi[:, j:j + 1] * mh[j]
        s2 = s2 + hi[:, j:j + 1] * ml[j]
        s3 = s3 + lo[:, j:j + 1] * mh[j]
    return _log_mel(s1, s2, s3).reshape(S, F, -1)


@pytest.mark.parametrize("rate,seconds,S", [(16000, 0.2, 3), (16000, 0.2, 1), (8000, 0.2, 5)])
def test_emulation_equals_simt_order_and_lies_within_bound(rate, seconds, S):
    lay, c = _consts(rate, seconds)
    frames = _frames(lay, S, seed=rate + S)
    rows = emulate(c, frames)
    assert torch.equal(rows, simt_order(c, frames))
    want = FK.logmel_rows_fused_plain(c, frames)
    assert rows.shape == want.shape == (S, lay.max_frames, 80)
    torch.testing.assert_close(rows, want, atol=2e-5, rtol=1e-4)


def test_emulation_matches_jax_interpret():
    S, chunk = 4, 3200
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    lay, c = _consts(16000, 0.2)
    frames = _frames(lay, S, seed=5)
    want = np.asarray(JFP.logmel_rows_fused(jl, jnp.asarray(frames.numpy()), block_s=S,
                                            interpret=True))
    np.testing.assert_allclose(emulate(c, frames).numpy(), want, atol=2e-5, rtol=1e-4)


# -- (d) silence ----------------------------------------------------------------------


def test_silence_is_log_k_eps_exactly():
    lay, c = _consts(16000, 0.2)
    S, F = 3, lay.max_frames
    frames = _frames(lay, S, seed=9)
    frames[1] = 0.0  # a silent session between loud ones in the same tiles
    frames[2, ::2] = 0.0  # and silent frames among loud ones
    rows = emulate(c, frames)
    silent = torch.full((80,), float(torch.log(torch.tensor(K_EPS, dtype=torch.float32))))
    assert bool((rows[1] == silent).all()) and bool((rows[2, ::2] == silent).all())
    assert not bool((rows[2, 1::2] == silent).all(dim=-1).any())
    assert torch.equal(rows, simt_order(c, frames))
