"""Port: kernel 5 on the H100 (csrc/fbank_bf16x3_tile.cu, planned by
ops/fbank_kernels.py `bf16x3_plan`, its tables laid out by `t5_stream`).

The kernel runs only on the card, where chip_smoke.py holds it bit for bit
to the CUDA-core kernel it displaces (`fbank_bf16x3_simt`) and to its plain
version at the fbank bound. Here, on the CPU:

(a) the stage stream, read where the kernel reads it (`t5_columns`' slots),
    round-trips to `fbank_constants`' d_hi / d_lo rows k < padded exactly,
    and the rows past padded that it leaves out are zero;
(b) `bf16x3_plan` at the 16 kHz and 8 kHz layouts, S in {1, 3, 8, 256,
    2048}, F of the 200 ms and the 1 s chunk: a plan within the H100's
    232,448 bytes a block whose tiles cover every frame row once and stage
    no more hop rows than it holds; shapes it cannot take (a hop that is not
    a multiple of 8 samples, 220 at 22,050 Hz; too few frames a session for
    a block's hop rows) have no plan, so they take `fbank_bf16x3_simt`;
(c) a plain-torch emulation of the kernel block by block (the hop rows
    staged at the kernel's pitch, each row's window read from them, the
    thread's rows tr + 4 i and columns by slot, the zero rows past padded
    skipped, a per-view partial added to a running sum at each view's end,
    the mel filter by filter over its own bins): a bf16 x bf16 product is
    exact in f32, so `acc + a * b` in f32 is the kernel's fmaf. Its rows
    equal, bit for bit, an emulation of csrc/fbank_bf16x3.cu's order written
    from the plain version's tables (every k of the whole views, every bin of
    every filter), and lie within the repo's fbank bound (atol 2e-5, rtol
    1e-4; tests/test_fbank_pallas.py) of `logmel_rows_from_buf_plain` and of
    the JAX kernel run with interpret=True;
(d) silence gives exactly log(K_EPS); full-scale samples stay inside the
    bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.config import FbankOptions as JFbankOptions
from april_asr_tpu.frontend import fbank as jfb
from april_asr_tpu.ops.fbank_pallas import logmel_rows_from_buf as j_logmel
from april_asr_tpu_torch.config import FbankOptions
from april_asr_tpu_torch.frontend.fbank import FbankLayout
from april_asr_tpu_torch.frontend.oracle import K_EPS
from april_asr_tpu_torch.ops import cuda_build
from april_asr_tpu_torch.ops import fbank_kernels as FK
from test_torch_port_lstm_mma_float import _one_thread  # noqa: F401 (the module's fixture)

RATES = (16000, 8000)


def _layout(rate: int, seconds: float) -> FbankLayout:
    return FbankLayout.build(FbankOptions(sample_freq=rate), int(rate * seconds))


def _consts(rate: int, seconds: float = 0.2):
    lay = _layout(rate, seconds)
    return lay, FK.fbank_constants(lay, "cpu")


def _pcm_buf(S: int, L: int, seed: int, scale: float = 0.25) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, scale, (S, L)) * 32768).clip(-32768, 32767).astype(np.int16)
    return torch.from_numpy(x.astype(np.float32) / 32768.0)


def _stream(c: dict) -> torch.Tensor:
    """The stage stream as the kernel reads it: [chunks, padded, 2 planes,
    T5_NC slots], k = 8 stage + 4 run + kk, plane 0 d_hi, 1 d_lo."""
    t5 = c["t5"]  # [chunks, stages, runs, planes, slots, kk]
    nch, nst = t5.shape[:2]
    return t5.permute(0, 1, 2, 5, 3, 4).reshape(nch, nst * FK.T5_SK, 2, FK.T5_NC)


def _pairs():
    """The slots of a chunk that hold a bin's re column (j = 0, 2 of a
    thread) and, in the same order, its im column (j + 1: 8 slots on)."""
    s = np.arange(FK.T5_NC)
    re = s[((s % 32) // 8) % 2 == 0]
    return re, re + 8


# -- (a) the tables ---------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
def test_stream_round_trips_to_the_dft_planes(rate):
    lay, c = _consts(rate)
    o = lay.opts
    padded, nfft = o.padded_window_size, o.num_fft_bins
    cols = FK.t5_columns(nfft)
    assert cols.shape == (2 * nfft // FK.T5_NC, FK.T5_NC)
    assert sorted(cols.reshape(-1)) == list(range(2 * nfft))  # every column once
    # slot 32 w + 8 j + t: the re (j even) and im (j + 1) of one bin
    re, im = _pairs()
    assert (cols[:, re] < nfft).all() and (cols[:, im] == cols[:, re] + nfft).all()
    st = _stream(c)
    assert c["t5"].dtype == torch.float32 and c["t5"].is_contiguous()
    assert c["t5"].shape == (cols.shape[0], padded // FK.T5_SK, 2, 2, FK.T5_NC, 4)
    for ch in range(cols.shape[0]):
        idx = torch.from_numpy(cols[ch])
        assert torch.equal(st[ch, :, 0], c["d_hi"][:padded][:, idx].float())
        assert torch.equal(st[ch, :, 1], c["d_lo"][:padded][:, idx].float())
    # the rows the stream leaves out are the whole views' zero padding
    K = lay.n_views * o.window_shift
    assert K > padded and c["d_hi"].shape[0] == K
    assert not c["d_hi"][padded:].float().any() and not c["d_lo"][padded:].float().any()


# -- (b) the plan and the route ----------------------------------------------------


def _tiles(plan, S, F, nv):
    """Each block's (first row, rows, hop rows staged), as the kernel computes
    them."""
    M = 4 * plan.rows
    out = []
    for blk in range(plan.blocks):
        R0 = blk * M
        nrows = min(M, S * F - R0)
        n0 = min(F - R0 % F, nrows)
        out.append((R0, nrows, nrows + (1 + -(-(nrows - n0) // F)) * (nv - 1)))
    return out


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seconds", (0.2, 1.0))
@pytest.mark.parametrize("S", (1, 3, 8, 256, 2048))
def test_bf16x3_plan_covers_and_fits(rate, seconds, S):
    lay, c = _consts(rate, seconds)
    o = lay.opts
    F = lay.max_frames
    assert F == {0.2: 21, 1.0: 101}[seconds]
    plan = FK.bf16x3_plan(S, F, o.window_shift, o.padded_window_size, o.num_fft_bins)
    assert plan is not None and plan == FK.bf16x3_plan_for(c, S, F)
    assert plan.rows in FK.T5_ROWS
    assert plan.smem <= cuda_build.SMEM_PER_BLOCK
    assert plan.smem == FK.bf16x3_smem(plan.rows, plan.hops, o.window_shift, o.num_fft_bins)
    M = 4 * plan.rows
    tiles = _tiles(plan, S, F, lay.n_views)
    assert sum(n for _, n, _ in tiles) == S * F
    assert [r0 for r0, *_ in tiles] == list(range(0, S * F, M))
    assert max(h for *_, h in tiles) <= plan.hops
    # a hop row's 2 pitch floats put 4 consecutive frames' float4 reads in 4
    # bank groups
    pitch = FK.t5_pitch(o.window_shift)
    assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert len({(f * 2 * pitch // 4) % 8 for f in range(4)}) == 4
    # no other row count fills the SMs' waves better
    n_sm = cuda_build.SM_COUNT
    waves = -(-plan.blocks // n_sm) * (plan.rows + 0.25)
    for R in FK.T5_ROWS:
        assert waves <= -(-(-(-S * F // (4 * R))) // n_sm) * (R + 0.25)


def test_bf16x3_plan_fills_the_waves_at_the_engine_shapes():
    # S = 256 sessions of 1 s: 924 tiles of 28 rows, seven waves of 132
    assert FK.bf16x3_plan(256, 101, 160, 512, 256).rows == 7
    assert FK.bf16x3_plan(256, 101, 160, 512, 256).blocks == 7 * cuda_build.SM_COUNT
    # S = 2048: 56 waves of 28-row tiles (7,388 tiles, the last wave 128)
    assert FK.bf16x3_plan(2048, 101, 160, 512, 256).rows == 7


def test_bf16x3_route_refuses_to_plan_what_the_kernel_cannot_take():
    o = FbankOptions(sample_freq=22050)
    assert o.window_shift == 220
    lay = FbankLayout.build(o, 22050)
    c = FK.fbank_constants(lay, "cpu")
    assert FK.bf16x3_plan_for(c, 8, lay.max_frames) is None  # so the CUDA-core kernel serves it
    # frames so few that one block's sessions overflow its shared memory
    assert FK.bf16x3_plan(256, 1, 160, 512, 256) is None
    assert FK.bf16x3_plan(256, 4, 160, 512, 256) is not None
    # nfft not a multiple of a chunk's 128 bins
    assert FK.bf16x3_plan(8, 101, 160, 512, 192) is None


# -- (c) the kernel's order, emulated ----------------------------------------------


def _split(x: torch.Tensor):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _log_mel(s1, s2, s3) -> torch.Tensor:
    return torch.log(torch.clamp_min((s1 + s2) + s3, float(K_EPS)))


def _windows(c: dict, buf: torch.Tensor, F: int):
    """Each block's staged hop rows read at the kernel's addresses: (x_hi,
    x_lo) [blocks * M, padded] (row 4 i + tr of a block at index
    block * M + tr + 4 i) and the tile rows that are real. A hop row holds
    2 pitch floats: per run of 4 samples, their x_hi then their x_lo."""
    S, L = buf.shape
    shift, padded, nv = c["shift"], c["padded"], c["n_views"]
    plan = FK.bf16x3_plan_for(c, S, F)
    M, pitch, nbuf = 4 * plan.rows, FK.t5_pitch(shift), L // shift
    hops3 = buf.reshape(S, nbuf, shift)
    k = np.arange(padded)
    kk = k % shift
    # a window's offsets in its hop rows, for x_hi (x_lo: 4 floats on)
    kofs = torch.from_numpy((k // shift) * 2 * pitch + 8 * (kk // 4) + kk % 4)
    xa, xb, real = [], [], []
    for blk in range(plan.blocks):
        R0 = blk * M
        nrows = min(M, S * F - R0)
        s0, f0 = divmod(R0, F)
        n0 = min(F - f0, nrows)
        seg0, segn = n0 + nv - 1, F + nv - 1
        hops = nrows + (1 + -(-(nrows - n0) // F)) * (nv - 1)
        assert hops <= plan.hops
        r = np.arange(hops)
        kk = np.where(r >= seg0, (r - seg0) // segn, 0)
        sess = np.where(r >= seg0, s0 + 1 + kk, s0)
        hop = np.where(r >= seg0, r - seg0 - kk * segn, f0 + r)
        staged = torch.full((hops, pitch // 4, 2, 4), float("nan"))  # pads are never read
        for p, plane in enumerate(_split(hops3[sess, hop])):
            staged[:, :shift // 4, p] = plane.reshape(hops, shift // 4, 4)
        staged = staged.reshape(-1)
        i = np.arange(M)  # tile row tr + 4 i is the thread (tr)'s i-th row
        q = np.maximum(i - n0, 0) // F
        hb = np.where(i < n0, i, seg0 + q * segn + (i - n0 - q * F))
        hb = torch.from_numpy(np.where(i < nrows, hb, 0) * 2 * pitch)  # rows past the tile: hop row 0
        idx = hb[:, None] + kofs[None, :]
        xa.append(staged[idx])
        xb.append(staged[idx + 4])
        real.append(torch.from_numpy(i < nrows))
    a, b = torch.cat(xa), torch.cat(xb)
    assert not (a.isnan().any() or b.isnan().any())
    return a, b, torch.cat(real), plan


def emulate(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Kernel 5 as csrc/fbank_bf16x3_tile.cu computes it: rows [S, F, bins].
    Every block's rows go through the same per-element steps, so the blocks
    run side by side here: per chunk of slots, for each stage and run of 4
    k, pre = fmaf(b, dh, fmaf(a, dl, fmaf(a, dh, pre))), k < padded only;
    acc = acc + pre where a view ends (or the window, at padded); then the
    power of each thread's bins by slot, and the mel filter by filter over
    its own bins."""
    S, _ = buf.shape
    shift, padded, nfft, bins = c["shift"], c["padded"], c["nfft"], c["bins"]
    a, b, real, plan = _windows(c, buf, F)
    st = _stream(c)
    cols = FK.t5_columns(nfft)
    n = a.shape[0]
    ph, pl = torch.zeros((n, nfft)), torch.zeros((n, nfft))
    for ch in range(cols.shape[0]):
        acc = torch.zeros((n, FK.T5_NC))
        pre = torch.zeros((n, FK.T5_NC))
        kin = 0
        for k in range(padded):
            dh, dl = st[ch, k, 0], st[ch, k, 1]
            x, y = a[:, k:k + 1], b[:, k:k + 1]
            pre = ((pre + x * dh) + x * dl) + y * dh
            kin += 1
            if kin == shift or k == padded - 1:  # a view ends
                acc = acc + pre
                pre = torch.zeros_like(pre)
                kin = 0
        rs, ims = _pairs()  # a thread's columns j (re) and j + 1 (im) of one bin
        re, im = acc[:, torch.from_numpy(rs)], acc[:, torch.from_numpy(ims)]
        p = re * re + im * im
        hi = _bf16(p)
        lo = _bf16(p - hi)
        binsel = torch.from_numpy(cols[ch, rs])
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
    return out[real].reshape(S, F, bins)


def simt_order(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """csrc/fbank_bf16x3.cu's order from the plain version's tables: the
    whole views' K = n_views * shift (zero rows past padded) k by k, the
    original column order, every bin of every mel filter."""
    S, L = buf.shape
    shift, nfft = c["shift"], c["nfft"]
    b3 = buf.reshape(S, L // shift, shift)
    xcat = torch.cat([b3[:, v:v + F, :] for v in range(c["n_views"])], dim=-1)
    a, b = _split(xcat.reshape(S * F, -1))
    dh_all, dl_all = c["d_hi"].float(), c["d_lo"].float()
    acc = torch.zeros((S * F, 2 * nfft))
    for v in range(c["n_views"]):
        pre = torch.zeros((S * F, 2 * nfft))
        for k in range(v * shift, (v + 1) * shift):
            x, y = a[:, k:k + 1], b[:, k:k + 1]
            pre = ((pre + x * dh_all[k]) + x * dl_all[k]) + y * dh_all[k]
        acc = acc + pre
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


@pytest.mark.parametrize("rate,seconds,S", [(16000, 1.0, 3), (16000, 0.2, 8), (8000, 0.2, 7)])
def test_emulation_equals_simt_order_and_lies_within_bound(rate, seconds, S):
    lay, c = _consts(rate, seconds)
    F = lay.max_frames
    buf = _pcm_buf(S, lay.buf_len, seed=rate + S)
    rows = emulate(c, buf, F)
    assert torch.equal(rows, simt_order(c, buf, F))
    want = FK.logmel_rows_from_buf_plain(c, buf, F)
    assert rows.shape == want.shape == (S, F, 80)
    torch.testing.assert_close(rows, want, atol=2e-5, rtol=1e-4)


def test_emulation_matches_jax_interpret():
    chunk, S = 3200, 8
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    lay, c = _consts(16000, 0.2)
    buf = _pcm_buf(S, lay.buf_len, seed=5)
    want = np.asarray(j_logmel(jl, jnp.asarray(buf.numpy()), interpret=True))
    rows = emulate(c, buf, lay.max_frames)
    np.testing.assert_allclose(rows.numpy(), want, atol=2e-5, rtol=1e-4)


# -- (d) silence and full scale ------------------------------------------------------


def test_silence_is_log_k_eps_exactly():
    lay, c = _consts(16000, 0.2)
    S, F = 7, lay.max_frames
    buf = _pcm_buf(S, lay.buf_len, seed=9)
    buf[1::2] = 0.0  # silent sessions beside loud ones in the same tiles
    rows = emulate(c, buf, F)
    silent = torch.full((F, 80), float(torch.log(torch.tensor(K_EPS, dtype=torch.float32))))
    for s in range(1, S, 2):
        assert torch.equal(rows[s], silent)
    assert torch.equal(rows, simt_order(c, buf, F))
    torch.testing.assert_close(rows, FK.logmel_rows_from_buf_plain(c, buf, F), atol=2e-5,
                               rtol=1e-4)


def test_full_scale_samples_within_bound():
    lay, c = _consts(16000, 0.2)
    S, F = 3, lay.max_frames
    rng = np.random.default_rng(11)
    edge = np.array([32767, -32768, -32767, 32512, -256, 255, 0], np.float32)
    x = rng.choice(edge, size=(S, lay.buf_len)).astype(np.float32) / 32768.0
    buf = torch.from_numpy(x)
    rows = emulate(c, buf, F)
    assert torch.isfinite(rows).all()
    assert torch.equal(rows, simt_order(c, buf, F))
    torch.testing.assert_close(rows, FK.logmel_rows_from_buf_plain(c, buf, F), atol=2e-5,
                               rtol=1e-4)
