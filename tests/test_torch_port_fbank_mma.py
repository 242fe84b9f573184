"""Port: kernel 1 on the H100 (csrc/fbank_mma.cu, planned by
ops/fbank_kernels.py `fbank_plan`, its tables laid out by `tc_tables`).

The kernel runs only on the card, where chip_smoke.py holds it bit for bit
to the CUDA-core kernel it displaces (`fbank_i8_simt`) and to its plain
version at the fbank bound. Here, on the CPU:

(a) the tables (the stage stream, the interleaved s_hi and corr)
    round-trip to `_folded_dft_i8`'s dhi / rlo / s_hi / corr, exactly, and
    `mel_bands` names every mel filter's weights and the chunk it ends in;
(b) `fbank_plan` at the 16 kHz and 8 kHz layouts, S in {1, 3, 256, 2048},
    F of the 200 ms and the 1 s chunk (the flush feeds its zero blocks
    through the same layout, so it runs the same F): a plan within the
    H100's 232,448 bytes a block whose tiles cover every frame row once and
    stage no more hop rows than it holds; a shift that is not a multiple of
    16 samples (220 at 22,050 Hz) has no plan, so it takes `fbank_i8_simt`;
(c) a plain-torch emulation of the kernel block by block (the hop rows
    staged at the kernel's pitches, each frame's window read through the
    kernel's k-offset tables, the tables read at the kernel's swizzled
    addresses, K = padded, the residual summed k by k, the mel filter by
    filter from the two-chunk power window): its int32 dots equal the plain
    version's `_int_dot` products exactly; its rows equal, bit for bit, an
    emulation of csrc/fbank_i8.cu's order written from the plain version's
    tables (every k of the whole views, every bin of every filter), and
    they are within the repo's fbank bound (atol 2e-5, rtol 1e-4;
    tests/test_fbank_pallas.py) of `logmel_rows_from_buf_i8_plain` and of
    the JAX kernel in interpret mode;
(d) silence gives exactly log(K_EPS); full-scale samples (+-32767, -32768,
    the edges of the floor split) stay inside the bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.config import FbankOptions as JFbankOptions
from april_asr_tpu.frontend import fbank as jfb
from april_asr_tpu.ops.fbank_pallas import logmel_rows_from_buf_i8 as j_logmel_i8
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


def _stage_bytes(tc: np.ndarray, n: np.ndarray, byte: np.ndarray) -> np.ndarray:
    """Bytes `byte` (of 128) of column row `n` in every stage, read where the
    kernel reads them: run byte // 16 sits at run (byte // 16) ^ (n % 8)."""
    return tc[..., n, ((byte // 16) ^ (n % 8)) * 16 + byte % 16]


def _stream(c: dict):
    """The stage stream decoded at the kernel's addresses: (dhi, rlo) as
    [K, 2 nfft] int8 and f32 in the interleaved column order."""
    tc = c["tc"].numpy()
    nch, K = tc.shape[0], c["padded"]
    s8 = K // 128
    n = np.arange(64)[None, :]
    d = _stage_bytes(tc[:, :s8], n, np.arange(128)[:, None]).view(np.int8)  # [nch, s8, 128, 64]
    d = d.reshape(nch, K, 64)
    # residual stages: k = 4 u + i of column n at byte 1024 u + 16 n + 4 i
    r = tc[:, s8:].reshape(nch, K // 32, 8, 64, 4, 4)  # [.., u, n, i, byte]
    r = np.ascontiguousarray(r.transpose(0, 1, 2, 4, 3, 5)).view(np.float32)[..., 0]
    r = r.reshape(nch, K, 64)
    return np.concatenate(list(d), axis=1), np.concatenate(list(r), axis=1)


def _bands(c: dict):
    bins = c["bins"]
    return np.split(c["tc_mel_plan"].numpy(), np.cumsum([bins, bins, bins]))


# -- (a) the tables ---------------------------------------------------------------


@pytest.mark.parametrize("rate", RATES)
def test_tc_tables_round_trip(rate):
    lay, c = _consts(rate)
    o = lay.opts
    dhi, rlo, s_hi, corr = FK._folded_dft_i8(o.padded_window_size, o.num_fft_bins,
                                             o.remove_dc_offset, o.preemph_coeff)
    perm = FK._interleave(o.num_fft_bins)
    assert sorted(perm) == list(range(2 * o.num_fft_bins))
    K = o.padded_window_size
    assert c["tc"].shape == (2 * o.num_fft_bins // 64, K // 128 + K // 32, 64, 128)
    d, r = _stream(c)
    np.testing.assert_array_equal(d, dhi[:, perm])
    np.testing.assert_array_equal(r, rlo[:, perm])
    np.testing.assert_array_equal(c["tc_shi"].numpy(), s_hi[perm])
    np.testing.assert_array_equal(c["tc_corr"].numpy(), corr[perm])
    # the swizzle is an involution and moves every run of a row exactly once
    tc = c["tc"].numpy()[:, :K // 128]
    np.testing.assert_array_equal(FK._swizzle(FK._swizzle(tc)), tc)


@pytest.mark.parametrize("rate", RATES + (22050,))
def test_mel_bands_hold_every_weight(rate):
    lay, c = _consts(rate)
    nfft, bins = c["nfft"], c["bins"]
    first, end, order, off = _bands(c)
    w = (c["mel_hi"].float() != 0) | (c["mel_lo"].float() != 0)
    per = FK.FB_NC // 2
    for m in range(bins):
        inside = torch.zeros(nfft, dtype=torch.bool)
        inside[first[m]:end[m]] = True
        assert not bool((w[:, m] & ~inside).any())  # no weight outside the band
        assert first[m] < end[m] and w[first[m], m] and w[end[m] - 1, m]
    chunk = (end - 1) // per
    assert sorted(order) == list(range(bins)) and list(off) == [
        int((chunk < k).sum()) for k in range(2 * nfft // FK.FB_NC + 1)]
    for k in range(len(off) - 1):
        assert all(chunk[m] == k for m in order[off[k]:off[k + 1]])
    assert c["tc_mel_span"] == max(chunk - first // per + 1) == 2


# -- (b) the plan and the route ----------------------------------------------------


def _tiles(plan, S, F, nv):
    """Each block's (first row, rows, sessions spanned, hop rows staged), as
    the kernel computes them."""
    out = []
    for blk in range(plan.blocks):
        R0 = blk * FK.FB_M
        nrows = min(FK.FB_M, S * F - R0)
        f0 = R0 % F
        n0 = min(F - f0, nrows)
        nseg = 1 + -(-(nrows - n0) // F)
        out.append((R0, nrows, nseg, nrows + nseg * (nv - 1)))
    return out


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("seconds", (0.2, 1.0))
@pytest.mark.parametrize("S", (1, 3, 256, 2048))
def test_fbank_plan_covers_and_fits(rate, seconds, S):
    lay, c = _consts(rate, seconds)
    o = lay.opts
    F = lay.max_frames
    assert F == {0.2: 21, 1.0: 101}[seconds]
    plan = FK.fbank_plan(S, F, o.window_shift, o.padded_window_size, o.num_fft_bins,
                         c["tc_mel_span"])
    assert plan is not None and plan == FK.plan_for(c, S, F)
    assert plan.smem <= cuda_build.SMEM_PER_BLOCK
    assert plan.smem == FK.fbank_smem(plan.hops, o.window_shift, o.padded_window_size)
    tiles = _tiles(plan, S, F, lay.n_views)
    assert sum(n for _, n, _, _ in tiles) == S * F
    assert [r0 for r0, *_ in tiles] == list(range(0, S * F, FK.FB_M))
    assert max(ns for _, _, ns, _ in tiles) <= min(S, (FK.FB_M - 2) // F + 2)
    assert max(h for *_, h in tiles) <= plan.hops
    # the pitches put 8 consecutive frames' 16-byte runs in 8 bank groups
    p8, pb = FK.fbank_pitches(o.window_shift)
    for pitch in (p8, 2 * pb):
        assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
        assert len({(f * pitch // 16) % 8 for f in range(8)}) == 8


def test_fbank_route_refuses_to_plan_what_the_kernel_cannot_take():
    o = FbankOptions(sample_freq=22050)
    assert o.window_shift == 220
    lay = FbankLayout.build(o, 22050)
    c = FK.fbank_constants(lay, "cpu")
    assert FK.plan_for(c, 8, lay.max_frames) is None  # so the CUDA-core kernel serves it
    # frames so few that one block's sessions overflow its shared memory
    assert FK.fbank_plan(256, 1, 160, 512, 256, 2) is None
    assert FK.fbank_plan(256, 4, 160, 512, 256, 2) is not None
    # a mel filter wider than the power window's two chunks
    assert FK.fbank_plan(8, 101, 160, 512, 256, 3) is None


# -- (c) the kernel's order, emulated ----------------------------------------------


def _split(x: torch.Tensor):
    pcm = x * 32768.0
    a = torch.floor(pcm * (1.0 / 256.0))
    b = torch.clamp(torch.round(pcm - 256.0 * a) - 128.0, -128.0, 127.0)
    return a, b, x.to(torch.bfloat16).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _log_mel(s1, s2, s3) -> torch.Tensor:
    return torch.log(torch.clamp_min((s1 + s2) + s3, float(K_EPS)))


def emulate(c: dict, buf: torch.Tensor, F: int):
    """Kernel 1 as csrc/fbank_mma.cu computes it, block by block: rows [S,
    F, bins] and the int32 dots of planes a and b, [S * F, 2 nfft] in the
    interleaved column order. Each product of the residual and the mel is
    exact in f32, so `acc + x * w` is the kernel's fmaf."""
    S, L = buf.shape
    shift, K, nfft, bins = c["shift"], c["padded"], c["nfft"], c["bins"]
    plan = FK.plan_for(c, S, F)
    p8, pb = FK.fbank_pitches(shift)
    nv, nbuf, M, per = c["n_views"], L // shift, FK.FB_M, FK.FB_NC // 2
    d_tab, r_tab = _stream(c)
    d_tab, r_tab = torch.from_numpy(d_tab).double(), torch.from_numpy(r_tab)
    first, end, order, off = _bands(c)
    mel_hi, mel_lo = c["mel_hi"].float(), c["mel_lo"].float()
    shi, corr = c["tc_shi"], c["tc_corr"]
    u8, ub = np.arange(K // 16), np.arange(K // 8)
    ko8 = (16 * u8 // shift) * p8 + 16 * u8 % shift
    kob = (8 * ub // shift) * pb + 8 * ub % shift
    win8 = torch.from_numpy((ko8[:, None] + np.arange(16)[None, :]).reshape(-1))
    winb = torch.from_numpy((kob[:, None] + np.arange(8)[None, :]).reshape(-1))
    rows = torch.empty((S * F, bins))
    ints = [torch.empty((S * F, 2 * nfft), dtype=torch.float64) for _ in range(2)]
    hops3 = buf.reshape(S, nbuf, shift)
    for blk in range(plan.blocks):
        R0 = blk * M
        nrows = min(M, S * F - R0)
        s0, f0 = divmod(R0, F)
        n0 = min(F - f0, nrows)
        seg0, segn = n0 + nv - 1, F + nv - 1
        hops = nrows + (1 + -(-(nrows - n0) // F)) * (nv - 1)
        assert hops <= plan.hops
        r = np.arange(hops)
        k = np.where(r >= seg0, (r - seg0) // segn, 0)
        sess = np.where(r >= seg0, s0 + 1 + k, s0)
        hop = np.where(r >= seg0, r - seg0 - k * segn, f0 + r)
        planes = []
        for plane, pitch in zip(_split(hops3[sess, hop]), (p8, p8, pb)):
            staged = torch.full((hops, pitch), float("nan"))  # pads are never read
            staged[:, :shift] = plane
            planes.append(staged.reshape(-1))
        i = np.arange(nrows)
        kq = np.maximum(i - n0, 0) // F
        hb = torch.from_numpy(np.where(i < n0, i, seg0 + kq * segn + (i - n0 - kq * F)))
        a = planes[0][hb[:, None] * p8 + win8[None, :]].double()  # [rows, K]
        b = planes[1][hb[:, None] * p8 + win8[None, :]].double()
        x = planes[2][hb[:, None] * pb + winb[None, :]]
        assert not (a.isnan().any() or b.isnan().any() or x.isnan().any())
        acc_a, acc_b = a @ d_tab, b @ d_tab  # exact: integers below 2^53
        ints[0][R0:R0 + nrows], ints[1][R0:R0 + nrows] = acc_a, acc_b
        hs = (acc_a.float() * 256.0 + acc_b.float() + corr) * shi
        rr = torch.zeros((nrows, 2 * nfft))
        for kk in range(K):  # the residual, k in order
            rr = rr + x[:, kk:kk + 1] * r_tab[kk]
        re, im = hs[:, 0::2] + rr[:, 0::2], hs[:, 1::2] + rr[:, 1::2]
        p = re * re + im * im
        hi = _bf16(p)
        lo = _bf16(p - hi)
        out = torch.empty((nrows, bins))
        for ch in range(len(off) - 1):  # the filters that end in chunk ch
            for m in order[off[ch]:off[ch + 1]]:
                assert first[m] >= per * (ch - 1)  # inside the power window
                s1, s2, s3 = (torch.zeros(nrows) for _ in range(3))
                for j in range(first[m], end[m]):
                    s1 = s1 + hi[:, j] * mel_hi[j, m]
                    s2 = s2 + hi[:, j] * mel_lo[j, m]
                    s3 = s3 + lo[:, j] * mel_hi[j, m]
                out[:, m] = _log_mel(s1, s2, s3)
        rows[R0:R0 + nrows] = out
    return rows.reshape(S, F, bins), ints


def simt_order(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """csrc/fbank_i8.cu's order from the plain version's tables: the whole
    views' K = n_views * shift (zero rows past padded) k by k, the original
    column order, every bin of every mel filter."""
    S, L = buf.shape
    shift, nfft = c["shift"], c["nfft"]
    b3 = buf.reshape(S, L // shift, shift)
    xcat = torch.cat([b3[:, v:v + F, :] for v in range(c["n_views"])], dim=-1)
    a, b, x = _split(xcat.reshape(S * F, -1))
    dhi, rlo = c["dhi"].double(), c["rlo"].float()
    rr = torch.zeros((S * F, 2 * nfft))
    for k in range(x.shape[1]):
        rr = rr + x[:, k:k + 1] * rlo[k]
    hre = (a.double() @ dhi).float() * 256.0 + (b.double() @ dhi).float() + c["corr"]
    spec = hre * c["s_hi"] + rr
    re, im = spec[:, :nfft], spec[:, nfft:]
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


def _plain_ints(c: dict, buf: torch.Tensor, F: int):
    """The plain version's two int8 dots ([S * F, 2 nfft], f64 exact)."""
    S, L = buf.shape
    shift = c["shift"]
    b3 = buf.reshape(S, L // shift, shift)
    xcat = torch.cat([b3[:, v:v + F, :] for v in range(c["n_views"])], dim=-1)
    a, b, _ = _split(xcat.reshape(S * F, -1))
    dhi = c["dhi"].double()
    return a.double() @ dhi, b.double() @ dhi


@pytest.mark.parametrize("rate,seconds,S", [(16000, 1.0, 3), (16000, 0.2, 8), (8000, 0.2, 7)])
def test_emulation_ints_exact_and_rows_within_bound(rate, seconds, S):
    lay, c = _consts(rate, seconds)
    F = lay.max_frames
    buf = _pcm_buf(S, lay.buf_len, seed=rate + S)
    rows, (ia, ib) = emulate(c, buf, F)
    pa, pb = _plain_ints(c, buf, F)
    perm = torch.from_numpy(FK._interleave(c["nfft"]))
    assert torch.equal(ia, pa[:, perm]) and torch.equal(ib, pb[:, perm])
    assert torch.equal(rows, simt_order(c, buf, F))
    want = FK.logmel_rows_from_buf_i8_plain(c, buf, F)
    assert rows.shape == want.shape == (S, F, 80)
    torch.testing.assert_close(rows, want, atol=2e-5, rtol=1e-4)


def test_emulation_matches_jax_interpret():
    chunk, S = 3200, 8
    jl = jfb.FbankLayout.build(JFbankOptions(), chunk)
    lay, c = _consts(16000, 0.2)
    buf = _pcm_buf(S, lay.buf_len, seed=5)
    want = np.asarray(j_logmel_i8(jl, jnp.asarray(buf.numpy()), interpret=True))
    rows, _ = emulate(c, buf, lay.max_frames)
    np.testing.assert_allclose(rows.numpy(), want, atol=2e-5, rtol=1e-4)


# -- (d) silence and full scale ------------------------------------------------------


def test_silence_is_log_k_eps_exactly():
    lay, c = _consts(16000, 0.2)
    S, F = 7, lay.max_frames
    buf = _pcm_buf(S, lay.buf_len, seed=9)
    buf[1::2] = 0.0  # silent sessions beside loud ones in the same tiles
    rows, _ = emulate(c, buf, F)
    silent = torch.full((F, 80), float(torch.log(torch.tensor(K_EPS, dtype=torch.float32))))
    for s in range(1, S, 2):
        assert torch.equal(rows[s], silent)
    assert torch.equal(rows, simt_order(c, buf, F))
    torch.testing.assert_close(rows, FK.logmel_rows_from_buf_i8_plain(c, buf, F), atol=2e-5,
                               rtol=1e-4)


def test_full_scale_samples_within_bound():
    lay, c = _consts(16000, 0.2)
    S, F = 3, lay.max_frames
    rng = np.random.default_rng(11)
    edge = np.array([32767, -32768, -32767, 32512, -256, 255, 0], np.float32)
    x = rng.choice(edge, size=(S, lay.buf_len)).astype(np.float32) / 32768.0
    buf = torch.from_numpy(x)
    rows, (ia, ib) = emulate(c, buf, F)
    pa, pb = _plain_ints(c, buf, F)
    perm = torch.from_numpy(FK._interleave(c["nfft"]))
    assert torch.equal(ia, pa[:, perm]) and torch.equal(ib, pb[:, perm])
    # the a-plane dot stays inside f32's exact integers and int32
    assert float(ia.abs().max()) < 2 ** 24
    assert torch.equal(rows, simt_order(c, buf, F))
    torch.testing.assert_close(rows, FK.logmel_rows_from_buf_i8_plain(c, buf, F), atol=2e-5,
                               rtol=1e-4)
