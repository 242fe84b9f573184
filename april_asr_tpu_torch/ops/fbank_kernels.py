"""Kernels 1 and 5: the fbank frame DSP (hop-row buffer -> log-mel rows).

Frames are formed from the hop rows of each session's sample buffer; the DC
removal, pre-emphasis and Povey window are folded into the DFT matrix in
float64 (`_folded_dft`). Two kernels compute the spectrum from there:

Kernel 1, port of `logmel_rows_from_buf_i8` (april_asr_tpu/ops/
fbank_pallas.py, `_buf_kernel_i8`), for int8 engines. PCM16 samples split exactly into
two int8 planes (a = floor(p/256), b = rint(p - 256a) - 128) that contract
with the int8 hi plane of the folded DFT in exact int32; the hi plane's
residual is one bf16 dot with f32 accumulation. Then the power spectrum, the
bf16x3 mel projection (`_dot3`) and log(max(K_EPS, .)). On the card the int8
planes run on the tensor cores and the residual and the mel on the CUDA
cores in csrc/fbank_i8.cu's order (csrc/fbank_mma.cu, planned by
`fbank_plan`, its tables laid out by `tc_tables`); shapes no plan holds take
the CUDA-core kernel `fbank_i8_simt` (csrc/fbank_i8.cu). The two give the
same rows, bit for bit.

Kernel 5, port of `logmel_rows_from_buf` (`_buf_kernel`), for every other
engine. Per hop-row view, the samples split exactly into bf16 hi/lo planes
and contract with the bf16 hi/lo planes of the zero-padded folded DFT, the
lo*lo term dropped (`_dot3`); the view sums add up in view order. Then the
same power, bf16x3 mel projection and log. On the card every sum is a fmaf
chain on the CUDA cores in csrc/fbank_bf16x3.cu's order, over tiles of
frame rows read from the staged hop rows (csrc/fbank_bf16x3_tile.cu, planned
by `bf16x3_plan`, its tables laid out by `t5_stream`); shapes no plan holds
take the CUDA-core kernel `fbank_bf16x3_simt` (csrc/fbank_bf16x3.cu). The
two give the same rows, bit for bit.

Kernel 6, port of `logmel_rows_fused` (`_kernel`), the same DSP on frames
formed beforehand ([S, F, padded], `frames_from_buf`): one full-f32 product
with the folded DFT (HIGHEST on the TPU), then the same power, mel and log.
The frontend takes it only for a buffer too short for in-kernel framing,
which no `FbankLayout.build` layout gives (frontend/fbank.py). On the card
each (row, column) is one fmaf chain over k in order, over tiles of frame
rows (csrc/fbank_frames_tile.cu, planned by `frames_plan`, its table laid
out by `t6_stream`); shapes no plan holds take the CUDA-core kernel
`fbank_frames_simt` (csrc/fbank_bf16x3.cu `fbank_frames`). The two give the
same rows, bit for bit.

As in the JAX package, the frontend takes kernels 1, 5 and 6 only where
`fused_supported` holds (S a multiple of 8); at other S it computes the f32
DFT with plain products (frontend/fbank.py `_frame_dsp`).

Each dispatcher takes the plain PyTorch version for a CPU tensor and
launches its CUDA kernel (csrc/fbank_mma.cu or csrc/fbank_i8.cu,
csrc/fbank_bf16x3_tile.cu or csrc/fbank_bf16x3.cu, csrc/fbank_frames_tile.cu
or csrc/fbank_bf16x3.cu) for a CUDA tensor; it never falls back.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..frontend.oracle import K_EPS, mel_banks, povey_window
from . import cuda_build


@functools.lru_cache(maxsize=8)
def _folded_dft(padded: int, nfft: int, remove_dc: bool, preemph: float) -> np.ndarray:
    """[padded, 2*nfft] f32: the Povey-windowed real DFT with pre-emphasis
    (data[0] quirk) and DC removal folded in, built in float64."""
    t = np.arange(padded, dtype=np.float64)[:, None]
    k = np.arange(nfft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / padded
    dft = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    m = np.asarray(povey_window(padded), np.float64)[:, None] * dft
    if preemph > 0.0:
        P = np.eye(padded) - preemph * np.eye(padded, k=-1)
        P[0, 0] = 1.0 - preemph
        m = P.T @ m
    if remove_dc:
        m = m - np.mean(m, axis=0, keepdims=True)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _folded_dft_i8(padded: int, nfft: int, remove_dc: bool, preemph: float):
    """(dhi int8 [padded, 2nfft], rlo f32 [padded, 2nfft] holding bf16
    values, s_hi f32 [2nfft], corr f32 [2nfft]) with
    x @ D == (x*32768 @ dhi) * s_hi + x @ rlo up to rlo's bf16 rounding;
    corr = 128 * colsum(dhi) undoes the b plane's -128 offset."""
    dft = _folded_dft(padded, nfft, remove_dc, preemph).astype(np.float64)
    s_raw = np.maximum(np.abs(dft).max(axis=0), 1e-30) / 127.0
    dhi = np.round(dft / s_raw)
    rlo = (dft - dhi * s_raw).astype(np.float32)
    rlo = torch.from_numpy(rlo).to(torch.bfloat16).float().numpy()
    s_hi = (s_raw / 32768.0).astype(np.float32)
    corr = (128.0 * dhi.sum(axis=0)).astype(np.float32)
    return dhi.astype(np.int8), rlo, s_hi, corr


def _split_bf16(w: np.ndarray):
    hi = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(torch.bfloat16)
    lo = (torch.from_numpy(np.ascontiguousarray(w, np.float32)) - hi.float()).to(torch.bfloat16)
    return hi, lo


# Kernel 1 on the H100 (csrc/fbank_mma.cu): a block takes FB_M frame
# rows, streams the DFT tables through FB_RING stages of FB_STAGE bytes, each
# [FB_NC columns][128 bytes of k], and keeps two chunks' power bins in rows of
# FB_PW bf16.
FB_M, FB_NC, FB_STAGE, FB_RING, FB_PW = 128, 64, 8192, 4, 72


def _interleave(nfft: int) -> np.ndarray:
    """Column order of csrc/fbank_mma.cu's tables: bin j's re column (j) at 2j,
    its im column (nfft + j) at 2j + 1."""
    perm = np.empty(2 * nfft, np.int64)
    perm[0::2] = np.arange(nfft)
    perm[1::2] = nfft + np.arange(nfft)
    return perm


def _swizzle(rows: np.ndarray) -> np.ndarray:
    """[..., 64, 128] bytes -> the same rows with 16-byte run x of row n
    stored at run x ^ (n % 8) (an involution: it also undoes itself)."""
    n = np.arange(rows.shape[-2])[:, None]
    runs = rows.reshape(*rows.shape[:-1], 8, 16)
    idx = (np.arange(8)[None, :] ^ (n % 8))[..., None]
    return np.take_along_axis(runs, np.broadcast_to(idx, runs.shape), axis=-2).reshape(rows.shape)


def mel_bands(mel_hi: torch.Tensor, mel_lo: torch.Tensor) -> tuple:
    """The mel filters' bands for csrc/fbank_mma.cu, from their bf16 planes
    [nfft, bins]: (int32 [bins] first bin, [bins] end bin, [bins] the mel
    bins by the chunk of FB_NC // 2 bins their filter ends in, [chunks + 1]
    offsets into that order; and the most chunks one filter spans). A filter
    with no weight is empty and ends in chunk 0."""
    nz = ((mel_hi.float() != 0) | (mel_lo.float() != 0)).numpy()
    nfft, bins = nz.shape
    some = nz.any(axis=0)
    first = np.where(some, nz.argmax(axis=0), 0)
    end = np.where(some, nfft - nz[::-1].argmax(axis=0), 0)
    per = FB_NC // 2
    chunk = np.where(some, (end - 1) // per, 0)
    span = int(np.where(some, chunk - first // per + 1, 1).max())
    order = np.argsort(chunk, kind="stable")
    off = np.searchsorted(chunk[order], np.arange(2 * nfft // FB_NC + 1))
    return np.concatenate([first, end, order, off]).astype(np.int32), span


def tc_tables(dhi, rlo, s_hi, corr, mel_hi, mel_lo) -> dict:
    """Kernel 1's tables for csrc/fbank_mma.cu, from `_folded_dft_i8`'s
    (dhi [K, 2nfft] int8, rlo [K, 2nfft] f32 holding bf16, s_hi, corr) at
    K = padded and the mel filters' bf16 planes [nfft, bins]:

      tc      [nfft / 32 chunks][K / 128 + K / 32 stages][64][128] uint8:
              per chunk of 64 interleaved columns (`_interleave`), the int8
              stages (128 k of dhi a column row, k-contiguous, `_swizzle`d)
              then the residual's (32 k of rlo as f32, as [8 runs of 4 k][64
              columns][4 k]);
      tc_shi, tc_corr  s_hi and corr in the interleaved column order;
      tc_mel_plan  `mel_bands`' int32 table, and tc_mel_span its span."""
    K, N2 = dhi.shape
    perm = _interleave(N2 // 2)
    d = np.ascontiguousarray(dhi[:, perm].T).view(np.uint8)                        # [N2, K]
    r = np.ascontiguousarray(np.asarray(rlo, np.float32)[:, perm].T).view(np.uint8)  # [N2, 4K]
    nch = N2 // FB_NC
    d = d.reshape(nch, FB_NC, K // 128, 128).transpose(0, 2, 1, 3)
    r = r.reshape(nch, FB_NC, K // 32, 8, 16).transpose(0, 2, 3, 1, 4).reshape(
        nch, K // 32, FB_NC, 128)
    tc = np.concatenate([_swizzle(d), r], axis=1)
    plan, span = mel_bands(mel_hi, mel_lo)
    return {
        "tc": np.ascontiguousarray(tc),
        "tc_shi": np.ascontiguousarray(np.asarray(s_hi, np.float32).reshape(-1)[perm]),
        "tc_corr": np.ascontiguousarray(np.asarray(corr, np.float32).reshape(-1)[perm]),
        "tc_mel_plan": plan,
        "tc_mel_span": span,
    }


def fbank_pitches(shift: int) -> tuple:
    """Kernel 1's hop-row pitches (int8 bytes, bf16 elements): the hop
    length, or 16 bytes more, whichever is an odd number of 16-byte runs,
    so that 8 consecutive frames' runs fill 8 distinct bank groups."""
    return (shift if (shift // 16) % 2 else shift + 16, shift if (shift // 8) % 2 else shift + 8)


@dataclasses.dataclass(frozen=True)
class FbankPlan:
    hops: int    # most hop rows a block stages
    smem: int    # dynamic shared memory a block
    blocks: int


def fbank_smem(hops: int, shift: int, padded: int) -> int:
    """csrc/fbank_mma.cu `fbank_smem`: the ring, the power window (hi, lo),
    the three sample planes and the two k-offset tables."""
    p8, pb = fbank_pitches(shift)
    return (FB_RING * FB_STAGE + 2 * FB_M * FB_PW * 2 + hops * (2 * pb + 2 * p8)
            + 4 * (padded // 16 + padded // 8))


@functools.lru_cache(maxsize=None)
def fbank_plan(S: int, F: int, shift: int, padded: int, nfft: int, mel_span: int
               ) -> Optional[FbankPlan]:
    """Kernel 1's launch on csrc/fbank_mma.cu for S sessions of F frames, or
    None where the kernel does not take the shapes (a shift that is not a
    multiple of 16 samples, padded not a multiple of 128, nfft not of 32, a
    mel filter over more than the two chunks of bins its power window holds:
    `mel_bands`' span) or a block cannot hold the hop rows of its tile: FB_M
    rows span at most (FB_M - 2) // F + 2 sessions, each staging n_views - 1
    hop rows beyond its frames."""
    if S < 1 or F < 1 or shift % 16 or padded % 128 or nfft % 32 or mel_span > 2:
        return None
    n_views = -(-padded // shift)
    sessions = min(S, (FB_M - 2) // F + 2)
    hops = FB_M + sessions * (n_views - 1)
    smem = fbank_smem(hops, shift, padded)
    if smem > cuda_build.SMEM_PER_BLOCK:
        return None
    return FbankPlan(hops, smem, -(-S * F // FB_M))


def plan_for(c: dict, S: int, F: int) -> Optional[FbankPlan]:
    """`fbank_plan` for the layout's constants `c`."""
    return fbank_plan(S, F, c["shift"], c["padded"], c["nfft"], c["tc_mel_span"])


# Kernel 5 on the H100 (csrc/fbank_bf16x3_tile.cu): a block of 8 warps and
# a producer warp takes 4 R frame rows (R one of T5_ROWS, chosen by
# `bf16x3_plan`), streams the DFT tables through T5_RING stages of T5_STAGE
# bytes, each [2 runs of 4 k][d_hi, d_lo][T5_NC columns][4 k] f32 (T5_SK k a
# stage), behind T5_BARS bytes of mbarriers.
T5_NC, T5_SK, T5_STAGE, T5_RING, T5_BARS, T5_ROWS = 256, 8, 16384, 4, 128, (6, 7)


def t5_columns(nfft: int) -> np.ndarray:
    """[chunks, T5_NC] DFT column of each slot of csrc/fbank_bf16x3_tile.cu's
    stages: slot 32 w + 8 j + t of chunk c is warp w's column j of thread
    t, the re (j even) or im (j odd) column of bin 128 c + 16 w + 8 (j // 2)
    + t."""
    s = np.arange(T5_NC)
    w, j, t = s // 32, (s % 32) // 8, s % 8
    bins = np.arange(2 * nfft // T5_NC)[:, None] * (T5_NC // 2) + 16 * w + 8 * (j // 2) + t
    return np.where(j % 2 == 0, bins, nfft + bins)


def t5_stream(d_hi: torch.Tensor, d_lo: torch.Tensor, padded: int) -> np.ndarray:
    """Kernel 5's table stream for csrc/fbank_bf16x3_tile.cu from the bf16
    planes [K, 2 nfft] of the zero-padded folded DFT: rows k < padded only
    (the rest are zero), widened to f32, as [chunks][padded / T5_SK stages][2
    runs][d_hi, d_lo][T5_NC slots (`t5_columns`)][4 k]."""
    planes = np.stack([d_hi[:padded].float().numpy(), d_lo[:padded].float().numpy()])
    cols = t5_columns(planes.shape[2] // 2)                                   # [nch, NC]
    x = planes[:, :, cols]                                                    # [2, padded, nch, NC]
    x = x.reshape(2, padded // T5_SK, 2, 4, cols.shape[0], T5_NC)             # [p, st, u, kk, ch, s]
    return np.ascontiguousarray(x.transpose(4, 1, 2, 0, 5, 3))


def t5_pitch(shift: int) -> int:
    """Kernel 5's hop-row pitch in floats of a plane: the hop length, or 4
    more, whichever is an odd number of 16-byte runs. A staged hop row holds
    both planes (per run of 4 samples, x_hi then x_lo: 2 pitch floats), so
    4 consecutive frames' float4 reads fall in 4 distinct bank groups."""
    return shift if (shift // 4) % 2 else shift + 4


@dataclasses.dataclass(frozen=True)
class Bf16x3Plan:
    rows: int    # R: rows a thread holds; a block takes 4 R frame rows
    hops: int    # most hop rows a block stages
    smem: int    # dynamic shared memory a block
    blocks: int


def bf16x3_smem(rows: int, hops: int, shift: int, nfft: int) -> int:
    """csrc/fbank_bf16x3_tile.cu `t5_smem`: the ring's mbarriers, the ring,
    the two sample planes and the power rows (hi, lo), all f32."""
    return T5_BARS + T5_RING * T5_STAGE + 2 * 4 * (hops * t5_pitch(shift) + 4 * rows * nfft)


@functools.lru_cache(maxsize=None)
def bf16x3_plan(S: int, F: int, shift: int, padded: int, nfft: int) -> Optional[Bf16x3Plan]:
    """Kernel 5's launch on csrc/fbank_bf16x3_tile.cu for S sessions of F
    frames, or None where the kernel does not take the shapes (a shift or a
    padded window that is not a multiple of T5_SK samples, nfft not a
    multiple of T5_NC / 2) or no block holds the hop rows of its tile. Of the
    row counts T5_ROWS whose tiles fit, the one whose tiles fill the H100's
    SMs' waves best: the least waves x (R + 1/4), the quarter a tile's
    staging and mel; on a tie the larger R (fewer table reads). 4 R rows
    span at most (4 R - 2) // F + 2 sessions, each staging n_views - 1 hop
    rows beyond its frames."""
    if S < 1 or F < 1 or shift % T5_SK or padded % T5_SK or nfft % (T5_NC // 2):
        return None
    n_views = -(-padded // shift)
    best, best_cost = None, None
    for R in T5_ROWS:
        M = 4 * R
        hops = M + min(S, (M - 2) // F + 2) * (n_views - 1)
        smem = bf16x3_smem(R, hops, shift, nfft)
        if smem > cuda_build.SMEM_PER_BLOCK:
            continue
        blocks = -(-S * F // M)
        cost = -(-blocks // cuda_build.SM_COUNT) * (R + 0.25)
        if best_cost is None or cost <= best_cost:
            best, best_cost = Bf16x3Plan(R, hops, smem, blocks), cost
    return best


def bf16x3_plan_for(c: dict, S: int, F: int) -> Optional[Bf16x3Plan]:
    """`bf16x3_plan` for the layout's constants `c`."""
    return bf16x3_plan(S, F, c["shift"], c["padded"], c["nfft"])


# Kernel 6 on the H100 (csrc/fbank_frames_tile.cu): a block of 8 warps and
# a producer warp takes WR x 4 R frame rows (R one of T6_ROWS, chosen by
# `frames_plan`; WR = 8 / (2 nfft / 64) warp rows; R = 10 spills at the 168
# registers a thread of a 9-warp block has), streams the f32 DFT
# through T6_RING stages of T6_SK k ([2 runs of 4 k][2 nfft slots][4 k])
# behind T6_BARS bytes of mbarriers.
T6_SK, T6_RING, T6_BARS, T6_ROWS, T6_NFFT = 8, 4, 128, (6, 7, 8, 9), (128, 256)


def t6_columns(nfft: int) -> np.ndarray:
    """[2 nfft] DFT column of each slot of csrc/fbank_frames_tile.cu's stages:
    slot 64 w + 8 j + t is warp column w's column j of thread t, the re (j
    even) or im (j odd) column of bin 32 w + 8 (j // 2) + t."""
    s = np.arange(2 * nfft)
    w, j, t = s // 64, (s % 64) // 8, s % 8
    bins = 32 * w + 8 * (j // 2) + t
    return np.where(j % 2 == 0, bins, nfft + bins)


def t6_stream(dft: np.ndarray) -> np.ndarray:
    """Kernel 6's table stream for csrc/fbank_frames_tile.cu from the folded
    DFT [padded, 2 nfft] f32: [padded / T6_SK stages][2 runs][2 nfft slots
    (`t6_columns`)][4 k]."""
    padded, n2 = dft.shape
    x = np.asarray(dft, np.float32)[:, t6_columns(n2 // 2)]       # [padded, slots]
    x = x.reshape(padded // T6_SK, 2, 4, n2)                      # [st, u, kk, s]
    return np.ascontiguousarray(x.transpose(0, 1, 3, 2))


@dataclasses.dataclass(frozen=True)
class FramesPlan:
    rows: int    # R: rows a thread holds; a block takes tile = WR x 4 R frame rows
    tile: int    # frame rows a block
    smem: int    # dynamic shared memory a block
    blocks: int


def frames_smem(tile: int, padded: int, nfft: int) -> int:
    """csrc/fbank_frames_tile.cu `t6_smem`: the mbarriers, the ring, and the
    frames' rows at a pitch of padded + 4 floats, whose space the power rows
    (hi, lo) reuse."""
    return (T6_BARS + T6_RING * T6_SK * 2 * nfft * 4
            + max(tile * (padded + 4) * 4, tile * nfft * 8))


@functools.lru_cache(maxsize=None)
def frames_plan(S: int, F: int, padded: int, nfft: int) -> Optional[FramesPlan]:
    """Kernel 6's launch on csrc/fbank_frames_tile.cu for S sessions of F
    frames, or None where the kernel does not take the shapes (padded not a
    multiple of T6_SK, nfft other than T6_NFFT: the DFT's columns are one
    chunk of 4 or 8 warps' 64) or no block holds its tile. Of the row counts
    T6_ROWS whose tiles fit, the one whose tiles fill the H100's SMs' waves
    best, as `bf16x3_plan` chooses: the least waves x (R + 1/4); on a tie
    the larger R (fewer table reads)."""
    if S < 1 or F < 1 or padded % T6_SK or nfft not in T6_NFFT:
        return None
    wr = 8 // (2 * nfft // 64)
    best, best_cost = None, None
    for R in T6_ROWS:
        tile = wr * 4 * R
        smem = frames_smem(tile, padded, nfft)
        if smem > cuda_build.SMEM_PER_BLOCK:
            continue
        blocks = -(-S * F // tile)
        cost = -(-blocks // cuda_build.SM_COUNT) * (R + 0.25)
        if best_cost is None or cost <= best_cost:
            best, best_cost = FramesPlan(R, tile, smem, blocks), cost
    return best


def frames_plan_for(c: dict, S: int, F: int) -> Optional[FramesPlan]:
    """`frames_plan` for the layout's constants `c`."""
    return frames_plan(S, F, c["padded"], c["nfft"])


_CONSTS: dict = {}


def fbank_constants(layout, device) -> dict:
    """Device-resident constant tables for one layout (built once)."""
    o = layout.opts
    key = (o, str(device))
    c = _CONSTS.get(key)
    if c is not None:
        return c
    padded, shift, nfft = o.padded_window_size, o.window_shift, o.num_fft_bins
    n_views = -(-padded // shift)
    K = n_views * shift
    dhi, rlo, s_hi, corr = _folded_dft_i8(padded, nfft, o.remove_dc_offset, o.preemph_coeff)
    # zero rows pad K to whole views: a zero dhi row kills both plane dots
    # there and corr sums only real rows, so the pad samples cancel exactly
    dhi_p = np.zeros((K, 2 * nfft), np.int8)
    dhi_p[:padded] = dhi
    rlo_p = np.zeros((K, 2 * nfft), np.float32)
    rlo_p[:padded] = rlo
    mel = mel_banks(o.num_bins, nfft, padded, o.sample_freq, o.mel_low, o.mel_high).T
    mel_hi, mel_lo = _split_bf16(mel)
    dpad = np.zeros((K, 2 * nfft), np.float32)
    dpad[:padded] = _folded_dft(padded, nfft, o.remove_dc_offset, o.preemph_coeff)
    d_hi, d_lo = _split_bf16(dpad)
    dft = _folded_dft(padded, nfft, o.remove_dc_offset, o.preemph_coeff)
    tc = tc_tables(dhi, rlo, s_hi, corr, mel_hi, mel_lo)
    c = {
        "dft": torch.from_numpy(dft).to(device),
        "d_hi": d_hi.contiguous().to(device),
        "d_lo": d_lo.contiguous().to(device),
        "dhi": torch.from_numpy(dhi_p).to(device),
        "rlo": torch.from_numpy(rlo_p).to(torch.bfloat16).to(device),
        "s_hi": torch.from_numpy(s_hi).to(device),
        "corr": torch.from_numpy(corr).to(device),
        "mel_hi": mel_hi.contiguous().to(device),
        "mel_lo": mel_lo.contiguous().to(device),
        **{k: torch.from_numpy(v).to(device) for k, v in tc.items() if k != "tc_mel_span"},
        "t5": torch.from_numpy(t5_stream(d_hi, d_lo, padded)).to(device),
        "t6": torch.from_numpy(t6_stream(dft)).to(device),
        "tc_mel_span": tc["tc_mel_span"],
        "padded": padded,
        "n_views": n_views,
        "shift": shift,
        "nfft": nfft,
        "bins": o.num_bins,
    }
    _CONSTS[key] = c
    return c


def _int_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product of small-int operands, returned as f32 (the
    float64 product is exact: every partial sum is an integer below 2^53;
    the f32 cast rounds like the TPU kernel's int32 -> f32 cast)."""
    return (q.double() @ w.double()).float()


def _dot3(x: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """bf16x3 product with f32 accumulation (drops only the lo*lo term)."""
    x_hi = x.to(torch.bfloat16)
    x_lo = (x - x_hi.float()).to(torch.bfloat16)
    wh, wl = w_hi.float(), w_lo.float()
    return (x_hi.float() @ wh + x_hi.float() @ wl) + x_lo.float() @ wh


def logmel_rows_from_buf_i8_plain(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Plain PyTorch version: buf [S, L] -> rows [S, F, bins] f32."""
    S, L = buf.shape
    shift, n_views, nfft = c["shift"], c["n_views"], c["nfft"]
    b3 = buf.reshape(S, L // shift, shift)
    xcat = torch.cat([b3[:, v : v + F, :] for v in range(n_views)], dim=-1)
    xcat = xcat.reshape(S * F, n_views * shift)
    pcm = xcat * 32768.0
    a = torch.floor(pcm * (1.0 / 256.0))
    b = torch.clamp(torch.round(pcm - 256.0 * a) - 128.0, -128.0, 127.0)
    dhi = c["dhi"]
    acc_hi = _int_dot(a, dhi) * 256.0 + _int_dot(b, dhi) + c["corr"]
    resid = xcat.to(torch.bfloat16).float() @ c["rlo"].float()
    spec = acc_hi * c["s_hi"] + resid
    re, im = spec[:, :nfft], spec[:, nfft:]
    power = re * re + im * im
    mel = _dot3(power, c["mel_hi"], c["mel_lo"])
    rows = torch.log(torch.clamp_min(mel, float(K_EPS)))
    return rows.reshape(S, F, -1)


def _buf_checks(c: dict, buf: torch.Tensor, F: int, what: str) -> torch.Tensor:
    S, L = buf.shape
    if buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError(f"{what}: buf must be contiguous float32")
    if L % c["shift"] or L // c["shift"] < F + c["n_views"] - 1:
        raise ValueError(f"{what}: buffer of {L} samples cannot frame {F} rows")
    return torch.empty((S, F, c["bins"]), dtype=torch.float32, device=buf.device)


def fbank_i8_simt(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Kernel 1 on the CUDA cores (csrc/fbank_i8.cu): 8 frames a block, one
    bin a thread. The route for shapes `fbank_plan` does not hold."""
    S, L = buf.shape
    out = _buf_checks(c, buf, F, "fbank_i8_simt")
    fn = cuda_build.bind("fbank_i8", "fbank_i8", 8, 7)
    cuda_build.COUNTS["fbank_i8_simt"] += 1
    rc = fn(
        buf.data_ptr(), c["dhi"].data_ptr(), c["rlo"].data_ptr(),
        c["s_hi"].data_ptr(), c["corr"].data_ptr(), c["mel_hi"].data_ptr(),
        c["mel_lo"].data_ptr(), out.data_ptr(),
        S, L // c["shift"], F, c["shift"], c["n_views"], c["nfft"], c["bins"],
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    cuda_build.check(rc, f"fbank_i8_simt (S={S}, F={F}, shift={c['shift']})")
    return out


def fbank_mma(c: dict, buf: torch.Tensor, F: int, plan: FbankPlan,
              stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 1 on csrc/fbank_mma.cu on `plan`; with `stamps` (int64
    [plan.blocks, 7], zeroed), each block's phase clock
    (tools/profile_fbank.py)."""
    S, L = buf.shape
    out = _buf_checks(c, buf, F, "fbank_i8")
    if buf.data_ptr() % 16:  # the staging reads 16-byte vectors
        buf = buf.clone()
    fn = cuda_build.bind("fbank_mma", "fbank_mma", 9, 9)
    cuda_build.COUNTS["fbank_i8"] += 1
    rc = fn(
        buf.data_ptr(), c["tc"].data_ptr(), c["tc_shi"].data_ptr(), c["tc_corr"].data_ptr(),
        c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(), c["tc_mel_plan"].data_ptr(),
        out.data_ptr(), 0 if stamps is None else stamps.data_ptr(),
        S, L // c["shift"], F, c["shift"], c["padded"], c["nfft"], c["bins"], plan.hops, plan.smem,
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    if rc < 0:
        raise RuntimeError(f"fbank_i8: csrc/fbank_mma.cu refuses S={S}, F={F}, shift={c['shift']}, "
                           f"padded={c['padded']}, nfft={c['nfft']}, bins={c['bins']} on {plan} "
                           f"({'shape' if rc == -1 else 'shared-memory bytes'})")
    cuda_build.check(rc, f"fbank_i8 (S={S}, F={F}, shift={c['shift']}, {plan})")
    return out


def logmel_rows_from_buf_i8_cuda(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Kernel 1 on the card: csrc/fbank_mma.cu on its plan, else the
    CUDA-core kernel; it never falls back."""
    S = buf.shape[0]
    if S * F == 0:
        return _buf_checks(c, buf, F, "fbank_i8")
    plan = plan_for(c, S, F)
    if plan is None:
        return fbank_i8_simt(c, buf, F)
    return fbank_mma(c, buf, F, plan)


def logmel_rows_from_buf_i8(layout, buf: torch.Tensor) -> torch.Tensor:
    """[S, L] hop-aligned sample buffers -> [S, max_frames, num_bins]."""
    c = fbank_constants(layout, buf.device)
    F = layout.max_frames
    if buf.device.type == "cpu":
        return logmel_rows_from_buf_i8_plain(c, buf, F)
    if buf.device.type != "cuda":
        raise ValueError(f"fbank_i8: unsupported device {buf.device}")
    return logmel_rows_from_buf_i8_cuda(c, buf, F)


def logmel_rows_from_buf_plain(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 5: buf [S, L] -> rows [S, F, bins]."""
    S, L = buf.shape
    shift, n_views, nfft = c["shift"], c["n_views"], c["nfft"]
    b3 = buf.reshape(S, L // shift, shift)
    acc = None
    for v in range(n_views):
        xv = b3[:, v : v + F, :].reshape(S * F, shift)
        rows = slice(v * shift, (v + 1) * shift)
        part = _dot3(xv, c["d_hi"][rows], c["d_lo"][rows])
        acc = part if acc is None else acc + part
    re, im = acc[:, :nfft], acc[:, nfft:]
    power = re * re + im * im
    mel = _dot3(power, c["mel_hi"], c["mel_lo"])
    rows = torch.log(torch.clamp_min(mel, float(K_EPS)))
    return rows.reshape(S, F, -1)


def fbank_bf16x3_simt(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Kernel 5 on the CUDA cores (csrc/fbank_bf16x3.cu): 8 frames of one
    session a block, one bin a thread. The route for shapes `bf16x3_plan`
    does not hold."""
    S, L = buf.shape
    shift = c["shift"]
    out = _buf_checks(c, buf, F, "fbank_bf16x3_simt")
    fn = cuda_build.bind("fbank_bf16x3", "fbank_bf16x3", 6, 7)
    cuda_build.COUNTS["fbank_bf16x3_simt"] += 1
    rc = fn(
        buf.data_ptr(), c["d_hi"].data_ptr(), c["d_lo"].data_ptr(),
        c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(), out.data_ptr(),
        S, L // shift, F, shift, c["n_views"], c["nfft"], c["bins"],
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    cuda_build.check(rc, f"fbank_bf16x3_simt (S={S}, F={F}, shift={shift})")
    return out


def fbank_bf16x3_tile(c: dict, buf: torch.Tensor, F: int, plan: Bf16x3Plan,
                      stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 5 on csrc/fbank_bf16x3_tile.cu on `plan`; with `stamps`
    (int64 [plan.blocks, 6], zeroed), each block's phase clock
    (tools/profile_fbank.py)."""
    S, L = buf.shape
    out = _buf_checks(c, buf, F, "fbank_bf16x3")
    if buf.data_ptr() % 16:  # the staging reads 16-byte vectors
        buf = buf.clone()
    fn = cuda_build.bind("fbank_bf16x3_tile", "fbank_bf16x3_tile", 7, 10)
    cuda_build.COUNTS["fbank_bf16x3"] += 1
    rc = fn(
        buf.data_ptr(), c["t5"].data_ptr(), c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(),
        c["tc_mel_plan"].data_ptr(), out.data_ptr(), 0 if stamps is None else stamps.data_ptr(),
        S, L // c["shift"], F, c["shift"], c["padded"], c["nfft"], c["bins"], plan.rows,
        plan.hops, plan.smem, torch.cuda.current_stream(buf.device).cuda_stream,
    )
    if rc < 0:
        raise RuntimeError(f"fbank_bf16x3: csrc/fbank_bf16x3_tile.cu refuses S={S}, F={F}, "
                           f"shift={c['shift']}, padded={c['padded']}, nfft={c['nfft']}, "
                           f"bins={c['bins']} on {plan} "
                           f"({'shape' if rc == -1 else 'shared-memory bytes'})")
    cuda_build.check(rc, f"fbank_bf16x3 (S={S}, F={F}, shift={c['shift']}, {plan})")
    return out


def logmel_rows_from_buf_cuda(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    """Kernel 5 on the card: csrc/fbank_bf16x3_tile.cu on its plan, else the
    CUDA-core kernel; it never falls back."""
    S = buf.shape[0]
    if S * F == 0:
        return _buf_checks(c, buf, F, "fbank_bf16x3")
    plan = bf16x3_plan_for(c, S, F)
    if plan is None:
        return fbank_bf16x3_simt(c, buf, F)
    return fbank_bf16x3_tile(c, buf, F, plan)


def logmel_rows_from_buf(layout, buf: torch.Tensor) -> torch.Tensor:
    """[S, L] hop-aligned sample buffers -> [S, max_frames, num_bins] by the
    bf16x3 DFT (kernel 5)."""
    c = fbank_constants(layout, buf.device)
    F = layout.max_frames
    if buf.device.type == "cpu":
        return logmel_rows_from_buf_plain(c, buf, F)
    if buf.device.type != "cuda":
        raise ValueError(f"fbank_bf16x3: unsupported device {buf.device}")
    return logmel_rows_from_buf_cuda(c, buf, F)


# the JAX kernels' session tile (fbank_pallas.py `fused_supported`): the
# frontend takes kernels 1, 5 and 6 only at S a multiple of it
BLOCK_S = 8


def fused_supported(layout, S: int) -> bool:
    """The JAX package's gate on its fbank kernels (fbank_pallas.py:190-191):
    S a multiple of the session tile, and frames to compute."""
    return S % BLOCK_S == 0 and layout.max_frames > 0


def frames_from_buf(layout, buf: torch.Tensor) -> torch.Tensor:
    """[S, L] hop-aligned buffers -> [S, max_frames, padded] frames (the JAX
    package's `_frames_from_buf`): frame i is buf[shift*i : shift*i + padded],
    formed from n_views hop-strided views. Like the JAX function, it raises
    where the last view runs past the buffer."""
    o = layout.opts
    shift, F = o.window_shift, layout.max_frames
    S = buf.shape[0]
    views = [buf[:, v * shift : v * shift + F * shift].reshape(S, F, shift)
             for v in range(layout.n_views)]
    return torch.cat(views, dim=2)[:, :, : o.padded_window_size].contiguous()


def logmel_rows_fused_plain(c: dict, frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: frames [S, F, padded] -> rows
    [S, F, bins], the DFT as one f32 product."""
    S, F, padded = frames.shape
    nfft = c["nfft"]
    spec = frames.reshape(S * F, padded) @ c["dft"]
    re, im = spec[:, :nfft], spec[:, nfft:]
    power = re * re + im * im
    mel = _dot3(power, c["mel_hi"], c["mel_lo"])
    return torch.log(torch.clamp_min(mel, float(K_EPS))).reshape(S, F, -1)


def _frames_checks(c: dict, frames: torch.Tensor, what: str) -> torch.Tensor:
    S, F, padded = frames.shape
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError(f"{what}: frames must be contiguous float32")
    if padded != c["padded"]:
        raise ValueError(f"{what}: frames of {padded} samples, the DFT takes {c['padded']}")
    return torch.empty((S, F, c["bins"]), dtype=torch.float32, device=frames.device)


def fbank_frames_simt(c: dict, frames: torch.Tensor) -> torch.Tensor:
    """Kernel 6 on the CUDA cores (csrc/fbank_bf16x3.cu `fbank_frames`): 16
    frames of one session a block, one bin a thread. The route for shapes
    `frames_plan` does not hold."""
    S, F, padded = frames.shape
    out = _frames_checks(c, frames, "fbank_frames_simt")
    fn = cuda_build.bind("fbank_bf16x3", "fbank_frames", 5, 5)
    rc = fn(
        frames.data_ptr(), c["dft"].data_ptr(), c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(),
        out.data_ptr(), S, F, padded, c["nfft"], c["bins"],
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    cuda_build.check(rc, f"fbank_frames_simt (S={S}, F={F}, padded={padded})")
    cuda_build.COUNTS["fbank_frames_simt"] += 1
    return out


def fbank_frames_tile(c: dict, frames: torch.Tensor, plan: FramesPlan,
                      stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 6 on csrc/fbank_frames_tile.cu on `plan`; with `stamps` (int64
    [plan.blocks, 6], zeroed), each block's phase clock
    (tools/profile_fbank.py)."""
    S, F, padded = frames.shape
    out = _frames_checks(c, frames, "fbank_frames")
    if frames.data_ptr() % 16:  # the rows arrive by 16-byte bulk copies
        frames = frames.clone()
    fn = cuda_build.bind("fbank_frames_tile", "fbank_frames_tile", 7, 6)
    rc = fn(
        frames.data_ptr(), c["t6"].data_ptr(), c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(),
        c["tc_mel_plan"].data_ptr(), out.data_ptr(), 0 if stamps is None else stamps.data_ptr(),
        S * F, padded, c["nfft"], c["bins"], plan.rows, plan.smem,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    if rc < 0:
        raise RuntimeError(f"fbank_frames: csrc/fbank_frames_tile.cu refuses S={S}, F={F}, "
                           f"padded={padded}, nfft={c['nfft']}, bins={c['bins']} on {plan} "
                           f"({'shape' if rc == -1 else 'shared-memory bytes'})")
    cuda_build.check(rc, f"fbank_frames (S={S}, F={F}, {plan})")
    cuda_build.COUNTS["fbank_frames"] += 1
    return out


def logmel_rows_fused_cuda(c: dict, frames: torch.Tensor) -> torch.Tensor:
    """Kernel 6 on the card: csrc/fbank_frames_tile.cu on its plan, else the
    CUDA-core kernel; it never falls back."""
    S, F, _ = frames.shape
    if S * F == 0:
        return _frames_checks(c, frames, "fbank_frames")
    plan = frames_plan_for(c, S, F)
    if plan is None:
        return fbank_frames_simt(c, frames)
    return fbank_frames_tile(c, frames, plan)


def logmel_rows_fused(layout, frames: torch.Tensor) -> torch.Tensor:
    """[S, F, padded] frames -> [S, F, num_bins] log-mel rows (kernel 6)."""
    c = fbank_constants(layout, frames.device)
    if frames.device.type == "cpu":
        return logmel_rows_fused_plain(c, frames)
    if frames.device.type != "cuda":
        raise ValueError(f"fbank_frames: unsupported device {frames.device}")
    return logmel_rows_fused_cuda(c, frames)
