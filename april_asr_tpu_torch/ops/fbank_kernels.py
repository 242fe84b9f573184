"""Kernels 1 and 5: the fbank frame DSP (hop-row buffer -> log-mel rows).

Frames are formed from the hop rows of each session's sample buffer; the DC
removal, pre-emphasis and Povey window are folded into the DFT matrix in
float64 (`_folded_dft`). Two kernels compute the spectrum from there:

Kernel 1, port of `logmel_rows_from_buf_i8` (april_asr_tpu/ops/
fbank_pallas.py, `_buf_kernel_i8`), for int8 engines. PCM16 samples split exactly into
two int8 planes (a = floor(p/256), b = rint(p - 256a) - 128) that contract
with the int8 hi plane of the folded DFT in exact int32; the hi plane's
residual is one bf16 dot with f32 accumulation. Then the power spectrum, the
bf16x3 mel projection (`_dot3`) and log(max(K_EPS, .)).

Kernel 5, port of `logmel_rows_from_buf` (`_buf_kernel`), for every other
engine. Per hop-row view, the samples split exactly into bf16 hi/lo planes
and contract with the bf16 hi/lo planes of the zero-padded folded DFT, the
lo*lo term dropped (`_dot3`); the view sums add up in view order. Then the
same power, bf16x3 mel projection and log.

Kernel 6, port of `logmel_rows_fused` (`_kernel`), the same DSP on frames
formed beforehand ([S, F, padded], `frames_from_buf`): one full-f32 product
with the folded DFT (HIGHEST on the TPU), then the same power, mel and log.
The frontend takes it only for a buffer too short for in-kernel framing,
which no `FbankLayout.build` layout gives (frontend/fbank.py).

Each dispatcher takes the plain PyTorch version for a CPU tensor and
launches its CUDA kernel (csrc/fbank_i8.cu, csrc/fbank_bf16x3.cu; kernel 6 is
the second entry of the latter) for a CUDA tensor; it never falls back.
"""

from __future__ import annotations

import functools

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


def logmel_rows_from_buf_i8_cuda(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    S, L = buf.shape
    shift = c["shift"]
    if buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError("fbank_i8: buf must be contiguous float32")
    if L % shift or L // shift < F + c["n_views"] - 1:
        raise ValueError(f"fbank_i8: buffer of {L} samples cannot frame {F} rows")
    out = torch.empty((S, F, c["bins"]), dtype=torch.float32, device=buf.device)
    fn = cuda_build.bind("fbank_i8", "fbank_i8", 8, 7)
    cuda_build.COUNTS["fbank_i8"] += 1
    rc = fn(
        buf.data_ptr(), c["dhi"].data_ptr(), c["rlo"].data_ptr(),
        c["s_hi"].data_ptr(), c["corr"].data_ptr(), c["mel_hi"].data_ptr(),
        c["mel_lo"].data_ptr(), out.data_ptr(),
        S, L // shift, F, shift, c["n_views"], c["nfft"], c["bins"],
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    cuda_build.check(rc, "fbank_i8")
    return out


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


def logmel_rows_from_buf_cuda(c: dict, buf: torch.Tensor, F: int) -> torch.Tensor:
    S, L = buf.shape
    shift = c["shift"]
    if buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError("fbank_bf16x3: buf must be contiguous float32")
    if L % shift or L // shift < F + c["n_views"] - 1:
        raise ValueError(f"fbank_bf16x3: buffer of {L} samples cannot frame {F} rows")
    out = torch.empty((S, F, c["bins"]), dtype=torch.float32, device=buf.device)
    fn = cuda_build.bind("fbank_bf16x3", "fbank_bf16x3", 6, 7)
    cuda_build.COUNTS["fbank_bf16x3"] += 1
    rc = fn(
        buf.data_ptr(), c["d_hi"].data_ptr(), c["d_lo"].data_ptr(),
        c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(), out.data_ptr(),
        S, L // shift, F, shift, c["n_views"], c["nfft"], c["bins"],
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    cuda_build.check(rc, "fbank_bf16x3")
    return out


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


def logmel_rows_fused_cuda(c: dict, frames: torch.Tensor) -> torch.Tensor:
    S, F, padded = frames.shape
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError("fbank_frames: frames must be contiguous float32")
    if padded != c["padded"]:
        raise ValueError(f"fbank_frames: frames of {padded} samples, the DFT takes {c['padded']}")
    out = torch.empty((S, F, c["bins"]), dtype=torch.float32, device=frames.device)
    if S == 0 or F == 0:
        return out
    fn = cuda_build.bind("fbank_bf16x3", "fbank_frames", 5, 5)
    rc = fn(
        frames.data_ptr(), c["dft"].data_ptr(), c["mel_hi"].data_ptr(), c["mel_lo"].data_ptr(),
        out.data_ptr(), S, F, padded, c["nfft"], c["bins"],
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    cuda_build.check(rc, "fbank_frames")
    cuda_build.COUNTS["fbank_frames"] += 1
    return out


def logmel_rows_fused(layout, frames: torch.Tensor) -> torch.Tensor:
    """[S, F, padded] frames -> [S, F, num_bins] log-mel rows (kernel 6)."""
    c = fbank_constants(layout, frames.device)
    if frames.device.type == "cpu":
        return logmel_rows_fused_plain(c, frames)
    if frames.device.type != "cuda":
        raise ValueError(f"fbank_frames: unsupported device {frames.device}")
    return logmel_rows_fused_cuda(c, frames)
