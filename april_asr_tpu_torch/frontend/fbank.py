"""Batched streaming log-mel fbank frontend (port of
april_asr_tpu/frontend/fbank.py).

Each engine step accepts one audio chunk per session, forms the hop-aligned
sample buffer (leftover + phase-rolled chunk), runs the frame DSP for every
session at once and appends the new log-mel rows to a fixed-capacity ring
per session. The frame DSP follows the JAX package's route by shape: where
S is a multiple of the kernels' 8-session tile (`fused_supported`), kernel
5, or kernel 1 for int8 engines, or kernel 6 on a buffer too short to frame
in the kernel (ops/fbank_kernels.py); at any other S the f32 DFT products
of `_frame_dsp` (JAX `fbank_accept`), with no fbank kernel. State
is a dict of tensors with a leading session axis S:

  leftover     f32 [S, leftover_cap]  zero-padded beyond leftover_len
  leftover_len i32 [S]
  fifo         f32 [S, fifo_rows, num_bins]  ring buffer of mel rows
  fifo_off     i32 [S]  ring index of the oldest valid row
  fifo_len     i32 [S]  rows available (includes flush padding)
  fifo_len_f   i32 [S]  real-data availability, may go negative in flush
  dropped      i32 [S]  overflow event count

The JAX package moves samples and rows with one-hot contractions and barrel
rolls, which XLA keeps off its slow gather path; here the same moves are
gathers. All of them move finite values exactly, so the two agree bit for bit
outside the frame DSP. Reference semantics: src/fbank.c:174-349 (leftover
carry, FIFO overflow keeps the stale leftover, segment pulls, flush padding
bounded by the real-data debt counter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import FbankOptions
from .oracle import K_EPS, mel_banks, povey_window


@dataclasses.dataclass(frozen=True)
class FbankLayout:
    """Static shapes for the streaming fbank, derived from options + chunk size."""

    opts: FbankOptions
    chunk: int  # samples accepted per step
    leftover_cap: int
    max_frames: int  # frame slots computed per step (upper bound)
    fifo_rows: int

    @staticmethod
    def build(opts: FbankOptions, chunk: int, fifo_rows: int | None = None) -> "FbankLayout":
        padded = opts.padded_window_size
        shift = opts.window_shift
        # a multiple of the hop so the leftover spans whole sample rows
        leftover_cap = ((padded + shift) + shift - 1) // shift * shift
        max_total = (padded + shift - 1) + chunk
        max_frames = max(0, (max_total - padded) // shift + 1)
        if fifo_rows is None:
            need = opts.pull_segment_count + max_frames
            fifo_rows = ((need + 7) // 8) * 8
        return FbankLayout(
            opts=opts,
            chunk=chunk,
            leftover_cap=leftover_cap,
            max_frames=max_frames,
            fifo_rows=fifo_rows,
        )

    @property
    def max_pulls_per_step(self) -> int:
        """Upper bound on segment pulls after one accept."""
        o = self.opts
        return max(
            1,
            (self.fifo_rows - (o.pull_segment_count - o.pull_segment_step)
             + (o.pull_segment_step - 1)) // o.pull_segment_step,
        )

    @property
    def n_views(self) -> int:
        return -(-self.opts.padded_window_size // self.opts.window_shift)

    @property
    def buf_len(self) -> int:
        """Samples in the per-session hop-aligned accept buffer."""
        shift = self.opts.window_shift
        L = self.leftover_cap + self.chunk + self.n_views * shift
        return ((L + shift - 1) // shift) * shift


FbankState = Dict[str, torch.Tensor]


def fbank_init(layout: FbankLayout, batch: int, device) -> FbankState:
    o = layout.opts
    z = lambda: torch.zeros(batch, dtype=torch.int32, device=device)  # noqa: E731
    return {
        "leftover": torch.zeros((batch, layout.leftover_cap), dtype=torch.float32, device=device),
        "leftover_len": z(),
        "fifo": torch.zeros((batch, layout.fifo_rows, o.num_bins), dtype=torch.float32, device=device),
        "fifo_off": z(),
        "fifo_len": z(),
        "fifo_len_f": z(),
        "dropped": z(),
    }


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    """Integer floor division (jnp `//` semantics)."""
    return torch.div(a, b, rounding_mode="floor")


def _rows_gather(src: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """out[s, i, :] = src[s, idx[s, i], :] where valid[s, i], else 0."""
    n = src.shape[1]
    g = torch.gather(
        src, 1, idx.clamp(0, n - 1).long()[:, :, None].expand(-1, -1, src.shape[2])
    )
    return torch.where(valid[:, :, None], g, torch.zeros((), dtype=src.dtype, device=src.device))


def _pad_to_rows(layout: FbankLayout, wave: torch.Tensor) -> torch.Tensor:
    """Append >= shift zeros and round the last axis up to whole hop rows."""
    shift = layout.opts.window_shift
    pad = shift + (-(layout.chunk + shift) % shift)
    return torch.nn.functional.pad(wave, (0, pad))


def _roll_right(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """Per-row circular right shift of the last axis by amt[s]."""
    n = x.shape[-1]
    idx = torch.remainder(
        torch.arange(n, device=x.device)[None, :] - amt[:, None].long(), n
    )
    return torch.gather(x, 1, idx)


def fbank_accept_batch(
    layout: FbankLayout, state: FbankState, wave: torch.Tensor, n: torch.Tensor,
    dft_i8: bool = False,
) -> FbankState:
    """Accept up to `layout.chunk` samples per session (`wave[s, :n[s]]`
    valid), on the JAX package's route: where `fused_supported(layout, S)`
    holds (S a multiple of 8, frames to compute), the frame DSP is the
    bf16x3 DFT (kernel 5), or with `dft_i8` the int8 DFT (kernel 1), which
    the engine selects for int8 engines as engine/step.py of the JAX package
    does; a buffer too short for in-kernel framing takes JAX's other branch,
    frames formed first and kernel 6 at either setting (no
    `FbankLayout.build` layout is that short, and where one were,
    `frames_from_buf` raises in both packages). At every other S the
    sessions take `fbank_accept`'s f32 DFT, as JAX does."""
    from ..ops.fbank_kernels import (
        frames_from_buf,
        fused_supported,
        logmel_rows_from_buf,
        logmel_rows_from_buf_i8,
        logmel_rows_fused,
    )

    if not fused_supported(layout, wave.shape[0]):
        return fbank_accept(layout, state, wave, n)
    wave_p, n = _aligned(layout, state, wave, n)
    buf, total = _accept_assemble(layout, state, wave_p, n)
    if buf.shape[1] // layout.opts.window_shift >= layout.max_frames + layout.n_views - 1:
        rows = (logmel_rows_from_buf_i8 if dft_i8 else logmel_rows_from_buf)(layout, buf)
    else:
        rows = logmel_rows_fused(layout, frames_from_buf(layout, buf))
    return _accept_commit(layout, state, buf, rows, total)


def fbank_accept(
    layout: FbankLayout, state: FbankState, wave: torch.Tensor, n: torch.Tensor,
) -> FbankState:
    """Accept up to `layout.chunk` samples per session through the f32 DFT
    (JAX `fbank_accept`, there one session under vmap): frames formed from
    the hop-aligned buffer (`frames_from_buf`), then `_frame_dsp`."""
    from ..ops.fbank_kernels import frames_from_buf

    wave_p, n = _aligned(layout, state, wave, n)
    buf, total = _accept_assemble(layout, state, wave_p, n)
    rows = _frame_dsp(layout, frames_from_buf(layout, buf))
    return _accept_commit(layout, state, buf, rows, total)


def _aligned(layout: FbankLayout, state: FbankState, wave: torch.Tensor,
             n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the chunk masked to its n[s] samples, padded to whole hop rows and
    phase-rolled, n as int32). The leftover is stored start-aligned, so the
    new samples are rolled by leftover_len % shift and then placed row-wise."""
    n = n.to(torch.int32)
    pos = torch.arange(layout.chunk, device=wave.device)[None, :]
    wave = torch.where(pos < n[:, None], wave.float(), torch.zeros((), device=wave.device))
    phi = torch.remainder(state["leftover_len"], layout.opts.window_shift)
    return _roll_right(_pad_to_rows(layout, wave), phi), n


def _dft_matrices(padded: int, num_fft_bins: int):
    """Real-DFT basis [padded, num_fft_bins] as numpy constants (float64
    trig, f32 storage; JAX `_dft_matrices`)."""
    t = np.arange(padded)[:, None]
    k = np.arange(num_fft_bins)[None, :]
    ang = 2.0 * np.pi * t * k / padded
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_DSP_CONSTS: dict = {}


def _dsp_constants(opts: FbankOptions, device) -> tuple:
    """(window [padded], cos [padded, nfft], sin, mel [nfft, bins]) on
    `device`, built once per options and device."""
    key = (opts, str(device))
    c = _DSP_CONSTS.get(key)
    if c is None:
        padded = opts.padded_window_size
        mel_t = mel_banks(opts.num_bins, opts.num_fft_bins, padded, opts.sample_freq,
                          opts.mel_low, opts.mel_high).T
        c = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
                  (povey_window(padded), *_dft_matrices(padded, opts.num_fft_bins), mel_t))
        _DSP_CONSTS[key] = c
    return c


def _frame_dsp(layout: FbankLayout, frames: torch.Tensor) -> torch.Tensor:
    """[S, F, padded] raw frames -> [S, F, num_bins] log-mel rows (JAX
    `_frame_dsp`, fbank.c:241-295): DC removal, pre-emphasis with the
    data[0] quirk, the Povey window, then the cos and sin DFT products, the
    power (bins 0..num_fft_bins-1: no Nyquist bin, the DC imaginary zero),
    the mel product and log(max(K_EPS, .)), all in f32. Plain products, as
    in JAX, where they are XLA's outside any kernel."""
    o = layout.opts
    window, cos_m, sin_m, mel_t = _dsp_constants(o, frames.device)
    x = frames
    if o.remove_dc_offset:
        x = x - x.mean(dim=-1, keepdim=True)
    if o.preemph_coeff > 0.0:
        shifted = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - float(np.float32(o.preemph_coeff)) * shifted
    x = x * window
    re, im = x @ cos_m, x @ sin_m
    power = re * re + im * im
    return torch.log(torch.clamp_min(power @ mel_t, float(K_EPS)))


def _accept_assemble(
    layout: FbankLayout, state: FbankState, wave_p: torch.Tensor, n: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hop-aligned sample buffers (buf [S, L], total samples [S]). Buf row t
    receives wave row t - leftover_len // shift; the start-aligned leftover
    overlays [0, leftover_len)."""
    shift = layout.opts.window_shift
    cap = layout.leftover_cap
    S = wave_p.shape[0]
    L = layout.buf_len
    nbuf = L // shift
    lo_len = state["leftover_len"]
    total = lo_len + n
    row_off = _fdiv(lo_len, shift)
    src = wave_p.reshape(S, -1, shift)
    t = torch.arange(nbuf, device=wave_p.device)[None, :]
    srow = t - row_off[:, None]
    buf = _rows_gather(src, srow, (srow >= 0) & (srow < src.shape[1])).reshape(S, L)
    lo_padded = torch.nn.functional.pad(state["leftover"], (0, L - cap))
    p = torch.arange(L, device=wave_p.device)[None, :]
    buf = torch.where(p < lo_len[:, None], lo_padded, buf)
    return buf, total


def _accept_commit(
    layout: FbankLayout,
    state: FbankState,
    buf: torch.Tensor,
    rows: torch.Tensor,
    total: torch.Tensor,
) -> FbankState:
    """Ring-append the new log-mel rows and update the leftover. `rows` is
    [S, max_frames, num_bins]; entries beyond a session's frame count are
    garbage and masked off here."""
    o = layout.opts
    padded, shift, cap = o.padded_window_size, o.window_shift, layout.leftover_cap
    S = buf.shape[0]
    dev = buf.device
    lo_len = state["leftover_len"]
    nbuf = buf.shape[1] // shift

    nframes = torch.clamp_min(_fdiv(total - padded, shift) + 1, 0)
    space = layout.fifo_rows - state["fifo_len"]
    nf_eff = torch.minimum(nframes, space)
    truncated = nf_eff < nframes

    # ring slot r takes new row (rel(r) - len) when that is a valid new frame
    R = layout.fifo_rows
    rel = torch.remainder(torch.arange(R, device=dev)[None, :] - state["fifo_off"][:, None], R)
    row_idx = rel - state["fifo_len"][:, None]
    write = (row_idx >= 0) & (row_idx < nf_eff[:, None])
    written = _rows_gather(rows, row_idx, write & (row_idx < rows.shape[1]))
    fifo = torch.where(write[:, :, None], written, state["fifo"])

    fifo_len = state["fifo_len"] + nf_eff
    fifo_len_f = torch.where(nf_eff > 0, fifo_len, state["fifo_len_f"])

    # leftover row j = buf row j + nframes (fbank.c:195-226); on truncation
    # the previous leftover stays (fbank.c:190-193)
    consumed = nframes * shift
    new_lo_len = total - consumed
    nlo = cap // shift
    j = torch.arange(nlo, device=dev)[None, :] + nframes[:, None]
    new_lo = _rows_gather(buf.reshape(S, nbuf, shift), j, j < nbuf).reshape(S, cap)
    lo_idx = torch.arange(cap, device=dev)[None, :]
    new_lo = torch.where(lo_idx < new_lo_len[:, None], new_lo, torch.zeros((), device=dev))

    keep = truncated
    return {
        "leftover": torch.where(keep[:, None], state["leftover"], new_lo),
        "leftover_len": torch.where(keep, lo_len, new_lo_len).to(torch.int32),
        "fifo": fifo,
        "fifo_off": state["fifo_off"],
        "fifo_len": fifo_len.to(torch.int32),
        "fifo_len_f": fifo_len_f.to(torch.int32),
        "dropped": (state["dropped"] + keep.to(torch.int32)).to(torch.int32),
    }


def fbank_flush_pad(layout: FbankLayout, state: FbankState) -> Tuple[FbankState, torch.Tensor]:
    """Pad log(eps) rows up to pull_segment_count where the debt bound
    allows (fbank_flush, fbank.c:308-325). Returns (state, did_flush)."""
    o = layout.opts
    seg = o.pull_segment_count
    dev = state["fifo"].device
    did = state["fifo_len_f"] >= -(seg * 3)
    log_eps = float(np.log(np.float32(K_EPS)))
    R = layout.fifo_rows
    rel = torch.remainder(torch.arange(R, device=dev)[None, :] - state["fifo_off"][:, None], R)
    pad_mask = did[:, None] & (rel >= state["fifo_len"][:, None]) & (rel < seg)
    new_state = dict(state)
    new_state["fifo"] = torch.where(pad_mask[:, :, None], log_eps, state["fifo"])
    new_state["fifo_len"] = torch.where(
        did, torch.clamp_min(state["fifo_len"], seg), state["fifo_len"]
    ).to(torch.int32)
    return new_state, did


def fbank_front_batch(layout: FbankLayout, state: FbankState, w: int) -> torch.Tensor:
    """Front `w` ring rows per session as [S, w, num_bins]; rows past one
    ring turn read as zeros (the JAX one-hot read's value there)."""
    R = layout.fifo_rows
    dev = state["fifo"].device
    u = torch.arange(w, device=dev)[None, :]
    idx = torch.remainder(state["fifo_off"][:, None] + u, R)
    return _rows_gather(state["fifo"], idx, (u < R).expand(idx.shape[0], -1))


def fbank_peek(layout: FbankLayout, state: FbankState) -> torch.Tensor:
    """Front pull_segment_count rows as the [S, seg, num_bins] network input."""
    return fbank_front_batch(layout, state, layout.opts.pull_segment_count)


def fbank_advance_n(layout: FbankLayout, state: FbankState, n_pulls: torch.Tensor) -> FbankState:
    """Advance the FIFO by `n_pulls` pulls' worth of rows at once."""
    d = n_pulls.to(torch.int32) * layout.opts.pull_segment_step
    new_state = dict(state)
    new_state["fifo_off"] = torch.remainder(state["fifo_off"] + d, layout.fifo_rows).to(torch.int32)
    new_state["fifo_len"] = (state["fifo_len"] - d).to(torch.int32)
    new_state["fifo_len_f"] = (state["fifo_len_f"] - d).to(torch.int32)
    return new_state


def fbank_advance(layout: FbankLayout, state: FbankState, do: torch.Tensor) -> FbankState:
    """Advance the FIFO by pull_segment_step rows where `do` (fbank.c:343-346)."""
    return fbank_advance_n(layout, state, do.to(torch.int32))
