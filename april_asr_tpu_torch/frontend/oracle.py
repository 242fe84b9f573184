"""Scalar NumPy oracle of the reference streaming fbank DSP.

This is a behavioral re-implementation (from study of reference src/fbank.c)
used as the test oracle — NOT the device path (see fbank.py for the
batched frontend). It reproduces the reference's exact
numeric quirks:

  * Povey window `(0.5-0.5cos)^0.85` computed over the *padded* window size
    (fbank.c:49-55,140-141), unlike Kaldi which windows the unpadded frame.
  * DC offset removed with a float32 accumulator over float64 samples
    (fbank.c:241-246).
  * Pre-emphasis 0.97 with the `data[0] -= c*data[0]` boundary (fbank.c:249-253).
  * FFT in float64 (fbank.c:259-270); power spectrum computed on float32 casts
    of the float64 FFT outputs (fbank.c:275-280); Nyquist bin dropped, DC bin
    uses the real DC term with zero imaginary (fbank.c:269-270).
  * Mel projection accumulated in float32 (fbank.c:283-291), then
    log(max(1.19e-7, x)) in float64 cast back to float32 (fbank.c:294-295).
  * Segment FIFO with pull_segment_count/pull_segment_step windowing and the
    separate real-data availability counter that bounds flush padding
    (fbank.c:308-349).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import FbankOptions

K_EPS = np.float32(1.1920928955078125e-07)


def povey_window(n: int) -> np.ndarray:
    """reference: generate_povey_window, fbank.c:49-55 (float64 math, f32 out)."""
    i = np.arange(n, dtype=np.float64)
    w = np.power(0.5 - 0.5 * np.cos(i / float(n) * 6.283185307), 0.85)
    return w.astype(np.float32)


def mel_scale(freq: np.ndarray | float) -> np.ndarray | float:
    """reference: fbank.c:61-63."""
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_banks(
    num_bins: int,
    num_fft_bins: int,
    padded_window_size: int,
    sample_freq: int,
    mel_low: int,
    mel_high: int,
) -> np.ndarray:
    """Triangular mel filterbank matrix [num_bins, num_fft_bins]
    (reference: generate_banks, fbank.c:65-95; float32 arithmetic with
    float64 mel_scale)."""
    if mel_high == 0:
        mel_high = sample_freq // 2
    fft_bin_width = np.float32(sample_freq) / np.float32(padded_window_size)
    mel_low_f = np.float32(mel_scale(float(mel_low)))
    mel_high_f = np.float32(mel_scale(float(mel_high)))
    mel_delta = (mel_high_f - mel_low_f) / np.float32(num_bins + 1.0)

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float32)
    mels = mel_scale(freqs.astype(np.float64)).astype(np.float32)

    out = np.zeros((num_bins, num_fft_bins), dtype=np.float32)
    for i in range(num_bins):
        left = mel_low_f + np.float32(i) * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        w = np.where(mels <= center, up, down)
        w = np.where((mels > left) & (mels < right), w, np.float32(0.0))
        out[i] = w.astype(np.float32)
    return out


def logmel_frames(opts: FbankOptions, wave: np.ndarray) -> np.ndarray:
    """Offline helper: all 10 ms log-mel rows of a waveform at once
    (reference frame semantics; used by the offline/beam decode path)."""
    ob = OracleFbank(opts)
    wave = np.asarray(wave, np.float32)
    rows = []
    pos = 0
    while pos + ob.padded <= len(wave):
        rows.append(ob._process_frame(wave[pos : pos + ob.padded]))
        pos += ob.window_shift
    if not rows:
        return np.zeros((0, opts.num_bins), np.float32)
    return np.stack(rows)


class OracleFbank:
    """Streaming log-mel extractor, scalar semantics of reference fbank.c."""

    def __init__(self, opts: FbankOptions):
        assert opts.snip_edges, "non-snip-edges unsupported (as in reference fbank.c:130)"
        self.opts = opts
        self.window_shift = opts.window_shift
        self.window_size = opts.window_size
        self.padded = opts.padded_window_size
        self.num_fft_bins = opts.num_fft_bins

        self.window = povey_window(self.padded)
        self.mel = mel_banks(
            opts.num_bins,
            self.num_fft_bins,
            self.padded,
            opts.sample_freq,
            opts.mel_low,
            opts.mel_high,
        )

        # FIFO of segment rows (reference: temp_segments ring, fbank.c:147-153).
        self.fifo_rows = opts.pull_segment_count * 32
        self.fifo: List[np.ndarray] = []
        self.avail_f = 0  # real-data availability (may go negative on flush)

        self.leftover = np.zeros(0, dtype=np.float32)

    # -- internal ---------------------------------------------------------

    def _process_frame(self, frame: np.ndarray) -> np.ndarray:
        """One 512-sample frame -> one log-mel row (reference fbank.c:228-295).

        The reference accumulates the DC mean and the mel projection in
        sequential float32 (fbank.c:241-246, :283-291); here those reductions
        are vectorized (float32 pairwise), which differs from strict
        left-to-right accumulation at ~1e-7 relative — far below the test
        tolerance and WER-neutral.
        """
        data = frame.astype(np.float64)

        if self.opts.remove_dc_offset:
            # float32 accumulator over float64 values (fbank.c:241-246)
            s = np.float32(np.sum(data, dtype=np.float64))
            mean = np.float32(s / np.float32(self.padded))
            data = data - np.float64(mean)

        c = np.float64(np.float32(self.opts.preemph_coeff))
        if c > 0.0:
            out = data.copy()
            out[1:] -= c * data[:-1]
            out[0] -= c * data[0]
            data = out

        data = data * self.window.astype(np.float64)

        spec = np.fft.rfft(data)  # float64, length padded//2 + 1
        re = spec.real.astype(np.float32)
        im = spec.imag.astype(np.float32)
        # DC bin keeps real term with zero imaginary; Nyquist dropped
        # (fbank.c:269-280).
        re = re[: self.num_fft_bins]
        im = im[: self.num_fft_bins].copy()
        im[0] = np.float32(0.0)
        power = (re * re + im * im).astype(np.float32)

        # Mel projection in float32 (fbank.c:283-291).
        row = self.mel @ power

        # log(max(eps, x)) computed in float64 (fbank.c:294-295).
        row = np.log(np.maximum(K_EPS, row).astype(np.float64)).astype(np.float32)
        return row

    # -- public (mirrors fbank.h API) -------------------------------------

    def accept_waveform(self, wave: Optional[np.ndarray], count: Optional[int] = None):
        """reference: fbank_accept_waveform, fbank.c:174-306. `wave=None`
        feeds zeros of length `count` (fbank.c:173-175)."""
        if wave is None:
            wave = np.zeros(count, dtype=np.float32)
        wave = np.asarray(wave, dtype=np.float32)

        buf = np.concatenate([self.leftover, wave])
        pos = 0
        while pos + self.padded <= len(buf):
            if len(self.fifo) + 1 > self.fifo_rows:
                # FIFO full: drop the rest, keep the (stale) leftover
                # (fbank.c:190-193 returns without touching prev_leftover).
                return
            frame = buf[pos : pos + self.padded]
            self.fifo.append(self._process_frame(frame))
            self.avail_f = len(self.fifo)
            pos += self.window_shift
        self.leftover = buf[pos:]

    def flush(self) -> bool:
        """reference: fbank_flush, fbank.c:308-325."""
        if self.avail_f < -(self.opts.pull_segment_count * 3):
            return False
        log_eps = np.full(
            self.opts.num_bins,
            np.float32(np.log(np.float64(K_EPS))),
            dtype=np.float32,
        )
        while len(self.fifo) < self.opts.pull_segment_count:
            self.fifo.append(log_eps.copy())
        return True

    def pull_segments(self) -> Optional[np.ndarray]:
        """reference: fbank_pull_segments, fbank.c:327-349. Returns
        [pull_segment_count, num_bins] or None."""
        n = self.opts.pull_segment_count
        if len(self.fifo) < n:
            return None
        out = np.stack(self.fifo[:n])
        step = self.opts.pull_segment_step
        del self.fifo[:step]
        self.avail_f -= step
        return out

    @property
    def segments_stride_ms(self) -> int:
        return self.opts.segment_stride_ms
