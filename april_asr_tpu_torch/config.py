"""Configuration dataclasses (same fields and defaults as the JAX package).

The reference hardcodes its decode heuristics as literal constants scattered
through src/april_session.c (early-emit ramp :449-453, punctuation margin :356,
confident-blank margin/penalty :409-419, silence decay :406, long-silence
reset :411, token-window cap april_session.h:30). Here they are data-driven
config with the reference values as defaults so behavior parity is the default
and tuning is explicit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FbankOptions:
    """Feature-frontend options (reference: src/fbank.h:26-66).

    Derived from model params the same way the reference does
    (src/april_model.c:84-97): snip_edges forced True, remove_dc_offset True,
    preemph 0.97 regardless of what the params block says.
    """

    sample_freq: int = 16000
    frame_shift_ms: int = 10
    frame_length_ms: int = 25
    num_bins: int = 80
    round_pow2: bool = True
    mel_low: int = 20
    mel_high: int = 0  # 0 => sample_freq / 2
    snip_edges: bool = True
    pull_segment_count: int = 9
    pull_segment_step: int = 4
    remove_dc_offset: bool = True
    preemph_coeff: float = 0.97

    @property
    def window_shift(self) -> int:
        # reference: fbank.c:135
        return self.frame_shift_ms * self.sample_freq // 1000

    @property
    def window_size(self) -> int:
        # reference: fbank.c:136
        return self.frame_length_ms * self.sample_freq // 1000

    @property
    def padded_window_size(self) -> int:
        # reference: fbank.c:137,39-47
        if not self.round_pow2:
            return self.window_size
        n = self.window_size - 1
        n |= n >> 1
        n |= n >> 2
        n |= n >> 4
        n |= n >> 8
        n |= n >> 16
        return n + 1

    @property
    def num_fft_bins(self) -> int:
        # reference: fbank.c:138 (Nyquist bin is dropped)
        return self.padded_window_size // 2

    @property
    def segment_stride_ms(self) -> int:
        # reference: fbank.c:359-361
        return self.pull_segment_step * self.frame_shift_ms


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Greedy transducer decode heuristics (reference: src/april_session.c:306-473).

    Every default is the reference's hardcoded constant, cited inline.
    """

    # Max joiner/decoder steps per encoder frame (april_session.c:450).
    max_symbols_per_frame: int = 3
    # Initial early-emit bonus, decremented 1.0 per inner step
    # (april_session.c:449-453): effective values 1.0, 0.0, 0.0.
    early_emit_initial: float = 2.0
    # Punctuation emission margin: emit punct if max > blank - margin
    # (april_session.c:356).
    punctuation_margin: float = 3.5
    # Confident-blank margin: provisionally emit if max > blank - margin
    # (april_session.c:409).
    confident_margin: float = 4.0
    # Logprob penalty applied to provisional confident-blank tokens
    # (april_session.c:418).
    confident_logprob_penalty: float = 8.0
    # Silence decay: max_val -= time_since_emission_ms / decay (april_session.c:406).
    silence_decay_ms: float = 3000.0
    # Long-silence threshold forcing finalize+context-clear+SILENCE
    # (april_session.c:411).
    long_silence_ms: int = 2200
    # Rolling token window capacity (april_session.h:30).
    max_active_tokens: int = 72


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Batched session-engine configuration.

    The reference processes audio in 3200-sample (200 ms @16 kHz) chunks on the
    caller's thread (april_session.c:500-533). The engine runs one step per
    tick over all active sessions with the same chunk size by default;
    smaller chunks lower partial latency at a higher step rate.
    """

    # Samples per session per engine step (reference SEGSIZE, april_session.c:500).
    chunk_samples: int = 3200
    # Mel-row FIFO capacity per session. Reference uses segment_size*32=288 rows
    # (fbank.c:147); steady state only needs ~segment_size+frames_per_chunk, so
    # we keep this small to save HBM. Must be >= pull_segment_count +
    # frames_per_chunk.
    fifo_rows: int = 64
    # Async input buffering bound, in seconds of audio, after which
    # ERROR_CANT_KEEP_UP fires (reference: 3 s ring, audio_provider.c:31).
    max_buffered_seconds: float = 3.0
    # Compute dtype for network weights ("float32" or "bfloat16").
    weight_dtype: str = "float32"
    # Compute dtype for activations/state.
    state_dtype: str = "float32"
    # Per-session event-cell budget for the compacted device->host event
    # blob (engine/step.pack_events). 0 = auto: max(8, ceil(0.6 * pulls)),
    # comfortably above the ~0.5 events/pull a saturated real-speech stream
    # sustains. When a step's total events exceed S * budget the host
    # transparently falls back to reading the dense event tensor for that
    # step (correctness is never budget-dependent; only transfer size is).
    events_per_session: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / parallelism configuration (no reference analog; the
    reference is single-process batch-1, SURVEY.md §2.4)."""

    # Data-parallel axis: concurrent sessions (serving) or utterances (training).
    data_axis: str = "data"
    # Tensor-parallel axis: LSTM gate dim / joiner vocab dim sharding.
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1
