#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (april_asr_tpu_torch) on one GPU.

Builds the port's CUDA kernels from csrc/ and its host runtime from
native/april_native.cc, holds each kernel against its plain
PyTorch version at the flagship serving shapes, checks the streaming engine
against the CPU (plain) engine on a small model at int8, bf16 and f32, drives a
flagship BatchEngine at int8, bf16 and f32 and a synchronous Session at int8
and at f32 (the weights as loaded), then asynchronous, ASYNC_RT and speaker
Sessions and the engine's failure containment, loads the flagship's ONNX form (verified
on the card, served beside its native form) and serves a model through the
ONNX interpreter, serves a flagship-width model with a
16,383-token vocabulary and a narrow one that no kernel 4 holds,
serves models at the widths the port once refused (an int8 model wider than
kernels 2 and 7 hold, a float model at d = 68, one at d = 66 whose widths
the kernels take zero-padded), runs the int8 chunk-layer
variants of the two profiling tools and the
matrix-unit tool's tensor-core products, then the tensor-parallel kernels
and a two-rank tensor-parallel engine, and prints the results.

    python3 chip_smoke.py                      # every phase (as the check runs it)
    python3 chip_smoke.py --phases build,kernels

Phases (each fails the run on error):
  build      nvcc for every csrc/*.cu, all started at once, and g++ for
             the host runtime (native/april_native.cc, printed); then
             csrc/lstm_mma.cu, lstm_mma_float.cu, lstm_chunk_mma.cu,
             ffn_mma.cu, fbank_mma.cu, fbank_bf16x3_tile.cu,
             fbank_frames_tile.cu, conv_embed_tile.cu and mm_wgmma.cu again
             to cubins: kernels 2, 7, 12, 10, 3, 1, 5, 6, 16, 17 and 23's
             registers and spills (none allowed), IMMA in 2, 7 and 3's SASS,
             IMMA and FFMA in kernel 1's, FFMA and no tensor-core
             instruction in kernels 5, 6, 16 and 17's, HMMA in kernels 12 and 10 at bf16, FFMA and no
             tensor-core instruction at f32, HGMMA in kernel 23's bf16 form
             and IGMMA in its int8 forms, FFMA and no tensor-core
             instruction in kernel 8's (csrc/dec_joiner_cluster.cu) and in
             kernel 9's 16 (csrc/joiner_stream.cu); IMMA in kernels 14 and
             13's (csrc/lstm_hoist.cu: the phase-A tile pass and the three
             phase-B recurrences) and kernel 15's
             (csrc/lstm_wavefront_hoist.cu: one cooperative launch a slab)
  kernels    each kernel against its plain version: timed at S=256, P=27,
             F=101, checked again at S=3, P=5 (ragged tiles); kernels 2 and
             7 also bit for bit against kernel 13's CUDA-core template and
             the three-pass step they replaced (ungated and gated), with
             their launch plans; kernels 14 and 13 (csrc/lstm_hoist.cu: the
             hoisted x-side product and one persistent recurrence launch)
             bit for bit against their CUDA-core templates
             (lstm_rec_*_simt) and kernel 2, gated and ungated, all five
             timed at S=256 by CUDA events and the profiler's device time;
             kernel 3 (tiled int8 tensor-core passes) bit for
             bit against the CUDA-core kernel it replaced, on 16-, 8- and
             4-row tiles, timed beside it with its design's byte bound;
             kernels 12 and 10 beside the three-pass step and the two-kernel
             chunk layer they replaced (the largest difference and both
             times); kernels 10 and 12 again at d 512 / H 2048 / F 4096 and
             at d 68 / H 260 / F 196 (bf16 weight rows 8-byte aligned); the
             int8 kernels on int8 weights, kernels 10 and 12 on f32 and on bf16
             weights, the chunk decode and kernels 8 and 9 on bf16 and on
             f32 decode weights, kernel 9 again at V=16,383, each beside
             the CUDA-core kernel it replaced (joiner_argmax_simt); kernel 9
             (csrc/joiner_stream.cu, one cooperative launch) bit for bit
             against joiner_argmax_simt (max_idx, max_val, blank_val) at
             S=3, 256 and 2048, V=500 and 16,383, bf16 and f32, and at the
             narrow models' joiners (J=128, V=64 and 16,383), both held to
             the plain version, both timed at V=16,383 (S=256, 2048) and
             V=500 (S=256) by CUDA events, the profiler's device time and
             the host's time a call, beside the plain version's device
             time, the bound and the FFMA floor; kernel 4 (the
             thread-block-cluster kernel) bit for bit against the CUDA-core
             kernel it replaced (chunk_decode_simt; every event and state
             key) at S=3, 256 and 2048, both timed by CUDA events and the
             profiler's device time a launch; kernel 8 (the thread-block-
             cluster kernel, csrc/dec_joiner_cluster.cu) bit for bit
             against the CUDA-core kernels it replaced (dec_joiner_simt;
             max_idx, max_val, blank_val, dout') at S=3, 256 and 2048 with
             need_dec at 50% and ~5%, its plans at S=1, 3, 256 and 2048,
             both timed at 256 and 2048 by CUDA events, the profiler's
             device time and the host's time a call; both conv-embed
             entries (16, 17) on bf16 weights, each by its route on
             csrc/conv_embed_tile.cu bit for bit against the CUDA-core kernel
             it replaced (conv_embed_simt, conv_embed_front_simt) at S=256
             and 2048 of 1 s chunks, S=1 and 256 of 200 ms chunks and S=3,
             P=5, kernel 17 at seg 9 and 7 (each entry held to its plain
             version by the derived flip bound), all four timed at S=256 and
             2048 by CUDA events and the profiler's device time a launch
             beside the stacked embed 16 displaces, the bound and each
             design's FFMA floor; kernel 6 (csrc/fbank_frames_tile.cu) on
             frames formed from the fbank buffers, by its route, against its
             plain version at the fbank bound and fbank_frames_simt bit for
             bit at 16 and 8 kHz, S=1 and 256 of 200 ms chunks, S=3, 256 and
             2048 of 1 s chunks and full-scale samples, silent sessions
             exactly log(K_EPS), both timed at S=256 and 2048 beside the
             bound, its FFMA floor and torch.mm of its DFT product;
             kernels 1 (csrc/fbank_mma.cu) and 5 (csrc/fbank_bf16x3_tile.cu),
             each by its route, against its plain version at the fbank
             bound and the CUDA-core kernel it displaces (fbank_i8_simt,
             fbank_bf16x3_simt) bit for bit, at 16 and 8 kHz, S=1 and 256
             of 200 ms (the session's) chunks and S=3, 256 and 2048 of 1 s
             chunks, and on full-scale samples, each launch counted on its
             route; silent sessions exactly log(K_EPS) and two launches
             equal bit for bit; both kernels of each timed at S=256 and
             2048 by CUDA events and the profiler's device time a launch,
             beside the bound and kernel 5's FFMA floor
  reference  a tiny random model: CUDA engine vs CPU engine, same streams,
             at int8 and bf16 (the step embeds through kernel 16) and at f32
             (the stacked embed); the flush runs kernels 7, 12 and 8 (on
             its cluster route: dec_joiner_simt never launched, here and in
             the engine, session and tp phases)
  engine     flagship random model, BatchEngine S=256, 1 s chunks, 10 ticks
             of tone bursts then flush, at int8, bf16 and f32; the step's
             and the flush's launch counts checked apart, timing and the
             profiler's busy share of a step and of a flush; at int8 and
             bf16 the step again on the stacked embed (kernel 16 off), in
             turns, with the device kernels that left the step
  session    one synchronous Session, 200 ms feeds over 3 s, then flush: at
             int8, and from Model(path) with no precision (f32 as loaded);
             batch-1 engines take no fbank kernel (S = 1 is no multiple of
             8: the f32 DFT, JAX's route). At int8 an asynchronous no_rt
             Session whose callbacks must equal the sync one's (its worker
             thread loading the kernel libraries it launches), an ASYNC_RT
             Session at ~1.4x realtime (get_rt_speedup > 1.05, the
             stretcher above 1x, no ERROR_CANT_KEEP_UP, a FINAL), a speaker
             round trip (the restored rows equal the snapshot bit for bit);
             the int8 engine at S=256 with a transient step failure (blobs
             equal a clean run's) and with a NaN slot and a failed step
             (that slot alone gets SESSION_ERROR, the others' events equal
             the clean run's; exactly those two failures counted); and the
             S=256 engines at int8, bf16 and f32: prog.step and prog.flush
             leave their input state unchanged. Every other engine and
             Session of the run must take no SESSION_ERROR, and each phase
             ends with no program failure caught (engine/batch.py CONTAINED)
  onnx       ONNX-form models: the flagship's weights written by the port
             in both forms, the ONNX form loaded at int8 (extracted, then
             verified on the card: kernel 12 must launch during the load;
             kind "native", weights bit for bit the native form's) and both
             served at S=256, 1 s chunks, 3 ticks and a flush with equal
             blobs, each form's load seconds by stage; then the reference
             model through the interpreter (prefer_native=False), CUDA vs
             CPU engine over 5 ticks and a flush at S=8, its step and flush
             ms and device kernels a step
  vocab      a flagship-width model with 16,383 tokens, which kernel 4
             cannot hold: the CUDA engine vs the CPU engine at S=8 (f32),
             then BatchEngine S=256 at f32 and bf16, 3 ticks and a flush,
             decoding through kernel 9 alone (csrc/joiner_stream.cu:
             joiner_argmax_simt never launched); and a 1-layer d = J = 128
             model with 16,383 tokens, which the JAX gate passes but no
             kernel 4 holds (no cluster plan, no CUDA-core block): CUDA vs
             CPU at S=8 (f32) through kernel 8, kernel 4 never launched
  widths     models the port once refused: a 2-layer int8 model at d 1024 /
             H 4096 / F 8192 (kernels 2 and 7 have no plan) serves S=256,
             the flagship engine's batch, 3 ticks and a flush, on kernel 14,
             the three-pass int8 step and kernel 3 (each held to its plain
             version at those widths, S=256, and timed; kernel 14 also bit
             for bit against its CUDA-core template at S=256 and 2048 and
             timed beside it, kernel 3 bit for bit against the CUDA-core
             kernel's 4-row tiles), the step program timed and profiled with
             kernel 14 launched and its template never; a float
             model at d 68 / H 260 / F 196 serves at f32 (CUDA vs CPU
             engine) and bf16; one at d 66 / H 258 / F 198 with conv
             channels (4, 12, 20), no width a multiple of 4 (the JAX package
             serves it through XLA), runs every layer kernel on weights
             zero-padded to their widths (ops/widths.py): kernels 2, 3, 7,
             10, 12 and 16 each held to its plain version at the model's own
             widths (the padded columns zero), then CUDA vs CPU engine at
             f32 and int8, then served at both, the layer kernels launched
             (PATH_KERNELS "d66 ..."); kernel 16 again at an odd d_model;
             the tensor-parallel kernels 18 and 20 (f32) and 19 and 21
             (int8) on each of the m = 2 shards (Hs 129, Fs 99) at S=8 on
             the padded route, held to their plain versions at the
             shard's own widths (`check_padded_tp`)
  chunk      the int8 chunk-layer variants at flagship widths, S=256, P=27:
             kernels 13, 14 and their CUDA-core templates, 11 (one layer,
             csrc/lstm_hoist.cu) and its template (csrc/lstm_chunk_i8.cu),
             15 (a 6-layer wavefront slab, csrc/lstm_wavefront_hoist.cu)
             and its template (csrc/lstm_wavefront.cu), 22 (the
             tile-interleaved core on kernel 14's launches, as JAX's
             block_s 512 and 256) and its template (on 4- and 2-session
             tiles) against their plain versions, gated, timed, 11, 15 and
             22 bit for bit against their templates, gated and ungated, and
             checked again at S=3, P=5; then every stack variant of the
             ported tools (profile_chunk_split: fused, split, stream,
             stream2, split-xla, interleave-ts4, interleave-ts2;
             profile_wavefront: slabs of 6, 4 and 12) against the shipped
             stack (kernels 2 + 3; fused, the interleave and the wavefront
             stacks bit for bit, launching only kernels 11, 22 and 3, or
             15), each new kernel launched by them, no template
  matmul     kernel 23 (profile_int8's bf16, int8 and dynamic-int8 bodies;
             csrc/mm_wgmma.cu, persistent, on wgmma and TMA): the ported
             tool at its five shapes (each body's plan, each body checked
             against its plain version, timed beside cuBLAS), every body
             launched by it and the mma.sync kernel it replaced never; then
             at every shape both kernels on the same inputs (the int8 forms
             equal bit for bit, bf16 both within the bound), timed in turns,
             by the profiler's device time and the host's time a call, the
             new kernel's phase clock; the three bodies and their mma.sync
             forms at 2048 x 512 x 4096 timed with their plain versions and
             bounds, the other shapes' plain times and bounds, and each
             wrapper's refusal of a ragged shape
  tp         tensor parallelism: kernels 18-21 on one shard's
             gate-shuffled slices at flagship widths (m = 2: d 512, Hs 512,
             Fs 1024), 18 and 20 at f32 and bf16 weights, 19 and 21 on the
             int8 weights, against their plain versions, timed at S=256 and
             checked again at S=3 and at m = 4 (Hs 256, Fs 512, S=256 and
             3); kernels 18 and 19 (csrc/lstm_tp_gates.cu) and 20 and 21
             (csrc/lstm_tp_ffn.cu), one launch each, bit for bit against
             the column-pass kernels they replaced (`*_simt`,
             csrc/lstm_tp.cu), gated and ungated where they take a gate,
             both timed by CUDA events, the profiler's device time and the
             host's time a call; every shard's partials summed against
             kernel 7 (int8) and 12 (f32); then two rank processes on this
             card (gloo, a file store) each serve BatchEngine(S=256,
             mesh=make_mesh(model_parallel=2)) at int8 and at f32, 2 ticks
             and a flush: identical blobs on both ranks, exactly the
             PATH_KERNELS["tp ..."] launches (the column-pass kernels
             never), the events of the single-card per-pull engine up to
             near-ties (the engines at the flagship's widths and 4 layers,
             TP_ENGINE), rank 0's device time of a step and the flush by
             kernel (torch.profiler), and the same run on the column-pass
             kernels with equal blobs, profiled alike

Output: one line per kernel and per phase, then a JSON line
{"kernels": [...]}, the `nvidia-smi` name and power limit, and as the last
line {"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASES = ("build", "kernels", "reference", "engine", "session", "onnx", "vocab", "widths", "chunk",
          "matmul", "tp")

# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s and ops/s by type
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

S_FLAG, CHUNK_1S = 256, 16000
DEV = "cuda"
# the widths phase's models (`TransducerDims` fields): an int8 model wider
# than kernels 2 and 7 hold, one at widths that are multiples of 4 but not
# of 8, and one at no multiple of 4 (the kernels at padded widths)
WIDE = dict(d_model=1024, hidden=4096, ffn=8192, layers=2)
NARROW = dict(d_model=68, hidden=260, ffn=196, joiner_dim=128, vocab=64, layers=2,
              decoder_groups=4)
ODD = dict(NARROW, d_model=66, hidden=258, ffn=198, decoder_groups=2, conv_channels=(4, 12, 20))
# the `tp` phase's two-rank engines: the flagship's widths at a third of its
# depth (each layer a step costs the ranks' gloo all-reduces through the host)
TP_ENGINE = dict(layers=4)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def bound_ms(n_bytes: float, ops: dict):
    """Least time for the work: bytes over the memory rate vs operations
    over the peak rate of their type (summed over types)."""
    t_mem = n_bytes / HBM_BPS
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items())
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of `fn` (after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _ulp_close(got, want, what):
    """f32 ulps apart except isolated int8 rounding flips: at most 1% of
    elements beyond 1e-5 and none beyond 0.1."""
    d = (got.float() - want.float()).abs()
    frac = float((d > 1e-5).float().mean())
    mx = float(d.max())
    if frac >= 0.01 or mx >= 0.1 or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {frac:.4f} of elements beyond 1e-5, max {mx:.3g}")
    return mx


def _embed_stats(got, want) -> tuple:
    """(max abs err, mean abs err, the share of windows within 1e-5
    everywhere, a summary) of [P, S, d] embeddings."""
    d = (got.float() - want.float()).abs()
    mx, mean = float(d.max()), float(d.mean())
    clean = float((d.reshape(-1, d.shape[-1]).amax(dim=1) <= 1e-5).float().mean())
    stats = (f"{float((d > 1e-4).float().mean()):.4f} of elements beyond 1e-4, mean {mean:.3g}, "
             f"{clean:.3f} of windows within 1e-5")
    return mx, mean, clean, stats


# sup |d/dx DoubleSwish(x)| of x * sigmoid(x - 1) (tanh-form sigmoid): 1.1990,
# at x = 2.796
DSWISH_SLOPE = 1.2


def bf16_step(v: float) -> float:
    """One bf16 rounding step (ulp) at magnitude v: 2^(floor(log2 v) - 7)."""
    return 0.0 if v <= 0 else 2.0 ** (np.floor(np.log2(v)) - 7)


def embed_flip_bound(params, amax) -> float:
    """The largest move of one output of the conv embed when one bf16
    rounding of one activation flips. Kernel 16 and its plain version round
    the same activations to bf16 (conv1's, conv2's and conv3's outputs; the
    front is rounded before any sum, the same in both) after f32 sums in
    other orders, so an ulp of a sum can move one rounded activation by one
    bf16 step (the rounding itself is the same function). A move e of conv3's
    output k moves output o by e * |wo[k, o]|; a move of conv2's output by at
    most e * sum over its paths of DSWISH_SLOPE * |w3| * |wo|; conv1's
    likewise through |w2| and |w3|: conv_transpose2d of those gains by the
    absolute weights, the DoubleSwish slope at each layer. The step is that
    of the largest activation at the point, `amax` (conv1, conv2, conv3 as
    `embed_amax` takes them). Returns max over the three points of step x
    the largest gain from one activation to one output."""
    import torch.nn.functional as F

    w = {k: params[k].to(torch.bfloat16).double().abs().cpu()
         for k in ("conv1_w", "conv2_w", "conv3_w", "embed_out_w")}
    wo = w["embed_out_w"]
    c3 = w["conv3_w"].shape[0]
    g3 = wo.T.reshape(wo.shape[1], c3, 1, wo.shape[0] // c3)  # conv3 row 0 -> out
    g2 = F.conv_transpose2d(g3, w["conv3_w"], stride=2) * DSWISH_SLOPE
    g1 = F.conv_transpose2d(g2, w["conv2_w"], stride=2) * DSWISH_SLOPE
    return max(bf16_step(a) * float(g.max()) for a, g in zip(amax, (g1, g2, g3)))


def embed_amax(params, front, P: int, step: int, seg: int, chunk: int = 8192) -> tuple:
    """The plain version's largest |activation| at each rounding point after
    a sum (conv1, conv2 and conv3's bf16 outputs) over the windows of
    `front` [S, W, mel], a chunk of windows at a time."""
    import torch.nn.functional as F

    from april_asr_tpu_torch.ops.activations import double_swish

    S, _, mel = front.shape
    windows = torch.stack([front[:, j * step : j * step + seg] for j in range(P)])
    windows = windows.reshape(P * S, seg, mel)
    amax = [0.0, 0.0, 0.0]
    for i in range(0, P * S, chunk):
        h = windows[i : i + chunk, None]
        for L, (wk, bk, stride, pad) in enumerate((("conv1_w", "conv1_b", 1, 1),
                                                    ("conv2_w", "conv2_b", 2, 0),
                                                    ("conv3_w", "conv3_b", 2, 0))):
            wt = params[wk].to(torch.bfloat16).float()
            h = F.conv2d(h.to(torch.bfloat16).float(), wt, stride=stride, padding=pad)
            h = double_swish(h + params[bk].float()[None, :, None, None])
            amax[L] = max(amax[L], float(h.to(torch.bfloat16).abs().max()))
    return tuple(amax)


def _embed_close(got, want, what, flip: float, window_stats: bool = True) -> tuple:
    """[P, S, d] embeddings with the same bf16 rounding points and f32 sums
    in another order, held per element to `flip` (`embed_flip_bound`: the
    largest move one flipped bf16 rounding of an activation can make, from
    the weights and the run's activations, at any number of windows; the
    gains sum every path in absolute value, so the few flips one window
    holds stay inside it), finite, and with `window_stats` the mean to 2e-4
    and at least a quarter of the windows within 1e-5 everywhere (a flip
    moves some of a window's outputs; a wrong index or a missed edge
    correction moves every window; 58% are clean at S = 256, P = 27, and
    the ragged check has only 15). Returns (max abs err, a summary)."""
    mx, mean, clean, stats = _embed_stats(got, want)
    if not window_stats:
        mean, clean = 0.0, 1.0
    if mx > flip or mean > 2e-4 or clean < 0.25 or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: max {mx:.3g} (flip bound {flip:.3g}), {stats}")
    return mx, f"{stats}, flip bound {flip:.3g}"


def _bit_equal(got, want, names, what):
    """torch.equal for each output (an int8 kernel against another with the
    same exact integer dots and f32 op order); prints the check."""
    torch.cuda.synchronize()
    for g, w, k in zip(got, want, names):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {k} differs, max abs diff "
                                 f"{float((g - w).abs().max()):.3g} in "
                                 f"{int((g != w).sum())} of {g.numel()} elements")
    print(f"{what}: {', '.join(names)} equal bit for bit")


def _stat_close(got, want, what, mean_tol=5e-3, p99_tol=0.05):
    d = (got.float() - want.float()).abs().flatten().cpu().numpy()
    if d.mean() >= mean_tol or np.percentile(d, 99) >= p99_tol:
        raise AssertionError(f"{what}: mean {d.mean():.5f} p99 {np.percentile(d, 99):.5f}")


def flagship_april(tmp: str, seed: int = 0, dims=None, form: str = "native") -> str:
    """A flagship-width random .april (blank logit biased +2.0 as bench.py
    does), written with the port's save_april in `form` ("native", or
    "onnx": the reference's three graphs); returns its path."""
    from april_asr_tpu_torch.models.export import make_model_parameters, save_april
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
    from april_asr_tpu_torch.testing import default_tokens

    dims = dims or TransducerDims()
    p = init_transducer_params(seed, dims)
    p["join_b"][0] += 2.0
    path = os.path.join(tmp, f"flagship-v{dims.vocab}{'-onnx' if form == 'onnx' else ''}.april")
    save_april(path, dims, p, make_model_parameters(dims, default_tokens(dims.vocab)),
               name="flagship-random", form=form)
    return path


# The kernels each path launches (cuda_build.COUNTS keys), in the step and
# in the flush: the step embeds through kernel 16 at bf16 conv weights (int8
# and bf16), runs the chunk encoder and, where the JAX gate passes and the
# cluster kernel 4 has a plan, kernel 4 (counted as `chunk_decode`); the
# flush runs the one-step encoder (its stacked
# embed is plain) and the per-pull decode (kernel 8, or kernel 9 where its
# gate refuses).
PATH_KERNELS = {
    # kernel 3 (`ffn_norm_i8`) is csrc/ffn_mma.cu's five tensor-core passes
    "int8": {"step": ("fbank_i8", "conv_embed", "lstm_rec_stream2_i8", "ffn_norm_i8",
                      "chunk_decode"),
             "flush": ("fbank_i8", "lstm_step_i8", "dec_joiner")},
    "bf16": {"step": ("fbank_bf16x3", "conv_embed", "lstm_chunk_mma_bf16", "chunk_decode"),
             "flush": ("fbank_bf16x3", "lstm_step_bf16", "dec_joiner")},
    "f32": {"step": ("fbank_bf16x3", "lstm_chunk_mma_f32", "chunk_decode_f32"),
            "flush": ("fbank_bf16x3", "lstm_step_f32", "dec_joiner_f32")},
    "vocab f32": {"step": ("fbank_bf16x3", "lstm_chunk_mma_f32", "joiner_argmax_f32"),
                  "flush": ("fbank_bf16x3", "lstm_step_f32", "joiner_argmax_f32")},
    "vocab bf16": {"step": ("fbank_bf16x3", "conv_embed", "lstm_chunk_mma_bf16", "joiner_argmax"),
                   "flush": ("fbank_bf16x3", "lstm_step_bf16", "joiner_argmax")},
    # the int8 routes of a model wider than kernels 2 and 7 hold: kernel 14,
    # kernel 3 (no width limit), the three-pass int8 step
    "wide int8": {"step": ("fbank_i8", "conv_embed", "lstm_rec_stream_i8", "ffn_norm_i8",
                           "chunk_decode"),
                  "flush": ("fbank_i8", "lstm_step_i8_simt", "dec_joiner")},
    # a float model at d 68 (not a 128-multiple: the decode goes pull by
    # pull through kernel 9, as the JAX gates route it)
    "narrow f32": {"step": ("fbank_bf16x3", "lstm_chunk_mma_f32", "joiner_argmax_f32"),
                   "flush": ("fbank_bf16x3", "lstm_step_f32", "joiner_argmax_f32")},
    "narrow bf16": {"step": ("fbank_bf16x3", "conv_embed", "lstm_chunk_mma_bf16", "joiner_argmax"),
                    "flush": ("fbank_bf16x3", "lstm_step_bf16", "joiner_argmax")},
    # a model at d 66 / H 258 / F 198: the layer kernels at padded widths,
    # the decode pull by pull through kernel 9
    "d66 f32": {"step": ("fbank_bf16x3", "lstm_chunk_mma_f32", "joiner_argmax_f32"),
                "flush": ("fbank_bf16x3", "lstm_step_f32", "joiner_argmax_f32")},
    "d66 int8": {"step": ("fbank_i8", "conv_embed", "lstm_rec_stream2_i8", "ffn_norm_i8",
                          "joiner_argmax"),
                 "flush": ("fbank_i8", "lstm_step_i8", "joiner_argmax")},
    # the tensor-parallel engine (one rank's counts): the per-pull recurrent
    # step on kernels 19 and 21 (int8) or 18 and 20 (f32) and kernel 8, no
    # chunk kernel; the f32 step keeps the stacked embed
    "tp int8": {"step": ("fbank_i8", "conv_embed", "tp_gc_i8", "tp_ffn_mid_i8", "dec_joiner"),
                "flush": ("fbank_i8", "tp_gc_i8", "tp_ffn_mid_i8", "dec_joiner")},
    "tp f32": {"step": ("fbank_bf16x3", "tp_gcp_f32", "tp_ffn_f32", "dec_joiner_f32"),
               "flush": ("fbank_bf16x3", "tp_gcp_f32", "tp_ffn_f32", "dec_joiner_f32")},
    # the ONNX interpreter's engine: kernel 5, every graph node plain torch
    "onnx interp": {"step": ("fbank_bf16x3",), "flush": ("fbank_bf16x3",)},
    # a Session's batch-1 engine: S = 1 is no multiple of the fbank kernels'
    # 8-session tile, so its frontend is the f32 DFT, as JAX routes it
    # (frontend/fbank.py `fused_supported`); its chunk decode is kernel 4
    "session int8": {"step": ("conv_embed", "lstm_rec_stream2_i8", "ffn_norm_i8", "chunk_decode"),
                     "flush": ("lstm_step_i8", "dec_joiner")},
    "session f32": {"step": ("lstm_chunk_mma_f32", "chunk_decode_f32"),
                    "flush": ("lstm_step_f32", "dec_joiner_f32")},
}


def require_launches(what: str, path: str, half: str, counts: dict | None = None) -> dict:
    """The launch counts since the last reset (or `counts`, a rank's);
    fails if a kernel of the path's step or flush (`half`) never launched,
    or any other kernel did."""
    from april_asr_tpu_torch.ops import cuda_build

    keys = PATH_KERNELS[path][half]
    counts = cuda_build.COUNTS if counts is None else counts
    launches = {k: counts.get(k, 0) for k in set(counts) | set(keys) if counts.get(k) or k in keys}
    missing = [k for k in keys if launches[k] == 0]
    stray = [k for k in launches if k not in keys]
    if missing or stray:
        raise AssertionError(f"{what}: kernels never launched: {missing}; "
                             f"kernels of another path launched: {stray}")
    return launches


def no_simt_joiner(what: str, counts: dict) -> None:
    """Kernel 8 ran on its cluster route: the CUDA-core kernels it replaced
    (`dec_joiner_simt`) launched no time in `counts`."""
    n = {k: counts.get(k, 0) for k in ("dec_joiner_simt", "dec_joiner_simt_f32")}
    if any(n.values()):
        raise AssertionError(f"{what}: dec_joiner_simt launched {n}")


def _merge(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


# -- phases -------------------------------------------------------------------


def phase_build(card):
    from april_asr_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # the mangled name, cut after its template arguments
                entry = " " + m.group(1)[:40]
            if "Used" in line or "error" in line.lower():
                print(f"  nvcc {name}{entry}: {line.strip()}")
    print(f"build: {len(logs)} sources in {dt:.1f} s ({card})")
    from april_asr_tpu_torch import native

    path, log, secs = native.build_native()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout.splitlines()
    print(f"build: host runtime native/april_native.cc -> {path.name} with g++ "
          f"{' '.join(native.GXX_FLAGS)} in {secs:.1f} s ({gxx[0] if gxx else 'g++'})"
          f"{': ' + log.strip() if log.strip() else ''}")
    check_mma_sass()


# the tensor-core kernels, by source and the start of their mangled names:
# kernels 2 and 7 (csrc/lstm_mma.cu) and kernel 3's two product passes
# (csrc/ffn_mma.cu, ff1 and ff2), int8 on IMMA; kernel 1 (csrc/fbank_mma.cu)
# on IMMA and FFMA; kernel 5 (csrc/fbank_bf16x3_tile.cu, R = 6 and 7), kernel
# 6 (csrc/fbank_frames_tile.cu, R = 6..9) and kernels 16 and 17
# (csrc/conv_embed_tile.cu: the two conv stacks at c1 = 4 and 8, the
# projection) on FFMA alone; kernels 12
# (csrc/lstm_mma_float.cu) and 10 (csrc/lstm_chunk_mma.cu): `<float>` on
# FFMA, `<unsigned short>` bf16 on HMMA; kernel 23 (csrc/mm_wgmma.cu, three
# forms x two tiles) on `wgmma`: bf16 HGMMA, the int8 forms IGMMA; kernel 8
# (csrc/dec_joiner_cluster.cu, two weight types x dec_proj resident or
# streamed) on FFMA alone, in dec_joiner_simt's order; kernel 9
# (csrc/joiner_stream.cu, two weight types x four register tiles x W
# resident or streamed) on FFMA alone, in joiner.cu's order; kernel 18
# (csrc/lstm_tp_gates.cu, rounding x stage depth) on FFMA alone,
# kernel 19 (three gate-item widths) on IMMA; kernel 20 (csrc/lstm_tp_ffn.cu,
# f32 and bf16) on FFMA alone, in tp_cols' order, kernel 21 (three
# column-tile counts) on IMMA; kernels 14 and 13 (csrc/lstm_hoist.cu: phase
# A's tile pass, phase B at 8-, 16- and 32-unit gate items) and kernel 11
# (phase B and kernel 3's passes in one launch, at the same three widths)
# on IMMA; kernel 15 (csrc/lstm_wavefront_hoist.cu, one launch a slab) on
# IMMA
MMA_SOURCES = (
    ("lstm_mma.cu", ("_Z19lstm_rec_mma_kernel", "_Z20lstm_step_mma_kernel"), 6),
    ("lstm_mma_float.cu", ("_Z26lstm_step_float_mma_kernel",), 2),
    ("lstm_chunk_mma.cu", ("_Z27lstm_chunk_float_mma_kernel",), 2),
    ("ffn_mma.cu", ("_Z13ffn_mm_kernel",), 2),
    ("fbank_mma.cu", ("_Z16fbank_mma_kernel",), 1),
    ("fbank_bf16x3_tile.cu", ("_Z17fbank_tile_kernel",), 2),
    ("fbank_frames_tile.cu", ("_Z24fbank_frames_tile_kernel",), 4),
    ("conv_embed_tile.cu", ("_Z17conv_stack_kernel", "_Z17conv_front_kernel",
                            "_Z16conv_proj_kernel"), 5),
    ("mm_wgmma.cu", ("_Z15mm_wgmma_kernel",), 6),
    ("dec_joiner_cluster.cu", ("_Z25dec_joiner_cluster_kernel",), 4),
    ("joiner_stream.cu", ("_Z20joiner_stream_kernel",), 16),
    ("lstm_tp_gates.cu", ("_Z13tp_gcp_kernel", "_Z15tp_gc_i8_kernel"), 7),
    ("lstm_tp_ffn.cu", ("_Z13tp_ffn_kernel", "_Z16tp_mid_i8_kernel"), 5),
    ("lstm_hoist.cu", ("_Z21lstm_rec_hoist_kernel", "_Z15hoist_gx_kernel",
                       "_Z23lstm_chunk_hoist_kernel"), 7),
    ("lstm_wavefront_hoist.cu", ("_Z27lstm_wavefront_hoist_kernel",), 1),
)


def sass_rule(kernel: str, insns: list) -> str:
    """Why a persistent kernel's SASS is wrong ("" where it is right): the
    int8 kernels need IMMA; kernel 1 IMMA and FFMA (its residual and mel on
    the CUDA cores) and no HMMA; kernels 5 and 6 FFMA and no tensor-core
    instruction (their sums keep fbank_bf16x3.cu's order), kernels 16, 17,
    8, 9 and 18 likewise (conv_embed.cu's, joiner.cu's and lstm_step.cuh's
    orders), and kernel 20 (`tp_ffn`, tp_cols' order); kernels 19 (`tp_gc_i8`) and 21
    (`tp_mid_i8`) IMMA; kernels 12 and 10 at bf16 HMMA, at f32 FFMA and
    no tensor-core instruction (no TF32); kernel 23 (mm_wgmma.cu) HGMMA at
    bf16 (`<0, ...>`), IGMMA in its int8 forms, and no other tensor-core
    instruction."""
    n = lambda op: sum(op in i for i in insns)  # noqa: E731
    if "mm_wgmma" in kernel:
        mine, other = ("HGMMA", "IGMMA") if "ILi0E" in kernel else ("IGMMA", "HGMMA")
        ok = n(mine) and not (n(other) or n("HMMA") or n("IMMA"))
        return "" if ok else f"not {mine} alone"
    if ("fbank_tile" in kernel or "frames_tile" in kernel or "conv_stack" in kernel
            or "conv_front" in kernel or "conv_proj" in kernel
            or "dec_joiner_cluster" in kernel or "joiner_stream" in kernel or "tp_gcp" in kernel
            or "tp_ffn" in kernel):
        return "" if n("FFMA") and not n("HMMA") and not n("IMMA") else "not FFMA alone"
    if "fbank" in kernel:
        return "" if n("IMMA") and n("FFMA") and not n("HMMA") else "not IMMA and FFMA alone"
    if "float_mma" not in kernel:
        return "" if n("IMMA") else "no IMMA instruction"
    if "IfE" in kernel:
        return "" if n("FFMA") and not n("HMMA") and not n("IMMA") else "not FFMA alone"
    return "" if n("HMMA") else "no HMMA instruction"


def check_mma_sass():
    """csrc/lstm_mma.cu, lstm_mma_float.cu, lstm_chunk_mma.cu, ffn_mma.cu,
    fbank_mma.cu, fbank_bf16x3_tile.cu, fbank_frames_tile.cu,
    conv_embed_tile.cu, mm_wgmma.cu,
    dec_joiner_cluster.cu, joiner_stream.cu, lstm_tp_gates.cu and lstm_tp_ffn.cu compiled
    again to cubins, all at once: each
    tiled kernel's registers, shared memory and spills (`-Xptxas -v`; a
    spill fails) and its SASS (`sass_rule`)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.tools import sass_diff

    def compiled(src):
        with tempfile.TemporaryDirectory() as tmp:
            return sass_diff.compile_sass(cuda_build.CSRC / src, Path(tmp))

    with ThreadPoolExecutor(len(MMA_SOURCES)) as pool:
        built = list(pool.map(compiled, [src for src, _, _ in MMA_SOURCES]))
    for (src, prefixes, count), (log, funcs) in zip(MMA_SOURCES, built):
        props = sass_diff.ptxas_properties(log)
        found = [k for k in funcs if k.startswith(prefixes)]
        if len(found) < count:
            raise AssertionError(f"{src}: expected {count} kernel instantiations, found {found}")
        for k in sorted(found):
            ops = {op: sum(op in i for i in funcs[k])
                   for op in ("IMMA", "HMMA", "IGMMA", "HGMMA", "FFMA")}
            prop = props.get(k, "no ptxas report")
            print(f"  sass {src} {k[:44]}: {prop}; {ops} of {len(funcs[k])} instructions")
            why = sass_rule(k, funcs[k])
            if re.search(r"[1-9]\d* bytes spill", prop):
                why = why or "spills"
            if why:
                raise AssertionError(f"{src} {k}: {why}")


def _check_decode(rt, S: int, P: int, rng, dev, t) -> dict:
    """Kernel 4 on `rt`'s decode weights (bf16 or f32): P pulls x 3 rounds
    from an aged state (`profile_decode.decode_case`), so every heuristic
    runs. The cluster kernel (`chunk_decode`, on the card's plan) equals the
    CUDA-core kernel (`chunk_decode_simt`) bit for bit, every event and
    state key, dout and logprob included, and both are held to the plain
    version. Returns {row: (kernel call, plain call, max abs err, bound,
    shape)} for both kernels."""
    from april_asr_tpu_torch.decode.greedy import vocab_tables_device
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import decode_kernels as DK
    from april_asr_tpu_torch.tools.profile_decode import decode_case

    w, dims = rt.weights, rt.dims
    d, J, V = dims.d_model, dims.joiner_dim, dims.vocab
    dargs, dkw = decode_case(w, vocab_tables_device(rt.vocab), rt.blank_id,
                             rt.fbank_opts.segment_stride_ms, S, P, rng, dev)
    st, T = dargs[2], dkw["dcfg"].max_active_tokens
    f32 = w["join_t"].dtype == torch.float32
    plan = DK.device_decode_plan(S, J, d, V, T, w["join_t"].element_size(), dev)
    if plan is None:
        raise AssertionError(f"chunk_decode: no cluster plan at S={S}, J={J}, d={d}, V={V}")
    kf = lambda: DK.chunk_decode(*dargs, **dkw)  # noqa: E731
    sf = lambda: DK.chunk_decode_simt(*dargs, **dkw)  # noqa: E731
    pf = lambda: DK.chunk_decode_plain(*dargs, **dkw)  # noqa: E731
    key = "chunk_decode_f32" if f32 else "chunk_decode"
    before = cuda_build.COUNTS[key]
    (gs, ge), (ss, se), (ws, we) = kf(), sf(), pf()
    if cuda_build.COUNTS[key] != before + 1:
        raise AssertionError(f"chunk_decode: the cluster kernel did not launch at S={S}")
    shape = (f"eouts[{P},{S},{J}] V={V}; plan C={plan.C} TS={plan.TS} clusters={plan.clusters} "
             f"waves={plan.waves} dec_proj {'resident' if plan.dp_smem else 'streamed'} "
             f"smem={plan.smem}")
    ints = lambda x: x.int() if x.dtype == torch.bool else x  # noqa: E731
    _bit_equal([ints(ge[k]) for k in DK.EVENT_KEYS] + [ints(gs[k]) for k in STATE_KEYS],
               [ints(se[k]) for k in DK.EVENT_KEYS] + [ints(ss[k]) for k in STATE_KEYS],
               [f"events[{k}]" for k in DK.EVENT_KEYS] + [f"state[{k}]" for k in STATE_KEYS],
               f"kernel 4 {'f32' if f32 else 'bf16'} S={S}: the cluster kernel against "
               f"chunk_decode_simt ({shape})")
    out = {}
    for name, (gs, ge) in ((key, (gs, ge)), (key.replace("decode", "decode_simt"), (ss, se))):
        for k in ("ops", "tok", "flags", "time_ms", "final_k"):
            if not torch.equal(ge[k], we[k]):
                raise AssertionError(f"{name} events[{k}] differ from the plain version")
        for k in STATE_KEYS[:-1]:
            if not torch.equal(gs[k], ws[k]):
                raise AssertionError(f"{name} state[{k}] differs from the plain version")
        out[name] = _decode_close(gs, ge, ws, we, st, J, d, V, T, P, S, f32, name)
    return {name: (kf if name == key else sf, pf, err, b, f"{shape} {stats}")
            for name, (err, b, stats) in out.items()}


# kernel 4's state keys, integers first (dout last)
STATE_KEYS = ("context", "token_words", "head", "last_call", "time_ms", "last_emit_ms",
              "need_dec", "emitted_silence", "dout")


def _decode_close(gs, ge, ws, we, st, J, d, V, T, P, S, f32, name) -> tuple:
    """logprob and dout of a kernel 4 held to the plain version; (max abs
    err, bound, stats)."""
    # dout: an f32 sum of the same products taken in another order (1e-5).
    # logprob with bf16 weights: the joiner rounds tanh(eout + dout) to bf16,
    # so an ulp of dout can flip that rounding and move one product term by
    # up to 2^-8 of |tanh| * |w| (~3e-4 here): 1e-3, the bound the CPU parity
    # test holds bf16 weights to. With f32 weights nothing is rounded to
    # bf16, so logprob is held to the f32 sum-order bound, 1e-5, as dout.
    lp_tol = 1e-5 if f32 else 1e-3
    torch.testing.assert_close(gs["dout"], ws["dout"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ge["logprob"], we["logprob"], atol=lp_tol, rtol=lp_tol)
    err = max(float((ge["logprob"] - we["logprob"]).abs().max()),
              float((gs["dout"] - ws["dout"]).abs().max()))
    n_ev = int((ge["ops"] != 0).sum())
    if n_ev < P * S // 4:
        raise AssertionError(f"{name}: only {n_ev} events, heuristics not exercised")
    # the work this run's data needs: joiner rows for active (session, pull,
    # round) cells; decoder refreshes after emissions and for sessions that
    # entered with need_dec
    n_act = int((ge["time_ms"] != 0).sum())
    n_ref = int(st["need_dec"].sum()) + int(((ge["ops"] & 8) != 0).sum())
    wb = 4 if f32 else 2
    b = bound_ms(
        P * S * (J + 1) * 4 + 6 * P * S * 3 * 4 + S * (2 * J + 2 * T + 16) * 4
        + 2 * V * d * 4 + (d * J + J * V) * wb + (J + 2 * V) * 4,
        {"f32" if f32 else "bf16": n_act * 2 * J * V + n_ref * 2 * d * J},
    )
    return err, b, f"events={n_ev} active_cells={n_act}"


def _check_joiner(rt, S: int, rng, dev, t, refresh: bool) -> dict:
    """Kernel 8 (`refresh`: decoder refresh, then joiner and argmax) or
    kernel 9 (joiner and argmax) on `rt`'s decode weights at S sessions,
    need_dec at 50%. max_idx must be equal wherever the plain version's top
    two non-blank logits differ by more than 1e-4; max_val, blank_val and
    dout' are held to atol 1e-4: f32 sums of the same products in another
    order differ by f32 ulps of these unit-scale logits. Kernel 8's route
    (the cluster kernel where `dj_plan` has a plan) must equal the CUDA-core
    kernels it replaced (`dec_joiner_simt`) on all four outputs, bit for
    bit, in the same call, and kernel 9's (csrc/joiner_stream.cu where
    `joiner_plan` has a plan) `joiner_argmax_simt` on its three; both are
    held to the plain version. Returns {row: (kernel call, plain call, max
    abs err, bound, shape)}: kernel 8's or 9's route and the CUDA-core
    kernels it replaced."""
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import decode_kernels as DK
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.ops import joiner_plan as JP

    w, dims = rt.weights, rt.dims
    d, J, V, blank = dims.d_model, dims.joiner_dim, dims.vocab, rt.blank_id
    eout = t((rng.normal(size=(S, J)) * 2.0).astype(np.float32))
    dout = t(rng.normal(size=(S, J)).astype(np.float32))
    ctx = t(rng.integers(0, V, size=(S, 2)).astype(np.int32))
    nd = t(rng.random(S) < 0.5)
    dec = (w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"], w["join_b"])
    f32 = w["join_t"].dtype == torch.float32
    sfx = "_f32" if f32 else ""
    calls = {}
    if refresh:
        calls["dec_joiner" + sfx] = lambda: JK.decoder_joiner_argmax_fused(  # noqa: E731
            ctx, nd, dout, eout, *dec, blank_id=blank)
        calls["dec_joiner_simt" + sfx] = lambda: JK.decoder_joiner_argmax_simt(  # noqa: E731
            ctx, nd, dout, eout, *dec, blank)
        pf = lambda: JK.decoder_joiner_argmax_plain(ctx, nd, dout, eout, *dec, blank)  # noqa: E731
    else:
        calls["joiner_argmax" + sfx] = lambda: JK.joiner_argmax_fused(  # noqa: E731
            eout, dout, w["join_t"], w["join_b"], blank_id=blank)
        calls["joiner_argmax_simt" + sfx] = lambda: JK.joiner_argmax_simt(  # noqa: E731
            eout, dout, w["join_t"], w["join_b"], blank)
        pf = lambda: JK.joiner_argmax_plain(eout, dout, w["join_t"], w["join_b"], blank)  # noqa: E731
    want = pf()
    got = {}
    for name, kf in calls.items():
        before = cuda_build.COUNTS[name]
        got[name] = kf()
        if cuda_build.COUNTS[name] != before + 1:
            raise AssertionError(f"{name}: not launched on its route at S={S}")
    torch.cuda.synchronize()
    wb = 4 if f32 else 2
    shape = f"eout[{S},{J}] d={d} V={V}"
    if refresh:
        plan = DK.device_dj_plan(S, J, d, V, wb, torch.device(dev).index or 0)
        shape += (f"; plan C={plan.C} TS={plan.TS} clusters={plan.clusters} waves={plan.waves} "
                  f"dec_proj {'resident' if plan.dp_smem else 'streamed'} smem={plan.smem}")
        _bit_equal(got["dec_joiner" + sfx], got["dec_joiner_simt" + sfx],
                   ("max_idx", "max_val", "blank_val", "dout'"),
                   f"kernel 8 {'f32' if f32 else 'bf16'} S={S} need_dec 50%: the cluster kernel "
                   f"against dec_joiner_simt")
    else:
        shape += "; " + k9_plan_line(JP.device_joiner_plan(S, J, V, wb, torch.device(dev).index or 0))
        _bit_equal(got["joiner_argmax" + sfx], got["joiner_argmax_simt" + sfx],
                   ("max_idx", "max_val", "blank_val"),
                   f"kernel 9 {'f32' if f32 else 'bf16'} S={S} V={V}: the stream kernel against "
                   f"joiner_argmax_simt")
    clear = _clear_rows(eout, want[3] if refresh else dout, w["join_t"], w["join_b"], blank,
                        f"kernel {8 if refresh else 9}")
    n_bytes = S * (2 * J * 4 + 12) + J * V * wb + V * 4
    ops = 2 * S * J * V
    if refresh:
        # the refresh reads only the table rows the contexts name
        rows = len(torch.unique(ctx[:, 0])) + len(torch.unique(ctx[:, 1]))
        n_bytes += S * (8 + 1 + J * 4) + rows * d * 4 + d * J * wb + J * 4
        ops += 2 * S * d * J
    b = bound_ms(n_bytes, {"f32" if f32 else "bf16": ops})
    out = {}
    for name, g in got.items():
        if not torch.equal(g[0][clear], want[0][clear]):
            raise AssertionError(f"{name}: max_idx differs from the plain version")
        err = 0.0
        for i, what in ((1, "max_val"), (2, "blank_val"), (3, "dout'"))[: 3 if refresh else 2]:
            torch.testing.assert_close(g[i], want[i], atol=1e-4, rtol=0, msg=f"{name} {what}")
            err = max(err, float((g[i] - want[i]).abs().max()))
        out[name] = (calls[name], pf, err, b, shape)
    return out


def _clear_rows(eout, dout, w_t, b, blank: int, what: str, least: float = 0.9):
    """The sessions whose top two non-blank logits (the plain version's)
    differ by more than 1e-4, where max_idx is held; fails where fewer than
    `least` of them are."""
    from april_asr_tpu_torch.ops.activations import dot_wd

    logits = dot_wd(torch.tanh(eout + dout), w_t) + b
    logits[:, blank] = -float("inf")
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    if float(clear.float().mean()) < least:
        raise AssertionError(f"{what}: only {int(clear.sum())} of {len(clear)} rows clear of a "
                             f"near-tie")
    return clear


def k9_plan_line(p) -> str:
    """Kernel 9's plan (ops/joiner_plan.py `JoinerPlan`) in one line."""
    return (f"plan tile {p.RC}x{p.RS}, Vc={p.Vc}, TS={p.TS}, {p.blocks} blocks ({p.n_vs} slices x "
            f"{p.n_sg} session groups, {p.blocks_per_sm} an SM), {p.rounds} tiles a block, W "
            f"{'resident' if p.w_resident else 'streamed'}, {p.smem} bytes of shared memory")


# Kernels 10 and 12 against their plain versions. f32 weights: true f32
# products summed in another order, atol 1e-4, rtol 1e-4 (kernel 10 measured
# 5.25e-6 on the H100 at S=256, P=27), so a kernel with TF32 or bf16-rounded
# products (errors ~1e-3 on these unit-scale rows) fails. bf16 weights: an
# f32 ulp can flip the bf16 rounding of an activation, moving a product by
# 2^-8 of itself: the repo's bf16 bound, atol 5e-2, rtol 1e-3
# (tests/test_lstm_pallas.py:56)
FLOAT_TOL = {"f32": (1e-4, 1e-4), "bf16": (5e-2, 1e-3)}


def _float_close(got, want, what: str, prec: str) -> float:
    atol, rtol = FLOAT_TOL[prec]
    err = 0.0
    for g, wv, k in zip(got, want, ("y", "h", "c")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} {k}: non-finite values")
        torch.testing.assert_close(g, wv, atol=atol, rtol=rtol, msg=f"{what} {k}")
        err = max(err, float((g - wv).abs().max()))
    return err


def check_chunk_float(x, h, c, lw, n_pulls, prec: str) -> tuple:
    """Kernel 10 (`lstm_layer_chunk_fused`) on one layer's weights `lw`
    (`TM.STEP_KEYS` order) against its plain version; its bound counts x,
    h, c, n_pulls and the weights read once, y, h' and c' written once, and
    the gate, projection and FFN products at the weights' rate."""
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF

    (P, S, d), H, F = x.shape, c.shape[1], lw[4].shape[1]
    kf = lambda: LF.lstm_layer_chunk_fused(x, h, c, *lw, n_pulls)  # noqa: E731
    pf = lambda: LF.lstm_layer_chunk_plain(x, h, c, *lw, n_pulls)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    err = _float_close(got, want, f"lstm_chunk_mma_{prec} at S={S}, P={P}, d={d}, H={H}, F={F}",
                       prec)
    wb = lw[0].element_size()
    b = bound_ms(
        2 * P * S * d * 4 + 2 * S * (d + H) * 4 + S * 4 + (2 * d * 4 * H + H * d + 2 * d * F) * wb
        + (4 * H + F + d) * lw[2].element_size() + 4,
        {prec: 2 * P * S * (2 * d * 4 * H + H * d + 2 * d * F)},
    )
    return kf, pf, err, b, f"x[{P},{S},{d}] H={H} ffn={F}"


def check_float_widths(S: int, P: int, seed: int) -> None:
    """Kernels 10 and 12 at widths the flagship model does not reach, on
    random weights: d 512 / H 2048 / F 4096, where the two-kernel chunk
    layer's FFN tile did not fit, and d 68 / H 260 / F 196, where bf16
    weight rows are only 8-byte aligned; f32 and bf16, gated."""
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF
    from april_asr_tpu_torch.tools.profile_lstm_mma import float_layer

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    for d, H, F in ((512, 2048, 4096), (68, 260, 196)):
        x = t(rng.normal(size=(P, S, d)).astype(np.float32))
        h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
        n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
        gate = t(rng.random(S) < 0.5)
        for prec, wd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            lw = float_layer(d, H, F, wd, torch.device(DEV), seed=seed)
            err10 = check_chunk_float(x, h, c, lw, n, prec)[2]
            got = LF.lstm_layer_fused(x[0], h, c, *lw, gate)
            err12 = _float_close(got, LF.lstm_layer_fused_plain(x[0], h, c, *lw, gate),
                                 f"lstm_step_{prec} at S={S}, d={d}, H={H}, F={F}", prec)
            print(f"widths d={d} H={H} F={F} {prec}: kernel 10 (S={S}, P={P}, gated) max_abs_err "
                  f"{err10:.3g}, kernel 12 (S={S}, gated) {err12:.3g}")


def ffn_bounds(R: int, d: int, F: int, bias_bytes: int):
    """Kernel 3's bound (the function's bytes: x and hseq read, y written,
    the weights, scales and biases once; its int8 operations) and its
    design's byte bound: the bytes its five passes move through device
    memory (x and hseq twice, yq, mid f32 and mq written and read once, y
    written, read and written by the norm), over 3.35 TB/s."""
    w_bytes = 2 * d * F + 4 * (F + d) + bias_bytes * (F + d) + 4
    fn = bound_ms(3 * R * d * 4 + w_bytes, {"int8": 2 * 2 * R * d * F})
    design = (4 * R * d * 4 + 3 * R * d * 4 + 2 * R * _up64(d) + 2 * R * F * 4
              + 2 * R * _up64(F) + w_bytes)
    return fn, design / HBM_BPS * 1e3


def _up64(n: int) -> int:
    return -(-n // 64) * 64


def check_ffn(xr, hs, fa, tiles, name: str) -> tuple:
    """Kernel 3 (`LK.ffn_norm_i8`, csrc/ffn_mma.cu) on rows xr, hs [R, d]
    and the layer's FFN weights `fa`: within `_ulp_close` of the plain
    version, and bit for bit the CUDA-core kernel it replaced
    (`LK.ffn_norm_i8_simt`) on each row tile of `tiles`. Returns its check
    entry (kernel call, plain call, max abs err, bound, shape)."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK

    (R, d), F = xr.shape, fa[0].shape[1]
    kf = lambda: LK.ffn_norm_i8(xr, hs, *fa)  # noqa: E731
    pf = lambda: LK.ffn_norm_plain(xr, hs, *fa)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    for rows in tiles:
        _bit_equal([got], [LK.ffn_norm_i8_simt(xr, hs, *fa, rows=rows)], ("y",),
                   f"{name} (tensor cores) vs the CUDA-core kernel 3 on {rows}-row tiles at "
                   f"R={R}, d={d}, ffn={F}")
    b, _ = ffn_bounds(R, d, F, fa[2].element_size())
    return kf, pf, _ulp_close(got, want, name), b, f"rows[{R},{d}] ffn={F}"


def ffn_inputs(rt, R: int, seed: int) -> tuple:
    """Rows x, hseq [R, d] drawn from a numpy seed on the card and the
    layer-0 FFN weights of the int8 runtime `rt` (kernel 3's arguments)."""
    rng = np.random.default_rng(seed)
    d, w = rt.dims.d_model, rt.weights
    xr, hs = (torch.from_numpy(rng.normal(size=(R, d)).astype(np.float32)).to(DEV) for _ in "xh")
    return xr, hs, tuple(w[k][0] for k in ("ff1_t_q8", "ff1_t_q8s", "ff1_b", "ff2_t_q8",
                                           "ff2_t_q8s", "ff2_b", "norm_eps"))


def ffn_yardstick(xr, hs, fa, rows: int, card, reps: int) -> None:
    """Kernel 3's time beside the CUDA-core kernel it replaced (on `rows`-row
    tiles) on the same inputs, and its design's byte bound."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK

    (R, d), F = xr.shape, fa[0].shape[1]
    k_ms = cuda_ms(lambda: LK.ffn_norm_i8(xr, hs, *fa), reps)
    s_ms = cuda_ms(lambda: LK.ffn_norm_i8_simt(xr, hs, *fa, rows=rows), max(3, reps // 4), warmup=1)
    (b_ms, b_by), design_ms = ffn_bounds(R, d, F, fa[2].element_size())
    print(f"ffn_norm_i8 beside the CUDA-core kernel 3 ({rows}-row tiles) at R={R}, d={d}, "
          f"ffn={F}: ms={k_ms:.4f} simt_ms={s_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"design_bytes_ms={design_ms:.4f} ({card})")


def fbank_buffer(S: int, L: int, rng, dev) -> torch.Tensor:
    """[S, L] hop-row buffers of PCM16 values (x / 32768)."""
    pcm = (rng.normal(0, 0.25, (S, L)) * 32768).clip(-32768, 32767).astype(np.int16)
    return torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(dev)


def fbank_i8_ops(S: int, F: int, K: int, N2: int, mel_ops: int) -> dict:
    """Kernel 1's operations: the two int8 planes against the DFT's hi
    plane, the bf16 residual and the bf16x3 mel."""
    return {"int8": 2 * 2 * S * F * K * N2, "bf16": 2 * S * F * K * N2 + mel_ops}


# Kernels 1 and 5 by number: the launch count of the route's kernel, its
# entry, the CUDA-core kernel it displaces (whose count is its name), the
# plain version, the plan, and the profiler's names of the two kernels
FBANK = {
    1: dict(count="fbank_i8", source="csrc/fbank_mma.cu", route="logmel_rows_from_buf_i8",
            simt="fbank_i8_simt", plain="logmel_rows_from_buf_i8_plain", plan="plan_for",
            keys=("fbank_mma_kernel", "fbank_kernel")),
    5: dict(count="fbank_bf16x3", source="csrc/fbank_bf16x3_tile.cu",
            route="logmel_rows_from_buf", simt="fbank_bf16x3_simt",
            plain="logmel_rows_from_buf_plain", plan="bf16x3_plan_for",
            keys=("fbank_tile_kernel", "fbank_bf16x3_kernel")),
}


def check_fbank(kernel: int, layout, S: int, rng, dev, buf=None) -> dict:
    """Kernel 1 or 5 at S sessions of `layout`'s frames: the route launches
    its tiled kernel (its count, and no CUDA-core launch), which is held at
    the fbank bound to the plain version and bit for bit to the CUDA-core
    kernel it displaces; every other session silent gives rows of exactly
    log(K_EPS), and a second launch equals the first bit for bit. `buf`,
    where given, replaces the random samples (its odd sessions silenced all
    the same). Returns {"F", "plan", "err_plain", "err_simt"}."""
    from april_asr_tpu_torch.frontend.oracle import K_EPS
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import fbank_kernels as FK

    k = FBANK[kernel]
    route, simt_fn, plain, plan_for = (getattr(FK, k[n]) for n in ("route", "simt", "plain", "plan"))
    c = FK.fbank_constants(layout, dev)
    F = layout.max_frames
    buf = fbank_buffer(S, layout.buf_len, rng, dev) if buf is None else buf
    buf[1::2] = 0.0
    before = dict(cuda_build.COUNTS)
    got = route(layout, buf)
    again = route(layout, buf)
    launched = {n: cuda_build.COUNTS[n] - before[n] for n in (k["count"], k["simt"])}
    plan = plan_for(c, S, F)
    what = f"{k['count']} {layout.opts.sample_freq:g} Hz S={S} F={F}"
    if launched != {k["count"]: 2, k["simt"]: 0} or plan is None:
        raise AssertionError(f"{what}: the route launched {launched} ({plan}), not "
                             f"{k['source']} twice")
    want = plain(c, buf, F)
    simt = simt_fn(c, buf, F)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4, msg=f"{what} vs plain")
    if not torch.equal(got, simt):
        raise AssertionError(f"{what}: differs from {k['simt']} (max abs "
                             f"{float((got - simt).abs().max()):.3g} in "
                             f"{int((got != simt).sum())} of {got.numel()}), not bit for bit")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")
    silent = torch.log(torch.tensor(float(K_EPS), dtype=torch.float32, device=dev))
    if not bool((got[1::2] == silent).all()):
        raise AssertionError(f"{what}: silent sessions are not log(K_EPS) bit for bit")
    return {"F": F, "plan": plan, "err_plain": float((got - want).abs().max()),
            "err_simt": float((got - simt).abs().max())}


def check_frames(layout, S: int, rng, dev, buf=None) -> dict:
    """Kernel 6 at S sessions of `layout`'s frames, formed from hop-row
    buffers (`frames_from_buf`): the route launches csrc/fbank_frames_tile.cu
    on its plan (its count, and no CUDA-core launch), held at the fbank
    bound to the plain version and bit for bit to `fbank_frames_simt`; every
    other session silent gives rows of exactly log(K_EPS), and a second
    launch equals the first bit for bit. `buf`, where given, replaces the
    random samples (its odd sessions silenced all the same). Returns {"F",
    "plan", "err_plain", "err_simt"}."""
    from april_asr_tpu_torch.frontend.oracle import K_EPS
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import fbank_kernels as FK

    c = FK.fbank_constants(layout, dev)
    F = layout.max_frames
    buf = fbank_buffer(S, layout.buf_len, rng, dev) if buf is None else buf
    buf[1::2] = 0.0
    frames = FK.frames_from_buf(layout, buf)
    before = dict(cuda_build.COUNTS)
    got = FK.logmel_rows_fused(layout, frames)
    again = FK.logmel_rows_fused(layout, frames)
    launched = {n: cuda_build.COUNTS[n] - before[n] for n in ("fbank_frames", "fbank_frames_simt")}
    plan = FK.frames_plan_for(c, S, F)
    what = f"fbank_frames {layout.opts.sample_freq:g} Hz S={S} F={F}"
    if launched != {"fbank_frames": 2, "fbank_frames_simt": 0} or plan is None:
        raise AssertionError(f"{what}: the route launched {launched} ({plan}), not "
                             "csrc/fbank_frames_tile.cu twice")
    want = FK.logmel_rows_fused_plain(c, frames)
    simt = FK.fbank_frames_simt(c, frames)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4, msg=f"{what} vs plain")
    if not torch.equal(got, simt):
        raise AssertionError(f"{what}: differs from fbank_frames_simt (max abs "
                             f"{float((got - simt).abs().max()):.3g} in "
                             f"{int((got != simt).sum())} of {got.numel()}), not bit for bit")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches differ")
    silent = torch.log(torch.tensor(float(K_EPS), dtype=torch.float32, device=dev))
    if not bool((got[1::2] == silent).all()):
        raise AssertionError(f"{what}: silent sessions are not log(K_EPS) bit for bit")
    return {"F": F, "plan": plan, "err_plain": float((got - want).abs().max()),
            "err_simt": float((got - simt).abs().max())}


def fbank5_ffma_ms(S: int, F: int, padded: int, N2: int) -> float:
    """Kernel 5's design floor: its DFT's 3 x padded x 2 nfft f32 multiply-
    adds a frame at the card's f32 peak (two operations each)."""
    return 3 * S * F * padded * N2 * 2 / PEAK_OPS["f32"] * 1e3


def fbank_times(card):
    """Kernels 1, 5 and 6 beyond `check_kernels`' S = 256 and 3 of 16 kHz 1 s
    chunks: at 16 and 8 kHz, 200 ms chunks at S = 1 and 256 and 1 s chunks at
    S = 3 and 2048, each checked by `check_fbank` (`check_frames`), and
    full-scale samples at S = 3; then at S = 256 and 2048 of 16 kHz 1 s
    chunks each tiled kernel and the CUDA-core kernel it displaces timed by
    CUDA events and by the profiler's device time a launch, beside the bound
    (and kernels 5's and 6's design's FFMA floor; kernel 6 also beside
    `torch.mm` of its DFT product alone, f32, no TF32)."""
    from april_asr_tpu_torch.config import FbankOptions
    from april_asr_tpu_torch.frontend.fbank import FbankLayout
    from april_asr_tpu_torch.ops import fbank_kernels as FK
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    dev = torch.device(DEV)
    rng = np.random.default_rng(21)
    edge = np.array([32767, -32768, -32767, 32512, -256, 255, 0], np.float32) / 32768.0
    for kernel in (1, 5):
        for rate in (16000, 8000):
            opts = FbankOptions(sample_freq=rate)
            for S, seconds in ((1, 0.2), (S_FLAG, 0.2), (3, 1.0), (2048, 1.0)):
                r = check_fbank(kernel, FbankLayout.build(opts, int(rate * seconds)), S, rng, dev)
                print(f"kernel {kernel} {rate} Hz S={S} F={r['F']} ({r['plan']}): max abs err "
                      f"{r['err_plain']:.3g} against the plain version, {r['err_simt']:.3g} "
                      f"against {FBANK[kernel]['simt']} (bit for bit); silent sessions log(K_EPS) "
                      f"bit for bit; two launches equal")
            layout = FbankLayout.build(opts, rate)
            full = torch.from_numpy(rng.choice(edge, size=(3, layout.buf_len)).astype(np.float32))
            r = check_fbank(kernel, layout, 3, rng, dev, buf=full.to(dev))
            print(f"kernel {kernel} {rate} Hz full-scale samples S=3: max abs err "
                  f"{r['err_plain']:.3g} against the plain version; bit for bit "
                  f"{FBANK[kernel]['simt']}")
    for rate in (16000, 8000):
        opts = FbankOptions(sample_freq=rate)
        for S, seconds in ((1, 0.2), (S_FLAG, 0.2), (3, 1.0), (2048, 1.0)):
            r = check_frames(FbankLayout.build(opts, int(rate * seconds)), S, rng, dev)
            print(f"kernel 6 {rate} Hz S={S} F={r['F']} ({r['plan']}): max abs err "
                  f"{r['err_plain']:.3g} against the plain version, {r['err_simt']:.3g} against "
                  f"fbank_frames_simt (bit for bit); silent sessions log(K_EPS) bit for bit; two "
                  f"launches equal")
        layout = FbankLayout.build(opts, rate)
        full = torch.from_numpy(rng.choice(edge, size=(3, layout.buf_len)).astype(np.float32))
        r = check_frames(layout, 3, rng, dev, buf=full.to(dev))
        print(f"kernel 6 {rate} Hz full-scale samples S=3: max abs err {r['err_plain']:.3g} "
              f"against the plain version; bit for bit fbank_frames_simt")
    opts = FbankOptions()
    layout = FbankLayout.build(opts, CHUNK_1S)
    c, F, K = FK.fbank_constants(layout, dev), layout.max_frames, opts.padded_window_size
    N2, nb, nfft = 2 * c["nfft"], c["bins"], c["nfft"]
    for kernel in (1, 5):
        k = FBANK[kernel]
        route, simt, plan_for = (getattr(FK, k[n]) for n in ("route", "simt", "plan"))
        for S in (S_FLAG, 2048):
            buf = fbank_buffer(S, layout.buf_len, rng, dev)
            plan = plan_for(c, S, F)
            kf = lambda: route(layout, buf)  # noqa: E731
            sf = lambda: simt(c, buf, F)  # noqa: E731
            k_ms, s_ms = cuda_ms(kf, 10), cuda_ms(sf, 3, warmup=1)
            _, k_dev = host_and_device_us(kf, n=5, keys=k["keys"][:1])
            _, s_dev = host_and_device_us(sf, n=2, keys=k["keys"][1:])
            mel_ops = 3 * 2 * S * F * nfft * nb
            if kernel == 1:
                tab, ops, floor = K * N2 * 3, fbank_i8_ops(S, F, K, N2, mel_ops), ""
            else:
                tab, ops = K * N2 * 4, {"bf16": 3 * 2 * S * F * K * N2 + mel_ops}
                floor = f", the design's FFMA floor {fbank5_ffma_ms(S, F, K, N2):.4f} ms"
            b_ms, b_by = bound_ms(S * layout.buf_len * 4 + S * F * nb * 4 + tab + nfft * nb * 4,
                                  ops)
            print(f"kernel {kernel} S={S} F={F}: {k['source']} ms={k_ms:.4f} (device "
                  f"{k_dev:.1f} us a launch; {plan}), {k['simt']} ms={s_ms:.4f} (device "
                  f"{s_dev:.1f} us), bound_ms={b_ms:.4f} ({b_by}){floor} ({card})")
    torch.backends.cuda.matmul.allow_tf32 = False  # the DFT product in full f32, as kernel 6
    for S in (S_FLAG, 2048):
        frames = FK.frames_from_buf(layout, fbank_buffer(S, layout.buf_len, rng, dev))
        plan = FK.frames_plan_for(c, S, F)
        kf = lambda: FK.logmel_rows_fused(layout, frames)  # noqa: E731
        sf = lambda: FK.fbank_frames_simt(c, frames)  # noqa: E731
        mm = lambda: torch.mm(frames.reshape(S * F, K), c["dft"])  # noqa: E731
        k_ms, s_ms, mm_ms = cuda_ms(kf, 10), cuda_ms(sf, 3, warmup=1), cuda_ms(mm, 10)
        _, k_dev = host_and_device_us(kf, n=5, keys=("fbank_frames_tile_kernel",))
        _, s_dev = host_and_device_us(sf, n=2, keys=("fbank_frames_kernel",))
        mel_ops = 3 * 2 * S * F * nfft * nb
        b_ms, b_by = bound_ms(S * F * K * 4 + S * F * nb * 4 + K * N2 * 4 + nfft * nb * 4,
                              {"f32": 2 * S * F * K * N2, "bf16": mel_ops})
        floor = 2 * S * F * K * N2 / PEAK_OPS["f32"] * 1e3
        print(f"kernel 6 S={S} F={F}: csrc/fbank_frames_tile.cu ms={k_ms:.4f} (device "
              f"{k_dev:.1f} us a launch; {plan}), fbank_frames_simt ms={s_ms:.4f} (device "
              f"{s_dev:.1f} us), bound_ms={b_ms:.4f} ({b_by}), the design's FFMA floor "
              f"{floor:.4f} ms, torch.mm of the DFT product alone (f32) ms={mm_ms:.4f} ({card})")


REC = ("hseq", "h", "c")
# kernels 14 and 13 (csrc/lstm_hoist.cu), their CUDA-core templates
# (csrc/lstm_i8.cu) and kernel 2: (name, wrapper, the profiler's kernel
# names)
REC_KERNELS = (
    ("lstm_rec_stream_i8", "lstm_layer_chunk_rec_stream_i8", ("hoist",)),
    ("lstm_rec_i8", "lstm_layer_chunk_rec_i8", ("hoist",)),
    ("lstm_rec_stream_i8_simt", "lstm_layer_chunk_rec_stream_i8_simt", ("lstm_rec_kernel",)),
    ("lstm_rec_i8_simt", "lstm_layer_chunk_rec_i8_simt", ("lstm_rec_kernel",)),
    ("lstm_rec_stream2_i8", "lstm_layer_chunk_rec_stream2_i8", ("lstm_rec_mma_kernel",)),
)


def check_rec_hoist(x, h0, c0, la, n_pulls, k2, S: int, P: int) -> None:
    """Kernels 14 and 13 bit for bit against their CUDA-core templates and
    kernel 2 (`k2`: its outputs gated by n_pulls), gated and ungated; kernel
    2 against kernel 13's template."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK

    for g in (n_pulls, None):
        tag = f"{'gated' if g is not None else 'ungated'} at S={S}, P={P}"
        ref = k2 if g is not None else LK.lstm_layer_chunk_rec_stream2_i8(x, h0, c0, *la)
        _bit_equal(LK.lstm_layer_chunk_rec_i8_simt(x, h0, c0, *la, g), ref, REC,
                   f"lstm_rec_stream2_i8 vs kernel 13's template {tag}")
        for k in (14, 13):
            name = "lstm_layer_chunk_rec_stream_i8" if k == 14 else "lstm_layer_chunk_rec_i8"
            got = getattr(LK, name)(x, h0, c0, *la, g)
            _bit_equal(got, getattr(LK, name + "_simt")(x, h0, c0, *la, g), REC,
                       f"kernel {k} vs its CUDA-core template {tag}")
            _bit_equal(got, ref, REC, f"kernel {k} vs lstm_rec_stream2_i8 {tag}")


def rec_times(x, h0, c0, la, n_pulls, shape: str, reps: int = 10) -> None:
    """Prints the CUDA-event ms a call and the profiler's device ms a call
    of the recurrent cores in REC_KERNELS, in that order."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK

    out = {}
    for name, fn, keys in REC_KERNELS:
        call = lambda fn=fn: getattr(LK, fn)(x, h0, c0, *la, n_pulls)  # noqa: E731
        ms = cuda_ms(call, reps, warmup=1)
        out[name] = (ms, profiled(call, 3, keys)[1] / 1e3)
    print("recurrent cores at " + shape + ": " + ", ".join(
        f"{k} ms={v[0]:.4f} (device {v[1]:.4f})" for k, v in out.items()) + f" ({card_line()})")


def check_kernels(models: dict, S: int, P: int, seed: int) -> dict:
    """Each kernel's wrapper and its plain version on the same inputs at S
    sessions and P pulls (F = 101 frames), held to the stated tolerances;
    `models` maps "int8", "bf16" and "f32" to the flagship Model at that
    precision. Returns {name: (kernel call, plain call, max abs err, bound,
    shape)}."""
    from april_asr_tpu_torch.frontend.fbank import FbankLayout
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import fbank_kernels as FK
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF
    from april_asr_tpu_torch.ops import lstm_kernels as LK

    rt = models["int8"].runtime
    w = rt.weights
    dims = rt.dims
    dev = torch.device(DEV)
    rng = np.random.default_rng(seed)
    layout = FbankLayout.build(rt.fbank_opts, CHUNK_1S)
    F = layout.max_frames
    d, H, Fn = dims.d_model, dims.hidden, dims.ffn
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = {}

    # 1. fbank_i8 (csrc/fbank_mma.cu, by its route), fbank_i8_simt (the
    # CUDA-core kernel it displaces), 5. fbank_bf16x3 (csrc/fbank_bf16x3_tile.cu,
    # by its route) and fbank_bf16x3_simt (the CUDA-core kernel it displaces): [S, L] hop-row
    # buffers of PCM16 values -> [S, F, 80]. Each sums exact products in f32
    # in another order than the plain version: the repo's fbank kernel
    # bound, atol 2e-5, rtol 1e-4 (tests/test_fbank_pallas.py:64-69)
    c = FK.fbank_constants(layout, dev)
    L = layout.buf_len
    buf = fbank_buffer(S, L, rng, dev)
    # the function's DFT has one row per sample of the padded window; the
    # kernels' whole 160-row views add zero rows past it, not counted here
    K = layout.opts.padded_window_size
    N2, nb, nfft = 2 * c["nfft"], c["bins"], c["nfft"]
    mel_ops = 3 * 2 * S * F * nfft * nb
    for name, kf, pf, tab_bytes, ops in (
        ("fbank_i8", lambda: FK.logmel_rows_from_buf_i8(layout, buf),
         lambda: FK.logmel_rows_from_buf_i8_plain(c, buf, F), K * N2 * 3,
         fbank_i8_ops(S, F, K, N2, mel_ops)),
        ("fbank_i8_simt", lambda: FK.fbank_i8_simt(c, buf, F),
         lambda: FK.logmel_rows_from_buf_i8_plain(c, buf, F), K * N2 * 3,
         fbank_i8_ops(S, F, K, N2, mel_ops)),
        ("fbank_bf16x3", lambda: FK.logmel_rows_from_buf(layout, buf),
         lambda: FK.logmel_rows_from_buf_plain(c, buf, F), K * N2 * 4,
         {"bf16": 3 * 2 * S * F * K * N2 + mel_ops}),
        ("fbank_bf16x3_simt", lambda: FK.fbank_bf16x3_simt(c, buf, F),
         lambda: FK.logmel_rows_from_buf_plain(c, buf, F), K * N2 * 4,
         {"bf16": 3 * 2 * S * F * K * N2 + mel_ops}),
    ):
        got, want = kf(), pf()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        b = bound_ms(S * L * 4 + S * F * nb * 4 + tab_bytes + nfft * nb * 4, ops)
        out[name] = (kf, pf, float((got - want).abs().max()), b, f"buf[{S},{L}] F={F}")
    check_fbank(1, layout, S, np.random.default_rng(seed + 31), dev)
    check_fbank(5, layout, S, np.random.default_rng(seed + 37), dev)

    # 2. lstm_rec_stream2_i8: one layer's recurrent core over P steps (layer 0)
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h0 = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c0 = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    n_pulls = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    la = (w["w_ih_t_q8"][0], w["w_ih_t_q8s"][0], w["w_hh_t_q8"][0], w["w_hh_t_q8s"][0],
          w["bias"][0], w["w_hr_t_q8"][0], w["w_hr_t_q8s"][0])
    kf = lambda: LK.lstm_layer_chunk_rec_stream2_i8(x, h0, c0, *la, n_pulls)  # noqa: E731
    pf = lambda: LK.lstm_rec_plain(x, h0, c0, n_pulls, *la)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    err = max(_ulp_close(g, wv, f"lstm_rec_stream2_i8 {k}")
              for g, wv, k in zip(got, want, ("hseq", "h", "c")))
    # the tensor-core kernel 2 equals kernel 13's CUDA-core template (which
    # it replaced on the step) bit for bit: the same exact int32 dots and f32
    # op order; so do kernels 14 and 13 (csrc/lstm_hoist.cu; 14 is kernel
    # 2's route where its stationary weights do not fit) and their
    # templates, gated and ungated
    check_rec_hoist(x, h0, c0, la, n_pulls, got, S, P)
    b = bound_ms(2 * P * S * d * 4 + 2 * S * (d + H) * 4 + 2 * d * 4 * H + H * d + (8 * H + d) * 4,
                 {"int8": 2 * P * S * (2 * d * 4 * H + H * d)})
    out["lstm_rec_stream2_i8"] = (kf, pf, err, b, f"x[{P},{S},{d}] H={H}")
    if S == S_FLAG:
        rec_times(x, h0, c0, la, n_pulls, f"S={S}, P={P}")

    # 3. ffn_norm_i8 over the flattened P*S rows (layer 0): the tensor-core
    # passes equal the CUDA-core kernel they replaced, on each of its row
    # tiles, bit for bit (the same exact int32 dots and f32 op order)
    R = P * S
    xr = x.reshape(R, d)
    hs = t(rng.normal(size=(R, d)).astype(np.float32))
    fa = (w["ff1_t_q8"][0], w["ff1_t_q8s"][0], w["ff1_b"][0],
          w["ff2_t_q8"][0], w["ff2_t_q8s"][0], w["ff2_b"][0], w["norm_eps"][0])
    out["ffn_norm_i8"] = check_ffn(xr, hs, fa, (16, 8, 4), "ffn_norm_i8")

    # 10. lstm_chunk: one whole float layer over P steps (layer 0), gated:
    # the persistent kernel against the plain version (`check_chunk_float`),
    # beside the two-kernel chunk layer it replaced
    for prec in ("f32", "bf16"):
        wl = models[prec].runtime.weights
        lw = tuple(wl[k][0] for k in TM.STEP_KEYS)
        out[f"lstm_chunk_mma_{prec}"] = check_chunk_float(x, h0, c0, lw, n_pulls, prec)
        simt = LF.lstm_layer_chunk_simt(x, h0, c0, *lw, n_pulls)
        got = out[f"lstm_chunk_mma_{prec}"][0]()
        torch.cuda.synchronize()
        diff = max(float((a - b).abs().max()) for a, b in zip(got, simt))
        print(f"lstm_chunk_mma_{prec} vs the two-kernel chunk layer at S={S}, P={P}: max abs "
              f"diff {diff:.3g}")
        if S == S_FLAG:
            k_ms = cuda_ms(lambda lw=lw: LF.lstm_layer_chunk_fused(x, h0, c0, *lw, n_pulls), 10)
            s_ms = cuda_ms(lambda lw=lw: LF.lstm_layer_chunk_simt(x, h0, c0, *lw, n_pulls), 10)
            print(f"lstm_chunk_mma_{prec}: ms={k_ms:.4f}, the two-kernel chunk layer "
                  f"(lstm_chunk_simt) ms={s_ms:.4f} at S={S}, P={P}")

    # 4. chunk_decode on bf16 (int8 and bf16 serving) and f32 decode weights:
    # the cluster kernel and the CUDA-core kernel it replaced
    out.update(_check_decode(rt, S, P, rng, dev, t))
    out.update(_check_decode(models["f32"].runtime, S, P, rng, dev, t))

    # 7. lstm_step_i8 and 12. lstm_step_f32/bf16: one layer's timestep
    # (layer 0) at the flush's shapes, ungated as the engine runs it, and
    # checked once more gated. Int8 to f32 ulps except isolated int8
    # rounding flips; f32 and bf16 at kernel 10's bounds, as above.
    xs = t(rng.normal(size=(S, d)).astype(np.float32))
    gate = t(rng.random(S) < 0.5)
    for name, prec, kfn, pfn, keys in (
        ("lstm_step_i8", "int8", LK.lstm_layer_fused_i8, LK.lstm_layer_fused_i8_plain, TM.STEP_I8_KEYS),
        ("lstm_step_f32", "f32", LF.lstm_layer_fused, LF.lstm_layer_fused_plain, TM.STEP_KEYS),
        ("lstm_step_bf16", "bf16", LF.lstm_layer_fused, LF.lstm_layer_fused_plain, TM.STEP_KEYS),
    ):
        wl = models[prec].runtime.weights
        sa = tuple(wl[k][0] for k in keys)
        err = 0.0
        for g in (None, gate):
            got, want = kfn(xs, h0, c0, *sa, g), pfn(xs, h0, c0, *sa, g)
            torch.cuda.synchronize()
            if prec == "int8":  # kernel 7 equals the three-pass step it replaced, bit for bit
                _bit_equal(got, LK.lstm_layer_fused_i8_simt(xs, h0, c0, *sa, g), ("y", "h", "c"),
                           f"lstm_step_i8{' gated' if g is not None else ''} vs the three-pass "
                           f"step at S={S}")
            else:  # kernel 12 beside the three-pass step it replaced (a yardstick)
                simt = LF.lstm_layer_fused_simt(xs, h0, c0, *sa, g)
                torch.cuda.synchronize()
                diff = max(float((a - b).abs().max()) for a, b in zip(got, simt))
                print(f"{name}{' gated' if g is not None else ''} vs the three-pass step at "
                      f"S={S}: max abs diff {diff:.3g}")
            for gv, wv, k in zip(got, want, ("y", "h", "c")):
                what = f"{name} {k}{' gated' if g is not None else ''}"
                if prec == "int8":
                    err = max(err, _ulp_close(gv, wv, what))
                    continue
                if not torch.isfinite(gv).all():
                    raise AssertionError(f"{what}: non-finite values")
                atol, rtol = (1e-4, 1e-4) if prec == "f32" else (5e-2, 1e-3)
                torch.testing.assert_close(gv, wv, atol=atol, rtol=rtol, msg=what)
                err = max(err, float((gv - wv).abs().max()))
        wb = 1 if prec == "int8" else wl["w_ih_t"].element_size()
        scales = (2 * 4 * H + 2 * d + Fn) * 4 if prec == "int8" else 0
        b = bound_ms(
            4 * S * (4 * d + 2 * H) + (2 * d * 4 * H + H * d + 2 * d * Fn) * wb + scales
            + (4 * H + Fn + d) * wl["bias"].element_size() + 4,
            {prec: 2 * S * (2 * d * 4 * H + H * d + 2 * d * Fn)},
        )
        out[name] = (lambda kfn=kfn, sa=sa: kfn(xs, h0, c0, *sa),
                     lambda pfn=pfn, sa=sa: pfn(xs, h0, c0, *sa), err, b, f"x[{S},{d}] H={H} ffn={Fn}")
        if prec != "int8" and S == S_FLAG:
            k_ms = cuda_ms(lambda sa=sa: LF.lstm_layer_fused(xs, h0, c0, *sa), 20)
            s_ms = cuda_ms(lambda sa=sa: LF.lstm_layer_fused_simt(xs, h0, c0, *sa), 20)
            print(f"{name}: ms={k_ms:.4f}, the three-pass step (lstm_step_float_simt) "
                  f"ms={s_ms:.4f} at S={S}")

    # 8. dec_joiner (the cluster kernel, and dec_joiner_simt, bit for bit) and
    # 9. joiner_argmax (the stream kernel, and joiner_argmax_simt, bit for
    # bit) on bf16 and f32 decode weights, and kernel 9 on the 16,383-token
    # model's bf16 and f32 weights
    for prec, sfx in (("bf16", ""), ("f32", "_f32")):
        out.update(_check_joiner(models[prec].runtime, S, rng, dev, t, refresh=True))
        out.update(_check_joiner(models[prec].runtime, S, rng, dev, t, refresh=False))
        v = _check_joiner(models["vocab " + prec].runtime, S, rng, dev, t, refresh=False)
        for name in ("joiner_argmax", "joiner_argmax_simt"):
            out[f"{name}{sfx}_v16383"] = v[name + sfx]

    # 16. conv_embed (and conv_embed_simt, bit for bit) and 17.
    # conv_embed_front: every window of the step from the front buffer [S,
    # W, mel] on bf16 weights (int8 and bf16 serving) -> [P, S, d], against
    # the stacked windows through conv_subsample
    out.update(check_conv_embed(models["bf16"].runtime, S, P, rng, t))

    # 6. fbank_frames (csrc/fbank_frames_tile.cu, by its route) and
    # fbank_frames_simt (the CUDA-core kernel it displaces): the DSP on frames
    # formed from the hop-row buffers, the DFT one f32 product; the fbank
    # kernel bound, as kernels 1 and 5
    frames = FK.frames_from_buf(layout, buf)
    pf = lambda: FK.logmel_rows_fused_plain(c, frames)  # noqa: E731
    b = bound_ms(S * F * K * 4 + S * F * nb * 4 + K * N2 * 4 + nfft * nb * 4,
                 {"f32": 2 * S * F * K * N2, "bf16": mel_ops})
    for name, kf in (("fbank_frames", lambda: FK.logmel_rows_fused(layout, frames)),
                     ("fbank_frames_simt", lambda: FK.fbank_frames_simt(c, frames))):
        got, want = kf(), pf()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        out[name] = (kf, pf, float((got - want).abs().max()), b, f"frames[{S},{F},{K}]")
    check_frames(layout, S, np.random.default_rng(seed + 41), dev)
    return out


def front_buffer(rt, S: int, P: int, rng, t):
    """A front buffer [S, W, mel] of log-mel-like rows for `rt`'s geometry."""
    dims = rt.dims
    W = (P - 1) * dims.segment_step + dims.segment_size
    return t((rng.normal(size=(S, W, dims.mel)) * 2.0 - 6.0).astype(np.float32))


def stacked_embed(rt, front, P: int):
    """The step's embed without kernel 16: the windows stacked, then
    `encoder_embed` (three cuDNN convolutions and the projection)."""
    seg, step = rt.dims.segment_size, rt.dims.segment_step
    S = front.shape[0]
    windows = torch.stack([front[:, i * step : i * step + seg] for i in range(P)])
    return rt.encoder_embed(rt.weights, windows.reshape(P * S, seg, -1)).reshape(P, S, -1)


def embed_bound(rt, S: int, P: int, front: bool = False) -> tuple:
    """(multiply-adds of the call, bound_ms, bound_by) on `rt`'s geometry,
    each at the bf16 rate, with the front, output and weights moved once.
    Kernel 16: each window's work as the function defines it (conv1 rows
    0..6, conv2 rows 0..2, conv3, the projection). Kernel 17 (`front`):
    conv1 once per buffer row that a window reads (rows 0..(P - 1) step +
    6: conv2 reads a window's conv1 rows 0..6), three taps more for each
    window's corrected top row and, where conv2 reads it (seg 7), its
    corrected bottom row (row seg - 1), then kernel 16's conv2, conv3 and
    projection a window."""
    dims = rt.dims
    seg, step, mel, d = dims.segment_size, dims.segment_step, dims.mel, dims.d_model
    c1, c2, c3 = dims.conv_channels
    f2 = (mel - 3) // 2 + 1
    f3 = (f2 - 3) // 2 + 1
    tail = 3 * f2 * c2 * 9 * c1 + f3 * c3 * 9 * c2 + f3 * c3 * d
    W = (P - 1) * step + seg
    if front:
        rows = min(W, (P - 1) * step + 7)
        edges = 1 + (seg - 1 < 7)
        macs = S * rows * mel * c1 * 9 + P * S * (edges * 3 * mel * c1 + tail)
    else:
        macs = P * S * (7 * mel * c1 * 9 + tail)
    n_bytes = S * W * mel * 4 + P * S * d * 4 + c1 * 9 * 4 + (9 * c1 * c2 + 9 * c2 * c3
                                                             + f3 * c3 * d) * 2
    return (macs, *bound_ms(n_bytes, {"bf16": 2 * macs}))


def embed_ffma_ms(macs: int) -> float:
    """A conv embed design's floor: its `macs` multiply-adds on the CUDA
    cores at the card's f32 peak (two operations each)."""
    return 2 * macs / PEAK_OPS["f32"] * 1e3


def check_conv_embed(rt, S: int, P: int, rng, t) -> dict:
    """Kernels 16 and 17 on `rt`'s bf16 weights. Each by its route launches
    csrc/conv_embed_tile.cu on its plan (its count, and no CUDA-core
    launch), bit for bit the CUDA-core kernel it replaced (`conv_embed_simt`,
    `conv_embed_front_simt`); kernel 17 again so at seg 7, where conv3 reads
    a window's corrected bottom row. Each of the four held to `_embed_close`
    against the plain version, at the flip bound of `rt`'s weights and this
    front's activations; kernel 17 at seg 7 at its flip bound and finite
    everywhere, and to its mean and clean share where the run has at least
    S_FLAG windows (they are window statistics: on 7 windows one flipped
    high-gain activation can move the mean past 2e-4, as the template, with
    the same bits, does, and as JAX's `conv_embed_from_front` does on the
    CPU, PERF.md PR 25). The time bound:
    `embed_bound`, kernel 17's with `front`."""
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE

    w, dims = rt.weights, rt.dims
    seg, step, mel = dims.segment_size, dims.segment_step, dims.mel
    front = front_buffer(rt, S, P, rng, t)
    pf = lambda: CE.conv_embed_plain(w, front, P, step, seg)  # noqa: E731
    bounds = {k: tuple(embed_bound(rt, S, P, front=k)[1:]) for k in (False, True)}
    what = f"S={S} P={P} d={dims.d_model} c={dims.conv_channels}"
    entries = (("conv_embed", CE.conv_embed_windows), ("conv_embed_simt", CE.conv_embed_simt),
               ("conv_embed_front", CE.conv_embed_from_front),
               ("conv_embed_front_simt", CE.conv_embed_front_simt))
    got = {}
    for k in (0, 2):
        (name, entry), (simt, simt_entry) = entries[k], entries[k + 1]
        got[name] = routed_embed(w, front, P, step, seg, name, entry, f"{name} {what}")
        got[simt] = simt_entry(w, front, P=P, step=step, seg=seg)
        _bit_equal([got[name]], [got[simt]], ("embed",), f"{name} {what} against {simt}")
    want = pf()
    flip = embed_flip_bound(w, embed_amax(w, front, P, step, seg))
    out = {}
    for name, entry in entries:
        kf = lambda entry=entry: entry(w, front, P=P, step=step, seg=seg)  # noqa: E731
        err, stats = _embed_close(got[name], want, name, flip)
        out[name] = (kf, pf, err, bounds["front" in name],
                     f"front[{S},{front.shape[1]},{mel}] P={P}: {stats}")
    if seg != 7:  # kernel 17 at seg 7 on the same weights
        W7 = (P - 1) * step + 7
        f7 = t((rng.normal(size=(S, W7, mel)) * 2.0 - 6.0).astype(np.float32))
        what7 = f"conv_embed_front seg=7 {what}"
        g7 = routed_embed(w, f7, P, step, 7, "conv_embed_front", CE.conv_embed_from_front, what7)
        _bit_equal([g7], [CE.conv_embed_front_simt(w, f7, P=P, step=step, seg=7)], ("embed",),
                   f"{what7} against conv_embed_front_simt")
        err, stats = _embed_close(g7, CE.conv_embed_plain(w, f7, P, step, 7), what7,
                                  embed_flip_bound(w, embed_amax(w, f7, P, step, 7)),
                                  window_stats=S * P >= S_FLAG)
        print(f"{what7}: max abs err {err:.3g} against the plain version ({stats}"
              f"{'' if S * P >= S_FLAG else '; the flip bound alone on so few windows'})")
    return out


def routed_embed(w, front, P: int, step: int, seg: int, name: str, entry, what: str):
    """`entry` (kernel 16's or 17's route) on `front`: it must launch
    csrc/conv_embed_tile.cu on its plan once (count `name`) and its
    CUDA-core kernel (`name`_simt) no time. Returns the output."""
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE
    from april_asr_tpu_torch.ops import cuda_build

    simt = name + "_simt" if name == "conv_embed_front" else "conv_embed_simt"
    plan = CE.embed_plan_for(w, front.shape[0], P, front.shape[2], seg, name == "conv_embed_front")
    before = dict(cuda_build.COUNTS)
    out = entry(w, front, P=P, step=step, seg=seg)
    launched = {n: cuda_build.COUNTS[n] - before[n] for n in (name, simt)}
    if plan is None or launched != {name: 1, simt: 0}:
        raise AssertionError(f"{what}: the route launched {launched} ({plan}), not "
                             "csrc/conv_embed_tile.cu once")
    return out


def embed_times(models, card):
    """Kernels 16 and 17 beyond `check_kernels`' S = 256 and 3: at S = 2048
    of 1 s chunks and at S = 1 and 256 of the session's 200 ms chunks, each
    checked by `check_conv_embed` (at S = 2048, 55,296 windows, as
    everywhere: the flip bound holds at any number of windows). Then at S =
    256 and 2048 of 1 s chunks kernel 16's tiled kernel, `conv_embed_simt`
    and the stacked embed it displaced in the step (windows stacked, then
    three cuDNN convolutions and the projection) timed by CUDA events, and
    kernel 17's tiled kernel and `conv_embed_front_simt`, the four kernels
    also by the profiler's device time a call, beside the bound and the
    designs' FFMA floors."""
    from april_asr_tpu_torch.frontend.fbank import FbankLayout
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE
    from april_asr_tpu_torch.tools.profile_embed import FRONT_KEYS, PROJ_KEYS, SIMT_KEYS, STACK_KEYS
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    rt = models["bf16"].runtime
    w, dims = rt.weights, rt.dims
    seg, step, mel = dims.segment_size, dims.segment_step, dims.mel
    rng = np.random.default_rng(23)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    P1 = FbankLayout.build(rt.fbank_opts, CHUNK_1S).max_pulls_per_step
    P200 = FbankLayout.build(rt.fbank_opts, CHUNK_1S // 5).max_pulls_per_step
    for S, P in ((2048, P1), (1, P200), (S_FLAG, P200)):
        r = check_conv_embed(rt, S, P, rng, t)
        print(f"kernel 16 S={S} P={P}: max abs err {r['conv_embed'][2]:.3g} against the plain "
              f"version ({r['conv_embed'][4]}); bit for bit conv_embed_simt; kernel 17 max abs "
              f"err {r['conv_embed_front'][2]:.3g} ({r['conv_embed_front'][4]}); bit for bit "
              f"conv_embed_front_simt")
    for S in (S_FLAG, 2048):
        front = front_buffer(rt, S, P1, rng, t)
        plan = CE.embed_plan_for(w, S, P1, mel, seg)
        kf = lambda: CE.conv_embed_windows(w, front, P=P1, step=step, seg=seg)  # noqa: E731
        sf = lambda: CE.conv_embed_simt(w, front, P=P1, step=step, seg=seg)  # noqa: E731
        k_ms, s_ms = cuda_ms(kf, 10), cuda_ms(sf, 5, warmup=1)
        st_ms = cuda_ms(lambda: stacked_embed(rt, front, P1), 3, warmup=1)
        _, k_dev = host_and_device_us(kf, n=5, keys=STACK_KEYS + PROJ_KEYS)
        _, s_dev = host_and_device_us(sf, n=2, keys=SIMT_KEYS)
        macs, b_ms, b_by = embed_bound(rt, S, P1)
        print(f"kernel 16 S={S} P={P1}: csrc/conv_embed_tile.cu ms={k_ms:.4f} (device "
              f"{k_dev:.1f} us a call; {plan}), conv_embed_simt ms={s_ms:.4f} (device "
              f"{s_dev:.1f} us), stacked embed ms={st_ms:.4f}, bound_ms={b_ms:.4f} ({b_by}), the "
              f"design's FFMA floor {embed_ffma_ms(macs):.4f} ms ({card})")
        plan = CE.embed_plan_for(w, S, P1, mel, seg, front=True)
        kf = lambda: CE.conv_embed_from_front(w, front, P=P1, step=step, seg=seg)  # noqa: E731
        sf = lambda: CE.conv_embed_front_simt(w, front, P=P1, step=step, seg=seg)  # noqa: E731
        k_ms, s_ms = cuda_ms(kf, 10), cuda_ms(sf, 5, warmup=1)
        _, k_dev = host_and_device_us(kf, n=5, keys=FRONT_KEYS + PROJ_KEYS)
        _, s_dev = host_and_device_us(sf, n=2, keys=SIMT_KEYS)
        # the design's floor: kernel 16's multiply-adds (conv1 on a window's
        # own seven rows) and each window's top row correction, three taps a
        # (freq, channel)
        floor = embed_ffma_ms(macs + P1 * S * 3 * mel * dims.conv_channels[0])
        _, b_ms, b_by = embed_bound(rt, S, P1, front=True)
        print(f"kernel 17 S={S} P={P1}: csrc/conv_embed_tile.cu ms={k_ms:.4f} (device "
              f"{k_dev:.1f} us a call; {plan}), conv_embed_front_simt ms={s_ms:.4f} (device "
              f"{s_dev:.1f} us), bound_ms={b_ms:.4f} ({b_by}), the design's FFMA floor "
              f"{floor:.4f} ms ({card})")


SOURCES = {
    "fbank_i8": ("april_asr_tpu_torch/csrc/fbank_mma.cu", "april_asr_tpu/ops/fbank_pallas.py:457"),
    "fbank_i8_simt": ("april_asr_tpu_torch/csrc/fbank_i8.cu",
                      "april_asr_tpu/ops/fbank_pallas.py:457"),
    "lstm_rec_stream2_i8": ("april_asr_tpu_torch/csrc/lstm_mma.cu",
                            "april_asr_tpu/ops/lstm_pallas.py:1147"),
    "ffn_norm_i8": ("april_asr_tpu_torch/csrc/ffn_mma.cu", "april_asr_tpu/ops/lstm_pallas.py:1264"),
    "chunk_decode": ("april_asr_tpu_torch/csrc/chunk_decode_cluster.cu",
                     "april_asr_tpu/ops/decode_pallas.py:440"),
    "chunk_decode_simt": ("april_asr_tpu_torch/csrc/chunk_decode.cu",
                          "april_asr_tpu/ops/decode_pallas.py:440"),
    "fbank_bf16x3": ("april_asr_tpu_torch/csrc/fbank_bf16x3_tile.cu",
                     "april_asr_tpu/ops/fbank_pallas.py:280"),
    "fbank_bf16x3_simt": ("april_asr_tpu_torch/csrc/fbank_bf16x3.cu",
                          "april_asr_tpu/ops/fbank_pallas.py:280"),
    "lstm_chunk_mma_f32": ("april_asr_tpu_torch/csrc/lstm_chunk_mma.cu",
                           "april_asr_tpu/ops/lstm_pallas.py:237"),
    "lstm_chunk_mma_bf16": ("april_asr_tpu_torch/csrc/lstm_chunk_mma.cu",
                            "april_asr_tpu/ops/lstm_pallas.py:237"),
    "chunk_decode_f32": ("april_asr_tpu_torch/csrc/chunk_decode_cluster.cu",
                         "april_asr_tpu/ops/decode_pallas.py:440"),
    "chunk_decode_simt_f32": ("april_asr_tpu_torch/csrc/chunk_decode.cu",
                              "april_asr_tpu/ops/decode_pallas.py:440"),
    "lstm_step_i8": ("april_asr_tpu_torch/csrc/lstm_mma.cu", "april_asr_tpu/ops/lstm_pallas.py:426"),
    "lstm_step_i8_simt": ("april_asr_tpu_torch/csrc/lstm_step.cu",
                          "april_asr_tpu/ops/lstm_pallas.py:426"),
    "ffn_norm_i8_wide": ("april_asr_tpu_torch/csrc/ffn_mma.cu",
                         "april_asr_tpu/ops/lstm_pallas.py:1264"),
    "lstm_step_f32": ("april_asr_tpu_torch/csrc/lstm_mma_float.cu",
                      "april_asr_tpu/ops/lstm_pallas.py:1370"),
    "lstm_step_bf16": ("april_asr_tpu_torch/csrc/lstm_mma_float.cu",
                       "april_asr_tpu/ops/lstm_pallas.py:1370"),
    "dec_joiner": ("april_asr_tpu_torch/csrc/dec_joiner_cluster.cu",
                   "april_asr_tpu/ops/joiner_pallas.py:218"),
    "dec_joiner_simt": ("april_asr_tpu_torch/csrc/joiner.cu",
                        "april_asr_tpu/ops/joiner_pallas.py:218"),
    "dec_joiner_simt_f32": ("april_asr_tpu_torch/csrc/joiner.cu",
                            "april_asr_tpu/ops/joiner_pallas.py:218"),
    "joiner_argmax": ("april_asr_tpu_torch/csrc/joiner_stream.cu",
                      "april_asr_tpu/ops/joiner_pallas.py:74"),
    "dec_joiner_f32": ("april_asr_tpu_torch/csrc/dec_joiner_cluster.cu",
                       "april_asr_tpu/ops/joiner_pallas.py:218"),
    "joiner_argmax_f32": ("april_asr_tpu_torch/csrc/joiner_stream.cu",
                          "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_v16383": ("april_asr_tpu_torch/csrc/joiner_stream.cu",
                             "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_f32_v16383": ("april_asr_tpu_torch/csrc/joiner_stream.cu",
                                 "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_simt": ("april_asr_tpu_torch/csrc/joiner.cu",
                           "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_simt_f32": ("april_asr_tpu_torch/csrc/joiner.cu",
                               "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_simt_v16383": ("april_asr_tpu_torch/csrc/joiner.cu",
                                  "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_simt_f32_v16383": ("april_asr_tpu_torch/csrc/joiner.cu",
                                      "april_asr_tpu/ops/joiner_pallas.py:74"),
    "conv_embed": ("april_asr_tpu_torch/csrc/conv_embed_tile.cu",
                   "april_asr_tpu/ops/conv_embed_pallas.py:333"),
    "conv_embed_simt": ("april_asr_tpu_torch/csrc/conv_embed.cu",
                        "april_asr_tpu/ops/conv_embed_pallas.py:333"),
    "conv_embed_front": ("april_asr_tpu_torch/csrc/conv_embed_tile.cu",
                         "april_asr_tpu/ops/conv_embed_pallas.py:438"),
    "conv_embed_front_simt": ("april_asr_tpu_torch/csrc/conv_embed.cu",
                              "april_asr_tpu/ops/conv_embed_pallas.py:438"),
    "fbank_frames": ("april_asr_tpu_torch/csrc/fbank_frames_tile.cu",
                     "april_asr_tpu/ops/fbank_pallas.py:163"),
    "fbank_frames_simt": ("april_asr_tpu_torch/csrc/fbank_bf16x3.cu",
                          "april_asr_tpu/ops/fbank_pallas.py:163"),
    "lstm_rec_i8": ("april_asr_tpu_torch/csrc/lstm_hoist.cu",
                    "april_asr_tpu/ops/lstm_pallas.py:814"),
    "lstm_rec_stream_i8": ("april_asr_tpu_torch/csrc/lstm_hoist.cu",
                           "april_asr_tpu/ops/lstm_pallas.py:973"),
    "lstm_rec_stream_i8_wide": ("april_asr_tpu_torch/csrc/lstm_hoist.cu",
                                "april_asr_tpu/ops/lstm_pallas.py:973"),
    "lstm_rec_i8_simt": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                         "april_asr_tpu/ops/lstm_pallas.py:814"),
    "lstm_rec_stream_i8_simt": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                                "april_asr_tpu/ops/lstm_pallas.py:973"),
    "lstm_chunk_i8": ("april_asr_tpu_torch/csrc/lstm_hoist.cu",
                      "april_asr_tpu/ops/lstm_pallas.py:636"),
    "lstm_chunk_i8_simt": ("april_asr_tpu_torch/csrc/lstm_chunk_i8.cu",
                           "april_asr_tpu/ops/lstm_pallas.py:636"),
    "lstm_wavefront_i8": ("april_asr_tpu_torch/csrc/lstm_wavefront_hoist.cu",
                          "april_asr_tpu/ops/lstm_wavefront_pallas.py:223"),
    "lstm_wavefront_i8_simt": ("april_asr_tpu_torch/csrc/lstm_wavefront.cu",
                               "april_asr_tpu/ops/lstm_wavefront_pallas.py:223"),
    "rec_interleave_i8": ("april_asr_tpu_torch/csrc/lstm_hoist.cu",
                          "tools/profile_chunk_split.py:248"),
    "rec_interleave_i8_ts2": ("april_asr_tpu_torch/csrc/lstm_hoist.cu",
                              "tools/profile_chunk_split.py:248"),
    "rec_interleave_i8_simt": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                               "tools/profile_chunk_split.py:248"),
    "rec_interleave_i8_ts2_simt": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                                   "tools/profile_chunk_split.py:248"),
    "mm_bf16": ("april_asr_tpu_torch/csrc/mm_wgmma.cu", "tools/profile_int8.py:66"),
    "mm_i8": ("april_asr_tpu_torch/csrc/mm_wgmma.cu", "tools/profile_int8.py:66"),
    "mm_i8_dynq": ("april_asr_tpu_torch/csrc/mm_wgmma.cu", "tools/profile_int8.py:66"),
    "mm_bf16_sync": ("april_asr_tpu_torch/csrc/int8_mm.cu", "tools/profile_int8.py:66"),
    "mm_i8_sync": ("april_asr_tpu_torch/csrc/int8_mm.cu", "tools/profile_int8.py:66"),
    "mm_i8_dynq_sync": ("april_asr_tpu_torch/csrc/int8_mm.cu", "tools/profile_int8.py:66"),
    "tp_gcp_f32": ("april_asr_tpu_torch/csrc/lstm_tp_gates.cu",
                   "april_asr_tpu/ops/lstm_tp_pallas.py:122"),
    "tp_gcp_bf16": ("april_asr_tpu_torch/csrc/lstm_tp_gates.cu",
                    "april_asr_tpu/ops/lstm_tp_pallas.py:122"),
    "tp_gc_i8": ("april_asr_tpu_torch/csrc/lstm_tp_gates.cu",
                 "april_asr_tpu/ops/lstm_tp_pallas.py:234"),
    "tp_gcp_simt_f32": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                        "april_asr_tpu/ops/lstm_tp_pallas.py:122"),
    "tp_gcp_simt_bf16": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                         "april_asr_tpu/ops/lstm_tp_pallas.py:122"),
    "tp_gc_i8_simt": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                      "april_asr_tpu/ops/lstm_tp_pallas.py:234"),
    "tp_ffn_f32": ("april_asr_tpu_torch/csrc/lstm_tp_ffn.cu",
                   "april_asr_tpu/ops/lstm_tp_pallas.py:305"),
    "tp_ffn_bf16": ("april_asr_tpu_torch/csrc/lstm_tp_ffn.cu",
                    "april_asr_tpu/ops/lstm_tp_pallas.py:305"),
    "tp_ffn_mid_i8": ("april_asr_tpu_torch/csrc/lstm_tp_ffn.cu",
                      "april_asr_tpu/ops/lstm_tp_pallas.py:363"),
    "tp_ffn_simt_f32": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                        "april_asr_tpu/ops/lstm_tp_pallas.py:305"),
    "tp_ffn_simt_bf16": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                         "april_asr_tpu/ops/lstm_tp_pallas.py:305"),
    "tp_ffn_mid_i8_simt": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                           "april_asr_tpu/ops/lstm_tp_pallas.py:363"),
}
# the launch counter of a row that times a kernel at a second shape or tile
# (kernel 22's 2-session row names the JAX block_s its template's tile
# serves; both rows launch kernel 14's entry, counted as
# `rec_interleave_i8`, while the templates count under their own names)
COUNT_KEY = {"joiner_argmax_v16383": "joiner_argmax", "joiner_argmax_f32_v16383": "joiner_argmax_f32",
             "joiner_argmax_simt_v16383": "joiner_argmax_simt",
             "joiner_argmax_simt_f32_v16383": "joiner_argmax_simt_f32",
             "rec_interleave_i8_ts2": "rec_interleave_i8"}
# the row that takes a path's launches of a kernel whose own row (another
# shape, no serving path) keeps that kernel's count name
PATH_ROW = {"wide int8": {"lstm_rec_stream_i8": "lstm_rec_stream_i8_wide",
                          "ffn_norm_i8": "ffn_norm_i8_wide"}}


def time_rows(checked: dict, card, reps: int, timer=cuda_ms) -> list:
    """Times each checked kernel (median of `reps` launches), its plain
    version (of 5, or 3 for kernel 4's) and, where the entry carries one as
    a sixth item, the library call (of `reps`) with `timer` (`cuda_ms`'s
    signature); returns the kernels' JSON rows."""
    rows = []
    for name, (kf, pf, err, (b_ms, b_by), shape, *lib) in checked.items():
        k_ms = timer(kf, reps)
        p_ms = timer(pf, 3 if name.startswith("chunk_decode") else 5, warmup=1)
        l_ms = timer(lib[0], reps) if lib else None
        source, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
        })
        lib_s = f"{l_ms:.4f}" if l_ms is not None else "none"
        print(f"kernel {name}: max_abs_err={err:.3g} ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_s} shape={shape} ({card})")
    return rows


def phase_kernels(models, card, reps: int = 20):
    """Every kernel at the engine cell's shapes (S=256, P=27, F=101; the
    one-step kernels at the flush's S=256): checked and timed against its
    plain version; then checked again at S=3, P=5, where every kernel's
    last tile is ragged."""
    from april_asr_tpu_torch.frontend.fbank import FbankLayout

    P = FbankLayout.build(models["int8"].runtime.fbank_opts, CHUNK_1S).max_pulls_per_step
    rows = time_rows(check_kernels(models, S_FLAG, P, seed=1), card, reps)
    ffn_yardstick(*ffn_inputs(models["int8"].runtime, S_FLAG * P, seed=4), 16, card, reps)
    embed_times(models, card)
    ragged = check_kernels(models, 3, 5, seed=2)
    print("kernels at ragged shapes S=3 P=5: " + ", ".join(
        f"{n} max_abs_err={v[2]:.3g}" for n, v in ragged.items()))
    check_float_widths(S_FLAG, P, seed=5)
    print_mma_plans(models["int8"].runtime, S_FLAG, P)
    decode_times(models, card, P)
    dj_times(models, card)
    k9_times(models, card)
    fbank_times(card)
    return rows


def decode_times(models, card, P: int):
    """Kernel 4 at S = 256 and 2048, bf16 (int8 and bf16 serving) and f32
    decode weights: the cluster kernel bit for bit against
    chunk_decode_simt and both against the plain version (`_check_decode`),
    then both timed, by CUDA events and by the profiler's device time a
    launch."""
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    dev = torch.device(DEV)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    for prec, model in (("bf16", models["int8"]), ("f32", models["f32"])):
        for S in (S_FLAG, 2048):
            (kf, _, _, (b_ms, b_by), shape), (sf, *_) = _check_decode(
                model.runtime, S, P, np.random.default_rng(S + 11), dev, t).values()
            k_ms, s_ms = cuda_ms(kf, 10), cuda_ms(sf, 3, warmup=1)
            _, k_dev = host_and_device_us(kf, n=5, keys=("chunk_decode_cluster_kernel",))
            _, s_dev = host_and_device_us(sf, n=2, keys=("chunk_decode_kernel",))
            print(f"kernel 4 {prec} S={S}: cluster kernel ms={k_ms:.4f} (device {k_dev:.1f} us a "
                  f"launch), chunk_decode_simt ms={s_ms:.4f} (device {s_dev:.1f} us), "
                  f"bound_ms={b_ms:.4f} ({b_by}); {shape} ({card})")


def host_us_turns(fns: dict, n: int = 100, rounds: int = 3) -> dict:
    """The host's time a call (us) of each of `fns`, n calls queued without a
    synchronize, in turns (a, b, b, a, ...) `rounds` times over; the median
    of each one's turns (one call's sample swings with the host's load)."""
    names = list(fns)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fns[k]()
            times[k].append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in times.items()}


def dj_times(models, card):
    """Kernel 8 on the flagship's bf16 (int8 and bf16 serving) and f32
    decode weights: its plan at S = 1, 3, 256 and 2048; at S = 3, 256 and
    2048, with need_dec at 50% and at a flush round's ~5%
    (`profile_decode.dj_case`), the route (the cluster kernel) equal bit for
    bit to `dec_joiner_simt` on all four outputs; at S = 256 and 2048 both
    timed by CUDA events, the profiler's device time a call and the host's
    time a call (`host_us_turns`)."""
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import decode_kernels as DK
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.tools.profile_decode import DJ_SHARES, dj_case

    dev = torch.device(DEV)
    for prec, model in (("bf16", models["int8"]), ("f32", models["f32"])):
        rt = model.runtime
        w, dims = rt.weights, rt.dims
        J, d, V = dims.joiner_dim, dims.d_model, dims.vocab
        wb, sfx = w["join_t"].element_size(), "_f32" if prec == "f32" else ""
        for S in (1, 3, 256, 2048):
            p = DK.device_dj_plan(S, J, d, V, wb, dev.index or 0)
            print(f"kernel 8 {prec} plan at S={S}: clusters of C={p.C}, tiles of TS={p.TS}, "
                  f"{p.clusters} clusters in {p.waves} waves of {p.max_clusters}, Vc={p.Vc} "
                  f"Jc={p.Jc}, dec_proj {'resident' if p.dp_smem else 'streamed'}, {p.smem} bytes "
                  f"of shared memory a block, {DK.dj_staged_bytes(p, J, d, wb):.0f} weight bytes "
                  f"staged a call")
        for S in (3, 256, 2048):
            for share in DJ_SHARES:
                args = dj_case(w, rt.blank_id, S, share, np.random.default_rng(S + 17), dev)
                kf = lambda: JK.decoder_joiner_argmax_fused(*args[:-1], blank_id=args[-1])  # noqa: E731
                sf = lambda: JK.decoder_joiner_argmax_simt(*args)  # noqa: E731
                before = cuda_build.COUNTS["dec_joiner" + sfx]
                got = kf()
                if cuda_build.COUNTS["dec_joiner" + sfx] != before + 1:
                    raise AssertionError(f"kernel 8 {prec} S={S}: the cluster kernel did not launch")
                _bit_equal(got, sf(), ("max_idx", "max_val", "blank_val", "dout'"),
                           f"kernel 8 {prec} S={S} need_dec {share:.0%} "
                           f"({int(args[1].sum())} rows refresh): the cluster kernel against "
                           f"dec_joiner_simt")
                if S == 3:
                    continue
                k_ms, s_ms = cuda_ms(kf, 20), cuda_ms(sf, 20)
                k_dev = profiled(kf, 5, "dec_joiner_cluster")[1]
                s_dev = profiled(sf, 5, ("dec_refresh", "joiner_tile", "argmax_final", "Memset"))[1]
                host = host_us_turns({"cluster": kf, "simt": sf})
                k_host, s_host = host["cluster"], host["simt"]
                print(f"kernel 8 {prec} S={S} need_dec {share:.0%}: cluster kernel ms={k_ms:.4f} "
                      f"(device {k_dev:.2f} us a call, host {k_host:.2f} us a call), "
                      f"dec_joiner_simt ms={s_ms:.4f} (device {s_dev:.2f} us, host {s_host:.2f} "
                      f"us) ({card})")


def k9_times(models, card):
    """Kernel 9 by its route (csrc/joiner_stream.cu on the card's
    `joiner_plan`) on the flagship's and the 16,383-token model's bf16 and
    f32 join weights and on the narrow models' joiners (J = 128 at V = 64
    and 16,383, weights drawn from a numpy seed): at S = 3, 256 and 2048
    its plan, its three outputs equal bit for bit to `joiner_argmax_simt`'s
    and both held to the plain version as `_check_joiner` holds them (max_idx
    on the rows clear of a near-tie, max_val and blank_val at atol 1e-4); at
    V = 16,383 (S = 256 and 2048) and V = 500 (S = 256) both timed by CUDA
    events, the profiler's device time a call and the host's time a call
    (`host_us_turns`), beside the plain version's device time, the bound
    and the design's FFMA floor (2 S J V at the f32 rate)."""
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.ops import joiner_plan as JP
    from april_asr_tpu_torch.tools.profile_decode import k9_case

    dev = torch.device(DEV)
    cases = [(prec, models[key].runtime.weights["join_t"], models[key].runtime.weights["join_b"],
              models[key].runtime.blank_id) for prec in ("bf16", "f32")
             for key in (prec, "vocab " + prec)]
    rng = np.random.default_rng(19)
    for J, V in ((128, 64), (128, 16383)):  # the narrow models' joiners
        w = (rng.normal(size=(J, V)) * J ** -0.5).astype(np.float32)
        jb = torch.from_numpy((rng.normal(size=V) * 0.1).astype(np.float32)).to(DEV)
        for prec, wd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            cases.append((prec, torch.from_numpy(w).to(wd).to(DEV), jb, 0))
    names = ("max_idx", "max_val", "blank_val")
    for prec, w_t, b, blank in cases:
        J, V = w_t.shape
        wb, key = w_t.element_size(), "joiner_argmax" + ("_f32" if prec == "f32" else "")
        for S in (3, 256, 2048):
            p = JP.device_joiner_plan(S, J, V, wb, dev.index or 0)
            eout, dout = k9_case(w_t, S, np.random.default_rng(S + V), dev)
            kf = lambda: JK.joiner_argmax_fused(eout, dout, w_t, b, blank_id=blank)  # noqa: E731
            sf = lambda: JK.joiner_argmax_simt(eout, dout, w_t, b, blank)  # noqa: E731
            pf = lambda: JK.joiner_argmax_plain(eout, dout, w_t, b, blank)  # noqa: E731
            before = cuda_build.COUNTS[key]
            got = kf()
            if p is None or cuda_build.COUNTS[key] != before + 1:
                raise AssertionError(f"kernel 9 {prec} S={S} J={J} V={V}: the stream kernel did "
                                     f"not launch ({p})")
            what = f"kernel 9 {prec} S={S} J={J} V={V}"
            _bit_equal(got, sf(), names, f"{what}: the stream kernel against joiner_argmax_simt "
                       f"({k9_plan_line(p)})")
            want = pf()
            clear = _clear_rows(eout, dout, w_t, b, blank, what, 0.9 if S > 3 else 0.0)
            if not torch.equal(got[0][clear], want[0][clear]):
                raise AssertionError(f"{what}: max_idx differs from the plain version")
            for i in (1, 2):
                torch.testing.assert_close(got[i], want[i], atol=1e-4, rtol=0,
                                           msg=f"{what} {names[i]}")
            if J != 512 or S == 3 or (V == 500 and S == 2048):
                continue
            k_ms, s_ms = cuda_ms(kf, 20), cuda_ms(sf, 20)
            k_dev = profiled(kf, 5, "joiner_stream")[1]
            s_dev = profiled(sf, 5, ("joiner_tile", "argmax_final", "Memset"))[1]
            p_dev = profiled(pf, 3, "")[1]
            host = host_us_turns({"stream": kf, "simt": sf})
            b_ms, b_by = bound_ms(S * (2 * J * 4 + 12) + J * V * wb + V * 4,
                                  {"f32" if wb == 4 else "bf16": 2 * S * J * V})
            floor = 2 * S * J * V / PEAK_OPS["f32"] * 1e3
            print(f"kernel 9 {prec} S={S} V={V}: stream kernel ms={k_ms:.4f} (device "
                  f"{k_dev:.2f} us a call, host {host['stream']:.2f} us a call), "
                  f"joiner_argmax_simt ms={s_ms:.4f} (device {s_dev:.2f} us, host "
                  f"{host['simt']:.2f} us), plain device {p_dev:.2f} us, bound_ms={b_ms:.4f} "
                  f"({b_by}), FFMA floor {floor:.4f} ms; {k9_plan_line(p)} ({card})")


def print_mma_plans(rt, S: int, P: int):
    """Kernels 2, 7, 14, 3, 12 and 10's launch plans (ops/lstm_mma.py) at
    the engine's shapes on this card."""
    from april_asr_tpu_torch.ops import lstm_mma as LM

    d, H, F = rt.dims.d_model, rt.dims.hidden, rt.dims.ffn
    for what, plan in (("kernel 2", LM.device_plan(S, d, H, 0, torch.device(DEV))),
                       ("kernel 7", LM.device_plan(S, d, H, F, torch.device(DEV))),
                       ("kernel 14 (phase B)", LM.device_hoist_plan(S, d, H, torch.device(DEV)))):
        print(f"{what} plan at S={S}: {plan.nb} blocks; gate items of {plan.ub} units x "
              f"{plan.gate.rows} rows ({plan.gate.items}); projection items (tiles, rows, column "
              f"groups, items) {plan.proj.ints()}; ff1 {plan.ff1.ints() if plan.ff1 else None}; "
              f"{plan.smem} bytes of shared memory a block")
    fp = LM.ffn_plan(S * P, d, F)
    print(f"kernel 3 plan at R={S * P}: ff1 grid (column tiles, row tiles) {fp.grid(F)}, ff2 "
          f"{fp.grid(d)}; {fp.smem} bytes of shared memory a block; {fp.scratch()[0]} bytes of "
          f"scratch")
    for wb, prec in ((4, "f32"), (2, "bf16")):
        for what, plan in (
                (f"kernel 12 {prec} plan at S={S}", LM.device_float_plan(S, d, H, F, wb,
                                                                         torch.device(DEV))),
                (f"kernel 10 {prec} plan at S={S}, P={P}",
                 LM.device_chunk_plan(S, P, d, H, F, wb, torch.device(DEV)))):
            print(f"{what}: {plan.nb} blocks; gate items of {plan.ub} units; tile splits (rows, "
                  f"columns, column groups, items, depth groups, mma tiles a warp) gates "
                  f"{plan.gate.ints()} projection {plan.proj.ints()} ff1 {plan.ff1.ints()} ff2 "
                  f"{plan.ff2.ints()}; {plan.smem} bytes of shared memory a block")


def _tone_bufs(S, chunk, rate, n=8, seed=0):
    """bench.py-style tone bursts: n distinct [S, chunk] int16 buffers."""
    rng = np.random.default_rng(seed)
    t = np.arange(chunk) / rate
    bufs = []
    for i in range(n):
        gate = (np.sin(2 * np.pi * 1.3 * t + i) > -0.2).astype(np.float32)
        base = 0.35 * np.sin(2 * np.pi * (180 + 60 * i) * t) * gate
        bufs.append(((base[None, :] + rng.normal(0, 0.05, size=(S, chunk))) * 20000).astype(np.int16))
    return bufs


def _lockstep(rt_dev, rt_cpu, S: int, chunk: int, ticks: int, seed: int, what: str, card,
              precision: str | None = None):
    """The CUDA engine (kernels) and the CPU engine (plain versions) on the
    same weights and audio, in lockstep over `ticks` steps and a flush:
    fbank rows within the fbank kernels' bound, h/c within the repo's
    cross-implementation bound, and every session's events, callbacks and
    integer decode state equal up to the first decision the plain decode
    took by a near-tie (testing.near_tie(precision): NEAR_TIE_BF16 for two
    bf16 engines, else NEAR_TIE): random weights are chaotic, and tanhf on
    the card and PyTorch's CPU tanh differ by ulps, which int8
    re-quantization and bf16 rounding can amplify."""
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.engine.step import unpack_events_np
    from april_asr_tpu_torch.testing import INT_DECODE, DecisionMargins, capture_events, check_parting

    bufs = _tone_bufs(S, chunk, rt_dev.sample_rate, seed=seed)
    eng, evs, recs = {}, {}, {}
    for side, rt in (("dev", rt_dev), ("cpu", rt_cpu)):
        eng[side] = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=chunk))
        evs[side], recs[side] = [], [[] for _ in range(S)]
        capture_events(eng[side].prog, unpack_events_np, evs[side])
        for i in range(S):
            eng[side].alloc(lambda r, toks, i=i, rec=recs[side]: rec[i].append(
                (int(r), tuple((t.token_id, t.time_ms) for t in toks))))

    def advance(e, k):
        if k < ticks:
            for i in range(S):
                e.feed(i, bufs[k % len(bufs)][i])
            e.tick()
        else:
            e.flush(np.ones(S, bool))

    parted = {}
    margins = DecisionMargins()  # recorded on the CPU (plain) engine only
    for k in range(ticks + 1):
        margins.reset()
        advance(eng["dev"], k)
        with margins:
            advance(eng["cpu"], k)
        torch.cuda.synchronize()
        a, b = eng["dev"].state, eng["cpu"].state
        torch.testing.assert_close(a["fbank"]["fifo"].cpu(), b["fbank"]["fifo"], atol=2e-5, rtol=1e-4)
        _stat_close(a["h"].cpu(), b["h"], f"{what} h step {k}")
        _stat_close(a["c"].cpu(), b["c"], f"{what} c step {k}")
        n_cells = evs["cpu"][-1]["ops"].shape[1] * evs["cpu"][-1]["ops"].shape[2]
        check_parting(
            k, evs["cpu"][-1], evs["dev"][-1], margins.per_cell(n_cells), recs["cpu"], recs["dev"],
            {key: b["decode"][key].numpy() for key in INT_DECODE},
            {key: a["decode"][key].cpu().numpy() for key in INT_DECODE}, parted,
            precision=precision,
        )
    n = sum(len(r) for r in recs["cpu"])
    if n == 0:
        raise AssertionError(f"{what}: no callbacks")
    print(f"{what}: {S} sessions x {ticks} ticks + flush, {n} callbacks; "
          f"{S - len(parted)} sessions identical end to end, parted at near-ties "
          f"(step, cell, margin): {parted} ({card})")


def reference_model() -> tuple:
    """The `reference` phase's tiny model (3 layers, d 128, seed 3, blank
    logit +2.0): (dims, f32 params, ModelParameters)."""
    from april_asr_tpu_torch.models.export import make_model_parameters
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
    from april_asr_tpu_torch.testing import default_tokens

    dims = TransducerDims(d_model=128, hidden=128, ffn=256, joiner_dim=128, vocab=64,
                          layers=3, decoder_groups=32, conv_channels=(4, 8, 8))
    p = init_transducer_params(3, dims)
    p["join_b"][0] += 2.0
    return dims, p, make_model_parameters(dims, default_tokens(dims.vocab))


def phase_reference(card, precision: str, ticks: int = 6):
    """A tiny model (3 layers, d 128), S=8, 200 ms chunks: `_lockstep` at
    `precision`. The steps run the chunk kernels and, at int8 and bf16,
    kernel 16 (checked), the flush kernels 7 or 12 and kernel 8. At f32
    nothing is re-quantized or rounded to bf16, so every session is expected
    identical end to end; at bf16 a session may part only at a near-tie."""
    from april_asr_tpu_torch.api.model import apply_precision
    from april_asr_tpu_torch.models.loader import native_runtime
    from april_asr_tpu_torch.ops import cuda_build

    dims, p, mp = reference_model()
    rts = [native_runtime("ref", "", "en-us", mp, dims,
                          apply_precision({k: v.to(dev) for k, v in p.items()}, precision), dev)
           for dev in (DEV, "cpu")]
    cuda_build.reset_counts()
    _lockstep(*rts, S=8, chunk=3200, ticks=ticks, seed=4, what=f"reference {precision}", card=card,
              precision=precision)
    if (cuda_build.COUNTS["conv_embed"] > 0) != (precision in ("int8", "bf16")):
        raise AssertionError(f"reference {precision}: kernel 16 launched "
                             f"{cuda_build.COUNTS['conv_embed']} times")
    no_simt_joiner(f"reference {precision}", cuda_build.COUNTS)
    k8 = cuda_build.COUNTS["dec_joiner_f32" if precision == "f32" else "dec_joiner"]
    if k8 == 0:
        raise AssertionError(f"reference {precision}: kernel 8 never launched")


def wall_ms(fn, reps):
    """Host-clock ms of `reps` calls of `fn`, each synchronized."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def embed_ab(rt, run_step, prof_kernel: dict, card, path: str):
    """The step with kernel 16 and with the stacked embed (the runtime's
    `encoder_embed_front` returning None, as at f32 weights), in turns
    (kernel 16, stacked, stacked, kernel 16; 5 steps a turn); the step ms of
    each, and the device kernels whose launches per step differ between the
    two profiles."""
    orig = rt.encoder_embed_front
    off = lambda *a: None  # noqa: E731
    times = {"kernel16": [], "stacked": []}
    try:
        for mode in ("kernel16", "stacked", "stacked", "kernel16"):
            rt.encoder_embed_front = orig if mode == "kernel16" else off
            times[mode] += wall_ms(run_step, 5)
        rt.encoder_embed_front = off
        prof_stacked = profile(run_step, card, f"engine {path} step, stacked embed")
    finally:
        rt.encoder_embed_front = orig
    moved = []
    for k in sorted(set(prof_kernel) | set(prof_stacked)):
        a, b = prof_kernel.get(k, (0.0, 0)), prof_stacked.get(k, (0.0, 0))
        if a[1] != b[1]:
            moved.append(f"{k[:60]} x{b[1]} -> x{a[1]} ({b[0] / 1e3:.3f} -> {a[0] / 1e3:.3f} ms)")
    print(f"engine {path} embed A/B: step_ms kernel16 median={np.median(times['kernel16']):.2f} "
          f"{[round(x, 2) for x in times['kernel16']]} stacked median={np.median(times['stacked']):.2f} "
          f"{[round(x, 2) for x in times['stacked']]}; device kernels per step, stacked -> kernel 16: "
          f"{'; '.join(moved) if moved else 'no profile'} ({card})")


def phase_engine(model, card, path: str, ticks: int = 10, flushes: int = 5, ab: bool = False):
    """BatchEngine S=256, 1 s chunks: `ticks` steps, then a flush of every
    slot; the step's and the flush's launches checked apart (PATH_KERNELS),
    then `flushes` - 1 more flushes, each after one more tick of audio; their
    times (median and range), and the profiler's view of one step and one
    flush. With `ab`, `embed_ab` on the live state."""
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.decode.scalar import RESULT_SESSION_ERROR
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.tools.profile_lstm_mma import FFN_PASSES_KERNELS

    rt = model.runtime
    S, chunk = S_FLAG, CHUNK_1S
    bufs = _tone_bufs(S, chunk, rt.sample_rate)
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=chunk))
    n_cb, errors = [0], []

    def handler(r, toks):
        n_cb[0] += 1
        if r == RESULT_SESSION_ERROR:
            errors.append(r)

    slots = [eng.alloc(handler) for _ in range(S)]
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    tick_ms = []
    for k in range(ticks):
        for s in slots:
            eng.feed(s, bufs[k % len(bufs)][s])
        t0 = time.perf_counter()
        if not eng.tick():
            raise AssertionError(f"engine {path}: tick {k} ran no step")
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    step_counts = require_launches(f"engine {path} step", path, "step")
    cuda_build.reset_counts()
    flush_ms = []
    for k in range(flushes):
        if k:
            for s in slots:
                eng.feed(s, bufs[k % len(bufs)][s])
            eng.tick()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.flush(np.ones(S, bool))
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        if not k:
            flush_counts = require_launches(f"engine {path} flush", path, "flush")
    no_simt_joiner(f"engine {path}", _merge(step_counts, flush_counts))
    st = eng.state
    for name, t in (("h", st["h"]), ("c", st["c"]), ("dout", st["decode"]["dout"]),
                    ("fifo", st["fbank"]["fifo"])):
        if not torch.isfinite(t).all():
            raise AssertionError(f"engine: non-finite {name}")
    if n_cb[0] == 0:
        raise AssertionError("engine: no callbacks")
    if errors:
        raise AssertionError(f"engine {path}: {len(errors)} SESSION_ERROR callbacks")
    no_containment(f"engine {path}")

    # the device programs alone (no staging, no host replay), on the live state
    audio = torch.from_numpy(bufs[0]).to(DEV)
    n = torch.full((S,), chunk, dtype=torch.int32, device=DEV)
    do = torch.ones(S, dtype=torch.bool, device=DEV)
    run_step = lambda: eng.prog.step(eng.weights, eng.state, audio, n)  # noqa: E731
    run_flush = lambda: eng.prog.flush(eng.weights, eng.state, do)  # noqa: E731

    def spread(ms):
        return f"median={np.median(ms):.1f} (min {min(ms):.1f}, max {max(ms):.1f}, n {len(ms)})"

    med_step = float(np.median(wall_ms(run_step, 5)))
    prog_flush = wall_ms(run_flush, 5)
    med_tick = float(np.median(tick_ms[1:])) if ticks > 1 else tick_ms[0]
    aps = S * chunk / rt.sample_rate / (med_tick / 1e3)
    print(f"engine {path}: S={S} chunk={chunk / rt.sample_rate:g} s P={eng.prog.layout.max_pulls_per_step} "
          f"V={rt.dims.vocab} ticks={ticks} tick_ms median={med_tick:.2f} (first {tick_ms[0]:.1f}) "
          f"step_ms median={med_step:.2f} flush_ms {spread(flush_ms)} "
          f"flush_program_ms {spread(prog_flush)} "
          f"audio_s_per_s={aps:.1f} callbacks={n_cb[0]} step_launches={json.dumps(step_counts)} "
          f"flush_launches={json.dumps(flush_counts)} ({card})")
    prof_step = profile(run_step, card, f"engine {path} step")
    k3 = [v for k, v in prof_step.items() if any(n in k for n in FFN_PASSES_KERNELS)]
    if k3:
        print(f"engine {path} step: kernel 3's passes {sum(t for t, _ in k3) / 1e3:.2f} ms of "
              f"device time a step over {sum(c for _, c in k3)} launches ({card})")
    profile(run_flush, card, f"engine {path} flush", n=1)
    if ab:
        embed_ab(rt, run_step, prof_step, card, path)
    return _merge(step_counts, flush_counts)


def no_containment(what: str) -> None:
    """Fails where an engine of this process caught a program failure or
    restarted (engine/batch.py `CONTAINED`): outside `engine_containment`,
    which injects its failures and counts them, every step and flush must
    run on its first try."""
    from april_asr_tpu_torch.engine.batch import CONTAINED

    if any(CONTAINED.values()):
        raise AssertionError(f"{what}: engines caught program failures {CONTAINED}")


def profile(run, card, what: str, n: int = 2) -> dict:
    """Device time by kernel over `n` calls of `run` (torch.profiler) and the
    device's busy share of the wall time; returns {kernel: (device us, launches)}
    per call. Measurement only: if the profiler records no device time here,
    says so, returns {} and goes on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    run()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): a host op's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print(f"profile {what}: no device time recorded; busy share not measured ({card})")
        return {}
    rows.sort(key=lambda r: -r[1])
    top = "; ".join(f"{k[:48]} {t / n / 1e3:.2f} ms x{c // n}" for k, t, c in rows[:8])
    print(f"profile {what}: {n} calls, device busy {busy_us / n / 1e3:.2f} ms of "
          f"{wall_us / n / 1e3:.2f} ms wall per call (busy share {busy_us / wall_us:.3f}), "
          f"{sum(r[2] for r in rows) // n} device kernels per call; per call: {top} ({card})")
    return {k: (t / n, c // n) for k, t, c in rows}


def phase_session(model, card, precision: str):
    from april_asr_tpu_torch.api import Result, Session
    from april_asr_tpu_torch.ops import cuda_build

    rate = model.get_sample_rate()
    pcm = _tone_bufs(1, 3 * rate, rate, n=1, seed=9)[0][0]
    got = []
    sess = Session(model, lambda r, toks: got.append((r, "".join(t.token for t in toks))))
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    for off in range(0, len(pcm), 3200):
        sess.feed_pcm16(pcm[off : off + 3200].tobytes())
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    step_counts = require_launches(f"session {precision} feeds", f"session {precision}", "step")
    cuda_build.reset_counts()
    t1 = time.perf_counter()
    sess.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t1
    P = sess._engine.prog.layout.max_pulls_per_step
    sess.close()
    flush_counts = require_launches(f"session {precision} flush", f"session {precision}", "flush")
    no_simt_joiner(f"session {precision}", _merge(step_counts, flush_counts))
    if not got:
        raise AssertionError("session: no callbacks")
    if any(r == Result.SESSION_ERROR for r, _ in got):
        raise AssertionError(f"session {precision}: a SESSION_ERROR callback")
    no_containment(f"session {precision}")
    kinds = {Result(r).name: sum(1 for x in got if x[0] == r) for r in {x[0] for x in got}}
    print(f"session {precision}: 3 s in 200 ms feeds + flush in {feed_s + flush_s:.2f} s "
          f"(feeds {feed_s:.2f} s, flush {flush_s:.2f} s), P={P}, callbacks={kinds}, "
          f"step_launches={json.dumps(step_counts)} flush_launches={json.dumps(flush_counts)} ({card})")
    return _merge(step_counts, flush_counts)


def _session_run(model, pcm, block: int, gap_s: float = 0.0, prep=None, **kw) -> tuple:
    """A Session fed `pcm` in `block`-sample feeds (`gap_s` apart), then
    flushed: (callbacks [(result, tokens)], feed s, flush s, session).
    `prep(session)` runs before the first feed. Fails on a SESSION_ERROR."""
    from april_asr_tpu_torch.api import Result, Session

    got = []
    sess = Session(model, lambda r, toks: got.append(
        (int(r), tuple((t.token, t.time_ms) for t in toks))), **kw)
    if prep is not None:
        prep(sess)
    t0 = time.perf_counter()
    for off in range(0, len(pcm), block):
        sess.feed_pcm16(pcm[off : off + block].tobytes())
        if gap_s:
            time.sleep(gap_s)
    feed_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    sess.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t1
    if int(Result.SESSION_ERROR) in [r for r, _ in got]:
        raise AssertionError(f"session {kw}: a SESSION_ERROR callback")
    return got, feed_s, flush_s, sess


def session_async(model, card) -> None:
    """At int8: an asynchronous no_rt Session (3 s in 200 ms feeds) whose
    callbacks must equal a synchronous Session's, its worker thread loading
    every kernel library it launches (`cuda_build.unload()` first, so each
    first use goes through cuda_build's lock off the main thread). Prints
    the feed and flush wall times of both."""
    from april_asr_tpu_torch.api import Result
    from april_asr_tpu_torch.ops import cuda_build

    rate = model.get_sample_rate()
    pcm = _tone_bufs(1, 3 * rate, rate, n=1, seed=9)[0][0]
    block = rate // 5
    sync, s_feed, s_flush, sess = _session_run(model, pcm, block)
    sess.close()
    cuda_build.unload()
    asyn, a_feed, a_flush, sess = _session_run(model, pcm, block, asynchronous=True, no_rt=True)
    worker = sess._worker.name
    sess.close()
    loaded_by = cuda_build.loaded_by()
    if asyn != sync:
        raise AssertionError(f"session int8 async: callbacks differ from the sync session's "
                             f"({len(asyn)} against {len(sync)})")
    if not loaded_by or any(t != worker for t in loaded_by.values()):
        raise AssertionError(f"session int8 async: kernel libraries loaded by {loaded_by}, "
                             f"not the worker {worker}")
    if int(Result.FINAL_RECOGNITION) not in [r for r, _ in sync]:
        raise AssertionError("session int8: no FINAL")
    print(f"session int8 async no_rt: {len(asyn)} callbacks equal to the sync session's; feeds "
          f"{a_feed:.3f} s, flush {a_flush:.3f} s (sync: feeds {s_feed:.3f} s, flush "
          f"{s_flush:.3f} s); {len(loaded_by)} kernel libraries first loaded on the worker "
          f"thread ({', '.join(sorted(loaded_by))}) ({card})")


def session_async_rt(model, card) -> None:
    """At int8: an ASYNC_RT Session whose ticks are slowed to ~1.4x
    realtime (its step program takes 0.28 s a 0.2 s chunk, 3 s fed in 200 ms
    feeds 0.3 s apart): get_rt_speedup, the stretcher's speed and the
    callbacks printed, no ERROR_CANT_KEEP_UP allowed, a FINAL required."""
    from april_asr_tpu_torch.api import Result

    rate = model.get_sample_rate()
    pcm = _tone_bufs(1, 3 * rate, rate, n=1, seed=9)[0][0]
    block = rate // 5

    def slow(sess):
        orig = sess._engine.prog.step

        def step(*a):
            t0 = time.monotonic()
            out = orig(*a)
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            if dt < 0.28:
                time.sleep(0.28 - dt)
            return out

        sess._engine.prog = dataclasses.replace(sess._engine.prog, step=step)

    got, feed_s, flush_s, sess = _session_run(model, pcm, block, gap_s=0.3, prep=slow,
                                              asynchronous=True)
    speedup, speed = sess.get_rt_speedup(), sess._stretcher.speed
    sess.close()
    kinds = {Result(r).name: sum(1 for x in got if x[0] == r) for r in {x[0] for x in got}}
    print(f"session int8 ASYNC_RT at ~1.4x realtime: get_rt_speedup {speedup:.3f}, stretcher "
          f"{speed:.3f}x, callbacks {kinds}; feeds {feed_s:.2f} s, flush {flush_s:.2f} s ({card})")
    if "ERROR_CANT_KEEP_UP" in kinds or "FINAL_RECOGNITION" not in kinds:
        raise AssertionError(f"session int8 ASYNC_RT: callbacks {kinds}")
    if not (speedup > 1.05 and speed > 1.0):
        raise AssertionError(f"session int8 ASYNC_RT: speedup {speedup}, stretcher {speed}")


def session_speaker(model, card, tmp: str) -> None:
    """A speaker Session at int8 (1 s of audio, then close) and a new one
    with the same key: its slot's rows equal the snapshot's bit for bit."""
    from april_asr_tpu_torch.api import Session
    from april_asr_tpu_torch.engine.speaker import speaker_path

    rate = model.get_sample_rate()
    pcm = _tone_bufs(1, rate, rate, n=1, seed=13)[0][0]
    old = os.environ.get("APRIL_SPEAKER_CACHE")
    os.environ["APRIL_SPEAKER_CACHE"] = os.path.join(tmp, "speakers")
    try:
        t0 = time.perf_counter()
        _, _, _, sess = _session_run(model, pcm, rate // 5, speaker_name="smoke")
        sess.close()
        save_s = time.perf_counter() - t0
        with np.load(speaker_path(model.get_name(), "smoke")) as f:
            saved = {k: np.asarray(f[k]) for k in f.files}
        sess = Session(model, lambda r, toks: None, speaker_name="smoke")
        st, i = sess._engine.state, sess._slot
        rows = {"h": st["h"][:, i], "c": st["c"][:, i], "context": st["decode"]["context"][i],
                "dout": st["decode"]["dout"][i]}
        sess.close()
    finally:
        if old is None:
            os.environ.pop("APRIL_SPEAKER_CACHE")
        else:
            os.environ["APRIL_SPEAKER_CACHE"] = old
    for k, v in rows.items():
        if not np.array_equal(v.cpu().numpy(), saved[k]):
            raise AssertionError(f"session speaker: restored {k} differs from the snapshot")
    if not np.abs(saved["c"]).max() > 0:
        raise AssertionError("session speaker: the snapshot's c is zero")
    print(f"session int8 speaker: {sorted(saved)} saved ({saved['h'].shape} h, "
          f"{saved['c'].shape} c) and restored bit for bit; session with snapshot "
          f"{save_s:.2f} s ({card})")


def engine_containment(model, card, ticks: int = 3) -> None:
    """The int8 engine at S = 256, 1 s chunks, `ticks` ticks and a flush,
    three times: clean; with the second step failing once (a transient
    failure: every blob must equal the clean run's and no SESSION_ERROR
    fire); with slot 7's h poisoned by NaN after the first tick and the
    second step failing once (only slot 7 gets SESSION_ERROR, and every
    other session's events and callbacks equal the clean run's)."""
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.decode.scalar import RESULT_SESSION_ERROR
    from april_asr_tpu_torch.engine.batch import CONTAINED, BatchEngine
    from april_asr_tpu_torch.engine.step import unpack_events_np
    from april_asr_tpu_torch.testing import EVENT_FIELDS, capture_events

    no_containment("before engine int8 containment")
    S, chunk, bad = S_FLAG, CHUNK_1S, 7
    bufs = _tone_bufs(S, chunk, model.get_sample_rate(), seed=23)

    def run(fail: bool, poison: bool) -> tuple:
        eng = BatchEngine(model.runtime, batch=S, cfg=EngineConfig(chunk_samples=chunk))
        calls, recs = [], [[] for _ in range(S)]
        capture_events(eng.prog, lambda p: (p.blob.clone(), unpack_events_np(p)), calls)
        for i in range(S):
            eng.alloc(lambda r, toks, i=i: recs[i].append(
                (int(r), tuple((t.token_id, t.time_ms) for t in toks))))
        failed = []
        for k in range(ticks):
            if k == 1 and fail:
                orig = eng.prog.step

                def step_once(*a, orig=orig):
                    if not failed:
                        failed.append(True)
                        raise RuntimeError("injected step failure")
                    return orig(*a)

                eng.prog = dataclasses.replace(eng.prog, step=step_once)
            if k == 1 and poison:
                st = dict(eng.state)
                st["h"] = st["h"].clone()
                st["h"][:, bad] = float("nan")
                eng.state = st
            for i in range(S):
                eng.feed(i, bufs[k % len(bufs)][i])
            eng.tick()
        eng.flush(np.ones(S, bool))
        torch.cuda.synchronize()
        return calls, recs, failed

    t0 = time.perf_counter()
    clean, clean_recs, _ = run(False, False)
    transient, t_recs, t_failed = run(True, False)
    if not t_failed or len(transient) != len(clean) or not all(
            torch.equal(a[0], b[0]) for a, b in zip(clean, transient)):
        raise AssertionError("engine int8 containment: a transient step failure changed the blobs")
    if t_recs != clean_recs:
        raise AssertionError("engine int8 containment: a transient failure changed the callbacks")
    poisoned, p_recs, p_failed = run(True, True)
    errs = [i for i in range(S) if any(r == RESULT_SESSION_ERROR for r, _ in p_recs[i])]
    if not p_failed or errs != [bad]:
        raise AssertionError(f"engine int8 containment: SESSION_ERROR went to {errs}, not [{bad}]")
    keep = [i for i in range(S) if i != bad]
    for k, (a, b) in enumerate(zip(clean, poisoned)):
        for f in EVENT_FIELDS + ("logprob",):
            if not np.array_equal(a[1][f][keep], b[1][f][keep]):
                raise AssertionError(f"engine int8 containment: call {k} {f} of a healthy "
                                     "session differs from the clean run's")
    if [p_recs[i] for i in keep] != [clean_recs[i] for i in keep]:
        raise AssertionError("engine int8 containment: a healthy session's callbacks differ")
    if CONTAINED != {"failures": 2, "recoveries": 0}:
        raise AssertionError(f"engine int8 containment: counted {CONTAINED}, not the two "
                             "injected failures and no recovery")
    CONTAINED.update(failures=0, recoveries=0)
    n_ev = sum(int((c[1]["ops"] != 0).sum()) for c in clean)
    print(f"engine int8 containment (S={S}, {ticks} ticks + flush, {n_ev} events): a transient "
          f"step failure left every blob equal to the clean run's; NaN in slot {bad} and a "
          f"failed step evicted slot {bad} alone, the other {len(keep)} sessions' events and "
          f"callbacks equal; 3 runs in {time.perf_counter() - t0:.1f} s ({card})")


def programs_keep_state(models, card) -> None:
    """For the S = 256 engines at int8, bf16 and f32 after a tick: every
    leaf of the state handed to prog.step and prog.flush is bit for bit
    unchanged by the call (containment retries on it)."""
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine, _map

    S, chunk = S_FLAG, CHUNK_1S
    for prec in ("int8", "bf16", "f32"):
        rt = models[prec].runtime
        bufs = _tone_bufs(S, chunk, rt.sample_rate, n=2, seed=29)
        eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=chunk))
        for i in range(S):
            eng.alloc(lambda r, toks: None)
            eng.feed(i, bufs[0][i])
        eng.tick()
        audio = torch.from_numpy(bufs[1]).to(DEV)
        n = torch.full((S,), chunk, dtype=torch.int32, device=DEV)
        do = torch.ones(S, dtype=torch.bool, device=DEV)
        for name, call in (("step", lambda st: eng.prog.step(eng.weights, st, audio, n)),
                           ("flush", lambda st: eng.prog.flush(eng.weights, st, do))):
            before = _map(eng.state, lambda t: t.clone())
            call(eng.state)
            torch.cuda.synchronize()
            moved = [key for key, now, was in _leaves(eng.state, before)
                     if not torch.equal(now, was)]
            if moved:
                raise AssertionError(f"engine {prec}: prog.{name} wrote into its input state "
                                     f"at {moved}")
    print(f"engines int8, bf16, f32 (S={S}): prog.step and prog.flush leave their input state "
          f"unchanged, every leaf bit for bit ({card})")


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def onnx_flagship(tmp: str, card, dims=None, S: int = S_FLAG, ticks: int = 3) -> None:
    """The `engine` phase's flagship weights written by the port's save_april
    in both forms and loaded at int8 on the card: the ONNX form must extract
    and verify (kind "native", kernel 12 launched by the load's
    verification), with weights bit for bit the native form's; both serve
    S sessions of 1 s chunks, `ticks` ticks of the engine phase's audio and
    a flush, their event blobs equal call by call, the ONNX engine on the
    int8 path's kernels."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.testing import capture_events

    d = os.path.join(tmp, "onnx")
    os.makedirs(d, exist_ok=True)
    models = {}
    for form in ("native", "onnx"):
        t0 = time.perf_counter()
        path = flagship_april(d, dims=dims, form=form)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cuda_build.reset_counts()
        t0 = time.perf_counter()
        models[form] = Model(path, precision="int8", device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rt = models[form].runtime
        k12 = cuda_build.COUNTS["lstm_step_f32"]
        stages = ", ".join(f"{k} {v:.3f}" for k, v in rt.load_seconds.items())
        print(f"onnx flagship {form} form ({os.path.getsize(path) / 2**20:.1f} MiB, written in "
              f"{write_s:.2f} s): kind {rt.kind}, Model(precision='int8') in {wall:.3f} s, the load "
              f"by stage (s): {stages}; kernel 12 (f32) launches in the load {k12}"
              + (f"; verification's max |native - interpreter|: {json.dumps(rt.verify_max_diff)}"
                 if rt.verify_max_diff else "") + f" ({card})")
        if form == "onnx" and (rt.kind != "native" or k12 == 0):
            raise AssertionError(f"onnx flagship: kind {rt.kind}, kernel 12 launched {k12} times "
                                 f"by the load's verification")
    wn, wo = models["native"].runtime.weights, models["onnx"].runtime.weights
    if wn.keys() != wo.keys():
        raise AssertionError(f"onnx flagship: weight keys differ: {set(wn) ^ set(wo)}")
    differ = [k for k in wn if wn[k].dtype != wo[k].dtype or not torch.equal(wn[k], wo[k])]
    if differ:
        raise AssertionError(f"onnx flagship: weights differ from the native form's: {differ}")

    chunk = CHUNK_1S
    bufs = _tone_bufs(S, chunk, models["native"].runtime.sample_rate)
    blobs, ms = {}, {}
    for form, model in models.items():
        eng = BatchEngine(model.runtime, batch=S, cfg=EngineConfig(chunk_samples=chunk))
        blobs[form] = []
        capture_events(eng.prog, lambda packed: packed.blob.cpu(), blobs[form])
        for _ in range(S):
            eng.alloc(lambda r, toks: None)
        torch.cuda.synchronize()
        cuda_build.reset_counts()
        ms[form] = []
        for k in range(ticks):
            for s in range(S):
                eng.feed(s, bufs[k % len(bufs)][s])
            t0 = time.perf_counter()
            eng.tick()
            torch.cuda.synchronize()
            ms[form].append((time.perf_counter() - t0) * 1e3)
        step_counts = require_launches(f"onnx flagship {form} step", "int8", "step")
        cuda_build.reset_counts()
        t0 = time.perf_counter()
        eng.flush(np.ones(S, bool))
        torch.cuda.synchronize()
        ms[form].append((time.perf_counter() - t0) * 1e3)
        flush_counts = require_launches(f"onnx flagship {form} flush", "int8", "flush")
        no_simt_joiner(f"onnx flagship {form}", _merge(step_counts, flush_counts))
    if len(blobs["onnx"]) != ticks + 1 or len(blobs["native"]) != ticks + 1:
        raise AssertionError("onnx flagship: a step or the flush was not captured")
    for k, (a, b) in enumerate(zip(blobs["onnx"], blobs["native"])):
        if not torch.equal(a, b):
            raise AssertionError(f"onnx flagship: call {k} blobs differ from the native form's")
    n_ev = sum(int(b[4 : 4 + S].sum()) for b in blobs["native"])
    print(f"onnx flagship int8: S={S} chunk 1 s, {ticks} ticks + flush, blobs equal to the native "
          f"form's at every call ({n_ev} events); tick ms ONNX form "
          f"{[round(x, 2) for x in ms['onnx'][:-1]]} native form "
          f"{[round(x, 2) for x in ms['native'][:-1]]}; flush ms {ms['onnx'][-1]:.1f} / "
          f"{ms['native'][-1]:.1f} ({card})")


def onnx_interp(tmp: str, card, S: int = 8, chunk: int = 3200, ticks: int = 5) -> None:
    """The `reference` phase's model in ONNX form, loaded with
    prefer_native=False on the card and on the CPU: the interpreter's CUDA
    engine in lockstep with its CPU engine over `ticks` ticks and a flush
    (`_lockstep`), on kernel 5 alone of the port's kernels; then on the
    card its step ms, flush ms, wrapper launches and device kernels a step
    (torch.profiler)."""
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.models.export import save_april
    from april_asr_tpu_torch.models.loader import load_model
    from april_asr_tpu_torch.ops import cuda_build

    dims, p, mp = reference_model()
    path = os.path.join(tmp, "reference-onnx.april")
    save_april(path, dims, p, mp, name="ref", form="onnx")
    rts = [load_model(path, prefer_native=False, device=dev) for dev in (DEV, "cpu")]
    if any(rt.kind != "interp" for rt in rts):
        raise AssertionError(f"onnx interp: kinds {[rt.kind for rt in rts]}")
    cuda_build.reset_counts()
    _lockstep(*rts, S=S, chunk=chunk, ticks=ticks, seed=4, what="onnx interp", card=card)
    require_launches("onnx interp lockstep", "onnx interp", "step")

    rt = rts[0]
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=chunk))
    for _ in range(S):
        eng.alloc(lambda r, toks: None)
    bufs = _tone_bufs(S, chunk, rt.sample_rate, seed=4)
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    tick_ms = []
    for k in range(ticks):
        for s in range(S):
            eng.feed(s, bufs[k % len(bufs)][s])
        t0 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    step_counts = require_launches("onnx interp step", "onnx interp", "step")
    audio = torch.from_numpy(bufs[0]).to(DEV)
    n = torch.full((S,), chunk, dtype=torch.int32, device=DEV)
    run_step = lambda: eng.prog.step(eng.weights, eng.state, audio, n)  # noqa: E731
    step_ms = wall_ms(run_step, 5)
    prof = profile(run_step, card, "onnx interp step", n=1)
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    eng.flush(np.ones(S, bool))
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) * 1e3
    flush_counts = require_launches("onnx interp flush", "onnx interp", "flush")
    print(f"onnx interp: S={S} chunk {chunk / rt.sample_rate:g} s P={eng.prog.layout.max_pulls_per_step} "
          f"tick ms {[round(x, 1) for x in tick_ms]} step_ms median={np.median(step_ms):.1f} "
          f"{[round(x, 1) for x in step_ms]} flush_ms {flush_ms:.1f}; wrapper launches a step "
          f"{json.dumps({k: v / ticks for k, v in step_counts.items()})}, in the flush "
          f"{json.dumps(flush_counts)}; device kernels a step "
          f"{sum(c for _, c in prof.values()) if prof else 'not measured'} ({card})")


def phase_onnx(tmp: str, card) -> None:
    """ONNX-form models: the flagship extracted and verified on the card and
    served at int8 beside its native form (`onnx_flagship`), then the
    interpreter's engine against the CPU (`onnx_interp`)."""
    onnx_flagship(tmp, card)
    onnx_interp(tmp, card)


def vocab_narrow(path: str, card):
    """A 1-layer d = J = 128 model with 16,383 tokens: the JAX chunk-decode
    gate passes it, but no block holds a cluster slice of its joiner
    (`decode_plan` gives None) nor the CUDA-core kernel's rows
    (16·(J + max(J, d) + V + T) bytes over the H100's 232,448), so the step
    decodes pull by pull through kernel 8, as the flush does; kernel 8's
    `dj_plan` has no cluster slice for it either, so it runs on the
    CUDA-core kernels (`dec_joiner_simt_f32`). The CUDA
    engine against the CPU engine at S=8 (`_lockstep`, f32 as loaded);
    kernel 4 must never launch."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import DecodeConfig
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import decode_kernels as DK

    rt = Model(path, device=DEV).runtime
    d, J, V = rt.dims.d_model, rt.dims.joiner_dim, rt.dims.vocab
    T = DecodeConfig().max_active_tokens
    wb = rt.weights["join_t"].element_size()
    plan = DK.device_decode_plan(8, J, d, V, T, wb, DEV)
    route = DK.decode_route(8, J, d, V, T, wb, rt.dims.context)
    if not DK.chunk_decode_supported(8, J, d, rt.dims.context, V) or plan is not None \
            or route is not None:
        raise AssertionError(f"vocab narrow: expected the JAX gate to pass and neither kernel 4 "
                             f"to hold it; plan {plan}, route {route}")
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    _lockstep(rt, Model(path, device="cpu").runtime, S=8, chunk=CHUNK_1S, ticks=3, seed=7,
              what="vocab narrow f32 lockstep", card=card)
    c = cuda_build.COUNTS
    k4 = {k: c[k] for k in ("chunk_decode", "chunk_decode_f32", "chunk_decode_simt",
                            "chunk_decode_simt_f32")}
    # no block holds kernel 8's cluster slices either (W's would take
    # 1.08 MB at C = 8): its route is the CUDA-core kernels
    if DK.dj_route(8, J, d, V, wb) != "simt" or c["dec_joiner_f32"]:
        raise AssertionError(f"vocab narrow: kernel 8's cluster route taken "
                             f"({c['dec_joiner_f32']} launches)")
    if any(k4.values()) or not c["dec_joiner_simt_f32"]:
        raise AssertionError(f"vocab narrow: kernel 4 launched {k4}, kernel 8 "
                             f"{c['dec_joiner_simt_f32']} times")
    print(f"vocab narrow: d=J={d} V={V}, decode_plan None, route: per pull; the CUDA-core "
          f"kernel 4 block {DK.chunk_decode_smem(J, d, V, T)} bytes; lockstep in "
          f"{time.perf_counter() - t0:.1f} s, kernel 4 launched 0 times, kernel 8 "
          f"{c['dec_joiner_simt_f32']} times on its CUDA-core route (dj_plan None), kernel 9 "
          f"{c['joiner_argmax_f32']} times ({card})")


def phase_vocab(models, path: str, narrow_path: str, card) -> dict:
    """A flagship-width model with 16,383 tokens (the most a .april holds).
    Kernel 4 cannot hold its [V] logits rows in shared memory, so its
    wrapper refuses it, and the JAX gates route it to the per-pull decode
    through kernel 9. Then the CUDA engine against the CPU engine at S=8
    (`_lockstep`, f32 as loaded), BatchEngine S=256 at f32 and bf16, and
    `vocab_narrow`."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import DecodeConfig
    from april_asr_tpu_torch.decode.greedy import init_decode_state, vocab_tables_device
    from april_asr_tpu_torch.engine.step import INNER_STEPS_EMIT
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import decode_kernels as DK

    rt = models["vocab f32"].runtime
    w, dims = rt.weights, rt.dims
    st = init_decode_state(8, 2, dims.joiner_dim, rt.blank_id, DecodeConfig(), DEV)
    eouts = torch.zeros((1, 8, dims.joiner_dim), dtype=torch.float32, device=DEV)
    try:
        DK.chunk_decode(eouts, torch.ones((1, 8), dtype=torch.bool, device=DEV), st,
                        w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"], w["join_b"],
                        vocab_tables_device(rt.vocab), blank_id=rt.blank_id, stride_ms=40,
                        emit_ramp=INNER_STEPS_EMIT, dcfg=DecodeConfig())
    except ValueError as e:
        print(f"vocab: kernel 4 refuses V={dims.vocab}: {e}")
    else:
        raise AssertionError(f"vocab: kernel 4 took V={dims.vocab}")
    if DK.chunk_decode_supported(S_FLAG, dims.joiner_dim, dims.d_model, dims.context, dims.vocab):
        raise AssertionError("vocab: the chunk decode gate passes V=16383")
    t0 = time.perf_counter()
    cuda_build.reset_counts()
    _lockstep(rt, Model(path, device="cpu").runtime, S=8, chunk=CHUNK_1S, ticks=3, seed=5,
              what="vocab f32 lockstep", card=card)
    k9_route("vocab f32 lockstep", dict(cuda_build.COUNTS), "joiner_argmax_f32")
    print(f"vocab: lockstep in {time.perf_counter() - t0:.1f} s")
    counts = _merge(phase_engine(models["vocab f32"], card, "vocab f32", ticks=3),
                    phase_engine(models["vocab bf16"], card, "vocab bf16", ticks=3))
    k9_route("vocab engines", counts, "joiner_argmax_f32", "joiner_argmax")
    vocab_narrow(narrow_path, card)
    return counts


def k9_route(what: str, counts: dict, *keys) -> None:
    """Kernel 9 ran on its route (csrc/joiner_stream.cu) in `counts`: each
    of `keys` launched, the CUDA-core kernels it replaced
    (`joiner_argmax_simt`) never."""
    simt = {k: counts.get(k, 0) for k in ("joiner_argmax_simt", "joiner_argmax_simt_f32")}
    got = {k: counts.get(k, 0) for k in keys}
    if any(simt.values()) or not all(got.values()):
        raise AssertionError(f"{what}: kernel 9 launched {got}, joiner_argmax_simt {simt}")
    print(f"{what}: kernel 9 on its route (csrc/joiner_stream.cu) {got} times, "
          f"joiner_argmax_simt {simt}")


def serve_once(model, path: str, S: int, ticks: int, card, program: bool = False) -> dict:
    """BatchEngine(S) on `model`, 1 s chunks: `ticks` ticks of tone bursts
    and a flush of every slot, the step's and the flush's launches checked
    apart (PATH_KERNELS[path]), the state finite, callbacks seen; with
    `program`, the step program alone timed (median of 3, wall with a
    synchronize) and profiled on the live state. Returns the launch counts
    of the steps and the flush."""
    from april_asr_tpu_torch.config import EngineConfig
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.ops import cuda_build

    rt = model.runtime
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=CHUNK_1S))
    n_cb = [0]
    slots = [eng.alloc(lambda r, toks: n_cb.__setitem__(0, n_cb[0] + 1)) for _ in range(S)]
    bufs = _tone_bufs(S, CHUNK_1S, rt.sample_rate)
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    for k in range(ticks):
        for s in slots:
            eng.feed(s, bufs[k % len(bufs)][s])
        eng.tick()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step_counts = require_launches(f"widths {path} step", path, "step")
    cuda_build.reset_counts()
    eng.flush(np.ones(S, bool))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    flush_counts = require_launches(f"widths {path} flush", path, "flush")
    st = eng.state
    for name, t in (("h", st["h"]), ("c", st["c"]), ("dout", st["decode"]["dout"])):
        if not torch.isfinite(t).all():
            raise AssertionError(f"widths {path}: non-finite {name}")
    if n_cb[0] == 0:
        raise AssertionError(f"widths {path}: no callbacks")
    if program:
        audio = torch.from_numpy(bufs[0]).to(DEV)
        n = torch.full((S,), CHUNK_1S, dtype=torch.int32, device=DEV)
        run_step = lambda: eng.prog.step(eng.weights, eng.state, audio, n)  # noqa: E731
        cuda_build.reset_counts()
        step_ms = wall_ms(run_step, 3)
        launched = require_launches(f"widths {path} step program", path, "step")
        print(f"widths {path} step program: step_ms median={np.median(step_ms):.2f} "
              f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}, n {len(step_ms)}) "
              f"launches={json.dumps(launched)} ({card})")
        profile(run_step, card, f"widths {path} step")
    dims = rt.dims
    print(f"widths {path}: d={dims.d_model} H={dims.hidden} F={dims.ffn} L={dims.layers} S={S}: "
          f"{ticks} ticks in {t1 - t0:.2f} s, flush {t2 - t1:.2f} s, {n_cb[0]} callbacks, "
          f"step_launches={json.dumps(step_counts)} flush_launches={json.dumps(flush_counts)} "
          f"({card})")
    return _merge(step_counts, flush_counts)


def check_wide_int8(rt, S: int, P: int, seed: int, card) -> dict:
    """The int8 routes at a model's widths (layer 0): kernel 2's call (kernel
    14 where kernel 2 has no plan), kernel 7's call (the three-pass step,
    ungated and gated) and kernel 3 against their plain versions, to
    `_ulp_close`; kernel 14 also bit for bit against its CUDA-core template
    at S and at 2048 rows (`wide_rec_vs_template`), kernel 3 against the
    CUDA-core kernel's 4-row tiles, each timed beside it. Returns the JSON
    checks of the three calls."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_mma as LM

    w, dims = rt.weights, rt.dims
    d, H, Fn = dims.d_model, dims.hidden, dims.ffn
    routes = LM.int8_routes(S, P, d, H, Fn, LM.device_sm(torch.device(DEV)))
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h0 = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c0 = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    n_pulls = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    sa = tuple(w[k][0] for k in LK.LAYER_I8_KEYS)
    got = LK.lstm_layer_chunk_rec_stream2_i8(x, h0, c0, *sa[:7], n_pulls)
    want = LK.lstm_rec_plain(x, h0, c0, n_pulls, *sa[:7])
    torch.cuda.synchronize()
    err14 = max(_ulp_close(g, wv, f"wide kernel 2's route {k}")
                for g, wv, k in zip(got, want, ("hseq", "h", "c")))
    wide_rec_vs_template(sa[:7], S, P, d, H, x, h0, c0, n_pulls, card)
    b = bound_ms(2 * P * S * d * 4 + 2 * S * (d + H) * 4 + 2 * d * 4 * H + H * d + (8 * H + d) * 4,
                 {"int8": 2 * P * S * (2 * d * 4 * H + H * d)})
    out = {"lstm_rec_stream_i8_wide": (
        lambda: LK.lstm_layer_chunk_rec_stream2_i8(x, h0, c0, *sa[:7], n_pulls),
        lambda: LK.lstm_rec_plain(x, h0, c0, n_pulls, *sa[:7]), err14, b,
        f"x[{P},{S},{d}] H={H} (kernel 2's route)")}
    xs, gate = x[0], t(rng.random(S) < 0.5)
    err = 0.0
    for g in (None, gate):
        got = LK.lstm_layer_fused_i8(xs, h0, c0, *sa, g)
        want = LK.lstm_layer_fused_i8_plain(xs, h0, c0, *sa, g)
        torch.cuda.synchronize()
        err = max([err] + [_ulp_close(gv, wv, f"wide kernel 7's route {k}")
                           for gv, wv, k in zip(got, want, ("y", "h", "c"))])
    b = bound_ms(4 * S * (4 * d + 2 * H) + 2 * d * 4 * H + H * d + 2 * d * Fn
                 + (2 * 4 * H + 2 * d + Fn) * 4 + (4 * H + Fn + d) * w["bias"].element_size() + 4,
                 {"int8": 2 * S * (2 * d * 4 * H + H * d + 2 * d * Fn)})
    out["lstm_step_i8_simt"] = (lambda: LK.lstm_layer_fused_i8(xs, h0, c0, *sa),
                                lambda: LK.lstm_layer_fused_i8_plain(xs, h0, c0, *sa), err, b,
                                f"x[{S},{d}] H={H} ffn={Fn} (kernel 7's route)")
    # kernel 3 against the CUDA-core kernel's 4-row tiles, its route here
    # before the tensor-core passes (no larger tile fits at these widths)
    xr, hs = x.reshape(P * S, d), t(rng.normal(size=(P * S, d)).astype(np.float32))
    out["ffn_norm_i8_wide"] = check_ffn(xr, hs, sa[7:], (4,), "wide kernel 3")
    print(f"widths wide int8 routes at S={S}, P={P}: {routes}; kernel 14 max_abs_err {err14:.3g}, "
          f"the three-pass step {err:.3g}, kernel 3 {out['ffn_norm_i8_wide'][2]:.3g}")
    ffn_yardstick(xr, hs, sa[7:], 4, card, 10)
    return out


def check_padded_layers(rt, S: int, P: int, seed: int) -> str:
    """Each layer kernel of a model whose widths are not multiples of 4 on
    the operands the encoder stacks give it (`padded_operands`: layer 0's
    weights and the rows zero-padded to the next multiples of 4, the
    norm's width the model's d_model), against its plain version on the
    model's own weights and widths: kernels 2, 3 and 7 on int8 weights
    (`_ulp_close`, gated and ungated), kernels 10 and 12 on f32 or bf16
    weights (`FLOAT_TOL`), and every padded output column exactly zero.
    Returns a summary of the largest differences."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF
    from april_asr_tpu_torch.ops import lstm_kernels as LK

    w = rt.weights
    q = TM.is_quantized(w)
    d, H, F = TM.layer_widths(w)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h0 = t((rng.normal(size=(1, S, d)) * 0.3).astype(np.float32))
    c0 = t((rng.normal(size=(1, S, H)) * 0.3).astype(np.float32))
    n_pulls = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    gate = t(rng.random(S) < 0.5)
    pw, xp, hp, cp, norm_d = TM.padded_operands(w, x, h0, c0)
    dp, Hp = xp.shape[-1], cp.shape[-1]
    if (dp, Hp) == (d, H) or norm_d != d:
        raise AssertionError(f"padded layers: widths d={d}, H={H} not padded ({dp}, {Hp})")
    keys = TM.STEP_I8_KEYS if q else TM.STEP_KEYS
    lw, lp = tuple(w[k][0] for k in keys), tuple(pw[k][0] for k in keys)
    errs = {}

    def held(name, got, want, widths, close):
        for g, wv, n, k in zip(got, want, widths, ("y", "h", "c")):
            torch.cuda.synchronize()
            if torch.count_nonzero(g[..., n:]):
                raise AssertionError(f"padded {name} {k}: a padded column is not zero")
            errs[name] = max(errs.get(name, 0.0), close(g[..., :n].contiguous(), wv, f"padded {name} {k}"))

    if q:
        ulp = _ulp_close
        held("kernel 2", LK.lstm_layer_chunk_rec_stream2_i8(xp, hp[0], cp[0], *lp[:7], n_pulls),
             LK.lstm_rec_plain(x, h0[0], c0[0], n_pulls, *lw[:7]), (d, d, H), ulp)
        R = P * S
        hs = t(rng.normal(size=(R, d)).astype(np.float32))
        held("kernel 3", [LK.ffn_norm_i8(xp.reshape(R, dp), torch.nn.functional.pad(hs, (0, dp - d)),
                                         *lp[7:], norm_d=d)],
             [LK.ffn_norm_plain(x.reshape(R, d), hs, *lw[7:])], (d,), ulp)
        for g in (None, gate):
            held("kernel 7", LK.lstm_layer_fused_i8(xp[0], hp[0], cp[0], *lp, g, norm_d=d),
                 LK.lstm_layer_fused_i8_plain(x[0], h0[0], c0[0], *lw, g), (d, d, H), ulp)
    else:
        prec = "bf16" if w["w_ih_t"].dtype == torch.bfloat16 else "f32"
        atol, rtol = FLOAT_TOL[prec]

        def fclose(g, wv, what):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{what}: non-finite values")
            torch.testing.assert_close(g, wv, atol=atol, rtol=rtol, msg=what)
            return float((g - wv).abs().max())

        held("kernel 10", LF.lstm_layer_chunk_fused(xp, hp[0], cp[0], *lp, n_pulls, norm_d=d),
             LF.lstm_layer_chunk_plain(x, h0[0], c0[0], *lw, n_pulls), (d, d, H), fclose)
        for g in (None, gate):
            held("kernel 12", LF.lstm_layer_fused(xp[0], hp[0], cp[0], *lp, g, norm_d=d),
                 LF.lstm_layer_fused_plain(x[0], h0[0], c0[0], *lw, g), (d, d, H), fclose)
    return (f"d={d} H={H} F={F} padded to d={dp} H={Hp} F={pw['ff1_t_q8' if q else 'ff1_t'].shape[-1]}"
            f" at S={S}, P={P}: " + ", ".join(f"{k} max_abs_err {v:.3g}" for k, v in errs.items()))


def check_padded_tp(rt, S: int, m: int, seed: int) -> str:
    """The tensor-parallel kernels 18 and 20 (f32 or bf16 weights) or 19
    and 21 (int8) at m shards of a model whose shard widths are not
    multiples of 4, on the operands the TP stack gives them
    (`padded_operands` of each rank's slices: layer 0's weights and the rows
    zero-padded to the next multiples of 4), each call required to launch
    its one-launch kernel, against the plain versions on the rank's own
    slices and widths (`_ulp_close` at int8, FLOAT_TOL at float weights; 18
    and 19 gated and ungated), every padded output column exactly zero.
    Returns a summary of the largest differences."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import lstm_tp_kernels as TK
    from april_asr_tpu_torch.ops.widths import zero_pad
    from april_asr_tpu_torch.parallel import TPMesh, prepare_tp_weights

    w = rt.weights
    q = TM.is_quantized(w)
    keys = TM.STEP_I8_KEYS if q else TM.STEP_KEYS
    d = TM.layer_widths(w)[0]
    prec = "int8" if q else ("bf16" if w["w_ih_t"].dtype == torch.bfloat16 else "f32")
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    errs, shapes = {}, []

    def close(g, wv, what):
        if q:
            return _ulp_close(g, wv, what)
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite values")
        atol, rtol = FLOAT_TOL[prec]
        torch.testing.assert_close(g, wv, atol=atol, rtol=rtol, msg=what)
        return float((g - wv).abs().max())

    def held(name, count, call, plain, widths):
        before = cuda_build.COUNTS[count]
        got, want = call(), plain()
        if cuda_build.COUNTS[count] != before + 1:
            raise AssertionError(f"padded tp {name}: {count} did not launch")
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, wv, n in zip(got, want, widths):
            torch.cuda.synchronize()
            if torch.count_nonzero(g[..., n:]):
                raise AssertionError(f"padded tp {name}: a padded column is not zero")
            errs[name] = max(errs.get(name, 0.0),
                             close(g[..., :n].contiguous(), wv, f"padded tp {name}"))

    for r in range(m):
        sh = prepare_tp_weights({k: w[k][:1] for k in keys}, TPMesh(None, r, m))
        _, Hs, Fs = TM.layer_widths(sh)
        x = t(rng.normal(size=(S, d)).astype(np.float32))
        h = t((rng.normal(size=(1, S, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(1, S, Hs)) * 0.3).astype(np.float32))
        y = t(rng.normal(size=(S, d)).astype(np.float32))
        gate = t(rng.random(S) < 0.5)
        pw, xp, hp, cp, _ = TM.padded_operands(sh, x, h, c)
        dp, Hp, Fp = xp.shape[-1], cp.shape[-1], pw["ff1_t_q8" if q else "ff1_t"].shape[-1]
        if (dp, Hp, Fp) == (d, Hs, Fs):
            raise AssertionError(f"padded tp: shard widths d={d}, Hs={Hs}, Fs={Fs} not padded")
        shapes.append(f"rank {r}: d={d} Hs={Hs} Fs={Fs} padded to {dp}, {Hp}, {Fp}")
        yp = zero_pad(y, (S, dp))
        lw, lp = ({k: v[0] for k, v in sh.items()}, {k: v[0] for k, v in pw.items()})
        if q:
            for g in (None, gate):
                held("kernel 19", "tp_gc_i8",
                     lambda g=g: TK.lstm_gates_cell_i8(xp, hp[0], cp[0], *(lp[k] for k in GC_I8), g),
                     lambda g=g: TK.lstm_gates_cell_i8_plain(x, h[0], c[0], *(lw[k] for k in GC_I8),
                                                             g), (Hs, Hs))
            held("kernel 21", "tp_ffn_mid_i8", lambda: TK.ffn_mid_i8(yp, *(lp[k] for k in MID_I8)),
                 lambda: TK.ffn_mid_i8_plain(y, *(lw[k] for k in MID_I8)), (Fs,))
        else:
            gk, fk = TP_FLOAT_KEYS[:4], TP_FLOAT_KEYS[4:]
            for g in (None, gate):
                held("kernel 18", f"tp_gcp_{prec}",
                     lambda g=g: TK.lstm_gate_cell_proj(xp, hp[0], cp[0], *(lp[k] for k in gk), g),
                     lambda g=g: TK.lstm_gate_cell_proj_plain(x, h[0], c[0], *(lw[k] for k in gk),
                                                              g), (d, Hs))
            held("kernel 20", f"tp_ffn_{prec}", lambda: TK.ffn_partial(yp, *(lp[k] for k in fk)),
                 lambda: TK.ffn_partial_plain(y, *(lw[k] for k in fk)), (d,))
    return (f"{'; '.join(shapes)} at S={S}: "
            + ", ".join(f"{k} max_abs_err {v:.3g}" for k, v in errs.items()))


def check_embed_widths(rt, S: int, P: int, seed: int) -> str:
    """Kernel 16 (and 17) on `rt`'s bf16 embed weights, and again on random
    bf16 embed weights at an odd d_model (67), each held to `_embed_close`:
    the conv channels and d_model zero-padded to the kernel's widths."""
    import types

    from april_asr_tpu_torch.models import lstm_transducer as TM

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    dims67 = dataclasses.replace(rt.dims, d_model=67, decoder_groups=1)
    p67 = {k: v.to(DEV) for k, v in TM.init_transducer_params(seed, dims67).items()}
    rt67 = types.SimpleNamespace(weights=TM.cast_weights(p67, torch.bfloat16), dims=dims67)
    out = []
    for r in (rt, rt67):
        for name, v in check_conv_embed(r, S, P, rng, t).items():
            out.append(f"{name} at d={r.dims.d_model} c={r.dims.conv_channels} "
                       f"max_abs_err {v[2]:.3g}")
    return "; ".join(out)


def wide_rec_vs_template(la, S: int, P: int, d: int, H: int, x, h0, c0, n_pulls, card) -> None:
    """Kernel 14 (csrc/lstm_hoist.cu) at a wide model's widths, bit for bit
    against its CUDA-core template (`lstm_rec_stream_i8_simt`) at S rows and
    at 2048 (the JAX tools' batch), gated, with its plan; kernel 14 timed by
    CUDA events (5 calls) and the profiler's device time, the template by
    CUDA events around the one call checked."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_mma as LM

    rng = np.random.default_rng(S + 2048)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    for Sw in (S, 2048):
        if Sw != S:
            x = t(rng.normal(size=(P, Sw, d)).astype(np.float32))
            h0 = t((rng.normal(size=(Sw, d)) * 0.3).astype(np.float32))
            c0 = t((rng.normal(size=(Sw, H)) * 0.3).astype(np.float32))
            n_pulls = t(rng.integers(0, P + 1, size=Sw).astype(np.int32))
        plan = LM.device_hoist_plan(Sw, d, H, torch.device(DEV))
        call = lambda: LK.lstm_layer_chunk_rec_stream_i8(x, h0, c0, *la, n_pulls)  # noqa: E731
        got = call()
        ms = cuda_ms(call, 5, warmup=1)
        dev_ms = profiled(call, 3, ("hoist",))[1] / 1e3
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        simt = LK.lstm_layer_chunk_rec_stream_i8_simt(x, h0, c0, *la, n_pulls)
        b.record()
        b.synchronize()
        _bit_equal(got, simt, REC, f"widths kernel 14 vs its CUDA-core template at d={d}, H={H}, "
                   f"S={Sw}, P={P}")
        print(f"widths kernel 14 at d={d} H={H} S={Sw} P={P}: ms={ms:.4f} (device {dev_ms:.4f}); "
              f"lstm_rec_stream_i8_simt ms={a.elapsed_time(b):.4f} (one call); plan: {plan.nb} "
              f"blocks, gate items of {plan.ub} units x {plan.gate.rows} rows "
              f"({plan.gate.items}), projection {plan.proj.ints()}, {plan.smem} bytes of shared "
              f"memory a block, {LM.hoist_scratch(plan, P)[0]} bytes of scratch ({card})")
        del got, simt


def phase_widths(tmp: str, card, reps: int = 10):
    """Models the port once refused. A 2-layer int8 model at d 1024 / H
    4096 / F 8192, wider than kernels 2 and 7 hold: its routed kernels
    against their plain versions at S=256, the flagship engine's batch
    (`check_wide_int8`, timed), then BatchEngine S=256 for 3 ticks and a
    flush on those routes (`serve_once`).
    A 2-layer float model at d 68 / H 260 / F 196: the CUDA engine against
    the CPU engine at f32 (`_lockstep`), then `serve_once` at f32 and bf16.
    A model at d 66 / H 258 / F 198, conv channels (4, 12, 20) (`ODD`): its
    layer kernels on padded operands against their plain versions
    (`check_padded_layers`, S=256, P=27), the tensor-parallel kernels on
    its m = 2 shards' padded operands (`check_padded_tp`, S=8) and kernel 16
    (`check_embed_widths`) at int8 and f32, then `_lockstep` and
    `serve_once` at f32 and int8 on those kernels (PATH_KERNELS "d66 ...").
    Returns (JSON rows, {path: launch counts})."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

    t0 = time.perf_counter()
    counts = {}
    wide_dir = os.path.join(tmp, "wide")
    os.makedirs(wide_dir)
    wide = Model(flagship_april(wide_dir, seed=9, dims=TransducerDims(**WIDE)), precision="int8",
                 device=DEV)
    print(f"widths: wide int8 model written and loaded in {time.perf_counter() - t0:.1f} s")
    rows = time_rows(check_wide_int8(wide.runtime, S_FLAG, 27, seed=15, card=card), card, reps)
    counts["wide int8"] = serve_once(wide, "wide int8", S_FLAG, 3, card, program=True)
    del wide
    narrow = TransducerDims(**NARROW)
    narrow_dir = os.path.join(tmp, "narrow68")
    os.makedirs(narrow_dir)
    path = flagship_april(narrow_dir, seed=10, dims=narrow)
    _lockstep(Model(path, device=DEV).runtime, Model(path, device="cpu").runtime, S=8,
              chunk=CHUNK_1S, ticks=2, seed=16, what="widths narrow f32 lockstep", card=card)
    for prec in ("f32", "bf16"):
        model = Model(path, precision=None if prec == "f32" else prec, device=DEV)
        counts[f"narrow {prec}"] = serve_once(model, f"narrow {prec}", 8, 2, card)
    # d 66 / H 258 / F 198: the layer kernels on zero-padded widths
    odd_dir = os.path.join(tmp, "narrow66")
    os.makedirs(odd_dir)
    odd = flagship_april(odd_dir, seed=11, dims=TransducerDims(**ODD))
    for prec in ("f32", "int8"):
        p = None if prec == "f32" else prec
        rt = Model(odd, precision=p, device=DEV).runtime
        print(f"widths d66 {prec}: {check_padded_layers(rt, S_FLAG, 27, seed=18)}")
        print(f"widths d66 {prec} tp (m=2): {check_padded_tp(rt, 8, 2, seed=20)}")
        if prec == "int8":
            print(f"widths d66 embed: {check_embed_widths(rt, S_FLAG, 27, seed=19)}")
        _lockstep(Model(odd, precision=p, device=DEV).runtime,
                  Model(odd, precision=p, device="cpu").runtime, S=8, chunk=CHUNK_1S, ticks=2,
                  seed=17, what=f"widths d66 {prec} lockstep", card=card)
        counts[f"d66 {prec}"] = serve_once(Model(odd, precision=p, device=DEV), f"d66 {prec}", 8,
                                           2, card)
    print(f"widths: {time.perf_counter() - t0:.1f} s")
    return rows, counts


def check_chunk_kernels(params, S: int, P: int, seed: int, Lk: int = 6) -> dict:
    """Kernels 13, 14, their CUDA-core templates, 22 (kernel 14's launches,
    as JAX's 512 and 256 block_s) and its template (on 4- and 2-session
    tiles; layer 0's recurrent core), 11 (layer 0 whole) and its template,
    and 15 (a slab of layers 0..Lk-1) and its template on the int8 serving
    weights `params`, at S sessions and P pulls, gated by random n_pulls,
    against their plain versions: one layer to `_ulp_close`, the slab to
    `_stat_close`; then kernels 11, 15 and 22 bit for bit against their
    templates, gated and ungated (`check_chunk_templates`). Returns {name:
    (kernel call, plain call, max abs err, bound, shape)}."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_wavefront_kernels as LW
    from april_asr_tpu_torch.tools.profile_chunk_split import (
        INTERLEAVE_TS, rec_interleave_i8, rec_interleave_i8_simt)

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    H, d = params["w_hr_t_q8"].shape[1:]
    Fn = params["ff1_t_q8"].shape[2]
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    hs = t((rng.normal(size=(Lk, S, d)) * 0.3).astype(np.float32))
    cs = t((rng.normal(size=(Lk, S, H)) * 0.3).astype(np.float32))
    n_pulls = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    slab = tuple(params[k][:Lk] for k in LK.LAYER_I8_KEYS)
    layer = tuple(w[0] for w in slab)
    # bytes: x in, the output and h/c out, n_pulls, weights and scales,
    # biases at their type; int8 ops of the gate, projection and FFN dots
    io = 2 * P * S * d * 4 + 2 * S * (d + H) * 4 + S * 4
    bias_b = params["bias"].element_size()
    rec_w = 2 * d * 4 * H + H * d + (8 * H + d) * 4 + 4 * H * bias_b
    ffn_w = 2 * d * Fn + (Fn + d) * (4 + bias_b) + 4
    rec_ops = 2 * P * S * (2 * d * 4 * H + H * d)
    ffn_ops = 2 * P * S * 2 * d * Fn
    shape = f"x[{P},{S},{d}] H={H}"
    out = {}
    # kernel 22 computes kernel 13's function and shares its bound: the h/c
    # carry between its template's launches is a cost of that design, not
    # bytes the function must move
    ts = {b: f" tile={INTERLEAVE_TS[b]}" for b in INTERLEAVE_TS}
    cores = (("lstm_rec_i8", LK.lstm_layer_chunk_rec_i8, ""),
             ("lstm_rec_stream_i8", LK.lstm_layer_chunk_rec_stream_i8, ""),
             ("lstm_rec_i8_simt", LK.lstm_layer_chunk_rec_i8_simt, ""),
             ("lstm_rec_stream_i8_simt", LK.lstm_layer_chunk_rec_stream_i8_simt, ""),
             ("rec_interleave_i8", functools.partial(rec_interleave_i8, block_s=512),
              " block_s=512"),
             ("rec_interleave_i8_ts2", functools.partial(rec_interleave_i8, block_s=256),
              " block_s=256"),
             ("rec_interleave_i8_simt", functools.partial(rec_interleave_i8_simt, block_s=512),
              ts[512]),
             ("rec_interleave_i8_ts2_simt",
              functools.partial(rec_interleave_i8_simt, block_s=256), ts[256]))
    for name, fn, tile in cores:
        kf = lambda fn=fn: fn(x, hs[0], cs[0], *layer[:7], n_pulls)  # noqa: E731
        pf = lambda: LK.lstm_rec_plain(x, hs[0], cs[0], n_pulls, *layer[:7])  # noqa: E731
        got, want = kf(), pf()
        torch.cuda.synchronize()
        err = max(_ulp_close(g, wv, f"{name} {k}") for g, wv, k in zip(got, want, REC))
        out[name] = (kf, pf, err, bound_ms(io + rec_w, {"int8": rec_ops}), shape + tile)
    pf = lambda: LK.lstm_chunk_i8_plain(x, hs[0], cs[0], *layer, n_pulls)  # noqa: E731
    for name, fn in (("lstm_chunk_i8", LK.lstm_layer_chunk_fused_i8),
                     ("lstm_chunk_i8_simt", LK.lstm_layer_chunk_fused_i8_simt)):
        kf = lambda fn=fn: fn(x, hs[0], cs[0], *layer, n_pulls)  # noqa: E731
        got, want = kf(), pf()
        torch.cuda.synchronize()
        err = max(_ulp_close(g, wv, f"{name} {k}") for g, wv, k in zip(got, want, "yhc"))
        out[name] = (kf, pf, err, bound_ms(io + rec_w + ffn_w, {"int8": rec_ops + ffn_ops}),
                     f"{shape} ffn={Fn}")
    check_chunk_templates(x, hs, cs, slab, n_pulls, S, P)
    pf = lambda: LW.lstm_slab_wavefront_plain(x, hs, cs, *slab, n_pulls=n_pulls)  # noqa: E731
    b = bound_ms(2 * P * S * d * 4 + Lk * (2 * S * (d + H) * 4 + rec_w + ffn_w) + S * 4,
                 {"int8": Lk * (rec_ops + ffn_ops)})
    for name, fn in (("lstm_wavefront_i8", LW.lstm_slab_wavefront_i8),
                     ("lstm_wavefront_i8_simt", LW.lstm_wavefront_i8_simt)):
        kf = lambda fn=fn: fn(x, hs, cs, *slab, n_pulls)  # noqa: E731
        got, want = kf(), pf()
        torch.cuda.synchronize()
        for g, wv, k in zip(got, want, "yhc"):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {k}: non-finite values")
            _stat_close(g, wv, f"{name} {k}")
        err = max(float((g - wv).abs().max()) for g, wv in zip(got, want))
        out[name] = (kf, pf, err, b, f"{shape} ffn={Fn} slab={Lk}")
    return out


def check_chunk_templates(x, hs, cs, slab, n_pulls, S: int, P: int) -> None:
    """Kernel 11 (csrc/lstm_hoist.cu) bit for bit against its CUDA-core
    template (csrc/lstm_chunk_i8.cu) on layer 0, kernel 15
    (csrc/lstm_wavefront_hoist.cu) against its template
    (csrc/lstm_wavefront.cu) on the slab, and kernel 22 (kernel 14's
    launches) against its template on both tiles, gated by n_pulls and
    ungated; each new kernel's launch counted, its template's not, and the
    other way round."""
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_wavefront_kernels as LW
    from april_asr_tpu_torch.tools.profile_chunk_split import (
        INTERLEAVE_SIMT, rec_interleave_i8, rec_interleave_i8_simt)

    h0, c0, layer = hs[0], cs[0], tuple(w[0] for w in slab)
    pairs = [("lstm_chunk_i8", "lstm_chunk_i8_simt",
              lambda g: LK.lstm_layer_chunk_fused_i8(x, h0, c0, *layer, g),
              lambda g: LK.lstm_layer_chunk_fused_i8_simt(x, h0, c0, *layer, g), "yhc"),
             ("lstm_wavefront_i8", "lstm_wavefront_i8_simt",
              lambda g: LW.lstm_slab_wavefront_i8(x, hs, cs, *slab, g),
              lambda g: LW.lstm_wavefront_i8_simt(x, hs, cs, *slab, g), "yhc")]
    for b, simt in INTERLEAVE_SIMT.items():
        pairs.append(("rec_interleave_i8", simt,
                      lambda g, b=b: rec_interleave_i8(x, h0, c0, *layer[:7], g, block_s=b),
                      lambda g, b=b: rec_interleave_i8_simt(x, h0, c0, *layer[:7], g, block_s=b),
                      REC))
    for new, simt, kf, tf, names in pairs:
        for g in (n_pulls, None):
            tag = f"{'gated' if g is not None else 'ungated'} at S={S}, P={P}"
            cuda_build.reset_counts()
            got = kf(g)
            mine = dict(cuda_build.COUNTS)
            cuda_build.reset_counts()
            want = tf(g)
            theirs = dict(cuda_build.COUNTS)
            if not mine[new] or mine[simt] or theirs[new] or not theirs[simt]:
                raise AssertionError(f"{new} vs {simt} {tag}: launches {mine[new]}, {mine[simt]} "
                                     f"then {theirs[new]}, {theirs[simt]}")
            _bit_equal(got, want, names, f"chunk {new} vs its template {simt} {tag}")


# the tool stacks that run kernels 11, 22 and 15 and the kernels each launches
STACK_LAUNCHES = {"fused": {"lstm_chunk_i8"},
                  "interleave-ts4": {"rec_interleave_i8", "ffn_norm_i8"},
                  "interleave-ts2": {"rec_interleave_i8", "ffn_norm_i8"},
                  **{f"wavefront-{n}": {"lstm_wavefront_i8"} for n in (6, 4, 12)}}


def phase_chunk(card, reps: int = 20):
    """The int8 chunk-layer variants at flagship widths, S=256, P=27: each
    new kernel against its plain version (`check_chunk_kernels`; kernels 11,
    15 and 22 also bit for bit against their templates), timed, and checked
    again at S=3, P=5; then every stack variant of the ported tools on the
    tools' own inputs, held to `_stat_close` against the shipped stack
    (kernel 2 + 3; split-xla, whose FFN is plain tensor code, against the
    plain stack), with its time and launches per stack; the stacks of
    kernels 11, 22 and 15 equal to it bit for bit and launching exactly
    STACK_LAUNCHES, no stack a template. No engine path runs these kernels:
    their JSON rows keep 0 launches."""
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims
    from april_asr_tpu_torch.tools import profile_chunk_split as PCS
    from april_asr_tpu_torch.tools import profile_wavefront as PWF

    t0 = time.perf_counter()
    S, P = S_FLAG, 27
    args = PCS.build(S, P, TransducerDims(), torch.device(DEV))
    rows = time_rows(check_chunk_kernels(args[0], S, P, seed=11), card, reps)
    ragged = check_chunk_kernels(args[0], 3, 5, seed=12)
    print("chunk kernels at ragged shapes S=3 P=5: " + ", ".join(
        f"{n} max_abs_err={v[2]:.3g}" for n, v in ragged.items()))
    ref = PCS.stack_shipped(*args)
    # split-xla computes its FFN + BasicNorm as plain tensor code, so it is
    # held against the plain stack, which shares that arithmetic; against
    # the shipped stack (kernel 3's sums and rsqrtf) an ulp in one layer's
    # norm flips int8 roundings that compound over the 12 random layers
    plain = PCS.stack_plain(*args)
    launched = {}
    for tool, variants in (("profile_chunk_split", PCS.VARIANTS),
                           ("profile_wavefront", PWF.VARIANTS)):
        for name, fn in variants.items():
            got, launches, ms = PCS.run_variant(fn, args, reps=5)
            want, against = (plain, "plain stack") if name == "split-xla" else (ref, "stream2")
            for g, wv, k in zip(got, want, "yhc"):
                _stat_close(g, wv, f"{tool} {name} {k} vs {against}")
            launched = _merge(launched, launches)
            if name in STACK_LAUNCHES:
                if set(launches) != STACK_LAUNCHES[name]:
                    raise AssertionError(f"chunk {tool} {name}: launched {launches}, not "
                                         f"{sorted(STACK_LAUNCHES[name])}")
                _bit_equal(got, ref, ("y", "h", "c"), f"chunk {tool} {name} vs stream2")
            held = "" if want is ref else " vs plain stack (max, mean, p99) " + " ".join(
                f"{k}=({v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g})" for k, v in PCS.diffs(got, plain).items())
            diff = PCS.diffs(got, ref)
            print(f"chunk {tool} {name}: S={S} P={P} L={args[2].shape[0]} ms_per_stack={ms:.3f} "
                  f"launches_per_stack={json.dumps(launches)} vs stream2 (max, mean, p99) "
                  + " ".join(f"{k}=({v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g})" for k, v in diff.items())
                  + f"{held} ({card})")
    # the templates of kernels 11, 13, 14, 15 and 22 serve no tool at these
    # widths: their counts are their own, never the new kernels'
    missing = [r["name"] for r in rows if not r["name"].endswith("_simt")
               and not launched.get(COUNT_KEY.get(r["name"], r["name"]))]
    templates = sorted(k for k, v in launched.items() if v and k.endswith("_simt"))
    if missing or templates:
        raise AssertionError(f"chunk: the tools never launched {missing}; they launched the "
                             f"templates {templates}")
    print(f"chunk: {time.perf_counter() - t0:.1f} s")
    return rows


def mm_bound(name: str, M: int, K: int, N: int):
    """Kernel 23's bound: x and w read once (bf16 x for bf16 and dynq, int8
    otherwise; bf16 or int8 w), dynq's [N] column scales, the 4-byte [M, N]
    output written once; 2MKN operations at the bf16 or int8 rate."""
    xb = 1 if name == "mm_i8" else 2
    wb = 2 if name == "mm_bf16" else 1
    n_bytes = M * K * xb + K * N * wb + 4 * M * N + (4 * N if name == "mm_i8_dynq" else 0)
    return bound_ms(n_bytes, {"bf16" if name == "mm_bf16" else "int8": 2 * M * K * N})


def profiled(fn, n: int, key, tries: int = 3) -> tuple:
    """`host_and_device_us` of `fn`'s kernels named `key` (or any of a tuple
    of names), asked again where the profiler reported no device time (its
    sessions, one after another, now and then return no events)."""
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    for _ in range(tries):
        host, dev = host_and_device_us(fn, n=n, keys=(key,) if isinstance(key, str) else key)
        if dev > 0:
            break
    return host, dev


def phase_matmul(card, reps: int = 20):
    """Kernel 23 through the ported tool (`profile_int8.main`: each body's
    plan at the tool's five shapes, each body against its plain version by
    `check_body` -- int8 equal, dynq within 2 f32 ulps, bf16 within K *
    2^-24 * (|x| @ |w|) of the float64 sum -- timed (median of `reps`
    CUDA-event launches, each queued behind a device sleep: `device_ms`)
    beside its library call); each body must have launched, and the
    `mma.sync` kernel it replaced (csrc/int8_mm.cu) never. Then at every
    shape csrc/mm_wgmma.cu and the `mma.sync` kernel (`*_sync`) on the same
    inputs: both held by `check_body`, the int8 forms equal bit for bit,
    timed in turns (new, sync, sync, new), each also by the profiler's
    device time and the host's time per call, and the new kernel's phase
    clock (`profile_int8.profile`). The JSON rows at 2048 x 512 x 4096
    (both kernels, plain version, library call, bound), the plain times and
    bounds of the other shapes, and each wrapper's ValueError on a shape its
    plan refuses. No engine path runs kernel 23: its rows keep 0 launches."""
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.tools import profile_int8 as PI8

    t0 = time.perf_counter()
    dev = torch.device(DEV)
    timer = lambda fn, n, warmup=3: PI8.device_ms(fn, n, dev, warmup)  # noqa: E731
    cuda_build.reset_counts()
    res = PI8.main(["--iters", str(reps)])
    missing = [b for b in PI8.BODIES if not cuda_build.COUNTS[b]]
    stray = [b for b in PI8.BODIES if cuda_build.COUNTS[f"{b}_sync"]]
    if missing or stray:
        raise AssertionError(f"matmul: the tool never launched {missing}; it launched the "
                             f"mma.sync kernel for {stray}")
    rows = []
    for M, K, N in PI8.SHAPES:
        ins = PI8.make_inputs(M, K, N, dev)
        shape = f"{M}x{K}x{N}"
        checked = {}
        for name in PI8.BODIES:
            args = PI8.body_args(name, ins)
            kf = lambda name=name, args=args: PI8.KERNEL[name](*args)  # noqa: E731
            sf = lambda name=name, args=args: PI8.SYNC[name](*args)  # noqa: E731
            pf = lambda name=name, args=args: PI8.PLAIN[name](*args)  # noqa: E731
            lib = PI8.LIBRARY.get(name)
            lf = () if lib is None else (lambda lib=lib: lib(ins),)  # noqa: E731
            new, old, want = kf(), sf(), pf()
            errs = [PI8.check_body(name, got, want, args) for got in (new, old)]
            what = f"matmul {name} {shape} csrc/mm_wgmma.cu against the mma.sync kernel"
            if name == "mm_bf16":
                print(f"{what}: max abs diff {float((new - old).abs().max()):.3g} (f32 sum orders)")
            else:
                _bit_equal([new], [old], ("out",), what)
            t = [timer(f, reps) for f in (kf, sf, sf, kf)]
            (h_new, d_new), (h_old, d_old) = (profiled(f, reps, key) for f, key in (
                (kf, "mm_wgmma_kernel"), (sf, "mm_kernel")))
            clock = PI8.profile(name, M, K, N, dev)
            print(f"matmul {name} {shape} in turns new / sync / sync / new: "
                  f"{' / '.join(f'{v:.4f}' for v in t)} ms; device {d_new:.1f} / {d_old:.1f} us a "
                  f"call, host {h_new:.1f} / {h_old:.1f} us a call; {clock['plan']}; clock: span "
                  f"{clock['span_us']:.1f} us, per block (median, max) " + ", ".join(
                      f"{k[:-3]} {v[0]:.1f} {v[1]:.1f}" for k, v in clock.items()
                      if isinstance(v, tuple)) + f" ({card})")
            bound = mm_bound(name, M, K, N)
            checked[name] = (kf, pf, errs[0], bound, shape, *lf)
            checked[f"{name}_sync"] = (sf, pf, errs[1], bound, shape, *lf)
        if (M, K, N) == (2048, 512, 4096):
            rows += time_rows(checked, card, reps, timer)
            continue
        for name, (kf, pf, err, (b_ms, b_by), shape, *_) in checked.items():
            if name.endswith("_sync"):
                continue
            r = res[shape][name]
            p_ms = timer(pf, 5, warmup=1)
            lib_s = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            print(f"matmul {name} {shape}: ms={r['ms']:.4f} ({r['rate']:.1f} "
                  f"{'TF/s' if name == 'mm_bf16' else 'TOP/s'}) library_ms={lib_s} "
                  f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err:.3g} ({card})")
    ragged = PI8.make_inputs(200, 512, 4096, dev)
    for name in PI8.BODIES:
        try:
            PI8.KERNEL[name](*PI8.body_args(name, ragged))
        except ValueError as e:
            print(f"matmul {name} refuses 200x512x4096: {e}")
        else:
            raise AssertionError(f"matmul {name}: took a ragged shape")
    print(f"matmul: {time.perf_counter() - t0:.1f} s")
    return rows


# layer weights of the TP kernels' checks: float (18, 20) and int8 (19, 21)
TP_FLOAT_KEYS = ("w_ih_t", "w_hh_t", "bias", "w_hr_t", "ff1_t", "ff1_b", "ff2_t")
TP_I8_KEYS = ("w_ih_t_q8", "w_ih_t_q8s", "w_hh_t_q8", "w_hh_t_q8s", "bias", "w_hr_t_q8",
              "ff1_t_q8", "ff1_t_q8s", "ff1_b", "ff2_t_q8")
GC_I8 = TP_I8_KEYS[:5]
MID_I8 = ("ff1_t_q8", "ff1_t_q8s", "ff1_b")


def _tp_shards(w: dict, keys, m: int) -> list:
    """Layer 0 of each of the m ranks' gate-shuffled weight slices, as
    `prepare_tp_weights` hands them to its rank."""
    from april_asr_tpu_torch.parallel import TPMesh, prepare_tp_weights

    sub = {k: w[k][:1] for k in keys}
    return [{k: v[0] for k, v in prepare_tp_weights(sub, TPMesh(None, r, m)).items()}
            for r in range(m)]


def _q8_sum(parts, wqs, ws):
    """Every shard's exact int32 product of its slice of the model-global
    row quantization, summed, then dequantized: `tp_q8_contract` over the
    m ranks, in one process."""
    from april_asr_tpu_torch.ops import lstm_tp_kernels as TK

    vq, s = TK.rowq8_global(torch.cat(parts, dim=1), None)
    acc, off = 0, 0
    for p, wq in zip(parts, wqs):
        acc = acc + (vq[:, off : off + p.shape[1]].double() @ wq.double()).to(torch.int32)
        off += p.shape[1]
    return acc.float() * (s * ws)


def tp_layer_summed(w, shards, x, h, c_shards, gate, q: bool):
    """Layer 0 through every shard's kernels (19 and 21 at int8, 18 and 20
    at float weights) with the partials summed in this process as the
    ranks' all-reduces sum them; `w` gives the replicated ff2_b, norm_eps
    and int8 column scales of w_hr and ff2. Returns (y, h', c')."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import lstm_tp_kernels as TK

    if q:
        hcs, c2s = zip(*(TK.lstm_gates_cell_i8(x, h, ck, *(wk[k] for k in GC_I8), gate)
                         for wk, ck in zip(shards, c_shards)))
        h_new = _q8_sum(hcs, [wk["w_hr_t_q8"] for wk in shards], w["w_hr_t_q8s"][0])
        y = x + h_new
        mids = [TK.ffn_mid_i8(y, *(wk[k] for k in MID_I8)) for wk in shards]
        ff = _q8_sum(mids, [wk["ff2_t_q8"] for wk in shards], w["ff2_t_q8s"][0])
    else:
        hps, c2s = zip(*(TK.lstm_gate_cell_proj(x, h, ck, *(wk[k] for k in TP_FLOAT_KEYS[:4]), gate)
                         for wk, ck in zip(shards, c_shards)))
        h_new = functools.reduce(torch.add, hps)
        y = x + h_new
        ffs = [TK.ffn_partial(y, *(wk[k] for k in TP_FLOAT_KEYS[4:])) for wk in shards]
        ff = functools.reduce(torch.add, ffs)
    yo = TM._basic_norm(y + (ff + w["ff2_b"][0].float()), w["norm_eps"][0], x.shape[1])
    return yo, (h_new if gate is None else torch.where(gate[:, None], h_new, h)), torch.cat(c2s, 1)


# kernels 18-21 (their count keys) beside the column-pass kernels they
# replaced, and the device kernels the profiler names for each
TP_PAIRS = (("tp_gcp_f32", "tp_gcp_simt_f32"), ("tp_gcp_bf16", "tp_gcp_simt_bf16"),
            ("tp_gc_i8", "tp_gc_i8_simt"), ("tp_ffn_f32", "tp_ffn_simt_f32"),
            ("tp_ffn_bf16", "tp_ffn_simt_bf16"), ("tp_ffn_mid_i8", "tp_ffn_mid_i8_simt"))
TP_DEVICE = {"tp_gcp_f32": ("tp_gcp_kernel",), "tp_gcp_bf16": ("tp_gcp_kernel",),
             "tp_gc_i8": ("tp_gc_i8_kernel",), "tp_ffn_f32": ("tp_ffn_kernel",),
             "tp_ffn_bf16": ("tp_ffn_kernel",), "tp_ffn_mid_i8": ("tp_mid_i8_kernel",),
             "simt": ("step_gates", "tp_cols")}
# the outputs of each kernel of TP_PAIRS, and whether it takes a gate
TP_OUTS = {"tp_gcp": (("hp", "c'"), True), "tp_gc_i8": (("hc", "c'"), True),
           "tp_ffn": (("out",), False), "tp_ffn_mid_i8": (("mid",), False)}


def tp_outs(name: str) -> tuple:
    return TP_OUTS.get(name) or next(v for k, v in TP_OUTS.items() if name.startswith(k + "_"))


def check_tp_kernels(models, S: int, seed: int, m: int = 2) -> dict:
    """Kernels 18-21 on rank 0's slices of layer 0's gate-shuffled weights
    at m shards (flagship, m = 2: d 512, Hs 512, Fs 1024), gated and
    ungated where the kernel takes a gate, against their plain versions
    (int8 to f32 ulps except isolated int8 rounding flips; f32 and bf16 at
    kernel 12's bounds); kernels 18 (f32, bf16), 19, 20 (f32, bf16) and 21
    by their route (csrc/lstm_tp_gates.cu, csrc/lstm_tp_ffn.cu, each call
    required to launch it) equal bit for bit to the column-pass kernels
    they replaced (`*_simt`), gated and ungated where the kernel takes a
    gate, which are held to the plain versions too; then every shard's pieces with their partials
    summed (`tp_layer_summed`) against the unsharded layer, kernel 7 at
    int8 and kernel 12 at f32: y, h and c within the JAX TP test's bounds
    (1e-5 int8, 2e-5 f32). Returns {name: (kernel call, plain call, max abs
    err, bound, shape)}; bounds from the JAX kernels' CostEstimates (bytes
    plus the bias, gate and scales they leave out; operations at the weight
    type's rate)."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_tp_kernels as TK

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    dims = models["int8"].runtime.dims
    d, H, Fn = dims.d_model, dims.hidden, dims.ffn
    Hs, Fs = H // m, Fn // m
    x = t(rng.normal(size=(S, d)).astype(np.float32))
    h0 = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c0 = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    cs = [c0[:, k * Hs : (k + 1) * Hs].contiguous() for k in range(m)]
    gate = t(rng.random(S) < 0.5)
    y_in = t(rng.normal(size=(S, d)).astype(np.float32))

    def held(name, prec, kf, pf, gated):
        err = 0.0
        for g in ((None, gate) if gated else (None,)):
            got, want = kf(g), pf(g)
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            for gv, wv in zip(got, want):
                what = f"{name}{' gated' if g is not None else ''}"
                if prec == "int8":
                    err = max(err, _ulp_close(gv, wv, what))
                    continue
                if not torch.isfinite(gv).all():
                    raise AssertionError(f"{what}: non-finite values")
                atol, rtol = (1e-4, 1e-4) if prec == "f32" else (5e-2, 1e-3)
                torch.testing.assert_close(gv, wv, atol=atol, rtol=rtol, msg=what)
                err = max(err, float((gv - wv).abs().max()))
        return err

    # (name, precision, kernel, plain, args, takes a gate, bytes, operations)
    table = []
    for prec in ("f32", "bf16"):
        w0 = _tp_shards(models[prec].runtime.weights, TP_FLOAT_KEYS, m)[0]
        wb, bb = w0["w_ih_t"].element_size(), w0["bias"].element_size()
        gcp = ((x, h0, cs[0]) + tuple(w0[k] for k in TP_FLOAT_KEYS[:4]), True,
               (2 * d * 4 * Hs + Hs * d) * wb + 4 * Hs * bb + S * (3 * d + 2 * Hs) * 4 + S * 4,
               2 * S * (2 * d * 4 * Hs + Hs * d))
        table += [
            (f"tp_gcp_{prec}", prec, TK.lstm_gate_cell_proj, TK.lstm_gate_cell_proj_plain) + gcp,
            (f"tp_gcp_simt_{prec}", prec, TK.lstm_gate_cell_proj_simt,
             TK.lstm_gate_cell_proj_plain) + gcp,
        ]
        ffn = ((y_in,) + tuple(w0[k] for k in TP_FLOAT_KEYS[4:]), False,
               2 * d * Fs * wb + Fs * w0["ff1_b"].element_size() + 2 * S * d * 4,
               2 * S * d * Fs * 2)
        table += [
            (f"tp_ffn_{prec}", prec, TK.ffn_partial, TK.ffn_partial_plain) + ffn,
            (f"tp_ffn_simt_{prec}", prec, TK.ffn_partial_simt, TK.ffn_partial_plain) + ffn,
        ]
    q0 = _tp_shards(models["int8"].runtime.weights, TP_I8_KEYS, m)[0]
    bb = q0["bias"].element_size()
    gc = ((x, h0, cs[0]) + tuple(q0[k] for k in GC_I8), True,
          2 * d * 4 * Hs + 2 * 4 * Hs * 4 + 4 * Hs * bb + S * (2 * d + 3 * Hs) * 4 + S * 4,
          2 * S * d * 4 * Hs * 2)
    table += [
        ("tp_gc_i8", "int8", TK.lstm_gates_cell_i8, TK.lstm_gates_cell_i8_plain) + gc,
        ("tp_gc_i8_simt", "int8", TK.lstm_gates_cell_i8_simt, TK.lstm_gates_cell_i8_plain) + gc,
    ]
    mid = ((y_in,) + tuple(q0[k] for k in MID_I8), False,
           d * Fs + Fs * 4 + Fs * q0["ff1_b"].element_size() + S * (d + Fs) * 4, 2 * S * d * Fs)
    table += [
        ("tp_ffn_mid_i8", "int8", TK.ffn_mid_i8, TK.ffn_mid_i8_plain) + mid,
        ("tp_ffn_mid_i8_simt", "int8", TK.ffn_mid_i8_simt, TK.ffn_mid_i8_plain) + mid,
    ]
    out = {}
    shape = f"x[{S},{d}] Hs={Hs} Fs={Fs} (m={m})"
    for name, prec, kfn, pfn, a, gated, n_bytes, ops in table:
        # timed ungated, as the flush calls them (kernel 7 and 12's rows too)
        kf = lambda g=None, kfn=kfn, a=a, gated=gated: kfn(*a, g) if gated else kfn(*a)  # noqa: E731
        pf = lambda g=None, pfn=pfn, a=a, gated=gated: pfn(*a, g) if gated else pfn(*a)  # noqa: E731
        out[name] = (kf, pf, held(name, prec, kf, pf, gated), bound_ms(n_bytes, {prec: ops}), shape)

    # kernels 18-21 by their route against the column-pass kernels, bit for bit
    for new, simt in TP_PAIRS:
        names, gated = tp_outs(new)
        for g in (None, gate) if gated else (None,):
            before = cuda_build.COUNTS[new]
            got = out[new][0](g)
            if cuda_build.COUNTS[new] != before + 1:
                raise AssertionError(f"{new} S={S} m={m}: the one-launch kernel did not launch")
            want = out[simt][0](g)
            _bit_equal(got if gated else (got,), want if gated else (want,), names,
                       f"{new} S={S} m={m}{' gated' if g is not None else ''}: the one-launch "
                       f"kernel against {simt}")

    # every shard's partials summed, against the unsharded layer
    for prec, keys, whole, tol in (("int8", TP_I8_KEYS, LK.lstm_layer_fused_i8, 1e-5),
                                   ("f32", TP_FLOAT_KEYS, LF.lstm_layer_fused, 2e-5)):
        w = models[prec].runtime.weights
        shards = _tp_shards(w, keys, m)
        lw = tuple(w[k][0] for k in (TM.STEP_I8_KEYS if prec == "int8" else TM.STEP_KEYS))
        diff = dict.fromkeys("yhc", 0.0)
        for g in (None, gate):
            got = tp_layer_summed(w, shards, x, h0, cs, g, prec == "int8")
            want = whole(x, h0, c0, *lw, g)
            torch.cuda.synchronize()
            for gv, wv, k in zip(got, want, "yhc"):
                torch.testing.assert_close(gv, wv, atol=tol, rtol=tol,
                                           msg=f"tp {prec} shard sum {k} vs the whole layer")
                diff[k] = max(diff[k], float((gv - wv).abs().max()))
        print(f"tp {prec}: {m} shards' partials summed hold kernel "
              f"{7 if prec == 'int8' else 12}'s layer at S={S} within {tol:g}, gated and "
              f"ungated (max abs diff y {diff['y']:.3g}, h {diff['h']:.3g}, c {diff['c']:.3g})")
    return out


def tp_times(checked: dict, card, d: int, Hs: int, Fs: int) -> None:
    """Kernels 18 (f32, bf16), 19, 20 (f32, bf16) and 21 beside the
    column-pass kernels they replaced, on `checked`'s inputs: each plan, the
    CUDA-event ms, the profiler's device us a call and the host's us a call
    (`host_us_turns`), beside the bound and, for kernels 18 and 20, the FFMA
    floor (their multiply-adds at the f32 rate)."""
    from april_asr_tpu_torch.ops import tp_plan as TP

    plan = {"tp_gcp": lambda: TP.device_gcp_plan(S_FLAG, d, Hs, 0),
            "tp_gc_i8": lambda: TP.device_gc_i8_plan(S_FLAG, d, Hs, 0),
            "tp_ffn": lambda: TP.device_ffn_plan(S_FLAG, d, Fs, 0),
            "tp_ffn_mid_i8": lambda: TP.device_mid_plan(S_FLAG, d, Fs, 0)}
    macs = {"tp_gcp": S_FLAG * (2 * d * 4 * Hs + Hs * d), "tp_ffn": 2 * S_FLAG * d * Fs}
    for new, simt in TP_PAIRS:
        kf, sf = checked[new][0], checked[simt][0]
        b_ms, b_by = checked[new][3]
        k_ms, s_ms = cuda_ms(kf, 20), cuda_ms(sf, 20)
        k_dev = profiled(kf, 5, TP_DEVICE[new])[1]
        s_dev = profiled(sf, 5, TP_DEVICE["simt"])[1]
        host = host_us_turns({"new": kf, "simt": sf})
        kind = new if new in plan else next(k for k in plan if new.startswith(k + "_"))
        floor = (f", FFMA floor {macs[kind] * 2 / PEAK_OPS['f32'] * 1e3:.4f} ms"
                 if kind in macs else "")
        print(f"kernel {new} S={S_FLAG}: one launch ms={k_ms:.4f} (device {k_dev:.2f} us a call, "
              f"host {host['new']:.2f} us a call), {simt} ms={s_ms:.4f} (device {s_dev:.2f} us, "
              f"host {host['simt']:.2f} us), bound_ms={b_ms:.4f} ({b_by}){floor}; {plan[kind]()} "
              f"({card})")


def no_simt_tp(what: str, counts: dict) -> None:
    """Kernels 18-21 ran on their one-launch route: the column-pass kernels
    they replaced launched no time in `counts`."""
    n = {k: counts.get(k, 0) for _, k in TP_PAIRS}
    if any(n.values()):
        raise AssertionError(f"{what}: the column-pass kernels launched {n}")


def tp_profile_lines(prof: dict, what: str, card, top: int = 10) -> dict:
    """One rank's profiled calls (testing.engine_run "profile"): per call the
    device ms, the busy share (device over wall) and the device ms of the
    `top` kernels by name (launches in brackets); returns {call: (device ms,
    wall ms)}."""
    out = {}
    for k, p in sorted(prof.items()):
        rows = sorted(((us, n, name) for name, (us, n) in p["kernels"].items()), reverse=True)
        busy = sum(us for us, _, _ in rows) / 1e3
        parts = "; ".join(f"{re.sub(r'^void ', '', name).split('(')[0][:48]} {us / 1e3:.3f} ({n})"
                          for us, n, name in rows[:top])
        out[k] = (busy, p["wall_ms"])
        print(f"{what} call {k}: device {busy:.3f} ms busy of {p['wall_ms']:.1f} ms wall "
              f"(share {busy / p['wall_ms']:.3f}); by kernel, ms (launches): {parts} ({card})")
    return out


def tp_engine(model, path: str, prec: str, card, ticks: int = 2) -> dict:
    """Two rank processes on this card (gloo, a file store), each a
    `BatchEngine(rt, 256, mesh=make_mesh(model_parallel=2))` on the model
    at `path` and `prec`, over `ticks` 1 s ticks of tone bursts and a flush
    (`testing.engine_run`), the second tick and the flush under
    torch.profiler. Fails unless both ranks exit, their event blobs are
    identical, each rank's step and flush launched exactly the
    PATH_KERNELS["tp " + prec] kernels, kernels 19 and 21 (int8) or 18 and
    20 (f32) P x L times a step and pulls x L a flush (and the column-pass
    kernels they replaced no time), and rank 0's events part from the
    single-card engine's, on the same model and audio, only at near-ties
    (testing.NEAR_TIE). That reference takes the same per-pull route
    (`encoder_chunk` None: kernel 7 or 12 per layer) with its decode on the
    plain versions, so that DecisionMargins records every decision's
    margin. Then the ranks again with kernels 18-21 on the column-pass
    kernels (`tp_kernels` "simt"), the same calls profiled: their blobs
    must equal the first run's. Prints rank 0's device-time breakdown of a
    step and the flush for both. Returns rank 0's launch counts over the
    first run."""
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.testing import RankGroup, check_parting, engine_run

    rt = model.runtime
    L = rt.dims.layers
    audio = np.stack(_tone_bufs(S_FLAG, CHUNK_1S, rt.sample_rate, n=ticks, seed=21))
    args = dict(path=path, precision="int8" if prec == "int8" else None, m=2, device=DEV,
                audio=audio, ticks=ticks)
    prof_calls = (1, ticks)  # a step after the first, and the flush
    t0 = time.perf_counter()
    ranks = RankGroup("april_asr_tpu_torch.testing:engine_run", dict(args, profile=prof_calls),
                      world=2, timeout=600).join()
    t_ranks = time.perf_counter() - t0
    for k, (a, b) in enumerate(zip(ranks[0]["blobs"], ranks[1]["blobs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"tp {prec}: the ranks' event blobs differ at call {k}")
    blank = rt.blank_id
    ref_rt = dataclasses.replace(
        rt, encoder_chunk=None,
        decoder_joiner_argmax=lambda w, ctx, nd, dout, e: JK.decoder_joiner_argmax_plain(
            ctx, nd, dout, e, w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"],
            w["join_b"], blank))
    ref = engine_run(dict(args, rt=ref_rt, m=1, margins=True))
    parted = {}
    for k in range(ticks + 1):
        check_parting(k, ref["events"][k], ranks[0]["events"][k], ref["cells"][k],
                      ref["recs"][k], ranks[0]["recs"][k], ref["dec"][k], ranks[0]["dec"][k], parted,
                      precision=prec)
    n_cb = sum(len(r) for r in ref["recs"][-1])
    if n_cb == 0:
        raise AssertionError(f"tp {prec}: no callbacks")
    layer_kernels = ("tp_gc_i8", "tp_ffn_mid_i8") if prec == "int8" else ("tp_gcp_f32", "tp_ffn_f32")
    for r, res in enumerate(ranks):
        if res["c_shape"] != (L, S_FLAG, rt.dims.hidden // 2):
            raise AssertionError(f"tp {prec} rank {r}: c is {res['c_shape']}")
        for k, cnt in enumerate(res["counts"]):
            half = "step" if k < ticks else "flush"
            require_launches(f"tp {prec} rank {r} {half} {k}", f"tp {prec}", half, cnt)
            no_simt_joiner(f"tp {prec} rank {r} {half} {k}", cnt)
            no_simt_tp(f"tp {prec} rank {r} {half} {k}", cnt)
            pulls = res["events"][k]["ops"].shape[1] - (half == "flush")
            for gc in layer_kernels:
                if cnt.get(gc) != pulls * L:
                    raise AssertionError(f"tp {prec} rank {r} {half} {k}: {gc} launched "
                                         f"{cnt.get(gc)} times, not {pulls} pulls x {L} layers")
    c0 = ranks[0]["counts"]
    print(f"tp engine {prec}: 2 ranks on one card (gloo through the host), S={S_FLAG} "
          f"chunk=1 s P={ranks[0]['events'][0]['ops'].shape[1]} L={L}, {ticks} ticks + flush, "
          f"ranks' run {t_ranks:.1f} s; rank tick_ms {[[round(x, 1) for x in r['ms'][:ticks]] for r in ranks]} "
          f"flush_ms {[round(r['ms'][-1], 1) for r in ranks]}; single-card per-pull reference "
          f"(plain decode) tick_ms {[round(x, 1) for x in ref['ms'][:ticks]]} flush_ms "
          f"{ref['ms'][-1]:.1f}; blobs identical on both ranks; {n_cb} callbacks; "
          f"{S_FLAG - len(parted)} of {S_FLAG} sessions identical to the reference, parted at "
          f"near-ties (step, cell, margin): {parted}; rank 0 step launches {json.dumps(c0[0])} "
          f"flush launches {json.dumps(c0[-1])} ({card})")
    new = tp_profile_lines(ranks[0]["profile"], f"tp engine {prec} rank 0 (kernels 18-21 one "
                           f"launch each)", card)
    simt = RankGroup("april_asr_tpu_torch.testing:engine_run",
                     dict(args, profile=prof_calls, tp_kernels="simt"), world=2,
                     timeout=600).join()
    for k, (a, b) in enumerate(zip(ranks[0]["blobs"], simt[0]["blobs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"tp {prec}: the column-pass kernels' blobs differ at call {k}")
    for r, res in enumerate(simt):
        for k, cnt in enumerate(res["counts"]):
            if any(cnt.get(n, 0) for n, _ in TP_PAIRS):
                raise AssertionError(f"tp {prec} simt rank {r} call {k}: a one-launch kernel "
                                     f"launched: {json.dumps(cnt)}")
    old = tp_profile_lines(simt[0]["profile"], f"tp engine {prec} rank 0 (kernels 18-21 on the "
                           f"column-pass kernels)", card)
    print(f"tp engine {prec}: blobs equal with the column-pass kernels; rank 0 device ms a step "
          f"{old[1][0]:.3f} -> {new[1][0]:.3f}, a flush {old[ticks][0]:.3f} -> "
          f"{new[ticks][0]:.3f} ({card})")
    return _merge(*c0)


def phase_tp(models, tmp: str, card, reps: int = 20):
    """Kernels 18-21 per shard at flagship widths (`check_tp_kernels`: m =
    2 at S=256, timed, each beside the column-pass kernel it replaced
    (`tp_times`); again at S=3, and at m = 4 (Hs 256, Fs 512) at S=256 and
    3), then the two-rank TP engine at int8 and at f32 (`tp_engine`) on a
    random model at the flagship's widths and TP_ENGINE's depth, written
    under `tmp`. Returns (JSON rows, {precision: rank 0's launch counts})."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

    t0 = time.perf_counter()
    checked = check_tp_kernels(models, S_FLAG, seed=13)
    rows = time_rows(checked, card, reps)
    dims = models["int8"].runtime.dims
    tp_times(checked, card, dims.d_model, dims.hidden // 2, dims.ffn // 2)
    for S, m, seed in ((3, 2, 14), (S_FLAG, 4, 15), (3, 4, 16)):
        more = check_tp_kernels(models, S, seed=seed, m=m)
        print(f"tp kernels at S={S}, m={m}: " + ", ".join(
            f"{n} max_abs_err={v[2]:.3g}" for n, v in more.items()))
    tp_dir = os.path.join(tmp, "tp")
    os.makedirs(tp_dir)
    path = flagship_april(tp_dir, dims=TransducerDims(**TP_ENGINE))
    counts = {prec: tp_engine(Model(path, precision="int8" if prec == "int8" else None,
                                    device=DEV), path, prec, card) for prec in ("int8", "f32")}
    print(f"tp: {time.perf_counter() - t0:.1f} s")
    return rows, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 2
    try:
        import april_asr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the april_asr_tpu_torch package is not importable: {e}", file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    torch.cuda.set_device(0)
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

    kernels, launches = [], {}

    def record(counts, path):
        # each kernel's launches come from the first path run that owns it,
        # its step and flush together
        for half in ("step", "flush"):
            for k in PATH_KERNELS[path][half]:
                launches.setdefault(PATH_ROW.get(path, {}).get(k, k), counts[k])

    t_start = time.perf_counter()
    last = [t_start]

    def phase_done(name):
        no_containment(f"phase {name}")
        now = time.perf_counter()
        print(f"phase {name}: {now - last[0]:.1f} s")
        last[0] = now

    with tempfile.TemporaryDirectory() as tmp:
        if "build" in phases:
            phase_build(card)
            phase_done("build")
        models, vocab_path = {}, None
        if {"kernels", "engine", "session", "tp"} & set(phases):
            t0 = time.perf_counter()
            path = flagship_april(tmp)
            models["int8"] = Model(path, precision="int8", device=DEV)
            models["bf16"] = Model(path, precision="bf16", device=DEV)
            models["f32"] = Model(path, device=DEV)  # no precision: f32 as loaded
            print(f"model: flagship random .april written and loaded at int8, bf16 and f32 "
                  f"in {time.perf_counter() - t0:.1f} s")
        if {"kernels", "vocab"} & set(phases):
            t0 = time.perf_counter()
            vocab_path = flagship_april(tmp, dims=TransducerDims(vocab=16383))
            models["vocab f32"] = Model(vocab_path, device=DEV)
            models["vocab bf16"] = Model(vocab_path, precision="bf16", device=DEV)
            print(f"model: flagship-width random .april with 16,383 tokens written and loaded at "
                  f"f32 and bf16 in {time.perf_counter() - t0:.1f} s")
        if "kernels" in phases:
            kernels = phase_kernels(models, card)
            phase_done("kernels")
        if "reference" in phases:
            for prec in ("int8", "bf16", "f32"):
                phase_reference(card, prec)
            phase_done("reference")
        if "engine" in phases:
            for prec in ("int8", "bf16", "f32"):
                record(phase_engine(models[prec], card, prec, ab=prec != "f32"), prec)
            phase_done("engine")
        if "session" in phases:
            record(phase_session(models["int8"], card, "int8"), "session int8")
            # Model(path) with no precision: the weights as loaded (f32)
            record(phase_session(models["f32"], card, "f32"), "session f32")
            session_async(models["int8"], card)
            session_async_rt(models["int8"], card)
            session_speaker(models["int8"], card, tmp)
            engine_containment(models["int8"], card)
            programs_keep_state(models, card)
            phase_done("session")
        if "onnx" in phases:
            phase_onnx(tmp, card)
            phase_done("onnx")
        if "vocab" in phases:
            narrow_dir = os.path.join(tmp, "narrow")
            os.makedirs(narrow_dir)
            narrow_path = flagship_april(narrow_dir, seed=6, dims=TransducerDims(
                d_model=128, hidden=128, ffn=128, joiner_dim=128, vocab=16383, layers=1,
                decoder_groups=32, conv_channels=(4, 8, 8)))
            counts = phase_vocab(models, vocab_path, narrow_path, card)
            record(counts, "vocab f32")
            record(counts, "vocab bf16")
            phase_done("vocab")
        if "widths" in phases:
            rows, counts = phase_widths(tmp, card)
            kernels += rows
            for p, c in counts.items():
                record(c, p)
            phase_done("widths")
        if "chunk" in phases:
            kernels += phase_chunk(card)
            phase_done("chunk")
        if "matmul" in phases:
            kernels += phase_matmul(card)
            phase_done("matmul")
        if "tp" in phases:
            rows, counts = phase_tp(models, tmp, card)
            kernels += rows
            for prec, c in counts.items():
                record(c, f"tp {prec}")
            phase_done("tp")
    for k in kernels:
        k["launches"] = launches.get(COUNT_KEY.get(k["name"], k["name"]), 0)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
