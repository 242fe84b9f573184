#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (april_asr_tpu_torch) on one GPU.

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the flagship serving shapes, checks the streaming engine
against the CPU (plain) engine on a small model at int8, bf16 and f32, drives a
flagship BatchEngine at int8, bf16 and f32 and a synchronous Session at int8
and at f32 (the weights as loaded), serves a flagship-width model with a
16,383-token vocabulary and a narrow one whose kernel 4 block does not fit,
serves models at the widths the port once refused (an int8 model wider than
kernels 2 and 7 hold, a float model at d = 68), runs the int8 chunk-layer
variants of the two profiling tools and the
matrix-unit tool's tensor-core products, then the tensor-parallel kernels
and a two-rank tensor-parallel engine, and prints the results.

    python3 chip_smoke.py                      # every phase (as the check runs it)
    python3 chip_smoke.py --phases build,kernels

Phases (each fails the run on error):
  build      nvcc for every csrc/*.cu, all started at once; then
             csrc/lstm_mma.cu, lstm_mma_float.cu and lstm_chunk_mma.cu again
             to cubins: kernels 2, 7, 12 and 10's registers and spills (none
             allowed), IMMA in 2 and 7's SASS, HMMA in kernels 12 and 10 at
             bf16, FFMA and no tensor-core instruction at f32
  kernels    each kernel against its plain version: timed at S=256, P=27,
             F=101, checked again at S=3, P=5 (ragged tiles); kernels 2 and
             7 also bit for bit against kernel 13 and the three-pass step
             they replaced (ungated and gated), with their launch plans,
             and kernel 14 and kernel 3 on 8- and 4-row tiles bit for bit
             against kernels 2 and 3 (the int8 routes of wide models);
             kernels 12 and 10 beside the three-pass step and the two-kernel
             chunk layer they replaced (the largest difference and both
             times); kernels 10 and 12 again at d 512 / H 2048 / F 4096 and
             at d 68 / H 260 / F 196 (bf16 weight rows 8-byte aligned); the
             int8 kernels on int8 weights, kernels 10 and 12 on f32 and on bf16
             weights, the chunk decode and kernels 8 and 9 on bf16 and on
             f32 decode weights, kernel 9 again at V=16,383, both conv-embed
             entries (16, 17) on bf16 weights beside the stacked embed they
             displace, kernel 6 on frames formed from the fbank buffers
  reference  a tiny random model: CUDA engine vs CPU engine, same streams,
             at int8 and bf16 (the step embeds through kernel 16) and at f32
             (the stacked embed); the flush runs kernels 7, 12 and 8
  engine     flagship random model, BatchEngine S=256, 1 s chunks, 10 ticks
             of tone bursts then flush, at int8, bf16 and f32; the step's
             and the flush's launch counts checked apart, timing and the
             profiler's busy share of a step and of a flush; at int8 and
             bf16 the step again on the stacked embed (kernel 16 off), in
             turns, with the device kernels that left the step
  session    one synchronous Session, 200 ms feeds over 3 s, then flush: at
             int8, and from Model(path) with no precision (f32 as loaded)
  vocab      a flagship-width model with 16,383 tokens, which kernel 4
             cannot hold: the CUDA engine vs the CPU engine at S=8 (f32),
             then BatchEngine S=256 at f32 and bf16, 3 ticks and a flush,
             decoding through kernel 9 alone; and a 1-layer d = J = 128
             model with 16,383 tokens, which the JAX gate passes but kernel
             4's block cannot hold: CUDA vs CPU at S=8 (f32) through kernel
             8, kernel 4 never launched
  widths     models the port once refused: a 2-layer int8 model at d 1024 /
             H 4096 / F 8192 (kernels 2 and 7 have no plan) serves S=256,
             the flagship engine's batch, 3 ticks and a flush, on kernel 14,
             the three-pass int8 step and kernel 3 on 4-row tiles (each held
             to its plain version at those widths, S=256, and timed); a float model at d 68 / H 260 / F 196 serves
             at f32 (CUDA vs CPU engine) and bf16; one at d 66 is refused
             when its engine is built
  chunk      the int8 chunk-layer variants at flagship widths, S=256, P=27:
             kernels 13, 14, 11 (one layer), 15 (a 6-layer wavefront slab)
             and 22 (the tile-interleaved core, on 4- and 2-session tiles)
             against their plain versions, gated, timed, and checked again
             at S=3, P=5; then every stack variant of the ported tools
             (profile_chunk_split: fused, split, stream, stream2, split-xla,
             interleave-ts4, interleave-ts2; profile_wavefront: slabs of 6,
             4 and 12) against the shipped stack (kernels 2 + 3), each new
             kernel launched by them
  matmul     kernel 23 (profile_int8's bf16, int8 and dynamic-int8 bodies on
             the tensor cores): the ported tool at its five shapes (each
             body checked against its plain version, timed beside cuBLAS),
             every body launched by it; then the three bodies at 2048 x 512
             x 4096 timed with their plain versions and bounds, the other
             shapes' plain times and bounds, and each wrapper's refusal of a
             ragged shape
  tp         tensor parallelism at m = 2: kernels 18-21 on one shard's
             gate-shuffled slices at flagship widths (d 512, Hs 512, Fs
             1024), 18 and 20 at f32 and bf16 weights, 19 and 21 on the int8
             weights, against their plain versions, timed at S=256 and
             checked again at S=3; both shards' partials summed against
             kernel 7 (int8) and 12 (f32); then two rank processes on this
             card (gloo, a file store) each serve BatchEngine(S=256,
             mesh=make_mesh(model_parallel=2)) at int8 and at f32, 3 ticks
             and a flush: identical blobs on both ranks, exactly the
             PATH_KERNELS["tp ..."] launches, and the events of the
             single-card per-pull engine up to near-ties

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

PHASES = ("build", "kernels", "reference", "engine", "session", "vocab", "widths", "chunk", "matmul",
          "tp")

# H100 SXM peaks (NVIDIA data sheet, dense): memory bytes/s and ops/s by type
HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

S_FLAG, CHUNK_1S = 256, 16000
DEV = "cuda"
# the widths phase's models (`TransducerDims` fields): an int8 model wider
# than kernels 2 and 7 hold, and float models at widths that are multiples
# of 4 but not of 8 (served) and at d 66 (refused)
WIDE = dict(d_model=1024, hidden=4096, ffn=8192, layers=2)
NARROW = dict(d_model=68, hidden=260, ffn=196, joiner_dim=128, vocab=64, layers=2,
              decoder_groups=4)


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


def _embed_close(got, want, what) -> tuple:
    """[P, S, d] embeddings with the same bf16 rounding points and f32 sums
    in another order. An ulp of a sum can flip the bf16 rounding of one of a
    window's ~9,000 rounded activations, which moves all d outputs of that
    window by 1e-4 to 1e-2, so the bound is per window: none beyond 2e-2
    (the JAX package's kernel test), a mean below 2e-4, and at least a
    quarter of the windows within 1e-5 everywhere (a wrong index or a missed
    edge correction moves every window; 58% are at S = 256, P = 27, and the
    ragged check has only 15). Returns (max abs err, a summary)."""
    d = (got.float() - want.float()).abs()
    mx, mean = float(d.max()), float(d.mean())
    clean = float((d.reshape(-1, d.shape[-1]).amax(dim=1) <= 1e-5).float().mean())
    stats = (f"{float((d > 1e-4).float().mean()):.4f} of elements beyond 1e-4, mean {mean:.3g}, "
             f"{clean:.3f} of windows within 1e-5")
    if mx > 2e-2 or mean > 2e-4 or clean < 0.25 or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: max {mx:.3g}, {stats}")
    return mx, stats


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


def flagship_april(tmp: str, seed: int = 0, dims=None) -> str:
    """A flagship-width random native .april (blank logit biased +2.0 as
    bench.py does), written with the port's save_april; returns its path."""
    from april_asr_tpu_torch.models.export import make_model_parameters, save_april
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
    from april_asr_tpu_torch.testing import default_tokens

    dims = dims or TransducerDims()
    p = init_transducer_params(seed, dims)
    p["join_b"][0] += 2.0
    path = os.path.join(tmp, f"flagship-v{dims.vocab}.april")
    save_april(path, dims, p, make_model_parameters(dims, default_tokens(dims.vocab)),
               name="flagship-random")
    return path


# The kernels each path launches (cuda_build.COUNTS keys), in the step and
# in the flush: the step embeds through kernel 16 at bf16 conv weights (int8
# and bf16), runs the chunk encoder and, where the JAX gate passes and kernel
# 4's block fits, kernel 4; the flush runs the one-step encoder (its stacked
# embed is plain) and the per-pull decode (kernel 8, or kernel 9 where its
# gate refuses).
PATH_KERNELS = {
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
    # kernel 3 on 4-row tiles, the three-pass int8 step
    "wide int8": {"step": ("fbank_i8", "conv_embed", "lstm_rec_stream_i8", "ffn_norm_i8_r4",
                           "chunk_decode"),
                  "flush": ("fbank_i8", "lstm_step_i8_simt", "dec_joiner")},
    # a float model at d 68 (not a 128-multiple: the decode goes pull by
    # pull through kernel 9, as the JAX gates route it)
    "narrow f32": {"step": ("fbank_bf16x3", "lstm_chunk_mma_f32", "joiner_argmax_f32"),
                   "flush": ("fbank_bf16x3", "lstm_step_f32", "joiner_argmax_f32")},
    "narrow bf16": {"step": ("fbank_bf16x3", "conv_embed", "lstm_chunk_mma_bf16", "joiner_argmax"),
                    "flush": ("fbank_bf16x3", "lstm_step_bf16", "joiner_argmax")},
    # the tensor-parallel engine (one rank's counts): the per-pull recurrent
    # step on kernels 19 and 21 (int8) or 18 and 20 (f32) and kernel 8, no
    # chunk kernel; the f32 step keeps the stacked embed
    "tp int8": {"step": ("fbank_i8", "conv_embed", "tp_gc_i8", "tp_ffn_mid_i8", "dec_joiner"),
                "flush": ("fbank_i8", "tp_gc_i8", "tp_ffn_mid_i8", "dec_joiner")},
    "tp f32": {"step": ("fbank_bf16x3", "tp_gcp_f32", "tp_ffn_f32", "dec_joiner_f32"),
               "flush": ("fbank_bf16x3", "tp_gcp_f32", "tp_ffn_f32", "dec_joiner_f32")},
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
    check_mma_sass()


# the persistent kernels, by source and the start of their mangled names:
# kernels 2 and 7 (csrc/lstm_mma.cu, int8 on IMMA), kernels 12
# (csrc/lstm_mma_float.cu) and 10 (csrc/lstm_chunk_mma.cu): `<float>` on
# FFMA, `<unsigned short>` bf16 on HMMA
MMA_SOURCES = (
    ("lstm_mma.cu", ("_Z19lstm_rec_mma_kernel", "_Z20lstm_step_mma_kernel"), 6),
    ("lstm_mma_float.cu", ("_Z26lstm_step_float_mma_kernel",), 2),
    ("lstm_chunk_mma.cu", ("_Z27lstm_chunk_float_mma_kernel",), 2),
)


def sass_rule(kernel: str, insns: list) -> str:
    """Why a persistent kernel's SASS is wrong ("" where it is right): the
    int8 kernels need IMMA; kernels 12 and 10 at bf16 HMMA, at f32 FFMA and
    no tensor-core instruction (no TF32)."""
    n = lambda op: sum(op in i for i in insns)  # noqa: E731
    if "float_mma" not in kernel:
        return "" if n("IMMA") else "no IMMA instruction"
    if "IfE" in kernel:
        return "" if n("FFMA") and not n("HMMA") and not n("IMMA") else "not FFMA alone"
    return "" if n("HMMA") else "no HMMA instruction"


def check_mma_sass():
    """csrc/lstm_mma.cu, lstm_mma_float.cu and lstm_chunk_mma.cu compiled
    again to cubins: each
    persistent kernel's registers, shared memory and spills (`-Xptxas -v`;
    a spill fails) and its SASS (`sass_rule`)."""
    from pathlib import Path

    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.tools import sass_diff

    for src, prefixes, count in MMA_SOURCES:
        with tempfile.TemporaryDirectory() as tmp:
            log, funcs = sass_diff.compile_sass(cuda_build.CSRC / src, Path(tmp))
        props = sass_diff.ptxas_properties(log)
        found = [k for k in funcs if k.startswith(prefixes)]
        if len(found) < count:
            raise AssertionError(f"{src}: expected {count} kernel instantiations, found {found}")
        for k in sorted(found):
            ops = {op: sum(op in i for i in funcs[k]) for op in ("IMMA", "HMMA", "FFMA")}
            prop = props.get(k, "no ptxas report")
            print(f"  sass {src} {k[:44]}: {prop}; {ops} of {len(funcs[k])} instructions")
            why = sass_rule(k, funcs[k])
            if re.search(r"[1-9]\d* bytes spill", prop):
                why = why or "spills"
            if why:
                raise AssertionError(f"{src} {k}: {why}")


def _check_decode(rt, S: int, P: int, rng, dev, t) -> tuple:
    """chunk_decode on `rt`'s decode weights (bf16 or f32): P pulls x 3
    rounds from an aged state, so every heuristic runs."""
    from april_asr_tpu_torch.config import DecodeConfig
    from april_asr_tpu_torch.decode.greedy import init_decode_state, vocab_tables_device
    from april_asr_tpu_torch.engine.step import INNER_STEPS_EMIT
    from april_asr_tpu_torch.ops import decode_kernels as DK

    w, dims = rt.weights, rt.dims
    d, J, V = dims.d_model, dims.joiner_dim, dims.vocab
    dcfg = DecodeConfig()
    T = dcfg.max_active_tokens
    st = init_decode_state(S, dims.context, J, rt.blank_id, dcfg, dev)
    st.update(
        head=t(rng.integers(0, T, size=S).astype(np.int32)),
        token_words=t((rng.integers(0, V, size=(S, T))
                       | (rng.integers(0, 4, size=(S, T)) << 16)).astype(np.int32)),
        time_ms=torch.full((S,), 4000, dtype=torch.int32, device=dev),
        last_emit_ms=t(rng.integers(0, 4000, size=S).astype(np.int32)),
        last_call=t(rng.integers(0, T, size=S).astype(np.int32)),
        context=t(rng.integers(0, V, size=(S, 2)).astype(np.int32)),
        need_dec=t(rng.random(S) < 0.5),
        emitted_silence=t(rng.random(S) < 0.5),
        dout=t(rng.normal(size=(S, J)).astype(np.float32)),
    )
    eouts = t((rng.normal(size=(P, S, J)) * 2.0).astype(np.float32))
    can = t(np.arange(P)[:, None] < rng.integers(0, P + 1, size=S)[None, :])
    dargs = (eouts, can, st, w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"],
             w["join_b"], vocab_tables_device(rt.vocab))
    dkw = dict(blank_id=rt.blank_id, stride_ms=rt.fbank_opts.segment_stride_ms,
               emit_ramp=INNER_STEPS_EMIT, dcfg=dcfg)
    kf = lambda: DK.chunk_decode(*dargs, **dkw)  # noqa: E731
    pf = lambda: DK.chunk_decode_plain(*dargs, **dkw)  # noqa: E731
    (gs, ge), (ws, we) = kf(), pf()
    torch.cuda.synchronize()
    for k in ("ops", "tok", "flags", "time_ms", "final_k"):
        if not torch.equal(ge[k], we[k]):
            raise AssertionError(f"chunk_decode events[{k}] differ from the plain version")
    for k in ("context", "token_words", "head", "last_call", "time_ms", "last_emit_ms",
              "need_dec", "emitted_silence"):
        if not torch.equal(gs[k], ws[k]):
            raise AssertionError(f"chunk_decode state[{k}] differs from the plain version")
    # dout: an f32 sum of the same products taken in another order (1e-5).
    # logprob with bf16 weights: the joiner rounds tanh(eout + dout) to bf16,
    # so an ulp of dout can flip that rounding and move one product term by
    # up to 2^-8 of |tanh| * |w| (~3e-4 here): 1e-3, the bound the CPU parity
    # test holds bf16 weights to. With f32 weights nothing is rounded to
    # bf16, so logprob is held to the f32 sum-order bound, 1e-5, as dout.
    f32 = w["join_t"].dtype == torch.float32
    lp_tol = 1e-5 if f32 else 1e-3
    torch.testing.assert_close(gs["dout"], ws["dout"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ge["logprob"], we["logprob"], atol=lp_tol, rtol=lp_tol)
    err = max(float((ge["logprob"] - we["logprob"]).abs().max()),
              float((gs["dout"] - ws["dout"]).abs().max()))
    n_ev = int((ge["ops"] != 0).sum())
    if n_ev < P * S // 4:
        raise AssertionError(f"chunk_decode: only {n_ev} events, heuristics not exercised")
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
    return kf, pf, err, b, f"eouts[{P},{S},{J}] V={V} events={n_ev} active_cells={n_act}"


def _check_joiner(rt, S: int, rng, dev, t, refresh: bool) -> tuple:
    """Kernel 8 (`refresh`: decoder refresh, then joiner and argmax) or
    kernel 9 (joiner and argmax) on `rt`'s decode weights at S sessions.
    max_idx must be equal wherever the plain version's top two non-blank
    logits differ by more than 1e-4; max_val, blank_val and dout' are held to
    atol 1e-4: f32 sums of the same products in another order differ by f32
    ulps of these unit-scale logits."""
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.ops.activations import dot_wd

    w, dims = rt.weights, rt.dims
    d, J, V, blank = dims.d_model, dims.joiner_dim, dims.vocab, rt.blank_id
    eout = t((rng.normal(size=(S, J)) * 2.0).astype(np.float32))
    dout = t(rng.normal(size=(S, J)).astype(np.float32))
    ctx = t(rng.integers(0, V, size=(S, 2)).astype(np.int32))
    nd = t(rng.random(S) < 0.5)
    dec = (w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"], w["join_b"])
    if refresh:
        kf = lambda: JK.decoder_joiner_argmax_fused(ctx, nd, dout, eout, *dec, blank_id=blank)  # noqa: E731
        pf = lambda: JK.decoder_joiner_argmax_plain(ctx, nd, dout, eout, *dec, blank)  # noqa: E731
    else:
        kf = lambda: JK.joiner_argmax_fused(eout, dout, w["join_t"], w["join_b"], blank_id=blank)  # noqa: E731
        pf = lambda: JK.joiner_argmax_plain(eout, dout, w["join_t"], w["join_b"], blank)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    f32 = w["join_t"].dtype == torch.float32
    name = ("dec_joiner" if refresh else "joiner_argmax") + ("_f32" if f32 else "")
    logits = dot_wd(torch.tanh(eout + (want[3] if refresh else dout)), w["join_t"]) + w["join_b"]
    logits[:, blank] = -float("inf")
    top2 = logits.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    if float(clear.float().mean()) < 0.9:
        raise AssertionError(f"{name}: only {int(clear.sum())} of {S} rows clear of a near-tie")
    if not torch.equal(got[0][clear], want[0][clear]):
        raise AssertionError(f"{name}: max_idx differs from the plain version")
    err = 0.0
    for i, what in ((1, "max_val"), (2, "blank_val"), (3, "dout'"))[: 3 if refresh else 2]:
        torch.testing.assert_close(got[i], want[i], atol=1e-4, rtol=0, msg=f"{name} {what}")
        err = max(err, float((got[i] - want[i]).abs().max()))
    wb = 4 if f32 else 2
    n_bytes = S * (2 * J * 4 + 12) + J * V * wb + V * 4
    ops = 2 * S * J * V
    if refresh:
        # the refresh reads only the table rows the contexts name
        rows = len(torch.unique(ctx[:, 0])) + len(torch.unique(ctx[:, 1]))
        n_bytes += S * (8 + 1 + J * 4) + rows * d * 4 + d * J * wb + J * 4
        ops += 2 * S * d * J
    b = bound_ms(n_bytes, {"f32" if f32 else "bf16": ops})
    return kf, pf, err, b, f"eout[{S},{J}] d={d} V={V}"


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

    # 1. fbank_i8 and 5. fbank_bf16x3: [S, L] hop-row buffers of PCM16
    # values -> [S, F, 80]. Both sum exact products in f32 in another order
    # than the plain version: the repo's fbank kernel bound, atol 2e-5,
    # rtol 1e-4 (tests/test_fbank_pallas.py:64-69)
    c = FK.fbank_constants(layout, dev)
    L = layout.buf_len
    pcm = (rng.normal(0, 0.25, (S, L)) * 32768).clip(-32768, 32767).astype(np.int16)
    buf = t(pcm.astype(np.float32) / 32768.0)
    # the function's DFT has one row per sample of the padded window; the
    # kernels' whole 160-row views add zero rows past it, not counted here
    K = layout.opts.padded_window_size
    N2, nb, nfft = 2 * c["nfft"], c["bins"], c["nfft"]
    mel_ops = 3 * 2 * S * F * nfft * nb
    for name, kf, pf, tab_bytes, ops in (
        ("fbank_i8", lambda: FK.logmel_rows_from_buf_i8(layout, buf),
         lambda: FK.logmel_rows_from_buf_i8_plain(c, buf, F), K * N2 * 3,
         {"int8": 2 * 2 * S * F * K * N2, "bf16": 2 * S * F * K * N2 + mel_ops}),
        ("fbank_bf16x3", lambda: FK.logmel_rows_from_buf(layout, buf),
         lambda: FK.logmel_rows_from_buf_plain(c, buf, F), K * N2 * 4,
         {"bf16": 3 * 2 * S * F * K * N2 + mel_ops}),
    ):
        got, want = kf(), pf()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
        b = bound_ms(S * L * 4 + S * F * nb * 4 + tab_bytes + nfft * nb * 4, ops)
        out[name] = (kf, pf, float((got - want).abs().max()), b, f"buf[{S},{L}] F={F}")

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
    # the tensor-core kernel 2 equals kernel 13 (the CUDA-core template it
    # replaced on the step) bit for bit: the same exact int32 dots and f32
    # op order
    _bit_equal(got, LK.lstm_layer_chunk_rec_i8(x, h0, c0, *la, n_pulls), ("hseq", "h", "c"),
               f"lstm_rec_stream2_i8 vs kernel 13 at S={S}, P={P}")
    # kernel 14, kernel 2's route where its stationary weights do not fit,
    # equals it bit for bit where both run
    _bit_equal(LK.lstm_layer_chunk_rec_stream_i8(x, h0, c0, *la, n_pulls), got,
               ("hseq", "h", "c"), f"kernel 14 (the wide route) vs lstm_rec_stream2_i8 at S={S}, "
               f"P={P}")
    b = bound_ms(2 * P * S * d * 4 + 2 * S * (d + H) * 4 + 2 * d * 4 * H + H * d + (8 * H + d) * 4,
                 {"int8": 2 * P * S * (2 * d * 4 * H + H * d)})
    out["lstm_rec_stream2_i8"] = (kf, pf, err, b, f"x[{P},{S},{d}] H={H}")

    # 3. ffn_norm_i8 over the flattened P*S rows (layer 0)
    R = P * S
    xr = x.reshape(R, d)
    hs = t(rng.normal(size=(R, d)).astype(np.float32))
    fa = (w["ff1_t_q8"][0], w["ff1_t_q8s"][0], w["ff1_b"][0],
          w["ff2_t_q8"][0], w["ff2_t_q8s"][0], w["ff2_b"][0], w["norm_eps"][0])
    kf = lambda: LK.ffn_norm_i8(xr, hs, *fa)  # noqa: E731
    pf = lambda: LK.ffn_norm_plain(xr, hs, *fa)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    # the 8- and 4-row tiles (the wide models' route) give the same bits
    for rows in (8, 4):
        _bit_equal([LK.ffn_norm_cuda(xr, hs, *fa, rows=rows)], [got], ("y",),
                   f"ffn_norm_i8 on {rows}-row tiles vs 16 at R={R}")
    b = bound_ms(3 * R * d * 4 + 2 * d * Fn + (2 * Fn + 2 * d) * 4, {"int8": 2 * R * d * Fn * 2})
    out["ffn_norm_i8"] = (kf, pf, _ulp_close(got, want, "ffn_norm_i8"), b, f"rows[{R},{d}] ffn={Fn}")

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

    # 4. chunk_decode on bf16 (int8 and bf16 serving) and f32 decode weights
    out["chunk_decode"] = _check_decode(rt, S, P, rng, dev, t)
    out["chunk_decode_f32"] = _check_decode(models["f32"].runtime, S, P, rng, dev, t)

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

    # 8. dec_joiner and 9. joiner_argmax on bf16 and f32 decode weights, and
    # kernel 9 on the 16,383-token model's bf16 and f32 weights
    for prec, sfx in (("bf16", ""), ("f32", "_f32")):
        out["dec_joiner" + sfx] = _check_joiner(models[prec].runtime, S, rng, dev, t, refresh=True)
        out["joiner_argmax" + sfx] = _check_joiner(models[prec].runtime, S, rng, dev, t, refresh=False)
        out[f"joiner_argmax{sfx}_v16383"] = _check_joiner(models["vocab " + prec].runtime, S, rng,
                                                          dev, t, refresh=False)

    # 16. conv_embed and 17. conv_embed_front: every window of the step from
    # the front buffer [S, W, mel] on bf16 weights (int8 and bf16 serving)
    # -> [P, S, d], against the stacked windows through conv_subsample
    out.update(check_conv_embed(models["bf16"].runtime, S, P, rng, t))

    # 6. fbank_frames: the DSP on frames formed from the hop-row buffers,
    # the DFT one f32 product; the fbank kernel bound, as kernels 1 and 5
    frames = FK.frames_from_buf(layout, buf)
    kf = lambda: FK.logmel_rows_fused(layout, frames)  # noqa: E731
    pf = lambda: FK.logmel_rows_fused_plain(c, frames)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    b = bound_ms(S * F * K * 4 + S * F * nb * 4 + K * N2 * 4 + nfft * nb * 4,
                 {"f32": 2 * S * F * K * N2, "bf16": mel_ops})
    out["fbank_frames"] = (kf, pf, float((got - want).abs().max()), b, f"frames[{S},{F},{K}]")
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


def check_conv_embed(rt, S: int, P: int, rng, t) -> dict:
    """Kernels 16 and 17 on `rt`'s bf16 weights, each held to `_embed_close`
    against the plain version. The bound counts each window's work as the
    function defines it (conv1 rows 0..6, conv2 rows 0..2, conv3, the
    projection) at the bf16 rate, and the front, output and weights once."""
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE

    w, dims = rt.weights, rt.dims
    seg, step, mel, d = dims.segment_size, dims.segment_step, dims.mel, dims.d_model
    c1, c2, c3 = dims.conv_channels
    f2 = (mel - 3) // 2 + 1
    f3 = (f2 - 3) // 2 + 1
    front = front_buffer(rt, S, P, rng, t)
    pf = lambda: CE.conv_embed_plain(w, front, P, step, seg)  # noqa: E731
    macs = 7 * mel * c1 * 9 + 3 * f2 * c2 * 9 * c1 + f3 * c3 * 9 * c2 + f3 * c3 * d
    n_bytes = front.numel() * 4 + P * S * d * 4 + c1 * 9 * 4 + (9 * c1 * c2 + 9 * c2 * c3
                                                                + f3 * c3 * d) * 2
    b = bound_ms(n_bytes, {"bf16": 2 * P * S * macs})
    out = {}
    for name, entry in (("conv_embed", CE.conv_embed_windows),
                        ("conv_embed_front", CE.conv_embed_from_front)):
        kf = lambda entry=entry: entry(w, front, P=P, step=step, seg=seg)  # noqa: E731
        got, want = kf(), pf()
        torch.cuda.synchronize()
        err, stats = _embed_close(got, want, name)
        out[name] = (kf, pf, err, b, f"front[{S},{front.shape[1]},{mel}] P={P}: {stats}")
    return out


SOURCES = {
    "fbank_i8": ("april_asr_tpu_torch/csrc/fbank_i8.cu", "april_asr_tpu/ops/fbank_pallas.py:457"),
    "lstm_rec_stream2_i8": ("april_asr_tpu_torch/csrc/lstm_mma.cu",
                            "april_asr_tpu/ops/lstm_pallas.py:1147"),
    "ffn_norm_i8": ("april_asr_tpu_torch/csrc/lstm_i8.cu", "april_asr_tpu/ops/lstm_pallas.py:1264"),
    "chunk_decode": ("april_asr_tpu_torch/csrc/chunk_decode.cu",
                     "april_asr_tpu/ops/decode_pallas.py:440"),
    "fbank_bf16x3": ("april_asr_tpu_torch/csrc/fbank_bf16x3.cu",
                     "april_asr_tpu/ops/fbank_pallas.py:280"),
    "lstm_chunk_mma_f32": ("april_asr_tpu_torch/csrc/lstm_chunk_mma.cu",
                           "april_asr_tpu/ops/lstm_pallas.py:237"),
    "lstm_chunk_mma_bf16": ("april_asr_tpu_torch/csrc/lstm_chunk_mma.cu",
                            "april_asr_tpu/ops/lstm_pallas.py:237"),
    "chunk_decode_f32": ("april_asr_tpu_torch/csrc/chunk_decode.cu",
                         "april_asr_tpu/ops/decode_pallas.py:440"),
    "lstm_step_i8": ("april_asr_tpu_torch/csrc/lstm_mma.cu", "april_asr_tpu/ops/lstm_pallas.py:426"),
    "lstm_step_i8_simt": ("april_asr_tpu_torch/csrc/lstm_step.cu",
                          "april_asr_tpu/ops/lstm_pallas.py:426"),
    "ffn_norm_i8_r4": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                       "april_asr_tpu/ops/lstm_pallas.py:1264"),
    "lstm_step_f32": ("april_asr_tpu_torch/csrc/lstm_mma_float.cu",
                      "april_asr_tpu/ops/lstm_pallas.py:1370"),
    "lstm_step_bf16": ("april_asr_tpu_torch/csrc/lstm_mma_float.cu",
                       "april_asr_tpu/ops/lstm_pallas.py:1370"),
    "dec_joiner": ("april_asr_tpu_torch/csrc/joiner.cu", "april_asr_tpu/ops/joiner_pallas.py:218"),
    "joiner_argmax": ("april_asr_tpu_torch/csrc/joiner.cu", "april_asr_tpu/ops/joiner_pallas.py:74"),
    "dec_joiner_f32": ("april_asr_tpu_torch/csrc/joiner.cu",
                       "april_asr_tpu/ops/joiner_pallas.py:218"),
    "joiner_argmax_f32": ("april_asr_tpu_torch/csrc/joiner.cu",
                          "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_v16383": ("april_asr_tpu_torch/csrc/joiner.cu",
                             "april_asr_tpu/ops/joiner_pallas.py:74"),
    "joiner_argmax_f32_v16383": ("april_asr_tpu_torch/csrc/joiner.cu",
                                 "april_asr_tpu/ops/joiner_pallas.py:74"),
    "conv_embed": ("april_asr_tpu_torch/csrc/conv_embed.cu",
                   "april_asr_tpu/ops/conv_embed_pallas.py:333"),
    "conv_embed_front": ("april_asr_tpu_torch/csrc/conv_embed.cu",
                         "april_asr_tpu/ops/conv_embed_pallas.py:438"),
    "fbank_frames": ("april_asr_tpu_torch/csrc/fbank_bf16x3.cu",
                     "april_asr_tpu/ops/fbank_pallas.py:163"),
    "lstm_rec_i8": ("april_asr_tpu_torch/csrc/lstm_i8.cu", "april_asr_tpu/ops/lstm_pallas.py:814"),
    "lstm_rec_stream_i8": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                           "april_asr_tpu/ops/lstm_pallas.py:973"),
    "lstm_rec_stream_i8_wide": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                                "april_asr_tpu/ops/lstm_pallas.py:973"),
    "lstm_chunk_i8": ("april_asr_tpu_torch/csrc/lstm_chunk_i8.cu",
                      "april_asr_tpu/ops/lstm_pallas.py:636"),
    "lstm_wavefront_i8": ("april_asr_tpu_torch/csrc/lstm_wavefront.cu",
                          "april_asr_tpu/ops/lstm_wavefront_pallas.py:223"),
    "rec_interleave_i8": ("april_asr_tpu_torch/csrc/lstm_i8.cu", "tools/profile_chunk_split.py:248"),
    "rec_interleave_i8_ts2": ("april_asr_tpu_torch/csrc/lstm_i8.cu",
                              "tools/profile_chunk_split.py:248"),
    "mm_bf16": ("april_asr_tpu_torch/csrc/int8_mm.cu", "tools/profile_int8.py:66"),
    "mm_i8": ("april_asr_tpu_torch/csrc/int8_mm.cu", "tools/profile_int8.py:66"),
    "mm_i8_dynq": ("april_asr_tpu_torch/csrc/int8_mm.cu", "tools/profile_int8.py:66"),
    "tp_gcp_f32": ("april_asr_tpu_torch/csrc/lstm_tp.cu", "april_asr_tpu/ops/lstm_tp_pallas.py:122"),
    "tp_gcp_bf16": ("april_asr_tpu_torch/csrc/lstm_tp.cu", "april_asr_tpu/ops/lstm_tp_pallas.py:122"),
    "tp_gc_i8": ("april_asr_tpu_torch/csrc/lstm_tp.cu", "april_asr_tpu/ops/lstm_tp_pallas.py:234"),
    "tp_ffn_f32": ("april_asr_tpu_torch/csrc/lstm_tp.cu", "april_asr_tpu/ops/lstm_tp_pallas.py:305"),
    "tp_ffn_bf16": ("april_asr_tpu_torch/csrc/lstm_tp.cu", "april_asr_tpu/ops/lstm_tp_pallas.py:305"),
    "tp_ffn_mid_i8": ("april_asr_tpu_torch/csrc/lstm_tp.cu",
                      "april_asr_tpu/ops/lstm_tp_pallas.py:363"),
}
# the launch counter of a row that times a kernel at a second shape or tile
COUNT_KEY = {"joiner_argmax_v16383": "joiner_argmax", "joiner_argmax_f32_v16383": "joiner_argmax_f32",
             "rec_interleave_i8_ts2": "rec_interleave_i8"}
# the row that takes a path's launches of a kernel whose own row (another
# shape, no serving path) keeps that kernel's count name
PATH_ROW = {"wide int8": {"lstm_rec_stream_i8": "lstm_rec_stream_i8_wide"}}


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
    # the embed kernel 16 displaces in the step: stacked windows + cuDNN
    rt = models["bf16"].runtime
    front = front_buffer(rt, S_FLAG, P, np.random.default_rng(3),
                        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV))
    s_ms = cuda_ms(lambda: stacked_embed(rt, front, P), 5, warmup=1)
    print(f"stacked embed (windows stack + encoder_embed, the step's embed before kernel 16; "
          f"bf16 weights): ms={s_ms:.4f} shape=front[{S_FLAG},{front.shape[1]},{rt.dims.mel}] "
          f"P={P} ({card})")
    ragged = check_kernels(models, 3, 5, seed=2)
    print("kernels at ragged shapes S=3 P=5: " + ", ".join(
        f"{n} max_abs_err={v[2]:.3g}" for n, v in ragged.items()))
    check_float_widths(S_FLAG, P, seed=5)
    print_mma_plans(models["int8"].runtime, S_FLAG, P)
    return rows


def print_mma_plans(rt, S: int, P: int):
    """Kernels 2, 7, 12 and 10's launch plans (ops/lstm_mma.py) at the
    engine's shapes on this card."""
    from april_asr_tpu_torch.ops import lstm_mma as LM

    d, H, F = rt.dims.d_model, rt.dims.hidden, rt.dims.ffn
    for what, plan in (("kernel 2", LM.device_plan(S, d, H, 0, torch.device(DEV))),
                       ("kernel 7", LM.device_plan(S, d, H, F, torch.device(DEV)))):
        print(f"{what} plan at S={S}: {plan.nb} blocks; gate items of {plan.ub} units x "
              f"{plan.gate.rows} rows ({plan.gate.items}); projection items (tiles, rows, column "
              f"groups, items) {plan.proj.ints()}; ff1 {plan.ff1.ints() if plan.ff1 else None}; "
              f"{plan.smem} bytes of shared memory a block")
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


def _lockstep(rt_dev, rt_cpu, S: int, chunk: int, ticks: int, seed: int, what: str, card):
    """The CUDA engine (kernels) and the CPU engine (plain versions) on the
    same weights and audio, in lockstep over `ticks` steps and a flush:
    fbank rows within the fbank kernels' bound, h/c within the repo's
    cross-implementation bound, and every session's events, callbacks and
    integer decode state equal up to the first decision the plain decode
    took by a near-tie (testing.NEAR_TIE): random weights are chaotic, and
    tanhf on the card and PyTorch's CPU tanh differ by ulps, which int8
    re-quantization can amplify."""
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
        )
    n = sum(len(r) for r in recs["cpu"])
    if n == 0:
        raise AssertionError(f"{what}: no callbacks")
    print(f"{what}: {S} sessions x {ticks} ticks + flush, {n} callbacks; "
          f"{S - len(parted)} sessions identical end to end, parted at near-ties "
          f"(step, cell, margin): {parted} ({card})")


def phase_reference(card, precision: str, ticks: int = 6):
    """A tiny model (3 layers, d 128), S=8, 200 ms chunks: `_lockstep` at
    `precision`. The steps run the chunk kernels and, at int8 and bf16,
    kernel 16 (checked), the flush kernels 7 or 12 and kernel 8. At f32
    nothing is re-quantized or rounded to bf16, so every session is expected
    identical end to end; at bf16 a session may part only at a near-tie."""
    from april_asr_tpu_torch.api.model import apply_precision
    from april_asr_tpu_torch.models.export import make_model_parameters
    from april_asr_tpu_torch.models.loader import native_runtime
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.testing import default_tokens

    dims = TransducerDims(d_model=128, hidden=128, ffn=256, joiner_dim=128, vocab=64,
                          layers=3, decoder_groups=32, conv_channels=(4, 8, 8))
    p = init_transducer_params(3, dims)
    p["join_b"][0] += 2.0
    mp = make_model_parameters(dims, default_tokens(dims.vocab))
    rts = [native_runtime("ref", "", "en-us", mp, dims,
                          apply_precision({k: v.to(dev) for k, v in p.items()}, precision), dev)
           for dev in (DEV, "cpu")]
    cuda_build.reset_counts()
    _lockstep(*rts, S=8, chunk=3200, ticks=ticks, seed=4, what=f"reference {precision}", card=card)
    if (cuda_build.COUNTS["conv_embed"] > 0) != (precision in ("int8", "bf16")):
        raise AssertionError(f"reference {precision}: kernel 16 launched "
                             f"{cuda_build.COUNTS['conv_embed']} times")


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
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.ops import cuda_build

    rt = model.runtime
    S, chunk = S_FLAG, CHUNK_1S
    bufs = _tone_bufs(S, chunk, rt.sample_rate)
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=chunk))
    n_cb = [0]

    def handler(r, toks):
        n_cb[0] += 1

    slots = [eng.alloc(handler) for _ in range(S)]
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    tick_ms = []
    for k in range(ticks):
        for s in slots:
            eng.feed(s, bufs[k % len(bufs)][s])
        t0 = time.perf_counter()
        eng.tick()
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
    st = eng.state
    for name, t in (("h", st["h"]), ("c", st["c"]), ("dout", st["decode"]["dout"]),
                    ("fifo", st["fbank"]["fifo"])):
        if not torch.isfinite(t).all():
            raise AssertionError(f"engine: non-finite {name}")
    if n_cb[0] == 0:
        raise AssertionError("engine: no callbacks")

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
    profile(run_flush, card, f"engine {path} flush", n=1)
    if ab:
        embed_ab(rt, run_step, prof_step, card, path)
    return _merge(step_counts, flush_counts)


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
    step_counts = require_launches(f"session {precision} feeds", precision, "step")
    cuda_build.reset_counts()
    t1 = time.perf_counter()
    sess.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t1
    P = sess._engine.prog.layout.max_pulls_per_step
    sess.close()
    flush_counts = require_launches(f"session {precision} flush", precision, "flush")
    if not got:
        raise AssertionError("session: no callbacks")
    kinds = {Result(r).name: sum(1 for x in got if x[0] == r) for r in {x[0] for x in got}}
    print(f"session {precision}: 3 s in 200 ms feeds + flush in {feed_s + flush_s:.2f} s "
          f"(feeds {feed_s:.2f} s, flush {flush_s:.2f} s), P={P}, callbacks={kinds}, "
          f"step_launches={json.dumps(step_counts)} flush_launches={json.dumps(flush_counts)} ({card})")
    return _merge(step_counts, flush_counts)


def vocab_narrow(path: str, card):
    """A 1-layer d = J = 128 model with 16,383 tokens: the JAX chunk-decode
    gate passes it, but kernel 4's block (16·(J + max(J, d) + V + T) bytes)
    exceeds the H100's 232,448, so the step decodes pull by pull through
    kernel 8, as the flush does. The CUDA engine against the CPU engine at
    S=8 (`_lockstep`, f32 as loaded); kernel 4 must never launch."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.config import DecodeConfig
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import decode_kernels as DK

    rt = Model(path, device=DEV).runtime
    d, J, V = rt.dims.d_model, rt.dims.joiner_dim, rt.dims.vocab
    T = DecodeConfig().max_active_tokens
    if not DK.chunk_decode_supported(8, J, d, rt.dims.context, V) or DK.chunk_decode_block_fits(J, d, V, T):
        raise AssertionError(f"vocab narrow: expected the JAX gate to pass and kernel 4's block "
                             f"({DK.chunk_decode_smem(J, d, V, T)} bytes) not to fit")
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    _lockstep(rt, Model(path, device="cpu").runtime, S=8, chunk=CHUNK_1S, ticks=3, seed=7,
              what="vocab narrow f32 lockstep", card=card)
    c = cuda_build.COUNTS
    if c["chunk_decode"] or c["chunk_decode_f32"] or not c["dec_joiner_f32"]:
        raise AssertionError(f"vocab narrow: kernel 4 launched {c['chunk_decode_f32']} times, "
                             f"kernel 8 {c['dec_joiner_f32']} times")
    print(f"vocab narrow: d=J={d} V={V}, kernel 4 block {DK.chunk_decode_smem(J, d, V, T)} bytes; "
          f"lockstep in {time.perf_counter() - t0:.1f} s, kernel 4 launched 0 times, kernel 8 "
          f"{c['dec_joiner_f32']} times, kernel 9 {c['joiner_argmax_f32']} times ({card})")


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
    _lockstep(rt, Model(path, device="cpu").runtime, S=8, chunk=CHUNK_1S, ticks=3, seed=5,
              what="vocab f32 lockstep", card=card)
    print(f"vocab: lockstep in {time.perf_counter() - t0:.1f} s")
    counts = _merge(phase_engine(models["vocab f32"], card, "vocab f32", ticks=3),
                    phase_engine(models["vocab bf16"], card, "vocab bf16", ticks=3))
    vocab_narrow(narrow_path, card)
    return counts


def serve_once(model, path: str, S: int, ticks: int, card) -> dict:
    """BatchEngine(S) on `model`, 1 s chunks: `ticks` ticks of tone bursts
    and a flush of every slot, the step's and the flush's launches checked
    apart (PATH_KERNELS[path]), the state finite, callbacks seen; returns
    the launch counts of the steps and the flush."""
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
    dims = rt.dims
    print(f"widths {path}: d={dims.d_model} H={dims.hidden} F={dims.ffn} L={dims.layers} S={S}: "
          f"{ticks} ticks in {t1 - t0:.2f} s, flush {t2 - t1:.2f} s, {n_cb[0]} callbacks, "
          f"step_launches={json.dumps(step_counts)} flush_launches={json.dumps(flush_counts)} "
          f"({card})")
    return _merge(step_counts, flush_counts)


def check_wide_int8(rt, S: int, P: int, seed: int) -> dict:
    """The int8 routes at a model's widths (layer 0): kernel 2's call (kernel
    14 where kernel 2 has no plan), kernel 7's call (the three-pass step,
    ungated and gated) and kernel 3 (its row tile by width) against their
    plain versions, to `_ulp_close`. Returns the JSON checks of the three
    routed calls."""
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
    R = P * S
    xr, hs = x.reshape(R, d), t(rng.normal(size=(R, d)).astype(np.float32))
    fa = sa[7:]
    got = LK.ffn_norm_i8(xr, hs, *fa)
    torch.cuda.synchronize()
    err3 = _ulp_close(got, LK.ffn_norm_plain(xr, hs, *fa), "wide kernel 3")
    b = bound_ms(3 * R * d * 4 + 2 * d * Fn + (2 * Fn + 2 * d) * 4, {"int8": 2 * R * d * Fn * 2})
    out["ffn_norm_i8" if routes.ffn_rows == 16 else f"ffn_norm_i8_r{routes.ffn_rows}"] = (
        lambda: LK.ffn_norm_i8(xr, hs, *fa), lambda: LK.ffn_norm_plain(xr, hs, *fa), err3, b,
        f"rows[{R},{d}] ffn={Fn} ({routes.ffn_rows}-row tiles)")
    print(f"widths wide int8 routes at S={S}, P={P}: {routes}; kernel 14 max_abs_err {err14:.3g}, "
          f"the three-pass step {err:.3g}, kernel 3 {err3:.3g}")
    return out


def phase_widths(tmp: str, card, reps: int = 10):
    """Models the port once refused. A 2-layer int8 model at d 1024 / H
    4096 / F 8192, wider than kernels 2 and 7 hold: its routed kernels
    against their plain versions at S=256, the flagship engine's batch
    (`check_wide_int8`, timed), then BatchEngine S=256 for 3 ticks and a
    flush on those routes (`serve_once`).
    A 2-layer float model at d 68 / H 260 / F 196: the CUDA engine against
    the CPU engine at f32 (`_lockstep`), then `serve_once` at f32 and bf16.
    A model at d 66 is refused when its engine is built. Returns (JSON rows,
    {path: launch counts})."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.engine.batch import BatchEngine
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

    t0 = time.perf_counter()
    counts = {}
    wide_dir = os.path.join(tmp, "wide")
    os.makedirs(wide_dir)
    wide = Model(flagship_april(wide_dir, seed=9, dims=TransducerDims(**WIDE)), precision="int8",
                 device=DEV)
    print(f"widths: wide int8 model written and loaded in {time.perf_counter() - t0:.1f} s")
    rows = time_rows(check_wide_int8(wide.runtime, S_FLAG, 27, seed=15), card, reps)
    counts["wide int8"] = serve_once(wide, "wide int8", S_FLAG, 3, card)
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
    odd_dir = os.path.join(tmp, "narrow66")
    os.makedirs(odd_dir)
    odd = Model(flagship_april(odd_dir, seed=11, dims=dataclasses.replace(
        narrow, d_model=66, decoder_groups=2)), device=DEV)
    try:
        BatchEngine(odd.runtime, batch=8)
    except ValueError as e:
        if "d_model=66" not in str(e):
            raise
        print(f"widths: d=66 refused when its engine is built: {e}")
    else:
        raise AssertionError("widths: an engine at d=66 was built")
    print(f"widths: {time.perf_counter() - t0:.1f} s")
    return rows, counts


def check_chunk_kernels(params, S: int, P: int, seed: int, Lk: int = 6) -> dict:
    """Kernels 13, 14 and 22 (on 4- and 2-session tiles; layer 0's
    recurrent core), 11 (layer 0 whole) and 15 (a slab of layers 0..Lk-1) on
    the int8 serving weights `params`, at S sessions and P pulls, gated by
    random n_pulls, against their plain versions: one layer to `_ulp_close`,
    the slab to `_stat_close`. Returns {name: (kernel call, plain call, max
    abs err, bound, shape)}."""
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_wavefront_kernels as LW
    from april_asr_tpu_torch.tools.profile_chunk_split import INTERLEAVE_TS, rec_interleave_i8

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
    # kernel 22 (on 4- and 2-session tiles) computes kernel 13's function and
    # shares its bound: the h/c carry between its launches is a cost of that
    # design, not bytes the function must move
    cores = (("lstm_rec_i8", LK.lstm_layer_chunk_rec_i8, ""),
             ("lstm_rec_stream_i8", LK.lstm_layer_chunk_rec_stream_i8, ""),
             ("rec_interleave_i8", functools.partial(rec_interleave_i8, block_s=512),
              f" tile={INTERLEAVE_TS[512]}"),
             ("rec_interleave_i8_ts2", functools.partial(rec_interleave_i8, block_s=256),
              f" tile={INTERLEAVE_TS[256]}"))
    for name, fn, tile in cores:
        kf = lambda fn=fn: fn(x, hs[0], cs[0], *layer[:7], n_pulls)  # noqa: E731
        pf = lambda: LK.lstm_rec_plain(x, hs[0], cs[0], n_pulls, *layer[:7])  # noqa: E731
        got, want = kf(), pf()
        torch.cuda.synchronize()
        err = max(_ulp_close(g, wv, f"{name} {k}") for g, wv, k in zip(got, want, ("hseq", "h", "c")))
        out[name] = (kf, pf, err, bound_ms(io + rec_w, {"int8": rec_ops}), shape + tile)
    kf = lambda: LK.lstm_layer_chunk_fused_i8(x, hs[0], cs[0], *layer, n_pulls)  # noqa: E731
    pf = lambda: LK.lstm_chunk_i8_plain(x, hs[0], cs[0], *layer, n_pulls)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    err = max(_ulp_close(g, wv, f"lstm_chunk_i8 {k}") for g, wv, k in zip(got, want, "yhc"))
    out["lstm_chunk_i8"] = (kf, pf, err, bound_ms(io + rec_w + ffn_w, {"int8": rec_ops + ffn_ops}),
                            f"{shape} ffn={Fn}")
    kf = lambda: LW.lstm_slab_wavefront_i8(x, hs, cs, *slab, n_pulls)  # noqa: E731
    pf = lambda: LW.lstm_slab_wavefront_plain(x, hs, cs, *slab, n_pulls=n_pulls)  # noqa: E731
    got, want = kf(), pf()
    torch.cuda.synchronize()
    for g, wv, k in zip(got, want, "yhc"):
        if not torch.isfinite(g).all():
            raise AssertionError(f"lstm_wavefront_i8 {k}: non-finite values")
        _stat_close(g, wv, f"lstm_wavefront_i8 {k}")
    err = max(float((g - wv).abs().max()) for g, wv in zip(got, want))
    b = bound_ms(2 * P * S * d * 4 + Lk * (2 * S * (d + H) * 4 + rec_w + ffn_w) + S * 4,
                 {"int8": Lk * (rec_ops + ffn_ops)})
    out["lstm_wavefront_i8"] = (kf, pf, err, b, f"{shape} ffn={Fn} slab={Lk}")
    return out


def phase_chunk(card, reps: int = 20):
    """The int8 chunk-layer variants at flagship widths, S=256, P=27: each
    new kernel against its plain version (`check_chunk_kernels`), timed, and
    checked again at S=3, P=5; then every stack variant of the ported tools
    on the tools' own inputs, held to `_stat_close` against the shipped
    stack (kernel 2 + 3; split-xla, whose FFN is plain tensor code, against
    the plain stack), with its time and launches per stack. No engine
    path runs these kernels: their JSON rows keep 0 launches."""
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
            held = "" if want is ref else " vs plain stack (max, mean, p99) " + " ".join(
                f"{k}=({v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g})" for k, v in PCS.diffs(got, plain).items())
            diff = PCS.diffs(got, ref)
            print(f"chunk {tool} {name}: S={S} P={P} L={args[2].shape[0]} ms_per_stack={ms:.3f} "
                  f"launches_per_stack={json.dumps(launches)} vs stream2 (max, mean, p99) "
                  + " ".join(f"{k}=({v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g})" for k, v in diff.items())
                  + f"{held} ({card})")
    missing = [r["name"] for r in rows if not launched.get(COUNT_KEY.get(r["name"], r["name"]))]
    if missing:
        raise AssertionError(f"chunk: the tools never launched {missing}")
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


def phase_matmul(card, reps: int = 20):
    """Kernel 23 through the ported tool (`profile_int8.main`): every body at
    the tool's five shapes against its plain version (`check_body`: int8
    equal, dynq within 2 f32 ulps, bf16 within K * 2^-24 * (|x| @ |w|) of
    the float64 sum), timed (median of `reps` CUDA-event launches, each
    queued behind a device sleep: `device_ms`) beside its library call; each
    body must have launched. Then the JSON rows at 2048 x 512 x 4096
    (kernel, plain version, library call, bound), the plain times and
    bounds of the other shapes, and each wrapper's ValueError on a shape its
    tiles do not divide. No engine path runs kernel 23: its rows keep 0
    launches."""
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.tools import profile_int8 as PI8

    t0 = time.perf_counter()
    dev = torch.device(DEV)
    timer = lambda fn, n, warmup=3: PI8.device_ms(fn, n, dev, warmup)  # noqa: E731
    cuda_build.reset_counts()
    res = PI8.main(["--iters", str(reps)])
    missing = [b for b in PI8.BODIES if not cuda_build.COUNTS[b]]
    if missing:
        raise AssertionError(f"matmul: the tool never launched {missing}")
    rows = []
    for M, K, N in PI8.SHAPES:
        ins = PI8.make_inputs(M, K, N, dev)
        shape = f"{M}x{K}x{N}"
        checked = {}
        for name in PI8.BODIES:
            args = PI8.body_args(name, ins)
            kf = lambda name=name, args=args: PI8.KERNEL[name](*args)  # noqa: E731
            pf = lambda name=name, args=args: PI8.PLAIN[name](*args)  # noqa: E731
            lib = PI8.LIBRARY.get(name)
            lf = () if lib is None else (lambda lib=lib: lib(ins),)  # noqa: E731
            checked[name] = (kf, pf, res[shape][name]["max_diff"], mm_bound(name, M, K, N), shape,
                             *lf)
        if (M, K, N) == (2048, 512, 4096):
            rows += time_rows(checked, card, reps, timer)
            continue
        for name, (kf, pf, err, (b_ms, b_by), shape, *_) in checked.items():
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
        h_new = hps[0] + hps[1]
        y = x + h_new
        ffs = [TK.ffn_partial(y, *(wk[k] for k in TP_FLOAT_KEYS[4:])) for wk in shards]
        ff = ffs[0] + ffs[1]
    yo = TM._basic_norm(y + (ff + w["ff2_b"][0].float()), w["norm_eps"][0])
    return yo, (h_new if gate is None else torch.where(gate[:, None], h_new, h)), torch.cat(c2s, 1)


def check_tp_kernels(models, S: int, seed: int, m: int = 2) -> dict:
    """Kernels 18-21 on rank 0's slices (m = 2) of layer 0's gate-shuffled
    weights (flagship: d 512, Hs 512, Fs 1024), gated and ungated where the
    kernel takes a gate, against their plain versions (int8 to f32 ulps
    except isolated int8 rounding flips; f32 and bf16 at kernel 12's
    bounds); then both shards' pieces with their partials summed
    (`tp_layer_summed`) against the unsharded layer, kernel 7 at int8 and
    kernel 12 at f32: y, h and c within the JAX TP test's bounds (1e-5 int8,
    2e-5 f32). Returns {name: (kernel call, plain call, max abs err, bound,
    shape)}; bounds from the JAX kernels' CostEstimates (bytes plus the
    bias, gate and scales they leave out; operations at the weight type's
    rate)."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
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
        table += [
            (f"tp_gcp_{prec}", prec, TK.lstm_gate_cell_proj, TK.lstm_gate_cell_proj_plain,
             (x, h0, cs[0]) + tuple(w0[k] for k in TP_FLOAT_KEYS[:4]), True,
             (2 * d * 4 * Hs + Hs * d) * wb + 4 * Hs * bb + S * (3 * d + 2 * Hs) * 4 + S * 4,
             2 * S * (2 * d * 4 * Hs + Hs * d)),
            (f"tp_ffn_{prec}", prec, TK.ffn_partial, TK.ffn_partial_plain,
             (y_in,) + tuple(w0[k] for k in TP_FLOAT_KEYS[4:]), False,
             2 * d * Fs * wb + Fs * w0["ff1_b"].element_size() + 2 * S * d * 4, 2 * S * d * Fs * 2),
        ]
    q0 = _tp_shards(models["int8"].runtime.weights, TP_I8_KEYS, m)[0]
    bb = q0["bias"].element_size()
    table += [
        ("tp_gc_i8", "int8", TK.lstm_gates_cell_i8, TK.lstm_gates_cell_i8_plain,
         (x, h0, cs[0]) + tuple(q0[k] for k in GC_I8), True,
         2 * d * 4 * Hs + 2 * 4 * Hs * 4 + 4 * Hs * bb + S * (2 * d + 3 * Hs) * 4 + S * 4,
         2 * S * d * 4 * Hs * 2),
        ("tp_ffn_mid_i8", "int8", TK.ffn_mid_i8, TK.ffn_mid_i8_plain,
         (y_in,) + tuple(q0[k] for k in MID_I8), False,
         d * Fs + Fs * 4 + Fs * q0["ff1_b"].element_size() + S * (d + Fs) * 4, 2 * S * d * Fs),
    ]
    out = {}
    shape = f"x[{S},{d}] Hs={Hs} Fs={Fs} (m={m})"
    for name, prec, kfn, pfn, a, gated, n_bytes, ops in table:
        # timed ungated, as the flush calls them (kernel 7 and 12's rows too)
        kf = lambda g=None, kfn=kfn, a=a, gated=gated: kfn(*a, g) if gated else kfn(*a)  # noqa: E731
        pf = lambda g=None, pfn=pfn, a=a, gated=gated: pfn(*a, g) if gated else pfn(*a)  # noqa: E731
        out[name] = (kf, pf, held(name, prec, kf, pf, gated), bound_ms(n_bytes, {prec: ops}), shape)

    # the shards' partials summed, against the unsharded layer
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


def tp_engine(model, path: str, prec: str, card, ticks: int = 3) -> dict:
    """Two rank processes on this card (gloo, a file store), each a
    `BatchEngine(rt, 256, mesh=make_mesh(model_parallel=2))` on the model
    at `path` and `prec`, over `ticks` 1 s ticks of tone bursts and a flush
    (`testing.engine_run`). Fails unless both ranks exit, their event blobs
    are identical, each rank's step and flush launched exactly the
    PATH_KERNELS["tp " + prec] kernels, kernel 19 (int8) or 18 (f32)
    P x L times a step and pulls x L a flush, and rank 0's events part from
    the single-card engine's, on the same model and audio, only at near-ties
    (testing.NEAR_TIE). That reference takes the same per-pull route
    (`encoder_chunk` None: kernel 7 or 12 per layer) with its decode on the
    plain versions, so that DecisionMargins records every decision's
    margin. Returns rank 0's launch counts over the run."""
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.testing import RankGroup, check_parting, engine_run

    rt = model.runtime
    L = rt.dims.layers
    audio = np.stack(_tone_bufs(S_FLAG, CHUNK_1S, rt.sample_rate, n=ticks, seed=21))
    args = dict(path=path, precision="int8" if prec == "int8" else None, m=2, device=DEV,
                audio=audio, ticks=ticks)
    t0 = time.perf_counter()
    ranks = RankGroup("april_asr_tpu_torch.testing:engine_run", args, world=2, timeout=600).join()
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
                      ref["recs"][k], ranks[0]["recs"][k], ref["dec"][k], ranks[0]["dec"][k], parted)
    n_cb = sum(len(r) for r in ref["recs"][-1])
    if n_cb == 0:
        raise AssertionError(f"tp {prec}: no callbacks")
    gc = "tp_gc_i8" if prec == "int8" else "tp_gcp_f32"
    for r, res in enumerate(ranks):
        if res["c_shape"] != (L, S_FLAG, rt.dims.hidden // 2):
            raise AssertionError(f"tp {prec} rank {r}: c is {res['c_shape']}")
        for k, cnt in enumerate(res["counts"]):
            half = "step" if k < ticks else "flush"
            require_launches(f"tp {prec} rank {r} {half} {k}", f"tp {prec}", half, cnt)
            pulls = res["events"][k]["ops"].shape[1] - (half == "flush")
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
    return _merge(*c0)


def phase_tp(models, path: str, card, reps: int = 20):
    """Kernels 18-21 per shard at flagship widths, m = 2 (`check_tp_kernels`
    at S=256, timed, and again at S=3), then the two-rank TP engine at int8
    and at f32 (`tp_engine`). Returns (JSON rows, {precision: rank 0's
    launch counts})."""
    t0 = time.perf_counter()
    rows = time_rows(check_tp_kernels(models, S_FLAG, seed=13), card, reps)
    ragged = check_tp_kernels(models, 3, seed=14)
    print("tp kernels at ragged shapes S=3: " + ", ".join(
        f"{n} max_abs_err={v[2]:.3g}" for n, v in ragged.items()))
    counts = {prec: tp_engine(models[prec], path, prec, card) for prec in ("int8", "f32")}
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
    with tempfile.TemporaryDirectory() as tmp:
        if "build" in phases:
            phase_build(card)
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
        if "reference" in phases:
            for prec in ("int8", "bf16", "f32"):
                phase_reference(card, prec)
        if "engine" in phases:
            for prec in ("int8", "bf16", "f32"):
                record(phase_engine(models[prec], card, prec, ab=prec != "f32"), prec)
        if "session" in phases:
            record(phase_session(models["int8"], card, "int8"), "int8")
            # Model(path) with no precision: the weights as loaded (f32)
            record(phase_session(models["f32"], card, "f32"), "f32")
        if "vocab" in phases:
            narrow_dir = os.path.join(tmp, "narrow")
            os.makedirs(narrow_dir)
            narrow_path = flagship_april(narrow_dir, seed=6, dims=TransducerDims(
                d_model=128, hidden=128, ffn=128, joiner_dim=128, vocab=16383, layers=1,
                decoder_groups=32, conv_channels=(4, 8, 8)))
            counts = phase_vocab(models, vocab_path, narrow_path, card)
            record(counts, "vocab f32")
            record(counts, "vocab bf16")
        if "widths" in phases:
            rows, counts = phase_widths(tmp, card)
            kernels += rows
            for p, c in counts.items():
                record(c, p)
        if "chunk" in phases:
            kernels += phase_chunk(card)
        if "matmul" in phases:
            kernels += phase_matmul(card)
        if "tp" in phases:
            rows, counts = phase_tp(models, path, card)
            kernels += rows
            for prec, c in counts.items():
                record(c, f"tp {prec}")
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
