"""This tree's port against another tree's (a parent commit unpacked beside
it, e.g. with `git archive`) on one card, in turns: other, this, this,
other.

    python -m april_asr_tpu_torch.tools.parent_ab --other build/parent \
        [--out build/parent_ab] [--sass] [--only k9|tp|k14|k11|k15|front]

Each turn is a worker process that imports `april_asr_tpu_torch` and
`chip_smoke.py` from one tree (its kernels built into that tree's build
directory) and, on the flagship random int8 model (seed 0):

* times kernel 2 (`lstm_layer_chunk_rec_stream2_i8`, layer 0) at S = 256
  and at S = 2048, P = 27, kernel 3 (`ffn_norm_i8`, layer 0) over the P * S
  rows of both, and kernel 7 (`lstm_layer_fused_i8`) at S = 256, on numpy
  seed inputs, with the SHA-1 of their outputs (kernel 7 ungated and
  gated);
* times kernel 1 (`logmel_rows_from_buf_i8`, by its route) and kernel 5
  (`logmel_rows_from_buf`, by its route) at S = 256 and 2048 on hop-row
  buffers of PCM16 values of the 1 s layout (F = 101) drawn from a numpy
  seed, by CUDA events and the profiler's device time, with the SHA-1 of
  their rows;
* times kernel 16 (`conv_embed_windows`, by its route) on the model's bf16
  embed weights at S = 256 and 2048, P = 27, on front buffers drawn from a
  numpy seed (chip_smoke's `front_buffer`), by CUDA events and the
  profiler's device time, with the SHA-1 of its output;
* times kernel 4 (`chunk_decode`, the whole-chunk decode) on the model's
  bf16 decode weights at S = 256 and 2048, P = 27, on the inputs chip_smoke
  checks it on (`profile_decode.decode_case`, loaded from this tree), by
  CUDA events and the profiler's device time, with the SHA-1 of its events
  and state;
* times kernel 8 (`decoder_joiner_argmax_fused`, one decoder-joiner round,
  by its route) on the model's bf16 decode weights at S = 256 and 2048 on
  the inputs chip_smoke checks it on (`profile_decode.dj_case`, loaded from
  this tree; need_dec at a flush round's ~5% and at 50%), by CUDA events
  and the profiler's device time at ~5%, with the SHA-1 of its four outputs
  at both shares;
* times kernel 9 (`joiner_argmax_fused`, the joiner and argmax, by its
  route) on a 16,383-token flagship-width model's bf16 and f32 join
  weights at S = 256 and 2048 on the inputs `profile_decode.k9_case` draws
  (loaded from this tree), by CUDA events (one call, and 20 calls queued
  back to back), the profiler's device time and the host's time a call
  queued, with the SHA-1 of its three outputs;
* records that model's engine event blobs at f32 (as loaded) and bf16 over
  3 ticks and a flush (the per-pull decode through kernel 9);
* runs chip_smoke's `engine` cell at int8 (10 ticks, 5 flushes, the step
  and flush programs, the profiler's step and flush), its lines relayed;
* records the int8 engine's event blobs over the same 10 ticks and a flush
  (`testing.engine_run`) into <out>/<turn>-<tree>.npz;
* then, on the same model served at f32 (as loaded) and at bf16: times
  kernel 12 (`lstm_layer_fused`, layer 0) at S = 256 and kernel 10
  (`lstm_layer_chunk_fused`, layer 0, gated) at S = 256 and 2048, P = 27,
  with the SHA-1 of their outputs (kernel 12 ungated and gated), kernels 4
  and 8 on its decode weights at f32 as above (bf16: the int8 model's), runs the
  `engine` cell at that precision (its step ms kept), records the engine's
  event blobs over the same 10 ticks and a flush with its kernels, and the
  engine's events over the same 10 ticks and a flush with the decode on its
  plain versions (kernel 4's and 8's functions), so that `DecisionMargins`
  records every decision's margin, into <out>/<turn>-<tree>-<precision>.pkl;
  at bf16 also on the random models of seeds 1 and 2
  (<turn>-<tree>-bf16-s<seed>.pkl).

The main process then requires every turn's int8 blobs, the f32 and bf16
engines' blobs (run on their kernels), the 16,383-token engines' blobs, and
the outputs of kernels 1, 2, 3, 4, 5, 7, 8, 9, 12 and 16 to be equal, bit
for bit; every session of a float
engine whose events part from the first turn's to part at a near-tie
decision (`testing.check_parting` at the engine's precision,
`testing.near_tie`: NEAR_TIE_BF16 at bf16; every session is
counted, and each parting at or above it listed), counted per turn
beside whether the blobs are equal (their f32 log-probabilities move by
ulps where the encoder's sums change order); and kernel 10's outputs to be
equal between the turns of one tree (it changes between the trees). It
prints the times per turn. With `--only k9` each turn runs kernel 9 and
the 16,383-token engines alone, and only their outputs and blobs are
compared. With `--only tp` each turn runs the tensor-parallel pieces alone
(`tp_turn`): kernels 18-21 on rank 0's slices of the flagship model's layer
0 (m = 2) at S = 256 and 2048 on numpy seed inputs, ungated and gated where
the kernel takes a gate (the SHA-1 of their outputs, CUDA-event ms and the
profiler's device us a call), and both two-rank TP engines' (int8, f32)
event blobs over 3 ticks and a flush; only those outputs and blobs are
compared. With `--only k14` each turn runs the int8 recurrent cores alone
(`k14_turn`): kernels 14 and 13 (`lstm_layer_chunk_rec_stream_i8`,
`lstm_layer_chunk_rec_i8`: csrc/lstm_hoist.cu here, their CUDA-core
templates in a parent before it) on layer 0 of the flagship int8 model at
S = 256 and 2048, P = 27, and kernel 14 on layer 0 of the widths phase's
d 1024 / H 4096 / F 8192 int8 model at S = 256, on numpy seed inputs,
ungated and gated (the SHA-1 of their outputs, CUDA-event ms and the
profiler's device us a call), then that wide model's engine event blobs
over 3 ticks and a flush (its step on kernel 14 there) with each call's
wall ms; only those outputs and blobs are compared. With `--only k11` each
turn runs kernels 11 and 22 and those whose code they share (`k11_turn`:
`lstm_layer_chunk_fused_i8` and `rec_interleave_i8` at block_s 512 and
256, csrc/lstm_hoist.cu here, their CUDA-core templates in a parent before
it; kernel 3, whose passes kernel 11 runs; kernels 14 and 13) on layer 0
of the flagship int8 model at S = 256 and 2048, P = 27, on numpy seed
inputs, ungated and gated (the SHA-1 of their outputs, CUDA-event ms and
the profiler's device us a call), then the flagship and wide int8
engines' event blobs and launch counts over 3 ticks and a flush; only
those are compared. With `--only k15` each turn runs kernel 15 alone
(`k15_turn`: `lstm_slab_wavefront_i8`, csrc/lstm_wavefront_hoist.cu here,
its CUDA-core template csrc/lstm_wavefront.cu in a parent before it) on
layers 0-5 of the flagship int8 model at S = 256 and 2048, P = 27, on numpy
seed inputs, ungated and gated (the SHA-1 of its outputs, CUDA-event ms and
the profiler's device us a call), then the flagship and wide int8 engines'
event blobs and launch counts over 3 ticks and a flush; only those are
compared. With `--only front` each turn runs kernels 6 and 17 alone
(`front_turn`: `logmel_rows_fused` on frames of the 1 s layout's hop-row
buffers at S = 256 and 2048, `conv_embed_from_front` on the flagship
model's bf16 embed weights at S = 256 and 2048, P = 27, seg 9, and at S =
256, seg 7, each by its route: csrc/fbank_frames_tile.cu and
csrc/conv_embed_tile.cu here, their CUDA-core templates in a parent
before it; the SHA-1 of their outputs, CUDA-event ms and the profiler's
device us a call), then the flagship engines' event blobs and launch
counts at int8 and bf16 over 3 ticks and a flush; only those are compared.
With
`--sass`, it also runs `sass_diff` on
csrc/lstm_mma.cu, lstm_i8.cu, lstm_step.cu, lstm_tp.cu, lstm_mma_float.cu,
lstm_chunk_mma.cu, chunk_decode.cu, chunk_decode_cluster.cu, joiner.cu,
fbank_i8.cu, fbank_bf16x3.cu, conv_embed.cu, ffn_mma.cu, lstm_wavefront.cu,
lstm_chunk_i8.cu, lstm_hoist.cu, fbank_bf16x3_tile.cu and conv_embed_tile.cu
of the two trees (kernels 2, 3, 4, 5, 7, 9, 11, 12, 13, 14, 16, 18, 19, 22,
the templates of 6, 11, 13, 14, 15, 17 and 22, the three-pass float step
and the CUDA-core kernels 3, 4, 8, 1, 5 and 16); a kernel only this tree
builds (kernel 17's `conv_front_kernel`) is listed as new, not as differing.
Needs a CUDA device (and nvcc).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pickle
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TAG = "PARENT_AB "
HERE = Path(__file__).resolve()
TREE = HERE.parents[2]
SASS_SOURCES = ("lstm_mma.cu", "lstm_i8.cu", "lstm_step.cu", "lstm_tp.cu", "lstm_mma_float.cu",
                "lstm_chunk_mma.cu", "chunk_decode.cu", "chunk_decode_cluster.cu", "joiner.cu",
                "fbank_i8.cu", "fbank_bf16x3.cu", "conv_embed.cu", "ffn_mma.cu",
                "lstm_wavefront.cu", "lstm_chunk_i8.cu", "lstm_hoist.cu", "fbank_bf16x3_tile.cu",
                "conv_embed_tile.cu")
FLOATS = ("f32", "bf16")
BF16_SEEDS = (1, 2)  # more random models for the bf16 engine's partings
# the float engines' runs compared between turns: (precision, model seed)
FLOAT_RUNS = tuple((p, 0) for p in FLOATS) + tuple(("bf16", s) for s in BF16_SEEDS)
# outputs equal between the trees as well as the turns: kernel 12's, kernel
# 4's at both sizes and the float engines' blobs on their kernels
FBANK_SIZES = (256, 2048)
K4_SIZES = (256, 2048)
K8_SIZES = (256, 2048)
K9_SIZES = (256, 2048)
EQUAL_KEYS = tuple(k for p in FLOATS for k in (f"k12_{p}_sha", f"k12_{p}_gated_sha",
                                                 f"blob_{p}_kernels_sha")) + tuple(
    f"k4_{p}_S{S}_sha" for p in FLOATS for S in K4_SIZES) + tuple(
    f"k8_{p}_S{S}_sha" for p in FLOATS for S in K8_SIZES) + tuple(
    f"k9_{p}_S{S}_sha" for p in FLOATS for S in K9_SIZES) + tuple(
    f"blob_vocab_{p}_sha" for p in FLOATS)
K4_STATE = ("context", "token_words", "head", "last_call", "time_ms", "last_emit_ms", "need_dec",
            "emitted_silence", "dout")
# chip_smoke's engine line: each precision's step, flush and flush program
# medians (wall ms)
ENGINE_MS = re.compile(r"^engine (\w+): .* step_ms median=([\d.]+) flush_ms median=([\d.]+) .*"
                       r"flush_program_ms median=([\d.]+)")
ENGINE_MS_KEYS = ("step_ms", "flush_ms", "flush_program_ms")
ENGINE_KEYS = ("events", "recs", "dec", "cells", "blobs")


def _sha(t) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def _this_tree(name: str):
    """This tree's tools/<name>.py, loaded by path (a turn imports the
    package from its own tree, which may not have the module)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"parent_ab_{name}", HERE.parent / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fbank_turn(CS, rt, res: dict, card: str) -> None:
    """Kernels 1 and 5 at S = 256 and 2048 of `rt`'s 1 s layout on
    numpy-seeded PCM16 buffers: each one's CUDA-event ms, the profiler's
    device us a launch and the SHA-1 of its rows, into res["k1_S<S>_*"] and
    res["k5_S<S>_*"]."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.frontend.fbank import FbankLayout
    from april_asr_tpu_torch.ops import fbank_kernels as FK
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    layout = FbankLayout.build(rt.fbank_opts, CS.CHUNK_1S)
    for S in FBANK_SIZES:
        rng = np.random.default_rng(S + 3)
        pcm = (rng.normal(0, 0.25, (S, layout.buf_len)) * 32768).clip(-32768, 32767)
        buf = torch.from_numpy(pcm.astype(np.int16).astype(np.float32) / 32768.0).cuda()
        for k, entry in (("k1", FK.logmel_rows_from_buf_i8), ("k5", FK.logmel_rows_from_buf)):
            fn = lambda: entry(layout, buf)  # noqa: E731
            res[f"{k}_S{S}_sha"] = _sha(fn())
            res[f"{k}_S{S}_ms"] = CS.cuda_ms(fn, 20 if S == 256 else 5)
            res[f"{k}_S{S}_device_us"] = host_and_device_us(fn, n=3, keys=("fbank",))[1]
    for k in ("k1", "k5"):
        print(f"kernels: {k} S=256 {res[f'{k}_S256_ms']:.4f} ms ({res[f'{k}_S256_device_us']:.1f} "
              f"us device), S=2048 {res[f'{k}_S2048_ms']:.4f} ms "
              f"({res[f'{k}_S2048_device_us']:.1f} us device) ({card})", flush=True)


def embed_turn(CS, rt, res: dict, card: str) -> None:
    """Kernel 16 by its route on `rt`'s bf16 embed weights at S = 256 and
    2048, P = 27, on numpy-seeded front buffers: its CUDA-event ms, the
    profiler's device us a call and the SHA-1 of its output, into
    res["k16_S<S>_*"]."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.ops import conv_embed_kernels as CE
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    step, seg = rt.dims.segment_step, rt.dims.segment_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    for S in FBANK_SIZES:
        front = CS.front_buffer(rt, S, 27, np.random.default_rng(S + 5), t)
        fn = lambda: CE.conv_embed_windows(rt.weights, front, P=27, step=step, seg=seg)  # noqa: E731
        res[f"k16_S{S}_sha"] = _sha(fn())
        res[f"k16_S{S}_ms"] = CS.cuda_ms(fn, 20 if S == 256 else 5)
        res[f"k16_S{S}_device_us"] = host_and_device_us(fn, n=3, keys=("conv_",))[1]
    print(f"kernels: k16 S=256 {res['k16_S256_ms']:.4f} ms ({res['k16_S256_device_us']:.1f} us "
          f"device), S=2048 {res['k16_S2048_ms']:.4f} ms ({res['k16_S2048_device_us']:.1f} us "
          f"device) ({card})", flush=True)


def kernel4_turn(CS, rt, prec: str, res: dict, card: str) -> None:
    """Kernel 4 on `rt`'s decode weights at S = 256 and 2048, P = 27: its
    CUDA-event ms, the profiler's device us a launch and the SHA-1 of its
    events and state, into res["k4_<prec>_S<S>_*"]."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.decode.greedy import vocab_tables_device
    from april_asr_tpu_torch.ops import decode_kernels as DK
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    case = _this_tree("profile_decode").decode_case
    dev = torch.device("cuda")
    for S in K4_SIZES:
        args, kw = case(rt.weights, vocab_tables_device(rt.vocab), rt.blank_id,
                        rt.fbank_opts.segment_stride_ms, S, 27, np.random.default_rng(S + 11), dev)
        fn = lambda: DK.chunk_decode(*args, **kw)  # noqa: E731
        st, ev = fn()
        res[f"k4_{prec}_S{S}_sha"] = ([_sha(ev[k]) for k in DK.EVENT_KEYS]
                                      + [_sha(st[k]) for k in K4_STATE])
        res[f"k4_{prec}_S{S}_ms"] = CS.cuda_ms(fn, 10 if S == 256 else 5)
        res[f"k4_{prec}_S{S}_device_us"] = host_and_device_us(fn, n=3, keys=("chunk_decode",))[1]
        del args
    print(f"kernels: k4 {prec} S=256 {res[f'k4_{prec}_S256_ms']:.4f} ms "
          f"({res[f'k4_{prec}_S256_device_us']:.1f} us device), S=2048 "
          f"{res[f'k4_{prec}_S2048_ms']:.4f} ms ({res[f'k4_{prec}_S2048_device_us']:.1f} us "
          f"device) ({card})", flush=True)


def kernel8_turn(CS, rt, prec: str, res: dict, card: str) -> None:
    """Kernel 8 by its route on `rt`'s decode weights at S = 256 and 2048,
    need_dec at ~5% and 50%: the SHA-1 of its four outputs at both shares,
    and at ~5% its CUDA-event ms and the profiler's device us a call, into
    res["k8_<prec>_S<S>_*"]."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    pd = _this_tree("profile_decode")
    dev = torch.device("cuda")
    keys = ("dec_joiner_cluster", "dec_refresh", "joiner_tile", "argmax_final", "Memset")
    for S in K8_SIZES:
        res[f"k8_{prec}_S{S}_sha"], fns = [], []
        for share in pd.DJ_SHARES:
            args = pd.dj_case(rt.weights, rt.blank_id, S, share, np.random.default_rng(S + 23),
                              dev)
            fns.append(lambda a=args: JK.decoder_joiner_argmax_fused(*a[:-1], blank_id=a[-1]))
            res[f"k8_{prec}_S{S}_sha"] += [_sha(o) for o in fns[-1]()]
        res[f"k8_{prec}_S{S}_ms"] = CS.cuda_ms(fns[0], 20)
        res[f"k8_{prec}_S{S}_device_us"] = host_and_device_us(fns[0], n=5, keys=keys)[1]
    print(f"kernels: k8 {prec} S=256 {res[f'k8_{prec}_S256_ms']:.4f} ms "
          f"({res[f'k8_{prec}_S256_device_us']:.1f} us device), S=2048 "
          f"{res[f'k8_{prec}_S2048_ms']:.4f} ms ({res[f'k8_{prec}_S2048_device_us']:.1f} us "
          f"device) ({card})", flush=True)


def kernel9_turn(CS, vocab_path: str, audio, res: dict, card: str) -> None:
    """Kernel 9 by its route on the 16,383-token model's bf16 and f32 join
    weights at S = 256 and 2048 (`profile_decode.k9_case`): the SHA-1 of its
    three outputs, its CUDA-event ms, the profiler's device us and the
    host's us a call, into res["k9_<prec>_S<S>_*"]; then the model's engine
    event blobs over the first 3 ticks of `audio` and a flush, into
    res["blob_vocab_<prec>_sha"]."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.testing import engine_run
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    case = _this_tree("profile_decode").k9_case
    dev = torch.device("cuda")
    keys = ("joiner_stream", "joiner_tile", "argmax_final", "Memset")
    for prec in FLOATS:
        rt = Model(vocab_path, precision=None if prec == "f32" else "bf16", device="cuda").runtime
        w_t, b = rt.weights["join_t"], rt.weights["join_b"]
        for S in K9_SIZES:
            eout, dout = case(w_t, S, np.random.default_rng(S + 29), dev)
            fn = lambda: JK.joiner_argmax_fused(eout, dout, w_t, b, blank_id=rt.blank_id)  # noqa: E731
            res[f"k9_{prec}_S{S}_sha"] = [_sha(o) for o in fn()]
            res[f"k9_{prec}_S{S}_ms"] = CS.cuda_ms(fn, 20)
            res[f"k9_{prec}_S{S}_queued_us"] = queued_us(fn, 20)
            res[f"k9_{prec}_S{S}_host_us"] = host_and_device_us(fn, n=50, keys=keys)[0]
            res[f"k9_{prec}_S{S}_device_us"] = CS.profiled(fn, 5, keys)[1]
        run = engine_run(dict(rt=rt, m=1, device="cuda", audio=audio[:3], ticks=3))
        res[f"blob_vocab_{prec}_sha"] = _blob_sha(run["blobs"])
        print("kernels: " + ", ".join(
            f"k9 {prec} V=16383 S={S} {res[f'k9_{prec}_S{S}_ms']:.4f} ms "
            f"({res[f'k9_{prec}_S{S}_queued_us']:.1f} us queued, "
            f"{res[f'k9_{prec}_S{S}_device_us']:.1f} us device, "
            f"{res[f'k9_{prec}_S{S}_host_us']:.1f} us host)" for S in K9_SIZES) + f" ({card})",
            flush=True)
        del rt


TP_SIZES = (256, 2048)
# the tensor-parallel kernels' device kernels in either tree (the one-launch
# kernels 18-21, or the column-pass kernels they replaced)
TP_KEYS = ("tp_gcp_kernel", "tp_gc_i8_kernel", "tp_ffn_kernel", "tp_mid_i8_kernel", "step_gates",
           "tp_cols")
TP_KERNELS = ("k18_f32", "k18_bf16", "k19", "k20_f32", "k20_bf16", "k21")


def tp_turn(CS, path: str, res: dict, card: str) -> None:
    """Kernels 18-21 on rank 0's slices (m = 2, `chip_smoke._tp_shards`) of
    the model at `path` (f32 and bf16 weights as served at those types, int8
    copies) at S = 256 and 2048 on numpy seed inputs: the SHA-1 of their
    outputs (18 and 19 also gated), CUDA-event ms and the profiler's device
    us a call, into res["<kernel>_S<S>_*"]; then both two-rank TP engines'
    event blobs over 3 ticks of tone bursts and a flush
    (res["blob_tp_<prec>_sha"], required equal on both ranks) and their
    rank-0 wall ms a call."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.ops import lstm_tp_kernels as TK
    from april_asr_tpu_torch.testing import RankGroup

    models = {"int8": Model(path, precision="int8", device="cuda"),
              "bf16": Model(path, precision="bf16", device="cuda"),
              "f32": Model(path, device="cuda")}
    dims = models["int8"].runtime.dims
    d, Hs = dims.d_model, dims.hidden // 2
    fk, ik = CS.TP_FLOAT_KEYS, CS.TP_I8_KEYS
    w = {p: CS._tp_shards(models[p].runtime.weights, fk, 2)[0] for p in ("f32", "bf16")}
    q = CS._tp_shards(models["int8"].runtime.weights, ik, 2)[0]
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    for S in TP_SIZES:
        rng = np.random.default_rng(S + 31)
        x = t(rng.normal(size=(S, d)).astype(np.float32))
        h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(S, Hs)) * 0.3).astype(np.float32))
        y = t(rng.normal(size=(S, d)).astype(np.float32))
        gate = t(rng.random(S) < 0.5)
        fns = {
            "k18_f32": lambda g=None: TK.lstm_gate_cell_proj(
                x, h, c, *(w["f32"][k] for k in fk[:4]), g),
            "k18_bf16": lambda g=None: TK.lstm_gate_cell_proj(
                x, h, c, *(w["bf16"][k] for k in fk[:4]), g),
            "k19": lambda g=None: TK.lstm_gates_cell_i8(x, h, c, *(q[k] for k in ik[:5]), g),
            "k20_f32": lambda g=None: TK.ffn_partial(y, *(w["f32"][k] for k in fk[4:])),
            "k20_bf16": lambda g=None: TK.ffn_partial(y, *(w["bf16"][k] for k in fk[4:])),
            "k21": lambda g=None: TK.ffn_mid_i8(y, q["ff1_t_q8"], q["ff1_t_q8s"], q["ff1_b"]),
        }
        for name, fn in fns.items():
            outs = list(fn()) if name[:3] in ("k18", "k19") else [fn()]
            if name[:3] in ("k18", "k19"):
                outs += list(fn(gate))
            res[f"{name}_S{S}_sha"] = [_sha(o) for o in outs]
            res[f"{name}_S{S}_ms"] = CS.cuda_ms(fn, 20)
            res[f"{name}_S{S}_device_us"] = CS.profiled(fn, 5, TP_KEYS)[1]
        print("kernels: " + ", ".join(
            f"{n} S={S} {res[f'{n}_S{S}_ms']:.4f} ms ({res[f'{n}_S{S}_device_us']:.1f} us device)"
            for n in TP_KERNELS) + f" ({card})", flush=True)
    audio = np.stack(CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, models["int8"].runtime.sample_rate,
                                   n=3, seed=21))
    del models
    for prec in ("int8", "f32"):
        args = dict(path=path, precision="int8" if prec == "int8" else None, m=2, device="cuda",
                    audio=audio, ticks=3)
        ranks = RankGroup("april_asr_tpu_torch.testing:engine_run", args, world=2,
                          timeout=600).join()
        shas = [_blob_sha(r["blobs"]) for r in ranks]
        if shas[0] != shas[1]:
            raise AssertionError(f"tp engine {prec}: the ranks' blobs differ")
        res[f"blob_tp_{prec}_sha"] = shas[0]
        res[f"tp_{prec}_ms"] = ranks[0]["ms"]
        print(f"tp engine {prec}: rank 0 ms a call {[round(v, 1) for v in ranks[0]['ms']]} "
              f"({card})", flush=True)


K14_SIZES = (256, 2048)
# the recurrent cores' device kernels in either tree (csrc/lstm_hoist.cu's
# three launches, or the CUDA-core template)
K14_KEYS = ("hoist", "lstm_rec_kernel")
K14_KERNELS = ("k14", "k13")


def k14_turn(CS, tmp: str, res: dict, card: str) -> None:
    """Kernels 14 and 13 on layer 0 of the flagship int8 model at S = 256
    and 2048, kernel 14 on layer 0 of the wide int8 model (chip_smoke's
    `WIDE`) at S = 256, P = 27, ungated and gated: the SHA-1 of their
    outputs, CUDA-event ms and the profiler's device us a call (ungated),
    into res["<kernel>_S<S>_*"] ("k14_wide_S256_*"); then the wide model's
    engine event blobs over 3 ticks and a flush (res["blob_wide_sha"]) and
    its wall ms a call (res["wide_ms"])."""
    import os

    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.testing import engine_run

    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    wide_dir = os.path.join(tmp, "wide")
    os.makedirs(wide_dir)
    wide_path = CS.flagship_april(wide_dir, seed=9, dims=TransducerDims(**CS.WIDE))
    cases = [(CS.flagship_april(tmp), S, K14_KERNELS, "") for S in K14_SIZES]
    cases.append((wide_path, 256, ("k14",), "_wide"))
    for path, S, kernels, tag in cases:
        rt = Model(path, precision="int8", device="cuda").runtime
        la = tuple(rt.weights[k][0] for k in LK.LAYER_I8_KEYS[:7])
        d, H, P = rt.dims.d_model, rt.dims.hidden, 27
        rng = np.random.default_rng(S + 14)
        x = t(rng.normal(size=(P, S, d)).astype(np.float32))
        h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
        n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
        for name in kernels:
            fn = LK.lstm_layer_chunk_rec_stream_i8 if name == "k14" else LK.lstm_layer_chunk_rec_i8
            call = lambda fn=fn, g=None: fn(x, h, c, *la, g)  # noqa: E731
            key = f"{name}{tag}_S{S}"
            res[f"{key}_sha"] = [_sha(o) for o in list(call()) + list(call(g=n))]
            res[f"{key}_ms"] = CS.cuda_ms(call, 5 if S == 256 else 2, warmup=1)
            res[f"{key}_device_us"] = CS.profiled(call, 2, K14_KEYS)[1]
        del rt, x, h, c
        print("kernels: " + ", ".join(
            f"{k}{tag} S={S} {res[f'{k}{tag}_S{S}_ms']:.4f} ms "
            f"({res[f'{k}{tag}_S{S}_device_us']:.1f} us device)" for k in kernels)
            + f" ({card})", flush=True)
    audio = np.stack(CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, 16000, n=3, seed=22))
    run = engine_run(dict(path=wide_path, precision="int8", m=1, device="cuda", audio=audio,
                          ticks=3))
    res["blob_wide_sha"] = _blob_sha(run["blobs"])
    res["wide_ms"] = run["ms"]
    res["wide_counts"] = run["counts"][0]
    print(f"wide int8 engine: ms a call {[round(v, 1) for v in run['ms']]}; step launches "
          f"{json.dumps(run['counts'][0])} ({card})", flush=True)


K11_SIZES = (256, 2048)
# kernels 11 and 22's device kernels in either tree (csrc/lstm_hoist.cu's
# launches, or the CUDA-core templates: csrc/lstm_chunk_i8.cu, and
# csrc/lstm_i8.cu's per-timestep step); kernel 3's (csrc/ffn_mma.cu)
K11_KEYS = ("hoist", "lstm_chunk_i8_kernel", "lstm_rec_kernel")
K3_KEYS = ("ffn_yq_kernel", "ffn_mm_kernel", "ffn_mq_kernel", "ffn_norm_rows_kernel")
# (result key, device kernel names) of each kernel the turn times
K11_KERNELS = (("k11", K11_KEYS), ("k22", K11_KEYS), ("k22_ts2", K11_KEYS), ("k3", K3_KEYS),
               ("k14", K11_KEYS), ("k13", K11_KEYS))
# the int8 engines whose kernels share csrc/lstm_hoist.cu's and
# csrc/ffn_mma.cu's code: the flagship (kernel 3) and the wide (14 and 3)
K11_ENGINES = ("int8", "wide")


def k11_turn(CS, tmp: str, res: dict, card: str) -> None:
    """Kernel 11 (`lstm_layer_chunk_fused_i8`), kernel 22
    (`profile_chunk_split.rec_interleave_i8`, block_s 512 and 256: "k22",
    "k22_ts2"), and the kernels whose code they share, kernel 3
    (`ffn_norm_i8` over the P * S rows), 14 and 13, on layer 0 of the
    flagship int8 model at S = 256 and 2048, P = 27, on numpy seed inputs,
    ungated and gated where they take n_pulls: the SHA-1 of their outputs,
    CUDA-event ms and the profiler's device us a call (ungated), into
    res["<kernel>_S<S>_*"]; then the int8 engines (`int8_engines`)."""
    import functools

    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.tools import profile_chunk_split as PCS

    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    path = CS.flagship_april(tmp)
    rt = Model(path, precision="int8", device="cuda").runtime
    w = tuple(rt.weights[k][0] for k in LK.LAYER_I8_KEYS)
    d, H, P = rt.dims.d_model, rt.dims.hidden, 27
    for S in K11_SIZES:
        rng = np.random.default_rng(S + 11)
        x = t(rng.normal(size=(P, S, d)).astype(np.float32))
        h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
        n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
        hs = t(rng.normal(size=(P * S, d)).astype(np.float32))
        calls = {
            "k11": lambda g: LK.lstm_layer_chunk_fused_i8(x, h, c, *w, g),
            "k22": lambda g: PCS.rec_interleave_i8(x, h, c, *w[:7], g, block_s=512),
            "k22_ts2": lambda g: PCS.rec_interleave_i8(x, h, c, *w[:7], g, block_s=256),
            "k3": lambda g: (LK.ffn_norm_i8(x.reshape(P * S, d), hs, *w[7:]),),
            "k14": lambda g: LK.lstm_layer_chunk_rec_stream_i8(x, h, c, *w[:7], g),
            "k13": lambda g: LK.lstm_layer_chunk_rec_i8(x, h, c, *w[:7], g),
        }
        for name, keys in K11_KERNELS:
            call = functools.partial(calls[name], None)
            key = f"{name}_S{S}"
            outs = list(call()) + (list(calls[name](n)) if name != "k3" else [])
            res[f"{key}_sha"] = [_sha(o) for o in outs]
            res[f"{key}_ms"] = CS.cuda_ms(call, 5 if S == 256 else 2, warmup=1)
            res[f"{key}_device_us"] = CS.profiled(call, 2, keys)[1]
        del x, h, c, hs
        print("kernels: " + ", ".join(
            f"{k} S={S} {res[f'{k}_S{S}_ms']:.4f} ms ({res[f'{k}_S{S}_device_us']:.1f} us device)"
            for k, _ in K11_KERNELS) + f" ({card})", flush=True)
    del rt
    int8_engines(CS, tmp, path, res, card)


def int8_engines(CS, tmp: str, path: str, res: dict, card: str) -> None:
    """The flagship (the model at `path`) and the wide (chip_smoke's `WIDE`)
    int8 engines' event blobs and launch counts over 3 ticks and a flush
    (res["blob_<engine>_sha"], res["<engine>_counts"])."""
    import os

    import numpy as np

    from april_asr_tpu_torch.models.lstm_transducer import TransducerDims
    from april_asr_tpu_torch.testing import engine_run

    wide_dir = os.path.join(tmp, "wide")
    os.makedirs(wide_dir)
    paths = {"int8": path,
             "wide": CS.flagship_april(wide_dir, seed=9, dims=TransducerDims(**CS.WIDE))}
    audio = np.stack(CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, 16000, n=3, seed=22))
    for name in K11_ENGINES:
        run = engine_run(dict(path=paths[name], precision="int8", m=1, device="cuda", audio=audio,
                              ticks=3))
        res[f"blob_{name}_sha"] = _blob_sha(run["blobs"])
        res[f"{name}_counts"] = run["counts"]
        print(f"{name} engine: ms a call {[round(v, 1) for v in run['ms']]}; step launches "
              f"{json.dumps(run['counts'][0])} ({card})", flush=True)


K15_SIZES = (256, 2048)
K15_LAYERS = 6
# kernel 15's device kernels in either tree: the cooperative launch
# (csrc/lstm_wavefront_hoist.cu) or the template's per-diagonal launches
# (csrc/lstm_wavefront.cu)
K15_KEYS = ("wavefront",)


def k15_turn(CS, tmp: str, res: dict, card: str) -> None:
    """Kernel 15 (`lstm_slab_wavefront_i8`) on layers 0-5 of the flagship
    int8 model at S = 256 and 2048, P = 27, on numpy seed inputs, ungated
    and gated: the SHA-1 of its outputs, CUDA-event ms and the profiler's
    device us a call (ungated), into res["k15_S<S>_*"]; then the int8
    engines (`int8_engines`)."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.ops import lstm_wavefront_kernels as LW

    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    path = CS.flagship_april(tmp)
    rt = Model(path, precision="int8", device="cuda").runtime
    slab = tuple(rt.weights[k][:K15_LAYERS] for k in LK.LAYER_I8_KEYS)
    d, H, P, L = rt.dims.d_model, rt.dims.hidden, 27, K15_LAYERS
    for S in K15_SIZES:
        rng = np.random.default_rng(S + 15)
        x = t(rng.normal(size=(P, S, d)).astype(np.float32))
        h = t((rng.normal(size=(L, S, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(L, S, H)) * 0.3).astype(np.float32))
        n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
        call = lambda g=None: LW.lstm_slab_wavefront_i8(x, h, c, *slab, g)  # noqa: E731
        key = f"k15_S{S}"
        res[f"{key}_sha"] = [_sha(o) for o in list(call()) + list(call(n))]
        res[f"{key}_ms"] = CS.cuda_ms(call, 5 if S == 256 else 2, warmup=1)
        res[f"{key}_device_us"] = CS.profiled(call, 2, K15_KEYS)[1]
        print(f"kernel 15 S={S}: {res[f'{key}_ms']:.4f} ms ({res[f'{key}_device_us']:.1f} us "
              f"device) ({card})", flush=True)
        del x, h, c
    del rt, slab
    int8_engines(CS, tmp, path, res, card)


FRONT_SIZES = (256, 2048)
FRONT_ENGINES = ("int8", "bf16")


def front_turn(CS, tmp: str, res: dict, card: str) -> None:
    """Kernels 6 and 17 by their routes: kernel 6 (`logmel_rows_fused`) on
    frames of the 1 s layout's numpy-seeded hop-row buffers and kernel 17
    (`conv_embed_from_front`) on the flagship model's bf16 embed weights, P =
    27, at S = 256 and 2048 (seg 9), kernel 17 also at S = 256, seg 7: the
    SHA-1 of each output, CUDA-event ms and the profiler's device us a call,
    into res["k6_S<S>_*"], res["k17_S<S>_*"] and res["k17s7_S256_*"]; then
    the flagship engines at int8 and bf16, their event blobs and launch
    counts over 3 ticks and a flush (res["blob_<precision>_sha"],
    res["<precision>_counts"])."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.frontend.fbank import FbankLayout
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE
    from april_asr_tpu_torch.ops import fbank_kernels as FK
    from april_asr_tpu_torch.testing import engine_run
    from april_asr_tpu_torch.tools.profile_lstm_mma import host_and_device_us

    path = CS.flagship_april(tmp)
    rt = Model(path, precision="int8", device="cuda").runtime
    layout = FbankLayout.build(rt.fbank_opts, CS.CHUNK_1S)
    step = rt.dims.segment_step
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

    def timed(key, fn, keys, reps):
        res[f"{key}_sha"] = _sha(fn())
        res[f"{key}_ms"] = CS.cuda_ms(fn, reps)
        res[f"{key}_device_us"] = host_and_device_us(fn, n=3, keys=keys)[1]
        print(f"kernels: {key} {res[f'{key}_ms']:.4f} ms ({res[f'{key}_device_us']:.1f} us "
              f"device) ({card})", flush=True)

    for S in FRONT_SIZES:
        rng = np.random.default_rng(S + 6)
        pcm = (rng.normal(0, 0.25, (S, layout.buf_len)) * 32768).clip(-32768, 32767)
        buf = torch.from_numpy(pcm.astype(np.int16).astype(np.float32) / 32768.0).cuda()
        frames = FK.frames_from_buf(layout, buf)
        timed(f"k6_S{S}", lambda: FK.logmel_rows_fused(layout, frames), ("fbank_frames",),
              20 if S == 256 else 5)
        for seg in ((9, 7) if S == 256 else (9,)):
            W = 26 * step + seg
            front = t((np.random.default_rng(S + seg).normal(size=(S, W, rt.dims.mel)) * 2.0
                       - 6.0).astype(np.float32))
            timed(f"k17_S{S}" if seg == 9 else f"k17s7_S{S}",
                  lambda: CE.conv_embed_from_front(rt.weights, front, P=27, step=step, seg=seg),
                  ("conv_",), 20 if S == 256 else 5)
        del buf, frames, front
    del rt
    audio = np.stack(CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, 16000, n=3, seed=25))
    for prec in FRONT_ENGINES:
        run = engine_run(dict(path=path, precision=prec, m=1, device="cuda", audio=audio,
                              ticks=3))
        res[f"blob_{prec}_sha"] = _blob_sha(run["blobs"])
        res[f"{prec}_counts"] = run["counts"]
        print(f"{prec} engine: ms a call {[round(v, 1) for v in run['ms']]}; step launches "
              f"{json.dumps(run['counts'][0])} ({card})", flush=True)


def queued_us(fn, n: int) -> float:
    """CUDA-event us a call over n calls queued back to back (after a
    warm-up): the device's time a call where it exceeds the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n * 1e3


def worker(root: str, out: str, only: str = "") -> None:
    """One turn: everything measured from the tree at `root` (with `only`
    "k9", kernel 9 and the 16,383-token engines alone; "tp", the
    tensor-parallel pieces alone)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as CS
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.ops import cuda_build
    from april_asr_tpu_torch.ops import lstm_kernels as LK
    from april_asr_tpu_torch.testing import engine_run

    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    cuda_build.build_all()
    res = {"root": root, "build_s": time.perf_counter() - t0}
    card = CS.card_line()
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        if only == "k9":
            from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

            bufs = CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, 16000)
            audio = np.stack([bufs[k % len(bufs)] for k in range(3)])
            kernel9_turn(CS, CS.flagship_april(tmp, dims=TransducerDims(vocab=16383)), audio, res,
                         card)
            print(TAG + json.dumps(dict(res, card=card)), flush=True)
            return
        if only == "tp":
            tp_turn(CS, CS.flagship_april(tmp), res, card)
            print(TAG + json.dumps(dict(res, card=card)), flush=True)
            return
        if only == "k14":
            k14_turn(CS, tmp, res, card)
            print(TAG + json.dumps(dict(res, card=card)), flush=True)
            return
        if only == "k11":
            k11_turn(CS, tmp, res, card)
            print(TAG + json.dumps(dict(res, card=card)), flush=True)
            return
        if only == "k15":
            k15_turn(CS, tmp, res, card)
            print(TAG + json.dumps(dict(res, card=card)), flush=True)
            return
        if only == "front":
            front_turn(CS, tmp, res, card)
            print(TAG + json.dumps(dict(res, card=card)), flush=True)
            return
        path = CS.flagship_april(tmp)
        model = Model(path, precision="int8", device="cuda")
        rt = model.runtime
        w, d, H = rt.weights, rt.dims.d_model, rt.dims.hidden
        keys = LK.LAYER_I8_KEYS
        la = tuple(w[k][0] for k in keys[:7])
        sa = tuple(w[k][0] for k in keys)
        for S, P, reps in ((256, 27, 20), (2048, 27, 5)):
            rng = np.random.default_rng(S)
            x = t(rng.normal(size=(P, S, d)).astype(np.float32))
            h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
            c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
            n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
            fn = lambda: LK.lstm_layer_chunk_rec_stream2_i8(x, h, c, *la, n)  # noqa: E731
            res[f"k2_S{S}_sha"] = [_sha(o) for o in fn()]
            res[f"k2_S{S}_ms"] = CS.cuda_ms(fn, reps)
            xr = x.reshape(P * S, d)
            hs = t(rng.normal(size=(P * S, d)).astype(np.float32))
            fn = lambda: LK.ffn_norm_i8(xr, hs, *sa[7:])  # noqa: E731
            res[f"k3_S{S}_sha"] = _sha(fn())
            res[f"k3_S{S}_ms"] = CS.cuda_ms(fn, reps)
            del x, xr, hs
        rng = np.random.default_rng(7)
        x = t(rng.normal(size=(256, d)).astype(np.float32))
        h = t((rng.normal(size=(256, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(256, H)) * 0.3).astype(np.float32))
        gate = t(rng.random(256) < 0.5)
        res["k7_sha"] = [_sha(o) for o in LK.lstm_layer_fused_i8(x, h, c, *sa)]
        res["k7_gated_sha"] = [_sha(o) for o in LK.lstm_layer_fused_i8(x, h, c, *sa, gate)]
        res["k7_ms"] = CS.cuda_ms(lambda: LK.lstm_layer_fused_i8(x, h, c, *sa), 20)
        print(f"kernels: k2 S=256 {res['k2_S256_ms']:.4f} ms, S=2048 {res['k2_S2048_ms']:.4f} ms, "
              f"k3 S=256 {res['k3_S256_ms']:.4f} ms, S=2048 {res['k3_S2048_ms']:.4f} ms, "
              f"k7 S=256 {res['k7_ms']:.4f} ms ({card})", flush=True)
        fbank_turn(CS, rt, res, card)
        embed_turn(CS, rt, res, card)
        kernel4_turn(CS, rt, "bf16", res, card)
        kernel8_turn(CS, rt, "bf16", res, card)
        CS.phase_engine(model, card, "int8")
        bufs = CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, rt.sample_rate)
        audio = np.stack([bufs[k % len(bufs)] for k in range(10)])
        run = engine_run(dict(path=path, precision="int8", m=1, device="cuda", audio=audio,
                              ticks=10))
        blobs = [np.asarray(b) for b in run["blobs"]]
        np.savez(out, *blobs)
        res["blob_sha"] = _blob_sha(blobs)
        del model
        for prec in FLOATS:
            float_turn(CS, path, prec, audio, card, res, out)
        for seed in BF16_SEEDS:
            seed_path = CS.flagship_april(tempfile.mkdtemp(dir=tmp), seed=seed)
            float_turn(CS, seed_path, "bf16", audio, card, res, out, seed)
        from april_asr_tpu_torch.models.lstm_transducer import TransducerDims

        vocab_path = CS.flagship_april(tempfile.mkdtemp(dir=tmp), dims=TransducerDims(vocab=16383))
        kernel9_turn(CS, vocab_path, audio, res, card)
    res["card"] = card
    print(TAG + json.dumps(res), flush=True)


def _blob_sha(blobs) -> list:
    import numpy as np

    return [hashlib.sha1(np.asarray(b).tobytes()).hexdigest()[:16] for b in blobs]


def _run_name(prec: str, seed: int) -> str:
    return prec if seed == 0 else f"{prec}-s{seed}"


def float_turn(CS, path: str, prec: str, audio, card: str, res: dict, out: str,
               seed: int = 0) -> None:
    """Kernels 12 and 10 and the engine at `prec` ("f32": the weights as
    loaded; "bf16"), measured from this turn's tree, into res; the engine's
    run with the plain decode and its margins into <out>-<prec>.pkl. On the
    models of other seeds (`seed` > 0), the engine's run alone, into
    <out>-<prec>-s<seed>.pkl."""
    import numpy as np
    import torch

    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF
    from april_asr_tpu_torch.testing import engine_run

    model = Model(path, precision=None if prec == "f32" else "bf16", device="cuda")
    rt = model.runtime
    w, d, H = rt.weights, rt.dims.d_model, rt.dims.hidden
    sa = tuple(w[k][0] for k in TM.STEP_KEYS)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(256, d)).astype(np.float32))
    h = t((rng.normal(size=(256, d)) * 0.3).astype(np.float32))
    c = t((rng.normal(size=(256, H)) * 0.3).astype(np.float32))
    gate = t(rng.random(256) < 0.5)
    if seed == 0:
        res[f"k12_{prec}_sha"] = [_sha(o) for o in LF.lstm_layer_fused(x, h, c, *sa)]
        res[f"k12_{prec}_gated_sha"] = [_sha(o) for o in LF.lstm_layer_fused(x, h, c, *sa, gate)]
        res[f"k12_{prec}_ms"] = CS.cuda_ms(lambda: LF.lstm_layer_fused(x, h, c, *sa), 20)
        for S, P, reps in ((256, 27, 10), (2048, 27, 3)):
            rng = np.random.default_rng(S + 1)
            xc = t(rng.normal(size=(P, S, d)).astype(np.float32))
            hc = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
            cc = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
            n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
            fn = lambda: LF.lstm_layer_chunk_fused(xc, hc, cc, *sa, n)  # noqa: E731
            res[f"k10_{prec}_S{S}_sha"] = [_sha(o) for o in fn()]
            res[f"k10_{prec}_S{S}_ms"] = CS.cuda_ms(fn, reps)
            del xc, hc, cc
        print(f"kernels: k12 {prec} S=256 {res[f'k12_{prec}_ms']:.4f} ms, k10 {prec} P=27 S=256 "
              f"{res[f'k10_{prec}_S256_ms']:.4f} ms, S=2048 {res[f'k10_{prec}_S2048_ms']:.4f} ms "
              f"({card})", flush=True)
        if prec == "f32":
            kernel4_turn(CS, rt, prec, res, card)
            kernel8_turn(CS, rt, prec, res, card)
        CS.phase_engine(model, card, prec)
        kern = engine_run(dict(rt=rt, m=1, device="cuda", audio=audio, ticks=len(audio)))
        res[f"blob_{prec}_kernels_sha"] = _blob_sha(kern["blobs"])
    run = plain_decode_run(rt, audio)
    name = _run_name(prec, seed)
    res[f"blob_{name}_sha"] = _blob_sha(run["blobs"])
    with open(f"{out[:-4]}-{name}.pkl", "wb") as f:
        pickle.dump({k: run[k] for k in ENGINE_KEYS}, f)
    del model


def plain_decode_run(rt, audio) -> dict:
    """`testing.engine_run` of the CUDA runtime `rt` over `audio` ([ticks,
    S, chunk]) and a flush, with the decode on its plain versions (kernel
    4's and 8's functions), so that `DecisionMargins` records every
    decision's margin."""
    from april_asr_tpu_torch.engine import step as ES
    from april_asr_tpu_torch.ops import decode_kernels as DK
    from april_asr_tpu_torch.ops import joiner_kernels as JK
    from april_asr_tpu_torch.testing import engine_run

    blank = rt.blank_id
    plain_rt = dataclasses.replace(
        rt, decoder_joiner_argmax=lambda w, ctx, nd, dout, e: JK.decoder_joiner_argmax_plain(
            ctx, nd, dout, e, w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"],
            w["join_b"], blank))
    orig = ES.chunk_decode
    ES.chunk_decode = DK.chunk_decode_plain
    try:
        return engine_run(dict(rt=plain_rt, m=1, device="cuda", audio=audio, ticks=len(audio),
                               margins=True))
    finally:
        ES.chunk_decode = orig


def run_turn(i: int, label: str, root: Path, out_dir: Path, only: str = "") -> dict:
    out = out_dir / f"{i}-{label}.npz"
    cmd = [sys.executable, str(HERE), "--worker", str(root), "--npz", str(out), "--only", only]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(root))
    res, ms = None, {k: {} for k in ENGINE_MS_KEYS}
    for line in proc.stdout:
        if line.startswith(TAG):
            res = json.loads(line[len(TAG):])
        else:
            m = ENGINE_MS.match(line)
            if m:
                for k, v in zip(ENGINE_MS_KEYS, m.groups()[1:]):
                    ms[k][m.group(1)] = float(v)
            print(f"[{i} {label}] {line.rstrip()}", flush=True)
    if proc.wait() != 0 or res is None:
        raise RuntimeError(f"turn {i} ({label}, {root}) failed with exit code {proc.returncode}")
    return dict(res, **ms)


def sass(other: Path) -> list:
    from april_asr_tpu_torch.tools import sass_diff

    rows = []
    for src in SASS_SOURCES:
        a = other / "april_asr_tpu_torch" / "csrc" / src
        b = TREE / "april_asr_tpu_torch" / "csrc" / src
        with tempfile.TemporaryDirectory() as da, tempfile.TemporaryDirectory() as db:
            found = sass_diff.compare(sass_diff.build(a, Path(da)), sass_diff.build(b, Path(db)))
        for r in found:
            state = "same" if r["same"] else "new" if r["insns"][0] is None else "differs"
            print(f"sass {src} {r['kernel'][:48]}: registers {r['regs'][0]} -> {r['regs'][1]}, "
                  f"instructions {r['insns'][0]} -> {r['insns'][1]}, SASS {state}", flush=True)
        rows += [dict(r, source=src) for r in found]
    return rows


def float_partings(out_dir: Path, turns: list, name: str, precision: str) -> tuple:
    """Sessions of each turn's plain-decode float engine run `name` (a
    precision, with "-s<seed>" for another model) that part from the first
    turn's, by `testing.check_parting` at `precision`: {turn: {session:
    (call, cell, margin)}}, and {turn: [sessions that parted at or above
    the precision's bound, `testing.near_tie`]}."""
    from april_asr_tpu_torch.testing import check_parting

    runs = []
    for i, tr in enumerate(turns):
        with open(out_dir / f"{i}-{tr['label']}-{name}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    ref = runs[0]
    found, over = {}, {}
    for i, run in enumerate(runs[1:], 1):
        parted, over[i] = {}, []
        for k in range(len(ref["events"])):
            check_parting(k, ref["events"][k], run["events"][k], ref["cells"][k], ref["recs"][k],
                          run["recs"][k], ref["dec"][k], run["dec"][k], parted, over[i],
                          precision)
        found[i] = parted
    return found, over


def k9_summary(turns: list, rows: list, out: Path, t0: float) -> int:
    """`--only k9`: kernel 9's outputs and the 16,383-token engines' blobs
    required equal across every turn; its times per turn."""
    ref = turns[0]
    keys = tuple(k for k in EQUAL_KEYS if k.startswith(("k9_", "blob_vocab_")))
    bad = sorted({k for tr in turns for k in keys if tr[k] != ref[k]})
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s") + tuple(
            f"k9_{p}_S{S}_{u}" for p in FLOATS for S in K9_SIZES
            for u in ("ms", "queued_us", "device_us", "host_us"))} for tr in turns],
        "equal": not bad, "differ": bad,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows if not r["same"]],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {bad}", file=sys.stderr)
        return 1
    return 0


def tp_summary(turns: list, rows: list, out: Path, t0: float) -> int:
    """`--only tp`: kernels 18-21's outputs and both TP engines' blobs
    required equal across every turn; their times per turn."""
    ref = turns[0]
    keys = tuple(f"{n}_S{S}_sha" for n in TP_KERNELS for S in TP_SIZES) + tuple(
        f"blob_tp_{p}_sha" for p in ("int8", "f32"))
    bad = sorted({k for tr in turns for k in keys if tr[k] != ref[k]})
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s", "tp_int8_ms", "tp_f32_ms") + tuple(
            f"{n}_S{S}_{u}" for n in TP_KERNELS for S in TP_SIZES
            for u in ("ms", "device_us"))} for tr in turns],
        "equal": not bad, "differ": bad,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows if not r["same"]],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {bad}", file=sys.stderr)
        return 1
    return 0


def k14_summary(turns: list, rows: list, out: Path, t0: float) -> int:
    """`--only k14`: kernels 13 and 14's outputs and the wide int8 engine's
    blobs required equal across every turn; their times per turn."""
    ref = turns[0]
    sizes = [(k, "", S) for k in K14_KERNELS for S in K14_SIZES] + [("k14", "_wide", 256)]
    keys = tuple(f"{k}{tag}_S{S}_sha" for k, tag, S in sizes) + ("blob_wide_sha",)
    bad = sorted({k for tr in turns for k in keys if tr[k] != ref[k]})
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s", "wide_ms", "wide_counts") + tuple(
            f"{k}{tag}_S{S}_{u}" for k, tag, S in sizes for u in ("ms", "device_us"))}
            for tr in turns],
        "equal": not bad, "differ": bad,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows if not r["same"]],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {bad}", file=sys.stderr)
        return 1
    return 0


def k11_summary(turns: list, rows: list, out: Path, t0: float) -> int:
    """`--only k11`: kernels 11, 22, 3, 14 and 13's outputs and the int8
    engines' blobs and launch counts required equal across every turn;
    their times per turn."""
    ref = turns[0]
    sizes = [(k, S) for k, _ in K11_KERNELS for S in K11_SIZES]
    keys = tuple(f"{k}_S{S}_sha" for k, S in sizes) + tuple(
        k for e in K11_ENGINES for k in (f"blob_{e}_sha", f"{e}_counts"))
    bad = sorted({k for tr in turns for k in keys if tr[k] != ref[k]})
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s") + tuple(
            f"{k}_S{S}_{u}" for k, S in sizes for u in ("ms", "device_us"))} for tr in turns],
        "equal": not bad, "differ": bad,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows if not r["same"]],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {bad}", file=sys.stderr)
        return 1
    return 0


def k15_summary(turns: list, rows: list, out: Path, t0: float) -> int:
    """`--only k15`: kernel 15's outputs and the int8 engines' blobs and
    launch counts required equal across every turn; its times per turn."""
    ref = turns[0]
    keys = tuple(f"k15_S{S}_sha" for S in K15_SIZES) + tuple(
        k for e in K11_ENGINES for k in (f"blob_{e}_sha", f"{e}_counts"))
    bad = sorted({k for tr in turns for k in keys if tr[k] != ref[k]})
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s") + tuple(
            f"k15_S{S}_{u}" for S in K15_SIZES for u in ("ms", "device_us"))} for tr in turns],
        "equal": not bad, "differ": bad,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows if not r["same"]],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {bad}", file=sys.stderr)
        return 1
    return 0


def front_summary(turns: list, rows: list, out: Path, t0: float) -> int:
    """`--only front`: kernels 6 and 17's outputs and the int8 and bf16
    engines' blobs and launch counts required equal across every turn;
    their times per turn; the shared sources' SASS, kernels only this tree
    builds apart."""
    ref = turns[0]
    timed = tuple(f"k6_S{S}" for S in FRONT_SIZES) + tuple(
        f"k17_S{S}" for S in FRONT_SIZES) + ("k17s7_S256",)
    keys = tuple(f"{k}_sha" for k in timed) + tuple(
        k for e in FRONT_ENGINES for k in (f"blob_{e}_sha", f"{e}_counts"))
    bad = sorted({k for tr in turns for k in keys if tr[k] != ref[k]})
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s") + tuple(
            f"{n}_{u}" for n in timed for u in ("ms", "device_us"))} for tr in turns],
        "equal": not bad, "differ": bad,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows
                         if not r["same"] and r["insns"][0] is not None],
        "sass_new": [f"{r['source']} {r['kernel']}" for r in rows if r["insns"][0] is None],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {bad}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other tree (e.g. the parent commit)")
    ap.add_argument("--out", type=Path, default=TREE / "build" / "parent_ab")
    ap.add_argument("--sass", action="store_true", help="also sass_diff the shared sources")
    ap.add_argument("--only", default="", choices=("", "k9", "tp", "k14", "k11", "k15", "front"),
                    help="k9: kernel 9 and the 16,383-token engines alone; tp: the "
                         "tensor-parallel kernels 18-21 and engines alone; k14: kernels 13 "
                         "and 14 and the wide int8 engine alone; k11: kernels 11 and 22 alone; "
                         "k15: kernel 15 and the int8 engines alone; front: kernels 6 and 17 "
                         "and the int8 and bf16 engines alone")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--npz", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.npz, args.only)
        return 0
    if args.other is None:
        ap.error("--other is required")
    other = args.other.resolve()
    args.out = args.out.resolve()  # the turns run from their own trees
    args.out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    turns = []
    for i, (label, root) in enumerate((("other", other), ("this", TREE), ("this", TREE),
                                       ("other", other))):
        turns.append(dict(run_turn(i, label, root, args.out, args.only), label=label))
    rows = sass(other) if args.sass else []
    ref = turns[0]
    if args.only == "k9":
        return k9_summary(turns, rows, args.out, t0)
    if args.only == "tp":
        return tp_summary(turns, rows, args.out, t0)
    if args.only == "k14":
        return k14_summary(turns, rows, args.out, t0)
    if args.only == "k11":
        return k11_summary(turns, rows, args.out, t0)
    if args.only == "k15":
        return k15_summary(turns, rows, args.out, t0)
    if args.only == "front":
        return front_summary(turns, rows, args.out, t0)
    equal_keys = ("k2_S256_sha", "k2_S2048_sha", "k3_S256_sha", "k3_S2048_sha", "k7_sha",
                  "k7_gated_sha", "blob_sha") + tuple(f"k{n}_S{S}_sha" for n in (1, 5, 16)
                                                      for S in FBANK_SIZES) + EQUAL_KEYS
    bad = [k for tr in turns for k in equal_keys if tr[k] != ref[k]]
    # kernel 10 changes between the trees, not between two turns of one tree
    float_keys = [f"k10_{p}_S{S}_sha" for p in FLOATS for S in (256, 2048)]
    for label in ("other", "this"):
        mine = [tr for tr in turns if tr["label"] == label]
        bad += [f"{k} ({label})" for k in float_keys if any(tr[k] != mine[0][k] for tr in mine)]
    from april_asr_tpu_torch.testing import near_tie

    floats = {}
    for p, seed in FLOAT_RUNS:
        name = _run_name(p, seed)
        try:
            parted, over = float_partings(args.out, turns, name, p)
        except AssertionError as e:
            bad.append(f"{name} engine: {e}")
            parted, over = {}, {}
        bad += [f"{name} engine: turn {i} session {s} parted at margin {parted[i][s][2]:.4f} "
                f">= {near_tie(p)}" for i, ss in over.items() for s in ss]
        floats[name] = [{"blobs_equal": tr[f"blob_{name}_sha"] == ref[f"blob_{name}_sha"],
                         "sessions_parted": len(parted.get(i, {})),
                         "largest_margin": max((m for _, _, m in parted.get(i, {}).values()),
                                               default=None)}
                        for i, tr in enumerate(turns[1:], 1)]
        print(f"{name} engine against turn 0, by turn: {floats[name]}; partings (session: call, "
              f"cell, margin): {parted}", flush=True)
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s", "k1_S256_ms", "k1_S2048_ms",
                                      "k1_S256_device_us", "k1_S2048_device_us", "k5_S256_ms",
                                      "k5_S2048_ms", "k5_S256_device_us", "k5_S2048_device_us",
                                      "k16_S256_ms", "k16_S2048_ms", "k16_S256_device_us",
                                      "k16_S2048_device_us",
                                      "k2_S256_ms", "k2_S2048_ms", "k3_S256_ms",
                                      "k3_S2048_ms", "k7_ms", "k12_f32_ms", "k12_bf16_ms",
                                      "k10_f32_S256_ms", "k10_f32_S2048_ms", "k10_bf16_S256_ms",
                                      "k10_bf16_S2048_ms")
                   + tuple(f"k4_{p}_S{S}_{u}" for p in FLOATS for S in K4_SIZES
                           for u in ("ms", "device_us"))
                   + tuple(f"k8_{p}_S{S}_{u}" for p in FLOATS for S in K8_SIZES
                           for u in ("ms", "device_us"))
                   + tuple(f"k9_{p}_S{S}_{u}" for p in FLOATS for S in K9_SIZES
                           for u in ("ms", "queued_us", "device_us", "host_us"))
                   + ENGINE_MS_KEYS}
                  for tr in turns],
        "equal": not bad, "differ": sorted(set(bad)), "blob_calls": len(ref["blob_sha"]),
        "floats": floats,
        "sass_differs": [f"{r['source']} {r['kernel']}" for r in rows if not r["same"]],
        "card": ref["card"], "seconds": time.perf_counter() - t0,
    }
    (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"parent_ab: outputs differ between the trees: {sorted(set(bad))}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
