"""This tree's port against another tree's (a parent commit unpacked beside
it, e.g. with `git archive`) on one card, in turns: other, this, this,
other.

    python -m april_asr_tpu_torch.tools.parent_ab --other build/parent \
        [--out build/parent_ab] [--sass]

Each turn is a worker process that imports `april_asr_tpu_torch` and
`chip_smoke.py` from one tree (its kernels built into that tree's build
directory) and, on the flagship random int8 model (seed 0):

* times kernel 2 (`lstm_layer_chunk_rec_stream2_i8`, layer 0) at S = 256
  and at S = 2048, P = 27, and kernel 7 (`lstm_layer_fused_i8`) at S = 256,
  on numpy seed inputs, with the SHA-1 of their outputs (kernel 7 ungated
  and gated);
* runs chip_smoke's `engine` cell at int8 (10 ticks, 5 flushes, the step
  and flush programs, the profiler's step and flush), its lines relayed;
* records the int8 engine's event blobs over the same 10 ticks and a flush
  (`testing.engine_run`) into <out>/<turn>-<tree>.npz;
* then, on the same model served at f32 (as loaded) and at bf16: times
  kernel 12 (`lstm_layer_fused`, layer 0) at S = 256 and kernel 10
  (`lstm_layer_chunk_fused`, layer 0, gated) at S = 256 and 2048, P = 27,
  with the SHA-1 of their outputs (kernel 12 ungated and gated), runs the
  `engine` cell at that precision (its step ms kept), and records the
  engine's events over the same 10 ticks and a flush with the decode on its
  plain versions (kernel 4's and 8's functions), so that `DecisionMargins`
  records every decision's margin, into <out>/<turn>-<tree>-<precision>.pkl;
  at bf16 also on the random models of seeds 1 and 2
  (<turn>-<tree>-bf16-s<seed>.pkl).

The main process then requires every turn's int8 blobs and the outputs of
kernels 2, 7 and 12 to be equal, bit for bit; every session of a float
engine whose events part from the first turn's to part at a near-tie
decision (`testing.check_parting`, `testing.NEAR_TIE`; every session is
counted, and each parting at or above it listed), counted per turn
beside whether the blobs are equal (their f32 log-probabilities move by
ulps where the encoder's sums change order); and kernel 10's outputs to be
equal between the turns of one tree (it changes between the trees). It
prints the times per turn. With `--sass`, it also runs `sass_diff` on
csrc/lstm_mma.cu, lstm_i8.cu, lstm_step.cu, lstm_tp.cu and lstm_mma_float.cu
of the two trees (kernels 2, 3, 7, 12, 13, 14, 18, 19, 22 and the
three-pass float step). Needs a CUDA device (and nvcc).
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
SASS_SOURCES = ("lstm_mma.cu", "lstm_i8.cu", "lstm_step.cu", "lstm_tp.cu", "lstm_mma_float.cu")
FLOATS = ("f32", "bf16")
BF16_SEEDS = (1, 2)  # more random models for the bf16 engine's partings
# the float engines' runs compared between turns: (precision, model seed)
FLOAT_RUNS = tuple((p, 0) for p in FLOATS) + tuple(("bf16", s) for s in BF16_SEEDS)
# outputs equal between the trees as well as the turns: kernel 12's
EQUAL_KEYS = tuple(k for p in FLOATS for k in (f"k12_{p}_sha", f"k12_{p}_gated_sha"))
STEP_MS = re.compile(r"^engine (\w+): .* step_ms median=([\d.]+)")
ENGINE_KEYS = ("events", "recs", "dec", "cells", "blobs")


def _sha(t) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def worker(root: str, out: str) -> None:
    """One turn: everything measured from the tree at `root`."""
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
        rng = np.random.default_rng(7)
        x = t(rng.normal(size=(256, d)).astype(np.float32))
        h = t((rng.normal(size=(256, d)) * 0.3).astype(np.float32))
        c = t((rng.normal(size=(256, H)) * 0.3).astype(np.float32))
        gate = t(rng.random(256) < 0.5)
        res["k7_sha"] = [_sha(o) for o in LK.lstm_layer_fused_i8(x, h, c, *sa)]
        res["k7_gated_sha"] = [_sha(o) for o in LK.lstm_layer_fused_i8(x, h, c, *sa, gate)]
        res["k7_ms"] = CS.cuda_ms(lambda: LK.lstm_layer_fused_i8(x, h, c, *sa), 20)
        print(f"kernels: k2 S=256 {res['k2_S256_ms']:.4f} ms, S=2048 {res['k2_S2048_ms']:.4f} ms, "
              f"k7 S=256 {res['k7_ms']:.4f} ms ({card})", flush=True)
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
        CS.phase_engine(model, card, prec)
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


def run_turn(i: int, label: str, root: Path, out_dir: Path) -> dict:
    out = out_dir / f"{i}-{label}.npz"
    cmd = [sys.executable, str(HERE), "--worker", str(root), "--npz", str(out)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(root))
    res, step_ms = None, {}
    for line in proc.stdout:
        if line.startswith(TAG):
            res = json.loads(line[len(TAG):])
        else:
            m = STEP_MS.match(line)
            if m:
                step_ms[m.group(1)] = float(m.group(2))
            print(f"[{i} {label}] {line.rstrip()}", flush=True)
    if proc.wait() != 0 or res is None:
        raise RuntimeError(f"turn {i} ({label}, {root}) failed with exit code {proc.returncode}")
    return dict(res, step_ms=step_ms)


def sass(other: Path) -> list:
    from april_asr_tpu_torch.tools import sass_diff

    rows = []
    for src in SASS_SOURCES:
        a = other / "april_asr_tpu_torch" / "csrc" / src
        b = TREE / "april_asr_tpu_torch" / "csrc" / src
        with tempfile.TemporaryDirectory() as da, tempfile.TemporaryDirectory() as db:
            found = sass_diff.compare(sass_diff.build(a, Path(da)), sass_diff.build(b, Path(db)))
        for r in found:
            print(f"sass {src} {r['kernel'][:48]}: registers {r['regs'][0]} -> {r['regs'][1]}, "
                  f"instructions {r['insns'][0]} -> {r['insns'][1]}, "
                  f"SASS {'same' if r['same'] else 'differs'}", flush=True)
        rows += [dict(r, source=src) for r in found]
    return rows


def float_partings(out_dir: Path, turns: list, name: str) -> tuple:
    """Sessions of each turn's plain-decode float engine run `name` (a
    precision, with "-s<seed>" for another model) that part from the first
    turn's, by `testing.check_parting`: {turn: {session: (call, cell,
    margin)}}, and {turn: [sessions that parted at or above NEAR_TIE]}."""
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
                          run["recs"][k], ref["dec"][k], run["dec"][k], parted, over[i])
        found[i] = parted
    return found, over


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other tree (e.g. the parent commit)")
    ap.add_argument("--out", type=Path, default=TREE / "build" / "parent_ab")
    ap.add_argument("--sass", action="store_true", help="also sass_diff the shared sources")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--npz", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.npz)
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
        turns.append(dict(run_turn(i, label, root, args.out), label=label))
    rows = sass(other) if args.sass else []
    ref = turns[0]
    bad = [k for tr in turns for k in ("k2_S256_sha", "k2_S2048_sha", "k7_sha", "k7_gated_sha",
                                       "blob_sha") + EQUAL_KEYS if tr[k] != ref[k]]
    # kernel 10 changes between the trees, not between two turns of one tree
    float_keys = [f"k10_{p}_S{S}_sha" for p in FLOATS for S in (256, 2048)]
    for label in ("other", "this"):
        mine = [tr for tr in turns if tr["label"] == label]
        bad += [f"{k} ({label})" for k in float_keys if any(tr[k] != mine[0][k] for tr in mine)]
    floats = {}
    for p, seed in FLOAT_RUNS:
        name = _run_name(p, seed)
        try:
            parted, over = float_partings(args.out, turns, name)
        except AssertionError as e:
            bad.append(f"{name} engine: {e}")
            parted, over = {}, {}
        bad += [f"{name} engine: turn {i} session {s} parted at margin {parted[i][s][2]:.4f} "
                f">= NEAR_TIE" for i, ss in over.items() for s in ss]
        floats[name] = [{"blobs_equal": tr[f"blob_{name}_sha"] == ref[f"blob_{name}_sha"],
                         "sessions_parted": len(parted.get(i, {})),
                         "largest_margin": max((m for _, _, m in parted.get(i, {}).values()),
                                               default=None)}
                        for i, tr in enumerate(turns[1:], 1)]
        print(f"{name} engine against turn 0, by turn: {floats[name]}; partings (session: call, "
              f"cell, margin): {parted}", flush=True)
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s", "k2_S256_ms", "k2_S2048_ms", "k7_ms",
                                      "k12_f32_ms", "k12_bf16_ms", "k10_f32_S256_ms",
                                      "k10_f32_S2048_ms", "k10_bf16_S256_ms", "k10_bf16_S2048_ms",
                                      "step_ms")} for tr in turns],
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
