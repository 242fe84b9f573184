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
  (`testing.engine_run`) into <out>/<turn>-<tree>.npz.

The main process then requires every turn's blobs and kernel outputs to be
equal, bit for bit, and prints the times per turn. With `--sass`, it also
runs `sass_diff` on csrc/lstm_i8.cu, lstm_step.cu and lstm_tp.cu of the two
trees (kernels 3, 12, 13, 14, 18, 19 and 22). Needs a CUDA device (and nvcc).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TAG = "PARENT_AB "
HERE = Path(__file__).resolve()
TREE = HERE.parents[2]
SASS_SOURCES = ("lstm_i8.cu", "lstm_step.cu", "lstm_tp.cu")


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
    res["blob_sha"] = [hashlib.sha1(b.tobytes()).hexdigest()[:16] for b in blobs]
    res["card"] = card
    print(TAG + json.dumps(res), flush=True)


def run_turn(i: int, label: str, root: Path, out_dir: Path) -> dict:
    out = out_dir / f"{i}-{label}.npz"
    cmd = [sys.executable, str(HERE), "--worker", str(root), "--npz", str(out)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(root))
    res = None
    for line in proc.stdout:
        if line.startswith(TAG):
            res = json.loads(line[len(TAG):])
        else:
            print(f"[{i} {label}] {line.rstrip()}", flush=True)
    if proc.wait() != 0 or res is None:
        raise RuntimeError(f"turn {i} ({label}, {root}) failed with exit code {proc.returncode}")
    return res


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
    args.out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    turns = []
    for i, (label, root) in enumerate((("other", other), ("this", TREE), ("this", TREE),
                                       ("other", other))):
        turns.append(dict(run_turn(i, label, root, args.out), label=label))
    rows = sass(other) if args.sass else []
    ref = turns[0]
    bad = [k for tr in turns for k in ("k2_S256_sha", "k2_S2048_sha", "k7_sha", "k7_gated_sha",
                                       "blob_sha") if tr[k] != ref[k]]
    summary = {
        "turns": [{k: tr[k] for k in ("label", "build_s", "k2_S256_ms", "k2_S2048_ms", "k7_ms")}
                  for tr in turns],
        "equal": not bad, "differ": sorted(set(bad)), "blob_calls": len(ref["blob_sha"]),
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
