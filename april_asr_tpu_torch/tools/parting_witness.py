"""Where two bf16 sum orders of the float chunk layer part, which side a
plain reference takes.

    python -m april_asr_tpu_torch.tools.parting_witness [--seeds 0,1,2] \
        [--ticks 10] [--out build/parting_witness.json]

On the flagship random model of each seed (`chip_smoke.flagship_april`),
served at bf16, one engine runs S = 256 sessions over parent_ab's tone
audio (`--ticks` ticks and a flush) with its decode on the plain versions,
so that `DecisionMargins` records every decision's margin. It runs three
times, the encoder's float layers on:

* kernel: kernel 10 (`lstm_layer_chunk_fused`) and kernel 12
  (`lstm_layer_fused`), as served;
* simt: the kept two-kernel chunk layer that kernel 10 replaced
  (`lstm_layer_chunk_simt`, its code unchanged) and kernel 12;
* plain: the plain versions of both (`lstm_layer_chunk_plain`,
  `lstm_layer_fused_plain`) on the card: bf16-rounded operands, f32
  products summed by cuBLAS.

For each pair of runs it counts the sessions that part
(`testing.check_parting` at bf16, partings at or above `NEAR_TIE_BF16`
listed, not raised) and the largest difference of the two runs' margins
over the decisions that both took in step: how far two sum orders move a logit gap
before any decision parts. For each session where kernel and simt part,
it says which of them the plain run follows to the end (or neither, with
its own first parting from each), with the three runs' margins at the
cell where kernel and simt part. Prints one JSON object and writes it to
`--out` after each seed. Needs a CUDA device (and nvcc).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
RUNS = ("kernel", "simt", "plain")
PAIRS = (("kernel", "simt"), ("plain", "kernel"), ("plain", "simt"))


def layers(run: str) -> tuple:
    """The (chunk layer, one-step layer) functions of a run."""
    from april_asr_tpu_torch.ops import lstm_float_kernels as LF

    return {"kernel": (LF.lstm_layer_chunk_fused, LF.lstm_layer_fused),
            "simt": (LF.lstm_layer_chunk_simt, LF.lstm_layer_fused),
            "plain": (LF.lstm_layer_chunk_plain, LF.lstm_layer_fused_plain)}[run]


def engine(rt, audio, run: str) -> dict:
    """parent_ab's plain-decode engine run, the encoder's layers on `run`'s."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.tools.parent_ab import plain_decode_run

    orig = (TM.lstm_layer_chunk_fused, TM.lstm_layer_fused)
    TM.lstm_layer_chunk_fused, TM.lstm_layer_fused = layers(run)
    try:
        return plain_decode_run(rt, audio)
    finally:
        TM.lstm_layer_chunk_fused, TM.lstm_layer_fused = orig


def partings(a: dict, b: dict, precision: str | None = None) -> tuple:
    """Sessions of `b` that part from `a`: {session: (call, cell, margin in
    a)}, the sessions among them at or above `testing.near_tie(precision)`,
    and the largest |margin a - margin b| over the calls each session spent
    wholly in step."""
    import numpy as np

    from april_asr_tpu_torch.testing import check_parting

    parted, over, gap = {}, [], 0.0
    for k in range(len(a["events"])):
        check_parting(k, a["events"][k], b["events"][k], a["cells"][k], a["recs"][k],
                      b["recs"][k], a["dec"][k], b["dec"][k], parted, over, precision)
        live = [s for s in range(a["cells"][k].shape[1]) if s not in parted]
        ca, cb = a["cells"][k][:, live], b["cells"][k][:, live]
        both = np.isfinite(ca) & np.isfinite(cb)
        if both.any():
            gap = max(gap, float(np.abs(ca[both] - cb[both]).max()))
    return parted, over, gap


def same_events(a: dict, b: dict, s: int) -> bool:
    import numpy as np

    from april_asr_tpu_torch.testing import EVENT_FIELDS

    return all(np.array_equal(np.asarray(ea[f][s]), np.asarray(eb[f][s]))
               for ea, eb in zip(a["events"], b["events"]) for f in EVENT_FIELDS)


def witness(seed: int, ticks: int, tmp: str) -> dict:
    import numpy as np

    import chip_smoke as CS
    from april_asr_tpu_torch.api import Model

    path = CS.flagship_april(tmp, seed=seed)
    rt = Model(path, precision="bf16", device="cuda").runtime
    bufs = CS._tone_bufs(CS.S_FLAG, CS.CHUNK_1S, rt.sample_rate)
    audio = np.stack([bufs[k % len(bufs)] for k in range(ticks)])
    runs = {}
    for run in RUNS:
        t0 = time.perf_counter()
        runs[run] = engine(rt, audio, run)
        print(f"seed {seed} {run}: {ticks} ticks + flush in {time.perf_counter() - t0:.1f} s",
              flush=True)
    out = {"seed": seed, "sessions": int(audio.shape[1]), "ticks": ticks, "pairs": {}}
    found = {}
    for a, b in PAIRS:
        parted, over, gap = partings(runs[a], runs[b], "bf16")
        found[(a, b)] = parted
        out["pairs"][f"{a}-{b}"] = {
            "sessions_parted": len(parted), "over_near_tie": sorted(over),
            "largest_parting_margin": max((m for _, _, m in parted.values()), default=None),
            "largest_in_step_margin_gap": gap}
    sides = {}
    for s, (k, cell, m) in sorted(found[("kernel", "simt")].items()):
        follows = [r for r in ("kernel", "simt") if same_events(runs["plain"], runs[r], s)]
        sides[s] = {
            "call": k, "cell": cell, "follows": follows[0] if follows else "neither",
            "margins": {r: float(runs[r]["cells"][k][cell, s]) for r in RUNS},
            "plain_parts_from": {r: found[("plain", r)].get(s) for r in ("kernel", "simt")}}
    out["kernel_simt_partings"] = {str(s): v for s, v in sides.items()}
    out["plain_follows"] = {r: sum(v["follows"] == r for v in sides.values())
                            for r in ("kernel", "simt", "neither")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--out", type=Path, default=TREE / "build" / "parting_witness.json")
    args = ap.parse_args(argv)
    import tempfile

    import torch

    sys.path.insert(0, str(TREE))
    import chip_smoke as CS
    from april_asr_tpu_torch.ops import cuda_build

    torch.cuda.set_device(0)
    cuda_build.build_all()
    res = {"card": CS.card_line(), "seeds": []}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as tmp:
            res["seeds"].append(witness(seed, args.ticks, tmp))
        args.out.write_text(json.dumps(res, indent=1))
        print(json.dumps(res["seeds"][-1]), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
