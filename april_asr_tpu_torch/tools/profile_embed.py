"""Where kernel 16's (or with `--front`, kernel 17's) time goes: the phases
of one call of csrc/conv_embed_tile.cu from each block's phase clock (the
global nanosecond timer), beside the CUDA-core kernel it displaces
(`conv_embed_simt`, or `conv_embed_front_simt`).

    python -m april_asr_tpu_torch.tools.profile_embed [--S 256] [--P 27] [--front]

On the flagship geometry's embed weights (`TransducerDims` defaults: mel 80,
segment 9, step 4, conv channels (8, 32, 32), d 512; drawn from a seed, the
conv and projection weights cast to bf16, as int8 and bf16 serving hold
them) and a front buffer drawn from a numpy seed, it launches the kernel on
its plan once with stamps and prints, per conv-stack block, the nanoseconds
of each phase summed over the block's groups: `staging` (the weights
widened once a block, each group's window rows staged; kernel 17's with
the rows above and below), `conv1` (kernel 17's with its edge rows'
corrections), `conv2` and `conv3` (each with its DoubleSwish and stores, up
to the block barrier
that ends it), as the blocks' median and maximum; per projection tile its
`projection` time (the ring's waits included); and each launch's span (the
first block's start to the last block's end). The phase clock adds no
barrier: the conv stack's phases end at block barriers anyway. Beside it,
without stamps: the CUDA-event time of one call, the device time of each
launch (torch.profiler) and the host's time per call, and the CUDA-event
and device time of the CUDA-core kernel on the same inputs. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch

# the conv stack's phase clock slots (csrc/conv_embed_tile.cu `phase_end`):
# 0 start, then the phases' nanoseconds, slot 5 the projection's, then the end
PHASES = ("staging", "conv1", "conv2", "conv3")
STACK_KEYS, PROJ_KEYS, SIMT_KEYS = ("conv_stack_kernel",), ("conv_proj_kernel",), ("conv_embed_kernel",)
FRONT_KEYS = ("conv_front_kernel",)


def embed_case(S: int, P: int, device, seed: int = 0) -> tuple:
    """(weights, front, geometry): the flagship geometry's embed weights
    (the conv and projection weights bf16) and a [S, W, mel] front buffer of
    log-mel-like rows, from `seed`."""
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE

    dims = dataclasses.replace(TM.TransducerDims(), layers=1)
    p = TM.init_transducer_params(seed, dims)
    w = {k: p[k].to(device, torch.bfloat16 if k in CE.EMBED_KEYS else p[k].dtype)
         for k in CE.EMBED_KEYS + CE._BIAS_KEYS}
    seg, step, mel = dims.segment_size, dims.segment_step, dims.mel
    W = (P - 1) * step + seg
    rng = np.random.default_rng(seed)
    front = torch.from_numpy((rng.normal(size=(S, W, mel)) * 2.0 - 6.0).astype(np.float32))
    return w, front.to(device), (seg, step, mel)


def profile(S: int, P: int, device, seed: int = 0, front: bool = False) -> dict:
    """Kernel 16 (or 17, `front`): {"plan", "span_us", "proj_span_us",
    "block_us", "phases", "event_ms", "device_us", "stack_us", "proj_us",
    "host_us", "simt_event_ms", "simt_device_us"}."""
    from april_asr_tpu_torch.ops import conv_embed_kernels as CE

    from .profile_lstm_mma import event_ms, host_and_device_us

    w, x, (seg, step, mel) = embed_case(S, P, device, seed)
    plan = CE.embed_plan_for(w, S, P, mel, seg, front)
    if plan is None:
        raise ValueError(f"kernel {17 if front else 16} has no plan at S={S}, P={P}")
    run = lambda st: CE.conv_embed_tile(w, x, P=P, step=step, seg=seg, plan=plan,  # noqa: E731
                                        stamps=st, from_front=front)
    simt_entry = CE.conv_embed_front_simt if front else CE.conv_embed_simt
    simt = lambda: simt_entry(w, x, P=P, step=step, seg=seg)  # noqa: E731
    stack = FRONT_KEYS if front else STACK_KEYS
    res = {"plan": plan, "event_ms": event_ms(lambda: run(None)),
           "simt_event_ms": event_ms(simt, reps=5)}
    res["host_us"], res["device_us"] = host_and_device_us(lambda: run(None),
                                                          keys=stack + PROJ_KEYS)
    _, res["stack_us"] = host_and_device_us(lambda: run(None), n=3, keys=stack)
    _, res["proj_us"] = host_and_device_us(lambda: run(None), n=3, keys=PROJ_KEYS)
    _, res["simt_device_us"] = host_and_device_us(simt, n=3, keys=SIMT_KEYS)
    st = torch.zeros((plan.blocks + plan.mtiles * plan.ntiles, CE.CE_NSTAMP), dtype=torch.int64,
                     device=device)
    run(st)
    st.zero_()
    run(st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    conv, proj = s[:plan.blocks], s[plan.blocks:]
    res["span_us"] = float(conv[:, -1].max() - conv[:, 0].min()) / 1e3
    res["proj_span_us"] = float(proj[:, -1].max() - proj[:, 0].min()) / 1e3
    res["block_us"] = float(np.median(conv[:, -1] - conv[:, 0])) / 1e3
    cols = [(name, conv[:, 1 + i]) for i, name in enumerate(PHASES)] + [("projection", proj[:, 5])]
    res["phases"] = {name: {"median_us": float(np.median(v)) / 1e3, "max_us": float(v.max()) / 1e3}
                     for name, v in cols}
    return res


def report(r: Dict, S: int, P: int, card: str = "", front: bool = False) -> None:
    p = r["plan"]
    parts = "; ".join(f"{k} {v['median_us']:.1f} us (max {v['max_us']:.1f})"
                      for k, v in r["phases"].items())
    which = "kernel 17" if front else "kernel 16"
    simt = "conv_embed_front_simt" if front else "conv_embed_simt"
    print(f"profile_embed {which} S={S} P={P}: conv stack {p.blocks} blocks over {p.groups} groups of "
          f"{p.nw} windows, {p.smem} bytes of shared memory a block; projection "
          f"{p.mtiles} x {p.ntiles} tiles; stamped conv-stack launch {r['span_us']:.1f} us (a "
          f"block's median {r['block_us']:.1f} us), projection launch {r['proj_span_us']:.1f} "
          f"us; without stamps: CUDA events {r['event_ms'] * 1e3:.1f} us a call, device time "
          f"(profiler) {r['device_us']:.1f} us (conv stack {r['stack_us']:.1f}, projection "
          f"{r['proj_us']:.1f}), host per call queued {r['host_us']:.1f} us; {simt}: "
          f"CUDA events {r['simt_event_ms'] * 1e3:.1f} us, device time "
          f"{r['simt_device_us']:.1f} us; by phase (blocks' median): {parts}"
          + (f" ({card})" if card else ""))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--P", type=int, default=27)
    ap.add_argument("--front", action="store_true", help="kernel 17 (the front's conv1) and its template")
    args = ap.parse_args(argv)
    r = profile(args.S, args.P, torch.device("cuda"), front=args.front)
    report(r, args.S, args.P, front=args.front)
    return r


if __name__ == "__main__":
    main()
