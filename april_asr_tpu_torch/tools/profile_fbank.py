"""Where the fbank kernels' time goes: the phases of one launch of kernel
1 (csrc/fbank_mma.cu), of kernel 5 (csrc/fbank_bf16x3_tile.cu) and of
kernel 6 (csrc/fbank_frames_tile.cu) from each block's phase clock (the
global nanosecond timer), beside the CUDA-core kernel each displaces
(`fbank_i8_simt`, `fbank_bf16x3_simt`, `fbank_frames_simt`).

    python -m april_asr_tpu_torch.tools.profile_fbank [--S 256] [--chunk 16000] [--kernel 1,5,6]

On hop-row buffers of PCM16 values drawn from a numpy seed, at the 16 kHz
layout of `chunk`-sample chunks (F = 101 frames at 1 s), it launches the
kernel on its plan once with stamps and prints, per block, the nanoseconds
of each phase summed over the block's DFT column chunks: `staging` (the
hop rows read, split into the three sample planes), `int8` (the int8
products on the tensor cores and their fold, the table ring's waits
included), `residual` (the bf16 residual's fmaf chains on the CUDA cores,
the ring's waits included), `power` (the power split into the window) and
`mel` (the mel filters' fmaf chains, the log and the rows' writes), as the
blocks' median and maximum,
and the launch's span (the first block's start to the last block's end).
Kernel 5's phases: `staging` (the hop rows read and split into the x_hi and
x_lo planes), `dft` (the three bf16 passes' fmaf chains over both column
chunks, the table ring's waits included), `power` (the power split into its
rows) and `mel` (the mel filters' fmaf chains, the log and the rows'
writes). Kernel 6's (on frames formed from the same buffers by
`frames_from_buf`): `staging` (the wait for the rows' bulk copies), `dft`
(the f32 fmaf chains, the table ring's waits included), `power` and `mel`.
The phase clock adds a block barrier at each phase boundary.
Beside it, without stamps: the CUDA-event time of one call, the kernel's
device time (torch.profiler) and the host's time per call, for the kernel
and the CUDA-core kernel it displaces. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

# the phase clock's slots (csrc/fbank_mma.cu and csrc/fbank_bf16x3_tile.cu
# `mark`): 0 start, then the phases' nanoseconds, then the end
PHASES = ("staging", "int8", "residual", "power", "mel")
PHASES5 = ("staging", "dft", "power", "mel")


def profile(S: int, chunk: int, device, rate: int = 16000, seed: int = 0, kernel: int = 1
            ) -> dict:
    """Kernel 1, 5 or 6: {"plan", "F", "span_us", "block_us", "phases",
    "event_ms", "device_us", "host_us", "simt_event_ms", "simt_device_us"}."""
    from april_asr_tpu_torch.config import FbankOptions
    from april_asr_tpu_torch.frontend.fbank import FbankLayout
    from april_asr_tpu_torch.ops import fbank_kernels as FK

    from .profile_lstm_mma import event_ms, host_and_device_us

    layout = FbankLayout.build(FbankOptions(sample_freq=rate), chunk)
    c = FK.fbank_constants(layout, device)
    F = layout.max_frames
    rng = np.random.default_rng(seed)
    pcm = (rng.normal(0, 0.25, (S, layout.buf_len)) * 32768).clip(-32768, 32767).astype(np.int16)
    buf = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(device)
    if kernel == 1:
        plan, phases, keys = FK.plan_for(c, S, F), PHASES, ("fbank_mma_kernel", "fbank_kernel")
        run = lambda st: FK.fbank_mma(c, buf, F, plan, stamps=st)  # noqa: E731
        simt = lambda: FK.fbank_i8_simt(c, buf, F)  # noqa: E731
    elif kernel == 5:
        plan, phases = FK.bf16x3_plan_for(c, S, F), PHASES5
        keys = ("fbank_tile_kernel", "fbank_bf16x3_kernel")
        run = lambda st: FK.fbank_bf16x3_tile(c, buf, F, plan, stamps=st)  # noqa: E731
        simt = lambda: FK.fbank_bf16x3_simt(c, buf, F)  # noqa: E731
    else:
        frames = FK.frames_from_buf(layout, buf)
        plan, phases = FK.frames_plan_for(c, S, F), PHASES5
        keys = ("fbank_frames_tile_kernel", "fbank_frames_kernel")
        run = lambda st: FK.fbank_frames_tile(c, frames, plan, stamps=st)  # noqa: E731
        simt = lambda: FK.fbank_frames_simt(c, frames)  # noqa: E731
    if plan is None:
        raise ValueError(f"kernel {kernel} has no plan at S={S}, F={F}")
    res = {"plan": plan, "F": F, "event_ms": event_ms(lambda: run(None)),
           "simt_event_ms": event_ms(simt, reps=5)}
    res["host_us"], res["device_us"] = host_and_device_us(lambda: run(None), keys=keys[:1])
    _, res["simt_device_us"] = host_and_device_us(simt, n=3, keys=keys[1:])
    st = torch.zeros((plan.blocks, 2 + len(phases)), dtype=torch.int64, device=device)
    run(st)
    st.zero_()
    run(st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    res["span_us"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
    res["block_us"] = float(np.median(s[:, -1] - s[:, 0])) / 1e3
    res["phases"] = {name: {"median_us": float(np.median(s[:, 1 + i])) / 1e3,
                            "max_us": float(s[:, 1 + i].max()) / 1e3}
                     for i, name in enumerate(phases)}
    return res


def report(r: Dict, S: int, card: str = "", kernel: int = 1) -> None:
    from april_asr_tpu_torch.ops import fbank_kernels as FK

    p = r["plan"]
    parts = "; ".join(f"{k} {v['median_us']:.1f} us (max {v['max_us']:.1f})"
                      for k, v in r["phases"].items())
    if kernel == 1:
        tile, ring = f"{FK.FB_M} frame rows", FK.FB_RING
    elif kernel == 5:
        tile, ring = f"{4 * p.rows} frame rows", FK.T5_RING
    else:
        tile, ring = f"{p.tile} frame rows", FK.T6_RING
    print(f"profile_fbank kernel {kernel} S={S} F={r['F']}: {p.blocks} blocks of {tile}, "
          f"{p.smem} bytes of shared memory a block, a {ring}-stage ring; stamped launch "
          f"{r['span_us']:.1f} us, a block's median {r['block_us']:.1f} us; without stamps: CUDA "
          f"events {r['event_ms'] * 1e3:.1f} us a call, device time (profiler) "
          f"{r['device_us']:.1f} us, host per call queued {r['host_us']:.1f} us; the CUDA-core "
          f"kernel: CUDA events {r['simt_event_ms'] * 1e3:.1f} us, device time "
          f"{r['simt_device_us']:.1f} us; per block, by phase (median): {parts}"
          + (f" ({card})" if card else ""))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=16000)
    ap.add_argument("--kernel", default="1,5", help="which kernels, of 1, 5 and 6")
    args = ap.parse_args(argv)
    out = {}
    for k in (int(x) for x in args.kernel.split(",")):
        out[k] = profile(args.S, args.chunk, torch.device("cuda"), kernel=k)
        report(out[k], args.S, kernel=k)
    return out


if __name__ == "__main__":
    main()
