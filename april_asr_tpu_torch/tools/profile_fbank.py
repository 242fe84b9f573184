"""Where kernel 1's time goes: the phases of one launch of
csrc/fbank_mma.cu from each block's phase clock (the global nanosecond
timer), beside the CUDA-core kernel it displaces (`fbank_i8_simt`).

    python -m april_asr_tpu_torch.tools.profile_fbank [--S 256] [--chunk 16000]

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
The phase clock adds a block barrier at each phase boundary. Beside it,
without stamps: the CUDA-event time of one call, the kernel's device time
(torch.profiler) and the host's time per call, for both kernels. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

# the phase clock's slots (csrc/fbank_mma.cu `mark`): 0 start, 1-5 the
# phases' nanoseconds, 6 end
PHASES = ("staging", "int8", "residual", "power", "mel")


def profile(S: int, chunk: int, device, rate: int = 16000, seed: int = 0) -> dict:
    """{"plan", "F", "span_us", "block_us", "phases", "event_ms", "device_us",
    "host_us", "simt_event_ms", "simt_device_us"}."""
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
    plan = FK.plan_for(c, S, F)
    if plan is None:
        raise ValueError(f"csrc/fbank_mma.cu has no plan at S={S}, F={F}")
    run = lambda st: FK.fbank_mma(c, buf, F, plan, stamps=st)  # noqa: E731
    simt = lambda: FK.fbank_i8_simt(c, buf, F)  # noqa: E731
    res = {"plan": plan, "F": F, "event_ms": event_ms(lambda: run(None)),
           "simt_event_ms": event_ms(simt, reps=5)}
    res["host_us"], res["device_us"] = host_and_device_us(lambda: run(None),
                                                          keys=("fbank_mma_kernel",))
    _, res["simt_device_us"] = host_and_device_us(simt, n=3, keys=("fbank_kernel",))
    st = torch.zeros((plan.blocks, 2 + len(PHASES)), dtype=torch.int64, device=device)
    run(st)
    st.zero_()
    run(st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    res["span_us"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
    res["block_us"] = float(np.median(s[:, -1] - s[:, 0])) / 1e3
    res["phases"] = {name: {"median_us": float(np.median(s[:, 1 + i])) / 1e3,
                            "max_us": float(s[:, 1 + i].max()) / 1e3}
                     for i, name in enumerate(PHASES)}
    return res


def report(r: Dict, S: int, card: str = "") -> None:
    from april_asr_tpu_torch.ops import fbank_kernels as FK

    p = r["plan"]
    parts = "; ".join(f"{k} {v['median_us']:.1f} us (max {v['max_us']:.1f})"
                      for k, v in r["phases"].items())
    print(f"profile_fbank kernel 1 S={S} F={r['F']}: {p.blocks} blocks of {FK.FB_M} frame rows, "
          f"{p.smem} bytes of shared memory a block, a {FK.FB_RING}-stage ring; stamped launch "
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
    args = ap.parse_args(argv)
    res = profile(args.S, args.chunk, torch.device("cuda"))
    report(res, args.S)
    return res


if __name__ == "__main__":
    main()
