"""Where the time of the persistent layer kernels 2, 7, 12 and 10 goes: the
phases and grid barriers of one launch, from each block's phase stamps
(csrc/lstm_mma.cuh `Stamps`, the global nanosecond timer).

    python -m april_asr_tpu_torch.tools.profile_lstm_mma [--S 256] [--P 27]

On the flagship int8 serving weights (`profile_chunk_split.build`, layer 0)
and numpy seed inputs, it launches kernel 2 (P steps) and kernel 7 once
each with stamps, then kernel 12 (csrc/lstm_mma_float.cu) and kernel 10
(csrc/lstm_chunk_mma.cu, P steps) once each on f32 and once on bf16
flagship-width weights drawn from a numpy seed, and prints,
per phase kind summed over the launch, the critical path (from the last
block's arrival at the phase's start to the last block's arrival at its
end), the blocks' median time in the phase, and the grid barriers (from
the last block's arrival to the last block's exit). The stamps add a
block barrier at each phase boundary; beside them, without stamps: the
CUDA-event time of one call, the kernel's device time (torch.profiler) and
the host's time per call queued without a synchronize. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import lstm_transducer as TM
from ..ops import lstm_float_kernels as LF
from ..ops import lstm_kernels as LK
from ..ops import lstm_mma as LM
from . import profile_chunk_split as PCS

# (phase, start stamp, end stamp) offsets of one step of kernel 2 (stamps
# 3 + 8 t ..) and of kernel 7's one launch; a barrier is (end, next start)
REC_STEP = (("gates", -1, 0), ("barrier", 0, 1), ("hcq", 1, 2), ("barrier", 2, 3),
            ("projection", 3, 4), ("barrier", 4, 5), ("hq", 5, 6), ("barrier", 6, 7))
STEP = (("stage + rowq8 x, h", 0, 1), ("barrier", 1, 2), ("gates", 2, 3), ("barrier", 3, 4),
        ("hcq", 4, 5), ("barrier", 5, 6), ("projection", 6, 7), ("barrier", 7, 8), ("yq", 8, 9),
        ("barrier", 9, 10), ("ff1", 10, 11), ("barrier", 11, 12), ("mq", 12, 13),
        ("barrier", 13, 14), ("ff2", 14, 15), ("barrier", 15, 16), ("norm", 16, 17))
# kernel 12's one launch: four phases of tile items and the norm
STEP12 = (("gates", 0, 1), ("barrier", 1, 2), ("projection", 2, 3), ("barrier", 3, 4),
          ("ff1", 4, 5), ("barrier", 5, 6), ("ff2", 6, 7), ("barrier", 7, 8), ("norm", 8, 9))


def chunk_phases(P: int) -> List[Tuple[str, int, int]]:
    """Kernel 10's one launch: per step the gates and the projection (stamps
    4 t ..), then ff1, ff2 and the norm over the P * S rows."""
    out = []
    for t in range(P):
        k = 4 * t
        out += [("gates", k, k + 1), ("barrier", k + 1, k + 2), ("projection", k + 2, k + 3),
                ("barrier", k + 3, k + 4)]
    k = 4 * P
    return out + [("ff1", k, k + 1), ("barrier", k + 1, k + 2), ("ff2", k + 2, k + 3),
                  ("barrier", k + 3, k + 4), ("norm", k + 4, k + 5)]


def breakdown(stamps: np.ndarray, phases: List[Tuple[str, int, int]]) -> Dict[str, dict]:
    """{phase: {"critical_us", "median_us", "n"}} from stamps [nb, n] (ns),
    summed over the phases of one name."""
    last = stamps.max(axis=0).astype(np.float64)
    out: Dict[str, dict] = {}
    for name, a, b in phases:
        r = out.setdefault(name, {"critical_us": 0.0, "median_us": 0.0, "n": 0})
        r["critical_us"] += (last[b] - last[a]) / 1e3
        r["median_us"] += float(np.median(stamps[:, b] - stamps[:, a])) / 1e3
        r["n"] += 1
    return out


def rec_phases(P: int) -> List[Tuple[str, int, int]]:
    out = [("stage + rowq8 x, h0", 0, 1), ("barrier", 1, 2)]
    for t in range(P):
        k0 = 3 + 8 * t
        for name, a, b in REC_STEP[: 5 if t == P - 1 else 8]:
            out.append((name, k0 + a, k0 + b))
    return out


def event_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call of `fn`, after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def float_layer(d: int, H: int, F: int, wd, device, seed: int = 4) -> tuple:
    """Kernel 12's weights (`TM.STEP_KEYS` order) of type wd, drawn from a
    numpy seed with unit-scale rows."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=wd: torch.from_numpy(a.astype(np.float32)).to(device, dt)  # noqa: E731
    w = lambda k, n: t(rng.normal(size=(k, n)) / np.sqrt(k))  # noqa: E731
    b = lambda n: t(rng.normal(size=n) * 0.3)  # noqa: E731
    return (w(d, 4 * H), w(d, 4 * H), b(4 * H), w(H, d), w(d, F), b(F), w(F, d), b(d),
            t(np.float32([0.25]), torch.float32))


def profile(S: int, P: int, device) -> Dict[str, dict]:
    """Kernel 2 at (S, P), kernel 7 and kernel 12 (f32 and bf16) at S,
    kernel 10 (f32 and bf16) at (S, P):
    {kernel: {"total_us", "event_ms", "phases", "blocks", "smem"}}."""
    params = PCS.build(S, P, TM.TransducerDims(), device)[0]
    layer = tuple(params[k][0] for k in LK.LAYER_I8_KEYS)
    d, H, F = layer[0].shape[0], layer[0].shape[1] // 4, layer[7].shape[1]
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    n = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    f32, bf16 = (float_layer(d, H, F, wd, device) for wd in (torch.float32, torch.bfloat16))
    out = {}
    for name, plan, nstamp, last, run, phases in (
        ("kernel 2", LM.device_plan(S, d, H, 0, device), 3 + 8 * P, 8 * P - 1,
         lambda st: LK._rec_mma_cuda(x, h, c, n, *layer[:7], stamps=st), rec_phases(P)),
        ("kernel 7", LM.device_plan(S, d, H, F, device), 18, 17,
         lambda st: LK.lstm_layer_fused_i8_cuda(x[0], h, c, *layer, stamps=st), STEP),
        ("kernel 12 f32", LM.device_float_plan(S, d, H, F, 4, device), 10, 9,
         lambda st: LF.lstm_layer_fused_cuda(x[0], h, c, *f32, stamps=st), STEP12),
        ("kernel 12 bf16", LM.device_float_plan(S, d, H, F, 2, device), 10, 9,
         lambda st: LF.lstm_layer_fused_cuda(x[0], h, c, *bf16, stamps=st), STEP12),
        ("kernel 10 f32", LM.device_chunk_plan(S, P, d, H, F, 4, device), 4 * P + 6, 4 * P + 5,
         lambda st: LF.lstm_layer_chunk_cuda(x, h, c, *f32, n, stamps=st), chunk_phases(P)),
        ("kernel 10 bf16", LM.device_chunk_plan(S, P, d, H, F, 2, device), 4 * P + 6, 4 * P + 5,
         lambda st: LF.lstm_layer_chunk_cuda(x, h, c, *bf16, n, stamps=st), chunk_phases(P)),
    ):
        ms = event_ms(lambda: run(None))
        host_us, device_us = host_and_device_us(lambda: run(None))
        st = torch.zeros((plan.nb, nstamp), dtype=torch.int64, device=device)
        run(st)
        run(st)
        torch.cuda.synchronize()
        s = st.cpu().numpy()
        out[name] = {"total_us": float(s[:, last].max() - s[:, 0].min()) / 1e3, "event_ms": ms,
                     "host_us": host_us, "device_us": device_us,
                     "phases": breakdown(s, phases), "blocks": plan.nb, "smem": plan.smem}
    return out


def host_and_device_us(fn, n: int = 50) -> Tuple[float, float]:
    """The host's time per call of `fn` over n calls queued without a
    synchronize (its enqueue cost where that exceeds the device's), and the
    device time per call of its mma kernel from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages() if "mma_kernel" in e.key)
    return host, dev / 5


def report(res: Dict[str, dict], S: int, P: int, card: str = "") -> None:
    for name, r in res.items():
        parts = "; ".join(f"{k} {v['critical_us']:.1f} us (x{v['n']}, blocks' median "
                          f"{v['median_us']:.1f})" for k, v in r["phases"].items())
        shape = f"S={S} P={P}" if name.startswith(("kernel 2", "kernel 10")) else f"S={S}"
        print(f"profile_lstm_mma {name} {shape}: {r['blocks']} blocks, {r['smem']} bytes of shared "
              f"memory; stamped launch {r['total_us']:.1f} us; without stamps: CUDA events "
              f"{r['event_ms'] * 1e3:.1f} us a call, the kernel's device time (profiler) "
              f"{r['device_us']:.1f} us, the host's per call queued {r['host_us']:.1f} us; "
              f"critical path by phase: {parts}"
              + (f" ({card})" if card else ""))


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--P", type=int, default=27)
    args = ap.parse_args(argv)
    res = profile(args.S, args.P, torch.device("cuda"))
    report(res, args.S, args.P)
    return res


if __name__ == "__main__":
    main()
