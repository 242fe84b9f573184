"""Where the time of the layer kernels 2, 7, 12, 10, 3, 14, 11 and 15 goes: for the
persistent kernels 2, 7, 12 and 10 the phases and grid barriers of one
launch, from each block's phase stamps (csrc/lstm_mma.cuh `Stamps`, the
global nanosecond timer); for kernel 3 (csrc/ffn_mma.cu, five launches in
stream order) each launch's device time; for kernel 14 (csrc/lstm_hoist.cu,
which kernel 13 shares) phase A's two launches by their device time and
phase B's recurrence by its blocks' stamps, as kernel 2's; for kernel 11
(csrc/lstm_hoist.cu `lstm_chunk_hoist_i8`) phase A likewise and its
cooperative launch's recurrence and FFN phases (yq, ff1, mq, ff2, norm and
their barriers) by its blocks' stamps; for kernel 15
(csrc/lstm_wavefront_hoist.cu, one cooperative launch a slab) its phases
(gates, hcq, projection, yq, ff1, mq, ff2, the norm and the next rows, and
their barriers) summed over the diagonals by its blocks' stamps, and the
gate phase a diagonal by its count of live layers, beside its
template's time.

    python -m april_asr_tpu_torch.tools.profile_lstm_mma [--S 256] [--P 27] [--wide] \
        [--ub 8,16,32] [--slab 6]

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
the host's time per call queued without a synchronize. Kernel 3 runs over
the P * S rows of the same layer: the whole call by CUDA events and each of
its launches (yq, ff1, mq, ff2, norm) by its device time in the profiler.
Kernel 14 runs on the same layer as kernel 2 (its stamps in kernel 2's
layout: h0's quantization, then per step gates, hcq, projection, hq and
their barriers); with --wide also on a one-layer int8 model at d 1024 / H
4096 / F 8192 (the widths phase's `WIDE`, where kernel 2 has no plan),
weights from `init_transducer_params` seed 0. With --ub, kernel 14 again on
each gate-item width named where its plan fits (`rec_hoist_plan(...,
units=(ub,))`), its outputs required equal to the default plan's bit for
bit.
Needs a CUDA device.
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


def rec_phases(P: int, first: str = "stage + rowq8 x, h0") -> List[Tuple[str, int, int]]:
    """Kernel 2's stamps (and kernel 14's phase B, whose first phase is
    `first`): the start, then per step REC_STEP."""
    out = [(first, 0, 1), ("barrier", 1, 2)]
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


# kernel 14's launches by the names the profiler gives their device kernels
HOIST_PASSES = (("phase A: rowq8 x", "hoist_xq_kernel"), ("phase A: gx tiles", "hoist_gx_kernel"),
                ("phase B: recurrence", "lstm_rec_hoist_kernel"))
WIDE = TM.TransducerDims(d_model=1024, hidden=4096, ffn=8192, layers=1)


def profile_hoist(S: int, P: int, device, dims: TM.TransducerDims = TM.TransducerDims(),
                  n: int = 3, ub: int = 0) -> dict:
    """Kernel 14 on layer 0 of the int8 serving weights at `dims` (numpy
    seed inputs, gated): phase B's per-block stamps (`rec_phases`), each
    launch's device time (torch.profiler over n calls), the CUDA-event time
    of a call, the host's time a call queued, the plan and the scratch:
    {"total_us", "event_ms", "host_us", "device_us", "phases", "launches",
    "blocks", "ub", "smem", "scratch"}. With `ub`, on the plan of that
    gate-item width alone, its outputs held bit for bit to the default
    plan's (ValueError where it has no plan)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    params = PCS.build(S, P, dims, device)[0]
    layer = tuple(params[k][0] for k in LK.LAYER_I8_KEYS[:7])
    d, H = dims.d_model, dims.hidden
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    nn = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    plan = (LM.rec_hoist_plan(S, d, H, LM.device_sm(device), units=(ub,)) if ub
            else LM.device_hoist_plan(S, d, H, device))
    run = lambda st=None: LK._rec_hoist_cuda("lstm_rec_stream_i8", x, h, c, nn, *layer,  # noqa: E731
                                             plan=plan, stamps=st)
    if ub:
        want = LK._rec_hoist_cuda("lstm_rec_stream_i8", x, h, c, nn, *layer)
        if not all(torch.equal(a, b) for a, b in zip(run(), want)):
            raise AssertionError(f"kernel 14 at {ub}-unit items differs from the default plan")
    res = {"event_ms": event_ms(run, reps=5), "blocks": plan.nb, "ub": plan.ub,
           "smem": plan.smem, "scratch": LM.hoist_scratch(plan, P)[0]}
    res["host_us"], res["device_us"] = host_and_device_us(run, n=10, keys=("hoist",))
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    res["launches"] = {name: sum(e.self_device_time_total for e in rows if key in e.key) / n
                       for name, key in HOIST_PASSES}
    st = torch.zeros((plan.nb, 3 + 8 * P), dtype=torch.int64, device=device)
    run(st)
    run(st)
    torch.cuda.synchronize()
    s = st.cpu().numpy()
    res["total_us"] = float(s[:, 8 * P - 1].max() - s[:, 0].min()) / 1e3
    res["phases"] = breakdown(s, rec_phases(P, "stage + rowq8 h0"))
    return res


def report_hoist(r: dict, S: int, P: int, dims: TM.TransducerDims, card: str = "",
                 kernel: str = "kernel 14", stamped: str = "phase B") -> None:
    parts = "; ".join(f"{k} {v['critical_us']:.1f} us (x{v['n']}, blocks' median "
                      f"{v['median_us']:.1f})" for k, v in r["phases"].items())
    launches = "; ".join(f"{k} {v:.1f} us" for k, v in r["launches"].items())
    print(f"profile_lstm_mma {kernel} d={dims.d_model} H={dims.hidden} S={S} P={P}"
          f"{' (forced)' if r.get('forced') else ''}: "
          f"{r['blocks']} blocks of {r['ub']}-unit gate items, {r['smem']} bytes of shared memory, "
          f"{r['scratch']} bytes of scratch; CUDA events {r['event_ms'] * 1e3:.1f} us a call, its "
          f"kernels' device time (profiler) {r['device_us']:.1f} us, the host's per call queued "
          f"{r['host_us']:.1f} us; device time by launch: {launches}; {stamped} stamped "
          f"{r['total_us']:.1f} us, critical path by phase: {parts}"
          + (f" ({card})" if card else ""))


# kernel 11's launches by the names the profiler gives their device kernels
CHUNK_PASSES = (("phase A: rowq8 x", "hoist_xq_kernel"), ("phase A: gx tiles", "hoist_gx_kernel"),
                ("recurrence + FFN", "lstm_chunk_hoist_kernel"))
# kernel 11's FFN phases after phase B's stamps (3 + 8 P ..): a barrier, then
# each phase and the barrier after it
CHUNK_FFN = (("yq", 0, 1), ("barrier", 1, 2), ("ff1", 2, 3), ("barrier", 3, 4), ("mq", 4, 5),
             ("barrier", 5, 6), ("ff2", 6, 7), ("barrier", 7, 8), ("norm", 8, 9))


def chunk_hoist_phases(P: int) -> List[Tuple[str, int, int]]:
    """Kernel 11's stamps: phase B's (`rec_phases`), the barrier after its
    last projection (stamp 8 P - 1), then CHUNK_FFN from stamp 3 + 8 P."""
    k = 3 + 8 * P
    return (rec_phases(P, "stage + rowq8 h0") + [("barrier", 8 * P - 1, k)]
            + [(name, k + a, k + b) for name, a, b in CHUNK_FFN])


def profile_chunk_hoist(S: int, P: int, device, n: int = 3) -> dict:
    """Kernel 11 on layer 0 of the flagship int8 serving weights (numpy seed
    inputs, gated): its launch's per-block stamps (`chunk_hoist_phases`),
    each launch's device time (torch.profiler over n calls), the CUDA-event
    time of a call, the host's time a call queued, the plan and the
    scratch, as `profile_hoist` returns them."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    params = PCS.build(S, P, TM.TransducerDims(), device)[0]
    layer = tuple(params[k][0] for k in LK.LAYER_I8_KEYS)
    d, H, F = layer[0].shape[0], layer[5].shape[0], layer[7].shape[1]
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h = t((rng.normal(size=(S, d)) * 0.3).astype(np.float32))
    c = t((rng.normal(size=(S, H)) * 0.3).astype(np.float32))
    nn = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    plan = LM.device_chunk_hoist_plan(S, P, d, H, F, device)
    run = lambda st=None: LK._chunk_hoist_cuda(x, h, c, *layer, nn, stamps=st)  # noqa: E731
    res = {"event_ms": event_ms(run, reps=5), "blocks": plan.nb, "ub": plan.rec.ub,
           "smem": plan.smem, "scratch": plan.scratch()[0]}
    res["host_us"], res["device_us"] = host_and_device_us(run, n=10, keys=("hoist",))
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    res["launches"] = {name: sum(e.self_device_time_total for e in rows if key in e.key) / n
                       for name, key in CHUNK_PASSES}
    st = torch.zeros((plan.nb, 13 + 8 * P), dtype=torch.int64, device=device)
    run(st)
    run(st)
    torch.cuda.synchronize()
    s = st.cpu().numpy()
    res["total_us"] = float(s[:, 12 + 8 * P].max() - s[:, 0].min()) / 1e3
    res["phases"] = breakdown(s, chunk_hoist_phases(P))
    return res


# kernel 15's phases at each diagonal (stamps 3 + 16 D ..), each followed
# by a grid barrier
WAVE_DIAG = ("gates", "hcq", "projection", "yq", "ff1", "mq", "ff2", "norm + next rows")


def wavefront_phases(diagonals: int) -> List[Tuple[str, int, int]]:
    """Kernel 15's stamps: h2 / c2 copied and layer 0's first rows
    quantized, a barrier, then per diagonal WAVE_DIAG, each phase from the
    barrier before it and followed by a grid barrier."""
    out = [("copy + first rows", 0, 1), ("barrier", 1, 2)]
    for D in range(diagonals):
        k0 = 3 + LM.WF_STAMPS * D
        for j, name in enumerate(WAVE_DIAG):
            out += [(name, k0 + 2 * j - 1, k0 + 2 * j), ("barrier", k0 + 2 * j, k0 + 2 * j + 1)]
    return out


def profile_wavefront_hoist(S: int, P: int, device, Lk: int = 6) -> dict:
    """Kernel 15 (csrc/lstm_wavefront_hoist.cu) on layers 0..Lk-1 of the
    flagship int8 serving weights (numpy seed inputs, gated): its launch's
    per-block stamps summed per phase over the diagonals
    (`wavefront_phases`), the CUDA-event time and the device time
    (torch.profiler) of a call, the host's time a call queued, and the same
    times of its CUDA-core template (`lstm_wavefront_i8_simt`), and the
    gate phase's mean critical path a diagonal by its number of live layers
    ("gates_by_live"); the stamped launch's outputs are required equal to
    the template's."""
    from ..ops import lstm_wavefront_kernels as LW

    params = PCS.build(S, P, TM.TransducerDims(), device)[0]
    slab = tuple(params[k][:Lk] for k in LK.LAYER_I8_KEYS)
    d, H, F = slab[0].shape[1], slab[5].shape[1], slab[7].shape[2]
    rng = np.random.default_rng(8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    x = t(rng.normal(size=(P, S, d)).astype(np.float32))
    h = t((rng.normal(size=(Lk, S, d)) * 0.3).astype(np.float32))
    c = t((rng.normal(size=(Lk, S, H)) * 0.3).astype(np.float32))
    nn = t(rng.integers(0, P + 1, size=S).astype(np.int32))
    plan = LM.device_wavefront_plan(S, P, d, H, F, Lk, device)
    run = lambda st=None: LW._wavefront_hoist_cuda(x, h, c, *slab, n_pulls=nn,  # noqa: E731
                                                   stamps=st)
    simt = lambda: LW.lstm_wavefront_i8_simt(x, h, c, *slab, nn)  # noqa: E731
    res = {"event_ms": event_ms(run, reps=5), "blocks": plan.nb, "smem": LM.WF_SMEM,
           "scratch": plan.scratch()[0], "diagonals": plan.diagonals, "Lk": Lk}
    res["host_us"], res["device_us"] = host_and_device_us(run, n=5, keys=("wavefront_hoist",))
    res["simt_event_ms"] = event_ms(simt, reps=3)
    res["simt_host_us"], res["simt_device_us"] = host_and_device_us(
        simt, n=2, keys=("wavefront_kernel",))
    st = torch.zeros((plan.nb, plan.n_stamps), dtype=torch.int64, device=device)
    run(st)
    got = run(st)
    want = simt()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("profile_lstm_mma kernel 15: the stamped launch differs from its "
                             "template")
    s = st.cpu().numpy()
    res["total_us"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
    res["phases"] = breakdown(s, wavefront_phases(plan.diagonals))
    last = s.max(axis=0).astype(np.float64)
    by_live: Dict[int, List[float]] = {}
    for D in range(plan.diagonals):
        k0 = 3 + LM.WF_STAMPS * D
        by_live.setdefault(len(plan.live(D)), []).append((last[k0] - last[k0 - 1]) / 1e3)
    res["gates_by_live"] = {n: float(np.mean(v)) for n, v in sorted(by_live.items())}
    return res


def report_wavefront(r: dict, S: int, P: int, card: str = "") -> None:
    parts = "; ".join(f"{k} {v['critical_us']:.1f} us (x{v['n']}, blocks' median "
                      f"{v['median_us']:.1f})" for k, v in r["phases"].items())
    gates = ", ".join(f"{n} {v:.1f} us" for n, v in r["gates_by_live"].items())
    print(f"profile_lstm_mma kernel 15 S={S} P={P} slab={r['Lk']} ({r['diagonals']} diagonals): "
          f"{r['blocks']} blocks, {r['smem']} bytes of shared memory, {r['scratch']} bytes of "
          f"scratch; CUDA events {r['event_ms'] * 1e3:.1f} us a call (template "
          f"{r['simt_event_ms'] * 1e3:.1f}), device time (profiler) {r['device_us']:.1f} us "
          f"(template {r['simt_device_us']:.1f}), the host's per call queued {r['host_us']:.1f} "
          f"us; the stamped launch {r['total_us']:.1f} us, critical path by phase: {parts}; "
          f"the gate phase's mean critical path a diagonal by live layers: {gates}"
          + (f" ({card})" if card else ""))


# kernel 3's launches by the names the profiler gives their device kernels
FFN_PASSES = (("yq", "ffn_yq_kernel"), ("ff1", "ffn_mm_kernel<true>"), ("mq", "ffn_mq_kernel"),
              ("ff2", "ffn_mm_kernel<false>"), ("norm", "ffn_norm_rows_kernel"))
FFN_PASSES_KERNELS = ("ffn_yq_kernel", "ffn_mm_kernel", "ffn_mq_kernel", "ffn_norm_rows_kernel")


def profile_ffn(S: int, P: int, device, n: int = 5) -> dict:
    """Kernel 3 over the P * S rows at the flagship int8 layer 0: {"event_us"
    (a whole call), "host_us", "device_us", "phases": {launch: device us},
    "rows", "scratch"}; each launch's device time from torch.profiler over
    n calls (a launch alone is shorter than the host's enqueue of a call,
    so CUDA events around it would time the host)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    params = PCS.build(S, P, TM.TransducerDims(), device)[0]
    fa = tuple(params[k][0] for k in LK.LAYER_I8_KEYS[7:])
    d, F = fa[0].shape
    R = P * S
    rng = np.random.default_rng(5)
    x, hs = (torch.from_numpy(rng.normal(size=(R, d)).astype(np.float32)).to(device)
             for _ in "xh")
    call = lambda: LK.ffn_norm_cuda(x, hs, *fa)  # noqa: E731
    res = {"event_us": event_ms(call) * 1e3, "rows": R,
           "scratch": LM.ffn_plan(R, d, F).scratch()[0]}
    res["host_us"], res["device_us"] = host_and_device_us(call, keys=FFN_PASSES_KERNELS)
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    res["phases"] = {name: sum(e.self_device_time_total for e in rows if key in e.key) / n
                     for name, key in FFN_PASSES}
    return res


def host_and_device_us(fn, n: int = 50, keys=("mma_kernel",)) -> Tuple[float, float]:
    """The host's time per call of `fn` over n calls queued without a
    synchronize (its enqueue cost where that exceeds the device's), and the
    device time per call of its kernels (whose names hold one of `keys`)
    from torch.profiler over 5 calls, after a warm-up step of 5 in the same
    session whose records are dropped. CUPTI loses a launch's record now
    and then (in a process that has profiled many times, the first one or
    two launches of a session, which read a one-launch kernel's time as 3/5
    of its own), so each kernel counts as its recorded launches' mean times
    its launches a call: its records over the 5 calls, rounded up (`fn`
    launches the same kernels each call; fewer than 5 of a kernel's records
    lost)."""
    from torch.profiler import ProfilerActivity, profile as tprofile, schedule

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # the warm-up step, then the recorded one
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return host, sum(e.self_device_time_total / e.count * -(-e.count // 5)
                     for e in prof.key_averages() if e.count and any(k in e.key for k in keys))


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


def report_ffn(r: dict, S: int, P: int, card: str = "") -> None:
    parts = "; ".join(f"{k} {v:.1f} us" for k, v in r["phases"].items())
    print(f"profile_lstm_mma kernel 3 S={S} P={P} ({r['rows']} rows, {r['scratch']} bytes of "
          f"scratch): CUDA events {r['event_us']:.1f} us a call, its kernels' device time "
          f"(profiler) {r['device_us']:.1f} us, the host's per call queued {r['host_us']:.1f} us; "
          f"device time by launch: {parts}"
          + (f" ({card})" if card else ""))


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--P", type=int, default=27)
    ap.add_argument("--wide", action="store_true",
                    help="also kernel 14 at d 1024 / H 4096 (kernel 2 has no plan there)")
    ap.add_argument("--ub", default="", help="kernel 14 again at these gate-item widths (8,16,32)")
    ap.add_argument("--slab", type=int, default=6, help="kernel 15's layers (default 6)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    res = profile(args.S, args.P, dev)
    report(res, args.S, args.P)
    res["kernel 3"] = profile_ffn(args.S, args.P, dev)
    report_ffn(res["kernel 3"], args.S, args.P)
    res["kernel 14"] = profile_hoist(args.S, args.P, dev)
    report_hoist(res["kernel 14"], args.S, args.P, TM.TransducerDims())
    res["kernel 11"] = profile_chunk_hoist(args.S, args.P, dev)
    report_hoist(res["kernel 11"], args.S, args.P, TM.TransducerDims(), kernel="kernel 11",
                 stamped="the cooperative launch")
    res["kernel 15"] = profile_wavefront_hoist(args.S, args.P, dev, args.slab)
    report_wavefront(res["kernel 15"], args.S, args.P)
    if args.wide:
        res["kernel 14 wide"] = profile_hoist(args.S, args.P, dev, WIDE)
        report_hoist(res["kernel 14 wide"], args.S, args.P, WIDE)
    for ub in (int(u) for u in args.ub.split(",") if u):
        try:
            r = dict(profile_hoist(args.S, args.P, dev, ub=ub), forced=True)
        except ValueError as e:
            print(f"profile_lstm_mma kernel 14 at {ub}-unit items: no plan ({e})")
            continue
        res[f"kernel 14 ub={ub}"] = r
        report_hoist(r, args.S, args.P, TM.TransducerDims())
    return res


if __name__ == "__main__":
    main()
