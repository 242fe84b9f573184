"""Where the tensor-parallel step's kernels 18 and 19 spend their time: the
phases of one launch of each (csrc/lstm_tp_gates.cu) from each block's
stamps (the global nanosecond timer), beside the two-pass kernels they
replaced (`tp_gate_cell_proj_simt`, `tp_gates_cell_i8_simt`).

    python -m april_asr_tpu_torch.tools.profile_tp [--S 256] [--m 2] [--ub 8,16,32] \
        [--kc 32,64]

On one model shard's weights at flagship widths (d 512, hidden 1024 split
over m shards: Hs = 1024 / m) drawn from a numpy seed (`tp_case`: unit-scale
rows; int8 weights with column scales) and numpy seed inputs (x, h, c, a
gate of ~50%), for kernel 18 at f32 and bf16 weights and kernel 19 at int8:
the card's plan and, for kernel 18, where `--ub` (units a gate item) or
`--kc` (depth of a gate stage) name others, the best plan of each
combination (`tp_plan.gcp_plan` restricted to it). Each plan's outputs are
required equal bit for bit to the two-pass kernel's, gated and ungated; per
phase the critical path (from the last block's arrival at the phase's start
to the last block's arrival at its end) and the blocks' median: kernel 18
`gates` (its gate items: the x and h chains, the cell), `barrier`,
`projection`; kernel 19 `stage + rowq8` (the gate slice staged, x and h
quantized), `barrier`, `gates`. Beside them, without stamps: the
CUDA-event time of one call, the device time (profiler) and the host's time
per call, of the plan's launch and of the two-pass kernel. On the CPU
(`--device cpu`) it prints the plans only. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import lstm_tp_kernels as TK
from ..ops import tp_plan as TP
from .profile_lstm_mma import breakdown, event_ms, host_and_device_us

D, H = 512, 1024  # the flagship widths
PHASES18 = (("gates", 0, 1), ("barrier", 1, 2), ("projection", 2, 3))
PHASES19 = (("stage + rowq8", 0, 1), ("barrier", 1, 2), ("gates", 2, 3))
# device kernels of each route, by the names the profiler gives them
KEYS = {"fused18": ("tp_gcp_kernel",), "fused19": ("tp_gc_i8_kernel",),
        "simt": ("step_gates", "tp_cols")}


def tp_case(kind: str, S: int, m: int, seed: int, dev, d: int = D, hidden: int = H) -> tuple:
    """(x, h, c, weights..., gate) of one shard at hidden / m units: kind
    "f32" or "bf16" (kernel 18: w_ih, w_hh [d, 4Hs], bias [4Hs], w_hr
    [Hs, d]) or "int8" (kernel 19: w_ih_q, w_ih_s, w_hh_q, w_hh_s, bias)."""
    rng = np.random.default_rng(seed)
    Hs = hidden // m
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev, dt)
    x = t(rng.normal(size=(S, d)))
    h = t(rng.normal(size=(S, d)) * 0.3)
    c = t(rng.normal(size=(S, Hs)) * 0.3)
    gate = torch.from_numpy(rng.random(S) < 0.5).to(dev)
    bias = t(rng.normal(size=4 * Hs) * 0.3)
    if kind == "int8":
        q = lambda: torch.from_numpy(  # noqa: E731
            rng.integers(-127, 128, size=(d, 4 * Hs), dtype=np.int8)).to(dev)
        s = lambda: t(rng.random(4 * Hs) * 2e-3 + 1e-4)  # noqa: E731
        return (x, h, c, q(), s(), q(), s(), bias, gate)
    wd = torch.float32 if kind == "f32" else torch.bfloat16
    w = lambda k, n: t(rng.normal(size=(k, n)) / np.sqrt(k), wd)  # noqa: E731
    return (x, h, c, w(d, 4 * Hs), w(d, 4 * Hs), bias, w(Hs, d), gate)


def _fns(kind: str, args: tuple):
    """(the plan's launch (plan, gate, stamps), the two-pass kernel (gate))."""
    if kind == "int8":
        return (lambda p, g, st=None: TK.lstm_gates_cell_i8_cuda(*args[:-1], g, plan=p, stamps=st),
                lambda g: TK.lstm_gates_cell_i8_simt_cuda(*args[:-1], g))
    return (lambda p, g, st=None: TK.lstm_gate_cell_proj_cuda(*args[:-1], g, plan=p, stamps=st),
            lambda g: TK.lstm_gate_cell_proj_simt_cuda(*args[:-1], g))


def check_equal(kind: str, args: tuple, plan) -> None:
    """The plan's outputs equal the two-pass kernel's bit for bit, gated
    and ungated; raises where they differ."""
    run, simt = _fns(kind, args)
    for g in (None, args[-1]):
        got, want = run(plan, g), simt(g)
        for name, a, b in zip(("hc" if kind == "int8" else "hp", "c2"), got, want):
            if not torch.equal(a, b):
                n = int((a != b).sum())
                gated = "gated " if g is not None else ""
                raise AssertionError(
                    f"kernel {19 if kind == 'int8' else 18} {kind} {gated}{name}: {n} values "
                    f"differ from the two-pass kernel's (max abs "
                    f"{float((a - b).abs().max()):.3g}) on {plan}")


def plan_line(plan) -> str:
    if isinstance(plan, TP.GcI8Plan):
        g = plan.gate
        return f"{g.items} blocks, gate items of {g.ub} units x {g.rows} rows, {plan.smem} bytes"
    return (f"{plan.nb} blocks, gate items of {plan.ub} units x {plan.nr1} rows in "
            f"{plan.kc}-deep stages, projection items of 32 x 32, {plan.smem} bytes")


def profile_plan(kind: str, args: tuple, plan) -> dict:
    """One plan: checked against the two-pass kernel, timed (events, device,
    host) and stamped (the phases)."""
    check_equal(kind, args, plan)
    run, _ = _fns(kind, args)
    fn = lambda: run(plan, None)  # noqa: E731
    key = KEYS["fused19" if kind == "int8" else "fused18"]
    host, dev = device_us(fn, key)
    st = torch.zeros((plan.nb, 4), dtype=torch.int64, device=args[0].device)
    run(plan, None, st)
    run(plan, None, st)
    torch.cuda.synchronize()
    s = st.cpu().numpy()
    return {"plan": plan_line(plan), "event_us": event_ms(fn) * 1e3, "device_us": dev,
            "host_us": host, "total_us": float(s[:, 3].max() - s[:, 0].min()) / 1e3,
            "phases": breakdown(s, PHASES19 if kind == "int8" else PHASES18)}


def device_us(fn, keys, tries: int = 3) -> Tuple[float, float]:
    """`host_and_device_us`, asked again where the profiler returned no
    device time (now and then a session reports no kernel events)."""
    for _ in range(tries):
        host, dev = host_and_device_us(fn, n=50, keys=keys)
        if dev > 0:
            break
    return host, dev


def simt_times(kind: str, args: tuple) -> dict:
    _, simt = _fns(kind, args)
    fn = lambda: simt(None)  # noqa: E731
    host, dev = device_us(fn, KEYS["simt"])
    return {"event_us": event_ms(fn) * 1e3, "device_us": dev, "host_us": host}


def plans(kind: str, S: int, Hs: int, index: int, ubs=(), kcs=()) -> List:
    """The card's plan, then (kernel 18) each named combination's best plan."""
    if kind == "int8":
        return [TP.device_gc_i8_plan(S, D, Hs, index)]
    out = [TP.device_gcp_plan(S, D, Hs, index)]
    for ub, kc in itertools.product(ubs or (None,), kcs or (None,)):
        out.append(TP.device_gcp_plan(S, D, Hs, index, (ub,) if ub else TP.UBS,
                                      (kc,) if kc else TP.KCS))
    seen, uniq = set(), []
    for p in out:
        if p is not None and p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def profile(S: int, m: int, ubs=(), kcs=(), kinds=("f32", "bf16", "int8"),
            seed: int = 3) -> Dict[str, dict]:
    """{kind: {"simt": times, "plans": [per plan]}} at S rows, m shards."""
    dev = torch.device("cuda")
    out = {}
    for kind in kinds:
        args = tp_case(kind, S, m, seed, dev)
        rows = [profile_plan(kind, args, p)
                for p in plans(kind, S, H // m, dev.index or 0, ubs, kcs)]
        out[kind] = {"simt": simt_times(kind, args), "plans": rows}
    return out


def report(res: Dict[str, dict], S: int, m: int, card: str = "") -> None:
    for kind, r in res.items():
        k = 19 if kind == "int8" else 18
        s = r["simt"]
        print(f"profile_tp kernel {k} {kind} S={S} m={m}: two-pass kernel {s['event_us']:.1f} us "
              f"(events), device {s['device_us']:.1f} us, host {s['host_us']:.1f} us a call"
              + (f" ({card})" if card else ""))
        for p in r["plans"]:
            parts = "; ".join(f"{n} {v['critical_us']:.1f} us (blocks' median {v['median_us']:.1f})"
                              for n, v in p["phases"].items())
            print(f"  {p['plan']}: equal bit for bit; events {p['event_us']:.1f} us, device "
                  f"{p['device_us']:.1f} us, host {p['host_us']:.1f} us a call; stamped launch "
                  f"{p['total_us']:.1f} us: {parts}")


def _ints(s: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in s.split(",") if v)


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--ub", default="", help="kernel 18: units a gate item (8, 16, 32)")
    ap.add_argument("--kc", default="", help="kernel 18: depth of a gate stage (32, 64)")
    ap.add_argument("--kinds", default="f32,bf16,int8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        for kind in args.kinds.split(","):
            p = (TP.gc_i8_plan(args.S, D, H // args.m) if kind == "int8"
                 else TP.gcp_plan(args.S, D, H // args.m))
            print(f"profile_tp {kind} S={args.S} m={args.m}: {plan_line(p)}")
        return {}
    t0 = time.perf_counter()
    res = profile(args.S, args.m, _ints(args.ub), _ints(args.kc), tuple(args.kinds.split(",")))
    report(res, args.S, args.m)
    print(f"profile_tp: {time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    main()
