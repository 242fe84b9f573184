"""Where the tensor-parallel step's one-launch kernels spend their time:
the phases of one launch of kernels 18 and 19 (csrc/lstm_tp_gates.cu) and
20 and 21 (csrc/lstm_tp_ffn.cu) from each block's stamps (the global
nanosecond timer), beside the column-pass kernels they replaced
(`tp_gate_cell_proj_simt`, `tp_gates_cell_i8_simt`, `tp_ffn_partial_simt`,
`tp_ffn_mid_i8_simt`).

    python -m april_asr_tpu_torch.tools.profile_tp [--S 256] [--m 2] [--ub 8,16,32] \
        [--kc 32,64] [--nw 2,4,8] [--kinds f32,bf16,int8,ffn_f32,ffn_bf16,mid_i8]

On one model shard's weights at flagship widths (d 512, hidden 1024 and
ffn 2048 split over m shards: Hs = 1024 / m, Fs = 2048 / m) drawn from a
numpy seed (`tp_case`: unit-scale rows; int8 weights with column scales)
and numpy seed inputs (x, h, c, a gate of ~50%, y), for kernel 18 at f32 and
bf16 weights ("f32", "bf16"), kernel 19 ("int8"), kernel 20 ("ffn_f32",
"ffn_bf16") and kernel 21 ("mid_i8"): the card's plan and, for kernel 18,
where `--ub` (units a gate item) or `--kc` (depth of a gate stage) name
others, the best plan of each combination (`tp_plan.gcp_plan` restricted
to it); for kernel 20 the best plan whose items compute on each `--nw`
warps. Each plan's outputs are
required equal bit for bit to the column-pass kernel's, gated and ungated
where the kernel takes a gate; per phase the critical path (from the last
block's arrival at the phase's start to the last block's arrival at its
end) and the blocks' median: kernel 18 `gates` (its gate items: the x and
h chains, the cell), `barrier`, `projection`; kernel 19 `stage + rowq8`
(the gate slice staged, x and h quantized), `barrier`, `gates`; kernel 20
`ff1` (y into row tiles, a grid barrier, the ff1 items), `barrier`, `ff2`; kernel 21 `stage + rowq8` (its first item's
weight columns staged, y quantized across the grid), `barrier`, `items`. Beside them, without stamps: the CUDA-event time of one call, the
device time (profiler) and the host's time per call, of the plan's launch
and of the column-pass kernel. On the CPU (`--device cpu`) it prints the
plans only. Needs a CUDA device.
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

D, H, F = 512, 1024, 2048  # the flagship widths
KINDS = ("f32", "bf16", "int8", "ffn_f32", "ffn_bf16", "mid_i8")
KERNEL = {"f32": 18, "bf16": 18, "int8": 19, "ffn_f32": 20, "ffn_bf16": 20, "mid_i8": 21}
PHASES = {18: (("gates", 0, 1), ("barrier", 1, 2), ("projection", 2, 3)),
          19: (("stage + rowq8", 0, 1), ("barrier", 1, 2), ("gates", 2, 3)),
          20: (("ff1", 0, 1), ("barrier", 1, 2), ("ff2", 2, 3)),
          21: (("stage + rowq8", 0, 1), ("barrier", 1, 2), ("items", 2, 3))}
# device kernels of each route, by the names the profiler gives them
KEYS = {18: ("tp_gcp_kernel",), 19: ("tp_gc_i8_kernel",), 20: ("tp_ffn_kernel",),
        21: ("tp_mid_i8_kernel",), "simt": ("step_gates", "tp_cols")}
OUTS = {18: ("hp", "c2"), 19: ("hc", "c2"), 20: ("out",), 21: ("mid",)}


def tp_case(kind: str, S: int, m: int, seed: int, dev, d: int = D, hidden: int = H,
            ffn: int = F) -> tuple:
    """The inputs of one shard at hidden / m units and ffn / m columns: kind
    "f32" or "bf16" (kernel 18: x, h, c, w_ih, w_hh [d, 4Hs], bias [4Hs],
    w_hr [Hs, d], gate), "int8" (kernel 19: x, h, c, w_ih_q, w_ih_s, w_hh_q,
    w_hh_s, bias, gate), "ffn_f32" or "ffn_bf16" (kernel 20: y, ff1 [d, Fs],
    ff1_b [Fs], ff2 [Fs, d]) or "mid_i8" (kernel 21: y, ff1_q, ff1_s,
    ff1_b)."""
    rng = np.random.default_rng(seed)
    Hs, Fs = hidden // m, ffn // m
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev, dt)
    q = lambda k, n: torch.from_numpy(  # noqa: E731
        rng.integers(-127, 128, size=(k, n), dtype=np.int8)).to(dev)
    s = lambda n: t(rng.random(n) * 2e-3 + 1e-4)  # noqa: E731
    wd = torch.bfloat16 if kind.endswith("bf16") else torch.float32
    w = lambda k, n: t(rng.normal(size=(k, n)) / np.sqrt(k), wd)  # noqa: E731
    if KERNEL[kind] >= 20:
        y = t(rng.normal(size=(S, d)))
        b1 = t(rng.normal(size=Fs) * 0.3)
        if kind == "mid_i8":
            return (y, q(d, Fs), s(Fs), b1)
        return (y, w(d, Fs), b1, w(Fs, d))
    x = t(rng.normal(size=(S, d)))
    h = t(rng.normal(size=(S, d)) * 0.3)
    c = t(rng.normal(size=(S, Hs)) * 0.3)
    gate = torch.from_numpy(rng.random(S) < 0.5).to(dev)
    bias = t(rng.normal(size=4 * Hs) * 0.3)
    if kind == "int8":
        return (x, h, c, q(d, 4 * Hs), s(4 * Hs), q(d, 4 * Hs), s(4 * Hs), bias, gate)
    return (x, h, c, w(d, 4 * Hs), w(d, 4 * Hs), bias, w(Hs, d), gate)


# each kernel's route (plan, gate, stamps) and its column-pass kernel (gate)
ROUTES = {18: (TK.lstm_gate_cell_proj_cuda, TK.lstm_gate_cell_proj_simt_cuda),
          19: (TK.lstm_gates_cell_i8_cuda, TK.lstm_gates_cell_i8_simt_cuda),
          20: (TK.ffn_partial_cuda, TK.ffn_partial_simt_cuda),
          21: (TK.ffn_mid_i8_cuda, TK.ffn_mid_i8_simt_cuda)}


def _fns(kind: str, args: tuple):
    """(the plan's launch (plan, gate, stamps), the column-pass kernel
    (gate)); kernels 20 and 21 take no gate."""
    k = KERNEL[kind]
    run, simt = ROUTES[k]
    if k >= 20:
        return (lambda p, g, st=None: run(*args, plan=p, stamps=st), lambda g: simt(*args))
    return (lambda p, g, st=None: run(*args[:-1], g, plan=p, stamps=st),
            lambda g: simt(*args[:-1], g))


def check_equal(kind: str, args: tuple, plan) -> None:
    """The plan's outputs equal the column-pass kernel's bit for bit, gated
    and ungated where the kernel takes a gate; raises where they differ."""
    k = KERNEL[kind]
    run, simt = _fns(kind, args)
    for g in (None,) if k >= 20 else (None, args[-1]):
        got, want = run(plan, g), simt(g)
        if k >= 20:
            got, want = (got,), (want,)
        for name, a, b in zip(OUTS[k], got, want):
            if not torch.equal(a, b):
                n = int((a != b).sum())
                gated = "gated " if g is not None else ""
                raise AssertionError(
                    f"kernel {k} {kind} {gated}{name}: {n} values differ from the column-pass "
                    f"kernel's (max abs {float((a - b).abs().max()):.3g}) on {plan}")


def plan_line(plan) -> str:
    if isinstance(plan, TP.GcI8Plan):
        g = plan.gate
        return f"{g.items} blocks, gate items of {g.ub} units x {g.rows} rows, {plan.smem} bytes"
    if isinstance(plan, TP.FfnPlan):
        items = [f"{n} items of {t.tr} x {t.tc} ({t.nw} warps, {t.rm} x {4 * t.nq} a lane)"
                 for n, t in (("ff1", plan.t1), ("ff2", plan.t2))]
        return f"{plan.nb} blocks, {', '.join(items)}, {plan.smem} bytes"
    if isinstance(plan, TP.MidPlan):
        return (f"{plan.nb} blocks, items of {plan.tr} x {plan.tc} ({plan.ntw} column tiles a "
                f"warp), {plan.smem} bytes")
    return (f"{plan.nb} blocks, gate items of {plan.ub} units x {plan.nr1} rows in "
            f"{plan.kc}-deep stages, projection items of 32 x 32, {plan.smem} bytes")


def profile_plan(kind: str, args: tuple, plan) -> dict:
    """One plan: checked against the column-pass kernel, timed (events,
    device, host) and stamped (the phases)."""
    check_equal(kind, args, plan)
    k = KERNEL[kind]
    run, _ = _fns(kind, args)
    fn = lambda: run(plan, None)  # noqa: E731
    host, dev = device_us(fn, KEYS[k])
    st = torch.zeros((plan.nb, 4), dtype=torch.int64, device=args[0].device)
    run(plan, None, st)
    run(plan, None, st)
    torch.cuda.synchronize()
    s = st.cpu().numpy()
    return {"plan": plan_line(plan), "event_us": event_ms(fn) * 1e3, "device_us": dev,
            "host_us": host, "total_us": float(s[:, 3].max() - s[:, 0].min()) / 1e3,
            "phases": breakdown(s, PHASES[k])}


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


def _plan(name: str, index, *shape, **kw):
    """tp_plan's `name` plan on card `index`'s SM count (cached per shape),
    or on the H100's where index is None (the CPU listing)."""
    if index is None:
        return getattr(TP, name)(*shape, **kw)
    return getattr(TP, "device_" + name)(*shape, index, **kw)


def plans(kind: str, S: int, m: int, index, ubs=(), kcs=(), nws=()) -> List:
    """The card's plan, then (kernel 18) each named combination's best plan,
    (kernel 20) the best plan whose items compute on each named number of
    warps."""
    Hs, Fs = H // m, F // m
    k = KERNEL[kind]
    if k == 19:
        return [_plan("gc_i8_plan", index, S, D, Hs)]
    if k == 21:
        return [_plan("mid_plan", index, S, D, Fs)]
    if k == 20:
        out = [_plan("ffn_plan", index, S, D, Fs)]
        out += [_plan("ffn_plan", index, S, D, Fs,
                      tiles=tuple(t for t in TP.FFN_TILES if t.nw == nw)) for nw in nws]

    else:
        out = [_plan("gcp_plan", index, S, D, Hs)]
        for ub, kc in itertools.product(ubs or (None,), kcs or (None,)):
            out.append(_plan("gcp_plan", index, S, D, Hs, ubs=(ub,) if ub else TP.UBS,
                             kcs=(kc,) if kc else TP.KCS))
    seen, uniq = set(), []
    for p in out:
        if p is not None and p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def profile(S: int, m: int, ubs=(), kcs=(), nws=(), kinds=KINDS,
            seed: int = 3) -> Dict[str, dict]:
    """{kind: {"simt": times, "plans": [per plan]}} at S rows, m shards."""
    dev = torch.device("cuda")
    out = {}
    for kind in kinds:
        args = tp_case(kind, S, m, seed, dev)
        rows = [profile_plan(kind, args, p)
                for p in plans(kind, S, m, dev.index or 0, ubs, kcs, nws)]
        out[kind] = {"simt": simt_times(kind, args), "plans": rows}
    return out


def report(res: Dict[str, dict], S: int, m: int, card: str = "") -> None:
    for kind, r in res.items():
        k = KERNEL[kind]
        s = r["simt"]
        print(f"profile_tp kernel {k} {kind} S={S} m={m}: column-pass kernel {s['event_us']:.1f} us "
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
    ap.add_argument("--nw", default="", help="kernel 20: computing warps an item (1-8)")
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        for kind in args.kinds.split(","):
            for p in plans(kind, args.S, args.m, None, _ints(args.ub), _ints(args.kc),
                           _ints(args.nw)):
                print(f"profile_tp {kind} S={args.S} m={args.m}: {plan_line(p)}")
        return {}
    t0 = time.perf_counter()
    res = profile(args.S, args.m, _ints(args.ub), _ints(args.kc), _ints(args.nw),
                  tuple(args.kinds.split(",")))
    report(res, args.S, args.m)
    print(f"profile_tp: {time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    main()
