"""Where kernels 4, 8 and 9 spend their time: the phases of one launch of
each (csrc/chunk_decode_cluster.cu, csrc/dec_joiner_cluster.cu,
csrc/joiner_stream.cu) from each block's stamps (the global nanosecond
timer), beside the CUDA-core kernel it replaced (`chunk_decode_simt`,
`dec_joiner_simt`, `joiner_argmax_simt`).

    python -m april_asr_tpu_torch.tools.profile_decode [--S 256] [--P 27] [--kernel 4|8|9] [--ts N]
    python -m april_asr_tpu_torch.tools.profile_decode --kernel 9 [--S 256] [--V 16383] \
        [--ts 64,128] [--vc 64,128,256] [--tile 8,4] [--w resident,streamed]

Kernel 9 (`--kernel 9`): the joiner and argmax at S sessions on
flagship-width join weights (J = 512, V columns, blank logit +2.0) at bf16
and f32 (`k9_case`: logit-scale eout, unit dout), on the card's plan and,
where `--ts`, `--vc`, `--tile` or `--w` name other splits, on each of
their combinations that a block holds (`joiner_plan.plan_for`: TS sessions
a tile, Vc columns a slice, the register tile by its columns, W resident or
streamed); each launch's outputs required equal bit for bit to
`joiner_argmax_simt`'s, and per phase the critical path and the blocks'
median: `tanh` (t for the block's share of the S x J values), `barrier`
(the grid barrier), `load` (the first ring stage and W's first chunk
landed), `product` (each tile's chains), `keys` (each thread's and warp's
argmax keys of a tile), `merge` (the keys into device memory), `finalize`
(the ticket, and the last block's outputs); beside them the
CUDA-event time, the device time (profiler) and the host's time per call
of the launch and of `joiner_argmax_simt`.

Kernel 8 (`--kernel 8`; both by default): one decoder-joiner round at S
sessions on flagship-width weights at bf16 and f32 (`dj_case`: need_dec at
a flush round's ~5% and at 50%), its outputs required equal bit for bit to
`dec_joiner_simt`'s, and per phase the critical path and the blocks'
median: `load` (the refresh list; the dec_proj slice landed where rows
refresh), `refresh rows`, `refresh`, `a` (this block's columns of dout' and
of a), `barrier A`, `gather`, `joiner` (the W slice landed, the logits),
`argmax`, `barrier B`, `merge`, `store`; beside them the CUDA-event time,
the device time (profiler) and the host's time per call of both kernels.

Kernel 4:

On flagship-width decode weights drawn from a numpy seed at bf16 and at f32
(blank logit +2.0, as bench.py's model) and an aged decode state
(`decode_case`, the inputs chip_smoke.py checks kernel 4 on), it launches
the cluster kernel on the card's plan once with stamps and prints, per
phase summed over the P x 3 rounds, the critical path (from the last
block's arrival at the phase's start to the last block's arrival at its
end) and the blocks' median: `refresh rows` (the refreshing sessions' decoder
inputs from the tables), `refresh` (this block's dout columns), `a` (its
columns of a), `barrier A`, `a gather` (every block's columns of a, read
through distributed shared memory), `joiner` (this block's logits),
`argmax` (the partial argmaxes stored into every block), `barrier B`,
`merge` (the merge and the heuristics); also `load` (the weight slices and
the state) and `store` (the outputs).
The stamps add a block barrier at each phase boundary. Beside them, without
stamps: the CUDA-event time of one call, the kernel's device time
(torch.profiler) and the host's time per call, for the cluster kernel and
for the CUDA-core kernel. Needs a CUDA device.

`decode_case` and `dj_case` import inside themselves only what every tree
of the port has, so tools/parent_ab.py loads this file by path into
another tree's turn.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


def decode_case(w: dict, vt, blank: int, stride: int, S: int, P: int, rng, dev) -> tuple:
    """Kernel 4's arguments on the decode weights `w` (dec_table, dec_proj_t,
    dec_proj_b, join_t, join_b) and vocab tables `vt`: P pulls of
    logit-scale eouts for S sessions, a random pull mask, and a decode state
    aged at random (heads, windows with flags, clocks, contexts, pending
    refreshes), so that every heuristic runs; drawn from `rng` in a fixed
    order. Returns (args, kwargs) of `decode_kernels.chunk_decode`."""
    from april_asr_tpu_torch.config import DecodeConfig
    from april_asr_tpu_torch.decode.greedy import init_decode_state
    from april_asr_tpu_torch.engine.step import INNER_STEPS_EMIT

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    J, V = w["join_t"].shape
    dcfg = DecodeConfig()
    T = dcfg.max_active_tokens
    st = init_decode_state(S, w["dec_table"].shape[0], J, blank, dcfg, dev)
    st.update(
        head=t(rng.integers(0, T, size=S).astype(np.int32)),
        token_words=t((rng.integers(0, V, size=(S, T))
                       | (rng.integers(0, 4, size=(S, T)) << 16)).astype(np.int32)),
        time_ms=torch.full((S,), 4000, dtype=torch.int32, device=dev),
        last_emit_ms=t(rng.integers(0, 4000, size=S).astype(np.int32)),
        last_call=t(rng.integers(0, T, size=S).astype(np.int32)),
        context=t(rng.integers(0, V, size=(S, 2)).astype(np.int32)),
        need_dec=t(rng.random(S) < 0.5),
        emitted_silence=t(rng.random(S) < 0.5),
        dout=t(rng.normal(size=(S, J)).astype(np.float32)),
    )
    eouts = t((rng.normal(size=(P, S, J)) * 2.0).astype(np.float32))
    can = t(np.arange(P)[:, None] < rng.integers(0, P + 1, size=S)[None, :])
    args = (eouts, can, st, w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"],
            w["join_b"], vt)
    return args, dict(blank_id=blank, stride_ms=stride, emit_ramp=INNER_STEPS_EMIT, dcfg=dcfg)


def dj_case(w: dict, blank: int, S: int, share: float, rng, dev) -> tuple:
    """Kernel 8's arguments on the decode weights `w` (dec_table,
    dec_proj_t, dec_proj_b, join_t, join_b): logit-scale eout, unit dout,
    random 2-token contexts and need_dec set for `share` of the sessions,
    drawn from `rng` in a fixed order. Returns the positional arguments of
    `joiner_kernels.decoder_joiner_argmax_fused` (blank_id last)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    J, V = w["join_t"].shape
    eout = t((rng.normal(size=(S, J)) * 2.0).astype(np.float32))
    dout = t(rng.normal(size=(S, J)).astype(np.float32))
    ctx = t(rng.integers(0, V, size=(S, 2)).astype(np.int32))
    nd = t(rng.random(S) < share)
    return (ctx, nd, dout, eout, w["dec_table"], w["dec_proj_t"], w["dec_proj_b"], w["join_t"],
            w["join_b"], blank)


def decode_weights(wd, device, seed: int = 0) -> Tuple[dict, dict, int, int]:
    """Flagship-width decode weights of type wd (dec_table f32), the vocab
    tables, the blank id and the stride: (w, vt, blank, stride_ms)."""
    from april_asr_tpu_torch.config import FbankOptions
    from april_asr_tpu_torch.decode.greedy import vocab_tables_device
    from april_asr_tpu_torch.io.params import build_vocab_tables
    from april_asr_tpu_torch.models import lstm_transducer as TM
    from april_asr_tpu_torch.models.export import make_model_parameters
    from april_asr_tpu_torch.testing import default_tokens

    dims = TM.TransducerDims()
    p = TM.precompute_decoder_tables(TM.init_transducer_params(seed, dims), dims)
    p["join_b"][0] += 2.0
    if wd != torch.float32:
        p = TM.cast_weights(p, wd)
    w = {k: p[k].to(device) for k in ("dec_table", "dec_proj_t", "dec_proj_b", "join_t", "join_b")}
    mp = make_model_parameters(dims, default_tokens(dims.vocab))
    vt = vocab_tables_device(build_vocab_tables(mp))
    return w, vt, mp.blank_id, FbankOptions().segment_stride_ms


# the stamped steps of one round, in order (csrc/chunk_decode_cluster.cu)
ROUND = ("refresh rows", "refresh", "a", "barrier A", "a gather", "joiner", "argmax",
         "barrier B", "merge")


def phases(P: int) -> List[Tuple[str, int, int]]:
    """(phase, start stamp, end stamp) of one launch: stamp 1 ends the load,
    stamps 2 + 9 (3 p + r) .. + 8 end round (p, r)'s steps (`ROUND`); the
    last ends the store."""
    out = [("load", 0, 1)]
    prev = 1
    for i in range(3 * P):
        for j, name in enumerate(ROUND):
            out.append((name, prev, 2 + 9 * i + j))
            prev = 2 + 9 * i + j
    return out + [("store", prev, prev + 1)]


def profile(S: int, P: int, device) -> Dict[str, dict]:
    """{"bf16" | "f32": {"plan", "total_us", "phases", "event_ms",
    "device_us", "host_us", "simt_event_ms", "simt_device_us"}}."""
    from april_asr_tpu_torch.ops import decode_kernels as DK

    from .profile_lstm_mma import breakdown, event_ms, host_and_device_us

    out = {}
    for name, wd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        w, vt, blank, stride = decode_weights(wd, device)
        args, kw = decode_case(w, vt, blank, stride, S, P, np.random.default_rng(S), device)
        J, V = w["join_t"].shape
        plan = DK.device_decode_plan(S, J, w["dec_table"].shape[2], V,
                                     kw["dcfg"].max_active_tokens, w["join_t"].element_size(),
                                     device)
        run = lambda st: DK.chunk_decode_cluster(*args, **kw, plan=plan, stamps=st)  # noqa: E731
        simt = lambda: DK.chunk_decode_simt(*args, **kw)  # noqa: E731
        res = {"plan": plan, "event_ms": event_ms(lambda: run(None)),
               "simt_event_ms": event_ms(simt, reps=5)}
        res["host_us"], res["device_us"] = host_and_device_us(
            lambda: run(None), keys=("chunk_decode_cluster_kernel",))
        _, res["simt_device_us"] = host_and_device_us(simt, n=3, keys=("chunk_decode_kernel",))
        st = torch.zeros((plan.blocks, 3 + 27 * P), dtype=torch.int64, device=device)
        run(st)
        run(st)
        torch.cuda.synchronize()
        s = st.cpu().numpy()
        res["total_us"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
        res["phases"] = breakdown(s, phases(P))
        out[name] = res
    return out


# kernel 8's stamped phases, in order (csrc/dec_joiner_cluster.cu)
DJ_PHASES = ("load", "refresh rows", "refresh", "a", "barrier A", "gather", "joiner", "argmax",
             "barrier B", "merge", "store")
DJ_SHARES = (0.05, 0.5)  # need_dec: a flush round's share, and chip_smoke's check


def dj_tiles(plan, TS: int, J: int, d: int, w_bytes: int):
    """`plan` (a kernel 8 `DecodePlan`) on tiles of TS sessions: the same
    cluster size and slices, its clusters and shared memory redone."""
    from april_asr_tpu_torch.ops import decode_kernels as DK

    return dataclasses.replace(
        plan, TS=TS, clusters=-(-plan.S // TS),
        smem=DK.dj_smem(TS, J, d, plan.Vc, plan.Jc, plan.C, w_bytes, plan.dp_smem))


def profile_dj(S: int, device, ts=None) -> Dict[str, dict]:
    """{"bf16 nd=0.05" ...: {"plan", "equal", "total_us", "phases",
    "event_ms", "device_us", "host_us", "simt_event_ms", "simt_device_us",
    "simt_host_us"}} for kernel 8 at S sessions, on the card's plan or on
    its slices in tiles of `ts` sessions."""
    from april_asr_tpu_torch.ops import decode_kernels as DK
    from april_asr_tpu_torch.ops import joiner_kernels as JK

    from .profile_lstm_mma import breakdown, event_ms, host_and_device_us

    out = {}
    for name, wd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        w, _, blank, _ = decode_weights(wd, device)
        J, V = w["join_t"].shape
        d, wb = w["dec_table"].shape[2], w["join_t"].element_size()
        plan = DK.device_dj_plan(S, J, d, V, wb, torch.device(device).index or 0)
        if ts:
            plan = dj_tiles(plan, ts, J, d, wb)
        for share in DJ_SHARES:
            args = dj_case(w, blank, S, share, np.random.default_rng(S + 7), device)
            run = lambda st: JK.decoder_joiner_argmax_cluster(*args, plan=plan, stamps=st)  # noqa: E731
            simt = lambda: JK.decoder_joiner_argmax_simt(*args)  # noqa: E731
            got, want = run(None), simt()
            torch.cuda.synchronize()
            res = {"plan": plan, "equal": all(torch.equal(g, x) for g, x in zip(got, want)),
                   "event_ms": event_ms(lambda: run(None)), "simt_event_ms": event_ms(simt)}
            res["host_us"], res["device_us"] = host_and_device_us(
                lambda: run(None), keys=("dec_joiner_cluster",))
            res["simt_host_us"], res["simt_device_us"] = host_and_device_us(
                simt, keys=("dec_refresh", "joiner_tile", "argmax_final", "Memset"))
            st = torch.zeros((plan.blocks, len(DJ_PHASES) + 1), dtype=torch.int64, device=device)
            run(st)
            run(st)
            torch.cuda.synchronize()
            s = st.cpu().numpy()
            res["total_us"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
            res["phases"] = breakdown(s, [(k, i, i + 1) for i, k in enumerate(DJ_PHASES)])
            out[f"{name} nd={share}"] = res
    return out


def report_dj(res: Dict[str, dict], S: int, card: str = "") -> None:
    for name, r in res.items():
        p = r["plan"]
        parts = "; ".join(f"{k} {v['critical_us']:.2f} us (blocks' median {v['median_us']:.2f})"
                          for k, v in r["phases"].items())
        print(f"profile_decode kernel 8 {name} S={S}: clusters of C={p.C}, tiles of TS={p.TS}, "
              f"{p.clusters} clusters ({p.waves} waves of {p.max_clusters}), dec_proj "
              f"{'resident' if p.dp_smem else 'streamed'}, {p.smem} bytes of shared memory a "
              f"block; outputs {'equal' if r['equal'] else 'DIFFER from'} dec_joiner_simt's; "
              f"stamped launch {r['total_us']:.2f} us; without stamps: CUDA events "
              f"{r['event_ms'] * 1e3:.2f} us a call, device time (profiler) {r['device_us']:.2f} "
              f"us, host per call queued {r['host_us']:.2f} us; dec_joiner_simt: CUDA events "
              f"{r['simt_event_ms'] * 1e3:.2f} us, device time {r['simt_device_us']:.2f} us, "
              f"host per call {r['simt_host_us']:.2f} us; critical path by phase: {parts}"
              + (f" ({card})" if card else ""))


def report(res: Dict[str, dict], S: int, P: int, card: str = "") -> None:
    for name, r in res.items():
        p = r["plan"]
        parts = "; ".join(f"{k} {v['critical_us']:.1f} us (x{v['n']}, blocks' median "
                          f"{v['median_us']:.1f})" for k, v in r["phases"].items())
        print(f"profile_decode kernel 4 {name} S={S} P={P}: clusters of C={p.C}, tiles of "
              f"TS={p.TS}, {p.clusters} clusters ({p.waves} waves of {p.max_clusters}), "
              f"dec_proj {'resident' if p.dp_smem else 'streamed'}, {p.smem} bytes of shared "
              f"memory a block; stamped launch {r['total_us']:.1f} us; without stamps: CUDA "
              f"events {r['event_ms'] * 1e3:.1f} us a call, device time (profiler) "
              f"{r['device_us']:.1f} us, host per call queued {r['host_us']:.1f} us; the "
              f"CUDA-core kernel: CUDA events {r['simt_event_ms'] * 1e3:.1f} us, device time "
              f"{r['simt_device_us']:.1f} us; critical path by phase: {parts}"
              + (f" ({card})" if card else ""))


K9_V = 16383  # the vocab cells' vocabulary


def k9_case(w_t, S: int, rng, dev) -> tuple:
    """Kernel 9's eout and dout at S sessions: logit-scale eout and unit
    dout [S, J] f32, drawn from `rng` in a fixed order."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    J = w_t.shape[0]
    return (t((rng.normal(size=(S, J)) * 2.0).astype(np.float32)),
            t(rng.normal(size=(S, J)).astype(np.float32)))


def k9_weights(wd, device, V: int = K9_V, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flagship-width join weights at V tokens of type wd (the bias f32,
    blank logit +2.0 as bench.py's model): (join_t, join_b, blank)."""
    from april_asr_tpu_torch.models import lstm_transducer as TM

    p = TM.init_transducer_params(seed, TM.TransducerDims(vocab=V))
    p["join_b"][0] += 2.0
    return p["join_t"].to(wd).to(device), p["join_b"].to(device), 0


def k9_phases(rounds: int) -> List[Tuple[str, int, int]]:
    """(phase, start stamp, end stamp) of one launch of kernel 9: stamps 0-3
    end entry, tanh, the grid barrier and the load; 4 + 3 r, 5 + 3 r and 6 +
    3 r end tile r's product, keys and merge; 4 + 3 rounds the finalize."""
    out = [("tanh", 0, 1), ("barrier", 1, 2), ("load", 2, 3)]
    prev = 3
    for r in range(rounds):
        b = 4 + 3 * r
        out += [("product", prev, b), ("keys", b, b + 1), ("merge", b + 1, b + 2)]
        prev = b + 2
    return out + [("finalize", prev, 4 + 3 * rounds)]


def k9_plans(S: int, J: int, V: int, wb: int, index: int, ts=(), vc=(), tiles=(), ws=()) -> list:
    """The card's plan, then each combination of the named splits (TS, Vc,
    the register tile's columns, "resident" / "streamed"; the plan's own
    where a list is empty) that a block holds."""
    import itertools

    from april_asr_tpu_torch.ops import joiner_plan as JP

    base = JP.device_joiner_plan(S, J, V, wb, index)
    out = [base]
    if not (ts or vc or tiles or ws):
        return out
    fit = JP.device_fit(index)
    for rc, n_ts, n_vc, w in itertools.product(
            tiles or (base.RC,), ts or (base.TS,), vc or (base.Vc,),
            ws or (("resident" if base.w_resident else "streamed"),)):
        ti = next(i for i, t in enumerate(JP.TILES) if t[0] == rc)
        RC, RS = JP.TILES[ti]
        TC, TSg = n_vc // RC, n_ts // RS
        if n_vc % RC or n_ts % RS or TC < 1 or TSg < 1 or TC & (TC - 1):
            continue
        p = JP.plan_for(S, J, V, wb, fit, ti, TC, TSg, w == "resident")
        if p is not None and p not in out:
            out.append(p)
    return out


def profile_k9(S: int, device, V: int = K9_V, **splits) -> Dict[str, dict]:
    """{"bf16 <split>" ...: {"plan", "equal", "total_us", "phases",
    "event_ms", "device_us", "host_us", "simt_event_ms", "simt_device_us",
    "simt_host_us"}} for kernel 9 at S sessions, on the card's plan and the
    splits `k9_plans` names."""
    from april_asr_tpu_torch.ops import joiner_kernels as JK

    from .profile_lstm_mma import breakdown, event_ms, host_and_device_us

    index = torch.device(device).index or 0
    out = {}
    for name, wd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        w_t, b, blank = k9_weights(wd, device, V)
        J, wb = w_t.shape[0], w_t.element_size()
        eout, dout = k9_case(w_t, S, np.random.default_rng(S + 9), device)
        simt = lambda: JK.joiner_argmax_simt(eout, dout, w_t, b, blank)  # noqa: E731
        want = simt()
        s_host, s_dev = host_and_device_us(simt, keys=("joiner_tile", "argmax_final", "Memset"))
        s_ms = event_ms(simt)
        for plan in k9_plans(S, J, V, wb, index, **splits):
            run = lambda st, p=plan: JK.joiner_argmax_stream(  # noqa: E731
                eout, dout, w_t, b, blank, plan=p, stamps=st)
            got = run(None)
            torch.cuda.synchronize()
            res = {"plan": plan, "equal": all(torch.equal(g, x) for g, x in zip(got, want)),
                   "event_ms": event_ms(lambda: run(None)), "simt_event_ms": s_ms,
                   "simt_host_us": s_host, "simt_device_us": s_dev}
            res["host_us"], res["device_us"] = host_and_device_us(
                lambda: run(None), keys=("joiner_stream",))
            st = torch.zeros((plan.blocks, 5 + 3 * plan.rounds), dtype=torch.int64,
                             device=device)
            run(st)
            run(st)
            torch.cuda.synchronize()
            s = st.cpu().numpy()
            res["total_us"] = float(s[:, -1].max() - s[:, 0].min()) / 1e3
            res["phases"] = breakdown(s, k9_phases(plan.rounds))
            out[f"{name} {k9_split(plan)}"] = res
    return out


def k9_split(plan) -> str:
    return (f"tile {plan.RC}x{plan.RS} Vc={plan.Vc} TS={plan.TS} W "
            f"{'resident' if plan.w_resident else 'streamed'}")


def report_k9(res: Dict[str, dict], S: int, V: int, card: str = "") -> None:
    for name, r in res.items():
        p = r["plan"]
        parts = "; ".join(f"{k} {v['critical_us']:.2f} us (x{v['n']}, blocks' median "
                          f"{v['median_us']:.2f})" for k, v in r["phases"].items())
        print(f"profile_decode kernel 9 {name} S={S} V={V}: {p.blocks} blocks ({p.n_vs} slices x "
              f"{p.n_sg} session groups, {p.blocks_per_sm} an SM), {p.rounds} tiles a block, "
              f"{p.smem} bytes of shared memory a block, cycles a k {p.cycles_per_k}; outputs "
              f"{'equal' if r['equal'] else 'DIFFER from'} joiner_argmax_simt's; stamped launch "
              f"{r['total_us']:.2f} us; without stamps: CUDA events {r['event_ms'] * 1e3:.2f} us a "
              f"call, device time (profiler) {r['device_us']:.2f} us, host per call queued "
              f"{r['host_us']:.2f} us; joiner_argmax_simt: CUDA events "
              f"{r['simt_event_ms'] * 1e3:.2f} us, device time {r['simt_device_us']:.2f} us, host "
              f"per call {r['simt_host_us']:.2f} us; critical path by phase: {parts}"
              + (f" ({card})" if card else ""))


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(",") if x) if text else ()


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--P", type=int, default=27)
    ap.add_argument("--V", type=int, default=K9_V, help="kernel 9's vocabulary")
    ap.add_argument("--kernel", type=int, choices=(4, 8, 9), help="one kernel (default: all)")
    ap.add_argument("--ts", default="", help="kernel 8 on tiles of this many sessions; kernel 9 "
                    "on tiles of each of these (comma-separated; default: the plan's)")
    ap.add_argument("--vc", default="", help="kernel 9 on slices of each of these many columns")
    ap.add_argument("--tile", default="", help="kernel 9 on register tiles of these columns")
    ap.add_argument("--w", default="", help="kernel 9 with W resident and/or streamed")
    args = ap.parse_args(argv)
    res = {}
    if args.kernel in (None, 4):
        res["kernel 4"] = profile(args.S, args.P, torch.device("cuda"))
        report(res["kernel 4"], args.S, args.P)
    if args.kernel in (None, 8):
        res["kernel 8"] = profile_dj(args.S, torch.device("cuda"),
                                     int(args.ts) if args.ts and args.kernel == 8 else None)
        report_dj(res["kernel 8"], args.S)
        bad = [k for k, r in res["kernel 8"].items() if not r["equal"]]
        if bad:
            raise SystemExit(f"profile_decode: kernel 8 differs from dec_joiner_simt: {bad}")
    if args.kernel in (None, 9):
        res["kernel 9"] = profile_k9(
            args.S, torch.device("cuda"), args.V,
            ts=_ints(args.ts) if args.kernel == 9 else (), vc=_ints(args.vc),
            tiles=_ints(args.tile), ws=tuple(w for w in args.w.split(",") if w))
        report_k9(res["kernel 9"], args.S, args.V)
        bad = [k for k, r in res["kernel 9"].items() if not r["equal"]]
        if bad:
            raise SystemExit(f"profile_decode: kernel 9 differs from joiner_argmax_simt: {bad}")
    return res


if __name__ == "__main__":
    main()
