"""Where kernels 4 and 8 spend their time: the phases of one launch of each
cluster kernel (csrc/chunk_decode_cluster.cu, csrc/dec_joiner_cluster.cu)
from each block's stamps (the global nanosecond timer), beside the
CUDA-core kernel it replaced (`chunk_decode_simt`, `dec_joiner_simt`).

    python -m april_asr_tpu_torch.tools.profile_decode [--S 256] [--P 27] [--kernel 4|8] [--ts N]

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


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--P", type=int, default=27)
    ap.add_argument("--kernel", type=int, choices=(4, 8), help="one kernel (default: both)")
    ap.add_argument("--ts", type=int, help="kernel 8 on tiles of this many sessions (default: "
                    "the plan's)")
    args = ap.parse_args(argv)
    res = {}
    if args.kernel in (None, 4):
        res["kernel 4"] = profile(args.S, args.P, torch.device("cuda"))
        report(res["kernel 4"], args.S, args.P)
    if args.kernel in (None, 8):
        res["kernel 8"] = profile_dj(args.S, torch.device("cuda"), args.ts)
        report_dj(res["kernel 8"], args.S)
        bad = [k for k, r in res["kernel 8"].items() if not r["equal"]]
        if bad:
            raise SystemExit(f"profile_decode: kernel 8 differs from dec_joiner_simt: {bad}")
    return res


if __name__ == "__main__":
    main()
