"""Test and smoke-run helpers: the vocabulary of april_asr_tpu/testing.py
that random-weight models use, a recorder of the plain greedy decode's
decision margins, and a launcher of tensor-parallel rank processes.

`RankGroup` runs a function of this package in m processes that meet in a
gloo process group (for the TP engine: one process per model shard). The
processes are started with `subprocess` as `python -m
april_asr_tpu_torch.testing JOB RANK` (they import torch, never JAX) and
meet at a `file://` store in a private temporary directory, so that any
number of groups can run side by side; the group and the join each have a
time limit, so a rank that never arrives fails the run instead of hanging
it.

    group = RankGroup("april_asr_tpu_torch.testing:engine_run", args, world=2)
    ...                     # other work while the ranks run
    results = group.join()  # one result per rank, in rank order
"""

from __future__ import annotations

import contextlib
import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np


def default_tokens(vocab: int, blank_id: int = 0) -> List[bytes]:
    """A plausible SentencePiece-like vocabulary for testing: blank, word
    pieces with/without leading space, punctuation, digits."""
    base = [
        b"<blk>", b" the", b" a", b" and", b" to", b" of", b" in", b" it",
        b" is", b" was", b" i", b" he", b" that", b" you", b" his", b" on",
        b"s", b"ing", b"ed", b"er", b"ly", b"tion", b"es", b"re", b"an",
        b"ar", b"or", b"en", b"al", b"le", b".", b",", b"!", b"?", b"'",
        b"0", b"1", b"2", b"3", b"9", b" one", b" two", b" ten", b" time",
        b" hand", b" day", b" way", b" man", b" world", b" great", b" old",
        b" right", b" elephant", b" cool", b" water", b" sound", b" place",
        b"ous", b"ment", b"ness", b"ful", b"ted", b"ter", b"ver",
    ]
    toks = list(base[:vocab])
    i = 0
    while len(toks) < vocab:
        toks.append(f"tok{i}".encode())
        i += 1
    toks[blank_id] = b"<blk>"
    return toks


class DecisionMargins:
    """Records, for every round of the plain greedy decode (the plain joiner
    `ops/joiner_kernels.joiner_argmax_plain`, or the interpreter's logits
    through `decode/greedy.py` `greedy_prologue`, then `decode_step_pre`, in
    the whole-chunk decode and in the per-pull `inner_decode` alike) and every
    session, the smallest margin by which a float decision was taken: blank
    against the best token (with the early-emit bonus), the best token
    against the second best, and the punctuation and confident-blank
    thresholds where they applied (inf for sessions not decoding in that
    round). Int8 re-quantization turns an f32 ulp into a logit shift of
    about 1e-3, so two implementations may take a decision apart only where
    its margin is small; parity checks use this to show that the first
    event where two streams part was a near-tie.

        with DecisionMargins() as m:
            engine.tick()
        m.per_cell(n_cells)  # [n_cells, S], rounds in event-cell order
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.cells = []

    def per_cell(self, n_cells: int) -> np.ndarray:
        """Margins of the rounds since the last reset, padded with inf to
        `n_cells` (the flush's closing event group takes no decision)."""
        m = np.stack(self.cells)
        pad = np.full((n_cells - m.shape[0], m.shape[1]), np.inf)
        return np.concatenate([m, pad])

    def __enter__(self):
        from .decode import greedy
        from .ops import joiner_kernels as jk

        self._mods = (jk, greedy)
        self._orig = (jk.joiner_argmax_plain, greedy.decode_step_pre, greedy.greedy_prologue)
        self._gap = None
        orig_prologue, orig_step, orig_logits_prologue = self._orig

        def top2_gap(logits, blank_id):
            logits = logits.clone()
            logits[:, blank_id] = float("-inf")
            top2 = logits.topk(2, dim=1).values
            self._gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()

        def prologue(eout, dout, w_t, b, blank_id):
            top2_gap(jk.joiner_logits_plain(eout, dout, w_t, b), blank_id)
            return orig_prologue(eout, dout, w_t, b, blank_id)

        def logits_prologue(logits, blank_id):
            # the interpreter's route: the joiner's logits, then decode_step
            top2_gap(logits, blank_id)
            return orig_logits_prologue(logits, blank_id)

        def step(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg):
            self._record(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg)
            return orig_step(state, max_idx, max_val, blank_val, active, early_emit, blank_id, vt, cfg)

        jk.joiner_argmax_plain, greedy.decode_step_pre, greedy.greedy_prologue = (
            prologue, step, logits_prologue)
        return self

    def __exit__(self, *exc):
        jk, greedy = self._mods
        jk.joiner_argmax_plain, greedy.decode_step_pre, greedy.greedy_prologue = self._orig

    def _record(self, state, mi, mv, bv, active, early_emit, blank_id, vt, cfg):
        from .decode.greedy import MASK_PUNCT

        f = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
        mi, mv, bv = mi.cpu().numpy(), f(mv), f(bv)
        last = state["context"][:, -1].cpu().numpy()
        eq = last == mi
        eff = np.where(eq, 0.0, early_emit)
        margin = np.minimum(np.abs(bv - eff - mv), self._gap)
        punct = (np.asarray(vt["mask"])[mi] & MASK_PUNCT) != 0
        boost_live = punct & (last != blank_id) & ~eq
        margin = np.where(boost_live, np.minimum(margin, np.abs(mv - (bv - cfg.punctuation_margin))), margin)
        t_since = f(state["time_ms"] - state["last_emit_ms"])
        blank = (bv - eff > mv) & ~(boost_live & (mv > bv - cfg.punctuation_margin))
        conf_live = blank & ~eq & (t_since < cfg.long_silence_ms)
        decayed = mv - t_since / cfg.silence_decay_ms
        margin = np.where(conf_live, np.minimum(margin, np.abs(decayed - (bv - cfg.confident_margin))), margin)
        self.cells.append(np.where(active.cpu().numpy(), margin, np.inf))


# A logit margin under which two implementations may take a decision apart.
# Int8 re-quantization turns an f32 ulp at a rounding boundary into one int8
# step, the steps compound through the recurrent state, and two
# implementations' encoder states are only held to p99 < 0.05 (the
# cross-implementation bound of tests/test_lstm_int8.py:69-80); a logit
# moves by as much.
NEAR_TIE = 0.05
# The same for two bf16 engines. Their states are bf16-rounded at every
# product, so two valid f32 sum orders (kernel 10, the two-kernel layer it
# replaced, the plain layers) move a logit margin further than the int8
# states' p99 bound: tools/parting_witness.py over seeds 0-4 (the flagship
# random model at bf16, S = 256, 10 ticks of 1 s and a flush; NVIDIA H100
# 80GB HBM3, 700 W) measured a largest margin shift of 0.0683 between two
# valid orders (seed 0, plain layers against the two-kernel layer, in step)
# and partings at margins up to 0.0504; 0.0683 rounded up.
NEAR_TIE_BF16 = 0.07
EVENT_FIELDS = ("ops", "tok", "flags", "final_k")
INT_DECODE = ("context", "token_words", "head", "last_call", "time_ms", "last_emit_ms",
              "need_dec", "emitted_silence")


def capture_events(prog, unpack, sink: list) -> None:
    """Wrap prog.step and prog.flush so every call's events, unpacked by
    `unpack` (an engine/step.py `unpack_events_np`), are appended to sink."""
    for name in ("step", "flush"):
        fn = getattr(prog, name)

        def wrapped(*a, fn=fn):
            state, packed = fn(*a)
            sink.append(unpack(packed))
            return state, packed

        setattr(prog, name, wrapped)


def near_tie(precision: str | None) -> float:
    """The margin under which two engines serving at `precision` ("int8",
    "bf16", "f32", or None for the weights as loaded) may take a decision
    apart: NEAR_TIE_BF16 at bf16, NEAR_TIE otherwise."""
    return NEAR_TIE_BF16 if precision == "bf16" else NEAR_TIE


def check_parting(step, ev_ref, ev, cells, recs_ref, recs, dec_ref, dec, parted: dict,
                  over: list | None = None, precision: str | None = None) -> None:
    """One engine step of a lockstep comparison of two engines on the same
    audio, both serving at `precision`. A session whose event cells
    (pull-major, round-minor) first differ in this step is entered in
    `parted` as (step, cell, margin) and must have been decided by less than
    `near_tie(precision)` there (`cells` [n, S] from DecisionMargins on the
    plain side); a session still in step must have equal callbacks `recs`
    and integer decode state (`dec`: INT_DECODE keys to host arrays). Raises
    AssertionError otherwise; with `over`, a parting at or above the bound
    is appended there (as its session) and the check goes on."""
    tie = near_tie(precision)
    for s in range(ev_ref["ops"].shape[0]):
        if s in parted:
            continue
        differ = np.zeros(np.asarray(ev_ref["ops"][s]).size, bool)
        for f in EVENT_FIELDS:
            differ |= (np.asarray(ev_ref[f][s]) != np.asarray(ev[f][s])).reshape(-1)
        if differ.any():
            first = int(np.argmax(differ))
            parted[s] = (step, first, float(cells[first, s]))
            if cells[first, s] >= tie and over is not None:
                over.append(s)
            elif cells[first, s] >= tie:
                raise AssertionError(
                    f"session {s} parted at step {step}, event cell {first}, where the "
                    f"plain decode's margin was {cells[first, s]:.4f} >= {tie} ({precision})")
            continue
        if recs_ref[s] != recs[s]:
            raise AssertionError(f"session {s}: callbacks differ while the events agree")
        for key in INT_DECODE:
            if not np.array_equal(dec_ref[key][s], dec[key][s]):
                raise AssertionError(f"session {s}: decode state {key} differs while the events agree")


class RankGroup:
    """`world` processes, each calling `fn(args)` ("module:function", a
    function of this package; it makes its mesh with parallel.make_mesh)
    inside an initialised gloo default group, with `threads` torch threads.
    `join` returns their results (pickled by the ranks into this group's
    directory) or raises with the failing ranks' output."""

    def __init__(self, fn: str, args, world: int, timeout: float = 300.0, threads: int = 2):
        self.world, self.timeout = world, timeout
        self.dir = Path(tempfile.mkdtemp(prefix="april_ranks_"))
        job = self.dir / "job.pkl"
        with open(job, "wb") as f:
            pickle.dump({"fn": fn, "args": args, "world": world, "timeout": timeout,
                         "threads": threads, "store": str(self.dir / "store")}, f)
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parent.parent)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.deadline = time.monotonic() + timeout
        self.logs = [open(self.dir / f"rank{r}.log", "wb") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, "-m", "april_asr_tpu_torch.testing",
                                        str(job), str(r)], stdout=log, stderr=subprocess.STDOUT,
                                       env=env)
                      for r, log in enumerate(self.logs)]

    def _tail(self, r: int, n: int = 4000) -> str:
        return (self.dir / f"rank{r}.log").read_bytes()[-n:].decode(errors="replace")

    def join(self) -> list:
        try:
            # a rank that fails ends the group at once: the others would wait
            # for it in a collective until the group's time limit
            while not all(p.poll() == 0 for p in self.procs):
                bad = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if bad:
                    raise RuntimeError("".join(
                        f"rank {r} exited with {self.procs[r].returncode}:\n{self._tail(r)}\n"
                        for r in bad))
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"rank processes still running after {self.timeout} s:\n"
                                       + "\n".join(self._tail(r) for r in range(self.world)))
                time.sleep(0.05)
            out = []
            for r in range(self.world):
                with open(self.dir / f"rank{r}.out", "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def _rank_main(job_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job["threads"])
    dist.init_process_group("gloo", init_method="file://" + job["store"], rank=rank,
                            world_size=job["world"],
                            timeout=datetime.timedelta(seconds=job["timeout"]))
    try:
        mod, name = job["fn"].split(":")
        out = getattr(importlib.import_module(mod), name)(job["args"])
    finally:
        dist.destroy_process_group()
    tmp = Path(job_path).parent / f"rank{rank}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, Path(job_path).parent / f"rank{rank}.out")


def _np(t):
    return t.detach().cpu().numpy()


def engine_run(args: dict) -> dict:
    """One engine over `args["ticks"]` ticks of `args["audio"]` ([ticks, S,
    chunk] int16) and a flush of every slot: a tensor-parallel BatchEngine
    over `make_mesh(model_parallel=args["m"])` when m > 1 (a rank function
    for RankGroup), else the single-device engine of `args["rt"]` or of the
    model at `args["path"]` and `args["precision"]`. Returns per call (each
    step, then the flush): the unpacked events, the raw event blob, the
    callbacks, the INT_DECODE state, the launch counts and the wall ms;
    with `args["margins"]`, also the plain decode's DecisionMargins per
    event cell (the decode must then run its plain versions: on the CPU, or
    through a runtime whose `decoder_joiner_argmax` is the plain one). With
    `args["profile"]` (a CUDA run), the calls it names (indices) run under
    torch.profiler: out["profile"][call] = {"kernels": {device kernel name:
    (device us, launches)}, "wall_ms"}. With `args["tp_kernels"]` "simt",
    the tensor-parallel step runs kernels 18-21 on the column-pass kernels
    they replaced (the yardstick of a before-and-after breakdown). Raises
    where the engine caught a program failure (engine/batch.py
    `CONTAINED`): every call must run on its first try."""
    import torch

    from .config import EngineConfig
    from .engine.batch import CONTAINED, BatchEngine
    from .engine.step import unpack_events_np
    from .ops import cuda_build

    dev = args["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    rt = args.get("rt")
    if rt is None:
        from .api.model import Model

        rt = Model(args["path"], precision=args["precision"], device=dev).runtime
    mesh = None
    if args["m"] > 1:
        from .parallel import make_mesh

        mesh = make_mesh(model_parallel=args["m"])
    audio = args["audio"]
    S = audio.shape[1]
    contained = dict(CONTAINED)
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=audio.shape[2]), mesh=mesh)
    calls = []
    capture_events(eng.prog, lambda p: (unpack_events_np(p), _np(p.blob)), calls)
    recs = [[] for _ in range(S)]
    for i in range(S):
        eng.alloc(lambda r, toks, i=i: recs[i].append(
            (int(r), tuple((int(t.token_id), int(t.time_ms)) for t in toks))))
    margins = DecisionMargins() if args.get("margins") else None
    out = {"events": [], "blobs": [], "recs": [], "dec": [], "counts": [], "ms": [],
           "cells": [], "c_shape": tuple(eng.state["c"].shape)}
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    prof_calls = set(args.get("profile") or ()) if dev == "cuda" else set()
    if prof_calls:
        out["profile"] = {}
    with margins if margins is not None else contextlib.nullcontext(), \
            _tp_simt() if args.get("tp_kernels") == "simt" else contextlib.nullcontext():
        for k in range(args["ticks"] + 1):
            if margins is not None:
                margins.reset()
            sync()
            cuda_build.reset_counts()
            prof = _profiler() if k in prof_calls else contextlib.nullcontext()
            with prof:
                t0 = time.perf_counter()
                if k < args["ticks"]:
                    for i in range(S):
                        eng.feed(i, audio[k, i])
                    eng.tick()
                else:
                    eng.flush(np.ones(S, bool))
                sync()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
            if k in prof_calls:
                out["profile"][k] = {"wall_ms": out["ms"][-1], "kernels": {
                    e.key: (e.self_device_time_total, e.count)
                    for e in prof.key_averages() if e.self_device_time_total > 0}}
            out["counts"].append({c: v for c, v in cuda_build.COUNTS.items() if v})
            ev, blob = calls[-1]
            out["events"].append(ev)
            out["blobs"].append(blob)
            out["recs"].append([list(r) for r in recs])
            out["dec"].append({key: _np(eng.state["decode"][key]) for key in INT_DECODE})
            if margins is not None:
                out["cells"].append(margins.per_cell(ev["ops"].shape[1] * ev["ops"].shape[2]))
    if CONTAINED != contained:
        raise RuntimeError(f"engine_run: the engine caught program failures ({contained} -> "
                           f"{CONTAINED})")
    return out


def speaker_run(args: dict) -> dict:
    """A rank function for RankGroup (or a call in one process at m = 1):
    the engine of the model at `args["path"]` and `args["precision"]`
    (tensor-parallel over `make_mesh(model_parallel=args["m"])` when m > 1)
    over `args["audio"]` ([ticks, S, chunk] int16), then every slot's state
    saved under `args["model"]` and the speaker keys "spk<slot>"
    (engine/speaker.py; on a TP engine a collective). Then a fresh engine of
    the same mesh restores "spk0" into its last slot. Returns the rows the
    save wrote for slot 0 ("snapshot", read back from its file), and this
    rank's h, c (its slice on a TP engine), context and dout rows of the
    restored slot ("restored")."""
    import torch

    from .api.model import Model
    from .config import EngineConfig
    from .engine.batch import BatchEngine
    from .engine.speaker import restore_speaker_state, save_speaker_state, speaker_path

    rt = Model(args["path"], precision=args["precision"], device="cpu").runtime
    mesh = None
    if args["m"] > 1:
        from .parallel import make_mesh

        mesh = make_mesh(model_parallel=args["m"])
    audio = args["audio"]
    S = audio.shape[1]
    cfg = EngineConfig(chunk_samples=audio.shape[2])
    eng = BatchEngine(rt, batch=S, cfg=cfg, mesh=mesh)
    for _ in range(S):
        eng.alloc(lambda r, toks: None)
    for k in range(audio.shape[0]):
        for i in range(S):
            eng.feed(i, audio[k, i])
        eng.tick()
    saved = [save_speaker_state(eng, i, args["model"], f"spk{i}") for i in range(S)]
    with np.load(speaker_path(args["model"], "spk0")) as f:
        snapshot = {k: np.asarray(f[k]) for k in f.files}
    fresh = BatchEngine(rt, batch=S, cfg=cfg, prog=eng.prog, mesh=mesh)
    applied = restore_speaker_state(fresh, S - 1, args["model"], "spk0")
    st = fresh.state
    with torch.no_grad():
        restored = {"h": _np(st["h"][:, S - 1]), "c": _np(st["c"][:, S - 1]),
                    "context": _np(st["decode"]["context"][S - 1]),
                    "dout": _np(st["decode"]["dout"][S - 1])}
    return {"saved": saved, "applied": applied, "snapshot": snapshot, "restored": restored,
            "rank": 0 if mesh is None else mesh.rank}


def contain_run(args: dict) -> dict:
    """A rank function for RankGroup: the tensor-parallel CPU engine of the
    model at `args["path"]` and `args["precision"]` over
    `make_mesh(model_parallel=args["m"])` ticks `args["audio"]` ([ticks, S,
    chunk] int16). On rank `args["fail_rank"]` alone the last tick's step
    program raises after it has run (its collectives met), as a failure
    local to one process would. Then every rank scrubs, together. Returns
    this rank's rank, what its last tick did ("ticked" or the error's
    text), the failures and recoveries it counted (engine/batch.py
    `CONTAINED`), its SESSION_ERROR callbacks and the scrub's evictions."""
    import dataclasses

    from .api.model import Model
    from .config import EngineConfig
    from .decode.scalar import RESULT_SESSION_ERROR
    from .engine.batch import CONTAINED, BatchEngine
    from .parallel import make_mesh

    rt = Model(args["path"], precision=args["precision"], device="cpu").runtime
    mesh = make_mesh(model_parallel=args["m"])
    audio = args["audio"]
    S, ticks = audio.shape[1], audio.shape[0]
    eng = BatchEngine(rt, batch=S, cfg=EngineConfig(chunk_samples=audio.shape[2]), mesh=mesh)
    errors = []
    for _ in range(S):
        eng.alloc(lambda r, toks: errors.append(r) if r == RESULT_SESSION_ERROR else None)
    before = dict(CONTAINED)
    last = "ticked"
    for k in range(ticks):
        if k == ticks - 1 and mesh.rank == args["fail_rank"]:
            orig = eng.prog.step

            def step(*a, orig=orig):
                orig(*a)
                raise RuntimeError("injected failure on one rank")

            eng.prog = dataclasses.replace(eng.prog, step=step)
        for i in range(S):
            eng.feed(i, audio[k, i])
        try:
            eng.tick()
        except RuntimeError as e:
            last = str(e)
    return {"rank": mesh.rank, "last": last, "errors": len(errors), "scrubbed": eng.scrub(),
            "counted": {k: CONTAINED[k] - before[k] for k in CONTAINED}}


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


# the tensor-parallel step's kernels (their names in the TP stack's module)
# and the kept column-pass kernels they replaced
TP_SIMT = {"lstm_gate_cell_proj": "lstm_gate_cell_proj_simt",
           "lstm_gates_cell_i8": "lstm_gates_cell_i8_simt",
           "ffn_partial": "ffn_partial_simt", "ffn_mid_i8": "ffn_mid_i8_simt"}


@contextlib.contextmanager
def _tp_simt():
    """The tensor-parallel step's kernels 18-21 on their kept column-pass
    kernels while the block runs."""
    from .models import lstm_transducer as TM
    from .ops import lstm_tp_kernels as TK

    saved = {k: getattr(TM, k) for k in TP_SIMT}
    for k, v in TP_SIMT.items():
        setattr(TM, k, getattr(TK, v))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(TM, k, v)


def tp_cases(args: dict) -> list:
    """A rank function for RankGroup: every case of `args["cases"]` on this
    rank, in order, each a dict with `kind`:

    * "stack": the TP stack `_lstm_stack_step_tp` over `make_mesh(m)` on
      `params` (numpy, the JAX package's keys) and x, h, c (whole: this rank
      takes its slice of c), gated by `gate` where it is not None; and the
      single-device `_lstm_stack_step` on the same inputs. Returns
      {"tp": (y, h, c_local), "single": (y, h, c)} as numpy.
    * "engine": `engine_run(case)` at model_parallel m.
    * "mesh": `make_mesh(model_parallel=case["m"])`; returns the exception's
      type and message, or None if it made a mesh."""
    import torch

    from .models.convert import from_jax_params
    from .models.lstm_transducer import _lstm_stack_step, _lstm_stack_step_tp
    from .parallel import make_mesh, prepare_tp_weights

    out = []
    for case in args["cases"]:
        if case["kind"] == "engine":
            out.append(engine_run(case))
        elif case["kind"] == "mesh":
            try:
                make_mesh(model_parallel=case["m"])
                out.append(None)
            except (NotImplementedError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        else:
            mesh = make_mesh(model_parallel=case["m"])
            p = from_jax_params(case["params"])
            t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
            x, h, c, gate = (t(case[k]) for k in ("x", "h", "c", "gate"))
            n = c.shape[2] // mesh.model_parallel
            c_local = c[:, :, mesh.rank * n : (mesh.rank + 1) * n].contiguous()
            with torch.no_grad():
                tp = _lstm_stack_step_tp(prepare_tp_weights(p, mesh), x, h, c_local, mesh, gate)
                single = _lstm_stack_step(p, x, h, c, gate)
            out.append({"tp": tuple(_np(v) for v in tp), "single": tuple(_np(v) for v in single)})
    return out


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
