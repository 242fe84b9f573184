"""Batched engine step: audio chunk -> fbank -> encoder -> decode events
(port of april_asr_tpu/engine/step.py, the native chunk-encoder branch).

One step advances every session by one audio chunk: the fbank accept
(kernel 1 for int8 engines, else kernel 5), one ring read of every pull
window, one batched conv embed (kernel 16 from the front buffer at bf16 conv
weights, i.e. int8 and bf16 engines; the stacked windows through
`encoder_embed` at f32), the 12-layer chunk encoder over all P pulls
(kernels 2 and 3 per layer at int8, kernel 10 per layer at f32 or bf16;
at widths zero-padded to multiples of 4 where a model's are not,
models/lstm_transducer.py `padded_layers`),
then the greedy decode: the whole chunk's in one launch of kernel 4 where
the JAX package's gate `chunk_decode_supported` passes and a kernel 4 holds
the shapes (ops/decode_kernels.py `decode_route`: the cluster kernel's
plan, else the CUDA-core kernel's block), else pull by pull through
`inner_decode`, as the JAX step's scan does. Handler-visible actions
leave the device as the compact APR4 event blob, bit-identical in layout to
the JAX package's (see the layout note below).

A runtime without `encoder_chunk` takes the per-pull recurrent scan
instead of the chunk encoder and its decode: for each pull, `time_ms`,
`encoder_recurrent` gated by the pull mask, then `inner_decode`. A runtime
without a split encoder (`encoder_embed` None: the ONNX interpreter's,
models/loader.py `kind="interp"`) steps as the flush does, P rounds of
`pull_once` (JAX step.py:607-615), and decodes from its joiner's logits
(`inner_decode`'s third branch); its frontend is kernel 5. The
tensor-parallel programs (`build_engine(..., mesh=)`, one process per model
shard over torch.distributed) are such a runtime: the encoder runs kernels
18 and 20 (float) or 19 and 21 (int8) per layer on this shard with the
all-reduces between them (models/lstm_transducer.py `_lstm_stack_step_tp`);
everything else runs replicated, so every rank gives the same events.

The flush program reproduces _aas_flush (src/april_session.c:547-564) as
masked pull rounds, each `pull_once` as in the JAX package: the one-step
encoder (kernel 7 per layer at int8, kernel 12 at f32 or bf16), the h/c
select by the pull mask, and `inner_decode`, three rounds of
`decoder_joiner_argmax` (kernel 8, or the decoder step and kernel 9 where
the gate `dj_supported` refuses) and `decode_step_pre`.

Event blob layout (per sub-blob; one int32 vector):
  [0] BLOB_MAGIC  [1] S  [2] K cell capacity  [3] stride_ms
  [4, 4+S) per-session event count   [4+S, 4+2S) per-session base time_ms
  [.., +K) cell word0 = ops(7b) | flags(2b)<<7 | final_k(7b)<<9 | tok(14b)<<16
  [.., +K) cell logprob, f32 bits   [.., +K/4) cell dt in stride units, u8 x4
Cells are session-major in (round, inner-step) order; past the event count
the cells repeat the JAX package's padding exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..config import DecodeConfig, EngineConfig
from ..decode import events as ev
from ..decode import greedy
from ..decode.greedy import init_decode_state, vocab_tables_device
from ..frontend.fbank import (
    FbankLayout,
    fbank_accept_batch,
    fbank_advance,
    fbank_advance_n,
    fbank_flush_pad,
    fbank_front_batch,
    fbank_init,
    fbank_peek,
)
from ..models.lstm_transducer import (
    encoder_recurrent_tp,
    encoder_step_tp,
    is_quantized,
    layer_widths,
)
from ..models.loader import ModelRuntime
from ..ops import lstm_mma
from ..ops import tp_plan as TP
from ..ops.decode_kernels import (
    EVENT_KEYS,
    chunk_decode,
    decode_plan,
    decode_route,
    device_max_clusters,
    nominal_clusters,
)
from ..ops.lstm_tp_kernels import tp_smem
from ..ops.widths import round_up
from ..parallel.mesh import shard_state
from ..parallel.tp import tp_shard_map_eligible

INNER_STEPS_EMIT = (1.0, 0.0, 0.0)  # early-emit ramp (april_session.c:449-453)
BLOB_MAGIC = 0x41505234  # "APR4"
BLOB_HEADER = 4


def events_budget(rounds: int, cfg_budget: int = 0) -> int:
    """Per-session compact-cell budget for a program with `rounds` pulls."""
    if cfg_budget > 0:
        return cfg_budget
    return max(8, -(-rounds * 3 // 5))


class PackedEvents(NamedTuple):
    """Step/flush event outputs: the compact `blob` (read every tick) and
    the `dense` [S, R, 2I+1] tensor (read only when the blob overflows)."""

    blob: torch.Tensor
    dense: torch.Tensor


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to int32 two's complement (jnp int32 overflow)."""
    x = torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)
    return x.to(torch.int32)


def pack_events(events: Dict[str, torch.Tensor], base_time: torch.Tensor, stride_ms: int,
                budget: int = 0) -> PackedEvents:
    """Events {key: [S, R, I]} -> PackedEvents, on the events' device."""
    dev = events["ops"].device
    i64 = torch.int64
    word0 = (
        events["ops"].to(i64)
        | (events["flags"].to(i64) << 7)
        | (events["final_k"].to(i64) << 9)
        | (events["tok"].to(i64) << 16)
    )
    word0 = _as_i32(word0)
    lp = events["logprob"].to(torch.float32).contiguous().view(torch.int32)
    time = events["time_ms"][:, :, :1].to(torch.int32)
    dense = torch.cat([word0, lp, time], dim=2)

    S, R, I = word0.shape
    if R > 255:
        raise ValueError(f"{R} rounds overflow the 8-bit cell dt (max 255)")
    N = R * I
    K = S * events_budget(R, budget)
    base_time = base_time.to(torch.int32)

    mask = events["ops"].reshape(S, N) != 0
    midx = torch.cumsum(mask.to(i64), dim=1) - 1
    counts = mask.sum(dim=1).to(torch.int32)
    srcn = torch.zeros((S, N), dtype=i64, device=dev)
    rows, cols = mask.nonzero(as_tuple=True)
    srcn[rows, midx[rows, cols]] = cols
    cum = torch.cumsum(counts.to(i64), dim=0)
    k_ids = torch.arange(K, dtype=i64, device=dev)
    n_ge = torch.searchsorted(cum, k_ids, right=True)
    s_k = torch.clamp(n_ge, max=S - 1)
    off_k = torch.where(n_ge > 0, cum[torch.clamp(n_ge - 1, min=0)], torch.zeros_like(n_ge))
    j_k = torch.clamp(k_ids - off_k, 0, N - 1)
    n_k = srcn.reshape(-1)[torch.clamp(s_k * N + j_k, 0, S * N - 1)]
    src = s_k * N + n_k

    dt = torch.div(
        events["time_ms"].to(i64) - base_time.to(i64)[:, None, None], stride_ms,
        rounding_mode="floor",
    ).reshape(S * N)
    w0_k = word0.reshape(-1)[src]
    lp_k = lp.reshape(-1)[src]
    dt_k = torch.clamp(dt[src], 0, 255)
    Kp = -(-K // 4) * 4
    dt_p = torch.nn.functional.pad(dt_k, (0, Kp - K)).reshape(Kp // 4, 4)
    dt_w = _as_i32(dt_p[:, 0] | (dt_p[:, 1] << 8) | (dt_p[:, 2] << 16) | (dt_p[:, 3] << 24))
    header = torch.tensor([BLOB_MAGIC, S, K, stride_ms], dtype=torch.int32, device=dev)
    blob = torch.cat([header, counts, base_time, w0_k, lp_k, dt_w])
    return PackedEvents(blob=blob, dense=dense)


def unpack_events_np(packed) -> Dict[str, np.ndarray]:
    """Dense-tensor unpack (accepts a PackedEvents or a raw dense array)."""
    if isinstance(packed, PackedEvents):
        packed = packed.dense
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    I = (arr.shape[2] - 1) // 2
    w = arr[:, :, :I]
    return {
        "ops": w & 0x7F,
        "flags": (w >> 7) & 0x3,
        "final_k": (w >> 9) & 0x7F,
        "tok": (w >> 16) & 0x3FFF,
        "logprob": np.ascontiguousarray(arr[:, :, I : 2 * I]).view(np.float32),
        "time_ms": arr[:, :, 2 * I],
    }


def iter_blobs(arr: np.ndarray):
    """Split a host copy of the blob vector into sub-blobs; yields
    (slot_base, sub_blob)."""
    pos = 0
    base = 0
    n = arr.shape[0]
    while pos < n:
        if arr[pos] != BLOB_MAGIC:
            raise ValueError(f"bad event blob magic at {pos}: {arr[pos]:#x}")
        S = int(arr[pos + 1])
        K = int(arr[pos + 2])
        size = BLOB_HEADER + 2 * S + 2 * K + (-(-K // 4))
        yield base, arr[pos : pos + size]
        pos += size
        base += S


def unpack_blob_np(sub: np.ndarray) -> Dict[str, np.ndarray]:
    """Decode one sub-blob into per-cell arrays (host-side, little-endian)."""
    S, K, stride = int(sub[1]), int(sub[2]), int(sub[3])
    o = BLOB_HEADER
    counts = sub[o : o + S]
    base_time = sub[o + S : o + 2 * S]
    w0 = sub[o + 2 * S : o + 2 * S + K]
    lp = np.ascontiguousarray(sub[o + 2 * S + K : o + 2 * S + 2 * K]).view(np.float32)
    dt = np.ascontiguousarray(sub[o + 2 * S + 2 * K :]).view(np.uint8)[:K]
    total = int(counts.sum())
    sess = np.repeat(np.arange(S), counts) if total <= K else None
    return {
        "S": S, "K": K, "stride": stride, "counts": counts, "base_time": base_time,
        "total": total, "overflow": total > K, "session": sess,
        "ops": w0 & 0x7F, "flags": (w0 >> 7) & 0x3, "final_k": (w0 >> 9) & 0x7F,
        "tok": (w0 >> 16) & 0x3FFF, "logprob": lp, "dt": dt,
    }


@dataclasses.dataclass
class EngineProgram:
    """The batched step/flush programs for one model + chunk size."""

    rt: ModelRuntime
    layout: FbankLayout
    cfg: EngineConfig
    dcfg: DecodeConfig
    step: Callable  # (weights, state, audio_i16 [S, chunk], n [S]) -> (state, PackedEvents)
    flush: Callable  # (weights, state, do_flush [S]) -> (state, PackedEvents)
    batch: int
    # The TP mesh (parallel/mesh.py) of a tensor-parallel program, else None.
    # When set, the program runs this process's model shard: weights must be
    # prepared with parallel.tp.prepare_tp_weights, and the cell state c
    # holds this shard's hidden slice (parallel.mesh.state_spec_tree).
    mesh: object = None
    # the model axes of the TP layout, and its family ("lstm"), or None
    tp_axes: tuple | None = None
    tp_family: str | None = None


def init_engine_state(prog: EngineProgram, weights=None) -> Dict:
    """Fresh state for `prog.batch` sessions on the model's device; the
    decoder is primed with the all-blank context (april_session.c:432-438)."""
    rt = prog.rt
    w = rt.weights if weights is None else weights
    S, dev, dims = prog.batch, rt.device, rt.dims
    # the interpreter's dims carry joiner_dim 0; its first decoder step
    # below gives dout its width (JAX step.py engine_state_init_fn)
    dstate = init_decode_state(S, dims.context, max(dims.joiner_dim, 1), rt.blank_id, prog.dcfg,
                               dev)
    dstate["dout"] = rt.decoder_step(w, dstate["context"])
    dstate["dout_init"] = torch.ones(S, dtype=torch.bool, device=dev)
    (L, dh), (_, dc) = rt.state_shapes
    state = {
        "fbank": fbank_init(prog.layout, S, dev),
        "h": torch.zeros((L, S, dh), dtype=torch.float32, device=dev),
        "c": torch.zeros((L, S, dc), dtype=torch.float32, device=dev),
        "decode": dstate,
    }
    # a TP program's c is this shard's [L, S, H/m] slice
    return shard_state(state, prog.mesh, prog.tp_axes) if prog.tp_axes else state


def check_kernel_plans(rt: ModelRuntime, S: int, P: int, n_sm: int, m: int = 1,
                       tokens: int = DecodeConfig().max_active_tokens,
                       max_clusters=nominal_clusters) -> None:
    """Plans every encoder layer kernel that a CUDA engine over S rows and P
    pulls a step launches, on a card of n_sm SMs, at the widths the kernels
    take (multiples of 4, zero-padded where the model's are not,
    models/lstm_transducer.py `padded_layers`): its step (kernel 2 or its
    int8 route, or kernel 10; kernel 3 plans at every width; with
    `encoder_chunk` None the per-pull step's), its flush (kernel 7 or its
    route, or kernel 12) and, at m > 1 model shards, the tensor-parallel
    kernels 18 and 20 (float) or 19 and 21 (int8) at the shard's widths
    padded likewise (`_lstm_stack_step_tp`): each by its route
    (ops/tp_plan.py `tp_route`), its one-launch kernel's plan or else its
    column-pass kernel's shared memory (`tp_smem`). With `encoder_chunk` it
    also plans the step's kernel 4 (ops/decode_kernels.py `decode_plan`, a
    token window of `tokens`) with `max_clusters` (the card's cluster
    occupancy). Raises one
    ValueError naming the widths and the kernel where one has no plan (or
    the card places none of kernel 4's clusters), so that a model the card
    cannot serve is refused when its engine is built, not at its first
    step or flush."""
    w = rt.weights
    q = is_quantized(w)
    wb = 1 if q else w["w_ih_t"].element_size()
    prec = {1: "int8", 2: "bf16", 4: "f32"}[wb]
    d, H, F = layer_widths(w)
    widths = f"d_model={d}, hidden={H}, ffn={F}"
    if m > 1:
        dp, Hs, Fs = round_up(d), round_up(H // m), round_up(F // m)
        simt = tp_smem(dp, Hs, Fs, wb)
        for k, kind, n, passes in (((19, "gc_i8", Hs, ("gates",)), (21, "mid_i8", Fs, ("ff1",)))
                                   if q else ((18, "gcp", Hs, ("gates", "projection")),
                                              (20, "ffn", Fs, ("ff1", "ff2")))):
            if TP.tp_route(kind, S, dp, n, n_sm) == "fused":
                continue
            over = {p: simt[p] for p in passes if simt[p] > lstm_mma.SMEM_LIMIT}
            if over:
                raise ValueError(
                    f"build_engine: the {prec} tensor-parallel kernel {k} has no launch for "
                    f"{widths} at model_parallel={m} (shard d={dp}, "
                    f"{'hidden' if k < 20 else 'ffn'}={n} padded to multiples of 4, S={S}, "
                    f"{n_sm} SMs): its one-launch kernel has no plan and its column passes "
                    f"need {over} bytes of shared memory, over {lstm_mma.SMEM_LIMIT}")
        return
    d, H, F = round_up(d), round_up(H), round_up(F)
    chunk = rt.encoder_chunk is not None
    if q:
        plans = [("kernel 2's and 7's routes (int8)",
                  lambda: lstm_mma.int8_routes(S, P, d, H, F, n_sm))]
    else:
        plans = [(f"kernel 12 ({prec})", lambda: lstm_mma.float_step_plan(S, d, H, F, wb, n_sm))]
        if chunk:
            plans.append((f"kernel 10 ({prec})",
                          lambda: lstm_mma.float_chunk_plan(S, P, d, H, F, wb, n_sm)))
    J, V = w["join_t"].shape
    dec = (S, J, w["dec_table"].shape[2], V, tokens, w["join_t"].element_size())
    if chunk and decode_route(*dec, rt.dims.context) == "cluster":
        plans.append((f"kernel 4 (J={J}, d={dec[2]}, V={V}, T={tokens}, "
                      f"{w['join_t'].dtype})", lambda: decode_plan(*dec, max_clusters)))
    for what, plan in plans:
        try:
            plan()
        except ValueError as e:
            raise ValueError(f"build_engine: {what} has no plan for {widths} at S={S}, P={P} "
                             f"on {n_sm} SMs: {e}") from None


def build_engine(
    rt: ModelRuntime,
    batch: int,
    cfg: EngineConfig | None = None,
    dcfg: DecodeConfig | None = None,
    mesh=None,
) -> EngineProgram:
    """Step and flush programs over `batch` session slots on rt.device.

    `mesh` (parallel.make_mesh) with model_parallel m > 1 builds this
    process's programs of the tensor-parallel engine (JAX step.py:434-464):
    the encoder step and recurrent forms become the TP ones over the model
    group, and `encoder_chunk` is None, so the step runs the per-pull
    recurrent scan (the whole-chunk kernels cannot hold the per-timestep
    all-reduces). Only the native LSTM family with H and F divisible by m
    is served; the JAX package's GSPMD fallback for other widths is not
    ported and raises."""
    cfg = cfg or EngineConfig()
    dcfg = dcfg or DecodeConfig()
    tp_axes, tp_family = None, None
    if mesh is not None and mesh.model_parallel > 1:
        m = mesh.model_parallel
        H = rt.state_shapes[1][1]
        F = rt.weights["ff1_t"].shape[2] if "ff1_t" in rt.weights else 0
        if not (rt.kind == "native" and tp_shard_map_eligible(rt.weights, rt.dims)
                and H % m == 0 and F % m == 0):
            raise NotImplementedError(
                f"model_parallel={m} needs the native LSTM family with hidden ({H}) and ffn "
                f"({F}) divisible by it; the JAX package's GSPMD path for other models is not "
                f"ported yet (ROADMAP queue 1 item 9)")
        rt = dataclasses.replace(
            rt,
            encoder_step=lambda w, x, h, c: encoder_step_tp(w, x, h, c, mesh),
            encoder_recurrent=lambda w, y, h, c, gate=None: encoder_recurrent_tp(
                w, y, h, c, mesh, gate),
            encoder_chunk=None,
        )
        tp_axes, tp_family = (mesh.axis_names[1],), "lstm"
    layout = FbankLayout.build(rt.fbank_opts, cfg.chunk_samples)
    P = layout.max_pulls_per_step
    dev = rt.device
    native = rt.kind == "native"
    if native and torch.device(dev).type == "cuda":
        check_kernel_plans(rt, batch, P, lstm_mma.device_sm(torch.device(dev)),
                           mesh.model_parallel if tp_axes else 1, dcfg.max_active_tokens,
                           device_max_clusters(dev, rt.weights["join_t"].element_size()))
    # int8-serving engines (weights with `_q8` copies) run the int8-DFT
    # frontend, every other engine (the interpreter's too) the bf16x3 one
    # (JAX engine/step.py:481-486)
    dft_i8 = native and is_quantized(rt.weights)
    vt = vocab_tables_device(rt.vocab)
    blank = rt.blank_id
    stride = layout.opts.segment_stride_ms
    seg = layout.opts.pull_segment_count
    step_rows = layout.opts.pull_segment_step

    def chunk_decode_fits(weights, eouts) -> bool:
        """The JAX step's choice between kernel 4 and the per-pull scan, less
        the shapes no kernel 4 holds (`decode_route`, from shapes only)."""
        _, S, J = eouts.shape
        d, V = weights["dec_table"].shape[2], weights["join_t"].shape[1]
        return decode_route(S, J, d, V, dcfg.max_active_tokens,
                            weights["join_t"].element_size(), rt.dims.context) is not None

    def inner_decode(weights, eout, can, dstate):
        """The <= 3-symbol masked inner loop of one pull (JAX step.py
        `inner_decode`): events {key: [S, 3]}. Its three branches, by what the
        runtime has: the lazy-dout `decoder_joiner_argmax`; `joiner_argmax`
        then the decoder step where the context changed; the joiner's
        logits (the interpreter's), `decode_step`, then the decoder step."""
        dstate = dict(dstate)
        done = ~can
        evts = []
        for ee in INNER_STEPS_EMIT:
            if rt.decoder_joiner_argmax is not None:
                mi, mv, bv, dstate["dout"] = rt.decoder_joiner_argmax(
                    weights, dstate["context"], dstate["need_dec"], dstate["dout"], eout
                )
                dstate, evt, is_blank, need_dec = greedy.decode_step_pre(
                    dstate, mi, mv, bv, ~done, ee, blank, vt, dcfg
                )
                dstate["need_dec"] = need_dec
            else:
                if rt.joiner_argmax is not None:
                    mi, mv, bv = rt.joiner_argmax(weights, eout, dstate["dout"])
                    dstate, evt, is_blank, need_dec = greedy.decode_step_pre(
                        dstate, mi, mv, bv, ~done, ee, blank, vt, dcfg
                    )
                else:
                    logits = rt.joiner(weights, eout, dstate["dout"])
                    dstate, evt, is_blank, need_dec = greedy.decode_step(
                        dstate, logits, ~done, ee, blank, vt, dcfg
                    )
                new_dout = rt.decoder_step(weights, dstate["context"])
                dstate["dout"] = torch.where(need_dec[:, None], new_dout, dstate["dout"])
            done = done | is_blank
            evts.append(evt)
        return dstate, {k: torch.stack([e[k] for e in evts], dim=1) for k in EVENT_KEYS}

    def add_time(dstate, can):
        dstate = dict(dstate)
        dstate["time_ms"] = (dstate["time_ms"] + stride * can.to(torch.int32)).to(torch.int32)
        return dstate

    def decode(weights, eouts, can, dstate):
        """eouts [P, S, J], can [P, S] -> (dstate', events {key: [P, S, 3]})."""
        if chunk_decode_fits(weights, eouts):
            return chunk_decode(
                eouts, can, dstate,
                weights["dec_table"], weights["dec_proj_t"], weights["dec_proj_b"],
                weights["join_t"], weights["join_b"], vt,
                blank_id=blank, stride_ms=int(stride), emit_ramp=INNER_STEPS_EMIT, dcfg=dcfg,
            )
        per_pull = []
        for p in range(eouts.shape[0]):
            dstate, e = inner_decode(weights, eouts[p], can[p], add_time(dstate, can[p]))
            per_pull.append(e)
        return dstate, {k: torch.stack([e[k] for e in per_pull]) for k in EVENT_KEYS}

    def split_pulls(weights, fb, h, c, dstate):
        """Every pull of a step through the split encoder: one ring read of
        every window, one batched embed, the chunk encoder and its decode (or
        the per-pull recurrent scan), one advance. Returns the states and the
        events {key: [P, S, 3]}."""
        S = fb["fifo_len"].shape[0]
        W = (P - 1) * step_rows + seg
        front = fbank_front_batch(layout, fb, W)  # [S, W, mel]
        can = fb["fifo_len"][None, :] >= (
            seg + step_rows * torch.arange(P, dtype=torch.int32, device=dev)[:, None]
        )  # [P, S]
        # kernel 16 straight from the front buffer where the runtime takes it
        # (bf16 conv weights), else the stacked windows (JAX step.py:624-636)
        y0 = rt.encoder_embed_front(weights, front, P, step_rows)
        if y0 is None:
            windows = torch.stack([front[:, i * step_rows : i * step_rows + seg] for i in range(P)])
            y0 = rt.encoder_embed(weights, windows.reshape(P * S, seg, -1)).reshape(P, S, -1)
        if rt.encoder_chunk is not None:
            eouts, h, c = rt.encoder_chunk(weights, y0, h, c, can)
            dstate, events = decode(weights, eouts, can, dstate)
        else:
            # the per-pull recurrent scan (JAX step.py:677-690): the pull
            # mask gates the h/c update inside the encoder
            per_pull = []
            for p in range(P):
                dstate = add_time(dstate, can[p])
                eout, h, c = rt.encoder_recurrent(weights, y0[p], h, c, can[p])
                dstate, e = inner_decode(weights, eout, can[p], dstate)
                per_pull.append(e)
            events = {k: torch.stack([e[k] for e in per_pull]) for k in EVENT_KEYS}
        n_pulled = torch.clamp(
            torch.div(fb["fifo_len"] - seg, step_rows, rounding_mode="floor") + 1, 0, P
        )
        fb = fbank_advance_n(layout, fb, n_pulled)
        return fb, h, c, dstate, events

    def step(weights, state, audio_i16, n):
        audio = audio_i16.to(torch.float32) / 32768.0  # april_session.c:520-522
        n = n.to(torch.int32)
        fb = fbank_accept_batch(layout, state["fbank"], audio, n, dft_i8)
        h, c, dstate = state["h"], state["c"], state["decode"]
        if rt.encoder_embed is None:
            # no split encoder: P pulls, each its own peek, encoder step,
            # decode and advance (JAX step.py:607-615)
            per_pull = []
            for _ in range(P):
                fb, h, c, dstate, e = pull_once(weights, fb, h, c, dstate)
                per_pull.append(e)
            events = {k: torch.stack([e[k] for e in per_pull]) for k in EVENT_KEYS}
        else:
            fb, h, c, dstate, events = split_pulls(weights, fb, h, c, dstate)
        events = {k: v.permute(1, 0, 2) for k, v in events.items()}  # [S, P, 3]
        new_state = {"fbank": fb, "h": h, "c": c, "decode": dstate}
        return new_state, pack_events(events, state["decode"]["time_ms"], stride,
                                      cfg.events_per_session)

    def pull_once(weights, fb, h, c, dstate):
        """One pull (JAX step.py `pull_once`): peek, time_ms += stride * can,
        the ungated one-step encoder, h/c kept where the pull is masked, the
        inner decode, advance. Returns the states and [S, 3] events."""
        can = fb["fifo_len"] >= seg
        x = fbank_peek(layout, fb)
        dstate = add_time(dstate, can)
        eout, h2, c2 = rt.encoder_step(weights, x, h, c)
        m3 = can[None, :, None]
        h = torch.where(m3, h2, h)
        c = torch.where(m3, c2, c)
        dstate, events = inner_decode(weights, eout, can, dstate)
        fb = fbank_advance(layout, fb, can)
        return fb, h, c, dstate, events

    def _sel(mask, a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)

    def gated_pull(weights, fb, h, c, dstate, do):
        fb_gated = dict(fb)
        fb_gated["fifo_len"] = torch.where(do, fb["fifo_len"], torch.zeros_like(fb["fifo_len"]))
        fb2, h, c, dstate, events = pull_once(weights, fb_gated, h, c, dstate)
        fb = {k: _sel(do, fb2[k], fb[k]) for k in fb}
        return fb, h, c, dstate, events

    def flush_round(weights, fb, h, c, dstate, flushing):
        """One `while fbank_flush: aas_infer` round: pad to seg where the
        debt bound allows, then one pull."""
        padded, did = fbank_flush_pad(layout, fb)
        do = flushing & did
        fb = {k: _sel(do, padded[k], fb[k]) for k in fb}
        return gated_pull(weights, fb, h, c, dstate, do)

    # derived flush bounds (engine/step.py of the JAX package)
    pad_pull_rounds = ((seg - 1) + 3 * seg) // step_rows + 1
    FLUSH_BLOCK = 3200  # the reference's two fixed zero blocks (SEGSIZE)
    hop = layout.opts.sample_freq * layout.opts.frame_shift_ms // 1000

    def flush(weights, state, do_flush):
        """_aas_flush (:547-564) for the masked sessions."""
        fb, h, c, dstate = state["fbank"], state["h"], state["c"], state["decode"]
        do_flush = do_flush.to(torch.bool)
        S = do_flush.shape[0]
        pulls = []
        # Phase A: drain + pad rounds until the debt bound stops padding
        for _ in range(pad_pull_rounds):
            fb, h, c, dstate, e = flush_round(weights, fb, h, c, dstate, do_flush)
            pulls.append(e)
        # Phase B: two fixed 3200-sample zero blocks, each followed by
        # pad-free drain pulls
        zeros = torch.zeros((S, layout.chunk), dtype=torch.float32, device=dev)
        for _ in range(2):
            rem = FLUSH_BLOCK
            while rem > 0:
                take = min(layout.chunk, rem)
                rem -= take
                nz = torch.where(do_flush, take, 0).to(torch.int32)
                fb = fbank_accept_batch(layout, fb, zeros, nz, dft_i8)
                for _ in range((take // hop + seg) // step_rows + 1):
                    fb, h, c, dstate, e = gated_pull(weights, fb, h, c, dstate, do_flush)
                    pulls.append(e)
        # Phase C: drain + pad rounds again
        for _ in range(pad_pull_rounds):
            fb, h, c, dstate, e = flush_round(weights, fb, h, c, dstate, do_flush)
            pulls.append(e)
        # Phase D: finalize + clear context + silence
        dstate = dict(dstate)
        head = dstate["head"]
        fin = do_flush & (head > 0)
        zi = torch.zeros(S, dtype=torch.int32, device=dev)
        evD = {
            "ops": (fin.to(torch.int32) * ev.OP_FINAL)
            | ((do_flush & ~dstate["emitted_silence"]).to(torch.int32) * ev.OP_SILENCE),
            "tok": zi,
            "logprob": torch.zeros(S, dtype=torch.float32, device=dev),
            "flags": zi,
            "time_ms": dstate["time_ms"],
            "final_k": torch.where(fin, head, zi),
        }
        dstate["last_call"] = torch.where(fin, head, dstate["last_call"])
        dstate["head"] = torch.where(fin, zi, head)
        do_clear = do_flush & (dstate["context"][:, 0] != blank)
        dstate["context"] = torch.where(
            do_clear[:, None], torch.full_like(dstate["context"], blank), dstate["context"]
        )
        new_dout = rt.decoder_step(weights, dstate["context"])
        dstate["dout"] = torch.where(do_clear[:, None], new_dout, dstate["dout"])
        dstate["need_dec"] = dstate["need_dec"] & ~do_clear
        dstate["emitted_silence"] = dstate["emitted_silence"] | do_flush

        events = {}
        for k in EVENT_KEYS:
            grp = torch.stack([e[k] for e in pulls], dim=1)  # [S, pulls, 3]
            last = torch.zeros((S, 1, 3), dtype=grp.dtype, device=dev)
            last[:, 0, 0] = evD[k]
            events[k] = torch.cat([grp, last], dim=1)
        new_state = {"fbank": fb, "h": h, "c": c, "decode": dstate}
        return new_state, pack_events(events, state["decode"]["time_ms"], stride,
                                      cfg.events_per_session)

    return EngineProgram(
        rt=rt, layout=layout, cfg=cfg, dcfg=dcfg,
        step=torch.no_grad()(step), flush=torch.no_grad()(flush), batch=batch,
        mesh=mesh if tp_axes else None, tp_axes=tp_axes, tp_family=tp_family,
    )
