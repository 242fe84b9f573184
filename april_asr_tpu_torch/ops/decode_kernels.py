"""Kernel 4: the whole chunk's greedy decode in one launch, and the gates
that choose between it and the per-pull decode.

Port of `chunk_decode_fused` (april_asr_tpu/ops/decode_pallas.py,
`_chunk_decode_kernel`). For each of P pulls and up to 3 masked rounds
(early-emit ramp 1, 0, 0): the lazy decoder refresh (dec-table rows of the
2-token context, ReLU, dec_proj), the joiner tanh(eout + dout) @ W + b, the
blank-excluded argmax, and every heuristic of `decode_step_pre`. The decode
state stays on chip across pulls; only per-pull event records and the final
state are written out. Each pull adds stride_ms to the time of sessions
that pull (`can`), as the engine's per-pull loop does. `dec_proj_t` and
`join_t` may be bf16 (int8 and bf16 serving) or f32 (serving as loaded); both
CUDA kernels are instantiated for both: the cluster kernel counts under
`chunk_decode` and `chunk_decode_f32`, the CUDA-core one under
`chunk_decode_simt` and `chunk_decode_simt_f32`.

`chunk_decode` takes the plain PyTorch version (per pull and round, kernel
8's plain version then `decode_step_pre`) for CPU tensors. For CUDA tensors
it launches csrc/chunk_decode_cluster.cu where `decode_plan` has a plan:
thread-block clusters of C blocks, each cluster a tile of TS sessions, each
block holding 1/C of the joiner's columns (and of dec_proj's, or streaming
those) in shared memory for the whole launch. Where no slice fits a block
(narrow models with large vocabularies) it launches the CUDA-core kernel
csrc/chunk_decode.cu (`chunk_decode_simt`, counted apart); else it raises.
It never falls back. The two kernels are equal bit for bit.

`chunk_decode_supported` and `dj_supported` are the port's copies of the
JAX package's gates (decode_pallas.py `chunk_decode_supported`,
joiner_pallas.py `dj_supported`): the engine's step runs kernel 4 only where
the first passes, and the per-pull decode runs kernel 8 only where the
second passes (else kernel 9). They keep JAX's formulas, which bound the
vocabulary-sized operands by the TPU's VMEM budget, so the port takes the
same route as the JAX package for every model. They drop JAX's
`S % block_s` term, since the CUDA kernels take ragged session tiles, and
size the budget's activation tiles at JAX's block for S, or 128 sessions
where JAX has none. They read only shapes, never the device.

`dj_plan` plans kernel 8's cluster kernel (csrc/dec_joiner_cluster.cu, one
decoder-joiner round of the per-pull decode; its wrapper is
ops/joiner_kernels.py) on kernel 4's slices and tiles, with `dj_smem` its
shared-memory layout; `dj_route` names kernel 8's kernel for a shape:
"cluster", or "simt" (csrc/joiner.cu's `dec_joiner_simt`) where no block
holds a slice.

`decode_route` is the step's choice: the JAX gate, then the cluster plan,
then `chunk_decode_block_fits` (the CUDA-core kernel keeps a [V] logits row
per session in shared memory, so narrow models, d or J of 128 or 256, above
~13.9k to 14.2k tokens fit neither), else the per-pull decode. Off the card
it plans for a card that places one cluster, which changes TS but not
whether a plan exists.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ..decode import greedy
from . import cuda_build
from . import joiner_kernels

EVENT_KEYS = ("ops", "tok", "logprob", "flags", "time_ms", "final_k")

_VMEM_BUDGET = 56 * 1024 * 1024  # the JAX gates' bound on resident bytes
SMEM_PER_BLOCK = cuda_build.SMEM_PER_BLOCK
CHUNK_DECODE_TSD = 4  # sessions per block of the CUDA-core kernel (TSD, csrc/chunk_decode.cu)
# the cluster kernel (csrc/chunk_decode_cluster.cu): the cluster sizes the
# plan tries (portable ones), its threads a block and the most sessions an
# item carries, the bytes of its per-session state and partial argmax, the
# dec_proj rows a stage of the streamed ring holds, the elements past each
# resident weight column, and the weight the plan's cost gives a streamed
# dec_proj column against a resident one
CLUSTER_SIZES = (1, 2, 4, 8)
CLUSTER_NT, CLUSTER_GS = 512, 4
SESS_STATE_BYTES = 52
PARTIAL_BYTES = 8
RING_ROWS = 32
KPAD = 4
STREAM_COST = 1.5

# max_clusters(C, smem, dp_smem): clusters of C blocks of `smem` bytes that
# run at once (the card's cudaOccupancyMaxActiveClusters)
MaxClusters = Callable[[int, int, bool], int]


def _gate_block_s(S: int) -> int:
    """JAX's session block for S (`_pick_block_s`), or 128 where it has none."""
    return next((b for b in (512, 256, 128) if S % b == 0), 128)


def chunk_decode_supported(S: int, J: int, d: int, context: int, vocab: int) -> bool:
    """True where the JAX package runs its whole-chunk decode kernel for
    these shapes (less its `S % block_s` term): 2-token context,
    128-multiple widths, and the vocabulary-sized operands within its
    budget. Narrow models (d or J of 128 or 256) pass vocabularies that no
    kernel 4 holds, which `decode_route` sends to the per-pull decode."""
    if not (context == 2 and J % 128 == 0 and d % 128 == 0):
        return False
    Vp = -(-vocab // 128) * 128 if vocab else 0
    resident = 2 * Vp * d * 4 + J * Vp * 4 + d * J * 4 + _gate_block_s(S) * (6 * J + 64) * 4
    return resident <= _VMEM_BUDGET


def chunk_decode_smem(J: int, d: int, vocab: int, tokens: int) -> int:
    """Shared-memory bytes of one block of the CUDA-core kernel 4 (its C
    entry's formula): TSD sessions' dout [J], work row [max(J, d)], logits
    [V] and token window [T], 4 bytes each."""
    return 4 * CHUNK_DECODE_TSD * (J + max(J, d) + vocab + tokens)


def chunk_decode_block_fits(J: int, d: int, vocab: int, tokens: int) -> bool:
    """True where one block of the CUDA-core kernel 4 fits the H100's shared
    memory (`decode_route`'s second choice). Reads shapes only."""
    return chunk_decode_smem(J, d, vocab, tokens) <= SMEM_PER_BLOCK


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def cluster_smem(TS: int, J: int, d: int, V: int, Vc: int, Jc: int, T: int, C: int, wb: int,
                 dp_smem: bool) -> int:
    """Shared-memory bytes of one block of the cluster kernel (its C
    `cluster_layout`, each region rounded up to 16 bytes): the W and (where
    resident) dec_proj slices, column by column (K + KPAD weights each), the
    tile's refresh and joiner input rows [TS][max(J, d)], its logits
    [TS][Vc] (sharing their room with the streamed dec_proj ring of two
    stages, 128-byte aligned), its columns of a and of dout, two pulls of
    eout columns, the token windows, the C partial argmaxes, the blank
    logits, two pull masks, the state, two lists and the token masks [V]."""
    up = lambda n: _up(n, 16)  # noqa: E731
    ring = 0 if dp_smem else 2 * RING_ROWS * Jc * wb + 128
    return (up(Vc * (J + KPAD) * wb) + (up(Jc * (d + KPAD) * wb) if dp_smem else 0)
            + up(TS * max(J, d) * 4)
            + up(max(TS * Vc * 4, ring)) + 2 * up(TS * Jc * 4) + up(2 * TS * Jc * 4)
            + up(TS * T * 4) + up(C * TS * PARTIAL_BYTES) + up(TS * 4) + up(2 * TS * 4)
            + up(TS * SESS_STATE_BYTES) + up(2 * TS * 4) + up(V * 4))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """One launch of the cluster kernel: clusters of C blocks, each cluster a
    tile of TS sessions; block r holds W's columns [r Vc, (r + 1) Vc) and
    dec_proj's [r Jc, (r + 1) Jc) (the last ragged, maybe empty), dec_proj
    resident (`dp_smem`) or streamed; `clusters` tiles, of which the card
    runs `max_clusters` at once."""

    S: int
    V: int
    J: int
    C: int
    TS: int
    Vc: int
    Jc: int
    dp_smem: bool
    smem: int
    clusters: int
    max_clusters: int

    @property
    def waves(self) -> int:
        return -(-self.clusters // self.max_clusters)

    @property
    def blocks(self) -> int:
        return self.clusters * self.C

    def v_slice(self, r: int) -> range:
        return range(min(r * self.Vc, self.V), min((r + 1) * self.Vc, self.V))

    def j_slice(self, r: int) -> range:
        return range(min(r * self.Jc, self.J), min((r + 1) * self.Jc, self.J))

    def tile(self, i: int) -> range:
        return range(i * self.TS, min((i + 1) * self.TS, self.S))


def decode_plan(S: int, J: int, d: int, V: int, T: int, w_bytes: int,
                max_clusters: MaxClusters) -> Optional[DecodePlan]:
    """The cluster kernel's launch for these shapes, or None where J or d
    is not a multiple of 16 or no block holds its slices (W's, and
    dec_proj's or the streamed ring) with one session's rows. For each
    cluster size C in CLUSTER_SIZES and dec_proj resident or streamed
    (streamed needs d % RING_ROWS == 0, J = C Jc with Jc a 16-byte multiple
    of at most 256 (a tensor-map box), and a tile's items, ceil(TS /
    CLUSTER_GS) x Jc, within CLUSTER_NT threads): the largest tile that fits
    a block, the fewest waves of `max_clusters` at it, then the smallest
    tile for those waves. The plan is the one of least waves x TS x (Vc J +
    Jc d, streamed columns weighted STREAM_COST), the smaller C on ties.
    Raises ValueError where slices fit but the card places no cluster of
    them."""
    if S < 1 or V < 1 or J % 16 or d % 16:
        return None
    best, unplaced = None, []
    for C in CLUSTER_SIZES:
        Vc, Jc = _up(-(-V // C), 8), _up(-(-J // C), 4)
        for dp_smem in (True, False):
            if not dp_smem and (d % RING_ROWS or C * Jc != J or Jc * w_bytes % 16 or Jc > 256):
                continue
            smem = functools.partial(cluster_smem, J=J, d=d, V=V, Vc=Vc, Jc=Jc, T=T, C=C,
                                     wb=w_bytes, dp_smem=dp_smem)
            fits = lambda ts: smem(ts) <= SMEM_PER_BLOCK and (  # noqa: E731
                dp_smem or -(-ts // CLUSTER_GS) * Jc <= CLUSTER_NT)
            if not fits(1):
                continue
            ts_max = 1
            while ts_max < S and fits(ts_max + 1):
                ts_max += 1
            mc = max_clusters(C, smem(ts_max), dp_smem)
            if mc < 1:
                unplaced.append((C, dp_smem, smem(ts_max)))
                continue
            waves = -(-S // (mc * ts_max))
            TS = -(-S // (waves * mc))
            mc = max(mc, max_clusters(C, smem(TS), dp_smem))
            n = -(-S // TS)
            cost = -(-n // mc) * TS * (Vc * J + (1.0 if dp_smem else STREAM_COST) * Jc * d)
            plan = DecodePlan(S, V, J, C, TS, Vc, Jc, dp_smem, smem(TS), n, mc)
            if best is None or cost < best[0]:
                best = (cost, plan)
    if best is None:
        if unplaced:
            raise ValueError(
                f"kernel 4: S={S}, J={J}, d={d}, V={V}, T={T} at {w_bytes}-byte weights: the "
                f"card places no cluster of these slices ((C, dec_proj resident, bytes): "
                f"{unplaced})")
        return None
    return best[1]


def nominal_clusters(C: int, smem: int, dp_smem: bool) -> int:
    """`MaxClusters` for a card that places one cluster: off the card it
    decides whether a plan exists (which depends only on the shapes), not
    its tile."""
    return 1


@functools.lru_cache(maxsize=None)
def _cluster_fit(C: int, smem: int, w_f32: int, dp_smem: bool, index: int) -> int:
    fn = cuda_build.bind("chunk_decode_cluster", "chunk_decode_cluster_fit", 0, 4)
    with torch.cuda.device(index):
        n = fn(C, smem, w_f32, int(dp_smem), None)
    if n < 0:
        raise RuntimeError(f"kernel 4: cudaOccupancyMaxActiveClusters(C={C}, smem={smem}) "
                           f"failed with error {-n}")
    return n


def device_max_clusters(device, w_bytes: int) -> MaxClusters:
    """`MaxClusters` queried on the card (cached per shape)."""
    index = torch.device(device).index or 0
    return lambda C, smem, dp: _cluster_fit(C, smem, int(w_bytes == 4), dp, index)


@functools.lru_cache(maxsize=None)
def _device_plan(S, J, d, V, T, w_bytes, device: str) -> Optional[DecodePlan]:
    return decode_plan(S, J, d, V, T, w_bytes, device_max_clusters(device, w_bytes))


def device_decode_plan(S: int, J: int, d: int, V: int, T: int, w_bytes: int,
                       device) -> Optional[DecodePlan]:
    """`decode_plan` with the card's cluster occupancy (cached)."""
    return _device_plan(S, J, d, V, T, w_bytes, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def decode_route(S: int, J: int, d: int, V: int, T: int, w_bytes: int, context: int,
                 max_clusters: MaxClusters = nominal_clusters) -> Optional[str]:
    """The step's decode for these shapes: "cluster" (the cluster kernel),
    "simt" (the CUDA-core kernel) or None (the per-pull decode), in that
    order where the JAX gate passes; None where it refuses."""
    if not chunk_decode_supported(S, J, d, context, V):
        return None
    if decode_plan(S, J, d, V, T, w_bytes, max_clusters) is not None:
        return "cluster"
    return "simt" if chunk_decode_block_fits(J, d, V, T) else None


def dj_smem(TS: int, J: int, d: int, Vc: int, Jc: int, C: int, wb: int, dp_smem: bool) -> int:
    """Shared-memory bytes of one block of the cluster kernel 8 (its C
    `dj_layout`, each region rounded up to 16 bytes): the W and (where
    resident) dec_proj slices, column by column (K + KPAD weights each), the
    tile's refresh and joiner input rows [TS][max(J, d)], its logits
    [TS][Vc] (sharing their room with the streamed dec_proj ring of two
    stages, 128-byte aligned), its columns of a and of the refreshed dout,
    the C blocks' argmax keys, the blank logits and two lists."""
    up = lambda n: _up(n, 16)  # noqa: E731
    ring = 0 if dp_smem else 2 * RING_ROWS * Jc * wb + 128
    return (up(Vc * (J + KPAD) * wb) + (up(Jc * (d + KPAD) * wb) if dp_smem else 0)
            + up(TS * max(J, d) * 4) + up(max(TS * Vc * 4, ring)) + 2 * up(TS * Jc * 4)
            + up(C * TS * 8) + up(TS * 4) + up(2 * TS * 4))


def dj_staged_bytes(plan: DecodePlan, J: int, d: int, w_bytes: int) -> float:
    """The weight bytes one call of kernel 8 on `plan` stages into shared
    memory (every block its slices; streamed dec_proj columns weighted
    STREAM_COST, since they cross a ring in stages behind a block barrier
    each)."""
    dp = plan.Jc * ((d + KPAD) if plan.dp_smem else STREAM_COST * d)
    return plan.blocks * (plan.Vc * (J + KPAD) + dp) * w_bytes


def dj_plan(S: int, J: int, d: int, V: int, w_bytes: int,
            max_clusters: MaxClusters) -> Optional[DecodePlan]:
    """Kernel 8's cluster launch for these shapes (a `DecodePlan`: clusters
    of C blocks, each cluster a tile of TS sessions, block r W's columns [r
    Vc, (r + 1) Vc) and dec_proj's [r Jc, (r + 1) Jc)), or None where J or d
    is not a multiple of 16 or no block holds its slices with one session's
    rows. A tile's items, ceil(TS / CLUSTER_GS) x Vc and x Jc, stay within
    CLUSTER_NT threads (one item a thread in each product). For each
    cluster size and dec_proj resident or streamed (as `decode_plan`): the
    largest tile that fits a block, the fewest waves of `max_clusters` at
    it, then the smallest tile for those waves (where a smaller tile lets
    more clusters run at once, smaller again). The plan is the one of the
    fewest waves, then the fewest multiply-adds a block, TS (Vc J + Jc d,
    streamed columns weighted STREAM_COST), then the fewest weight bytes
    staged a call (`dj_staged_bytes`), then the smaller C. The smallest tile
    goes before the fewest staged bytes because a block's fmaf chains, not
    its slice loads, hold a call: at S = 256 on the H100, tiles of 18
    sessions took 20.0 us of device time, tiles of 32 (the fewest bytes)
    24.2. Raises ValueError where slices fit but the card places no cluster
    of them."""
    if S < 1 or V < 1 or J % 16 or d % 16:
        return None
    best, unplaced = None, []
    for C in CLUSTER_SIZES:
        Vc, Jc = _up(-(-V // C), 8), _up(-(-J // C), 4)
        for dp_smem in (True, False):
            if not dp_smem and (d % RING_ROWS or C * Jc != J or Jc * w_bytes % 16 or Jc > 256):
                continue
            smem = functools.partial(dj_smem, J=J, d=d, Vc=Vc, Jc=Jc, C=C, wb=w_bytes,
                                     dp_smem=dp_smem)
            fits = lambda ts: (smem(ts) <= SMEM_PER_BLOCK  # noqa: E731
                               and -(-ts // CLUSTER_GS) * max(Vc, Jc) <= CLUSTER_NT)
            if not fits(1):
                continue
            ts_max = 1
            while ts_max < S and fits(ts_max + 1):
                ts_max += 1
            mc = max_clusters(C, smem(ts_max), dp_smem)
            if mc < 1:
                unplaced.append((C, dp_smem, smem(ts_max)))
                continue
            waves = -(-S // (mc * ts_max))
            TS = -(-S // (waves * mc))
            while True:  # a smaller tile may let more clusters run at once
                mc = max(mc, max_clusters(C, smem(TS), dp_smem))
                if -(-S // (waves * mc)) == TS:
                    break
                TS = -(-S // (waves * mc))
            plan = DecodePlan(S, V, J, C, TS, Vc, Jc, dp_smem, smem(TS), -(-S // TS), mc)
            macs = TS * (Vc * J + (1.0 if dp_smem else STREAM_COST) * Jc * d)
            key = (plan.waves, macs, dj_staged_bytes(plan, J, d, w_bytes), C)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        if unplaced:
            raise ValueError(
                f"kernel 8: S={S}, J={J}, d={d}, V={V} at {w_bytes}-byte weights: the card "
                f"places no cluster of these slices ((C, dec_proj resident, bytes): {unplaced})")
        return None
    return best[1]


@functools.lru_cache(maxsize=None)
def _dj_cluster_fit(C: int, smem: int, w_f32: int, dp_smem: bool, index: int) -> int:
    fn = cuda_build.bind("dec_joiner_cluster", "dec_joiner_cluster_fit", 0, 4)
    with torch.cuda.device(index):
        n = fn(C, smem, w_f32, int(dp_smem), None)
    if n < 0:
        raise RuntimeError(f"kernel 8: cudaOccupancyMaxActiveClusters(C={C}, smem={smem}) "
                           f"failed with error {-n}")
    return n


@functools.lru_cache(maxsize=None)
def device_dj_plan(S: int, J: int, d: int, V: int, w_bytes: int,
                   index: int) -> Optional[DecodePlan]:
    """`dj_plan` with card `index`'s cluster occupancy (cached per shape)."""
    return dj_plan(S, J, d, V, w_bytes,
                   lambda C, smem, dp: _dj_cluster_fit(C, smem, int(w_bytes == 4), dp, index))


@functools.lru_cache(maxsize=None)
def dj_route(S: int, J: int, d: int, V: int, w_bytes: int,
             max_clusters: MaxClusters = nominal_clusters) -> str:
    """Kernel 8's kernel for these shapes: "cluster" (csrc/dec_joiner_cluster.cu)
    where `dj_plan` has a plan, else "simt" (csrc/joiner.cu's three
    kernels). Reads shapes only."""
    return "simt" if dj_plan(S, J, d, V, w_bytes, max_clusters) is None else "cluster"


def dj_supported(S: int, J: int, d: int, context: int, vocab: int = 0, w_itemsize: int = 4) -> bool:
    """True where the JAX package runs kernel 8 (`decoder_joiner_argmax_fused`)
    for these shapes (less its `S % block_s` term); elsewhere its per-pull
    decode runs the decoder step and kernel 9."""
    if not (context == 2 and J % 128 == 0 and d % 128 == 0):
        return False
    if vocab:
        Vp = -(-vocab // 128) * 128
        resident = (2 * Vp * d * 4 + J * Vp * w_itemsize + d * J * w_itemsize
                    + _gate_block_s(S) * (4 * J + 16) * 4)
        if resident > _VMEM_BUDGET:
            return False
    return True


def chunk_decode_plain(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b,
                       vt, *, blank_id, stride_ms, emit_ramp, dcfg):
    P = eouts.shape[0]
    dstate = dict(dstate)
    per_pull = []
    for p in range(P):
        can_p = can[p]
        dstate["time_ms"] = (dstate["time_ms"] + stride_ms * can_p.to(torch.int32)).to(torch.int32)
        done = ~can_p
        rounds = []
        for ee in emit_ramp:
            mi, mv, bv, dstate["dout"] = joiner_kernels.decoder_joiner_argmax_plain(
                dstate["context"], dstate["need_dec"], dstate["dout"], eouts[p],
                dec_table, dec_proj_t, dec_proj_b, w_t, b, blank_id,
            )
            dstate, evt, is_blank, need_dec = greedy.decode_step_pre(
                dstate, mi, mv, bv, ~done, ee, blank_id, vt, dcfg
            )
            dstate["need_dec"] = need_dec
            done = done | is_blank
            rounds.append(evt)
        per_pull.append({k: torch.stack([e[k] for e in rounds], dim=1) for k in EVENT_KEYS})
    events = {k: torch.stack([e[k] for e in per_pull], dim=0) for k in EVENT_KEYS}
    return dstate, events


def _cuda_args(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
               blank_id, stride_ms, emit_ramp, dcfg, what: str):
    """Both CUDA kernels' checks and C arguments: (shapes, the pointers up to
    the events, the trailing floats, the outputs' assembly)."""
    P, S, J = eouts.shape
    d = dec_table.shape[2]
    V = w_t.shape[1]
    T = dcfg.max_active_tokens
    R = len(emit_ramp)
    dev = eouts.device
    if R != 3 or dec_table.shape[0] != 2:
        raise ValueError(f"{what}: needs 3 rounds and a 2-token context")
    wd = w_t.dtype
    if wd not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: join_t must be bfloat16 or float32, got {wd}")
    checks = (
        (eouts, torch.float32, (P, S, J)), (dec_table, torch.float32, (2, V, d)),
        (dec_proj_t, wd, (d, J)), (w_t, wd, (J, V)),
        (dec_proj_b, torch.float32, (J,)), (b, torch.float32, (V,)),
        (dstate["dout"], torch.float32, (S, J)),
        (dstate["context"], torch.int32, (S, 2)),
        (dstate["token_words"], torch.int32, (S, T)),
    )
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{what}: expected contiguous {dt} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    keep = [i32(can), i32(dstate["need_dec"]), i32(dstate["emitted_silence"])]
    scal_in = [i32(dstate[k]) for k in ("head", "last_call", "time_ms", "last_emit_ms")]
    tmask = greedy.vocab_mask_on(vt, dev)
    out_ctx = torch.empty_like(dstate["context"])
    out_dout = torch.empty_like(dstate["dout"])
    out_words = torch.empty_like(dstate["token_words"])
    out_scal = [torch.empty(S, dtype=torch.int32, device=dev) for _ in range(6)]
    ev = {k: torch.empty((P, S, R), dtype=torch.float32 if k == "logprob" else torch.int32,
                         device=dev) for k in EVENT_KEYS}
    ptrs = [
        eouts.data_ptr(), keep[0].data_ptr(),
        dstate["context"].data_ptr(), dstate["dout"].data_ptr(), keep[1].data_ptr(),
        dstate["token_words"].data_ptr(), *[t.data_ptr() for t in scal_in], keep[2].data_ptr(),
        dec_table.data_ptr(), dec_proj_t.data_ptr(), dec_proj_b.data_ptr(),
        w_t.data_ptr(), b.data_ptr(), tmask.data_ptr(),
        out_ctx.data_ptr(), out_dout.data_ptr(), out_words.data_ptr(),
        *[t.data_ptr() for t in out_scal],
        *[ev[k].data_ptr() for k in EVENT_KEYS],
    ]
    floats = [*[float(x) for x in emit_ramp], float(dcfg.punctuation_margin),
              float(dcfg.confident_margin), float(dcfg.confident_logprob_penalty),
              float(dcfg.long_silence_ms), float(dcfg.silence_decay_ms)]

    def outputs():
        nd, head, last_call, time_ms, last_emit, sil = out_scal
        state = dict(dstate)
        state.update(
            context=out_ctx, dout=out_dout, need_dec=nd != 0, token_words=out_words,
            head=head, last_call=last_call, time_ms=time_ms, last_emit_ms=last_emit,
            emitted_silence=sil != 0,
        )
        return state, ev

    return (P, S, J, d, V, T, wd), ptrs, floats, outputs, (keep, scal_in, tmask)


def chunk_decode_simt(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
                      blank_id, stride_ms, emit_ramp, dcfg):
    """The CUDA-core kernel (csrc/chunk_decode.cu, TSD sessions a block):
    the step's route where `decode_plan` has none and its block fits."""
    (P, S, J, d, V, T, wd), ptrs, floats, outputs, _keep = _cuda_args(
        eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, blank_id=blank_id,
        stride_ms=stride_ms, emit_ramp=emit_ramp, dcfg=dcfg, what="chunk_decode_simt")
    w_f32 = int(wd == torch.float32)
    fn = cuda_build.bind("chunk_decode", "chunk_decode_simt", 32, 9, 8)
    rc = fn(*ptrs, P, S, J, d, V, T, blank_id, stride_ms, w_f32, *floats,
            torch.cuda.current_stream(eouts.device).cuda_stream)
    if rc < 0:
        raise ValueError(
            f"chunk_decode_simt: V={V}, J={J}, d={d}, T={T} need {-rc} bytes of shared memory "
            "per block, more than this device allows one block; the engine's step sends such "
            "shapes to the per-pull decode (decode_route)"
        )
    cuda_build.check(rc, "chunk_decode_simt")
    cuda_build.COUNTS["chunk_decode_simt_f32" if w_f32 else "chunk_decode_simt"] += 1
    return outputs()


def chunk_decode_cluster(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
                         blank_id, stride_ms, emit_ramp, dcfg, plan: DecodePlan, stamps=None):
    """The cluster kernel (csrc/chunk_decode_cluster.cu) on `plan`; `stamps`
    (int64 [plan.blocks, 3 + 27 P] on the card, or None) takes each block's
    phase stamps (tools/profile_decode.py)."""
    (P, S, J, d, V, T, wd), ptrs, floats, outputs, _keep = _cuda_args(
        eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, blank_id=blank_id,
        stride_ms=stride_ms, emit_ramp=emit_ramp, dcfg=dcfg, what="chunk_decode")
    if (plan.S, plan.V, plan.J) != (S, V, J):
        raise ValueError(f"chunk_decode: a plan for S={plan.S}, V={plan.V}, J={plan.J} given "
                         f"S={S}, V={V}, J={J}")
    for t, what in ((eouts, "eouts"), (dec_table, "dec_table"), (dec_proj_t, "dec_proj_t")):
        if t.data_ptr() % 16:
            raise ValueError(f"chunk_decode: {what} must be 16-byte aligned")
    w_f32 = int(wd == torch.float32)
    fn = cuda_build.bind("chunk_decode_cluster", "chunk_decode_cluster", 33, 15, 8)
    rc = fn(*ptrs, None if stamps is None else stamps.data_ptr(), P, S, J, d, V, T, blank_id,
            stride_ms, w_f32, plan.C, plan.TS, plan.Vc, plan.Jc, int(plan.dp_smem), plan.smem,
            *floats, torch.cuda.current_stream(eouts.device).cuda_stream)
    if rc < 0:
        raise ValueError(f"chunk_decode: the kernel's layout needs {-rc} bytes of shared memory, "
                         f"the plan {plan.smem} ({plan})")
    cuda_build.check(rc, "chunk_decode")
    cuda_build.COUNTS["chunk_decode_f32" if w_f32 else "chunk_decode"] += 1
    return outputs()


def chunk_decode_cuda(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
                      blank_id, stride_ms, emit_ramp, dcfg):
    """The cluster kernel on the card's plan, else the CUDA-core kernel where
    its block fits, else ValueError naming the shapes."""
    P, S, J = eouts.shape
    d, V, T = dec_table.shape[2], w_t.shape[1], dcfg.max_active_tokens
    args = (eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt)
    kw = dict(blank_id=blank_id, stride_ms=stride_ms, emit_ramp=emit_ramp, dcfg=dcfg)
    plan = device_decode_plan(S, J, d, V, T, w_t.element_size(), eouts.device)
    if plan is not None:
        return chunk_decode_cluster(*args, **kw, plan=plan)
    if chunk_decode_block_fits(J, d, V, T):
        return chunk_decode_simt(*args, **kw)
    raise ValueError(
        f"chunk_decode: V={V}, J={J}, d={d}, T={T} at {w_t.dtype}: no block holds a cluster "
        f"slice (decode_plan) nor the CUDA-core kernel's {chunk_decode_smem(J, d, V, T)} bytes "
        f"(within {SMEM_PER_BLOCK}); the engine's step sends such shapes to the per-pull decode "
        "(decode_route)")


def chunk_decode(eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt, *,
                 blank_id: int, stride_ms: int, emit_ramp, dcfg) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """eouts [P, S, J], can [P, S] bool -> (dstate', events {key: [P, S, 3]}).
    State keys as decode/greedy.init_decode_state; `dout_init` passes through."""
    kw = dict(blank_id=blank_id, stride_ms=stride_ms, emit_ramp=tuple(emit_ramp), dcfg=dcfg)
    args = (eouts, can, dstate, dec_table, dec_proj_t, dec_proj_b, w_t, b, vt)
    if eouts.device.type == "cpu":
        return chunk_decode_plain(*args, **kw)
    if eouts.device.type != "cuda":
        raise ValueError(f"chunk_decode: unsupported device {eouts.device}")
    return chunk_decode_cuda(*args, **kw)
