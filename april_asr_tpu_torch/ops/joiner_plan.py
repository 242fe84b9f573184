"""Kernel 9's launch plan: csrc/joiner_stream.cu's column slices, session
tiles and register tile, and the route between it and the kept CUDA-core
kernel (csrc/joiner.cu `joiner_argmax`, counted as `joiner_argmax_simt`).

The kernel is one cooperative launch of blocks of NT threads. Block b holds
W's columns [v0, v0 + Vc) (slice b % n_vs) and walks `rounds` session tiles
of TS sessions (group b / n_vs), each thread an RC x RS register tile
(columns x sessions) of fmaf chains. W's slice stays resident in shared
memory where it fits (`w_resident`), else its KC-row chunks stream through
the ring beside those of t. W's form is f32 (bf16 weights widened
exactly, so that the inner loop has no unpacks). Every block must be
co-resident (one grid barrier), so the blocks number at most
the card's `fit` (blocks an SM) x its SM count.

`joiner_plan` is the rule, read from shapes and the card's occupancy
alone: among every register tile in TILES and every column and session
split, the fewest cycles a k (`cycles_per_k`, of an SM's busiest
scheduler: the tiles a block walks x its FFMA slots, the warps it carries
x RC RS; at least an fmaf's latency), then the larger register tile
(fewer shared-memory loads a
multiply-add), then more warps a block, then the fewest bytes staged a
call (W's slices, each pass of a streamed one, and t's tiles), then the
fewest blocks. None where J is not a multiple of KC, where the route is
"simt". On the H100 at S = 256, V = 16,383 the rule's choice, 8 x 8 tiles
on 128-column slices streamed, took 0.12 ms a call where 4 x 4 tiles took
0.15-0.18 and a bf16 form (unpacked in the inner loop) 0.145 streamed and
0.154 resident (tools/profile_decode.py --kernel 9 sweeps the splits).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from . import cuda_build

NT = 256        # threads a block (JS_NT)
KC = 32         # k rows a ring stage and a resident chunk hold (JS_KC)
NS = 4          # ring stages (JS_NS)
FMA_LATENCY = 4  # cycles from one fmaf to the next of its chain
# register tiles (columns, sessions) a thread, by the kernel's tile index
TILES = ((8, 8), (4, 4), (2, 2), (1, 1))
SMEM_PER_BLOCK = cuda_build.SMEM_PER_BLOCK
SM_COUNT = cuda_build.SM_COUNT

# fit(tile, smem, w_resident, w_bytes): blocks of that instantiation an SM
# runs at once (the card's cudaOccupancyMaxActiveBlocksPerMultiprocessor)
Fit = Callable[[int, int, bool, int], int]


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def joiner_smem(J: int, Vc: int, TS: int, w_resident: bool) -> int:
    """Shared-memory bytes of one block (csrc/joiner_stream.cu `js_layout`,
    each region rounded up to 128 bytes): W's slice [J][Vc] f32 where
    resident, else its ring stages [NS KC][Vc]; t's ring stages [NS KC][TS]
    f32; a tile's argmax keys [TS]."""
    w = (J if w_resident else NS * KC) * Vc * 4
    return _up(w, 128) + _up(NS * KC * TS * 4, 128) + _up(TS * 8, 128)


@dataclasses.dataclass(frozen=True)
class JoinerPlan:
    """One launch of kernel 9: n_vs column slices of Vc columns x n_sg
    session groups of `rounds` tiles of TS sessions; each thread (of the
    first TC x TSg) an RC x RS register tile; W's slice resident or
    streamed; `blocks_per_sm` as the card places them."""

    S: int
    J: int
    V: int
    ti: int  # the register tile's index in TILES (the kernel's `tile`)
    TC: int
    TSg: int
    w_resident: bool
    smem: int
    rounds: int
    blocks_per_sm: int

    @property
    def RC(self) -> int:
        return TILES[self.ti][0]

    @property
    def RS(self) -> int:
        return TILES[self.ti][1]

    @property
    def Vc(self) -> int:
        return self.TC * self.RC

    @property
    def TS(self) -> int:
        return self.TSg * self.RS

    @property
    def n_vs(self) -> int:
        return -(-self.V // self.Vc)

    @property
    def n_st(self) -> int:
        return -(-self.S // self.TS)

    @property
    def n_sg(self) -> int:
        return -(-self.n_st // self.rounds)

    @property
    def blocks(self) -> int:
        return self.n_vs * self.n_sg

    @property
    def warps(self) -> int:
        return -(-self.TC * self.TSg // 32)

    @property
    def cycles_per_k(self) -> int:
        """Cycles of an SM's busiest scheduler per k: the tiles a block walks
        x its FFMA slots (the warps it carries x RC RS), at least one fmaf's
        latency (FMA_LATENCY: a chain takes one fmaf a k)."""
        per_sm = -(-self.blocks // SM_COUNT)
        return self.rounds * max(-(-per_sm * self.warps // 4) * self.RC * self.RS, FMA_LATENCY)

    @property
    def staged_bytes(self) -> int:
        """The bytes a call stages into shared memory: each block's W slice
        (once where resident, once a tile where it streams) and t's tiles."""
        w = self.J * self.Vc * 4 * (1 if self.w_resident else self.rounds)
        return self.blocks * (w + self.rounds * self.J * self.TS * 4)

    def v_slice(self, i: int) -> range:
        return range(min(i * self.Vc, self.V), min((i + 1) * self.Vc, self.V))

    def tiles_of(self, g: int) -> range:
        """The session tiles of group g."""
        return range(g * self.rounds, min((g + 1) * self.rounds, self.n_st))

    def tile_rows(self, r: int) -> range:
        return range(r * self.TS, min((r + 1) * self.TS, self.S))

    def columns(self, cg: int, w_bytes: int) -> list:
        """The slice columns of the thread in column group cg, by register:
        vector loads of GC = min(RC, 16 / w_bytes) adjacent columns, the
        loads TC GC columns apart."""
        gc = min(self.RC, 16 // w_bytes)
        return [(j // gc) * self.TC * gc + cg * gc + j % gc for j in range(self.RC)]

    def rows(self, sg: int) -> list:
        """The tile rows of the thread in session group sg, by register."""
        gs = min(self.RS, 4)
        return [(i // gs) * self.TSg * gs + sg * gs + i % gs for i in range(self.RS)]


def _pow2_upto(n: int):
    p = 1
    while p <= n:
        yield p
        p *= 2


def plan_for(S: int, J: int, V: int, w_bytes: int, fit: Fit, ti: int, TC: int, TSg: int,
             w_resident: bool) -> Optional[JoinerPlan]:
    """The launch on register tile TILES[ti], TC column groups and TSg
    session groups, W resident or streamed: each slice's block takes the
    fewest tiles a block that lets every block be co-resident; None where a
    block's shared memory or the card's blocks do not hold it."""
    if TC * TSg > NT:
        return None
    RC, RS = TILES[ti]
    smem = joiner_smem(J, TC * RC, TSg * RS, w_resident)
    if smem > SMEM_PER_BLOCK:
        return None
    bpm = fit(ti, smem, w_resident, w_bytes)
    n_vs, n_st = -(-V // (TC * RC)), -(-S // (TSg * RS))
    if bpm < 1 or n_vs > bpm * SM_COUNT:
        return None
    rounds = -(-n_st // min(n_st, bpm * SM_COUNT // n_vs))
    return JoinerPlan(S, J, V, ti, TC, TSg, w_resident, smem, rounds, bpm)


def joiner_plan(S: int, J: int, V: int, w_bytes: int, fit: Fit) -> Optional[JoinerPlan]:
    """Kernel 9's launch for these shapes (module docstring), or None where
    J is not a positive multiple of KC. Column groups TC are powers of two
    (whole warps reduce a session's columns by shuffles); Vc and TS stop
    where a smaller split already covers V or S."""
    if S < 1 or V < 1 or J < KC or J % KC:
        return None
    best = None
    for ti, (RC, RS) in enumerate(TILES):
        for TC in _pow2_upto(NT):
            if TC > 1 and TC * RC >= 2 * V:
                break
            for TSg in _pow2_upto(NT // TC):
                if TSg > 1 and TSg * RS >= 2 * S:
                    break
                for resident in (True, False):
                    plan = plan_for(S, J, V, w_bytes, fit, ti, TC, TSg, resident)
                    if plan is None:
                        continue
                    key = (plan.cycles_per_k, -RC * RS, -plan.warps, plan.staged_bytes,
                           plan.blocks)
                    if best is None or key < best[0]:
                        best = (key, plan)
    return None if best is None else best[1]


def nominal_fit(tile: int, smem: int, w_resident: bool, w_bytes: int) -> int:
    """`Fit` for a card that places one block an SM: off the card it decides
    whether a plan exists (which depends only on the shapes), not its
    split."""
    return 1


@functools.lru_cache(maxsize=None)
def _fit(tile: int, smem: int, w_resident: bool, w_bytes: int, index: int) -> int:
    fn = cuda_build.bind("joiner_stream", "joiner_stream_fit", 0, 4)
    with torch.cuda.device(index):
        n = fn(tile, int(w_bytes == 4), int(w_resident), smem, None)
    if n < 0:
        raise RuntimeError(f"kernel 9: cudaOccupancyMaxActiveBlocksPerMultiprocessor(tile "
                           f"{TILES[tile]}, smem={smem}) failed with error {-n}")
    return n


def device_fit(index: int) -> Fit:
    """`Fit` queried on card `index` (cached per instantiation and bytes)."""
    return lambda t, smem, r, wb: _fit(t, smem, r, wb, index)


@functools.lru_cache(maxsize=None)
def device_joiner_plan(S: int, J: int, V: int, w_bytes: int, index: int) -> Optional[JoinerPlan]:
    """`joiner_plan` with card `index`'s occupancy (cached per shape)."""
    return joiner_plan(S, J, V, w_bytes, device_fit(index))


@functools.lru_cache(maxsize=None)
def joiner_route(S: int, J: int, V: int, w_bytes: int, fit: Fit = nominal_fit) -> str:
    """Kernel 9's kernel for these shapes: "stream" (csrc/joiner_stream.cu)
    where `joiner_plan` has a plan, else "simt" (csrc/joiner.cu's three
    stream operations). Reads shapes only."""
    return "simt" if joiner_plan(S, J, V, w_bytes, fit) is None else "stream"
