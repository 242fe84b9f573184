"""The launch plans of the tensor-parallel step's kernels 18 and 19
(csrc/lstm_tp_gates.cu) and 20 and 21 (csrc/lstm_tp_ffn.cu) as one launch
each, and the route between them and the kept column-pass kernels
(csrc/lstm_tp.cu `tp_gate_cell_proj_simt`, `tp_gates_cell_i8_simt`,
`tp_ffn_partial_simt`, `tp_ffn_mid_i8_simt`, counted as `tp_gcp_simt_f32` /
`_bf16`, `tp_gc_i8_simt`, `tp_ffn_simt_f32` / `_bf16` and
`tp_ffn_mid_i8_simt`).

Kernel 18 (`GcpPlan`, f32 or bf16 weights): one cooperative grid of nb <=
n_sm blocks of NT threads walks two phases of items (block b takes items
b, b + nb, ...) with a grid barrier between them.

* Gate items of ub hidden units (all four gate columns of each) x 1024 / ub
  rows (ub 8, 16 or 32): a lane owns its unit's four gates for 4 rows, so
  the cell stays in its registers. Item j is unit group j % ngu and row
  tile j // ngu. x, h and the weights stream in kc-deep stages (64: three
  stages, 32: four).
* Projection items of 32 columns of hp x 32 rows; item j is column group
  j % ncg and row tile j // ncg.

The rule (`gcp_plan`): the fewest waves of per-thread multiply-adds (a gate
item 32 d, a projection item 4 Hs), then the fewest bytes a block streams,
then the fewest blocks, the deeper stage (fewer block barriers), the
smaller ub; None where no split fits `smem_limit` or the widths are not
multiples of 4. At S = 256, d = Hs = 512 on 132 SMs: 128 blocks, ub 16
(64-row gate items) in 64-deep stages, 202,752 bytes a block. On the H100
that took 52.6-55.7 us against 54.0-60.2 for the other tiles and depths the
sweeps tried (tools/profile_tp.py).

Kernel 19 (`GcI8Plan`, int8 weights): kernel 7's gate phase on
ops/lstm_mma.py `gate_split` (ub 4, 8 or 16; the split with the fewest rows
an item, then the smaller ub), nb = the gate items, shared memory the gate
slice and the A ring; None where no split fits the SMs and the shared
memory.

Kernel 20 (`FfnPlan`, f32 or bf16 weights): one cooperative grid of nb <=
n_sm blocks, two phases of items with a grid barrier between: ff1 items
(rows x columns of mid [S, Fs]), then ff2 items (of out [S, d]). An item's
shape (`FfnTile`): its first wr x wc warps compute, a lane rm rows (1, 2 or
4) x 4 nq columns (nq 1 or 2), so it is 4 wr rm rows x 32 nq wc columns.
A 64-deep stage of an item's rows (y or mid, tiled [row tile][depth chunk]
[TR][68] by the kernel) and weight columns (tiled on the host) is two bulk
copies into a ring of three stages, whose size depends on the item shapes
alone. The rule (`ffn_plan`): the fewest
cycles of the two phases' waves (`FfnTile.cycles`: FFMA issue plus shared
memory at 512 bytes an LDS.128, as the card's sweeps ranked the shapes),
then the fewest bytes a block streams, the fewest blocks, the more
computing warps. At S = 256, d = 512, Fs = 1024 on 132 SMs: 128 blocks,
ff1 items of 64 x 32 on 4 warps, ff2 items of 32 x 32 on 2 warps, 4 x 4 a
lane, 76,800 bytes a block.

Kernel 21 (`MidPlan`, int8): items of tr rows x tc columns of mid on
`mma.sync` (tr, tc in 16..128, (tr / 16)(tc / 8) = 8 NTW 8-column tiles a
warp, NTW 1, 2 or 4): the item's ff1 columns and its rows' int8 values in
shared memory, y quantized across the grid into int8 scratch before a grid
barrier. The rule (`mid_plan`): the fewest waves of mma.sync a warp, then
the fewest bytes a block reads (its int8 rows and its weight columns), then
the fewest blocks, the fewer rows. At S = 256, d = 512, Fs = 1024 on 132
SMs: 128 blocks of 32 x 64 items.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import List, Optional, Tuple

from . import cuda_build
from . import lstm_mma as LM

NT = 256  # threads a block
UBS = (8, 16, 32)  # hidden units a gate item
KCS = (64, 32)  # depths of a gate stage
STAGES = {32: 4, 64: 3}  # ring stages by gate-stage depth (`Ring`)
NC = 32  # columns (and rows) of a projection item
KC2 = 128  # depth of a projection stage (TPG_KC2)
SMEM_LIMIT = cuda_build.SMEM_PER_BLOCK


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def gcp_smem(ub: int, kc: int) -> int:
    """Bytes of kernel 18's ring (csrc/lstm_tp_gates.cu `gcp_stage`):
    STAGES[kc] stages, each the larger of a gate stage (x and h [1024 /
    ub][kc + 4], the w_ih and w_hh forms' [kc][ub][4]) and a projection
    stage (hc [32][KC2 + 4], w_hr [KC2][32]), f32."""
    gates = 2 * (1024 // ub) * (kc + 4) * 4 + 2 * kc * ub * 16
    proj = NC * (KC2 + 4) * 4 + KC2 * NC * 4
    return STAGES[kc] * max(gates, proj)


@dataclasses.dataclass(frozen=True)
class GcpPlan:
    S: int
    d: int
    Hs: int
    ub: int
    kc: int  # depth of a gate stage
    nb: int
    smem: int

    @property
    def nr1(self) -> int:
        return 1024 // self.ub

    @property
    def ngu(self) -> int:
        return _cdiv(self.Hs, self.ub)

    @property
    def ncg(self) -> int:
        return _cdiv(self.d, NC)

    def ints(self) -> Tuple[int, ...]:
        """The C entry's plan arguments: ub, kc, nb, smem."""
        return self.ub, self.kc, self.nb, self.smem

    def scratch(self) -> Tuple[int, Tuple[int, ...]]:
        """(bytes, offsets) of the C entry's hc [S][Hs] f32."""
        return 4 * self.S * self.Hs, (0,)

    def gate_items(self, b: int) -> List[Tuple[range, range]]:
        """Block b's gate items in its order: (units, rows) each (units past
        Hs are the kernel's zero columns)."""
        n = self.ngu * _cdiv(self.S, self.nr1)
        return [(range((j % self.ngu) * self.ub, (j % self.ngu + 1) * self.ub),
                 range((j // self.ngu) * self.nr1, min((j // self.ngu + 1) * self.nr1, self.S)))
                for j in range(b, n, self.nb)]

    def proj_items(self, b: int) -> List[Tuple[range, range]]:
        """Block b's projection items: (columns, rows) each (columns past d
        are zero)."""
        n = self.ncg * _cdiv(self.S, NC)
        return [(range((j % self.ncg) * NC, (j % self.ncg + 1) * NC),
                 range((j // self.ncg) * NC, min((j // self.ncg + 1) * NC, self.S)))
                for j in range(b, n, self.nb)]


def gcp_plan(S: int, d: int, Hs: int, n_sm: int = cuda_build.SM_COUNT,
             smem_limit: int = SMEM_LIMIT, ubs=UBS, kcs=KCS) -> Optional[GcpPlan]:
    """Kernel 18's plan for S rows at the shard's widths d and Hs on a card
    of n_sm SMs, among the units a gate item `ubs` and the stage depths
    `kcs`; None where none fits `smem_limit` or the widths are not
    multiples of 4."""
    if min(S, d, Hs) < 1 or d % 4 or Hs % 4:
        return None
    best = None
    for ub, kc in itertools.product(ubs, kcs):
        smem = gcp_smem(ub, kc)
        if smem > smem_limit:
            continue
        nr1 = 1024 // ub
        n1, n2 = _cdiv(Hs, ub) * _cdiv(S, nr1), _cdiv(d, NC) * _cdiv(S, NC)
        nb = min(n_sm, max(n1, n2))
        w1, w2 = _cdiv(n1, nb), _cdiv(n2, nb)
        b1 = 2 * d * ub * 16 + 2 * min(nr1, S) * d * 4
        b2 = Hs * NC * 4 + min(NC, S) * Hs * 4
        key = (w1 * 32 * d + w2 * 4 * Hs, w1 * b1 + w2 * b2, nb, -kc, ub)
        if best is None or key < best[0]:
            best = (key, GcpPlan(S, d, Hs, ub, kc, nb, smem))
    return None if best is None else best[1]


@dataclasses.dataclass(frozen=True)
class GcI8Plan:
    S: int
    d: int
    Hs: int
    sp: int  # rows padded to 16
    dp: int  # depth padded to 64
    gate: LM.GateSplit
    smem: int

    @property
    def ub(self) -> int:
        return self.gate.ub

    @property
    def nb(self) -> int:
        return self.gate.items

    def ints(self) -> Tuple[int, ...]:
        """The C entry's plan arguments: sp, dp, ub, nb and the gate split's
        rows, unit groups and items."""
        return (self.sp, self.dp, self.ub, self.nb, *self.gate.ints())

    def scratch(self) -> Tuple[int, Tuple[int, ...]]:
        """(bytes, offsets) of the C entry's xq, hq [sp][dp] (int8), scl
        [2][sp] (f32) and amax [sp] (u32) in one workspace, each 256-byte
        aligned."""
        sizes = (self.sp * self.dp, self.sp * self.dp, 4 * 2 * self.sp, 4 * self.sp)
        offsets, n = [], 0
        for size in sizes:
            offsets.append(n)
            n += _cdiv(size, 256) * 256
        return n, tuple(offsets)


def gc_i8_plan(S: int, d: int, Hs: int, n_sm: int = cuda_build.SM_COUNT,
               smem_limit: int = SMEM_LIMIT) -> Optional[GcI8Plan]:
    """Kernel 19's plan: of the gate splits (ub 4, 8, 16) whose items fit
    the SMs and whose gate slice and A ring fit `smem_limit`, the one with
    the fewest rows an item, then the smaller ub; None where none does or
    the widths are not multiples of 4."""
    if min(S, d, Hs) < 1 or d % 4 or Hs % 4:
        return None
    sp, dp = _cdiv(S, 16) * 16, _cdiv(d, 64) * 64
    plans = []
    for ub in LM.UNITS:
        gate = LM.gate_split(Hs, ub, n_sm, sp)
        if gate is None:
            continue
        smem = gate.smem(dp) + LM.STAGE_BYTES
        if smem <= smem_limit:
            plans.append(GcI8Plan(S, d, Hs, sp, dp, gate, smem))
    return min(plans, key=lambda p: (p.gate.rows, p.ub)) if plans else None


FFN_KC = 64  # depth of a kernel-20 ring stage (FFN_DK)
FFN_STAGES = 3  # of the ring (FFN_ST)


@dataclasses.dataclass(frozen=True)
class FfnTile:
    """A kernel-20 item shape (csrc/lstm_tp_ffn.cu `FfnTile`): the item's
    first wr * wc warps compute, a lane rm rows x nq float4s of columns."""

    rm: int  # rows a lane: 1, 2 or 4
    nq: int  # float4s of columns a lane: 1 or 2
    wr: int  # computing warps along the rows
    wc: int  # ... along the columns

    @property
    def tr(self) -> int:
        return 4 * self.wr * self.rm

    @property
    def tc(self) -> int:
        return 32 * self.nq * self.wc

    @property
    def nw(self) -> int:
        return self.wr * self.wc

    def stage(self) -> int:
        """Bytes of a ring stage: rows [tr][FFN_KC + 4], weight rows
        [FFN_KC][tc], f32."""
        return (self.tr * (FFN_KC + 4) + FFN_KC * self.tc) * 4

    def cycles(self, K: int) -> int:
        """An item's cost over depth K on one SM, in cycles: per 4 depths a
        lane issues 16 rm nq FFMA (the item's warps on 4 schedulers) and
        reads rm + 4 nq LDS.128, each 512 bytes of the 128 bytes a cycle
        shared memory serves; the two added, as the H100 sweeps of the item
        shapes ranked them (their sum, not the larger, ordered every shape
        measured at S = 256 and 2048; PERF.md)."""
        ffma = _cdiv(self.nw, 4) * 16 * self.rm * self.nq
        lds = self.nw * (self.rm + 4 * self.nq) * 4
        return _cdiv(K, 4) * (ffma + lds)


FFN_TILES = tuple(FfnTile(rm, nq, wr, wc) for rm in (1, 2, 4) for nq in (1, 2)
                  for wr in (1, 2, 4, 8) for wc in (1, 2, 4, 8) if wr * wc <= 8)


def ffn_smem(t1: FfnTile, t2: FfnTile) -> int:
    """Bytes of kernel 20's shared memory (csrc/lstm_tp_ffn.cu `ffn_stb`):
    three ring stages, each the larger of the two phases' stages, then the
    slots' mbarriers."""
    return FFN_STAGES * max(t1.stage(), t2.stage()) + 8 * FFN_STAGES


def ffn_tiled_rows(S: int, K: int, TR: int) -> int:
    """Floats of rows tiled as kernel 20's stages take them: [row tile][depth
    chunk][TR][FFN_KC + 4]."""
    return _cdiv(S, TR) * _cdiv(K, FFN_KC) * TR * (FFN_KC + 4)


def _tiles(S: int, N: int, TR: int, TC: int) -> List[Tuple[range, range]]:
    """Items of TR rows x TC columns over S rows and N columns, item j at
    column group j % ncg and row tile j // ncg: (columns, rows) each
    (columns past N are zero)."""
    ncg = _cdiv(N, TC)
    return [(range((j % ncg) * TC, (j % ncg + 1) * TC),
             range((j // ncg) * TR, min((j // ncg + 1) * TR, S)))
            for j in range(ncg * _cdiv(S, TR))]


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    S: int
    d: int
    Fs: int
    t1: FfnTile  # ff1 items (over Fs columns)
    t2: FfnTile  # ff2 items (over d columns)
    nb: int
    smem: int

    def ints(self) -> Tuple[int, ...]:
        """The C entry's plan arguments: each phase's rm, nq, wr, wc; nb;
        smem."""
        return (*dataclasses.astuple(self.t1), *dataclasses.astuple(self.t2), self.nb,
                self.smem)

    def items(self, phase: int, b: int) -> List[Tuple[range, range]]:
        """Block b's items of phase 1 (ff1, over Fs columns) or 2 (ff2, over
        d) in its order: (columns, rows) each."""
        t, N = (self.t1, self.Fs) if phase == 1 else (self.t2, self.d)
        return _tiles(self.S, N, t.tr, t.tc)[b::self.nb]

    def scratch(self) -> Tuple[int, Tuple[int, ...]]:
        """(bytes, offsets) of the C entry's tiled y (ff1's row tiles over d)
        and mid (ff2's row tiles over Fs), f32, 256-byte aligned."""
        a = _cdiv(4 * ffn_tiled_rows(self.S, self.d, self.t1.tr), 256) * 256
        return a + 4 * ffn_tiled_rows(self.S, self.Fs, self.t2.tr), (0, a)


def ffn_plan(S: int, d: int, Fs: int, n_sm: int = cuda_build.SM_COUNT,
             smem_limit: int = SMEM_LIMIT, tiles=FFN_TILES) -> Optional[FfnPlan]:
    """Kernel 20's plan for S rows at the shard's widths d and Fs on a card
    of n_sm SMs, among the item shapes `tiles`: the fewest cycles of the
    two phases' waves (`FfnTile.cycles`), then the fewest bytes a block
    streams, the fewest blocks, the more computing warps, the taller items;
    None where none fits `smem_limit` or the widths are not multiples of
    4."""
    if min(S, d, Fs) < 1 or d % 4 or Fs % 4:
        return None

    def phase(t, N, K):
        n = _cdiv(S, t.tr) * _cdiv(N, t.tc)
        return n, t.cycles(K), (min(t.tr, S) * K + K * min(t.tc, N)) * 4

    best = None
    p1 = [(t, *phase(t, Fs, d)) for t in tiles]
    p2 = [(t, *phase(t, d, Fs)) for t in tiles]
    for (t1, n1, c1, b1), (t2, n2, c2, b2) in itertools.product(p1, p2):
        smem = ffn_smem(t1, t2)
        if smem > smem_limit:
            continue
        nb = min(n_sm, max(n1, n2))
        w1, w2 = _cdiv(n1, nb), _cdiv(n2, nb)
        key = (w1 * c1 + w2 * c2, w1 * b1 + w2 * b2, nb, -t1.nw, -t2.nw, t1.wc, t2.wc,
               t1.rm, t2.rm, t1.nq, t2.nq)
        if best is None or key < best[0]:
            best = (key, FfnPlan(S, d, Fs, t1, t2, nb, smem))
    return None if best is None else best[1]


MID_TILES = (16, 32, 64, 128)  # rows and columns a kernel-21 item may take


def mid_smem(tr: int, tc: int, dp: int) -> int:
    """Bytes of kernel 21's shared memory (csrc/lstm_tp_ffn.cu `mid_smem`):
    the item's ff1 columns [tc][dp + 16] and rows [tr][dp + 16] (int8), and
    the rows' scales."""
    return (tr + tc) * (dp + 16) + 4 * tr


@dataclasses.dataclass(frozen=True)
class MidPlan:
    S: int
    d: int
    Fs: int
    dp: int  # depth padded to 64
    tr: int
    tc: int
    nb: int
    smem: int

    @property
    def ntw(self) -> int:
        """8-column tiles a warp."""
        return (self.tr // 16) * (self.tc // 8) // 8

    def ints(self) -> Tuple[int, ...]:
        """The C entry's plan arguments: dp, tr, tc, nb, smem."""
        return self.dp, self.tr, self.tc, self.nb, self.smem

    def items(self, b: int) -> List[Tuple[range, range]]:
        """Block b's items in its order: (columns, rows) each."""
        return _tiles(self.S, self.Fs, self.tr, self.tc)[b::self.nb]

    def scratch(self) -> Tuple[int, Tuple[int, ...]]:
        """(bytes, offsets) of the C entry's yq [S][dp] (int8) and ys [S]
        (f32) in one workspace, 256-byte aligned."""
        n = _cdiv(self.S * self.dp, 256) * 256
        return n + _cdiv(4 * self.S, 256) * 256, (0, n)


def mid_plan(S: int, d: int, Fs: int, n_sm: int = cuda_build.SM_COUNT,
             smem_limit: int = SMEM_LIMIT) -> Optional[MidPlan]:
    """Kernel 21's plan for S rows at the shard's widths d and Fs; None where
    no item fits `smem_limit` or the widths are not multiples of 4."""
    if min(S, d, Fs) < 1 or d % 4 or Fs % 4:
        return None
    dp = _cdiv(d, 64) * 64
    best = None
    for tr, tc in itertools.product(MID_TILES, MID_TILES):
        tiles = (tr // 16) * (tc // 8)
        smem = mid_smem(tr, tc, dp)
        if tiles not in (8, 16, 32) or smem > smem_limit:
            continue
        n = _cdiv(S, tr) * _cdiv(Fs, tc)
        nb = min(n_sm, n)
        w = _cdiv(n, nb)
        key = (w * tiles // 8 * dp // 32, w * (min(tr, S) + min(tc, Fs)) * d, nb, tr)
        if best is None or key < best[0]:
            best = (key, MidPlan(S, d, Fs, dp, tr, tc, nb, smem))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def device_gcp_plan(S: int, d: int, Hs: int, index: int, ubs=UBS,
                    kcs=KCS) -> Optional[GcpPlan]:
    """`gcp_plan` on card `index`'s SM count, cached per shape."""
    return gcp_plan(S, d, Hs, LM._n_sm(index), ubs=ubs, kcs=kcs)


@functools.lru_cache(maxsize=256)
def device_gc_i8_plan(S: int, d: int, Hs: int, index: int) -> Optional[GcI8Plan]:
    """`gc_i8_plan` on card `index`'s SM count, cached per shape."""
    return gc_i8_plan(S, d, Hs, LM._n_sm(index))


@functools.lru_cache(maxsize=256)
def device_ffn_plan(S: int, d: int, Fs: int, index: int,
                    tiles=FFN_TILES) -> Optional[FfnPlan]:
    """`ffn_plan` on card `index`'s SM count, cached per shape."""
    return ffn_plan(S, d, Fs, LM._n_sm(index), tiles=tiles)


@functools.lru_cache(maxsize=256)
def device_mid_plan(S: int, d: int, Fs: int, index: int) -> Optional[MidPlan]:
    """`mid_plan` on card `index`'s SM count, cached per shape."""
    return mid_plan(S, d, Fs, LM._n_sm(index))


PLANS = {"gcp": gcp_plan, "gc_i8": gc_i8_plan, "ffn": ffn_plan, "mid_i8": mid_plan}


def tp_route(kind: str, S: int, d: int, n: int, n_sm: int = cuda_build.SM_COUNT,
             smem_limit: int = SMEM_LIMIT) -> str:
    """The kernel that serves kernel 18 (`kind` "gcp"), 19 ("gc_i8"), 20
    ("ffn") or 21 ("mid_i8") at S rows and the shard's widths d and n (Hs
    for 18 and 19, Fs for 20 and 21): "fused" (csrc/lstm_tp_gates.cu,
    csrc/lstm_tp_ffn.cu) where its plan exists, else "simt" (csrc/lstm_tp.cu's
    column passes). Reads shapes only."""
    plan = PLANS[kind](S, d, n, n_sm, smem_limit=smem_limit)
    return "simt" if plan is None else "fused"
