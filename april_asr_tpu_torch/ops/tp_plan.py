"""The launch plans of the tensor-parallel step's kernels 18 and 19 as one
launch each (csrc/lstm_tp_gates.cu), and the route between them and the
kept two-pass kernels (csrc/lstm_tp.cu `tp_gate_cell_proj_simt`,
`tp_gates_cell_i8_simt`, counted as `tp_gcp_simt_f32` / `_bf16` and
`tp_gc_i8_simt`).

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


@functools.lru_cache(maxsize=256)
def device_gcp_plan(S: int, d: int, Hs: int, index: int, ubs=UBS,
                    kcs=KCS) -> Optional[GcpPlan]:
    """`gcp_plan` on card `index`'s SM count, cached per shape."""
    return gcp_plan(S, d, Hs, LM._n_sm(index), ubs=ubs, kcs=kcs)


@functools.lru_cache(maxsize=256)
def device_gc_i8_plan(S: int, d: int, Hs: int, index: int) -> Optional[GcI8Plan]:
    """`gc_i8_plan` on card `index`'s SM count, cached per shape."""
    return gc_i8_plan(S, d, Hs, LM._n_sm(index))


def tp_route(kind: str, S: int, d: int, Hs: int, n_sm: int = cuda_build.SM_COUNT,
             smem_limit: int = SMEM_LIMIT) -> str:
    """The kernel that serves kernel 18 (`kind` "gcp") or 19 ("gc_i8") at
    these shapes: "fused" (csrc/lstm_tp_gates.cu) where its plan exists,
    else "simt" (csrc/lstm_tp.cu's two passes). Reads shapes only."""
    plan = (gcp_plan(S, d, Hs, n_sm, smem_limit=smem_limit) if kind == "gcp"
            else gc_i8_plan(S, d, Hs, n_sm, smem_limit=smem_limit))
    return "simt" if plan is None else "fused"
