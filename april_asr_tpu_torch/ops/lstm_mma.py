"""The launch plan of the persistent int8 tensor-core kernels 2 and 7
(csrc/lstm_mma.cu): how the layer's columns, and where they are fewer than
the blocks its rows, are split over one block per SM, and the shared memory
that takes.

* Gate items (`GateSplit`): item b owns hidden units [ug * ub, +ub) with
  all four gate columns of each (local column gi * ub + u is gate gi of
  unit u), so the cell stays in the block, for rows [rg * rows, +rows),
  ug = b % ngu, rg = b / ngu. Every block streams all the activation rows
  of its row range at every step, and that L2 stream binds the product, so
  ub (4, 8 or 16) is the one whose items split the rows most finely within
  the SM count and the shared memory (the smaller ub on a tie).
* Column splits (`ColSplit`): an N-column product (the projection and ff2,
  N = d; ff1, N = F) in items of `ct` 8-column tiles x `rows` rows; item b
  owns columns [cg * ct * 8, +ct * 8) and rows [rg * rows, +rows), with
  cg = b % ncg and rg = b / ncg. With fewer column tiles than blocks the
  rows are split too, in multiples of 16.
* Shared memory of a block: the gate slice [4 ub][2 dp + 16], its
  [8][16][4 ub + 8] f32 exchange and [3][4 ub] f32 column constants, each
  column slice [ct * 8][Kp + 16] with its f32 column constants, and the
  three-stage A ring (3 x 128 rows x 144 bytes); depths pad to 64 bytes.

The C entries map blocks to work with the same arithmetic, and compute the
same bytes (`rec_smem`, `step_smem`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may opt in to
ROWS = 128  # rows of one pass
KC = 128  # bytes of depth per stage
STAGES = 3  # of the A ring
STAGE_BYTES = STAGES * ROWS * (KC + 16)
UNITS = (4, 8, 16)  # hidden units per gate block


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class ColSplit:
    n: int  # columns
    ct: int  # 8-column tiles per item
    rows: int  # rows per item (a multiple of 16)
    ncg: int  # column groups
    items: int

    def item(self, b: int, sp: int) -> Optional[Tuple[range, range]]:
        """(columns, padded rows) of item b, or None past the last item."""
        if b >= self.items:
            return None
        g, r = b % self.ncg, b // self.ncg
        c0, r0 = g * self.ct * 8, r * self.rows
        return range(c0, min(c0 + self.ct * 8, self.n)), range(r0, min(r0 + self.rows, sp))

    def ints(self) -> Tuple[int, int, int, int]:
        return self.ct, self.rows, self.ncg, self.items

    def smem(self, kp: int, nv: int) -> int:
        """Bytes of an item's weight slice (depth kp) and nv f32 constants
        a column."""
        return self.ct * 8 * (kp + 16 + 4 * nv)


@dataclass(frozen=True)
class GateSplit:
    H: int  # hidden units
    ub: int  # units per item
    rows: int  # rows per item (a multiple of 16)
    ngu: int  # unit groups
    items: int

    def item(self, b: int, sp: int) -> Optional[Tuple[range, range]]:
        """(hidden units, padded rows) of item b, or None past the last."""
        if b >= self.items:
            return None
        u0, r0 = (b % self.ngu) * self.ub, (b // self.ngu) * self.rows
        return range(u0, min(u0 + self.ub, self.H)), range(r0, min(r0 + self.rows, sp))

    def ints(self) -> Tuple[int, int, int]:
        return self.rows, self.ngu, self.items

    def smem(self, dp: int) -> int:
        """Bytes of the weight slice, the f32 exchange and the constants."""
        nc = 4 * self.ub
        return nc * (2 * dp + 16) + 8 * 16 * (nc + 8) * 4 + 3 * nc * 4


def gate_split(H: int, ub: int, n_sm: int, sp: int) -> Optional[GateSplit]:
    """ub-unit items over at most n_sm blocks, the rows split as finely as
    the blocks allow (None where the unit groups alone outnumber them)."""
    ngu = -(-H // ub)
    if ngu > n_sm:
        return None
    mt = sp // 16
    rows = -(-mt // min(n_sm // ngu, mt)) * 16
    return GateSplit(H, ub, rows, ngu, ngu * -(-sp // rows))


def col_split(n: int, nb: int, sp: int, ct_max: int = 2) -> ColSplit:
    """Split n columns over at most nb items of ct whole 8-column tiles (ct
    from the fewest that keep the items within nb up to ct_max) and the sp
    padded rows as finely as the blocks allow: the split with the fewest
    rows an item, which streams the fewest activation bytes (the fewest
    tiles on a tie). Past 2 tiles an item's rows fill too few warps."""
    nct = -(-n // 8)
    mt = sp // 16
    lo = -(-nct // nb)
    best = None
    for ct in range(lo, max(lo, ct_max) + 1):
        ncg = -(-nct // ct)
        rows = -(-mt // min(nb // ncg, mt)) * 16
        if best is None or rows < best.rows:
            best = ColSplit(n, ct, rows, ncg, ncg * -(-sp // rows))
    return best


@dataclass(frozen=True)
class MmaPlan:
    S: int
    d: int
    H: int
    F: int  # 0 for kernel 2 (no FFN)
    sp: int  # rows padded to 16
    dp: int  # depths padded to 64
    hp: int
    fp: int
    gate: GateSplit
    nb: int  # blocks
    proj: ColSplit  # the projection (and kernel 7's ff2): d columns
    ff1: Optional[ColSplit]  # kernel 7's ff1: F columns
    smem: int

    @property
    def ub(self) -> int:
        return self.gate.ub

    def gate_item(self, b: int) -> Optional[Tuple[range, range, List[int]]]:
        """(hidden units, padded rows, weight columns in the block's local
        order) of gate item b, or None past the last."""
        item = self.gate.item(b, self.sp)
        if item is None:
            return None
        units, rows = item
        return units, rows, [gi * self.H + u for gi in range(4) for u in units]


def scratch_layout(plan: "MmaPlan", P: int = 0) -> Tuple[int, Tuple[int, ...]]:
    """(bytes, offsets) of the C entry's scratch buffers in one workspace,
    in its argument order, each 256-byte aligned: kernel 2 (F = 0, P steps)
    xq [P][sp][dp], hq [sp][dp], hcq [sp][hp] int8, hc [S][H] and the row
    scales [P + 2][sp] f32, the amax slots [4][sp]; kernel 7 xq, hq
    [sp][dp], hcq [sp][hp], yq [sp][dp], mq [sp][fp] int8, hc [S][H], y
    [S][d], mid [S][F] and the row scales [5][sp] f32, the amax slots
    [3][sp]."""
    sp, dp, hp, S = plan.sp, plan.dp, plan.hp, plan.S
    if plan.F == 0:
        sizes = (P * sp * dp, sp * dp, sp * hp, 4 * S * plan.H, 4 * (P + 2) * sp, 4 * 4 * sp)
    else:
        sizes = (sp * dp, sp * dp, sp * hp, sp * dp, sp * plan.fp, 4 * S * plan.H, 4 * S * plan.d,
                 4 * S * plan.F, 4 * 5 * sp, 4 * 3 * sp)
    offsets, n = [], 0
    for size in sizes:
        offsets.append(n)
        n += _up(size, 256)
    return n, tuple(offsets)


def _smem(gate: GateSplit, dp: int, hp: int, fp: int, proj: ColSplit,
          ff1: Optional[ColSplit]) -> int:
    if ff1 is None:
        cols = proj.smem(hp, 1)
    else:
        cols = proj.smem(hp, 3) + ff1.smem(dp, 2) + proj.smem(fp, 0)
    return gate.smem(dp) + cols + STAGE_BYTES


def mma_plan(S: int, d: int, H: int, F: int = 0, n_sm: int = 132,
             smem_limit: int = SMEM_LIMIT) -> MmaPlan:
    """The plan of kernel 2 (F = 0) or kernel 7 for S rows at widths d, H
    (and F) on a card of n_sm SMs: of the gate splits whose blocks fit the
    SMs and whose shared memory fits, the one with the fewest rows an item
    (then the fewest units); ValueError where none fits."""
    if min(S, d, H) < 1 or d % 4 or H % 4 or F % 4 or F < 0:
        raise ValueError(f"lstm_mma: no plan for S={S}, d={d}, hidden={H}, ffn={F}: rows must be "
                         "positive and widths positive multiples of 4")
    sp, dp, hp, fp = _up(S, 16), _up(d, 64), _up(H, 64), _up(F, 64)
    tried, plans = [], []
    for ub in UNITS:
        gate = gate_split(H, ub, n_sm, sp)
        if gate is None:
            tried.append(f"ub={ub}: {-(-H // ub)} gate blocks")
            continue
        work = max(gate.items, -(-d // 8) * (sp // 16), -(-F // 8) * (sp // 16))
        nb = min(n_sm, work)
        for ct_max in (2, 1):  # two-tile column items where they fit, else one
            proj = col_split(d, nb, sp, ct_max)
            ff1 = col_split(F, nb, sp, ct_max) if F else None
            smem = _smem(gate, dp, hp, fp, proj, ff1)
            if smem <= smem_limit:
                plans.append(MmaPlan(S, d, H, F, sp, dp, hp, fp, gate, nb, proj, ff1, smem))
                break
        else:
            tried.append(f"ub={ub}: {smem} bytes")
    if plans:
        return min(plans, key=lambda p: (p.gate.rows, p.ub))
    raise ValueError(f"lstm_mma: no plan for S={S}, d={d}, hidden={H}, ffn={F} on {n_sm} SMs "
                     f"within {smem_limit} bytes of shared memory ({'; '.join(tried)})")


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=64)
def _plan_cached(S: int, d: int, H: int, F: int, n_sm: int) -> MmaPlan:
    return mma_plan(S, d, H, F, n_sm)


def device_plan(S: int, d: int, H: int, F: int, device: torch.device) -> MmaPlan:
    """`mma_plan` for the SM count of `device` (a CUDA device)."""
    return _plan_cached(S, d, H, F, _n_sm(device.index if device.index is not None
                                           else torch.cuda.current_device()))
