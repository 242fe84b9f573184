"""The launch plans of the persistent layer kernels: the int8 tensor-core
kernels 2 and 7 (csrc/lstm_mma.cu, `mma_plan`; where they have none, the
int8 routes, `int8_routes`) and the float kernels 12 and 10
(csrc/lstm_mma_float.cu, csrc/lstm_chunk_mma.cu; `float_step_plan`,
`float_chunk_plan`, below): how the layer's columns, and where they are
fewer than the blocks its rows, are split over one block per SM, and the
shared memory that takes.

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


# -- the int8 routes: which kernel serves each int8 layer call -------------
#
# Kernels 2 and 7 keep the layer's weights stationary in shared memory, so
# past the flagship widths they have no plan. Their calls then take kernels
# that compute the same function bit for bit and stream their weights:
# kernel 2's the recurrent core of kernel 14 (csrc/lstm_i8.cu `launch_rec<4,
# X_ASYNC>`), kernel 7's the three-pass step (csrc/lstm_step.cu
# `lstm_step_i8_simt`). Kernel 3 (csrc/lstm_i8.cu `ffn_norm_i8`) stages a
# [rt][F] tile a block, so it takes the largest row tile that fits. The
# choice reads widths only (and S, through `mma_plan`), before any launch;
# the byte counts mirror the C launches.

FFN_ROWS = (16, 8, 4)  # kernel 3's row tiles
STEP_FFN_ROWS = 4  # the three-pass step's FFN pass (csrc/lstm_step.cu FRT)


def ffn_i8_smem(rows: int, d: int, F: int) -> int:
    """Bytes of an int8 FFN row tile (csrc/ffn_norm.cuh `ffn_i8_smem`): y
    [rows][d], mid [rows][F] and the scales [2][rows] f32, yq and mq int8."""
    return 4 * (rows * d + rows * F + 2 * rows) + rows * (d + F)


def rec_stream_smem(d: int, H: int) -> int:
    """Bytes of kernel 14's block of 4 sessions (csrc/lstm_i8.cu
    `launch_rec<4, X_ASYNC>`): h, c, hc, two x buffers and the scales f32,
    the int8 h, hc and x rows."""
    ts = 4
    return 4 * (ts * (d + 2 * H) + 2 * ts * d + 4 * ts) + ts * (d + H) + ts * d


def step_simt_smem(d: int, H: int, F: int) -> int:
    """Bytes of the largest block of the int8 three-pass step
    (csrc/lstm_step.cuh `launch_gates`, csrc/lstm_step.cu `gates_proj` and
    its FFN pass): 32 sessions' x and h rows and two staged 32-row weight
    chunks of 64 units' four gates; 16 sessions' hc rows and a 32 x 64
    w_hr chunk; the 4-row FFN tile."""
    gates = 4 * 2 * 32 + 2 * 32 * (d + 16) + 2 * 32 * 4 * 64
    proj = 4 * 16 + 16 * (H + 16) + 32 * 64
    return max(gates, proj, ffn_i8_smem(STEP_FFN_ROWS, d, F))


@dataclass(frozen=True)
class Int8Routes:
    rec: str  # kernel 2's call: "mma" (kernel 2) or "stream" (kernel 14)
    step: str  # kernel 7's call: "mma" (kernel 7) or "simt" (the three-pass step)
    ffn_rows: int  # kernel 3's row tile


def rec_route(S: int, d: int, H: int, n_sm: int = 132, smem_limit: int = SMEM_LIMIT) -> str:
    """Kernel 2's route for S rows at widths d, H."""
    try:
        mma_plan(S, d, H, 0, n_sm, smem_limit)
        return "mma"
    except ValueError as e:
        if rec_stream_smem(d, H) <= smem_limit:
            return "stream"
        raise ValueError(f"{e}; kernel 14 needs {rec_stream_smem(d, H)} bytes") from None


def step_route(S: int, d: int, H: int, F: int, n_sm: int = 132,
               smem_limit: int = SMEM_LIMIT) -> str:
    """Kernel 7's route for S rows at widths d, H, F."""
    try:
        mma_plan(S, d, H, F, n_sm, smem_limit)
        return "mma"
    except ValueError as e:
        if step_simt_smem(d, H, F) <= smem_limit:
            return "simt"
        raise ValueError(f"{e}; the three-pass step needs {step_simt_smem(d, H, F)} "
                         "bytes") from None


def ffn_rows(d: int, F: int, smem_limit: int = SMEM_LIMIT) -> int:
    """Kernel 3's row tile at widths d, F: the largest that fits."""
    for rows in FFN_ROWS:
        if ffn_i8_smem(rows, d, F) <= smem_limit:
            return rows
    raise ValueError(f"ffn_norm_i8: no row tile for d={d}, ffn={F} within {smem_limit} bytes "
                     f"of shared memory ({ffn_i8_smem(FFN_ROWS[-1], d, F)} at "
                     f"{FFN_ROWS[-1]} rows)")


def int8_routes(S: int, P: int, d: int, H: int, F: int, n_sm: int = 132,
                smem_limit: int = SMEM_LIMIT) -> Int8Routes:
    """The route of each int8 layer call of an engine over S rows and P
    steps (P does not change them: kernels 2 and 14 stream x by step):
    ValueError where a call has none."""
    if min(S, P, d, H, F) < 1 or d % 4 or H % 4 or F % 4:
        raise ValueError(f"int8 routes: no route for S={S}, P={P}, d={d}, hidden={H}, ffn={F}: "
                         "rows and steps must be positive and widths positive multiples of 4")
    return Int8Routes(rec_route(S, d, H, n_sm, smem_limit),
                      step_route(S, d, H, F, n_sm, smem_limit), ffn_rows(d, F, smem_limit))


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=64)
def _plan_cached(S: int, d: int, H: int, F: int, n_sm: int) -> MmaPlan:
    return mma_plan(S, d, H, F, n_sm)


def device_plan(S: int, d: int, H: int, F: int, device: torch.device) -> MmaPlan:
    """`mma_plan` for the SM count of `device` (a CUDA device)."""
    return _plan_cached(S, d, H, F, device_sm(device))


@functools.lru_cache(maxsize=256)
def _route_cached(kind: str, S: int, d: int, H: int, F: int, n_sm: int) -> str:
    return rec_route(S, d, H, n_sm) if kind == "rec" else step_route(S, d, H, F, n_sm)


def device_route(kind: str, S: int, d: int, H: int, F: int, device: torch.device) -> str:
    """`rec_route` ("rec") or `step_route` ("step") for the SM count of
    `device` (a CUDA device)."""
    return _route_cached(kind, S, d, H, F, device_sm(device))


def device_sm(device: torch.device) -> int:
    """The SM count of `device` (a CUDA device)."""
    return _n_sm(device.index if device.index is not None else torch.cuda.current_device())


# -- kernels 12 and 10: the float layer (csrc/lstm_mma_float.cu, one step;
# csrc/lstm_chunk_mma.cu, P steps of its gate and projection phases, then
# its FFN over the P * S rows) ----------------------------------------------
#
# Every phase is a set of tile items: item b of a `TileSplit` owns rows
# [rg * nr, +nr) and local columns [cg * nc, +nc) (cg = b % ncg, rg = b //
# ncg; for the gate phase the nc = 4 ub columns are the four gates of ub
# hidden units [cg * ub, +ub)). A block walks its items (b = blockIdx,
# blockIdx + nb, ...), streaming A (f32 activation rows) and B (the item's
# weight columns, f32 or bf16) through one three-stage shared ring in depth
# chunks of FKC values, so the weights cross from device memory once per
# launch. The block's 256 threads form `ks` groups that split each chunk's
# depth; each group covers the whole nr x nc tile: at f32 a thread owns an
# 8-row x 8-column register tile (FFMA), at bf16 a warp owns 16 rows x 8 ntw
# columns of m16n8k16 `mma.sync` tiles. The groups' partial tiles are summed
# in group order in shared memory, then the phase's epilogue reads the tile.

FKC = 64  # depth values of one chunk
FLDA = FKC + 8  # f32 stride of a staged A row (conflict-free fragment loads)
F_STAGES = 3
F_THREADS = 256
# bytes of the partial tiles at most: f32 8 x 8 a thread, bf16 16 x 64 a warp
F_PART_MAX = {4: F_THREADS * 64 * 4, 2: 8 * 16 * 64 * 4}
F_TILE_ROWS = (16, 32, 64, 128)
F_TILE_COLS = (16, 32, 64, 128)
F_UNITS = (8, 16, 32)
# the plan's cost model (tools/profile_lstm_mma.py's phase stamps, H100):
# FMAs per ns of one SM at each weight type, and the bytes per ns that all
# the blocks together, and one block alone, stream from L2 (each item reads
# its A rows and its B columns once); a phase takes the longest of its
# items' products and their streams, in rounds of n_sm blocks, and the
# whole phase's stream
F_RATE = {4: 110.0, 2: 2000.0}
F_L2_BPS = 1800.0
F_SM_BPS = 15.0
F_ITEM_NS = 500.0  # an item's fixed cost: its epilogue and ring start


@dataclass(frozen=True)
class TileSplit:
    nr: int  # rows per item (a multiple of 16)
    nc: int  # local columns per item
    ncg: int  # column groups (unit groups for the gates)
    items: int
    ks: int  # depth groups of the block's threads
    ntw: int  # bf16: 8-column mma tiles of a warp (0 at f32)

    def item(self, b: int, n: int, S: int) -> Optional[Tuple[range, range]]:
        """(local columns, rows) of item b, cut at n columns and S rows, or
        None past the last item."""
        if b >= self.items:
            return None
        g, r = b % self.ncg, b // self.ncg
        return (range(g * self.nc, min((g + 1) * self.nc, n)),
                range(r * self.nr, min((r + 1) * self.nr, S)))

    def ints(self) -> Tuple[int, int, int, int, int, int]:
        return self.nr, self.nc, self.ncg, self.items, self.ks, self.ntw

    def stage(self, wbytes: int) -> int:
        """Bytes of one ring stage: A [nr][FLDA] f32, B [FKC][nc + 8]."""
        return self.nr * FLDA * 4 + FKC * (self.nc + 8) * wbytes

    def part(self) -> int:
        """Bytes of the groups' partial tiles [ks][nr][nc] f32."""
        return self.ks * self.nr * self.nc * 4


def tile_groups(nr: int, nc: int, wbytes: int) -> Optional[Tuple[int, int]]:
    """(ks, ntw) of an nr x nc tile on 256 threads, or None where the tile
    does not map: at f32 (nr / 8) x (nc / 8) threads a group, at most 16
    groups (4 depth values a group and chunk); at bf16 (nr / 16) x (nc / 8
    ntw) warps a group (ntw = min(8, nc / 8), even), at most 4 groups (one
    16-deep mma step a group and chunk)."""
    if nr % 16 or nc % 16:
        return None
    if wbytes == 4:
        tpg = (nr // 8) * (nc // 8)
        if tpg > F_THREADS or F_THREADS % tpg or F_THREADS // tpg > FKC // 4:
            return None
        return F_THREADS // tpg, 0
    ntw = min(8, nc // 8)
    wpg = (nr // 16) * (nc // (8 * ntw))
    if wpg > 8 or 8 % wpg or 8 // wpg > FKC // 16:
        return None
    return 8 // wpg, ntw


def _phase_ns(sp: "TileSplit", K: int, wbytes: int, n_sm: int) -> float:
    item_bytes = sp.nr * K * 4 + K * sp.nc * wbytes
    item = max(sp.nr * sp.nc * K / F_RATE[wbytes], item_bytes / F_SM_BPS) + F_ITEM_NS
    return max(-(-sp.items // n_sm) * item, sp.items * item_bytes / F_L2_BPS)


def _tile_split(n: int, K: int, S: int, wbytes: int, n_sm: int, cols,
                stage_max: int) -> Optional[TileSplit]:
    """The split of an n-column product of depth K over S rows whose items
    finish soonest on n_sm blocks by the cost model (the fewest items on a
    tie), among the tiles whose stage fits stage_max."""
    best, key = None, None
    for nc in cols:
        for nr in F_TILE_ROWS:
            g = tile_groups(nr, nc, wbytes)
            if g is None:
                continue
            ncg = -(-n // nc)
            sp = TileSplit(nr, nc, ncg, ncg * -(-S // nr), *g)
            if sp.stage(wbytes) > stage_max:
                continue
            k = (_phase_ns(sp, K, wbytes, n_sm), sp.items, -nr)
            if key is None or k < key:
                best, key = sp, k
    return best


@dataclass(frozen=True)
class FloatPlan:
    S: int
    d: int
    H: int
    F: int
    wbytes: int  # 4 (f32 weights) or 2 (bf16)
    ub: int  # hidden units of a gate item
    gate: TileSplit  # nc = 4 ub: gate gi of unit u is local column gi * ub + u
    proj: TileSplit  # d columns, depth H
    ff1: TileSplit  # F columns, depth d
    ff2: TileSplit  # d columns, depth F
    nb: int
    smem: int
    P: int = 1  # steps: the gate and projection splits cover S rows, ff1 and ff2 P * S

    def splits(self) -> Tuple[TileSplit, TileSplit, TileSplit, TileSplit]:
        return self.gate, self.proj, self.ff1, self.ff2

    def gate_item(self, b: int) -> Optional[Tuple[range, range, List[int]]]:
        """(hidden units, rows, weight columns in the block's local order) of
        gate item b, or None past the last."""
        if b >= self.gate.items:
            return None
        g, r = b % self.gate.ncg, b // self.gate.ncg
        units = range(g * self.ub, min((g + 1) * self.ub, self.H))
        rows = range(r * self.gate.nr, min((r + 1) * self.gate.nr, self.S))
        return units, rows, [gi * self.H + u for gi in range(4) for u in units]

    def ints(self) -> Tuple[int, ...]:
        return (self.ub, self.nb) + sum((s.ints() for s in self.splits()), ())


def float_smem(splits, wbytes: int) -> int:
    """Bytes of kernel 10's or 12's shared memory: the three-stage ring,
    each stage sized for the largest phase, and the largest partial tiles
    (csrc/lstm_mma.cuh `float_smem`)."""
    return F_STAGES * max(s.stage(wbytes) for s in splits) + max(s.part() for s in splits)


def _float_plan(what: str, S: int, P: int, d: int, H: int, F: int, wbytes: int, n_sm: int,
                smem_limit: int) -> FloatPlan:
    """The gate and projection splits over S rows and the ff1 and ff2 splits
    over P * S rows, each phase's tile by the cost model, three stages of
    every tile within the shared memory left after the partial tiles."""
    if wbytes not in (2, 4):
        raise ValueError(f"{what}: weights of {wbytes} bytes: f32 or bf16 only")
    if min(S, P, d, H, F) < 1 or d % 4 or H % 4 or F % 4:
        raise ValueError(f"{what}: no plan for S={S}, P={P}, d={d}, hidden={H}, ffn={F}: rows "
                         "and steps must be positive and widths positive multiples of 4")
    stage_max = (smem_limit - F_PART_MAX[wbytes]) // F_STAGES
    gate = None
    for ub in F_UNITS:
        # ceil(4 H / 4 ub) unit groups
        sp = _tile_split(4 * H, 2 * d, S, wbytes, n_sm, (4 * ub,), stage_max)
        if sp is not None:
            k = (_phase_ns(sp, 2 * d, wbytes, n_sm), sp.items)
            if gate is None or k < gate[0]:
                gate = (k, ub, sp)
    proj = _tile_split(d, H, S, wbytes, n_sm, F_TILE_COLS, stage_max)
    ff1 = _tile_split(F, d, P * S, wbytes, n_sm, F_TILE_COLS, stage_max)
    ff2 = _tile_split(d, F, P * S, wbytes, n_sm, F_TILE_COLS, stage_max)
    if gate is None or None in (proj, ff1, ff2):
        raise ValueError(f"{what}: no plan for S={S}, P={P}, d={d}, hidden={H}, ffn={F} within "
                         f"{smem_limit} bytes of shared memory")
    splits = (gate[2], proj, ff1, ff2)
    nb = min(n_sm, max(s.items for s in splits))
    return FloatPlan(S, d, H, F, wbytes, gate[1], *splits, nb, float_smem(splits, wbytes), P)


def float_step_plan(S: int, d: int, H: int, F: int, wbytes: int, n_sm: int = 132,
                    smem_limit: int = SMEM_LIMIT) -> FloatPlan:
    """Kernel 12's plan for S rows at widths d, H, F with f32 (wbytes 4) or
    bf16 (2) weights on n_sm SMs: each phase's tile split by the cost model,
    three stages of every tile within the shared memory left after the
    partial tiles; ValueError where the widths are not multiples of 4 or no
    tile fits."""
    return _float_plan("lstm_step", S, 1, d, H, F, wbytes, n_sm, smem_limit)


def float_chunk_plan(S: int, P: int, d: int, H: int, F: int, wbytes: int, n_sm: int = 132,
                     smem_limit: int = SMEM_LIMIT) -> FloatPlan:
    """Kernel 10's plan (csrc/lstm_chunk_mma.cu) for P steps of S rows:
    kernel 12's gate and projection splits at S rows, its ff1 and ff2 splits
    at the P * S rows of the chunk's FFN; ValueError as `float_step_plan`."""
    return _float_plan("lstm_chunk", S, P, d, H, F, wbytes, n_sm, smem_limit)


def chunk_scratch(plan: FloatPlan) -> int:
    """f32 values of kernel 10's scratch: hc [S][H], then mid [P * S][F]."""
    return plan.S * plan.H + plan.P * plan.S * plan.F


@functools.lru_cache(maxsize=64)
def _float_plan_cached(what: str, S: int, P: int, d: int, H: int, F: int, wbytes: int,
                       n_sm: int) -> FloatPlan:
    return _float_plan(what, S, P, d, H, F, wbytes, n_sm, SMEM_LIMIT)


def device_float_plan(S: int, d: int, H: int, F: int, wbytes: int,
                      device: torch.device) -> FloatPlan:
    """`float_step_plan` for the SM count of `device` (a CUDA device)."""
    return _float_plan_cached("lstm_step", S, 1, d, H, F, wbytes, device_sm(device))


def device_chunk_plan(S: int, P: int, d: int, H: int, F: int, wbytes: int,
                      device: torch.device) -> FloatPlan:
    """`float_chunk_plan` for the SM count of `device` (a CUDA device)."""
    return _float_plan_cached("lstm_chunk", S, P, d, H, F, wbytes, device_sm(device))
