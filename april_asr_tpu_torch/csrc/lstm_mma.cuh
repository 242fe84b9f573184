// Pieces of the persistent, weight-stationary int8 tensor-core layer kernels
// 2 and 7 (csrc/lstm_mma.cu): one cooperative launch of at most one block
// per SM, the work split by columns, each block's weight slice staged once
// into shared memory, every dot an `mma.sync` m16n8k32 s8 -> s32 product
// (csrc/mma_tc.cuh), and the row scales of `_rowq8` folded across blocks.
//
// The launch plan (units per gate block, the column splits, the grid and
// the shared memory) is ops/lstm_mma.py's `mma_plan`; the C side reads its
// integers and maps blocks to work with the same arithmetic:
//
//   gate item b of a GateSplit (b < items) owns hidden units [ug * UB,
//     +UB) with all four gate columns of each (local column gi * UB + u is
//     gate gi of unit u), so the cell stays in the block, for rows
//     [rg * rows, +rows), ug = b % ngu, rg = b / ngu;
//   column item b of a ColSplit (b < items) owns output columns
//     [cg * ct * 8, +ct * 8) and rows [rg * rows, +rows), cg = b % ncg,
//     rg = b / ncg.
//
// Splitting rows as well as columns cuts what each block streams: every
// block reads all the activation rows of its row range at every step (the
// A operand is broadcast from L2 to all the blocks of a row range), and
// that stream, about 3.5 TB/s across the card, is what binds the products.
//
// Operands. A (the activation rows, int8 in device-memory scratch of row
// stride Kp, the depth padded to 64) streams from L2 through a three-stage
// shared ring by cp.async.cg, 128 rows x 128 bytes a stage, two stages in
// flight while one is multiplied; each of the 8
// warps owns a 16-row tile of a pass and reads it with `ldmatrix`. B (the
// block's weight columns) is staged once as [n][k] (the int8 [k][n] rows
// transposed in 4 x 4 byte blocks, `transpose4x4_s8`), zero past K and past
// the valid columns, so the padded depth and the ragged edges add nothing
// to an integer dot; A's pad bytes and pad rows are never initialised and
// their results are never stored.
//
// Row scales across blocks. A row's amax is folded into a per-row slot with
// atomicMax on the non-negative float's bits (exact, order-free), then,
// after a grid barrier, each block quantizes its own slice with the row's
// scale, as warp_rowq8 computes it: s = max(amax, 1e-30) * (1/127),
// q = rint(v * rcp(s)). Scratch that other blocks wrote is read through L2
// (cp.async.cg, __ldcg), never through the non-coherent L1 path.
//
// Numerics: exact int32 dots; every f32 step outside them rounded
// separately (__fmul_rn/__fadd_rn) in the op order of the kernels this
// replaces (csrc/lstm_step.cu, csrc/lstm_i8.cu); tanhf, sig_tanh, rsqrtf and
// warp_rowq8 are the shared device functions (no fast-math).
#pragma once

#include <cooperative_groups.h>

#include "lstm_step.cuh"  // blend; the row helpers of common.cuh
#include "mma_tc.cuh"

#define MMA_NT 256                       // 8 warps
#define MMA_ROWS 128                     // rows of a pass: one 16-row tile per warp
#define MMA_KC 128                       // bytes of depth per stage
#define MMA_LDA (MMA_KC + 16)            // padded stage row (bytes)
#define MMA_STAGE (MMA_ROWS * MMA_LDA)   // bytes of one stage
#define MMA_NST 3                        // stages of the A ring (2 chunks in flight)
#define MMA_RING (MMA_NST * MMA_STAGE)   // bytes of the A ring
#define MMA_NTW 2                        // 8-column tiles a column pass multiplies at once

namespace cg = cooperative_groups;

// An N-column product split over blocks in items of ct 8-column tiles x
// `rows` rows (ops/lstm_mma.py `ColSplit`)
struct ColSplit {
  int ct, rows, ncg, items;
};

struct Item {
  int c0, c1, r0, r1;  // columns [c0, c1), rows [r0, r1) (r1 <= the padded row count)
};

__device__ __forceinline__ bool col_item(const ColSplit& cs, int b, int N, int Sp, Item& it) {
  if (b >= cs.items) return false;
  const int g = b % cs.ncg, r = b / cs.ncg;
  it.c0 = g * cs.ct * 8;
  it.c1 = min(it.c0 + cs.ct * 8, N);
  it.r0 = r * cs.rows;
  it.r1 = min(it.r0 + cs.rows, Sp);
  return true;
}

__device__ __forceinline__ void mma_cp16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void mma_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void mma_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// _rowq8's scale of a row whose amax has the bits `bits` (warp_rowq8's)
__device__ __forceinline__ float amax_scale(unsigned bits) {
  return __fmul_rn(fmaxf(__uint_as_float(bits), ROWQ_FLOOR), INV127);
}

__device__ __forceinline__ char4 quant4(const float4 v, float inv) {
  return make_char4((signed char)__float2int_rn(__fmul_rn(v.x, inv)),
                    (signed char)__float2int_rn(__fmul_rn(v.y, inv)),
                    (signed char)__float2int_rn(__fmul_rn(v.z, inv)),
                    (signed char)__float2int_rn(__fmul_rn(v.w, inv)));
}

// Weight columns of W [K][N] (row-major int8) into B ([n][k], row stride
// ldb) from depth koff: local column n takes global column col_of(n) (-1:
// none; 4 consecutive local columns map to 4 consecutive global ones); k in
// [K, Kp) and absent columns are zero.
template <class ColOf>
__device__ __forceinline__ void stage_cols(uint8_t* B, int ldb, int koff,
                                           const int8_t* __restrict__ W, int N, int K, int Kp,
                                           int ncols, ColOf col_of) {
  const int ng = ncols >> 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < (Kp >> 2) * ng; i += MMA_NT) {
    const int kg = i / ng, n0 = (i - kg * ng) * 4, k0 = kg * 4;
    const int gc = col_of(n0);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (gc >= 0 && k0 < K) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(W + (size_t)(k0 + r) * N + gc);
    }
    transpose4x4_s8(w);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(B + (size_t)(n0 + c) * ldb + koff + k0) = w[c];
  }
}

// One pass of 128 rows from row0 (rows at or past rend are not loaded): the
// warp's 16-row tile of acc0 = A0[:, 0:K0] . B[:, 0:K0] and, with TWO, of
// acc1 = A1[:, 0:K1] . B[:, K0:K0+K1], for nt (<= NT) 8-column tiles of B.
// A0 and A1 are row-major int8 of row stride K0 and K1 (multiples of 64),
// read in depth chunks of MMA_KC through the MMA_NST-stage ring. Every
// thread of the block calls it; it synchronizes the block.
template <int NT, bool TWO>
__device__ __forceinline__ void mma_pass(int (&acc0)[NT][4], int (&acc1)[NT][4],
                                         const int8_t* A0, int K0, const int8_t* A1, int K1,
                                         int row0, int rend, const uint8_t* B, int ldb, int nt,
                                         uint8_t* stage) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0;
  const int n0 = (K0 + MMA_KC - 1) / MMA_KC;
  const int nch = n0 + (TWO ? (K1 + MMA_KC - 1) / MMA_KC : 0);
  const int nrows = min(MMA_ROWS, rend - row0);
  // chunk c into stage c % MMA_NST (one commit group a call, empty past the last chunk)
  auto load = [&](int c) {
    if (c < nch) {
      const bool p1 = TWO && c >= n0;
      const int K = p1 ? K1 : K0, kb = (p1 ? c - n0 : c) * MMA_KC, w16 = min(MMA_KC, K - kb) >> 4;
      const int8_t* A = (p1 ? A1 : A0) + (size_t)row0 * K + kb;
      uint8_t* st = stage + (c % MMA_NST) * MMA_STAGE;
      for (int i = tid; i < nrows * w16; i += MMA_NT) {
        const int r = i / w16, p = i - r * w16;
        mma_cp16(st + r * MMA_LDA + p * 16, A + (size_t)r * K + p * 16);
      }
    }
    mma_cp_commit();
  };
#pragma unroll
  for (int c = 0; c < MMA_NST - 1; ++c) load(c);
  const bool live = warp * 16 < nrows;
  for (int c = 0; c < nch; ++c) {
    mma_cp_wait<MMA_NST - 2>();  // chunk c has landed
    __syncthreads();             // ... for every thread; and stage (c - 1) % MMA_NST is free
    load(c + MMA_NST - 1);
    if (live) {
      const bool p1 = TWO && c >= n0;
      const int K = p1 ? K1 : K0, kb = (p1 ? c - n0 : c) * MMA_KC, kn = min(MMA_KC, K - kb);
      const uint8_t* sa = stage + (c % MMA_NST) * MMA_STAGE + (warp * 16 + (lane & 15)) * MMA_LDA
                          + (lane >> 4) * 16;
      const uint8_t* sb = B + (lane & 7) * ldb + (p1 ? K0 : 0) + kb + (lane >> 3) * 16;
      for (int ks = 0; ks < kn; ks += 64) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, sa + ks);
        ldmatrix_x4(a1, sa + ks + 32);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            uint32_t b[4];  // b[0..1]: depth ks..ks+31, b[2..3]: ks+32..ks+63 of columns j*8..
            ldmatrix_x4(b, sb + j * 8 * ldb + ks);
            if (p1) {
              mma_s8_16832(acc1[j], a0, b[0], b[1]);
              mma_s8_16832(acc1[j], a1, b[2], b[3]);
            } else {
              mma_s8_16832(acc0[j], a0, b[0], b[1]);
              mma_s8_16832(acc0[j], a1, b[2], b[3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the ring is free for the caller's next pass
}

// A gate split (ops/lstm_mma.py `GateSplit`): item b owns hidden units
// [ug * UB, +UB) with their four gate columns, for rows [rg * rows, +rows),
// ug = b % ngu, rg = b / ngu
struct GateSplit {
  int rows, ngu, items;
};

__device__ __forceinline__ bool gate_item(const GateSplit& gs, int b, int ub, int Sp, int& u0,
                                          int& r0, int& r1) {
  if (b >= gs.items) return false;
  u0 = (b % gs.ngu) * ub;
  r0 = (b / gs.ngu) * gs.rows;
  r1 = min(r0 + gs.rows, Sp);
  return true;
}

// The gate phase's inputs: the quantized x_t and h rows ([Sp][dp]) and
// their row scales, the carried c, hc's output and its row amax slots.
struct GateIn {
  const int8_t *xq, *hq;
  const float *xs, *hs;
  const float* c_old;  // [S][H]
  float* hcf;          // [S][H]
  unsigned* amax;      // [Sp]
};

// The block's per-column constants of its gate columns into gcs [3][NC]:
// the w_ih and w_hh column scales and the bias as f32 (zero where absent)
template <class ColOf>
__device__ __forceinline__ void stage_gate_consts(float* gcs, int nc, const float* __restrict__ wihs,
                                                  const float* __restrict__ whhs, const void* bias,
                                                  int bias_bf16, ColOf col_of) {
  for (int n = threadIdx.x; n < nc; n += MMA_NT) {
    const int col = col_of(n);
    gcs[n] = col >= 0 ? wihs[col] : 0.f;
    gcs[nc + n] = col >= 0 ? whhs[col] : 0.f;
    gcs[2 * nc + n] = col >= 0 ? load_vec(bias, col, bias_bf16) : 0.f;
  }
}

// The gates and cell of the gate item (units u0.., rows [r0, r1)): gates =
// (dot(xq, w_ih) * (xs * s_ih) + dot(hq, w_hh) * (hs * s_hh)) + b, then
// c' = sig(f) * c + sig(i) * tanh(g) and hc = sig(o) * tanh(c'), as
// rec_gates_cell and step_gates compute them. Writes hc, folds |hc| into
// the row amax slots and hands (row, index, c, c', caux(row)) to cstore.
// gcs [3][NC] holds the columns' scales and bias (`stage_gate_consts`);
// gbuf is the block's [8][16][NC + 8] f32 exchange (rows padded so that a
// half-warp's float2 stores hit distinct banks): the gate values go from
// the mma fragments to the threads that own a (row, unit). Each pass first
// issues the loads its epilogue needs (row scales, c, caux), so that they
// land while the pass multiplies.
template <int NTG, class CAux, class CStore>
__device__ __forceinline__ void gate_phase(const GateIn& g, const uint8_t* Bg, int ldg,
                                           const float* gcs, float* gbuf, uint8_t* stage, int u0,
                                           int r0, int r1, int S, int dp, int H, CAux caux,
                                           CStore cstore) {
  constexpr int UB = 2 * NTG, NC = 8 * NTG, NCELL = UB / 2;  // a lane's cells a pass
  constexpr int LDG = NC + 8;                                 // gbuf row stride
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  float* gb = gbuf + warp * 16 * LDG;
  for (int row0 = r0; row0 < r1; row0 += MMA_ROWS) {
    const int rw = row0 + warp * 16;
    const bool wl = rw < r1;
    float xsr[2], hsr[2], cold[NCELL], cax[NCELL];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rw + gq + hh * 8;
      const bool ok = wl && row < S;
      xsr[hh] = ok ? __ldcg(g.xs + row) : 0.f;
      hsr[hh] = ok ? __ldcg(g.hs + row) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NCELL; ++i) {
      const int it = lane + 32 * i, rin = it / UB, row = rw + rin, U = u0 + it - rin * UB;
      const bool ok = wl && row < S && U < H;
      cold[i] = ok ? __ldcg(g.c_old + (size_t)row * H + U) : 0.f;
      cax[i] = ok ? caux(row) : 0.f;
    }
    int ax[NTG][4], ah[NTG][4];
    mma_pass<NTG, true>(ax, ah, g.xq, dp, g.hq, dp, row0, r1, Bg, ldg, NTG, stage);
    if (!wl) continue;
#pragma unroll
    for (int j = 0; j < NTG; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows gq and gq + 8, columns lc and lc + 1
        const int lc = j * 8 + 2 * q;
        float v[2];
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int e = 2 * hh + o;
          const float gx = __fmul_rn((float)ax[j][e], __fmul_rn(xsr[hh], gcs[lc + o]));
          const float gh = __fmul_rn((float)ah[j][e], __fmul_rn(hsr[hh], gcs[NC + lc + o]));
          v[o] = __fadd_rn(__fadd_rn(gx, gh), gcs[2 * NC + lc + o]);
        }
        *reinterpret_cast<float2*>(gb + (gq + hh * 8) * LDG + lc) = make_float2(v[0], v[1]);
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NCELL; ++i) {
      const int it = lane + 32 * i, rin = it / UB, u = it - rin * UB, row = rw + rin, U = u0 + u;
      float m = 0.f;
      if (row < S && U < H) {
        const float* gr = gb + rin * LDG + u;
        const size_t k = (size_t)row * H + U;
        const float cn = __fadd_rn(__fmul_rn(sig_tanh(gr[UB]), cold[i]),
                                   __fmul_rn(sig_tanh(gr[0]), tanhf(gr[2 * UB])));
        const float hc = __fmul_rn(sig_tanh(gr[3 * UB]), tanhf(cn));
        __stcg(g.hcf + k, hc);
        cstore(row, k, cold[i], cn, cax[i]);
        m = fabsf(hc);
      }
      // the UB lanes of one row are consecutive: fold them, one atomic a row
#pragma unroll
      for (int o = UB / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((lane & (UB - 1)) == 0 && row < S) atomicMax(g.amax + row, __float_as_uint(m));
    }
    __syncwarp();
  }
}

// A column item's product A [rows][K] . B, in passes of 128 rows and NTW
// column tiles: epi(row, col, acc, rpre(row), epre(row, col)) for every
// row < S and col < c1 returns a value whose row max is folded into amax
// (skipped where amax is null). rpre and epre (each a float2) are loaded
// before the pass multiplies, so that their latency hides behind it.
template <int NTW, class RPre, class EPre, class Epi>
__device__ __forceinline__ void cols_phase(const Item& it, const int8_t* A, int K, const uint8_t* B,
                                           int ldb, uint8_t* stage, int S, unsigned* amax,
                                           RPre rpre, EPre epre, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const int ntile = (it.c1 - it.c0 + 7) >> 3;
  const float2 zero = make_float2(0.f, 0.f);
  for (int j0 = 0; j0 < ntile; j0 += NTW) {
    const int nt = min(NTW, ntile - j0);
    for (int row0 = it.r0; row0 < it.r1; row0 += MMA_ROWS) {
      const int rw = row0 + warp * 16;
      const bool wl = rw < it.r1;
      float2 rv[2], ev[NTW][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rw + gq + hh * 8;
        rv[hh] = wl && row < S ? rpre(row) : zero;
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rw + gq + (e >> 1) * 8, col = it.c0 + (j0 + j) * 8 + 2 * q + (e & 1);
          ev[j][e] = wl && j < nt && row < S && col < it.c1 ? epre(row, col) : zero;
        }
      int acc[NTW][4];
      mma_pass<NTW, false>(acc, acc, A, K, nullptr, 0, row0, it.r1, B + (size_t)j0 * 8 * ldb, ldb,
                           nt, stage);
      if (!wl) continue;
      float m[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rw + gq + (e >> 1) * 8, col = it.c0 + (j0 + j) * 8 + 2 * q + (e & 1);
          if (j < nt && row < S && col < it.c1)
            m[e >> 1] = fmaxf(m[e >> 1], epi(row, col, acc[j][e], rv[e >> 1], ev[j][e]));
        }
      if (amax != nullptr) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const int row = rw + gq + hh * 8;
          if (q == 0 && row < S) atomicMax(amax + row, __float_as_uint(v));
        }
      }
    }
  }
}

// The item's per-column constants into cc [nv][ct * 8]: value v of local
// column n is f(v, global column) (zero past c1)
template <class F>
__device__ __forceinline__ void stage_item_consts(float* cc, const Item& it, int ncols, int nv, F f) {
  for (int i = threadIdx.x; i < nv * ncols; i += MMA_NT) {
    const int v = i / ncols, n = i - v * ncols, col = it.c0 + n;
    cc[i] = col < it.c1 ? f(v, col) : 0.f;
  }
}

// q[row][c] = rint(v[row][c] * rcp(s_row)) over rows [r0, r1) and columns
// [c0, c1) (multiples of 4), s_row from the amax slots; `writer` also
// stores the row scales (one block per row does).
__device__ __forceinline__ void quant_region(const float* v, int ldv, int8_t* q, int ldq,
                                             const unsigned* amax, float* scl, bool writer, int r0,
                                             int r1, int c0, int c1) {
  const int w4 = (c1 - c0) >> 2;
  for (int i = threadIdx.x; i < (r1 - r0) * w4; i += MMA_NT) {
    const int r = i / w4, row = r0 + r, c = c0 + (i - r * w4) * 4;
    const float s = amax_scale(__ldcg(amax + row));
    const float4 x = __ldcg(reinterpret_cast<const float4*>(v + (size_t)row * ldv + c));
    *reinterpret_cast<char4*>(q + (size_t)row * ldq + c) = quant4(x, __frcp_rn(s));
    if (writer && c == c0) scl[row] = s;
  }
}

// _rowq8 of whole rows by warps across the grid: row r < n of src (row
// stride ld) into dst (row stride ldq) and its scale into scl, through
// map(r) -> (src row, dst row, scale index)
template <class Map>
__device__ __forceinline__ void quant_rows(int n, Map map) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = blockIdx.x * (MMA_NT / 32) + warp; r < n; r += gridDim.x * (MMA_NT / 32)) {
    const float* src;
    int8_t* dst;
    float* sc;
    int len;
    map(r, src, dst, sc, len);
    const float s = warp_rowq8(src, len, dst, lane);
    if (lane == 0) *sc = s;
  }
}

// dst[i] = src[i] for i < n, across the grid
__device__ __forceinline__ void grid_copy(float* dst, const float* __restrict__ src, size_t n) {
  for (size_t i = (size_t)blockIdx.x * MMA_NT + threadIdx.x; i < n; i += (size_t)gridDim.x * MMA_NT)
    dst[i] = src[i];
}

__device__ __forceinline__ void grid_zero(unsigned* dst, int n) {
  for (int i = blockIdx.x * MMA_NT + threadIdx.x; i < n; i += gridDim.x * MMA_NT) dst[i] = 0u;
}

// Bytes of the gate phase's shared memory: the [4 UB][2 dp + 16] weight
// slice, the [8][16][4 UB + 8] f32 exchange and the [3][4 UB] f32 column
// constants; a column item's slice is ct * 8 rows of Kp + 16 bytes and nv
// f32 constants a column; the A ring is MMA_RING.
__host__ __device__ constexpr size_t gate_smem(int ub, int dp) {
  return (size_t)4 * ub * (2 * dp + 16) + (size_t)8 * 16 * (4 * ub + 8) * 4
         + (size_t)3 * 4 * ub * 4;
}

__host__ __device__ constexpr size_t item_smem(int ct, int kp, int nv) {
  return (size_t)ct * 8 * (kp + 16 + 4 * nv);
}

// The global nanosecond timer (the same clock on every SM)
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Phase stamps: where `stamps` is not null, each block records the time at
// which all its threads reached stamp k, at stamps[block * nstamp + k]
// (tools/profile_lstm_mma.py reads them); null costs one branch a stamp.
struct Stamps {
  unsigned long long* at;
  int n;
  __device__ __forceinline__ void operator()(int k) const {
    if (at == nullptr) return;
    __syncthreads();
    if (threadIdx.x == 0) at[(size_t)blockIdx.x * n + k] = global_ns();
  }
};

// One cooperative launch of `kern` (argument struct `args`) on nb blocks:
// minus the bytes where the shared memory exceeds this device's limit, else
// the CUDA error of the launch (cudaErrorCooperativeLaunchTooLarge where
// the grid cannot be co-resident).
template <class K, class A>
static int coop_launch(K kern, const A& args, int nb, size_t smem, void* stream) {
  const int fit = smem_fits(smem);
  if (fit) return fit;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<A*>(&args)};
  return (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(nb), dim3(MMA_NT), params, smem,
                                          (cudaStream_t)stream);
}
