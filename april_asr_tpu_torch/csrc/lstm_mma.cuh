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

// ---- Kernel 12's pieces (csrc/lstm_mma_float.cu): float tile items ------
//
// A phase of the float layer is a set of tile items (ops/lstm_mma.py
// `TileSplit`): item b owns rows [rg * nr, +nr) and local columns [cg * nc,
// +nc), cg = b % ncg, rg = b / ncg. `tile_pass` streams the item's A rows
// (f32, from device memory through L2) and B columns (f32 or bf16 weights)
// through a three-stage shared ring in depth chunks of FKC values, zero
// past the depth, the rows and the valid columns. The block's 256 threads
// form ks groups, each taking FKC / ks of every chunk's depth over the
// whole nr x nc tile: at f32 a thread owns 8 rows x 8 columns (true FFMA,
// no tensor cores; rows ty + i nr / 8, columns tx * 4 + {0, nc / 2} + j, so
// that 8 threads' float4 loads of a B row are 128 contiguous bytes), at bf16 a warp owns 16 rows x 8 ntw columns of
// m16n8k16 `mma.sync` tiles, its A fragments the f32 rows rounded to bf16
// (RNE, as jnp's astype) as they are read. The groups' partial tiles are
// summed in group order in shared memory.
//
// Widths are multiples of 4. A row of f32 (activations, f32 weights) is
// then 16-byte aligned and its 16-byte pieces never straddle a width; a
// row of bf16 weights at a width that is not a multiple of 8 is only
// 8-byte aligned, so there (`half8`) each 16-byte piece of B is copied as
// two 8-byte halves, each zero past the valid columns.
//
// The float layer kernels 10 (csrc/lstm_chunk_mma.cu) and 12
// (csrc/lstm_mma_float.cu) are built from the phases below: `float_gates`
// (gates and cell over ub-unit items), `float_cols` (a product over column
// items with a per-element epilogue) and `float_norm` (BasicNorm of whole
// rows).

#define FKC 64                  // depth values of a chunk
#define FLDA (FKC + 8)          // f32 stride of a staged A row
#define F_STAGES 3

struct TileSplit {
  int nr, nc, ncg, items, ks, ntw;
};

// Bytes of one ring stage (A [nr][FLDA] f32, B [FKC][nc + 8] weights) and
// of the partial tiles [ks][nr][nc] f32 (ops/lstm_mma.py `TileSplit`)
__host__ __device__ inline size_t tile_stage(const TileSplit& s, int wb) {
  return (size_t)s.nr * FLDA * 4 + (size_t)FKC * (s.nc + 8) * wb;
}

__host__ __device__ inline size_t tile_part(const TileSplit& s) {
  return (size_t)s.ks * s.nr * s.nc * 4;
}

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void mma_cp8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

// mma_bf16_16816 on the first four values of an accumulator row
__device__ __forceinline__ void mma_bf16_acc(float (&d)[8], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  float t[4] = {d[0], d[1], d[2], d[3]};
  mma_bf16_16816(t, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = t[i];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float2 v) {
  __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&b);
}

// The item's product into part[0 : nr * nc] (f32, [nr][nc]), through the
// ring's stages of stage_bytes: the depth
// runs over A0 . B0 (K0 values) then, where A1 is not null, A1 . B1 (K1).
// A0 and A1 are f32 rows of stride K0 and K1 (rows at or past rend read as
// zero); B0 and B1 weight rows of stride N, local column n taking global
// column col_of(n) (-1: zero; each run of 16 bytes of local columns maps to
// one of global columns; with half8, each run of 8 bytes). Every thread of
// the block calls it; on return the ring is free and part[0..] holds the
// tile for every thread.
template <class W, class ColOf>
__device__ __forceinline__ void tile_pass(const TileSplit& sp, float* part, uint8_t* ring,
                                          size_t stage_bytes, int r0, int rend, const float* A0,
                                          const W* B0, int K0, const float* A1, const W* B1,
                                          int K1, int N, ColOf col_of, bool half8) {
  constexpr int EP = 16 / (int)sizeof(W);  // weights in 16 bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int nr = sp.nr, nc = sp.nc, ldb = nc + 8, kg = FKC / sp.ks;
  const int n0 = (K0 + FKC - 1) / FKC, nch = n0 + (A1 != nullptr ? (K1 + FKC - 1) / FKC : 0);
  const int lpw = __ffs(nc / EP) - 1;  // log2 of the 16-byte pieces of a B row (nc: 2^n)
  auto load = [&](int c) {
    if (c < nch) {
      const bool p1 = c >= n0;
      const int K = p1 ? K1 : K0, kb = (p1 ? c - n0 : c) * FKC;
      const float* A = p1 ? A1 : A0;
      const W* B = p1 ? B1 : B0;
      float* sa = reinterpret_cast<float*>(ring + (c % F_STAGES) * stage_bytes);
      W* sb = reinterpret_cast<W*>(sa + nr * FLDA);
      for (int i = tid; i < nr * (FKC / 4); i += MMA_NT) {
        const int r = i / (FKC / 4), k = (i - r * (FKC / 4)) * 4, row = r0 + r;
        float* dst = sa + r * FLDA + k;
        if (row < rend && kb + k < K) mma_cp16(dst, A + (size_t)row * K + kb + k);
        else zero16(dst);
      }
      for (int i = tid; i < FKC << lpw; i += MMA_NT) {
        const int k = i >> lpw, n = (i & ((1 << lpw) - 1)) * EP;
        W* dst = sb + k * ldb + n;
        if constexpr (sizeof(W) == 2) {
          if (half8) {  // rows 8-byte aligned: two copies of 4 columns
#pragma unroll
            for (int e = 0; e < EP; e += 4) {
              const int gc = kb + k < K ? col_of(n + e) : -1;
              if (gc >= 0) mma_cp8(dst + e, B + (size_t)(kb + k) * N + gc);
              else *reinterpret_cast<float2*>(dst + e) = make_float2(0.f, 0.f);
            }
            continue;
          }
        }
        const int gc = col_of(n);
        if (gc >= 0 && kb + k < K) mma_cp16(dst, B + (size_t)(kb + k) * N + gc);
        else zero16(dst);
      }
    }
    mma_cp_commit();
  };
  // this thread's (f32) or warp's (bf16) place: depth group grp, and its
  // rows and columns of the tile
  int grp, ty = 0, tx = 0, mt = 0, nb0 = 0;
  if constexpr (sizeof(W) == 4) {
    const int tpg = (nr / 8) * (nc / 8), t = tid % tpg;
    grp = tid / tpg;
    tx = t % (nc / 8);
    ty = t / (nc / 8);
  } else {
    const int wpg = 8 / sp.ks, w = warp % wpg;
    grp = warp / wpg;
    mt = w % (nr / 16);
    nb0 = (w / (nr / 16)) * 8 * sp.ntw;
  }
  float acc[8][8];  // f32: [row i][column]; bf16: [n-tile j][fragment 0..3]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < F_STAGES - 1; ++c) load(c);
  for (int c = 0; c < nch; ++c) {
    mma_cp_wait<F_STAGES - 2>();  // chunk c has landed
    __syncthreads();              // ... for every thread; stage (c - 1) % F_STAGES is free
    load(c + F_STAGES - 1);
    const float* sa = reinterpret_cast<const float*>(ring + (c % F_STAGES) * stage_bytes);
    const W* sb = reinterpret_cast<const W*>(sa + nr * FLDA);
    const int k0 = grp * kg;
    if constexpr (sizeof(W) == 4) {
      const int rs = nr / 8, half = nc / 2;
#pragma unroll 2
      for (int kk = k0; kk < k0 + kg; kk += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(sa + (ty + i * rs) * FLDA + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bj = sb + (kk + j) * ldb + tx * 4;
          const float4 b0 = *reinterpret_cast<const float4*>(bj);
          const float4 b1 = *reinterpret_cast<const float4*>(bj + half);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ak = j == 0 ? av[i].x : j == 1 ? av[i].y : j == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[i][n] = fmaf(ak, bv[n], acc[i][n]);
          }
        }
      }
    } else {
      for (int ks = k0; ks < k0 + kg; ks += 16) {
        const float* ar = sa + (mt * 16 + gq) * FLDA + ks + 2 * q;
        const uint32_t af[4] = {
            pack_bf16x2(*reinterpret_cast<const float2*>(ar)),
            pack_bf16x2(*reinterpret_cast<const float2*>(ar + 8 * FLDA)),
            pack_bf16x2(*reinterpret_cast<const float2*>(ar + 8)),
            pack_bf16x2(*reinterpret_cast<const float2*>(ar + 8 * FLDA + 8))};
        // ldmatrix.trans matrices: k 0-7 | 8-15 of columns +0, then of +8
        const W* br = sb + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + nb0 + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          if (j < sp.ntw) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, br + j * 8);
            mma_bf16_acc(acc[j], af, bf[0], bf[1]);
            mma_bf16_acc(acc[j + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
  }
  __syncthreads();  // the ring is free for the caller's next pass
  float* pg = part + (size_t)grp * nr * nc;
  if constexpr (sizeof(W) == 4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* o = pg + (ty + i * (nr / 8)) * nc + tx * 4;
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + nc / 2) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < sp.ntw) {
        float* o = pg + (mt * 16 + gq) * nc + nb0 + j * 8 + 2 * q;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * nc) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
  __syncthreads();
  if (sp.ks > 1) {
    const int n = nr * nc;
    for (int i = tid; i < n; i += MMA_NT) {
      float s = part[i];
      for (int g = 1; g < sp.ks; ++g) s = __fadd_rn(s, part[(size_t)g * n + i]);
      part[i] = s;
    }
    __syncthreads();
  }
}

// Bytes of a ring stage (the largest phase's) and of the whole shared
// memory: the three-stage ring, then the largest partial tiles
// (ops/lstm_mma.py `float_smem`)
__host__ __device__ inline size_t float_stage(const TileSplit (&s)[4], int wb) {
  size_t m = 0;
  for (const TileSplit& t : s) m = tile_stage(t, wb) > m ? tile_stage(t, wb) : m;
  return m;
}

static inline size_t float_smem(const TileSplit (&s)[4], int wb) {
  size_t p = 0;
  for (const TileSplit& t : s) p = tile_part(t) > p ? tile_part(t) : p;
  return F_STAGES * float_stage(s, wb) + p;
}

// A block's share of the float phases: the ring (stages of `stage` bytes),
// the partial tiles after it, and whether B rows take 8-byte copies
struct FloatRing {
  uint8_t* ring;
  size_t stage;
  float* part;
  bool half8;
};

template <class W>
__device__ __forceinline__ FloatRing float_ring(void* smem, const TileSplit (&s)[4], bool half8) {
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);
  const size_t stage = float_stage(s, (int)sizeof(W));
  return FloatRing{ring, stage, reinterpret_cast<float*>(ring + F_STAGES * stage), half8};
}

// Gates and cell over the gate items of g (item b owns hidden units [u0,
// u0 + ub) with their four gate columns, local column gi * ub + u, for rows
// [r0, min(r0 + nr, R))): gates = dot(x, w_ih) + dot(h, w_hh) (one depth
// run), + b; c' = sig(f) c + sig(i) tanh(g), hc = sig(o) tanh(c') into hc
// [R][H]; cstore(row, k, c, c') stores the carried cell (k = row * H + U).
template <class W, class CStore>
__device__ __forceinline__ void float_gates(const TileSplit& g, int ub, const FloatRing& fr,
                                            const float* x, const W* wih, const float* h,
                                            const W* whh, const void* bias, int bias_bf16,
                                            const float* c, float* hc, int R, int d, int H,
                                            CStore cstore) {
  const int lub = __ffs(ub) - 1;  // ub: 2^n
  for (int b = blockIdx.x; b < g.items; b += gridDim.x) {
    const int u0 = (b % g.ncg) * ub, r0 = (b / g.ncg) * g.nr, rend = min(r0 + g.nr, R);
    tile_pass<W>(g, fr.part, fr.ring, fr.stage, r0, rend, x, wih, d, h, whh, d, 4 * H,
                 [&](int n) {
                   const int gi = n >> lub, U = u0 + (n & (ub - 1));
                   return U < H ? gi * H + U : -1;
                 }, fr.half8);
    for (int i = threadIdx.x; i < (rend - r0) * ub; i += MMA_NT) {
      const int rl = i / ub, u = i - rl * ub, row = r0 + rl, U = u0 + u;
      if (U >= H) continue;
      const float* gr = fr.part + rl * g.nc + u;
      float gt[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        gt[gi] = __fadd_rn(gr[gi * ub], load_vec(bias, gi * H + U, bias_bf16));
      const size_t k = (size_t)row * H + U;
      const float cold = __ldcg(c + k);
      const float cn = __fadd_rn(__fmul_rn(sig_tanh(gt[1]), cold),
                                 __fmul_rn(sig_tanh(gt[0]), tanhf(gt[2])));
      hc[k] = __fmul_rn(sig_tanh(gt[3]), tanhf(cn));
      cstore(row, k, cold, cn);
    }
  }
}

// An N-column product of depth K over R rows of A, over the column items of
// sp (item b owns columns [c0, c0 + nc) and rows [r0, min(r0 + nr, R))):
// epi(row, col, v) for every row and column < N of the item, v the sum.
template <class W, class Epi>
__device__ __forceinline__ void float_cols(const TileSplit& sp, const FloatRing& fr,
                                           const float* A, const W* B, int K, int N, int R,
                                           Epi epi) {
  for (int b = blockIdx.x; b < sp.items; b += gridDim.x) {
    const int c0 = (b % sp.ncg) * sp.nc, r0 = (b / sp.ncg) * sp.nr;
    const int rend = min(r0 + sp.nr, R), nc = sp.nc;
    tile_pass<W>(sp, fr.part, fr.ring, fr.stage, r0, rend, A, B, K, nullptr, (const W*)nullptr, 0,
                 N, [&](int n) { return c0 + n < N ? c0 + n : -1; }, fr.half8);
    for (int i = threadIdx.x; i < (rend - r0) * nc; i += MMA_NT) {
      const int rl = i / nc, col = c0 + i - rl * nc;
      if (col >= N) continue;
      epi(r0 + rl, col, fr.part[i]);
    }
  }
}

// DoubleSwish of an ff1 sum plus its bias: m * sig(m - 1)
__device__ __forceinline__ float ff1_dswish(float v, const void* f1b, int col, int f1b_bf16) {
  const float m = __fadd_rn(v, load_vec(f1b, col, f1b_bf16));
  return __fmul_rn(m, sig_tanh(__fsub_rn(m, 1.f)));
}

// BasicNorm of rows [0, R) of yf into y (which may be yf: each lane reads
// its values before it writes them), one warp a row across the grid, in
// basic_norm_rows' order (csrc/ffn_norm.cuh)
__device__ __forceinline__ void float_norm(const float* yf, float* y, float e, int R, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * (MMA_NT / 32) + warp; row < R; row += gridDim.x * (MMA_NT / 32)) {
    const float* yr = yf + (size_t)row * d;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = __ldcg(yr + k);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = warp_sum(ss);
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), e));
    for (int k = lane; k < d; k += 32) y[(size_t)row * d + k] = __fmul_rn(__ldcg(yr + k), rs);
  }
}
