// Kernels 14, 13 and 22 redesigned for the H100: the int8 recurrent core of
// the chunk layer as a hoisted x-side gate product plus one persistent
// recurrence launch; and kernel 11, the whole int8 chunk layer, as the same
// launches with kernel 3's FFN + BasicNorm as phases of the persistent one.
//
// Replaces april_asr_tpu/ops/lstm_pallas.py `lstm_layer_chunk_rec_stream_i8`
// (`_rec_stream_kernel_i8`, 14) and `lstm_layer_chunk_rec_i8`
// (`_rec_kernel_i8`, 13): one layer over P steps -- _rowq8(x_t) and
// _rowq8(h), the int8 gate dots against w_ih/w_hh, the f32 cell with the
// tanh-form sigmoid, _rowq8(hc), the int8 projection; hseq[t] written
// ungated, h and c kept where t >= n_pulls. The two TPU kernels differ only
// in how x reaches the core (streamed by step, or the whole chunk staged);
// this design consumes x whole before the time loop, so both take it. The
// CUDA-core templates they had here stay in csrc/lstm_i8.cu as
// `lstm_rec_stream_i8_simt` and `lstm_rec_i8_simt`, for shapes this plan
// has no launch for (ops/lstm_mma.py `rec_hoist_plan`).
//
// What bounds it on the H100. A layer's gate and projection products are
// 2 P S (2 d 4H + H d) int8 operations (d 1024, H 4096, S = 256, P = 27: 522
// G, 0.26 ms at 1,979 TOP/s); its weights stay in the 50 MB L2. The
// templates re-read all three weight matrices from L2 every step for every
// 4-session tile and multiplied them on IMAD loops (212 ms a layer at those
// widths on an H100, PERF.md). Kernel 11 adds the FFN's 4 P S d F
// operations (29 G at the flagship, d 512 / F 2048, S = 256, P = 27: 15 us);
// its template re-read every weight from L2 every step for every 2-session
// tile (12.7 ms a layer at the flagship on an H100).
// Kernel 2 (csrc/lstm_mma.cu) keeps w_ih, w_hh and w_hr stationary in shared
// memory, which past the flagship widths no split holds. Here:
//
//   * Phase A, the x-side gate product over all P * S rows at once: gx =
//     dot(_rowq8(x), w_ih) * (xs * s_ih) depends on x alone, so it leaves
//     the time loop. Two ordinary launches: `hoist_xq_kernel` quantizes
//     every row (one warp a row, warp_rowq8) into int8 scratch; then
//     `hoist_gx_kernel` runs kernel 3's 128 x 128 `mma.sync` s8 tiles
//     (csrc/mma_tile.cuh) over [P S, d] x [d, 4H] with exact int32 sums and
//     writes gx f32 [P][S][4H] (113 MB at flagship S = 256; 453 MB at d
//     1024 / H 4096). w_ih crosses from L2 once per 128-row band, not once
//     per step and tile. (Kernel 23's `wgmma` s8 form would need a K-major
//     copy of w_ih made at load; this simple form is kernel 3's, which
//     already computes such products bit for bit.)
//   * Phase B, the recurrence: one cooperative launch of at most one block
//     per SM over the P steps, on kernel 2's phase structure and pieces
//     (csrc/lstm_mma.cuh): h0 quantized across the grid | per step: the
//     gate items' h-dot on `mma.sync` s8 against their w_hh columns,
//     stationary in shared memory, + gx_t read from the scratch, + the
//     bias, and the cell in registers (the items are 8, 16 or 32 units
//     whose four gates sit in whole 8-column mma tiles, so each lane holds
//     all four gates of its units), hc's row amax folded by atomicMax |
//     hcq | the projection items against their stationary w_hr columns,
//     hseq[t], the carried h (amax of h) | hq |. Only w_hh and w_hr are
//     read in the loop (20 MB at the wide widths, where kernel 2's three
//     matrices are 37.7 MB); a 32-unit item's w_hh slice at d 1024 is 133
//     KB, so the wide model fits one block an SM.
//
// Kernel 22 (tools/profile_chunk_split.py `rec_interleave_i8`) computes
// kernel 13's function with time as the slow axis, which this launch is, so
// it takes the same entry (its per-timestep template stays in
// csrc/lstm_i8.cu, `rec_interleave_i8`).
//
// Kernel 11 (april_asr_tpu/ops/lstm_pallas.py `lstm_layer_chunk_fused_i8`,
// `_chunk_kernel_i8`) is kernel 14's function followed by kernel 3's over
// the P * S rows: no step's FFN feeds the recurrence, and y comes from the
// ungated h_new, which is hseq. Its entry `lstm_chunk_hoist_i8` runs phase
// A, then one cooperative launch: phase B with hseq into a scratch, a grid
// barrier, the block's shared memory re-carved for two 128 x 128 tile
// stages, then kernel 3's five passes (csrc/ffn_mma.cuh: yq | ff1 with
// DoubleSwish and the row amax folded by atomicMax | mq | ff2 + the
// residual | the norm) as phases separated by grid barriers, each walking
// its rows or tiles over the launch's blocks. The TPU kernel runs each
// step's FFN inside the time loop; at S = 256 that would leave ff1 32
// tiles for 132 SMs, so here it runs after the loop over all P * S rows.
// The template it replaced stays as csrc/lstm_chunk_i8.cu
// (`lstm_chunk_i8_simt`), for shapes this plan has no launch for.
//
// Numerics: the integer dots are exact in any order; gx = fl(float(xdot) *
// fl(xs * s_ih)), gh likewise, each gate fl(fl(gx + gh) + b), the cell and
// the projection in the templates' op order (csrc/lstm_i8.cuh
// `rec_gates_cell`, `rec_proj`), so the outputs equal theirs, and kernel
// 2's, bit for bit; kernel 11's FFN phases are kernel 3's passes, bit for
// bit csrc/ffn_norm.cuh `ffn_norm_tile`, so it equals its template;
// chip_smoke.py holds them to that.

#include "ffn_mma.cuh"  // kernel 3's passes (kernel 11); mma_tile.cuh's tile loop
#include "lstm_mma.cuh"

#define HX_ROWS (FM_NT / 32)  // rows of the x quantization a block, one warp a row

// ---- Phase A: the x-side gate product ------------------------------------

struct HoistA {
  const float* x;  // [R][d]
  const int8_t* wih;
  const float* wihs;
  int8_t* xq;  // [rp][dp], zero past d
  float* xs;   // [rp]
  float* gx;   // [R][N]
  int R, d, N, dp;
};

// _rowq8 of every x row, one warp a row
__global__ void __launch_bounds__(FM_NT) hoist_xq_kernel(const HoistA a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * HX_ROWS + (threadIdx.x >> 5);
  if (row >= a.R) return;
  int8_t* q = a.xq + (size_t)row * a.dp;
  const float s = warp_rowq8(a.x + (size_t)row * a.d, a.d, q, lane);
  for (int k = a.d + lane; k < a.dp; k += 32) q[k] = 0;
  if (lane == 0) a.xs[row] = s;
}

// One 128 x 128 tile of gx a block, (column tile, row tile) = (blockIdx.x,
// blockIdx.y): gx = fl(float(acc) * fl(xs * s_ih))
__global__ void __launch_bounds__(FM_NT) hoist_gx_kernel(const HoistA a) {
  __shared__ __align__(16) uint8_t smem[2][FM_STAGE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * FM_BM, n0 = blockIdx.x * FM_BN;
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int KT = a.dp / FM_KT;
  FmStaged st;
  fm_load(st, a.xq, a.dp, a.wih, a.d, a.N, m0, n0, 0);
  fm_store(st, smem[0]);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fm_load(st, a.xq, a.dp, a.wih, a.d, a.N, m0, n0, (kt + 1) * FM_KT);
    fm_mma(acc, smem[kt & 1], wm, wn);
    if (kt + 1 < KT) fm_store(st, smem[(kt + 1) & 1]);
    __syncthreads();
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      if (row >= a.R) continue;
      const float xs = a.xs[row];
      float* out = a.gx + (size_t)row * a.N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + q * 2;
        if (col >= a.N) continue;  // N is a multiple of 4: col + 1 < N too
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = __fmul_rn((float)acc[mi][ni][2 * h + e], __fmul_rn(xs, a.wihs[col + e]));
        *reinterpret_cast<float2*>(out + col) = make_float2(v[0], v[1]);
      }
    }
}

// ---- Phase B: the recurrence ---------------------------------------------

struct HoistArgs {
  const float *h0, *c0, *gx;  // gx [P][S][4H]
  const int* np;
  const int8_t *whh, *whr;
  const float *whhs, *whrs;
  const void* bias;
  float *hseq, *h2, *c2;
  int8_t *hq, *hcq;  // [Sp][dp], [Sp][hp]
  float *hcf, *scl;  // [S][H]; [2][Sp]: h, hc row scales
  unsigned* amax;    // [4][Sp]: hc (two slots), h (two slots)
  int P, S, d, H, bias_bf16, Sp, dp, hp;
  GateSplit gs;
  ColSplit pj;
  Stamps stamp;  // 3 + 8 P a block, as kernel 2's
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The gates and cell of gate item (units u0.., rows [r0, r1)) at step t:
// gates = fl(fl(gx_t + dot(hq, w_hh) * (hs * s_hh)) + b), c' = sig(f) c +
// sig(i) tanh(g), hc = sig(o) tanh(c'). Local column n = gi * UB + u is gate
// gi of unit u0 + u, so mma tile j holds gate j / TPG of units (j % TPG) * 8
// + 2 (lane % 4) + {0, 1} for rows lane / 4 and + 8: each lane has all four
// gates of its units and runs their cells in registers. Writes hc, c' where
// t < n_pulls, and folds |hc| into the row amax slots am_hc. gcs [2][NC]:
// the w_hh column scales and the bias.
template <int NTG>
__device__ __forceinline__ void hoist_gates(const HoistArgs& a, const float* gxt, const uint8_t* Bh,
                                            int ldh, const float* gcs, uint8_t* stage, int u0,
                                            int r0, int r1, int t, unsigned* am_hc) {
  static_assert(NTG % 4 == 0, "each gate in whole 8-column tiles");
  constexpr int NC = 8 * NTG, TPG = NTG / 4;
  const int S = a.S, H = a.H, G = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const float* hs = a.scl;
  const float2 zero = make_float2(0.f, 0.f);
  for (int row0 = r0; row0 < r1; row0 += MMA_ROWS) {
    {  // the pass's gx rows toward L2 while it multiplies: 32-byte sectors of 8 units
      const int rend = min(min(row0 + MMA_ROWS, r1), S), per_row = 4 * TPG;
      for (int i = threadIdx.x; i < (rend - row0) * per_row; i += MMA_NT) {
        const int r = i / per_row, rem = i - r * per_row, gi = rem / TPG;
        const int U = u0 + (rem - gi * TPG) * 8;
        if (U < H) prefetch_l2(gxt + (size_t)(row0 + r) * G + gi * H + U);
      }
    }
    const int rw = row0 + warp * 16;
    const bool wl = rw < r1;
    float hsr[2];
    bool live[2];
    float2 cold[2][TPG];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rw + gq + hh * 8;
      const bool ok = wl && row < S;
      hsr[hh] = ok ? __ldcg(hs + row) : 0.f;
      live[hh] = ok && t < __ldg(a.np + row);
#pragma unroll
      for (int jj = 0; jj < TPG; ++jj) {
        const int U = u0 + jj * 8 + 2 * q;
        cold[hh][jj] = ok && U < H
                           ? __ldcg(reinterpret_cast<const float2*>(a.c2 + (size_t)row * H + U))
                           : zero;
      }
    }
    int ah[NTG][4];
    mma_pass<NTG, false>(ah, ah, a.hq, a.dp, nullptr, 0, row0, r1, Bh, ldh, NTG, stage);
    if (!wl) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rw + gq + hh * 8;
      float m = 0.f;
      if (row < S) {
        const float* gr = gxt + (size_t)row * G;
#pragma unroll
        for (int jj = 0; jj < TPG; ++jj) {
          const int U = u0 + jj * 8 + 2 * q;  // even, and H is a multiple of 4: U + 1 < H too
          if (U >= H) continue;
          float2 gv[4];
#pragma unroll
          for (int gi = 0; gi < 4; ++gi)
            gv[gi] = __ldcs(reinterpret_cast<const float2*>(gr + gi * H + U));
          float hc[2], cn[2];
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            float v[4];
#pragma unroll
            for (int gi = 0; gi < 4; ++gi) {
              const int j = gi * TPG + jj, lc = j * 8 + 2 * q + o;
              const float gh = __fmul_rn((float)ah[j][2 * hh + o], __fmul_rn(hsr[hh], gcs[lc]));
              v[gi] = __fadd_rn(__fadd_rn(o ? gv[gi].y : gv[gi].x, gh), gcs[NC + lc]);
            }
            const float c = o ? cold[hh][jj].y : cold[hh][jj].x;
            cn[o] = __fadd_rn(__fmul_rn(sig_tanh(v[1]), c), __fmul_rn(sig_tanh(v[0]), tanhf(v[2])));
            hc[o] = __fmul_rn(sig_tanh(v[3]), tanhf(cn[o]));
            m = fmaxf(m, fabsf(hc[o]));
          }
          const size_t k = (size_t)row * H + U;
          __stcg(reinterpret_cast<float2*>(a.hcf + k), make_float2(hc[0], hc[1]));
          if (live[hh]) __stcg(reinterpret_cast<float2*>(a.c2 + k), make_float2(cn[0], cn[1]));
        }
      }
      // the quad of lanes that share the row, one atomic a row and warp
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (q == 0 && row < S) atomicMax(am_hc + row, __float_as_uint(m));
    }
  }
}

// Phase B of one layer over the P steps, on the block's dynamic shared
// memory `smem_f4`: stamps 0 .. 8 P - 1 (the last step ends at its
// projection, stamp 8 P - 1)
template <int NTG>
__device__ __forceinline__ void hoist_recurrence(const HoistArgs& a, float4* smem_f4,
                                                 cg::grid_group& grid) {
  constexpr int UB = 2 * NTG, NC = 8 * NTG;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int S = a.S, d = a.d, H = a.H, Sp = a.Sp, dp = a.dp, hp = a.hp, P = a.P;
  const int ldh = dp + 16, ldp = hp + 16, pc = a.pj.ct * 8;
  uint8_t* Bh = reinterpret_cast<uint8_t*>(smem_f4);  // [NC][ldh]: w_hh columns
  uint8_t* Bp = Bh + NC * ldh;                         // [pc][ldp]: w_hr columns
  uint8_t* stage = Bp + pc * ldp;                      // the A ring
  float* gcs = reinterpret_cast<float*>(stage + MMA_RING);  // [2][NC]: w_hh scales, bias
  float* pcs = gcs + 2 * NC;                                // [pc]: w_hr column scales
  float* hs = a.scl;
  float* hcs = hs + Sp;
  unsigned* am_hc = a.amax;
  unsigned* am_h = a.amax + 2 * Sp;
  int u0 = 0, g0 = 0, g1 = 0;
  const bool gate_blk = gate_item(a.gs, b, UB, Sp, u0, g0, g1);
  Item pi;
  const bool proj_blk = col_item(a.pj, b, d, Sp, pi);
  a.stamp(0);

  if (gate_blk) {
    auto gcol = [&](int n) {
      const int gi = n / UB, U = u0 + n - gi * UB;
      return U < H ? gi * H + U : -1;
    };
    stage_cols(Bh, ldh, 0, a.whh, 4 * H, d, dp, NC, gcol);
    for (int n = tid; n < NC; n += MMA_NT) {
      const int col = gcol(n);
      gcs[n] = col >= 0 ? a.whhs[col] : 0.f;
      gcs[NC + n] = col >= 0 ? load_vec(a.bias, col, a.bias_bf16) : 0.f;
    }
  }
  if (proj_blk) {
    stage_cols(Bp, ldp, 0, a.whr, d, H, hp, pc,
               [&](int n) { return pi.c0 + n < pi.c1 ? pi.c0 + n : -1; });
    stage_item_consts(pcs, pi, pc, 1, [&](int, int col) { return a.whrs[col]; });
  }
  quant_rows(S, [&](int s, const float*& src, int8_t*& dst, float*& sc, int& len) {
    len = d;
    src = a.h0 + (size_t)s * d;
    dst = a.hq + (size_t)s * dp;
    sc = hs + s;
  });
  grid_copy(a.h2, a.h0, (size_t)S * d);
  grid_copy(a.c2, a.c0, (size_t)S * H);
  grid_zero(a.amax, 4 * Sp);
  a.stamp(1);
  grid.sync();
  a.stamp(2);

  for (int t = 0; t < P; ++t) {
    const int k0 = 3 + 8 * t;
    const int sl = t & 1;
    // the other slots were last read before the barrier that ended step t - 1
    // and are next written after the one that ends step t
    if (b == 0)
      for (int i = tid; i < Sp; i += MMA_NT) am_hc[(sl ^ 1) * Sp + i] = am_h[(sl ^ 1) * Sp + i] = 0u;
    if (gate_blk)
      hoist_gates<NTG>(a, a.gx + (size_t)t * S * 4 * H, Bh, ldh, gcs, stage, u0, g0, g1, t,
                       am_hc + sl * Sp);
    a.stamp(k0);
    grid.sync();
    a.stamp(k0 + 1);
    if (gate_blk)
      quant_region(a.hcf, H, a.hcq, hp, am_hc + sl * Sp, hcs, u0 == 0, g0, min(g1, S), u0,
                   min(u0 + UB, H));
    a.stamp(k0 + 2);
    grid.sync();
    a.stamp(k0 + 3);
    const bool last = t + 1 == P;
    if (proj_blk)
      cols_phase<MMA_NTW>(
          pi, a.hcq, hp, Bp, ldp, stage, S, last ? nullptr : am_h + sl * Sp,
          [&](int row) {
            return make_float2(__ldcg(hcs + row), t < __ldg(a.np + row) ? 1.f : 0.f);
          },
          [&](int row, int col) { return make_float2(__ldcg(a.h2 + (size_t)row * d + col), 0.f); },
          [&](int row, int col, int acc, float2 r, float2 e) {
            const float hn = __fmul_rn((float)acc, __fmul_rn(r.x, pcs[col - pi.c0]));
            const size_t k = (size_t)row * d + col;
            a.hseq[(size_t)t * S * d + k] = hn;
            if (r.y != 0.f) {
              a.h2[k] = hn;
              return fabsf(hn);
            }
            return fabsf(e.x);
          });
    a.stamp(k0 + 4);
    if (last) break;
    grid.sync();
    a.stamp(k0 + 5);
    if (proj_blk)
      quant_region(a.h2, d, a.hq, dp, am_h + sl * Sp, hs, pi.c0 == 0, pi.r0, min(pi.r1, S), pi.c0,
                   pi.c1);
    a.stamp(k0 + 6);
    grid.sync();
    a.stamp(k0 + 7);
  }
}

template <int NTG>
__global__ void __launch_bounds__(MMA_NT, 1) lstm_rec_hoist_kernel(const HoistArgs a) {
  extern __shared__ float4 smem_f4[];
  cg::grid_group grid = cg::this_grid();
  hoist_recurrence<NTG>(a, smem_f4, grid);
}

// Bytes of phase B's shared memory (ops/lstm_mma.py `hoist_smem`): the w_hh
// slice [4 ub][dp + 16] and its [2][4 ub] f32 constants, the projection
// item's slice [ct * 8][hp + 16] and its f32 column scales, the A ring.
static size_t hoist_smem(int ub, int dp, int hp, int pj_ct) {
  return (size_t)4 * ub * (dp + 16) + (size_t)2 * 4 * ub * 4 + item_smem(pj_ct, hp, 1) + MMA_RING;
}

// Phase A's two launches on `st`, after checking the widths and the plan's
// paddings; fills `a` with phase B's arguments (stamps of nstamp a block).
// Returns 0, or the first failing launch's CUDA error.
static int hoist_phase_a(HoistArgs& a, const float* x, const float* h, const float* c,
                         const int* npulls, const int8_t* wih, const float* wihs,
                         const int8_t* whh, const float* whhs, const void* bias, const int8_t* whr,
                         const float* whrs, float* hseq, float* h2, float* c2, int8_t* xq,
                         float* gx, int8_t* hq, int8_t* hcq, float* hcf, float* scl,
                         unsigned* amax, unsigned long long* stamps, int nstamp, int P, int S,
                         int d, int H, int bias_bf16, int Sp, int dp, int hp, int rp, int g_rows,
                         int g_ngu, int g_items, int pj_ct, int pj_rows, int pj_ncg, int pj_items,
                         cudaStream_t st) {
  const int R = P * S, N = 4 * H;
  if (P < 1 || S < 1 || d < 4 || H < 4 || d % 4 || H % 4 || dp % FM_KT || hp % FM_KT || dp < d ||
      hp < H || rp % FM_BM || rp < R || Sp % 16 || Sp < S)
    return (int)cudaErrorInvalidValue;
  const HoistA pa{x, wih, wihs, xq, scl, gx, R, d, N, dp};
  hoist_xq_kernel<<<(R + HX_ROWS - 1) / HX_ROWS, FM_NT, 0, st>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hoist_gx_kernel<<<dim3((N + FM_BN - 1) / FM_BN, rp / FM_BM), FM_NT, 0, st>>>(pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a = HoistArgs{h, c, gx, npulls, whh, whr, whhs, whrs, bias, hseq, h2, c2, hq, hcq, hcf,
                scl + rp, amax, P, S, d, H, bias_bf16, Sp, dp, hp,
                GateSplit{g_rows, g_ngu, g_items}, ColSplit{pj_ct, pj_rows, pj_ncg, pj_items},
                Stamps{stamps, nstamp}};
  return 0;
}

// Kernels 14 and 13: phase A (two launches) then phase B (one cooperative
// launch) on the caller's stream. Scratch from the wrapper (ops/lstm_mma.py
// `hoist_scratch`): xq [rp][dp] int8, gx [P][S][4H] f32, hq [Sp][dp] and hcq
// [Sp][hp] int8, hcf [S][H] f32, scl [rp + 2 Sp] f32 (x, h, hc row scales),
// amax [4][Sp]; stamps null, or [nb][3 + 8 P] for phase B's times; the plan
// (`rec_hoist_plan`): rp = P S rounded up to 128, ub (8, 16 or 32 hidden
// units a gate item), nb blocks, the gate split's rows, unit groups and
// items, the projection's ColSplit. Returns minus the shared-memory bytes
// where they do not fit, else the first failing launch's CUDA error.
extern "C" int lstm_rec_hoist_i8(const float* x, const float* h, const float* c,
                                 const int* npulls, const int8_t* wih, const float* wihs,
                                 const int8_t* whh, const float* whhs, const void* bias,
                                 const int8_t* whr, const float* whrs, float* hseq, float* h2,
                                 float* c2, int8_t* xq, float* gx, int8_t* hq, int8_t* hcq,
                                 float* hcf, float* scl, unsigned* amax,
                                 unsigned long long* stamps, int P, int S, int d, int H,
                                 int bias_bf16, int Sp, int dp, int hp, int rp, int ub, int nb,
                                 int g_rows, int g_ngu, int g_items, int pj_ct, int pj_rows,
                                 int pj_ncg, int pj_items, void* stream) {
  const size_t smem = hoist_smem(ub, dp, hp, pj_ct);
  const int fit = smem_fits(smem);
  if (fit) return fit;
  HoistArgs a;
  const int rc = hoist_phase_a(a, x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq, h2,
                               c2, xq, gx, hq, hcq, hcf, scl, amax, stamps, 3 + 8 * P, P, S, d, H,
                               bias_bf16, Sp, dp, hp, rp, g_rows, g_ngu, g_items, pj_ct, pj_rows,
                               pj_ncg, pj_items, (cudaStream_t)stream);
  if (rc) return rc;
  if (ub == 8) return coop_launch(lstm_rec_hoist_kernel<4>, a, nb, smem, stream);
  if (ub == 16) return coop_launch(lstm_rec_hoist_kernel<8>, a, nb, smem, stream);
  if (ub == 32) return coop_launch(lstm_rec_hoist_kernel<16>, a, nb, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// ---- Kernel 11: the whole layer in one cooperative launch ----------------

struct ChunkArgs {
  HoistArgs r;  // phase B; its stamps 3 + 8 P + CH_STAMPS a block
  FfnArgs f;    // kernel 3's passes over the P S rows: x the layer's input, hs phase B's hseq
};

#define CH_STAMPS 10  // of the FFN phases: after the barrier, after the phase, five times

// Phase B over the P steps, then kernel 3's five passes as phases, a grid
// barrier before each: yq (rows by warps across the grid) | ff1 (the 128 x
// 128 tiles, tile i = ry * nx + cx on block i mod nb, as ops/lstm_mma.py
// `FfnPlan.tiles` orders them) | mq | ff2 | norm. Each buffer a phase reads
// was written by other blocks before a grid barrier and is read by no block
// before it, so plain loads see it.
template <int NTG>
__global__ void __launch_bounds__(MMA_NT, 1)
    lstm_chunk_hoist_kernel(const __grid_constant__ ChunkArgs a) {
  extern __shared__ float4 smem_f4[];
  cg::grid_group grid = cg::this_grid();
  hoist_recurrence<NTG>(a.r, smem_f4, grid);
  const FfnArgs& f = a.f;
  const int k0 = 3 + 8 * a.r.P, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * (MMA_NT / 32) + (threadIdx.x >> 5);
  const int rstride = gridDim.x * (MMA_NT / 32);
  const int mt = (f.R + FM_BM - 1) / FM_BM, n1 = (f.F + FM_BN - 1) / FM_BN,
            n2 = (f.d + FM_BN - 1) / FM_BN;
  // the shared memory re-carved: two depth stages and a tile's row amax slots
  uint8_t(*stage)[FM_STAGE] = reinterpret_cast<uint8_t(*)[FM_STAGE]>(smem_f4);
  unsigned* rmax = reinterpret_cast<unsigned*>(stage + 2);
  grid.sync();
  a.r.stamp(k0);
  for (int row = row0; row < f.R; row += rstride) ffn_yq_row(f, row, lane);
  a.r.stamp(k0 + 1);
  grid.sync();
  a.r.stamp(k0 + 2);
  for (int i = blockIdx.x; i < mt * n1; i += gridDim.x)
    ffn_tile<true>(f, stage, rmax, i / n1, i % n1);
  a.r.stamp(k0 + 3);
  grid.sync();
  a.r.stamp(k0 + 4);
  for (int row = row0; row < f.R; row += rstride) ffn_mq_row(f, row, lane);
  a.r.stamp(k0 + 5);
  grid.sync();
  a.r.stamp(k0 + 6);
  for (int i = blockIdx.x; i < mt * n2; i += gridDim.x)
    ffn_tile<false>(f, stage, rmax, i / n2, i % n2);
  a.r.stamp(k0 + 7);
  grid.sync();
  a.r.stamp(k0 + 8);
  for (int row = row0; row < f.R; row += rstride) ffn_norm_row(f, row, lane);
  a.r.stamp(k0 + 9);
}

// Kernel 11: phase A (two launches), then one cooperative launch of phase B
// and the FFN phases, on the caller's stream. Scratch from the wrapper
// (ops/lstm_mma.py `ChunkPlan.scratch`): kernel 14's (as above), hseq [P S][d]
// f32, then kernel 3's (yq [rp][dp] int8, ys [rp] f32, mid [P S][F] f32,
// famax [rp], mq [rp][fp] int8, ms [rp] f32); stamps null, or [nb][3 + 8 P +
// CH_STAMPS]; the plan (`chunk_hoist_plan`): phase B's, fp = F rounded up to
// 64, nb blocks (at least phase B's). The shared memory is the larger of
// phase B's and a product tile's. Returns as kernel 14's entry.
extern "C" int lstm_chunk_hoist_i8(
    const float* x, const float* h, const float* c, const int* npulls, const int8_t* wih,
    const float* wihs, const int8_t* whh, const float* whhs, const void* bias, const int8_t* whr,
    const float* whrs, const int8_t* ff1, const float* ff1s, const void* f1b, const int8_t* ff2,
    const float* ff2s, const void* f2b, const float* eps, float* y, float* h2, float* c2,
    int8_t* xq, float* gx, int8_t* hq, int8_t* hcq, float* hcf, float* scl, unsigned* amax,
    float* hseq, int8_t* yq, float* ys, float* mid, unsigned* famax, int8_t* mq, float* ms,
    unsigned long long* stamps, int P, int S, int d, int H, int F, int bias_bf16, int f1b_bf16,
    int f2b_bf16, int Sp, int dp, int hp, int fp, int rp, int ub, int nb, int g_rows, int g_ngu,
    int g_items, int pj_ct, int pj_rows, int pj_ncg, int pj_items, void* stream) {
  if (F < 4 || F % 4 || fp % FM_KT || fp < F) return (int)cudaErrorInvalidValue;
  const size_t hb = hoist_smem(ub, dp, hp, pj_ct), smem = hb > FM_TILE_SMEM ? hb : FM_TILE_SMEM;
  const int fit = smem_fits(smem);
  if (fit) return fit;
  ChunkArgs a;
  const int rc = hoist_phase_a(a.r, x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq,
                               h2, c2, xq, gx, hq, hcq, hcf, scl, amax, stamps,
                               3 + 8 * P + CH_STAMPS, P, S, d, H, bias_bf16, Sp, dp, hp, rp,
                               g_rows, g_ngu, g_items, pj_ct, pj_rows, pj_ncg, pj_items,
                               (cudaStream_t)stream);
  if (rc) return rc;
  a.f = FfnArgs{x, hseq, ff1, ff2, ff1s, ff2s, eps, f1b, f2b, y, yq, mq, ys, mid, ms, famax,
                P * S, d, F, dp, fp, f1b_bf16, f2b_bf16, d};
  if (ub == 8) return coop_launch(lstm_chunk_hoist_kernel<4>, a, nb, smem, stream);
  if (ub == 16) return coop_launch(lstm_chunk_hoist_kernel<8>, a, nb, smem, stream);
  if (ub == 32) return coop_launch(lstm_chunk_hoist_kernel<16>, a, nb, smem, stream);
  return (int)cudaErrorInvalidValue;
}
