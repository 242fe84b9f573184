// The passes of kernel 3 (csrc/ffn_mma.cu), the int8 residual FFN +
// BasicNorm over R rows, as device functions: a row of the one-warp-a-row
// passes (yq, mq, norm) and an output tile of the two products (ff1, ff2).
// Kernel 3 launches each pass on its own grid; kernel 11 (csrc/lstm_hoist.cu
// `lstm_chunk_hoist_kernel`) walks them as phases of one cooperative launch.
// The numerics are kernel 3's, described in csrc/ffn_mma.cu. Kernel 3's mq
// and product launches call these functions and compile to the machine code
// they had before the functions moved here; its yq and norm launches keep
// their own copies of `ffn_yq_row` and `ffn_norm_row`, because calling
// these compiled them to other code (tools/sass_diff.py).
#pragma once

#include "mma_tile.cuh"  // the 128 x 128 tile loop (fm_load, fm_store, fm_mma)

struct FfnArgs {
  const float *x, *hs;
  const int8_t *ff1, *ff2;
  const float *ff1s, *ff2s, *eps;
  const void *f1b, *f2b;
  float* out;
  int8_t *yq, *mq;  // [rp][dp], [rp][fp]
  float *ys, *mid, *ms;
  unsigned* amax;
  int R, d, F, dp, fp, f1b_bf16, f2b_bf16, dn;
};

// Bytes of a product tile's shared memory: two depth stages and the row
// amax slots of the tile
#define FM_TILE_SMEM (2 * FM_STAGE + FM_BM * 4)

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float amax4(float m, const float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// warp_rowq8's codes of four values
__device__ __forceinline__ char4 q8x4(const float4 v, float inv) {
  return make_char4((signed char)__float2int_rn(__fmul_rn(v.x, inv)),
                    (signed char)__float2int_rn(__fmul_rn(v.y, inv)),
                    (signed char)__float2int_rn(__fmul_rn(v.z, inv)),
                    (signed char)__float2int_rn(__fmul_rn(v.w, inv)));
}

// Pass 0, one warp: _rowq8 of y = x + hseq of `row`; zeroes its mid amax slot
__device__ __forceinline__ void ffn_yq_row(const FfnArgs a, int row, int lane) {
  const float4* x4 = reinterpret_cast<const float4*>(a.x + (size_t)row * a.d);
  const float4* h4 = reinterpret_cast<const float4*>(a.hs + (size_t)row * a.d);
  const int n4 = a.d >> 2;
  float amax = 0.f;
  for (int k = lane; k < n4; k += 32) amax = amax4(amax, add4(x4[k], h4[k]));
  amax = warp_max(amax);
  const float s = __fmul_rn(fmaxf(amax, ROWQ_FLOOR), INV127);
  const float inv = __frcp_rn(s);
  char4* q4 = reinterpret_cast<char4*>(a.yq + (size_t)row * a.dp);
  for (int k = lane; k < (a.dp >> 2); k += 32)
    q4[k] = k < n4 ? q8x4(add4(x4[k], h4[k]), inv) : make_char4(0, 0, 0, 0);
  if (lane == 0) {
    a.ys[row] = s;
    a.amax[row] = 0u;
  }
}

// Pass 2, one warp: _rowq8 of mid's `row` with the row's folded amax
__device__ __forceinline__ void ffn_mq_row(const FfnArgs a, int row, int lane) {
  const float s = __fmul_rn(fmaxf(__uint_as_float(a.amax[row]), ROWQ_FLOOR), INV127);
  const float inv = __frcp_rn(s);
  const float4* m4 = reinterpret_cast<const float4*>(a.mid + (size_t)row * a.F);
  char4* q4 = reinterpret_cast<char4*>(a.mq + (size_t)row * a.fp);
  const int n4 = a.F >> 2;
  for (int k = lane; k < (a.fp >> 2); k += 32)
    q4[k] = k < n4 ? q8x4(m4[k], inv) : make_char4(0, 0, 0, 0);
  if (lane == 0) a.ms[row] = s;
}

// Pass 4, one warp: BasicNorm of out's `row` in place (csrc/ffn_norm.cuh
// basic_norm_rows' order: lane j adds k = j, j + 32, ..., then warp_sum)
__device__ __forceinline__ void ffn_norm_row(const FfnArgs a, int row, int lane) {
  float* y = a.out + (size_t)row * a.d;
  float ss = 0.f;
  for (int k = lane; k < a.d; k += 32) ss = __fadd_rn(ss, __fmul_rn(y[k], y[k]));
  ss = warp_sum(ss);
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)a.dn), a.eps[0]));
  for (int k = lane; k < a.d; k += 32) y[k] = __fmul_rn(y[k], rs);
}

// Passes 1 (FF1) and 3: the 128 x 128 output tile (row tile by, column
// tile bx), its depth through the two stages `smem`; ff1 folds each row's
// |mid| into rmax (FM_BM slots of the block), then into the row's amax slot
template <bool FF1>
__device__ __forceinline__ void ffn_tile(const FfnArgs a, uint8_t (*smem)[FM_STAGE],
                                         unsigned* rmax, int by, int bx) {
  const int8_t* A = FF1 ? a.yq : a.mq;
  const int lda = FF1 ? a.dp : a.fp;
  const int8_t* W = FF1 ? a.ff1 : a.ff2;
  const int K = FF1 ? a.d : a.F, N = FF1 ? a.F : a.d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = by * FM_BM, n0 = bx * FM_BN;
  if (FF1 && tid < FM_BM) rmax[tid] = 0u;  // published by the loop's barriers

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int KT = lda / FM_KT;
  FmStaged st;
  fm_load(st, A, lda, W, K, N, m0, n0, 0);
  fm_store(st, smem[0]);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fm_load(st, A, lda, W, K, N, m0, n0, (kt + 1) * FM_KT);
    fm_mma(acc, smem[kt & 1], wm, wn);
    if (kt + 1 < KT) fm_store(st, smem[(kt + 1) & 1]);
    __syncthreads();
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 64 + mi * 16 + g + h * 8, row = m0 + rl;
      const bool live = row < a.R;
      if (FF1) {
        float mx = 0.f;
        if (live) {
          const float ys = a.ys[row];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + q * 2;
            if (col >= N) continue;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float m = __fadd_rn(
                  __fmul_rn((float)acc[mi][ni][2 * h + e], __fmul_rn(ys, a.ff1s[col + e])),
                  load_vec(a.f1b, col + e, a.f1b_bf16));
              v[e] = __fmul_rn(m, sig_tanh(__fsub_rn(m, 1.f)));
              mx = fmaxf(mx, fabsf(v[e]));
            }
            *reinterpret_cast<float2*>(a.mid + (size_t)row * N + col) = make_float2(v[0], v[1]);
          }
        }
        // the quad of lanes that share the row, then the block's warps
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (q == 0 && live) atomicMax(rmax + rl, __float_as_uint(mx));
      } else if (live) {
        const float ms = a.ms[row];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + q * 2;
          if (col >= N) continue;
          const size_t o = (size_t)row * N + col;
          const float2 xv = *reinterpret_cast<const float2*>(a.x + o);
          const float2 hv = *reinterpret_cast<const float2*>(a.hs + o);
          const float y[2] = {__fadd_rn(xv.x, hv.x), __fadd_rn(xv.y, hv.y)};
          float r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ff = __fadd_rn(
                __fmul_rn((float)acc[mi][ni][2 * h + e], __fmul_rn(ms, a.ff2s[col + e])),
                load_vec(a.f2b, col + e, a.f2b_bf16));
            r[e] = __fadd_rn(y[e], ff);
          }
          *reinterpret_cast<float2*>(a.out + o) = make_float2(r[0], r[1]);
        }
      }
    }
  if (FF1) {
    __syncthreads();
    if (tid < FM_BM && m0 + tid < a.R) atomicMax(a.amax + m0 + tid, rmax[tid]);
  }
}
