// The residual + FFN + BasicNorm row-tile pass shared by the encoder layers:
// y = x + hseq, mid = DoubleSwish(dot(y, ff1) + b1), ff = dot(mid, ff2) + b2,
// out = (y + ff) * rsqrtf(mean((y + ff)^2) + eps), over tiles of RT rows,
// with the [RT, ffn] mid tile in dynamic shared memory (it never reaches
// device memory). Items of work are (column group of 4, group of RG rows);
// the weight loops unroll by 8 so that each thread has several loads in
// flight.
//
// ffn_norm_kernel<RT, RG>: int8 weights with f32 column scales; _rowq8 of y
// and of mid, exact int32 dots dequantized as acc * (s_row * s_col).
// Used by kernel 3 (csrc/lstm_i8.cu, RT = 16, or 8 and 4 where 16 rows do
// not fit) and the three-pass int8 step (csrc/lstm_step.cu, RT = 4); its
// body `ffn_norm_tile` also runs inside
// kernels 11 and 15 (csrc/lstm_i8.cuh, RT = 2: one session tile).
//
// float_ffn_kernel<WT, RT, RG>: f32 or bf16 weights; every dot rounds its
// activation to the weight type and accumulates in f32. Used by the
// two-kernel chunk layer and the three-pass float step that kernels 10 and
// 12 replaced (csrc/lstm_chunk.cu, RT = 16; csrc/lstm_step.cu, RT = 4),
// both kept as chip_smoke.py's yardsticks.
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn, no FMA contraction) in the JAX op order; tanhf and
// rsqrtf are CUDA's (no fast-math).
#pragma once

#include "common.cuh"

#define FFN_NT 256

__device__ __forceinline__ void fma4(float (&a)[4], float v, const float4& w) {
  a[0] = fmaf(v, w.x, a[0]);
  a[1] = fmaf(v, w.y, a[1]);
  a[2] = fmaf(v, w.z, a[2]);
  a[3] = fmaf(v, w.w, a[3]);
}

__device__ __forceinline__ void imad4(int (&a)[4], int v, const char4& w) {
  a[0] += v * w.x;
  a[1] += v * w.y;
  a[2] += v * w.z;
  a[3] += v * w.w;
}

// BasicNorm of the RT rows of y (row stride d) into out, one warp per row.
template <int RT>
__device__ __forceinline__ void basic_norm_rows(const float* y, float* __restrict__ out,
                                                const float* __restrict__ eps, int r0, int R,
                                                int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float e = eps[0];
  for (int r = warp; r < RT; r += FFN_NT / 32) {
    const int row = r0 + r;
    if (row >= R) continue;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) ss = __fadd_rn(ss, __fmul_rn(y[r * d + k], y[r * d + k]));
    ss = warp_sum(ss);
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), e));
    for (int k = lane; k < d; k += 32) out[(size_t)row * d + k] = __fmul_rn(y[r * d + k], rs);
  }
}

template <int RT>
static size_t ffn_i8_smem(int d, int F) {
  return sizeof(float) * (size_t)(RT * d + RT * F + 2 * RT) + (size_t)RT * (d + F);
}

// The int8 FFN + BasicNorm of RT rows whose y = x + hseq is already in
// shared memory (y [RT][d], with mid [RT][F], sc [2][RT], yq [RT][d] and
// mq [RT][F] as scratch); writes rows r0.. of out, those below R. Called by
// every thread of a block of FFN_NT; it synchronizes before it reads y.
// ffn_norm_kernel runs it on row tiles; kernels 11 and 15
// (csrc/lstm_i8.cuh `layer_step_i8`) run it on one timestep's session tile.
template <int RT, int RG>
__device__ __forceinline__ void ffn_norm_tile(
    float* y, float* mid, float* sc, int8_t* yq, int8_t* mq, const int8_t* __restrict__ ff1,
    const float* __restrict__ ff1s, const void* __restrict__ f1b, const int8_t* __restrict__ ff2,
    const float* __restrict__ ff2s, const void* __restrict__ f2b, const float* __restrict__ eps,
    float* __restrict__ out, int r0, int R, int d, int F, int f1b_bf16, int f2b_bf16) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = FFN_NT / 32;
  __syncthreads();
  for (int r = warp; r < RT; r += nwarps) {
    float s = warp_rowq8(y + r * d, d, yq + r * d, lane);
    if (lane == 0) sc[r] = s;
  }
  __syncthreads();

  // ff1 + DoubleSwish
  for (int it = tid; it < (F / 4) * (RT / RG); it += FFN_NT) {
    const int cg = it % (F / 4), rb = (it / (F / 4)) * RG;
    int acc[RG][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    const int8_t* w = ff1 + cg * 4;
#pragma unroll 8
    for (int k = 0; k < d; ++k) {
      const char4 a = *reinterpret_cast<const char4*>(w + (size_t)k * F);
#pragma unroll
      for (int r = 0; r < RG; ++r) imad4(acc[r], yq[(rb + r) * d + k], a);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg * 4 + j;
        float m = __fadd_rn(__fmul_rn((float)acc[r][j], __fmul_rn(sc[rb + r], ff1s[col])),
                            load_vec(f1b, col, f1b_bf16));
        mid[(rb + r) * F + col] = __fmul_rn(m, sig_tanh(__fsub_rn(m, 1.f)));
      }
  }
  __syncthreads();
  for (int r = warp; r < RT; r += nwarps) {
    float s = warp_rowq8(mid + r * F, F, mq + r * F, lane);
    if (lane == 0) sc[RT + r] = s;
  }
  __syncthreads();

  // ff2 + bias + residual (in place: each (row, column) has one owner)
  for (int it = tid; it < (d / 4) * (RT / RG); it += FFN_NT) {
    const int cg = it % (d / 4), rb = (it / (d / 4)) * RG;
    int acc[RG][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    const int8_t* w = ff2 + cg * 4;
#pragma unroll 8
    for (int k = 0; k < F; ++k) {
      const char4 a = *reinterpret_cast<const char4*>(w + (size_t)k * d);
#pragma unroll
      for (int r = 0; r < RG; ++r) imad4(acc[r], mq[(rb + r) * F + k], a);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg * 4 + j;
        const float ff = __fadd_rn(
            __fmul_rn((float)acc[r][j], __fmul_rn(sc[RT + rb + r], ff2s[col])),
            load_vec(f2b, col, f2b_bf16));
        y[(rb + r) * d + col] = __fadd_rn(y[(rb + r) * d + col], ff);
      }
  }
  __syncthreads();
  basic_norm_rows<RT>(y, out, eps, r0, R, d);
}

template <int RT, int RG>
__global__ void __launch_bounds__(FFN_NT) ffn_norm_kernel(
    const float* __restrict__ x, const float* __restrict__ hs, const int8_t* __restrict__ ff1,
    const float* __restrict__ ff1s, const void* __restrict__ f1b, const int8_t* __restrict__ ff2,
    const float* __restrict__ ff2s, const void* __restrict__ f2b, const float* __restrict__ eps,
    float* __restrict__ out, int R, int d, int F, int f1b_bf16, int f2b_bf16) {
  extern __shared__ float4 smem_f4[];
  float* y = reinterpret_cast<float*>(smem_f4);  // [RT][d]
  float* mid = y + RT * d;                       // [RT][F]
  float* sc = mid + RT * F;                      // [2][RT]
  int8_t* yq = reinterpret_cast<int8_t*>(sc + 2 * RT);  // [RT][d]
  int8_t* mq = yq + RT * d;                      // [RT][F]

  const int r0 = blockIdx.x * RT;
  for (int i = threadIdx.x; i < RT * d; i += FFN_NT) {
    int r = i / d, row = r0 + r;
    size_t gi = (size_t)row * d + (i - r * d);
    y[i] = row < R ? __fadd_rn(x[gi], hs[gi]) : 0.f;
  }
  ffn_norm_tile<RT, RG>(y, mid, sc, yq, mq, ff1, ff1s, f1b, ff2, ff2s, f2b, eps, out, r0, R, d, F,
                        f1b_bf16, f2b_bf16);
}

template <int RT>
static size_t ffn_float_smem(int d, int F) {
  return sizeof(float) * (size_t)RT * (2 * d + F);
}

template <typename WT, int RT, int RG>
__global__ void __launch_bounds__(FFN_NT) float_ffn_kernel(
    const float* __restrict__ x, const float* __restrict__ hs, const void* __restrict__ ff1_v,
    const void* __restrict__ f1b, const void* __restrict__ ff2_v, const void* __restrict__ f2b,
    const float* __restrict__ eps, float* __restrict__ out, int R, int d, int F, int f1b_bf16,
    int f2b_bf16) {
  extern __shared__ float4 smem_f4[];
  const WT* __restrict__ ff1 = static_cast<const WT*>(ff1_v);
  const WT* __restrict__ ff2 = static_cast<const WT*>(ff2_v);
  float* y = reinterpret_cast<float*>(smem_f4);  // [RT][d] y, then y + ff
  float* ya = y + RT * d;                        // [RT][d] act(y)
  float* ma = ya + RT * d;                       // [RT][F] act(DoubleSwish(mid))

  const int r0 = blockIdx.x * RT;
  const int tid = threadIdx.x;

  for (int i = tid; i < RT * d; i += FFN_NT) {
    const int r = i / d, row = r0 + r;
    const size_t gi = (size_t)row * d + (i - r * d);
    const float v = row < R ? __fadd_rn(x[gi], hs[gi]) : 0.f;
    y[i] = v;
    ya[i] = Wt<WT>::act(v);
  }
  __syncthreads();

  // ff1 + bias + DoubleSwish
  for (int it = tid; it < (F / 4) * (RT / RG); it += FFN_NT) {
    const int cg = it % (F / 4), rb = (it / (F / 4)) * RG;
    float acc[RG][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    const WT* w = ff1 + cg * 4;
#pragma unroll 8
    for (int k = 0; k < d; ++k) {
      const float4 a = Wt<WT>::ld4(w + (size_t)k * F);
#pragma unroll
      for (int r = 0; r < RG; ++r) fma4(acc[r], ya[(rb + r) * d + k], a);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg * 4 + j;
        const float m = __fadd_rn(acc[r][j], load_vec(f1b, col, f1b_bf16));
        ma[(rb + r) * F + col] = Wt<WT>::act(__fmul_rn(m, sig_tanh(__fsub_rn(m, 1.f))));
      }
  }
  __syncthreads();

  // ff2 + bias + residual (in place: each (row, column) has one owner)
  for (int it = tid; it < (d / 4) * (RT / RG); it += FFN_NT) {
    const int cg = it % (d / 4), rb = (it / (d / 4)) * RG;
    float acc[RG][4];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    const WT* w = ff2 + cg * 4;
#pragma unroll 8
    for (int k = 0; k < F; ++k) {
      const float4 a = Wt<WT>::ld4(w + (size_t)k * d);
#pragma unroll
      for (int r = 0; r < RG; ++r) fma4(acc[r], ma[(rb + r) * F + k], a);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg * 4 + j;
        const float ff = __fadd_rn(acc[r][j], load_vec(f2b, col, f2b_bf16));
        y[(rb + r) * d + col] = __fadd_rn(y[(rb + r) * d + col], ff);
      }
  }
  __syncthreads();
  basic_norm_rows<RT>(y, out, eps, r0, R, d);
}
