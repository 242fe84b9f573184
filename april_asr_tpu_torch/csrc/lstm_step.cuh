// The gate pass of the one-step LSTM layer, shared by kernel 12 and the
// three-pass int8 step (csrc/lstm_step.cu) and the tensor-parallel kernels 18 and 19
// (csrc/lstm_tp.cu, where a gate-shuffled shard is a standard layer of
// hidden width H/m): the activation forms (`FloatOps`: rounded to the weight
// type; `I8Ops`: _rowq8, int8 in shared memory) and `step_gates`, which
// writes hc and the blended c2 for a block of 64 hidden units x 32 sessions
// (see csrc/lstm_step.cu for the design and its bound).
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn, no FMA contraction) in the JAX op order; tanhf is
// CUDA's (no fast-math).
#pragma once

#include "ffn_norm.cuh"

#define ST_NT 256
#define UG 16    // column groups of 4 per block: 64 columns
#define SL 16    // session lanes per block
#define APAD 16  // row padding of the activation tiles (shared-memory banks)
#define NSG 2    // sessions per thread in the gate pass (32 per block)
#define KC 32    // weight rows per chunk staged in shared memory

// 4 consecutive weights as raw bits (16, 8 or 4 bytes): the staging unit
template <typename T>
struct Raw4;
template <>
struct Raw4<float> { using T4 = float4; };
template <>
struct Raw4<uint16_t> { using T4 = uint2; };
template <>
struct Raw4<int8_t> { using T4 = char4; };

// Activations of a float layer: rounded to the weight type, kept as f32.
template <typename WT>
struct FloatOps {
  using W = WT;
  using A = float;
  using Acc = float;
  static __device__ __forceinline__ float4 w4(const WT* p) { return Wt<WT>::ld4(p); }
  static __device__ __forceinline__ void mac(float (&a)[4], float v, const float4& w) { fma4(a, v, w); }
  // one row of n values by one warp (src null: a zero row); returns its scale
  static __device__ __forceinline__ float row(const float* src, int n, float* dst, int lane) {
    for (int k = lane; k < n; k += 32) dst[k] = src ? Wt<WT>::act(src[k]) : 0.f;
    return 1.f;
  }
  static __device__ __forceinline__ float deq(float acc, float, const float*, int) { return acc; }
};

// Activations of an int8 layer: _rowq8 per row, int8 in shared memory.
struct I8Ops {
  using W = int8_t;
  using A = int8_t;
  using Acc = int;
  static __device__ __forceinline__ char4 w4(const int8_t* p) {
    return *reinterpret_cast<const char4*>(p);
  }
  static __device__ __forceinline__ void mac(int (&a)[4], int v, const char4& w) { imad4(a, v, w); }
  static __device__ __forceinline__ float row(const float* src, int n, int8_t* dst, int lane) {
    if (src) return warp_rowq8(src, n, dst, lane);
    for (int k = lane; k < n; k += 32) dst[k] = 0;
    return 1.f;
  }
  static __device__ __forceinline__ float deq(int acc, float rs, const float* cs, int col) {
    return __fmul_rn((float)acc, __fmul_rn(rs, cs[col]));
  }
};

__device__ __forceinline__ float blend(float g, float nw, float old) {
  return __fadd_rn(__fmul_rn(g, nw), __fmul_rn(__fsub_rn(1.f, g), old));
}

template <class Ops>
__global__ void __launch_bounds__(ST_NT) step_gates(
    const float* __restrict__ x, const float* __restrict__ h, const float* __restrict__ c,
    const float* __restrict__ gate, const typename Ops::W* __restrict__ wih,
    const float* __restrict__ wihs, const typename Ops::W* __restrict__ whh,
    const float* __restrict__ whhs, const void* __restrict__ bias, float* __restrict__ hc_out,
    float* __restrict__ c2, int S, int d, int H, int bias_bf16) {
  using A = typename Ops::A;
  using Acc = typename Ops::Acc;
  using W = typename Ops::W;
  using R4 = typename Raw4<W>::T4;
  constexpr int TSG = SL * NSG;
  constexpr int UB = 4 * UG;  // hidden units per block
  extern __shared__ float4 smem_f4[];
  const int lda = d + APAD;
  float* sc = reinterpret_cast<float*>(smem_f4);  // [2][TSG] row scales of x, h
  A* xa = reinterpret_cast<A*>(sc + 2 * TSG);     // [TSG][lda]
  A* ha = xa + TSG * lda;                         // [TSG][lda]
  W* ws = reinterpret_cast<W*>(ha + TSG * lda);   // [2][KC][4][UB] staged w_ih, w_hh rows

  const int s0 = blockIdx.y * TSG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < 2 * TSG; r += ST_NT / 32) {
    const int rr = r % TSG, s = s0 + rr;
    const float* src = s < S ? (r < TSG ? x : h) + (size_t)s * d : nullptr;
    const float scale = Ops::row(src, d, (r < TSG ? xa : ha) + rr * lda, lane);
    if (lane == 0) sc[r] = scale;
  }

  const int ug = tid % UG, sl = tid / UG;
  const int ub0 = blockIdx.x * UB, u0 = ub0 + ug * 4;
  const int G = 4 * H;
  Acc ax[4][NSG][4], ah[4][NSG][4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < NSG; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) ax[g][j][q] = ah[g][j][q] = 0;
  for (int k0 = 0; k0 < d; k0 += KC) {
    __syncthreads();  // the activation rows are in; the last chunk is consumed
    for (int i = tid; i < 2 * KC * 4 * UG; i += ST_NT) {
      const int grp = i % UG, g = (i / UG) % 4, kk = (i / (4 * UG)) % KC, m = i / (4 * UG * KC);
      const int k = k0 + kk, u = ub0 + grp * 4;
      R4 v = {};
      if (k < d && u < H) v = *reinterpret_cast<const R4*>((m ? whh : wih) + (size_t)k * G + g * H + u);
      *reinterpret_cast<R4*>(ws + ((m * KC + kk) * 4 + g) * UB + grp * 4) = v;
    }
    __syncthreads();
    if (u0 >= H) continue;
    const int kn = min(KC, d - k0);
    for (int kk = 0; kk < kn; ++kk) {
      A xv[NSG], hv[NSG];
#pragma unroll
      for (int j = 0; j < NSG; ++j) {
        xv[j] = xa[(sl + j * SL) * lda + k0 + kk];
        hv[j] = ha[(sl + j * SL) * lda + k0 + kk];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const auto a = Ops::w4(ws + (kk * 4 + g) * UB + ug * 4);
        const auto b = Ops::w4(ws + ((KC + kk) * 4 + g) * UB + ug * 4);
#pragma unroll
        for (int j = 0; j < NSG; ++j) {
          Ops::mac(ax[g][j], xv[j], a);
          Ops::mac(ah[g][j], hv[j], b);
        }
      }
    }
  }
  if (u0 >= H) return;
#pragma unroll
  for (int j = 0; j < NSG; ++j) {
    const int s = s0 + sl + j * SL;
    if (s >= S) continue;
    float gt[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = g * H + u0 + q, r = sl + j * SL;
        gt[g][q] = __fadd_rn(__fadd_rn(Ops::deq(ax[g][j][q], sc[r], wihs, col),
                                       Ops::deq(ah[g][j][q], sc[TSG + r], whhs, col)),
                             load_vec(bias, col, bias_bf16));
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t u = (size_t)s * H + u0 + q;
      const float cold = c[u];
      const float cn = __fadd_rn(__fmul_rn(sig_tanh(gt[1][q]), cold),
                                 __fmul_rn(sig_tanh(gt[0][q]), tanhf(gt[2][q])));
      hc_out[u] = __fmul_rn(sig_tanh(gt[3][q]), tanhf(cn));
      c2[u] = gate ? blend(gate[s], cn, cold) : cn;
    }
  }
}

// Launches step_gates over S sessions and H hidden units: hc (ungated) and
// c2 (blended by `gate` where it is not null).
template <class Ops>
static cudaError_t launch_gates(const float* x, const float* h, const float* c, const float* gate,
                                const typename Ops::W* wih, const float* wihs,
                                const typename Ops::W* whh, const float* whhs, const void* bias,
                                float* hc, float* c2, int S, int d, int H, int bias_bf16,
                                cudaStream_t stream) {
  const size_t a = sizeof(typename Ops::A), w = sizeof(typename Ops::W);
  const size_t g_smem = sizeof(float) * 2 * SL * NSG + a * 2 * SL * NSG * (size_t)(d + APAD)
                        + w * 2 * KC * 4 * 4 * UG;
  cudaError_t err = allow_smem(step_gates<Ops>, g_smem);
  if (err != cudaSuccess) return err;
  dim3 gg((H / 4 + UG - 1) / UG, (S + SL * NSG - 1) / (SL * NSG));
  step_gates<Ops><<<gg, ST_NT, g_smem, stream>>>(x, h, c, gate, wih, wihs, whh, whhs, bias, hc, c2,
                                                  S, d, H, bias_bf16);
  return cudaGetLastError();
}
