// Kernels 18-21: one model shard's pieces of a tensor-parallel LSTM encoder
// layer step, between which the caller all-reduces the partial sums over
// the model group (ops/lstm_tp_kernels.py, models/lstm_transducer.py
// `_lstm_stack_step_tp`).
//
// Kernels 18 and 19 run as one launch each in csrc/lstm_tp_gates.cu, kernels
// 20 and 21 in csrc/lstm_tp_ffn.cu; their column-pass forms here are kept as
// `tp_gate_cell_proj_simt`, `tp_gates_cell_i8_simt`, `tp_ffn_partial_simt`
// and `tp_ffn_mid_i8_simt`, the yardstick those are held to bit for bit and
// the route where their plans do not hold the shapes (ops/tp_plan.py).
//
// Replace april_asr_tpu/ops/lstm_tp_pallas.py:
//   tp_gate_cell_proj (18) `lstm_gate_cell_proj` (`_gcp_kernel`), f32 or bf16
//     weights: gates = dot(x, w_ih) + dot(h, w_hh) + b over the shard's
//     gate-shuffled [d, 4Hs] slice, the f32 cell, hp = dot(hc, w_hr[Hs, d])
//     (the ungated partial), c2 = gt * c' + (1 - gt) * c.
//   tp_gates_cell_i8 (19) `lstm_gates_cell_i8` (`_gc_kernel_i8`): the same
//     gates and cell on int8 weights with f32 column scales, x and h rows
//     quantized by _rowq8 (exact: they are replicated, so the local row amax
//     is the full one); writes hc (ungated, NOT quantized: its scale is the
//     model-global one, taken after the kernel) and c2.
//   tp_ffn_partial (20) `ffn_partial` (`_ffn_kernel`), f32 or bf16 weights:
//     DoubleSwish(dot(y, ff1[d, Fs]) + b1) then dot(., ff2[Fs, d]): the
//     partial FFN sum, without the second bias, the residual or the norm.
//   tp_ffn_mid_i8 (21) `ffn_mid_i8` (`_ffn_mid_kernel_i8`): _rowq8(y), the
//     int8 ff1 with column scales, + b1, DoubleSwish -> mid [S, Fs].
//
// Every dot rounds its activation to the weight type (float weights) or
// quantizes it per row (int8), exact int32 dequantized as
// acc * (s_row * s_col), and accumulates float products in f32 FMAs on the
// CUDA cores (no TF32, no tensor cores), as kernel 12's f32 path does.
//
// Design. A gate-shuffled shard is a standard layer of hidden width Hs, so
// the gate pass of kernels 18 and 19 is the three-pass step's `step_gates`
// (csrc/lstm_step.cuh) run at Hs: a block owns 64 hidden units' i, f, g, o
// columns for 32 sessions. Everything else is one column pass, `tp_cols`: a
// block owns 64 output columns for 16 sessions, their activation rows
// (rounded, or quantized) in shared memory and the weight rows staged 32 at
// a time, each thread 4 consecutive columns of one session; its epilogue is
// the dequantization, or the bias and DoubleSwish. Kernel 18's projection
// reads the gate pass's hc, and kernel 20's ff2 pass the ff1 pass's mid,
// from device memory between two launches of one C call (one count).
// Columns spread over blocks, so S = 256 at flagship widths (d 512, Hs 512,
// Fs 1024 at m = 2) runs 64 blocks in the gate pass, 128 in a pass of d
// columns and 256 in one of Fs columns.
//
// Bound on the H100 at S = 256, flagship widths and m = 2: the f32 kernels
// by operations (kernel 18: 2·S·(2·d·4Hs + Hs·d) = 1.2 GFLOP of FMAs at 67
// TFLOP/s, 18 µs), the int8 ones by bytes (kernel 19: 2.1 MB of weights
// and 2.6 MB of rows, 1.4 µs). These FMA and IMAD loops on the CUDA cores
// reach neither: a first version, right before fast.
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn, no FMA contraction) in the JAX op order; tanhf is
// CUDA's (no fast-math).

#include "lstm_step.cuh"

enum Epi { EPI_DEQ = 0, EPI_DSWISH = 1 };

// out[s, n] = epi(deq(dot(row(a[s, :K]), w[:K, n]))) for a block of SL
// sessions x 64 columns; EPI_DSWISH adds the bias, then DoubleSwish.
template <class Ops, int EPI>
__global__ void __launch_bounds__(ST_NT) tp_cols(
    const float* __restrict__ a, const typename Ops::W* __restrict__ w,
    const float* __restrict__ ws, const void* __restrict__ bias, float* __restrict__ out, int S,
    int K, int N, int bias_bf16) {
  using A = typename Ops::A;
  using Acc = typename Ops::Acc;
  using W = typename Ops::W;
  using R4 = typename Raw4<W>::T4;
  constexpr int CB = 4 * UG;  // output columns per block
  extern __shared__ float4 smem_f4[];
  const int lda = K + APAD;
  float* sc = reinterpret_cast<float*>(smem_f4);  // [SL] row scales
  A* aa = reinterpret_cast<A*>(sc + SL);          // [SL][lda]
  W* wst = reinterpret_cast<W*>(aa + SL * lda);   // [KC][CB] staged weight rows

  const int s0 = blockIdx.y * SL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < SL; r += ST_NT / 32) {
    const int s = s0 + r;
    const float scale = Ops::row(s < S ? a + (size_t)s * K : nullptr, K, aa + r * lda, lane);
    if (lane == 0) sc[r] = scale;
  }

  const int cg = tid % UG, sl = tid / UG;
  const int cb0 = blockIdx.x * CB, col0 = cb0 + cg * 4;
  const int s = s0 + sl;
  const bool live = col0 < N && s < S;
  Acc acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the activation rows are in; the last chunk is consumed
    for (int i = tid; i < KC * UG; i += ST_NT) {
      const int grp = i % UG, kk = i / UG, k = k0 + kk, cc = cb0 + grp * 4;
      R4 v = {};
      if (k < K && cc < N) v = *reinterpret_cast<const R4*>(w + (size_t)k * N + cc);
      *reinterpret_cast<R4*>(wst + kk * CB + grp * 4) = v;
    }
    __syncthreads();
    if (!live) continue;
    const int kn = min(KC, K - k0);
    for (int kk = 0; kk < kn; ++kk)
      Ops::mac(acc, aa[sl * lda + k0 + kk], Ops::w4(wst + kk * CB + cg * 4));
  }
  if (!live) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = col0 + q;
    float v = Ops::deq(acc[q], sc[sl], ws, col);
    if (EPI == EPI_DSWISH) {
      v = __fadd_rn(v, load_vec(bias, col, bias_bf16));
      v = __fmul_rn(v, sig_tanh(__fsub_rn(v, 1.f)));
    }
    out[(size_t)s * N + col] = v;
  }
}

template <class Ops, int EPI>
static cudaError_t launch_cols(const float* a, const typename Ops::W* w, const float* ws,
                               const void* bias, float* out, int S, int K, int N, int bias_bf16,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * SL + sizeof(typename Ops::A) * SL * (size_t)(K + APAD)
                      + sizeof(typename Ops::W) * KC * 4 * UG;
  cudaError_t err = allow_smem(tp_cols<Ops, EPI>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N / 4 + UG - 1) / UG, (S + SL - 1) / SL);
  tp_cols<Ops, EPI><<<grid, ST_NT, smem, stream>>>(a, w, ws, bias, out, S, K, N, bias_bf16);
  return cudaGetLastError();
}

template <typename WT>
static cudaError_t gate_cell_proj(const float* x, const float* h, const float* c,
                                  const float* gate, const void* wih, const void* whh,
                                  const void* bias, const void* whr, float* hc, float* hp,
                                  float* c2, int S, int d, int Hs, int bias_bf16,
                                  cudaStream_t st) {
  cudaError_t err = launch_gates<FloatOps<WT>>(x, h, c, gate, (const WT*)wih, nullptr,
                                               (const WT*)whh, nullptr, bias, hc, c2, S, d, Hs,
                                               bias_bf16, st);
  if (err != cudaSuccess) return err;
  return launch_cols<FloatOps<WT>, EPI_DEQ>(hc, (const WT*)whr, nullptr, nullptr, hp, S, Hs, d, 0,
                                            st);
}

template <typename WT>
static cudaError_t ffn_partial(const float* y, const void* ff1, const void* f1b, const void* ff2,
                               float* mid, float* out, int S, int d, int Fs, int f1b_bf16,
                               cudaStream_t st) {
  cudaError_t err = launch_cols<FloatOps<WT>, EPI_DSWISH>(y, (const WT*)ff1, nullptr, f1b, mid, S,
                                                          d, Fs, f1b_bf16, st);
  if (err != cudaSuccess) return err;
  return launch_cols<FloatOps<WT>, EPI_DEQ>(mid, (const WT*)ff2, nullptr, nullptr, out, S, Fs, d,
                                            0, st);
}

// Kernel 18's two passes, kept as `tp_gate_cell_proj_simt` beside the one
// launch that replaced them (csrc/lstm_tp_gates.cu). gate: [S] f32 or null
// (ungated). hc [S, Hs] is the wrapper's scratch. Outputs hp [S, d]
// (ungated) and c2 [S, Hs]. w_bf16 selects the weight type (1: bf16, 0: f32).
extern "C" int tp_gate_cell_proj_simt(const float* x, const float* h, const float* c,
                                      const float* gate, const void* wih, const void* whh,
                                      const void* bias, const void* whr, float* hc, float* hp,
                                      float* c2, int S, int d, int Hs, int w_bf16,
                                      int bias_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(w_bf16 ? gate_cell_proj<uint16_t>(x, h, c, gate, wih, whh, bias, whr, hc, hp, c2,
                                                 S, d, Hs, bias_bf16, st)
                      : gate_cell_proj<float>(x, h, c, gate, wih, whh, bias, whr, hc, hp, c2, S,
                                              d, Hs, bias_bf16, st));
}

// Kernel 19's gate pass, kept as `tp_gates_cell_i8_simt` (csrc/lstm_tp_gates.cu
// replaced it). Outputs hc [S, Hs] (ungated) and c2 [S, Hs].
extern "C" int tp_gates_cell_i8_simt(const float* x, const float* h, const float* c,
                                     const float* gate, const int8_t* wih, const float* wihs,
                                     const int8_t* whh, const float* whhs, const void* bias,
                                     float* hc, float* c2, int S, int d, int Hs, int bias_bf16,
                                     void* stream) {
  return (int)launch_gates<I8Ops>(x, h, c, gate, wih, wihs, whh, whhs, bias, hc, c2, S, d, Hs,
                                  bias_bf16, (cudaStream_t)stream);
}

// Kernel 20's two passes, kept as `tp_ffn_partial_simt` (csrc/lstm_tp_ffn.cu
// replaced them). mid [S, Fs] is the wrapper's scratch; out [S, d].
extern "C" int tp_ffn_partial_simt(const float* y, const void* ff1, const void* f1b,
                                   const void* ff2, float* mid, float* out, int S, int d, int Fs,
                                   int w_bf16, int f1b_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(w_bf16 ? ffn_partial<uint16_t>(y, ff1, f1b, ff2, mid, out, S, d, Fs, f1b_bf16, st)
                      : ffn_partial<float>(y, ff1, f1b, ff2, mid, out, S, d, Fs, f1b_bf16, st));
}

// Kernel 21's column pass, kept as `tp_ffn_mid_i8_simt` (csrc/lstm_tp_ffn.cu
// replaced it). Outputs mid [S, Fs].
extern "C" int tp_ffn_mid_i8_simt(const float* y, const int8_t* ff1, const float* ff1s,
                                  const void* f1b, float* mid, int S, int d, int Fs,
                                  int f1b_bf16, void* stream) {
  return (int)launch_cols<I8Ops, EPI_DSWISH>(y, ff1, ff1s, f1b, mid, S, d, Fs, f1b_bf16,
                                             (cudaStream_t)stream);
}
