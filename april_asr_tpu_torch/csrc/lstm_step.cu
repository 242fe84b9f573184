// The three-pass layer steps that kernels 7 and 12 replaced: one timestep
// of a whole residual LSTMP encoder layer.
//
// lstm_step_float computes april_asr_tpu/ops/lstm_pallas.py
// `lstm_layer_fused` (`_layer_kernel`, f32 or bf16 weights) and
// lstm_step_i8_simt `lstm_layer_fused_i8` (`_layer_kernel_i8`, int8
// weights with f32 column scales), both on the CUDA cores. Kernel 12 is now
// csrc/lstm_mma_float.cu's persistent kernel and kernel 7 csrc/lstm_mma.cu's
// tensor-core kernel; these entries stay as chip_smoke.py's yardsticks
// (lstm_step_i8_simt the oracle kernel 7 equals bit for bit; lstm_step_float
// the time and the outputs kernel 12 is shown beside). lstm_step_i8_simt
// also serves kernel 7's calls at widths where kernel 7 has no plan
// (ops/lstm_mma.py `step_route`); no serving path launches lstm_step_float.
// Both compute, for S sessions,
//
//   gates = dot(x, w_ih) + dot(h, w_hh) + b      (two sums, then the bias)
//   c'    = sig(f) * c + sig(i) * tanh(g)
//   hc    = sig(o) * tanh(c');  h' = dot(hc, w_hr)
//   y     = BasicNorm(x + h' + ff2(DoubleSwish(ff1(x + h'))))
//   with a gate column: h2 = gt * h' + (1 - gt) * h, c2 likewise
//
// where each int8 dot quantizes its activation row with _rowq8 and is exact
// in int32, dequantized as acc * (s_row * s_col), and each float dot rounds
// its activation to the weight type and accumulates in f32 (true f32 FMAs
// for f32 weights: no TF32, no tensor cores).
//
// The layer's columns are spread over blocks, in three launches of one C
// call (one count):
//
//   step_gates (csrc/lstm_step.cuh, shared with kernels 18 and 19 of
//     csrc/lstm_tp.cu): a block owns 64 hidden units (the i, f, g and o columns of
//     each, so the cell and hc stay in registers) for 32 sessions, with the
//     sessions' x and h rows (rounded, or quantized) in shared memory and
//     the block's slice of w_ih and w_hh staged through shared memory 32
//     rows at a time. Each thread owns 4 consecutive units for 2 sessions.
//     Writes hc and c2.
//   step_proj: a block owns 64 output columns for 16 sessions, with their
//     hc rows (rounded, or quantized: each block takes the row's _rowq8 over
//     the whole hidden width) in shared memory and w_hr staged the same
//     way. Writes h' and h2.
//   the FFN + BasicNorm row-tile pass of csrc/ffn_norm.cuh (shared with
//     kernels 3 and 10) over tiles of 4 rows: y = x + h', the FFN, the norm.
//
// Each session tile re-reads its weight slice from L2 (8 tiles in the gate
// pass, 16 in the projection, 64 in the FFN at S = 256), each weight feeds
// few multiply-adds, and bf16 weights never reach the tensor cores: on the
// H100 this step ran 18x (f32) and 97x (bf16) above its bound, the fault the
// persistent kernels remove.
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn, no FMA contraction) in the JAX op order; tanhf and
// rsqrtf are CUDA's (no fast-math).

#include "lstm_step.cuh"

#define FRT 4    // rows per block of the FFN pass
#define FRG 2    // rows per thread item of the FFN pass

template <class Ops>
__global__ void __launch_bounds__(ST_NT) step_proj(
    const float* __restrict__ hc, const float* __restrict__ h, const float* __restrict__ gate,
    const typename Ops::W* __restrict__ whr, const float* __restrict__ whrs,
    float* __restrict__ hn, float* __restrict__ h2, int S, int d, int H) {
  using A = typename Ops::A;
  using Acc = typename Ops::Acc;
  using W = typename Ops::W;
  using R4 = typename Raw4<W>::T4;
  constexpr int CB = 4 * UG;  // output columns per block
  extern __shared__ float4 smem_f4[];
  const int ldh = H + APAD;
  float* sc = reinterpret_cast<float*>(smem_f4);  // [SL] row scales of hc
  A* hca = reinterpret_cast<A*>(sc + SL);         // [SL][ldh]
  W* ws = reinterpret_cast<W*>(hca + SL * ldh);   // [KC][CB] staged w_hr rows

  const int s0 = blockIdx.y * SL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < SL; r += ST_NT / 32) {
    const int s = s0 + r;
    const float scale = Ops::row(s < S ? hc + (size_t)s * H : nullptr, H, hca + r * ldh, lane);
    if (lane == 0) sc[r] = scale;
  }

  const int cg = tid % UG, sl = tid / UG;
  const int cb0 = blockIdx.x * CB, col0 = cb0 + cg * 4;
  const int s = s0 + sl;
  const bool live = col0 < d && s < S;
  Acc acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < H; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < KC * UG; i += ST_NT) {
      const int grp = i % UG, kk = i / UG, k = k0 + kk, cc = cb0 + grp * 4;
      R4 v = {};
      if (k < H && cc < d) v = *reinterpret_cast<const R4*>(whr + (size_t)k * d + cc);
      *reinterpret_cast<R4*>(ws + kk * CB + grp * 4) = v;
    }
    __syncthreads();
    if (!live) continue;
    const int kn = min(KC, H - k0);
    for (int kk = 0; kk < kn; ++kk)
      Ops::mac(acc, hca[sl * ldh + k0 + kk], Ops::w4(ws + kk * CB + cg * 4));
  }
  if (!live) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t i = (size_t)s * d + col0 + q;
    const float v = Ops::deq(acc[q], sc[sl], whrs, col0 + q);
    hn[i] = v;
    h2[i] = gate ? blend(gate[s], v, h[i]) : v;
  }
}

// The gate and projection passes; hc [S, H] and hn [S, d] are the wrapper's
// scratch (hn is h' before the gate, the FFN pass's residual input).
template <class Ops>
static cudaError_t gates_proj(const float* x, const float* h, const float* c, const float* gate,
                              const typename Ops::W* wih, const float* wihs,
                              const typename Ops::W* whh, const float* whhs, const void* bias,
                              const typename Ops::W* whr, const float* whrs, float* hc, float* hn,
                              float* h2, float* c2, int S, int d, int H, int bias_bf16,
                              cudaStream_t stream) {
  const size_t a = sizeof(typename Ops::A), w = sizeof(typename Ops::W);
  cudaError_t err = launch_gates<Ops>(x, h, c, gate, wih, wihs, whh, whhs, bias, hc, c2, S, d, H,
                                      bias_bf16, stream);
  if (err != cudaSuccess) return err;
  const size_t p_smem = sizeof(float) * SL + a * SL * (size_t)(H + APAD) + w * KC * 4 * UG;
  err = allow_smem(step_proj<Ops>, p_smem);
  if (err != cudaSuccess) return err;
  dim3 pg((d / 4 + UG - 1) / UG, (S + SL - 1) / SL);
  step_proj<Ops><<<pg, ST_NT, p_smem, stream>>>(hc, h, gate, whr, whrs, hn, h2, S, d, H);
  return cudaGetLastError();
}

// gate: [S] f32 or null (ungated). Outputs y, h2 [S, d] and c2 [S, H]. dn:
// the width of the BasicNorm's mean (d, or d_model where d is padded).
extern "C" int lstm_step_i8_simt(const float* x, const float* h, const float* c,
                                 const float* gate, const int8_t* wih, const float* wihs,
                                 const int8_t* whh, const float* whhs, const void* bias,
                                 const int8_t* whr, const float* whrs, const int8_t* ff1,
                                 const float* ff1s, const void* f1b, const int8_t* ff2,
                                 const float* ff2s, const void* f2b, const float* eps, float* hc,
                                 float* hn, float* y, float* h2, float* c2, int S, int d, int H,
                                 int F, int bias_bf16, int f1b_bf16, int f2b_bf16, int dn,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = gates_proj<I8Ops>(x, h, c, gate, wih, wihs, whh, whhs, bias, whr, whrs, hc, hn,
                                      h2, c2, S, d, H, bias_bf16, st);
  if (err != cudaSuccess) return (int)err;
  const auto ffn = ffn_norm_kernel<FRT, FRG>;
  const size_t smem = ffn_i8_smem<FRT>(d, F);
  err = allow_smem(ffn, smem);
  if (err != cudaSuccess) return (int)err;
  ffn<<<(S + FRT - 1) / FRT, FFN_NT, smem, st>>>(x, hn, ff1, ff1s, f1b, ff2, ff2s, f2b, eps, y, S,
                                                 d, F, f1b_bf16, f2b_bf16, dn);
  return (int)cudaGetLastError();
}

// w_bf16 selects the weight type (1: bf16, 0: f32).
extern "C" int lstm_step_float(const float* x, const float* h, const float* c, const float* gate,
                               const void* wih, const void* whh, const void* bias, const void* whr,
                               const void* ff1, const void* f1b, const void* ff2, const void* f2b,
                               const float* eps, float* hc, float* hn, float* y, float* h2,
                               float* c2, int S, int d, int H, int F, int w_bf16, int bias_bf16,
                               int f1b_bf16, int f2b_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (w_bf16) {
    using W = uint16_t;
    err = gates_proj<FloatOps<W>>(x, h, c, gate, (const W*)wih, nullptr, (const W*)whh, nullptr,
                                  bias, (const W*)whr, nullptr, hc, hn, h2, c2, S, d, H, bias_bf16,
                                  st);
  } else {
    using W = float;
    err = gates_proj<FloatOps<W>>(x, h, c, gate, (const W*)wih, nullptr, (const W*)whh, nullptr,
                                  bias, (const W*)whr, nullptr, hc, hn, h2, c2, S, d, H, bias_bf16,
                                  st);
  }
  if (err != cudaSuccess) return (int)err;
  const auto ffn = w_bf16 ? float_ffn_kernel<uint16_t, FRT, FRG> : float_ffn_kernel<float, FRT, FRG>;
  const size_t smem = ffn_float_smem<FRT>(d, F);
  err = allow_smem(ffn, smem);
  if (err != cudaSuccess) return (int)err;
  ffn<<<(S + FRT - 1) / FRT, FFN_NT, smem, st>>>(x, hn, ff1, f1b, ff2, f2b, eps, y, S, d, F,
                                                 f1b_bf16, f2b_bf16);
  return (int)cudaGetLastError();
}
