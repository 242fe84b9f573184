// The two-kernel float chunk layer that kernel 10 (csrc/lstm_chunk_mma.cu)
// replaced, kept as chip_smoke.py's yardstick; no serving path launches it
// (ops/lstm_float_kernels.py `lstm_layer_chunk_simt`).
//
// It computes april_asr_tpu/ops/lstm_pallas.py `lstm_layer_chunk_fused`
// (`_chunk_kernel`): one residual LSTMP layer with its DoubleSwish FFN and
// BasicNorm over P steps. The TPU kernel runs the whole layer per step with
// the weights resident in VMEM. Here the layer is split as csrc/lstm_i8.cu
// splits the int8 one; no step's FFN feeds the recurrence, so the split
// changes no value. One C call, `lstm_chunk`, launches both halves:
//
// lstm_chunk_rec: one block owns TS sessions for all P steps (the time loop
// runs inside the block) with h, c and the step's operands in shared memory.
// Per step: gates = dot(x_t, w_ih) + dot(h, w_hh) + b (the x-side gates are
// computed here, two separate f32 sums then the bias, the TPU kernel's op
// order), the f32 cell with the tanh-form sigmoid, then h_new = dot(hc, w_hr).
// It writes hseq[t] = h_new and keeps h/c where t >= n_pulls[s] (prefix
// gate); masked steps still write a finite hseq row.
//
// float_ffn_kernel<WT, 16, 8> (csrc/ffn_norm.cuh, shared with lstm_step.cu):
// over tiles of RT = 16 of the flattened P*S rows, y = x + hseq,
// mid = DoubleSwish(dot(y, ff1) + b1), ff = dot(mid, ff2) + b2, BasicNorm
// (y + ff) * rsqrtf(mean((y + ff)^2) + eps). The [16, ffn] mid tile lives
// in dynamic shared memory and never reaches device memory.
//
// Products: every dot rounds its activation to the weight type first and
// accumulates in f32, as jnp.dot(x.astype(wd), w, preferred_element_type=
// f32). With f32 weights these are true f32 FMAs on the CUDA cores (no TF32,
// no tensor cores): the JAX function on the CPU computes f32 products, and
// the tests hold the port to it. With bf16 weights the activation is rounded
// half to even to bf16 and each product is exact in f32.
//
// Bound on the H100: per step every block re-reads the layer's recurrent
// weights (w_ih, w_hh, w_hr: 18.9 MB at f32, 9.4 MB at bf16, flagship dims)
// from L2, and each FFN tile re-reads ff1/ff2 (8.4 / 4.2 MB). Design:
// TS = 4 sessions per block share every weight read (S = 256 runs 64
// blocks); each thread owns 4 consecutive hidden units, so one 16-byte
// (f32) or 8-byte (bf16) load feeds 4 x TS FMAs and the cell needs no
// exchange between threads. Measured at S = 256, P = 27 on the H100, the
// layer takes the same time with f32 and with bf16 weights, at ~10% of the
// f32 FMA rate: neither the L2 bytes nor the FMAs bind this first version.
// The likeliest limit, not yet measured, is the latency of the weight
// stream, with 8 warps on each of only 64 SMs to hide it (PERF.md).
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn, no FMA contraction) in the JAX op order; tanhf and
// rsqrtf are CUDA's (no fast-math).

#include "ffn_norm.cuh"

#define TS 4        // sessions per block (lstm_chunk_rec)
#define RT 16       // rows per block (float_ffn_kernel)
#define RG 8        // rows per thread item (float_ffn_kernel)
#define NTHREADS 256

template <typename WT>
__global__ void __launch_bounds__(NTHREADS) lstm_chunk_rec(
    const float* __restrict__ x, const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ npulls, const void* __restrict__ wih_v,
    const void* __restrict__ whh_v, const void* __restrict__ bias,
    const void* __restrict__ whr_v, float* __restrict__ hseq, float* __restrict__ h2,
    float* __restrict__ c2, int P, int S, int d, int H, int bias_bf16) {
  extern __shared__ float4 smem_f4[];
  const WT* __restrict__ wih = static_cast<const WT*>(wih_v);
  const WT* __restrict__ whh = static_cast<const WT*>(whh_v);
  const WT* __restrict__ whr = static_cast<const WT*>(whr_v);
  float* hsh = reinterpret_cast<float*>(smem_f4);  // [TS][d] carried h
  float* csh = hsh + TS * d;                      // [TS][H] carried c
  float* xa = csh + TS * H;                       // [TS][d] act(x_t)
  float* ha = xa + TS * d;                        // [TS][d] act(h)
  float* hca = ha + TS * d;                       // [TS][H] act(hc)

  const int s0 = blockIdx.x * TS;
  const int tid = threadIdx.x;
  const int G = 4 * H;
  int np[TS];
#pragma unroll
  for (int r = 0; r < TS; ++r) np[r] = (s0 + r < S) ? npulls[s0 + r] : 0;

  for (int i = tid; i < TS * d; i += NTHREADS) {
    const int r = i / d, s = s0 + r;
    hsh[i] = s < S ? h0[(size_t)s * d + (i - r * d)] : 0.f;
  }
  for (int i = tid; i < TS * H; i += NTHREADS) {
    const int r = i / H, s = s0 + r;
    csh[i] = s < S ? c0[(size_t)s * H + (i - r * H)] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < P; ++t) {
    for (int i = tid; i < TS * d; i += NTHREADS) {
      const int r = i / d, s = s0 + r;
      xa[i] = Wt<WT>::act(s < S ? x[((size_t)t * S + s) * d + (i - r * d)] : 0.f);
      ha[i] = Wt<WT>::act(hsh[i]);
    }
    __syncthreads();

    // gates and cell: each thread owns 4 consecutive hidden units
    for (int ug = tid; ug < H / 4; ug += NTHREADS) {
      const int u0 = ug * 4;
      float gate[4][TS][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float ax[TS][4], ah[TS][4];
#pragma unroll
        for (int r = 0; r < TS; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) ax[r][j] = ah[r][j] = 0.f;
        const WT* wx = wih + g * H + u0;
        const WT* wh = whh + g * H + u0;
        for (int k = 0; k < d; ++k) {
          const float4 a = Wt<WT>::ld4(wx + (size_t)k * G);
          const float4 b = Wt<WT>::ld4(wh + (size_t)k * G);
#pragma unroll
          for (int r = 0; r < TS; ++r) {
            fma4(ax[r], xa[r * d + k], a);
            fma4(ah[r], ha[r * d + k], b);
          }
        }
#pragma unroll
        for (int r = 0; r < TS; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            gate[g][r][j] = __fadd_rn(__fadd_rn(ax[r][j], ah[r][j]),
                                      load_vec(bias, g * H + u0 + j, bias_bf16));
      }
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = r * H + u0 + j;
          const float cn = __fadd_rn(__fmul_rn(sig_tanh(gate[1][r][j]), csh[u]),
                                     __fmul_rn(sig_tanh(gate[0][r][j]), tanhf(gate[2][r][j])));
          hca[u] = Wt<WT>::act(__fmul_rn(sig_tanh(gate[3][r][j]), tanhf(cn)));
          if (t < np[r]) csh[u] = cn;
        }
    }
    __syncthreads();

    // projection: each thread owns 4 consecutive output columns
    for (int cg = tid; cg < d / 4; cg += NTHREADS) {
      float acc[TS][4];
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
      const WT* w = whr + cg * 4;
      for (int k = 0; k < H; ++k) {
        const float4 a = Wt<WT>::ld4(w + (size_t)k * d);
#pragma unroll
        for (int r = 0; r < TS; ++r) fma4(acc[r], hca[r * H + k], a);
      }
#pragma unroll
      for (int r = 0; r < TS; ++r) {
        const int s = s0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg * 4 + j;
          if (s < S) hseq[((size_t)t * S + s) * d + col] = acc[r][j];
          if (t < np[r]) hsh[r * d + col] = acc[r][j];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < TS * d; i += NTHREADS) {
    const int r = i / d, s = s0 + r;
    if (s < S) h2[(size_t)s * d + (i - r * d)] = hsh[i];
  }
  for (int i = tid; i < TS * H; i += NTHREADS) {
    const int r = i / H, s = s0 + r;
    if (s < S) c2[(size_t)s * H + (i - r * H)] = csh[i];
  }
}

// One whole layer over P steps: the recurrence, then the FFN rows. hseq is
// the wrapper's [P, S, d] scratch; y [P, S, d], h2 [S, d], c2 [S, H] are
// the outputs. w_bf16 selects the weight type (1: bf16, 0: f32).
extern "C" int lstm_chunk(const float* x, const float* h, const float* c, const int* npulls,
                          const void* wih, const void* whh, const void* bias, const void* whr,
                          const void* ff1, const void* f1b, const void* ff2, const void* f2b,
                          const float* eps, float* hseq, float* h2, float* c2, float* y, int P,
                          int S, int d, int H, int F, int w_bf16, int bias_bf16, int f1b_bf16,
                          int f2b_bf16, void* stream) {
  const auto rec = w_bf16 ? lstm_chunk_rec<uint16_t> : lstm_chunk_rec<float>;
  const auto ffn = w_bf16 ? float_ffn_kernel<uint16_t, RT, RG> : float_ffn_kernel<float, RT, RG>;
  const size_t rec_smem = sizeof(float) * (size_t)TS * (3 * d + 2 * H);
  cudaError_t err = allow_smem(rec, rec_smem);
  if (err != cudaSuccess) return (int)err;
  rec<<<(S + TS - 1) / TS, NTHREADS, rec_smem, (cudaStream_t)stream>>>(
      x, h, c, npulls, wih, whh, bias, whr, hseq, h2, c2, P, S, d, H, bias_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = P * S;
  const size_t ffn_smem = ffn_float_smem<RT>(d, F);
  err = allow_smem(ffn, ffn_smem);
  if (err != cudaSuccess) return (int)err;
  ffn<<<(R + RT - 1) / RT, FFN_NT, ffn_smem, (cudaStream_t)stream>>>(
      x, hseq, ff1, f1b, ff2, f2b, eps, y, R, d, F, f1b_bf16, f2b_bf16);
  return (int)cudaGetLastError();
}
