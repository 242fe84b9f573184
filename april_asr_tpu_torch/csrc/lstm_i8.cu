// Kernels 2 and 3: the int8 split-form LSTM layer of the chunk encoder.
//
// lstm_rec_i8 replaces april_asr_tpu/ops/lstm_pallas.py
// `lstm_layer_chunk_rec_stream2_i8` (`_rec_stream2_kernel_i8`): the
// recurrent core of one layer over P steps. On the TPU the time axis is a
// sequential grid dimension with h/c resident in VMEM; here one block owns a
// tile of TS sessions for all P steps (the time loop runs inside the block)
// with h, c, hc and the int8 activations in shared memory. Each step computes
// _rowq8(x_t) and _rowq8(h) (one warp per row), the int8 gate dots against
// w_ih/w_hh (the x-side gates are computed here too, not by a library GEMM),
// the f32 cell, _rowq8(hc) and the int8 projection; it writes hseq[t] and
// keeps h/c where t >= n_pulls.
//
// Bound on the H100: per step every block re-reads the layer's int8 weights
// (2 x d x 4H + H x d = 4.7 MB at flagship dims), which stay resident in the
// 50 MB L2; the integer multiply-adds (plain IMAD loops over char4 weight
// strips, exact int32) are the issue-rate limit. Design: TS = 2 sessions
// per block so S = 256 fills 128 of the 132 SMs, each thread owns 4
// consecutive hidden units (one coalesced char4 per gate row) so the cell
// needs no exchange between threads.
//
// ffn_norm_i8 replaces `ffn_norm_i8` (`_ffn_norm_kernel_i8`) with
// ffn_norm_kernel<16, 8> (csrc/ffn_norm.cuh, shared with kernel 7): over
// tiles of RT = 16 of the flattened P*S rows, y = x + hseq, _rowq8(y), int8 ff1,
// DoubleSwish, _rowq8(mid), int8 ff2, residual, BasicNorm
// y * rsqrtf(mean(y^2) + eps). The [16, ffn] mid tile (128 KB f32 at
// ffn = 2048) lives in dynamic shared memory and never reaches device
// memory. Bound: the integer multiply-adds; the weights (2 MB) stay in L2.
//
// Numerics: activations quantize as the JAX package does (see common.cuh);
// integer dots are exact; every f32 step is rounded separately
// (__fmul_rn/__fadd_rn, no FMA contraction) in the JAX op order. tanhf and
// rsqrtf are CUDA's (no fast-math): they can differ from XLA's by an ulp,
// which may flip an isolated int8 rounding downstream.

#include "ffn_norm.cuh"

#define TS 2        // sessions per block (lstm_rec_i8)
#define RT 16       // rows per block (ffn_norm_i8)
#define RG 8        // rows per thread item (ffn_norm_i8)
#define NTHREADS 256

__global__ void __launch_bounds__(NTHREADS) lstm_rec_kernel(
    const float* __restrict__ x, const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ npulls, const int8_t* __restrict__ wih,
    const float* __restrict__ wihs, const int8_t* __restrict__ whh,
    const float* __restrict__ whhs, const void* __restrict__ bias,
    const int8_t* __restrict__ whr, const float* __restrict__ whrs,
    float* __restrict__ hseq, float* __restrict__ h2, float* __restrict__ c2,
    int P, int S, int d, int H, int bias_bf16) {
  extern __shared__ float4 smem_f4[];
  float* hsh = reinterpret_cast<float*>(smem_f4);  // [TS][d] carried h
  float* csh = hsh + TS * d;                      // [TS][H] carried c
  float* hcs = csh + TS * H;                      // [TS][H] hc of this step
  float* xt = hcs + TS * H;                       // [TS][d] x_t
  float* sc = xt + TS * d;                        // [3][TS] row scales
  int8_t* xq = reinterpret_cast<int8_t*>(sc + 4 * TS);  // [TS][d]
  int8_t* hq = xq + TS * d;                       // [TS][d]
  int8_t* hcq = hq + TS * d;                      // [TS][H]

  const int s0 = blockIdx.x * TS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = 4 * H;
  int np[TS];
#pragma unroll
  for (int r = 0; r < TS; ++r) np[r] = (s0 + r < S) ? npulls[s0 + r] : 0;

  for (int i = tid; i < TS * d; i += NTHREADS) {
    int r = i / d, s = s0 + r;
    hsh[i] = s < S ? h0[(size_t)s * d + (i - r * d)] : 0.f;
  }
  for (int i = tid; i < TS * H; i += NTHREADS) {
    int r = i / H, s = s0 + r;
    csh[i] = s < S ? c0[(size_t)s * H + (i - r * H)] : 0.f;
  }

  for (int t = 0; t < P; ++t) {
    for (int i = tid; i < TS * d; i += NTHREADS) {
      int r = i / d, s = s0 + r;
      xt[i] = s < S ? x[((size_t)t * S + s) * d + (i - r * d)] : 0.f;
    }
    __syncthreads();
    if (warp < TS) {
      float s = warp_rowq8(xt + warp * d, d, xq + warp * d, lane);
      if (lane == 0) sc[warp] = s;
    } else if (warp < 2 * TS) {
      int r = warp - TS;
      float s = warp_rowq8(hsh + r * d, d, hq + r * d, lane);
      if (lane == 0) sc[TS + r] = s;
    }
    __syncthreads();

    // gates and cell: each thread owns 4 consecutive hidden units
    for (int ug = tid; ug < H / 4; ug += NTHREADS) {
      const int u0 = ug * 4;
      float gate[4][TS][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        int ax[TS][4], ah[TS][4];
#pragma unroll
        for (int r = 0; r < TS; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) ax[r][j] = ah[r][j] = 0;
        const int8_t* wx = wih + g * H + u0;
        const int8_t* wh = whh + g * H + u0;
        for (int k = 0; k < d; ++k) {
          const char4 a = *reinterpret_cast<const char4*>(wx + (size_t)k * G);
          const char4 b = *reinterpret_cast<const char4*>(wh + (size_t)k * G);
#pragma unroll
          for (int r = 0; r < TS; ++r) {
            const int xv = xq[r * d + k], hv = hq[r * d + k];
            ax[r][0] += xv * a.x; ax[r][1] += xv * a.y; ax[r][2] += xv * a.z; ax[r][3] += xv * a.w;
            ah[r][0] += hv * b.x; ah[r][1] += hv * b.y; ah[r][2] += hv * b.z; ah[r][3] += hv * b.w;
          }
        }
#pragma unroll
        for (int r = 0; r < TS; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = g * H + u0 + j;
            const float gx = __fmul_rn((float)ax[r][j], __fmul_rn(sc[r], wihs[col]));
            const float gh = __fmul_rn((float)ah[r][j], __fmul_rn(sc[TS + r], whhs[col]));
            gate[g][r][j] = __fadd_rn(__fadd_rn(gx, gh), load_vec(bias, col, bias_bf16));
          }
      }
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = r * H + u0 + j;
          const float cold = csh[u];
          const float cn = __fadd_rn(__fmul_rn(sig_tanh(gate[1][r][j]), cold),
                                     __fmul_rn(sig_tanh(gate[0][r][j]), tanhf(gate[2][r][j])));
          hcs[u] = __fmul_rn(sig_tanh(gate[3][r][j]), tanhf(cn));
          if (t < np[r]) csh[u] = cn;
        }
    }
    __syncthreads();
    if (warp < TS) {
      float s = warp_rowq8(hcs + warp * H, H, hcq + warp * H, lane);
      if (lane == 0) sc[2 * TS + warp] = s;
    }
    __syncthreads();

    // projection: each thread owns 4 consecutive output columns
    for (int cg = tid; cg < d / 4; cg += NTHREADS) {
      int acc[TS][4];
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0;
      const int8_t* w = whr + cg * 4;
      for (int k = 0; k < H; ++k) {
        const char4 a = *reinterpret_cast<const char4*>(w + (size_t)k * d);
#pragma unroll
        for (int r = 0; r < TS; ++r) {
          const int v = hcq[r * H + k];
          acc[r][0] += v * a.x; acc[r][1] += v * a.y; acc[r][2] += v * a.z; acc[r][3] += v * a.w;
        }
      }
#pragma unroll
      for (int r = 0; r < TS; ++r) {
        const int s = s0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg * 4 + j;
          const float hn = __fmul_rn((float)acc[r][j], __fmul_rn(sc[2 * TS + r], whrs[col]));
          if (s < S) hseq[((size_t)t * S + s) * d + col] = hn;
          if (t < np[r]) hsh[r * d + col] = hn;
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < TS * d; i += NTHREADS) {
    int r = i / d, s = s0 + r;
    if (s < S) h2[(size_t)s * d + (i - r * d)] = hsh[i];
  }
  for (int i = tid; i < TS * H; i += NTHREADS) {
    int r = i / H, s = s0 + r;
    if (s < S) c2[(size_t)s * H + (i - r * H)] = csh[i];
  }
}

static size_t rec_smem(int d, int H) {
  return sizeof(float) * (size_t)(TS * d * 2 + TS * H * 2 + 4 * TS) + (size_t)TS * (2 * d + H);
}

extern "C" int lstm_rec_i8(const float* x, const float* h, const float* c, const int* npulls,
                           const int8_t* wih, const float* wihs, const int8_t* whh,
                           const float* whhs, const void* bias, const int8_t* whr,
                           const float* whrs, float* hseq, float* h2, float* c2, int P, int S,
                           int d, int H, int bias_bf16, void* stream) {
  const size_t smem = rec_smem(d, H);
  cudaError_t err = allow_smem(lstm_rec_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + TS - 1) / TS);
  lstm_rec_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq, h2, c2, P, S, d, H, bias_bf16);
  return (int)cudaGetLastError();
}

extern "C" int ffn_norm_i8(const float* x, const float* hs, const int8_t* ff1, const float* ff1s,
                           const void* f1b, const int8_t* ff2, const float* ff2s, const void* f2b,
                           const float* eps, float* out, int R, int d, int F, int f1b_bf16,
                           int f2b_bf16, void* stream) {
  const auto kern = ffn_norm_kernel<RT, RG>;
  const size_t smem = ffn_i8_smem<RT>(d, F);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + RT - 1) / RT);
  kern<<<grid, FFN_NT, smem, (cudaStream_t)stream>>>(
      x, hs, ff1, ff1s, f1b, ff2, ff2s, f2b, eps, out, R, d, F, f1b_bf16, f2b_bf16);
  return (int)cudaGetLastError();
}
