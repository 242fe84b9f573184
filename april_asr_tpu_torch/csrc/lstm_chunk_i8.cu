// Kernel 11: the int8 whole-layer chunk of the encoder, unsplit.
//
// Replaces april_asr_tpu/ops/lstm_pallas.py `lstm_layer_chunk_fused_i8`
// (`_chunk_kernel_i8`): one residual LSTMP layer over P steps with its int8
// FFN and BasicNorm inside the time loop. Kernels 2 + 3 compute the same
// function with the FFN hoisted out of the loop (no step's FFN feeds the
// recurrence); this kernel keeps the TPU kernel's schedule: one block owns a
// tile of TS = 2 sessions for all P steps and runs, per step,
// `layer_step_i8` (csrc/lstm_i8.cuh): _rowq8(x_t), _rowq8(h), the int8 gate
// dots, the f32 cell, _rowq8(hc), the projection, y = x_t + h_new (from the
// ungated h_new: a masked step still writes its y row), then the FFN +
// BasicNorm of csrc/ffn_norm.cuh on the tile's two rows with the [TS, ffn]
// mid rows in shared memory, in `_ffn_norm_kernel_i8`'s op order and
// _rowq8 points. h and c are kept where t >= n_pulls.
//
// Bound on the H100: per step every block re-reads all of the layer's int8
// weights (2 x d x 4H + H x d + 2 x d x ffn = 6.8 MB at flagship dims) from
// L2, and the integer multiply-adds set the pace, as in kernel
// 2. The FFN now runs at 2 rows per weight read inside the serial loop,
// where kernel 3 runs it at 16 rows per read outside it: the TPU's reason
// to split the layer (kernels 13, 14 and 2) holds here too, and this kernel
// measures it.
//
// Numerics as kernels 2 and 3 (csrc/lstm_i8.cu).

#include "lstm_i8.cuh"

constexpr int TS_CHUNK = 2;  // sessions per block

__global__ void __launch_bounds__(REC_NT) lstm_chunk_i8_kernel(
    const float* __restrict__ x, const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ npulls, LayerI8 w, float* __restrict__ y, float* __restrict__ h2,
    float* __restrict__ c2, int P, int S, int d, int H, int F) {
  constexpr int TS = TS_CHUNK;
  extern __shared__ float4 smem_f4[];
  const LayerSmem m = layer_smem<TS>(reinterpret_cast<float*>(smem_f4), d, H, F);
  const int s0 = blockIdx.x * TS;
  int np[TS];
#pragma unroll
  for (int r = 0; r < TS; ++r) np[r] = (s0 + r < S) ? npulls[s0 + r] : 0;
  load_rows<TS>(m.hsh, h0, s0, S, d);
  load_rows<TS>(m.csh, c0, s0, S, H);
  for (int t = 0; t < P; ++t)
    layer_step_i8<TS>(m, w, x + (size_t)t * S * d, y + (size_t)t * S * d, np, t, s0, S, d, H, F);
  store_rows<TS>(h2, m.hsh, s0, S, d);
  store_rows<TS>(c2, m.csh, s0, S, H);
}

extern "C" int lstm_chunk_i8(const float* x, const float* h, const float* c, const int* npulls,
                             const int8_t* wih, const float* wihs, const int8_t* whh,
                             const float* whhs, const void* bias, const int8_t* whr,
                             const float* whrs, const int8_t* ff1, const float* ff1s,
                             const void* f1b, const int8_t* ff2, const float* ff2s,
                             const void* f2b, const float* eps, float* y, float* h2, float* c2,
                             int P, int S, int d, int H, int F, int bias_bf16, int f1b_bf16,
                             int f2b_bf16, void* stream) {
  const LayerI8 w = {wih, whh, whr, ff1, ff2, wihs, whhs, whrs, ff1s, ff2s, eps,
                     bias, f1b, f2b, bias_bf16, f1b_bf16, f2b_bf16};
  const size_t smem = layer_smem_bytes<TS_CHUNK>(d, H, F);
  const int fit = smem_fits(smem);
  if (fit) return fit;
  cudaError_t err = allow_smem(lstm_chunk_i8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_chunk_i8_kernel<<<(S + TS_CHUNK - 1) / TS_CHUNK, REC_NT, smem, (cudaStream_t)stream>>>(
      x, h, c, npulls, w, y, h2, c2, P, S, d, H, F);
  return (int)cudaGetLastError();
}
