// Kernel 3: the int8 residual FFN + BasicNorm of the chunk layer over its
// R = P * S rows, as tiled int8 tensor-core passes.
//
// Replaces april_asr_tpu/ops/lstm_pallas.py `ffn_norm_i8`
// (`_ffn_norm_kernel_i8`): y = x + hseq, _rowq8(y), the int8 ff1 product
// dequantized as acc * (ys * s1) + b1, DoubleSwish mid * sigmoid(mid - 1),
// _rowq8(mid), the int8 ff2 product + b2, the residual, then BasicNorm
// yn * rsqrt(mean(yn^2) + eps).
//
// Bound on the H100: at the flagship (R = 6,912, d 512, F 2048) the two
// products are 2 * 2 * R * d * F = 29 G int8 operations (14.7 us at the
// int8 peak), and the function must move x, hseq and y (42 MB, 12.7 us at
// 3.35 TB/s). The design adds the scratch it streams: mid in f32, written
// and read back once (113 MB), the int8 rows (~35 MB), x and hseq read again
// and y read and written again by the norm: ~250 MB, 75 us of bytes
// (chip_smoke.py `ffn_bounds`). The products, at kernel 23's rate, take
// longer still: they bind.
//
// Design. _rowq8(mid) needs a whole row of F columns before ff2 can start,
// so the layer is five ordinary launches in stream order; no block keeps
// state from one to the next:
//   0 yq    one warp a row: y = x + hseq and _rowq8 into yq [rp][dp] int8
//           (zero past d) and ys [rp]; zeroes the row's mid amax slot
//   1 ff1   128 x 128 output tiles of yq x ff1 on `mma.sync` m16n8k32 s8 ->
//           s32, kernel 23's tile loop (csrc/int8_mm.cu: 8 warps of 64 x 32,
//           64-byte depth tiles in two shared stages, the next tile loaded
//           into registers while the warps multiply the current one, B
//           transposed in 4 x 4 byte blocks as it is staged), with ragged
//           edges: B rows past the depth and columns past the width load as
//           zero, so the padded depth adds nothing to an integer dot.
//           Epilogue: dequantize, bias, DoubleSwish into mid [R][F] f32;
//           each row's |mid| folded into its amax slot by atomicMax on the
//           float's bits (exact and order-free), first across the block's
//           warps in shared memory, then once a block and row in memory
//   2 mq    one warp a row: mq = rint(mid * rcp(s)), s from the row's slot
//   3 ff2   the same tiles over mq x ff2; epilogue: y + (acc * (ms * s2) +
//           b2), y recomputed from x and hseq, into out
//   4 norm  one warp a row: BasicNorm of out in place, the mean over dn
//           columns (d, or the model's d_model where d is zero-padded)
// The passes' bodies are csrc/ffn_mma.cuh, which kernel 11
// (csrc/lstm_hoist.cu) also runs as phases of its cooperative launch (the yq
// and norm launches below keep copies of theirs: see the header).
// The tiles are planned in Python by ops/lstm_mma.py `ffn_plan` (the grid
// of each product and the scratch layout); the C entry computes the same
// grids. Rows past R in the padded scratch are never initialised; their
// products are never stored.
//
// Numerics: bit for bit csrc/ffn_norm.cuh `ffn_norm_tile` (the CUDA-core
// kernel 3 this replaces, kept as `ffn_norm_i8_simt` in csrc/lstm_i8.cu):
// exact int32 dots, _rowq8 as warp_rowq8 computes it, every f32 step
// outside the dots rounded separately (__fmul_rn/__fadd_rn) in its op order,
// sig_tanh's tanhf and rsqrtf (no fast-math), the norm's sum of squares in
// basic_norm_rows' lane order.

#include "ffn_mma.cuh"  // the passes' bodies, on mma_tile.cuh's tile loop

#define FM_ROWS_A_BLOCK (FM_NT / 32)      // rows of a one-warp-a-row pass per block
#define FM_PHASES 5

// Phase 0: _rowq8 of y = x + hseq, one warp a row
__global__ void __launch_bounds__(FM_NT) ffn_yq_kernel(FfnArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * FM_ROWS_A_BLOCK + (threadIdx.x >> 5);
  if (row >= a.R) return;
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

// Phase 2: _rowq8 of mid with the row's folded amax, one warp a row
__global__ void __launch_bounds__(FM_NT) ffn_mq_kernel(FfnArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * FM_ROWS_A_BLOCK + (threadIdx.x >> 5);
  if (row >= a.R) return;
  ffn_mq_row(a, row, lane);
}

// Phase 4: BasicNorm of out's rows in place (csrc/ffn_norm.cuh
// basic_norm_rows' order: lane j adds k = j, j + 32, ..., then warp_sum)
__global__ void __launch_bounds__(FM_NT) ffn_norm_rows_kernel(FfnArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * FM_ROWS_A_BLOCK + (threadIdx.x >> 5);
  if (row >= a.R) return;
  float* y = a.out + (size_t)row * a.d;
  float ss = 0.f;
  for (int k = lane; k < a.d; k += 32) ss = __fadd_rn(ss, __fmul_rn(y[k], y[k]));
  ss = warp_sum(ss);
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)a.dn), a.eps[0]));
  for (int k = lane; k < a.d; k += 32) y[k] = __fmul_rn(y[k], rs);
}

// Phases 1 (FF1) and 3: one 128 x 128 output tile a block, (column tile,
// row tile) = (blockIdx.x, blockIdx.y)
template <bool FF1>
__global__ void __launch_bounds__(FM_NT) ffn_mm_kernel(FfnArgs a) {
  __shared__ __align__(16) uint8_t smem[2][FM_STAGE];
  __shared__ unsigned rmax[FM_BM];  // ff1: the tile's |mid| amax of each row
  ffn_tile<FF1>(a, smem, rmax, blockIdx.y, blockIdx.x);
}

// Kernel 3: the five launches above in stream order (yq, ff1, mq, ff2,
// norm), on the caller's stream. Scratch (ops/lstm_mma.py `FfnPlan.scratch`):
// yq [rp][dp] and mq [rp][fp] int8, ys, amax and ms [rp], mid [R][F] f32,
// rp = R rounded up to 128 rows, dp and fp = d and F rounded up to 64.
extern "C" int ffn_norm_mma(const float* x, const float* hs, const int8_t* ff1, const float* ff1s,
                            const void* f1b, const int8_t* ff2, const float* ff2s, const void* f2b,
                            const float* eps, float* out, int8_t* yq, float* ys, float* mid,
                            unsigned* amax, int8_t* mq, float* ms, int R, int d, int F, int dp,
                            int fp, int f1b_bf16, int f2b_bf16, int dn, void* stream) {
  if (R < 1 || d < 4 || F < 4 || d % 4 || F % 4 || dp % FM_KT || fp % FM_KT || dp < d || fp < F ||
      dn < 1 || dn > d)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const FfnArgs a{x, hs, ff1, ff2, ff1s, ff2s, eps, f1b, f2b, out, yq, mq, ys, mid, ms, amax,
                  R, d, F, dp, fp, f1b_bf16, f2b_bf16, dn};
  const int rows = (R + FM_ROWS_A_BLOCK - 1) / FM_ROWS_A_BLOCK;
  const int mt = (R + FM_BM - 1) / FM_BM;
  for (int p = 0; p < FM_PHASES; ++p) {
    switch (p) {
      case 0: ffn_yq_kernel<<<rows, FM_NT, 0, st>>>(a); break;
      case 1: ffn_mm_kernel<true><<<dim3((F + FM_BN - 1) / FM_BN, mt), FM_NT, 0, st>>>(a); break;
      case 2: ffn_mq_kernel<<<rows, FM_NT, 0, st>>>(a); break;
      case 3: ffn_mm_kernel<false><<<dim3((d + FM_BN - 1) / FM_BN, mt), FM_NT, 0, st>>>(a); break;
      default: ffn_norm_rows_kernel<<<rows, FM_NT, 0, st>>>(a); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
