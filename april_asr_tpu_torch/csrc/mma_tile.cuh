// The int8 tensor-core output tile of kernel 3's products (csrc/ffn_mma.cu)
// and of the hoisted kernel 14's x-side gate product (csrc/lstm_hoist.cu):
// a block of 8 warps computes a 128 x 128 tile of A [rows][K] (int8 scratch
// rows of stride lda, a multiple of FM_KT, always in bounds) times W [K][N]
// (row-major int8 weights, zero past K and N) on `mma.sync` m16n8k32 s8 ->
// s32, each warp a 64 x 32 share. The depth streams in FM_KT-byte tiles
// through two shared stages, the next tile loaded into registers (kernel
// 23's csrc/int8_mm.cu loop) while the warps multiply the current one; B is
// transposed in 4 x 4 byte blocks as it is staged ([n][k], mma_tc.cuh).
// The caller runs the loop (fm_load, fm_store, fm_mma) and its epilogue on
// the accumulators: acc[mi][ni][e] is row wm * 64 + mi * 16 + lane / 4 (+ 8
// for e >= 2), column wn * 32 + ni * 8 + 2 (lane % 4) + (e & 1).
#pragma once

#include "common.cuh"
#include "mma_tc.cuh"

#define FM_BM 128                         // rows of an output tile
#define FM_BN 128                         // columns of an output tile
#define FM_NT 256                         // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
#define FM_KT 64                          // bytes of depth a stage
#define FM_LD (FM_KT + 16)                // padded shared row (bytes): A [m][k], B as [n][k]
#define FM_A_BYTES (FM_BM * FM_LD)
#define FM_STAGE (FM_A_BYTES + FM_BN * FM_LD)

// The next depth tile of A (int8 scratch rows, always in bounds) and B (the
// weights [K][N], zero past K and N), held in registers between load and
// store
struct FmStaged {
  uint4 a[2];
  uint32_t b[2][4];
};

__device__ __forceinline__ void fm_load(FmStaged& st, const int8_t* __restrict__ A, int lda,
                                        const int8_t* __restrict__ W, int K, int N, int m0, int n0,
                                        int k0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + j * FM_NT, row = c >> 2, p = c & 3;
    st.a[j] = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + row) * lda + k0 + p * 16);
  }
  // B [64][128] in 4 x 4 blocks: a warp covers 4 k-groups x 8 n-groups
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int wb = j * 8 + warp, kg = (wb >> 2) * 4 + (lane >> 3), ng = (wb & 3) * 8 + (lane & 7);
    const int k = k0 + kg * 4, n = n0 + ng * 4;
    const bool ok = k < K && n < N;  // K and N are multiples of 4
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st.b[j][r] = ok ? __ldg(reinterpret_cast<const unsigned*>(W + (size_t)(k + r) * N + n)) : 0u;
  }
}

__device__ __forceinline__ void fm_store(FmStaged& st, uint8_t* stage) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* sa = stage;
  uint8_t* sb = stage + FM_A_BYTES;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + j * FM_NT, row = c >> 2, p = c & 3;
    *reinterpret_cast<uint4*>(sa + row * FM_LD + p * 16) = st.a[j];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int wb = j * 8 + warp, kg = (wb >> 2) * 4 + (lane >> 3), ng = (wb & 3) * 8 + (lane & 7);
    transpose4x4_s8(st.b[j]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(sb + (ng * 4 + c) * FM_LD + kg * 4) = st.b[j][c];
  }
}

// The warp's 64 x 32 share of one staged tile: two k-steps of 32 bytes
__device__ __forceinline__ void fm_mma(int (&acc)[4][4][4], const uint8_t* stage, int wm, int wn) {
  const int lane = threadIdx.x & 31;
  const uint8_t* sa = stage;
  const uint8_t* sb = stage + FM_A_BYTES;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4(af[mi],
                  sa + (wm * 64 + mi * 16 + (lane & 15)) * FM_LD + ks * 32 + (lane >> 4) * 16);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      const int n = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(r, sb + n * FM_LD + ks * 32 + ((lane >> 3) & 1) * 16);
      bf[2 * nj][0] = r[0];
      bf[2 * nj][1] = r[1];
      bf[2 * nj + 1][0] = r[2];
      bf[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8_16832(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
  }
}
