// Kernel 23's first port: the matrix-unit microbenchmark of
// tools/profile_int8.py -- one [M, K] x [K, N] product in three forms, on
// the tensor cores -- kept as `mm_*_sync`, the comparison chip_smoke holds
// csrc/mm_wgmma.cu against (the tool's route launches that kernel).
//
// Replaces tools/profile_int8.py `call` (the ungridded `pl.pallas_call`) over
// its bodies:
//   mm_bf16     `mm_kernel`: bf16 x bf16 -> f32
//   mm_i8       `mm_kernel_i8`: int8 x int8 -> int32 (exact)
//   mm_i8_dynq  `mm_kernel_i8_dynq`: bf16 x quantized per row in the kernel
//               (sx = amax / 127, q = round(x / max(sx, 1e-30)), a division),
//               the int8 dot, then (acc * sx) * s[n]. XLA compiles the
//               body's `amax / 127.0` as amax * f32(1/127) (a division by a
//               constant becomes a multiply); the kernel does the same.
//
// Design: one tiled GEMM template, warp-level `mma.sync` (csrc/mma_tc.cuh:
// m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32). A block of 256 threads owns a
// 128 x 128 output tile; its 8 warps own 64 x 32 each (4 x 4 mma tiles, the
// accumulators in registers). The K loop walks tiles of 64 bytes per row
// (32 bf16 or 64 int8) through two shared-memory stages: the next tile is
// loaded into registers while the warps multiply the current one, then
// stored to the other stage (one barrier per tile). A is staged row-major and
// read with `ldmatrix`; bf16 B [k][n] row-major and read with
// `ldmatrix.trans`; int8 B is transposed in 4 x 4 byte blocks while it is
// staged ([n][k], `transpose4x4_s8`), since `ldmatrix.trans` moves only
// 16-bit elements. Shared rows are padded by 16 bytes so the 8 rows of each
// `ldmatrix` matrix fall in distinct banks. The epilogue writes the
// accumulators straight to the [M, N] output.
//
// mm_i8_dynq first reads each of the block's 128 rows of x over all of K for
// its amax (one warp per 16 rows), keeps sx and max(sx, 1e-30) per row in
// shared memory, and quantizes each x tile while staging it: IEEE division
// (__fdiv_rn, not a multiply by a reciprocal) and round half to even
// (__float2int_rn), the tool's op order; the epilogue rounds (acc * sx) and
// then (* s) separately.
//
// Bound on the H100 at the tool's shapes: bytes, not operations -- the
// 4-byte [M, N] output dominates (2048 x 512 x 4096: 33.6 MB of 39.8 MB
// moved at bf16); the operations (2MKN) take at most 8.7 us at the bf16
// rate. csrc/mm_wgmma.cu takes the same products to wgmma, TMA and warp
// specialisation.
//
// Shapes: M and N multiples of 128, K a multiple of 32 (bf16) or 64 (int8
// forms); operands 16-byte aligned. The wrappers check; the C entries return
// cudaErrorInvalidValue otherwise.

#include <type_traits>

#include "common.cuh"
#include "mma_tc.cuh"

#define MM_BM 128
#define MM_BN 128
#define MM_NT 256                  // 8 warps: 2 (rows) x 4 (cols), 64 x 32 each
#define MM_KB 64                   // bytes of a k-tile row: 32 bf16 or 64 int8
#define MM_LD (MM_KB + 16)         // padded shared row (bytes): A, and int8 B as [n][k]
#define MM_LDB (MM_BN * 2 + 16)    // padded shared row (bytes): bf16 B as [k][n]

enum { MM_BF16 = 0, MM_I8 = 1, MM_DYNQ = 2 };

template <int MODE>
struct MmCfg {
  static constexpr int KT = MODE == MM_BF16 ? 32 : 64;          // k per tile
  static constexpr int A_LD = MODE == MM_DYNQ ? 4 : 2;          // uint4 loads of A a thread
  static constexpr int A_BYTES = MM_BM * MM_LD;
  static constexpr int B_BYTES = MODE == MM_BF16 ? 32 * MM_LDB : MM_BN * MM_LD;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte aligned stages");
};

// The next tile's operands, held in registers between its load and store
template <int MODE>
struct Staged {
  uint4 a[MmCfg<MODE>::A_LD];
  uint4 b16[2];        // bf16 B: two 16-byte row pieces
  uint32_t b8[2][4];   // int8 B: two 4 x 4 blocks, row-major until stored
};

template <int MODE>
__device__ __forceinline__ void load_tile(Staged<MODE>& st, const uint8_t* __restrict__ a,
                                          const uint8_t* __restrict__ b, int m0, int n0, int kt,
                                          int K, int N) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = kt * MmCfg<MODE>::KT;
  if (MODE == MM_DYNQ) {
    // x bf16: 128 rows x 64 values = 8 pieces of 8 a row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tid + j * MM_NT, row = c >> 3, k8 = (c & 7) * 8;
      st.a[j] = *reinterpret_cast<const uint4*>(a + ((size_t)(m0 + row) * K + k0 + k8) * 2);
    }
  } else {
    // bf16 or int8 A: 128 rows x 64 bytes = 4 pieces of 16 bytes a row
    const int es = MODE == MM_BF16 ? 2 : 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * MM_NT, row = c >> 2, p = c & 3;
      st.a[j] = *reinterpret_cast<const uint4*>(a + ((size_t)(m0 + row) * K + k0) * es + p * 16);
    }
  }
  if (MODE == MM_BF16) {
    // B bf16 [32][128]: 16 pieces of 8 columns a row
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * MM_NT, kr = c >> 4, p = c & 15;
      st.b16[j] = *reinterpret_cast<const uint4*>(b + ((size_t)(k0 + kr) * N + n0 + p * 8) * 2);
    }
  } else {
    // B int8 [64][128] in 4 x 4 blocks: a warp covers 4 k-groups x 8 n-groups
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wb = j * 8 + warp, kg = (wb >> 2) * 4 + (lane >> 3), ng = (wb & 3) * 8 + (lane & 7);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st.b8[j][r] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k0 + kg * 4 + r) * N + n0 + ng * 4);
    }
  }
}

__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16)
         | ((uint32_t)(d & 0xff) << 24);
}

// round(x / dv) of two bf16 values packed in u, as int8 codes
__device__ __forceinline__ void quant2(uint32_t u, float dv, int& q0, int& q1) {
  q0 = __float2int_rn(__fdiv_rn(__uint_as_float(u << 16), dv));
  q1 = __float2int_rn(__fdiv_rn(__uint_as_float(u & 0xffff0000u), dv));
}

template <int MODE>
__device__ __forceinline__ void store_tile(Staged<MODE>& st, uint8_t* stage, const float* dv) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* sa = stage;
  uint8_t* sb = stage + MmCfg<MODE>::A_BYTES;
  if (MODE == MM_DYNQ) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tid + j * MM_NT, row = c >> 3, k8 = (c & 7) * 8;
      const float v = dv[row];
      int q[8];
      quant2(st.a[j].x, v, q[0], q[1]);
      quant2(st.a[j].y, v, q[2], q[3]);
      quant2(st.a[j].z, v, q[4], q[5]);
      quant2(st.a[j].w, v, q[6], q[7]);
      *reinterpret_cast<uint2*>(sa + row * MM_LD + k8) =
          make_uint2(pack_s8x4(q[0], q[1], q[2], q[3]), pack_s8x4(q[4], q[5], q[6], q[7]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * MM_NT, row = c >> 2, p = c & 3;
      *reinterpret_cast<uint4*>(sa + row * MM_LD + p * 16) = st.a[j];
    }
  }
  if (MODE == MM_BF16) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * MM_NT, kr = c >> 4, p = c & 15;
      *reinterpret_cast<uint4*>(sb + kr * MM_LDB + p * 16) = st.b16[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int wb = j * 8 + warp, kg = (wb >> 2) * 4 + (lane >> 3), ng = (wb & 3) * 8 + (lane & 7);
      transpose4x4_s8(st.b8[j]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(sb + (ng * 4 + c) * MM_LD + kg * 4) = st.b8[j][c];
    }
  }
}

// The warp's 64 x 32 share of one staged tile: two k-steps of 32 bytes
template <int MODE, typename Acc>
__device__ __forceinline__ void mma_tile(Acc (&acc)[4][4][4], const uint8_t* stage, int wm,
                                         int wn) {
  const int lane = threadIdx.x & 31;
  const uint8_t* sa = stage;
  const uint8_t* sb = stage + MmCfg<MODE>::A_BYTES;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4(a[mi], sa + (wm * 64 + mi * 16 + (lane & 15)) * MM_LD + ks * 32 + (lane >> 4) * 16);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
      if (MODE == MM_BF16) {
        const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * 32 + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(r, sb + kr * MM_LDB + n * 2);
      } else {
        const int n = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(r, sb + n * MM_LD + ks * 32 + ((lane >> 3) & 1) * 16);
      }
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (MODE == MM_BF16)
          mma_bf16_16816(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        else
          mma_s8_16832(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
  }
}

// out [M, N] = a [M, K] x b [K, N] in form MODE; s [N] (dynq column scales)
template <int MODE>
__global__ void __launch_bounds__(MM_NT) mm_kernel(const uint8_t* __restrict__ a,
                                                   const uint8_t* __restrict__ b,
                                                   const float* __restrict__ s,
                                                   void* __restrict__ out, int K, int N) {
  using Acc = typename std::conditional<MODE == MM_BF16, float, int>::type;
  __shared__ __align__(16) uint8_t smem[2][MmCfg<MODE>::STAGE];
  __shared__ float sx[MM_BM], dv[MM_BM];  // dynq: per-row scale and divisor
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;

  if (MODE == MM_DYNQ) {
    // each row's amax over all of K, before any of it is quantized
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const uint4* row = reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K * 2);
      float amax = 0.f;
      for (int c = lane; c < K / 8; c += 32) {
        const uint4 u = row[c];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          amax = fmaxf(amax, fmaxf(fabsf(__uint_as_float(w[i] << 16)),
                                   fabsf(__uint_as_float(w[i] & 0xffff0000u))));
      }
      amax = warp_max(amax);
      if (lane == 0) {
        const float v = __fmul_rn(amax, INV127);
        sx[r] = v;
        dv[r] = fmaxf(v, ROWQ_FLOOR);
      }
    }
    __syncthreads();
  }

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int KT = K / MmCfg<MODE>::KT;
  Staged<MODE> st;
  load_tile<MODE>(st, a, b, m0, n0, 0, K, N);
  store_tile<MODE>(st, smem[0], dv);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_tile<MODE>(st, a, b, m0, n0, kt + 1, K, N);
    mma_tile<MODE>(acc, smem[kt & 1], wm, wn);
    if (kt + 1 < KT) store_tile<MODE>(st, smem[(kt + 1) & 1], dv);
    __syncthreads();
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * 64 + mi * 16 + g + h * 8;
        const int col = n0 + wn * 32 + ni * 8 + q * 2;
        const size_t o = (size_t)(m0 + rl) * N + col;
        const Acc v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if constexpr (MODE == MM_BF16) {
          *reinterpret_cast<float2*>((float*)out + o) = make_float2(v0, v1);
        } else if constexpr (MODE == MM_I8) {
          *reinterpret_cast<int2*>((int*)out + o) = make_int2(v0, v1);
        } else {
          const float r0 = __fmul_rn(__fmul_rn(__int2float_rn(v0), sx[rl]), s[col]);
          const float r1 = __fmul_rn(__fmul_rn(__int2float_rn(v1), sx[rl]), s[col + 1]);
          *reinterpret_cast<float2*>((float*)out + o) = make_float2(r0, r1);
        }
      }
}

template <int MODE>
static int launch_mm(const void* a, const void* b, const float* s, void* out, int M, int K, int N,
                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % MM_BM || N % MM_BN || K % MmCfg<MODE>::KT)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / MM_BN, M / MM_BM);
  mm_kernel<MODE><<<grid, MM_NT, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, s, out, K, N);
  return (int)cudaGetLastError();
}

// x bf16 [M, K], w bf16 [K, N] -> out f32 [M, N]
extern "C" int mm_bf16(const void* x, const void* w, float* out, int M, int K, int N,
                       void* stream) {
  return launch_mm<MM_BF16>(x, w, nullptr, out, M, K, N, stream);
}

// x int8 [M, K], w int8 [K, N] -> out int32 [M, N]
extern "C" int mm_i8(const int8_t* x, const int8_t* w, int* out, int M, int K, int N,
                     void* stream) {
  return launch_mm<MM_I8>(x, w, nullptr, out, M, K, N, stream);
}

// x bf16 [M, K], w int8 [K, N], s f32 [N] -> out f32 [M, N]
extern "C" int mm_i8_dynq(const void* x, const int8_t* w, const float* s, float* out, int M,
                          int K, int N, void* stream) {
  return launch_mm<MM_DYNQ>(x, w, s, out, M, K, N, stream);
}
