// The pieces of the thread-block-cluster decode rounds that kernel 4
// (csrc/chunk_decode_cluster.cu, the whole chunk's decode) and kernel 8
// (csrc/dec_joiner_cluster.cu, one decoder-joiner round) share: the block's
// threads and the item scheme (GS sessions x one weight column a thread
// item, one session where few rows are active), the fmaf chains over a
// weight column held in shared memory (its K weights contiguous, K + KPAD
// apart), the mbarrier and copy primitives, the f32 dec_proj columns
// streamed as tensor-map boxes through a TMA ring, the distributed-shared-
// memory gather of a, the per-block phase stamps, the cluster launch and the
// tensor-map encoding. Each sum is one thread's fmaf chain over k = 0 ..
// K-1 in order (the CUDA-core kernels' order).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define CNT 512      // threads a block
#define GS 4         // the most sessions a thread's item carries
#define RING_ROWS 32 // dec_proj rows a stage of the streamed ring holds
#define KPAD 4       // elements past each resident weight column (bank spread)

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// The global nanosecond timer, by thread 0 after a block barrier, into the
// block's row of `at` (tools/profile_decode.py reads the phases).
__device__ __forceinline__ void stamp(unsigned long long* at, int n, int k) {
  if (at == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    at[(size_t)blockIdx.x * n + k] = t;
  }
}

// The tensor-copy (TMA) engine: an mbarrier counting the bytes it waits
// for, and one 2-D box of a tensor map copied to shared memory on it.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// cp.async of 16 or 4 bytes from global to shared memory, its group
// commit, and the wait for all but the newest N groups.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


// dst[c][k] = src[k][c0 + c] for k < K and c < cn, zero for cn <= c < cols:
// a slice of weight columns, each column's K weights contiguous (row stride
// K + KPAD), by plain loads once a launch (global reads along c).
template <typename WT>
__device__ void load_columns(WT* dst, int cols, int K, const WT* src, int scols, int c0, int cn) {
  for (int i = threadIdx.x; i < K * cols; i += blockDim.x) {
    const int k = i / cols, c = i - k * cols;
    dst[(size_t)c * (K + KPAD) + k] = c < cn ? src[(size_t)k * scols + c0 + c] : WT(0);
  }
}

// acc[g] = fmaf chain over k in [k0, k1) of x[g][k] * w[(k - k0) ldw], k in
// order (the CUDA-core kernel's sum); x[g] are f32 rows and w a weight
// column in shared memory, x 16-byte aligned, k1 - k0 a multiple of 16.
template <int G, typename WT>
__device__ __forceinline__ void dot_rows(const float* const* x, int k0, int k1, const WT* w,
                                         int ldw, float* acc) {
#pragma unroll 4
  for (int k = k0; k < k1; k += 4, w += 4 * ldw) {
    const float w0 = Wt<WT>::ld(w, 0), w1 = Wt<WT>::ld(w, ldw);
    const float w2 = Wt<WT>::ld(w, 2 * ldw), w3 = Wt<WT>::ld(w, 3 * ldw);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(x[g] + k);
      acc[g] = fmaf(v.x, w0, acc[g]);
      acc[g] = fmaf(v.y, w1, acc[g]);
      acc[g] = fmaf(v.z, w2, acc[g]);
      acc[g] = fmaf(v.w, w3, acc[g]);
    }
  }
}

// dot_rows for a weight column whose K weights are contiguous in shared
// memory (8-byte aligned for bf16, 16 for f32): one load of 4 weights.
template <int G, typename WT>
__device__ __forceinline__ void dot_rows_col(const float* const* x, int K, const WT* w,
                                             float* acc) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    const float4 wv = Wt<WT>::ld4(w + k);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(x[g] + k);
      acc[g] = fmaf(v.x, wv.x, acc[g]);
      acc[g] = fmaf(v.y, wv.y, acc[g]);
      acc[g] = fmaf(v.z, wv.z, acc[g]);
      acc[g] = fmaf(v.w, wv.w, acc[g]);
    }
  }
}

// The item of thread `it` among (n rows in groups of G) x `cols` columns:
// its first row b0 and column c, and whether it computes (c < cn).
struct Item {
  int b0, c;
  bool on;
};

template <int G>
__device__ __forceinline__ Item item_of(int it, int n, int cols, int cn) {
  const int g = it / cols;
  Item t;
  t.b0 = g * G;
  t.c = it - g * cols;
  t.on = t.b0 < n && t.c < cn;
  return t;
}

// out(b, c, sum) for every row b < n and column c < cn of `cols`, sum the
// fmaf chain over k < K of row(b) against column c of the weights w (column
// c's K weights at w + c (K + KPAD)); items of G rows and one column,
// strided over the block's threads.
template <int G, typename WT, class Row, class Out>
__device__ __forceinline__ void rows_by_cols(int n, int cols, int cn, int K, Row row,
                                             const WT* w, Out out) {
  for (int it = threadIdx.x; it < (n + G - 1) / G * cols; it += CNT) {
    const Item t = item_of<G>(it, n, cols, cn);
    if (!t.on) continue;
    const float* x[G];
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      x[g] = row(min(t.b0 + g, n - 1));
      acc[g] = 0.f;
    }
    dot_rows_col<G>(x, K, w + (size_t)t.c * (K + KPAD), acc);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (t.b0 + g < n) out(t.b0 + g, t.c, acc[g]);
  }
}

// The rows an item carries: one where the rows x columns chains fill at
// most half the block's threads (few sessions: one chain a thread, the
// shortest critical path), else GS, so that each weight read feeds GS
// chains and each thread's GS independent chains hide each other's latency.
__device__ __forceinline__ int item_rows(int n, int cols) { return n * cols <= CNT / 2 ? 1 : GS; }

// rows_by_cols with `item_rows` rows an item.
template <typename WT, class Row, class Out>
__device__ __forceinline__ void rows_by_cols_spread(int n, int cols, int cn, int K, Row row,
                                                    const WT* w, Out out) {
  if (item_rows(n, cols) == 1)
    rows_by_cols<1>(n, cols, cn, K, row, w, out);
  else
    rows_by_cols<GS>(n, cols, cn, K, row, w, out);
}

// The refresh's dout columns with dec_proj's columns [j0, j0 + Jc) streamed
// from global memory through a ring of `slots` stages of RING_ROWS rows x Jc
// at `ring` (128-byte aligned): thread 0 copies each stage as one box of
// the tensor map `map` on the stage slot's mbarrier (`bars`, whose phase
// parities `ph` carry from round to round), slots - 1 stages in flight,
// one block barrier a stage. Each thread keeps one item's sums across the
// stages (the plan keeps the items within one pass: ceil(TS / GS) Jc <=
// CNT).
template <int G, typename WT, class Row, class Out>
__device__ void refresh_streamed(int n, int Jc, int d, const CUtensorMap* map, int j0, WT* ring,
                                 int slots, uint64_t* bars, unsigned& ph, Row row, Out out) {
  const Item t = item_of<G>(threadIdx.x, n, Jc, Jc);
  const float* x[G];
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x[g] = row(min(t.b0 + g, n - 1));
    acc[g] = 0.f;
  }
  const int stages = d / RING_ROWS;
  const size_t stage_elems = (size_t)RING_ROWS * Jc;
  const unsigned stage_bytes = (unsigned)(stage_elems * sizeof(WT));
  const auto issue = [&](int st) {
    if (st < stages && threadIdx.x == 0)
      tma_box(ring + (st % slots) * stage_elems, map, j0, st * RING_ROWS, bars + st % slots,
              stage_bytes);
  };
  for (int st = 0; st < slots - 1; ++st) issue(st);
  for (int st = 0; st < stages; ++st) {
    const int sl = st % slots;
    while (!mbar_done(bars + sl, (ph >> sl) & 1u)) {
    }
    ph ^= 1u << sl;
    __syncthreads();  // stage st - 1 is consumed by every thread
    issue(st + slots - 1);
    if (t.on)
      dot_rows<G>(x, st * RING_ROWS, (st + 1) * RING_ROWS, ring + sl * stage_elems + t.c, Jc, acc);
  }
  __syncthreads();
  if (t.on) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (t.b0 + g < n) out(t.b0 + g, t.c, acc[g]);
  }
}

// X[b][k] = a[row(b)][k] for b < n and k < J: column k read through
// distributed shared memory from the block of the cluster that holds it
// (block r's columns [r Jc, (r + 1) Jc) at its `aloc` [TS][Jc]), by float4s.
template <class Row>
__device__ __forceinline__ void gather_a(const cg::cluster_group& cl, float* aloc, float* X,
                                         int n, int J, int Jc, Row row) {
  const int J4 = J / 4;
  for (int i = threadIdx.x; i < n * J4; i += CNT) {
    const int sl = i / J4, k = 4 * (i - sl * J4), r2 = k / Jc;
    const float* src = cl.map_shared_rank(aloc, r2) + (size_t)row(sl) * Jc + (k - r2 * Jc);
    *reinterpret_cast<float4*>(X + (size_t)sl * J + k) = *reinterpret_cast<const float4*>(src);
  }
}

static cudaLaunchConfig_t cluster_config(int nb, int C, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(CNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// dec_proj [d][J] as a tensor map whose boxes are RING_ROWS rows x Jc
// columns (cuTensorMapEncodeTiled, from the driver through the runtime);
// 0 or a CUDA error.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static int dp_tensor_map(CUtensorMap* map, const void* dp, int J, int d, int Jc, int w_f32) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || encode == nullptr)
      return err != cudaSuccess ? (int)err : (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)J, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)J * (w_f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)Jc, (cuuint32_t)RING_ROWS};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type =
      w_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 2, const_cast<void*>(dp), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

