// Kernels 8 and 9: one round of the greedy decode's joiner and argmax.
//
// joiner_argmax replaces april_asr_tpu/ops/joiner_pallas.py
// `joiner_argmax_fused` (`_kernel`): logits = wd(tanh(eout + dout)) @ W + b,
// then blank_val = logits[blank] and the max and argmax of the logits with
// the blank column at -1e30 (first index on ties), where wd(.) rounds to the
// weight type (bf16 or f32, one template).
//
// dec_joiner_simt replaces `decoder_joiner_argmax_fused` (`_dj_kernel`): first
// the lazy decoder refresh of every session, pre = T0[c0] + T1[c1] (exact
// f32 row gathers: the TPU kernel's one-hot f32 contraction selects the same
// rows), new = wd(relu(pre)) @ dec_proj + b, and the blend
// dout' = nd * new + (1 - nd) * dout; then kernel 9's joiner and argmax on
// dout'. Kernel 8's route is now csrc/dec_joiner_cluster.cu; this one serves
// the shapes no cluster slice holds (ops/decode_kernels.py `dj_plan`).
//
// The TPU kernels pad the vocabulary to 128 lanes and keep the whole [V]
// logits row of a session tile in VMEM. Here no [V] row is kept anywhere,
// so any V runs (kernel 9 serves vocabularies up to 16,383 tokens, where
// kernel 8's gate and the chunk decode's refuse), unpadded, which is what
// the TPU kernels' -1e30 pad columns amount to. One C call launches:
//
//   dec_refresh (dec_joiner_simt only): a block per JT = 16 sessions, their
//     gathered rows in shared memory, a thread per dec_proj column; writes
//     dout'.
//   joiner_tile: a block per (256 vocabulary columns, JT sessions), a
//     thread per column, the sessions' wd(tanh(eout + dout)) rows in shared
//     memory (column-major, so one 16-byte read feeds 4 sessions). Each
//     block reduces its columns to a (max, first index) per session and
//     merges it into the session's 64-bit key with atomicMax: the float's
//     order-preserving bits above the inverted column index, so the larger
//     logit, then the lower index, wins. The blank column's block writes
//     blank_val.
//   argmax_final: the keys back to (max_idx, max_val).
//
// Bound on the H100: per call the J x V joiner matrix is read from device
// memory once and from L2 once per session tile; the multiply-adds are
// 2 x J x V per session (plus 2 x d x J for the refresh). Design: JT = 16
// sessions share each weight load, and every thread keeps KU = 8 weight
// loads in flight, since with one block per SM a single load at a time
// leaves the stream latency-bound.
//
// Numerics: as kernel 4 (csrc/chunk_decode.cu): f32 FMA sums, the bias and
// every f32 step outside the dots rounded separately; tanhf as written (no
// fast-math).

#include "common.cuh"

#define JT 16    // sessions per block
#define JNT 256  // threads per block; joiner_tile: vocabulary columns per block
#define KU 8     // weight loads in flight per thread
#define NEG_INF_F (-1e30f)

// (value, index) as one key whose unsigned order is the argmax order:
// larger value first, then lower index.
__device__ __forceinline__ unsigned long long argmax_key(float v, int i) {
  const unsigned b = __float_as_uint(v);
  const unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)ord << 32) | (0xffffffffu - (unsigned)i);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  const unsigned ord = (unsigned)(k >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

template <typename WT>
__global__ void __launch_bounds__(JNT) dec_refresh(
    const int* __restrict__ ctx, const float* __restrict__ nd, const float* __restrict__ dout,
    const float* __restrict__ dec_table, const void* __restrict__ dp_v,
    const float* __restrict__ dpb, float* __restrict__ dout_out, int S, int J, int d, int V) {
  extern __shared__ float4 smem_f4[];
  const WT* __restrict__ dp = static_cast<const WT*>(dp_v);
  float* ya = reinterpret_cast<float*>(smem_f4);  // [d][JT] wd(relu(pre))
  const int s0 = blockIdx.x * JT;
  for (int i = threadIdx.x; i < JT * d; i += JNT) {
    const int si = i / d, k = i - si * d, s = s0 + si;
    float y = 0.f;
    if (s < S) {
      const float pre = __fadd_rn(dec_table[(size_t)ctx[2 * s] * d + k],
                                  dec_table[((size_t)V + ctx[2 * s + 1]) * d + k]);
      y = Wt<WT>::act(fmaxf(pre, 0.f));
    }
    ya[k * JT + si] = y;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < J; j += JNT) {
    float acc[JT];
#pragma unroll
    for (int si = 0; si < JT; ++si) acc[si] = 0.f;
    for (int k0 = 0; k0 < d; k0 += KU) {
      float w[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) w[u] = k0 + u < d ? Wt<WT>::ld(dp, (size_t)(k0 + u) * J + j) : 0.f;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (k0 + u >= d) break;
        const float4* y4 = reinterpret_cast<const float4*>(ya + (k0 + u) * JT);
#pragma unroll
        for (int q = 0; q < JT / 4; ++q) {
          const float4 y = y4[q];
          acc[4 * q] = fmaf(y.x, w[u], acc[4 * q]);
          acc[4 * q + 1] = fmaf(y.y, w[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(y.z, w[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(y.w, w[u], acc[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int si = 0; si < JT; ++si) {
      const int s = s0 + si;
      if (s >= S) break;
      const size_t g = (size_t)s * J + j;
      const float n = nd[s];
      dout_out[g] = __fadd_rn(__fmul_rn(n, __fadd_rn(acc[si], dpb[j])),
                              __fmul_rn(__fsub_rn(1.f, n), dout[g]));
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(JNT) joiner_tile(
    const float* __restrict__ eout, const float* __restrict__ dout, const void* __restrict__ W_v,
    const float* __restrict__ jb, unsigned long long* __restrict__ keys, float* __restrict__ bv,
    int S, int J, int V, int blank) {
  extern __shared__ float4 smem_f4[];
  __shared__ unsigned long long red[JNT / 32][JT];
  const WT* __restrict__ W = static_cast<const WT*>(W_v);
  float* t = reinterpret_cast<float*>(smem_f4);  // [J][JT] wd(tanh(eout + dout))
  const int s0 = blockIdx.y * JT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < JT * J; i += JNT) {
    const int si = i / J, j = i - si * J, s = s0 + si;
    const size_t g = (size_t)s * J + j;
    t[j * JT + si] = s < S ? Wt<WT>::act(tanhf(__fadd_rn(eout[g], dout[g]))) : 0.f;
  }
  __syncthreads();

  const int v = blockIdx.x * JNT + tid;
  float acc[JT];
#pragma unroll
  for (int si = 0; si < JT; ++si) acc[si] = 0.f;
  if (v < V) {
    for (int j0 = 0; j0 < J; j0 += KU) {
      float w[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) w[u] = j0 + u < J ? Wt<WT>::ld(W, (size_t)(j0 + u) * V + v) : 0.f;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (j0 + u >= J) break;
        const float4* t4 = reinterpret_cast<const float4*>(t + (j0 + u) * JT);
#pragma unroll
        for (int q = 0; q < JT / 4; ++q) {
          const float4 x = t4[q];
          acc[4 * q] = fmaf(x.x, w[u], acc[4 * q]);
          acc[4 * q + 1] = fmaf(x.y, w[u], acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(x.z, w[u], acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(x.w, w[u], acc[4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int si = 0; si < JT; ++si) {
    unsigned long long k = 0;  // below every real key
    if (v < V) {
      float lv = __fadd_rn(acc[si], jb[v]);
      if (v == blank) {
        if (s0 + si < S) bv[s0 + si] = lv;
        lv = NEG_INF_F;
      }
      k = argmax_key(lv, v);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long ok = __shfl_xor_sync(0xffffffffu, k, o);
      k = ok > k ? ok : k;
    }
    if (lane == 0) red[warp][si] = k;
  }
  __syncthreads();
  if (tid < JT && s0 + tid < S) {
    unsigned long long k = red[0][tid];
    for (int w = 1; w < JNT / 32; ++w) k = red[w][tid] > k ? red[w][tid] : k;
    atomicMax(keys + s0 + tid, k);
  }
}

__global__ void argmax_final(const unsigned long long* __restrict__ keys, int* __restrict__ mi,
                             float* __restrict__ mv, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const unsigned long long k = keys[s];
  mi[s] = (int)(0xffffffffu - (unsigned)(k & 0xffffffffu));
  mv[s] = key_value(k);
}

// The joiner, argmax and finalization on rows (eout, dout); keys is the
// wrapper's [S] u64 scratch.
template <typename WT>
static cudaError_t joiner_argmax_run(const float* eout, const float* dout, const void* W,
                                     const float* jb, int* mi, float* mv, float* bv,
                                     unsigned long long* keys, int S, int J, int V, int blank,
                                     cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * (size_t)S, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * JT * (size_t)J;
  err = allow_smem(joiner_tile<WT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((V + JNT - 1) / JNT, (S + JT - 1) / JT);
  joiner_tile<WT><<<grid, JNT, smem, stream>>>(eout, dout, W, jb, keys, bv, S, J, V, blank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  argmax_final<<<(S + 255) / 256, 256, 0, stream>>>(keys, mi, mv, S);
  return cudaGetLastError();
}

// w_f32 selects the type of W (and dec_proj): 1 f32, 0 bf16.
extern "C" int joiner_argmax(const float* eout, const float* dout, const void* W, const float* jb,
                             int* mi, float* mv, float* bv, void* keys, int S, int J, int V,
                             int blank, int w_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  return (int)(w_f32 ? joiner_argmax_run<float>(eout, dout, W, jb, mi, mv, bv, k, S, J, V, blank, st)
                     : joiner_argmax_run<uint16_t>(eout, dout, W, jb, mi, mv, bv, k, S, J, V, blank,
                                                   st));
}

template <typename WT>
static cudaError_t dec_joiner_run(const int* ctx, const float* nd, const float* dout,
                                  const float* eout, const float* dec_table, const void* dp,
                                  const float* dpb, const void* W, const float* jb, int* mi,
                                  float* mv, float* bv, float* dout_out, unsigned long long* keys,
                                  int S, int J, int d, int V, int blank, cudaStream_t stream) {
  const size_t smem = sizeof(float) * JT * (size_t)d;
  cudaError_t err = allow_smem(dec_refresh<WT>, smem);
  if (err != cudaSuccess) return err;
  dec_refresh<WT><<<(S + JT - 1) / JT, JNT, smem, stream>>>(ctx, nd, dout, dec_table, dp, dpb,
                                                            dout_out, S, J, d, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return joiner_argmax_run<WT>(eout, dout_out, W, jb, mi, mv, bv, keys, S, J, V, blank, stream);
}

extern "C" int dec_joiner_simt(const int* ctx, const float* nd, const float* dout,
                               const float* eout, const float* dec_table, const void* dp,
                               const float* dpb, const void* W, const float* jb, int* mi,
                               float* mv, float* bv, float* dout_out, void* keys, int S, int J,
                               int d, int V, int blank, int w_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  return (int)(w_f32 ? dec_joiner_run<float>(ctx, nd, dout, eout, dec_table, dp, dpb, W, jb, mi, mv,
                                             bv, dout_out, k, S, J, d, V, blank, st)
                     : dec_joiner_run<uint16_t>(ctx, nd, dout, eout, dec_table, dp, dpb, W, jb, mi,
                                                mv, bv, dout_out, k, S, J, d, V, blank, st));
}
