// Shared device helpers for the port's kernels (plain C interface, built by
// april_asr_tpu_torch/ops/cuda_build.py with nvcc for sm_90a, no fast-math).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// f32 constants spelled exactly as the JAX package rounds them:
// f32(1/127) and f32(1e-30) (the _rowq8 scale factor and floor).
#define INV127 0x1.020408p-7f
#define ROWQ_FLOOR 0x1.4484c0p-100f

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(((uint32_t)b) << 16);
}

// round-to-nearest-even to bf16 and back (jnp .astype(bfloat16))
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The tanh-form logistic of april_asr_tpu/ops/activations.py.
__device__ __forceinline__ float sig_tanh(float x) {
  return __fadd_rn(__fmul_rn(0.5f, tanhf(__fmul_rn(0.5f, x))), 0.5f);
}

__device__ __forceinline__ float load_vec(const void* p, int i, int is_bf16) {
  return is_bf16 ? bf16_to_f32(((const uint16_t*)p)[i]) : ((const float*)p)[i];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// _rowq8 of one row of n floats by one warp: s = max(amax, 1e-30) * (1/127),
// q = rint(v * (1/s)) (round half to even; the reciprocal is multiplied,
// never divided by). Returns s on every lane.
__device__ __forceinline__ float warp_rowq8(const float* v, int n, int8_t* q, int lane) {
  float amax = 0.f;
  for (int k = lane; k < n; k += 32) amax = fmaxf(amax, fabsf(v[k]));
  amax = warp_max(amax);
  const float s = __fmul_rn(fmaxf(amax, ROWQ_FLOOR), INV127);
  const float inv = __frcp_rn(s);
  for (int k = lane; k < n; k += 32) q[k] = (int8_t)__float2int_rn(__fmul_rn(v[k], inv));
  return s;
}

// Weight access by type (float, or uint16_t holding bf16 bits): one weight
// or four consecutive weights as floats, and the activation rounding that
// jnp.dot(x.astype(wd), w, preferred_element_type=f32) applies first.
template <typename WT>
struct Wt;

template <>
struct Wt<float> {
  static __device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
  static __device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float act(float x) { return x; }
};

template <>
struct Wt<uint16_t> {
  static __device__ __forceinline__ float ld(const uint16_t* p, size_t i) { return bf16_to_f32(p[i]); }
  static __device__ __forceinline__ float4 ld4(const uint16_t* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float act(float x) { return round_bf16(x); }
};

// 0 if `bytes` of dynamic shared memory fit one block on this device, minus
// the bytes if they do not (the wrappers raise with them), or a CUDA error.
static inline int smem_fits(size_t bytes) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return bytes > (size_t)limit ? -(int)bytes : 0;
}

// Allows `bytes` of dynamic shared memory for `kern` (needed above 48 KB).
template <typename K>
static cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
