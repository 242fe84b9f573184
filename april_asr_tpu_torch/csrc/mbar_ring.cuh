// A ring of shared-memory stages filled by the bulk-copy (TMA) engine and
// guarded by mbarriers, for kernels of one producer warp and 8 consumer
// warps (kernels 5 and 16: csrc/fbank_bf16x3_tile.cu, conv_embed_tile.cu;
// kernel 20, csrc/lstm_tp_ffn.cu, fills its ring from thread 0).
// Each slot has a `full` mbarrier, which completes when the stage's bytes
// have landed (the producer's arrival plus the copies' byte count), and an
// `empty` one, which completes when the consumer warps have released it.
#pragma once

#include <stdint.h>

// (also defined, under the same guard, by mma_tc.cuh and wgmma.cuh)
#ifndef APRIL_SMEM_U32
#define APRIL_SMEM_U32
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
#endif

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned ok = 0;
  while (!ok)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the producer's arrival on a `full` mbarrier, with the bytes its copies
// will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) copied by the
// bulk-copy engine onto the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A barrier of the 8 consumer warps alone (the producer warp never waits).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
