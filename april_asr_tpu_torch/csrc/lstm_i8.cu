// Kernel 22 and the CUDA-core templates of kernels 13 and 14: recurrent
// cores of the int8 chunk layer; and the CUDA-core form of kernel 3, its
// batched residual + FFN + BasicNorm (the engine's kernel 3 is
// csrc/ffn_mma.cu). (Kernel 2, the engine's core, computes the same
// function on the tensor cores: csrc/lstm_mma.cu; kernels 13 and 14 are
// csrc/lstm_hoist.cu, a hoisted x-side product and a persistent
// recurrence, which also serves kernel 2's calls where its stationary
// weights do not fit, ops/lstm_mma.py `rec_route`. The templates below
// serve kernels 13 and 14 only where that plan has no launch, as
// `lstm_rec_i8_simt` and `lstm_rec_stream_i8_simt`.)
//
// The recurrent cores replace april_asr_tpu/ops/lstm_pallas.py
// `lstm_layer_chunk_rec_i8` (`_rec_kernel_i8`, 13) and
// `lstm_layer_chunk_rec_stream_i8` (`_rec_stream_kernel_i8`, 14), and
// tools/profile_chunk_split.py `rec_interleave_i8` (22). All compute one
// function of one layer over P steps: _rowq8(x_t) and _rowq8(h),
// the int8 gate dots against w_ih/w_hh, the f32 cell, _rowq8(hc) and the
// int8 projection; hseq[t] is written ungated and h/c are kept where
// t >= n_pulls. On the TPU they differ in how time and x reach the core: the
// whole P-deep x tile in VMEM with the time loop inside the block (13), the
// time axis as the fastest grid axis with a 1024-row session tile (14).
// Here one block owns a tile of TS sessions for
// all P steps (the time loop runs inside the block; the step's pieces are
// in csrc/lstm_i8.cuh), with h, c, hc and the int8 rows in shared memory.
// The x-side gates are computed in the block too, never by a library GEMM.
// They differ in how x_t reaches the block:
//
//   X_STAGED (13, TS = 2): the block quantizes every step's x rows at its
//     start and keeps P * TS * d int8 values and P * TS scales in shared
//     memory, the int8 form of the TPU kernel's VMEM-resident x tile (the
//     f32 tile would need 229 KB at TS = 2, d = 512, P = 56); the time loop
//     then quantizes only h. The C entry returns minus the bytes where a P
//     does not fit.
//   X_ASYNC (14, TS = 4): x_{t+1} is copied into a second buffer by
//     cp.async while step t computes. The larger session tile makes each L2
//     read of the layer's weights serve 4 sessions, not 2, at the price of
//     filling only 64 of the 132 SMs at S = 256: the trade the TPU kernel's
//     1024-row tile makes, and the one to measure.
//   X_STEP (22, TS = 2 or 4): the one step t = P - 1 alone, x_t read from
//     device memory and quantized beside h, with x and hseq indexed by that global t and the mask t < n_pulls taken at
//     it; kernel 22 launches it once per step (launch_interleave).
//
// Bound on the H100: per step every block re-reads the layer's int8 weights
// (2 x d x 4H + H x d = 4.7 MB at flagship dims), which stay resident in the
// 50 MB L2; the integer multiply-adds (plain IMAD loops over char4 weight
// strips, exact int32) set the pace (instruction throughput). Each thread owns 4
// consecutive hidden units (one coalesced char4 per gate row) so the cell
// needs no exchange between threads.
//
// ffn_norm_i8_simt computes `ffn_norm_i8` (`_ffn_norm_kernel_i8`) with
// ffn_norm_kernel<16, 8> (csrc/ffn_norm.cuh, shared with lstm_step_i8_simt):
// over tiles of RT = 16 of the flattened P*S rows, y = x + hseq, _rowq8(y),
// int8 ff1, DoubleSwish, _rowq8(mid), int8 ff2, residual, BasicNorm
// y * rsqrtf(mean(y^2) + eps). The [16, ffn] mid tile (128 KB f32 at
// ffn = 2048) lives in dynamic shared memory and never reaches device
// memory. Bound: the integer multiply-adds; the weights (2 MB) stay in L2.
//
// Numerics: activations quantize as the JAX package does (see common.cuh);
// integer dots are exact; every f32 step is rounded separately
// (__fmul_rn/__fadd_rn, no FMA contraction) in the JAX op order. tanhf and
// rsqrtf are CUDA's (no fast-math): they can differ from XLA's by an ulp,
// which may flip an isolated int8 rounding downstream.

#include "lstm_i8.cuh"

#define X_STAGED 1
#define X_ASYNC 2
#define X_STEP 3
#define RT 16  // rows per block (ffn_norm_i8_simt)
#define RG 8   // rows per thread item (ffn_norm_i8_simt)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copies of the tile's rows of x_t [S, d] into dst [TS][d], 16
// bytes a copy (rows past S are not copied: they stay zero)
template <int TS>
__device__ __forceinline__ void async_rows(float* dst, const float* __restrict__ src, int s0,
                                           int S, int d) {
  const int q4 = d / 4;
  for (int i = threadIdx.x; i < TS * q4; i += REC_NT) {
    const int r = i / q4, s = s0 + r, k = (i - r * q4) * 4;
    if (s < S) cp_async16(dst + r * d + k, src + (size_t)s * d + k);
  }
}

template <int XM>
__host__ __device__ constexpr int x_bufs() {
  return XM == X_STEP ? 1 : (XM == X_ASYNC ? 2 : 0);
}

template <int TS, int XM>
__global__ void __launch_bounds__(REC_NT) lstm_rec_kernel(
    const float* __restrict__ x, const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ npulls, const int8_t* __restrict__ wih,
    const float* __restrict__ wihs, const int8_t* __restrict__ whh,
    const float* __restrict__ whhs, const void* __restrict__ bias,
    const int8_t* __restrict__ whr, const float* __restrict__ whrs,
    float* __restrict__ hseq, float* __restrict__ h2, float* __restrict__ c2,
    int P, int S, int d, int H, int bias_bf16) {
  static_assert(2 * TS <= REC_NT / 32, "one warp per x row and per h row");
  extern __shared__ float4 smem_f4[];
  float* hsh = reinterpret_cast<float*>(smem_f4);  // [TS][d] carried h
  float* csh = hsh + TS * d;                      // [TS][H] carried c
  float* hcs = csh + TS * H;                      // [TS][H] hc of this step
  float* xt = hcs + TS * H;                       // [x_bufs][TS][d] f32 x_t
  float* sc = xt + x_bufs<XM>() * TS * d;         // [4][TS] row scales: x, h, hc
  float* xsc = sc + 4 * TS;                       // X_STAGED: [P][TS] x row scales
  int8_t* hq = reinterpret_cast<int8_t*>(xsc + (XM == X_STAGED ? P * TS : 0));  // [TS][d]
  int8_t* hcq = hq + TS * d;                      // [TS][H]
  int8_t* xq = hcq + TS * H;                      // [TS][d]; X_STAGED: [P][TS][d]

  const int s0 = blockIdx.x * TS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int np[TS];
#pragma unroll
  for (int r = 0; r < TS; ++r) np[r] = (s0 + r < S) ? npulls[s0 + r] : 0;
  load_rows<TS>(hsh, h0, s0, S, d);
  load_rows<TS>(csh, c0, s0, S, H);

  if (XM == X_STAGED) {
    // _rowq8 of every step's x rows, one warp per (step, row)
    for (int i = warp; i < P * TS; i += REC_NT / 32) {
      const int t = i / TS, s = s0 + (i - t * TS);
      int8_t* q = xq + (size_t)i * d;
      if (s < S) {
        const float v = warp_rowq8(x + ((size_t)t * S + s) * d, d, q, lane);
        if (lane == 0) xsc[i] = v;
      } else {
        for (int k = lane; k < d; k += 32) q[k] = 0;
        if (lane == 0) xsc[i] = 0.f;
      }
    }
  } else if (XM == X_ASYNC) {
    for (int i = tid; i < 2 * TS * d; i += REC_NT)
      if (s0 + (i / d) % TS >= S) xt[i] = 0.f;
    async_rows<TS>(xt, x, s0, S, d);
    cp_async_commit();
  }

  for (int t = XM == X_STEP ? P - 1 : 0; t < P; ++t) {
    const float* xr = xt;
    if (XM == X_STEP) {
      load_rows<TS>(xt, x + (size_t)t * S * d, s0, S, d);
    } else if (XM == X_ASYNC) {
      xr = xt + (t & 1) * TS * d;
      cp_async_wait_all();
    }
    __syncthreads();
    if (XM == X_ASYNC && t + 1 < P) {
      // x_{t+1} into the buffer step t - 1 read (its readers passed the barrier)
      async_rows<TS>(xt + ((t + 1) & 1) * TS * d, x + (size_t)(t + 1) * S * d, s0, S, d);
      cp_async_commit();
    }
    if (XM != X_STAGED && warp < TS) {
      const float s = warp_rowq8(xr + warp * d, d, xq + warp * d, lane);
      if (lane == 0) sc[warp] = s;
    } else if (warp >= TS && warp < 2 * TS) {
      const int r = warp - TS;
      const float s = warp_rowq8(hsh + r * d, d, hq + r * d, lane);
      if (lane == 0) sc[TS + r] = s;
    }
    __syncthreads();
    const bool staged = XM == X_STAGED;
    rec_gates_cell<TS>(staged ? xq + (size_t)t * TS * d : xq, staged ? xsc + t * TS : sc, hq,
                       sc + TS, wih, wihs, whh, whhs, bias, bias_bf16, csh, hcs, np, t, d, H);
    __syncthreads();
    if (warp < TS) {
      const float s = warp_rowq8(hcs + warp * H, H, hcq + warp * H, lane);
      if (lane == 0) sc[2 * TS + warp] = s;
    }
    __syncthreads();
    rec_proj<TS>(hcq, sc + 2 * TS, whr, whrs, d, H, [&](int r, int col, float hn) {
      const int s = s0 + r;
      if (s < S) hseq[((size_t)t * S + s) * d + col] = hn;
      if (t < np[r]) hsh[r * d + col] = hn;
    });
    __syncthreads();
  }
  store_rows<TS>(h2, hsh, s0, S, d);
  store_rows<TS>(c2, csh, s0, S, H);
}

template <int TS, int XM>
static int launch_rec(const float* x, const float* h, const float* c, const int* npulls,
                      const int8_t* wih, const float* wihs, const int8_t* whh, const float* whhs,
                      const void* bias, const int8_t* whr, const float* whrs, float* hseq,
                      float* h2, float* c2, int P, int S, int d, int H, int bias_bf16,
                      void* stream) {
  const int px = XM == X_STAGED ? P : 1;
  const size_t smem =
      sizeof(float) * (size_t)(TS * (d + 2 * H) + x_bufs<XM>() * TS * d + 4 * TS
                               + (XM == X_STAGED ? P * TS : 0))
      + (size_t)TS * (d + H) + (size_t)px * TS * d;
  const int fit = smem_fits(smem);
  if (fit) return fit;
  const auto kern = lstm_rec_kernel<TS, XM>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(S + TS - 1) / TS, REC_NT, smem, (cudaStream_t)stream>>>(
      x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq, h2, c2, P, S, d, H, bias_bf16);
  return (int)cudaGetLastError();
}

// Kernel 22: kernel 13's contract with time the slow axis -- one launch of
// the X_STEP core per timestep t over every session tile (a CUDA grid does
// not order its blocks, so the TPU's sequential (P, tiles) grid becomes P
// launches), the launch boundary ordering step t after step t - 1. h and c
// are carried between launches in hbuf [2][S][d] and cbuf [2][S][H] (step t
// reads h, c at t = 0, else slot (t - 1) & 1, and writes slot t & 1): the
// device-memory counterpart of the TPU kernel's [S, d]/[S, H] VMEM scratch,
// L2-resident at the tool's shapes (12 MB at S = 2048). hseq[t] is written
// ungated; h/c keep their values where t >= n_pulls. The caller's h', c'
// are slot (P - 1) & 1.
template <int TS>
static int launch_interleave(const float* x, const float* h, const float* c, const int* npulls,
                             const int8_t* wih, const float* wihs, const int8_t* whh,
                             const float* whhs, const void* bias, const int8_t* whr,
                             const float* whrs, float* hseq, float* hbuf, float* cbuf, int P,
                             int S, int d, int H, int bias_bf16, void* stream) {
  const size_t hs = (size_t)S * d, cs = (size_t)S * H;
  for (int t = 0; t < P; ++t) {
    const float* hi = t ? hbuf + ((t - 1) & 1) * hs : h;
    const float* ci = t ? cbuf + ((t - 1) & 1) * cs : c;
    const int rc = launch_rec<TS, X_STEP>(x, hi, ci, npulls, wih, wihs, whh, whhs, bias, whr,
                                          whrs, hseq, hbuf + (t & 1) * hs, cbuf + (t & 1) * cs,
                                          t + 1, S, d, H, bias_bf16, stream);
    if (rc) return rc;
  }
  return 0;
}

#define REC_ENTRY(name, TS, XM)                                                                  \
  extern "C" int name(const float* x, const float* h, const float* c, const int* npulls,         \
                      const int8_t* wih, const float* wihs, const int8_t* whh, const float* whhs, \
                      const void* bias, const int8_t* whr, const float* whrs, float* hseq,       \
                      float* h2, float* c2, int P, int S, int d, int H, int bias_bf16,           \
                      void* stream) {                                                            \
    return launch_rec<TS, XM>(x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq, h2,  \
                              c2, P, S, d, H, bias_bf16, stream);                                \
  }

// the templates of kernels 13 and 14 (csrc/lstm_hoist.cu redesigned both),
// kept for shapes the new plan has no launch for and as chip_smoke.py's
// yardstick
REC_ENTRY(lstm_rec_i8_simt, 2, X_STAGED)        // kernel 13's
REC_ENTRY(lstm_rec_stream_i8_simt, 4, X_ASYNC)  // kernel 14's (x 16-byte aligned)

// kernel 22 on tiles of ts = 2 (kernel 13's) or 4 (kernel 14's) sessions
extern "C" int rec_interleave_i8(const float* x, const float* h, const float* c,
                                 const int* npulls, const int8_t* wih, const float* wihs,
                                 const int8_t* whh, const float* whhs, const void* bias,
                                 const int8_t* whr, const float* whrs, float* hseq, float* hbuf,
                                 float* cbuf, int P, int S, int d, int H, int bias_bf16, int ts,
                                 void* stream) {
  if (ts == 2)
    return launch_interleave<2>(x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq,
                                hbuf, cbuf, P, S, d, H, bias_bf16, stream);
  if (ts == 4)
    return launch_interleave<4>(x, h, c, npulls, wih, wihs, whh, whhs, bias, whr, whrs, hseq,
                                hbuf, cbuf, P, S, d, H, bias_bf16, stream);
  return (int)cudaErrorInvalidValue;
}

template <int RTI, int RGI>
static int launch_ffn_i8(const float* x, const float* hs, const int8_t* ff1, const float* ff1s,
                         const void* f1b, const int8_t* ff2, const float* ff2s, const void* f2b,
                         const float* eps, float* out, int R, int d, int F, int f1b_bf16,
                         int f2b_bf16, cudaStream_t stream) {
  const auto kern = ffn_norm_kernel<RTI, RGI>;
  const size_t smem = ffn_i8_smem<RTI>(d, F);
  const int fit = smem_fits(smem);
  if (fit) return fit;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(R + RTI - 1) / RTI, FFN_NT, smem, stream>>>(x, hs, ff1, ff1s, f1b, ff2, ff2s, f2b, eps,
                                                      out, R, d, F, f1b_bf16, f2b_bf16, d);
  return (int)cudaGetLastError();
}

// The CUDA-core kernel 3 that csrc/ffn_mma.cu replaced, on row tiles of
// `rows` = 16 (RT), 8 or 4 (its routes for wide models), kept as
// chip_smoke.py's yardstick: the new kernel equals it bit for bit. A row's
// quantization, integer dots and f32 steps do not depend on the tile, so
// every tile gives the same bits.
extern "C" int ffn_norm_i8_simt(const float* x, const float* hs, const int8_t* ff1,
                                const float* ff1s, const void* f1b, const int8_t* ff2,
                                const float* ff2s, const void* f2b, const float* eps, float* out,
                                int R, int d, int F, int f1b_bf16, int f2b_bf16, int rows,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows == RT)
    return launch_ffn_i8<RT, RG>(x, hs, ff1, ff1s, f1b, ff2, ff2s, f2b, eps, out, R, d, F,
                                 f1b_bf16, f2b_bf16, st);
  if (rows == 8)
    return launch_ffn_i8<8, 8>(x, hs, ff1, ff1s, f1b, ff2, ff2s, f2b, eps, out, R, d, F, f1b_bf16,
                               f2b_bf16, st);
  if (rows == 4)
    return launch_ffn_i8<4, 4>(x, hs, ff1, ff1s, f1b, ff2, ff2s, f2b, eps, out, R, d, F, f1b_bf16,
                               f2b_bf16, st);
  return (int)cudaErrorInvalidValue;
}
