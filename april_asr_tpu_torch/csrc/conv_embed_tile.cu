// Kernels 16 and 17: the step's conv embed of every pull window (front
// buffer [S, W, mel] -> [P, S, d]) for the H100, on the CUDA cores, each bit
// for bit the kernel it replaces.
//
// Replaces april_asr_tpu/ops/conv_embed_pallas.py `conv_embed_windows`
// (`_win_kernel`, kernel 16: conv_stack_kernel) and `conv_embed_from_front`
// (`_kernel`, kernel 17: conv_front_kernel). The CUDA-core kernel they
// displace stays as `conv_embed_simt` / `conv_embed_front_simt`
// (csrc/conv_embed.cu) for the shapes no plan holds; the outputs of each
// pair are equal bit for bit.
//
// The function, per window (each zero-padded on its own): conv1 (3x3, pad
// 1) -> DoubleSwish -> bf16, conv2 (3x3, stride 2) -> DoubleSwish -> bf16,
// conv3 (3x3, stride 2) -> DoubleSwish -> bf16, then the projection of the
// (freq, ch)-flattened row to d. Every product is of two bf16 values, exact
// in f32, so each fmaf rounds only its sum, and every sum is conv_embed.cu's
// chain in its order: conv1 over (dt, df), skipping the taps outside the
// window, then + b1; conv2 and conv3 from 0 over (dt, df, ci), then the
// bias; the projection from bo[n] over k = 0..K-1. Any other order (the
// tensor cores' among them) moves outputs by an ulp and the engines' blobs
// with them, so the sums stay fmaf chains on the CUDA cores.
//
// Bound on the H100: operations. ~0.80 M multiply-adds a window at the
// flagship geometry (mel 80, c = 8, 32, 32, d 512): conv1 40 K, conv2 270 K,
// conv3 175 K, the projection 311 K; 5.50 G at S = 256, P = 27, 0.164 ms at
// the f32 FMA rate (0.011 ms at the bf16 tensor-core rate, which the bits
// forbid). Two launches:
//
//   conv_stack_kernel<C1>  one persistent block of 12 warps an SM walks
//       groups of nw consecutive windows (of the [P * S] output rows, so a
//       group may span sessions), conv2's and conv3's weights widened to f32
//       in shared memory once a block, every intermediate of a group in
//       shared memory:
//         staging  the group's window rows, bf16-rounded f32 with a zero
//                  column each side (float4 loads, 4 in flight a thread);
//         conv1    one (window, row, freq) item a thread, its C1 channels in
//                  registers, stored as bf16 with the even and odd
//                  frequencies in two planes, so that conv2's stride-2 reads
//                  fall on consecutive 16-byte runs;
//         conv2    warp items of (8 output channels, 32 PP2 positions): each
//                  lane PP2 positions x 8 channels, per tap one 16-byte read
//                  of a position's C1 activations and two broadcast float4
//                  weight reads per input channel for 8 PP2 fmaf;
//         conv3    likewise over (window, freq) positions with the windows
//                  fastest (conv2's rows at a window stride of an odd number
//                  of 16-byte runs, so lanes fall in distinct bank groups),
//                  each result written straight to y3t;
//       y3t [M / 128][K][128] f32 holds y3 (bf16 values, exact) k-major
//       per 128-row tile, 16.8 MB at S = 256, in L2 for the next launch.
//   conv_proj_kernel  the projection as 128 x 128 output tiles of a
//       register-tiled f32 product (each thread 8 rows x 8 columns): a
//       producer warp streams the tile's k stages ([8 k][128 rows] of y3t,
//       [8 k][128 columns] of the f32 weight) by bulk copy (TMA) onto each
//       ring slot's `full` mbarrier, the 8 consumer warps release a slot on
//       its `empty` mbarrier (kernel 5's ring, csrc/mbar_ring.cuh).
//
// Kernel 17 differs in conv1 alone. conv_embed.cu computes its conv1 once
// per buffer row over all nine taps (the rows above and below a window read
// as they lie in the buffer, zero outside [0, W)) and corrects a window's
// top row (and, at seg = 7, where conv3 reads it, its bottom row) by
// subtracting the leaked taps' fmaf chain before the DoubleSwish. A row's
// value does not depend on the window that reads it, so conv_front_kernel
// stages each window's R1 + 2 buffer rows from the one above it, computes
// conv1 rows 0..R1-1 per window in that order (acc over all nine (dt, df)
// taps from 0, + b1; row 0 minus the dt = 0 taps' chain, row seg - 1 at seg
// = 7 minus the dt = 2 taps'), and runs kernel 16's conv2, conv3 and
// projection unchanged: the same bits as the CUDA-core kernel. A window's
// rows are its own session's (a group may span sessions), zero past the
// buffer's first and last rows.
//
// The parent re-read the whole projection weight from L2 in every 9-window
// block (~478 MB a launch at S = 256) and ran conv2 and conv3 at 8 fmaf per
// three shared-memory reads; here a staged weight serves every window of a
// block's groups, a register tile serves 8 PP fmaf per weight read, and
// each projection weight serves 128 windows.
//
// Numerics: every f32 step is conv_embed.cu's, in its order, so the outputs
// equal `conv_embed_simt`'s bit for bit. No atomics, no fast-math.
//
// The groups and the shared memory are planned in Python by
// ops/conv_embed_kernels.py `conv_embed_plan` (`front` for kernel 17); the C entry recomputes the
// bytes and refuses a plan that disagrees. With `stamps`, thread 0 of each
// block adds each phase's global-timer nanoseconds after a block barrier
// (tools/profile_embed.py): rows [0, blocks) the conv stack's blocks, then
// one row per projection tile.

#include "common.cuh"
#include "mbar_ring.cuh"

#define CT_NT 384   // conv stack threads: 12 warps
#define CT_R1 7     // conv1 rows that conv3's output reads
#define CT_R2 3     // conv2 rows that conv3's output reads
#define CT_CG 8     // output channels a lane
#define CT_PP2 4    // conv2 positions a lane
#define CT_PP3 2    // conv3 positions a lane
#define CT_STAGE_U 4  // staging loads in flight a thread
#define PJ_NT 256   // projection consumers: 8 warps (and a producer warp)
#define PJ_BM 128   // projection rows a tile
#define PJ_BN 128   // projection columns a tile
#define PJ_BK 8     // k a ring stage
#define PJ_RING 6   // ring stages
#define PJ_BARS 128 // bytes before the ring: its full and empty mbarriers
#define PJ_STAGE (PJ_BK * (PJ_BM + PJ_BN))  // floats a stage: [BK][BM] of y3t, [BK][BN] of wo
#define CE_NSTAMP 7 // start, staging, conv1, conv2, conv3, projection (ns), end

__host__ __device__ inline size_t al16(size_t b) { return (b + 15) & ~(size_t)15; }

// The conv stack's widths: c2 and c3 the padded channels (multiples of 8);
// h1 and h2 the half widths of the even / odd frequency planes of conv1's
// and conv2's outputs; p2 conv2's position pitch in bf16 (c2, or c2 + 8,
// whichever is an odd number of 16-byte runs); ws2 its window stride in bf16
// (an odd number of 16-byte runs).
struct CtDims {
  int c1, c2, c3, mel, seg, f2, f3, h1, h2, p2, ws2, nw;
};

__host__ __device__ inline CtDims ct_dims(int c1, int c2, int c3, int mel, int seg, int nw) {
  CtDims g;
  g.c1 = c1; g.c2 = c2; g.c3 = c3; g.mel = mel; g.seg = seg; g.nw = nw;
  g.f2 = (mel - 3) / 2 + 1;
  g.f3 = (g.f2 - 3) / 2 + 1;
  g.h1 = (mel + 1) / 2;
  g.h2 = (g.f2 + 1) / 2;
  g.p2 = 8 * ((c2 / 8) | 1);
  g.ws2 = 6 * g.h2 * g.p2 + 8;
  return g;
}

// Byte offsets in shared memory (ops/conv_embed_kernels.py `conv_embed_smem`
// computes the same total): conv1's taps [9][C1], the biases, w2 [9 C1][c2]
// and w3 [9 c2][c3] f32; then per window the staged rows [xrows][mel + 2]
// f32 (kernel 16: the window's seg rows; kernel 17: R1 + 2 rows from the
// one above it), which conv2's output [R2][2][h2][p2] bf16 (+ 8) reuses,
// and conv1's output [R1][2][h1][C1] bf16.
struct CtLayout {
  size_t w1, b1, b2, b3, w2, w3, xa, a1, total;
};

__host__ __device__ inline CtLayout ct_layout(const CtDims& g, int xrows) {
  CtLayout L;
  L.w1 = 0;
  L.b1 = L.w1 + al16((size_t)9 * g.c1 * 4);
  L.b2 = L.b1 + al16((size_t)g.c1 * 4);
  L.b3 = L.b2 + al16((size_t)g.c2 * 4);
  L.w2 = L.b3 + al16((size_t)g.c3 * 4);
  L.w3 = L.w2 + al16((size_t)9 * g.c1 * g.c2 * 4);
  L.xa = L.w3 + al16((size_t)9 * g.c2 * g.c3 * 4);
  const size_t xw = (size_t)xrows * (g.mel + 2) * 4, y2w = (size_t)g.ws2 * 2;
  L.a1 = L.xa + al16((size_t)g.nw * (xw > y2w ? xw : y2w));
  L.total = L.a1 + al16((size_t)g.nw * CT_R1 * 2 * g.h1 * g.c1 * 2);
  return L;
}

struct CtArgs {
  const float* front;          // [S][W][mel]
  const float* w1;             // [c1][9], bf16-rounded
  const float* b1;             // [c1]
  const uint16_t* w2k;         // [9 c1][c2] bf16, rows (dt, df, ci)
  const float* b2;             // [c2]
  const uint16_t* w3k;         // [9 c2][c3] bf16
  const float* b3;             // [c3]
  float* y3t;                  // [ceil(M / PJ_BM)][K][PJ_BM]
  unsigned long long* stamps;  // null, or [blocks + tiles][CE_NSTAMP]
  CtDims g;
  int S, W, P, step, groups;
};

struct PjArgs {
  const float* y3t;            // as above
  const float* wo;             // [K][np] f32, columns past dp zero
  const float* bo;             // [dp]
  float* out;                  // [M][dp]
  unsigned long long* stamps;  // null, or as above
  int M, K, dp, np, row0;      // row0: the first projection row of the stamps
};

// icefall DoubleSwish with the tanh-form logistic: x * sigmoid(x - 1)
// (conv_embed.cu's, step for step).
__device__ __forceinline__ float dswish(float x) { return __fmul_rn(x, sig_tanh(__fsub_rn(x, 1.f))); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// the i-th of the bf16 values packed in 32-bit words, widened exactly
__device__ __forceinline__ float bf16_at(uint32_t w, int i) {
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float get8(const uint4& v, int i) {
  const int q = i >> 1;
  return bf16_at(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w, i);
}
__device__ __forceinline__ float get4(const uint2& v, int i) { return bf16_at(i < 2 ? v.x : v.y, i); }

// a position's C1 conv1 activations: one 16-byte (C1 = 8) or 8-byte read
template <int C1>
struct Act;
template <>
struct Act<8> {
  typedef uint4 T;
  static __device__ __forceinline__ T load(const uint16_t* p) { return *reinterpret_cast<const uint4*>(p); }
  static __device__ __forceinline__ float get(const T& v, int i) { return get8(v, i); }
};
template <>
struct Act<4> {
  typedef uint2 T;
  static __device__ __forceinline__ T load(const uint16_t* p) { return *reinterpret_cast<const uint2*>(p); }
  static __device__ __forceinline__ float get(const T& v, int i) { return get4(v, i); }
};

__device__ __forceinline__ void fma8(float* acc, float x, const float4& a, const float4& b) {
  acc[0] = fmaf(x, a.x, acc[0]); acc[1] = fmaf(x, a.y, acc[1]);
  acc[2] = fmaf(x, a.z, acc[2]); acc[3] = fmaf(x, a.w, acc[3]);
  acc[4] = fmaf(x, b.x, acc[4]); acc[5] = fmaf(x, b.y, acc[5]);
  acc[6] = fmaf(x, b.z, acc[6]); acc[7] = fmaf(x, b.w, acc[7]);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Slot k of a stamp row: 0 the start, CE_NSTAMP - 1 the end, else the
// nanoseconds since the last mark added.
__device__ __forceinline__ void stamp(unsigned long long* row, unsigned long long& last, int k) {
  const unsigned long long t = global_ns();
  if (k == 0 || k == CE_NSTAMP - 1)
    row[k] = t;
  else
    row[k] += t - last;
  last = t;
}

// The end of a conv stack phase: a block barrier, then the stamp.
__device__ __forceinline__ void phase_end(unsigned long long* row, unsigned long long& last, int k) {
  __syncthreads();
  if (row != nullptr && threadIdx.x == 0) stamp(row, last, k);
}

// n8 runs of 8 bf16 values widened to f32
__device__ __forceinline__ void widen(float* dst, const uint16_t* src, int n8) {
  for (int i = threadIdx.x; i < n8; i += CT_NT) {
    const uint4 u = reinterpret_cast<const uint4*>(src)[i];
    reinterpret_cast<float4*>(dst)[2 * i] =
        make_float4(bf16_at(u.x, 0), bf16_at(u.x, 1), bf16_at(u.y, 0), bf16_at(u.y, 1));
    reinterpret_cast<float4*>(dst)[2 * i + 1] =
        make_float4(bf16_at(u.z, 0), bf16_at(u.z, 1), bf16_at(u.w, 0), bf16_at(u.w, 1));
  }
}

// The conv stack of kernel 16 (FRONT false) or kernel 17 (FRONT true).
template <int C1, bool FRONT>
__device__ __forceinline__ void conv_stack(const CtArgs& a) {
  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(smem_f4);
  const CtDims g = a.g;
  const CtLayout L = ct_layout(g, FRONT ? CT_R1 + 2 : g.seg);
  float* w1s = reinterpret_cast<float*>(base + L.w1);  // [9][C1]
  float* b1s = reinterpret_cast<float*>(base + L.b1);
  float* b2s = reinterpret_cast<float*>(base + L.b2);
  float* b3s = reinterpret_cast<float*>(base + L.b3);
  float* w2s = reinterpret_cast<float*>(base + L.w2);  // [9 C1][c2]
  float* w3s = reinterpret_cast<float*>(base + L.w3);  // [9 c2][c3]
  float* xw = reinterpret_cast<float*>(base + L.xa);   // [nw][xrows][mel + 2]
  uint16_t* y2 = reinterpret_cast<uint16_t*>(base + L.xa);  // [nw][ws2]: [R2][2][h2][p2]
  uint16_t* a1 = reinterpret_cast<uint16_t*>(base + L.a1);  // [nw][R1][2][h1][C1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c2 = g.c2, c3 = g.c3, mel = g.mel, seg = g.seg, mp = mel + 2;
  const int f2 = g.f2, f3 = g.f3, h1 = g.h1, h2 = g.h2, p2 = g.p2, ws2 = g.ws2;
  // the rows staged a window: its seg rows, or (kernel 17) the buffer rows
  // j step - 1 .. j step + R1 that its conv1 rows 0..R1-1 read
  const int xrows = FRONT ? CT_R1 + 2 : seg;
  const int K = f3 * c3, M = a.P * a.S, xn = xrows * mp;
  unsigned long long* row = a.stamps ? a.stamps + (size_t)blockIdx.x * CE_NSTAMP : nullptr;
  unsigned long long last = 0;
  if (row != nullptr && tid == 0) stamp(row, last, 0);

  // the weights, once a block (covered by the first group's staging barrier)
  for (int i = tid; i < 9 * C1; i += CT_NT) {
    const int tap = i / C1, c = i - tap * C1;
    w1s[i] = a.w1[c * 9 + tap];
  }
  for (int i = tid; i < C1; i += CT_NT) b1s[i] = a.b1[i];
  for (int i = tid; i < c2; i += CT_NT) b2s[i] = a.b2[i];
  for (int i = tid; i < c3; i += CT_NT) b3s[i] = a.b3[i];
  widen(w2s, a.w2k, 9 * C1 * c2 / 8);
  widen(w3s, a.w3k, 9 * c2 * c3 / 8);

  for (int grp = blockIdx.x; grp < a.groups; grp += gridDim.x) {
    const int m0 = grp * g.nw, nw = min(g.nw, M - m0);

    // staging: window m = j S + s is rows j step .. j step + seg - 1 of
    // session s (kernel 17: from row j step - 1, zero outside [0, W));
    // column col holds frequency col - 1
    if (mel % 4 == 0) {  // runs of 4 frequencies, CT_STAGE_U loads in flight a thread
      const int q4 = mel / 4, n4 = nw * xrows * q4;
      for (int i0 = tid; i0 < n4; i0 += CT_STAGE_U * CT_NT) {
        float4 v[CT_STAGE_U];
#pragma unroll
        for (int u = 0; u < CT_STAGE_U; ++u) {
          const int i = min(i0 + u * CT_NT, n4 - 1), rr = i / q4, c4 = i - rr * q4;
          const int jl = rr / xrows, r = rr - jl * xrows, m = m0 + jl, j = m / a.S, s = m - j * a.S;
          if constexpr (FRONT) {
            const int br = j * a.step + r - 1;
            v[u] = br >= 0 && br < a.W
                       ? __ldg(reinterpret_cast<const float4*>(
                                   a.front + ((size_t)s * a.W + br) * mel) + c4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            v[u] = __ldg(reinterpret_cast<const float4*>(
                             a.front + ((size_t)s * a.W + j * a.step + r) * mel) + c4);
          }
        }
#pragma unroll
        for (int u = 0; u < CT_STAGE_U; ++u) {
          const int i = i0 + u * CT_NT;
          if (i >= n4) break;
          float* x = xw + (i / q4) * mp + 1 + 4 * (i % q4);
          x[0] = round_bf16(v[u].x);
          x[1] = round_bf16(v[u].y);
          x[2] = round_bf16(v[u].z);
          x[3] = round_bf16(v[u].w);
        }
      }
      for (int i = tid; i < nw * xrows; i += CT_NT) xw[i * mp] = xw[i * mp + mel + 1] = 0.f;
    } else {
      for (int i = tid; i < nw * xn; i += CT_NT) {
        const int jl = i / xn, rem = i - jl * xn, r = rem / mp, col = rem - r * mp;
        const int m = m0 + jl, j = m / a.S, s = m - j * a.S, f = col - 1;
        if constexpr (FRONT) {
          const int br = j * a.step + r - 1;
          xw[i] = (f >= 0 && f < mel && br >= 0 && br < a.W)
                      ? round_bf16(__ldg(a.front + ((size_t)s * a.W + br) * mel + f))
                      : 0.f;
        } else {
          xw[i] = (f >= 0 && f < mel)
                      ? round_bf16(__ldg(a.front + ((size_t)s * a.W + j * a.step + r) * mel + f))
                      : 0.f;
        }
      }
    }
    phase_end(row, last, 1);

    // conv1: item (window, row t, freq f), its C1 channels
    for (int i = tid; i < nw * CT_R1 * mel; i += CT_NT) {
      const int jl = i / (CT_R1 * mel), rem = i - jl * (CT_R1 * mel), t = rem / mel, f = rem - t * mel;
      const float* xr = xw + jl * xn + f;
      float acc[C1];
#pragma unroll
      for (int c = 0; c < C1; ++c) acc[c] = 0.f;
      if constexpr (FRONT) {
        // conv_embed.cu's buffer row: all nine taps (staged rows t .. t + 2),
        // + b1, then the leaked row's taps off a window's top row (and its
        // bottom row at seg = 7, where conv3 reads it)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float x = xr[(t + tap / 3) * mp + tap % 3];
          const float* wp = w1s + tap * C1;
#pragma unroll
          for (int c = 0; c < C1; c += 4) {
            const float4 w = *reinterpret_cast<const float4*>(wp + c);
            acc[c] = fmaf(x, w.x, acc[c]);
            acc[c + 1] = fmaf(x, w.y, acc[c + 1]);
            acc[c + 2] = fmaf(x, w.z, acc[c + 2]);
            acc[c + 3] = fmaf(x, w.w, acc[c + 3]);
          }
        }
#pragma unroll
        for (int c = 0; c < C1; ++c) acc[c] = __fadd_rn(acc[c], b1s[c]);
        const int dt = t == 0 ? 0 : (seg - 1 < CT_R1 && t == seg - 1) ? 2 : -1;
        if (dt >= 0) {
#pragma unroll
          for (int c = 0; c < C1; ++c) {
            float e = 0.f;
#pragma unroll
            for (int df = 0; df < 3; ++df) e = fmaf(xr[(t + dt) * mp + df], w1s[(dt * 3 + df) * C1 + c], e);
            acc[c] = __fsub_rn(acc[c], e);
          }
        }
      } else {
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const int wr = t + dt - 1;  // the window's row; outside it, the zero pad
          if (wr < 0 || wr >= seg) continue;
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const float x = xr[wr * mp + df];
            const float* wp = w1s + (dt * 3 + df) * C1;
#pragma unroll
            for (int c = 0; c < C1; c += 4) {
              const float4 w = *reinterpret_cast<const float4*>(wp + c);
              acc[c] = fmaf(x, w.x, acc[c]);
              acc[c + 1] = fmaf(x, w.y, acc[c + 1]);
              acc[c + 2] = fmaf(x, w.z, acc[c + 2]);
              acc[c + 3] = fmaf(x, w.w, acc[c + 3]);
            }
          }
        }
      }
      // the pre-activation: kernel 17's is complete, kernel 16's takes b1
      auto pre = [&](int c) { return FRONT ? acc[c] : __fadd_rn(acc[c], b1s[c]); };
      uint32_t wv[C1 / 2];
#pragma unroll
      for (int c = 0; c < C1; c += 2)
        wv[c / 2] = bf16_bits(dswish(pre(c))) | (bf16_bits(dswish(pre(c + 1))) << 16);
      uint16_t* dst = a1 + ((size_t)((jl * CT_R1 + t) * 2 + (f & 1)) * h1 + (f >> 1)) * C1;
      if constexpr (C1 == 8)
        *reinterpret_cast<uint4*>(dst) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(wv[0], wv[1]);
    }
    phase_end(row, last, 2);

    // conv2: warp item (channel group cg, position block pb); lane position
    // p = (pb PP2 + q) 32 + lane of the (window, row r, freq fo) list
    const int np2 = nw * CT_R2 * f2, ng2 = c2 / CT_CG;
    const int nb2 = (np2 + 32 * CT_PP2 - 1) / (32 * CT_PP2);
    for (int it = warp; it < nb2 * ng2; it += CT_NT / 32) {
      const int cg = it % ng2, pb = it / ng2;
      int aoff[CT_PP2], yoff[CT_PP2];
      bool ok[CT_PP2];
#pragma unroll
      for (int q = 0; q < CT_PP2; ++q) {
        const int p = (pb * CT_PP2 + q) * 32 + lane;
        ok[q] = p < np2;
        const int pp = ok[q] ? p : 0;
        const int jl = pp / (CT_R2 * f2), rem = pp - jl * (CT_R2 * f2), r = rem / f2, fo = rem - r * f2;
        aoff[q] = ((jl * CT_R1 + 2 * r) * 2 * h1 + fo) * C1;
        yoff[q] = jl * ws2 + ((r * 2 + (fo & 1)) * h2 + (fo >> 1)) * p2 + cg * CT_CG;
      }
      float acc[CT_PP2][CT_CG];
#pragma unroll
      for (int q = 0; q < CT_PP2; ++q)
#pragma unroll
        for (int k = 0; k < CT_CG; ++k) acc[q][k] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3, df = tap % 3;
        // conv1 row 2 r + dt, frequency 2 fo + df: plane df & 1, half fo + df / 2
        const int toff = (dt * 2 * h1 + (df & 1) * h1 + (df >> 1)) * C1;
        typename Act<C1>::T v[CT_PP2];
#pragma unroll
        for (int q = 0; q < CT_PP2; ++q) v[q] = Act<C1>::load(a1 + aoff[q] + toff);
#pragma unroll
        for (int ci = 0; ci < C1; ++ci) {
          const float* wp = w2s + (tap * C1 + ci) * c2 + cg * CT_CG;
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
#pragma unroll
          for (int q = 0; q < CT_PP2; ++q) fma8(acc[q], Act<C1>::get(v[q], ci), wa, wb);
        }
      }
#pragma unroll
      for (int q = 0; q < CT_PP2; ++q) {
        if (!ok[q]) continue;
        uint32_t wv[CT_CG / 2];
#pragma unroll
        for (int k = 0; k < CT_CG; k += 2)
          wv[k / 2] = bf16_bits(dswish(__fadd_rn(acc[q][k], b2s[cg * CT_CG + k]))) |
                      (bf16_bits(dswish(__fadd_rn(acc[q][k + 1], b2s[cg * CT_CG + k + 1]))) << 16);
        *reinterpret_cast<uint4*>(y2 + yoff[q]) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      }
    }
    phase_end(row, last, 3);

    // conv3: warp item (cg, pb) over the (freq fo, window) list, windows
    // fastest; each result to y3t[m / BM][fo c3 + co][m % BM]
    const int np3 = nw * f3, ng3 = c3 / CT_CG, nc = c2 / 8;
    const int nb3 = (np3 + 32 * CT_PP3 - 1) / (32 * CT_PP3);
    for (int it = warp; it < nb3 * ng3; it += CT_NT / 32) {
      const int cg = it % ng3, pb = it / ng3;
      int yoff[CT_PP3];
      size_t ooff[CT_PP3];
      bool ok[CT_PP3];
#pragma unroll
      for (int q = 0; q < CT_PP3; ++q) {
        const int p = (pb * CT_PP3 + q) * 32 + lane;
        ok[q] = p < np3;
        const int pp = ok[q] ? p : 0;
        const int fo = pp / nw, jl = pp - fo * nw, m = m0 + jl;
        yoff[q] = jl * ws2 + fo * p2;
        ooff[q] = ((size_t)(m / PJ_BM) * K + fo * c3 + cg * CT_CG) * PJ_BM + m % PJ_BM;
      }
      float acc[CT_PP3][CT_CG];
#pragma unroll
      for (int q = 0; q < CT_PP3; ++q)
#pragma unroll
        for (int k = 0; k < CT_CG; ++k) acc[q][k] = 0.f;
      for (int kc = 0; kc < 9 * nc; ++kc) {  // (tap, run of 8 input channels), in order
        const int tap = kc / nc, cc = kc - tap * nc, dt = tap / 3, df = tap - 3 * dt;
        const int toff = (dt * 2 * h2 + (df & 1) * h2 + (df >> 1)) * p2 + cc * 8;
        uint4 v[CT_PP3];
#pragma unroll
        for (int q = 0; q < CT_PP3; ++q) v[q] = *reinterpret_cast<const uint4*>(y2 + yoff[q] + toff);
        const float* wp = w3s + (size_t)kc * 8 * c3 + cg * CT_CG;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 wa = *reinterpret_cast<const float4*>(wp + u * c3);
          const float4 wb = *reinterpret_cast<const float4*>(wp + u * c3 + 4);
#pragma unroll
          for (int q = 0; q < CT_PP3; ++q) fma8(acc[q], get8(v[q], u), wa, wb);
        }
      }
#pragma unroll
      for (int q = 0; q < CT_PP3; ++q) {
        if (!ok[q]) continue;
#pragma unroll
        for (int k = 0; k < CT_CG; ++k)
          a.y3t[ooff[q] + (size_t)k * PJ_BM] =
              round_bf16(dswish(__fadd_rn(acc[q][k], b3s[cg * CT_CG + k])));
      }
    }
    phase_end(row, last, 4);  // also frees conv2's rows for the next group's staging
  }
  if (row != nullptr && tid == 0) stamp(row, last, CE_NSTAMP - 1);
}

template <int C1>
__global__ void __launch_bounds__(CT_NT, 1) conv_stack_kernel(const CtArgs a) {
  conv_stack<C1, false>(a);
}

template <int C1>
__global__ void __launch_bounds__(CT_NT, 1) conv_front_kernel(const CtArgs a) {
  conv_stack<C1, true>(a);
}

__global__ void __launch_bounds__(PJ_NT + 32, 1) conv_proj_kernel(const PjArgs a) {
  extern __shared__ float4 smem_f4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_f4);           // [RING]
  uint64_t* empty = full + PJ_RING;                                // [RING]
  float* ring = reinterpret_cast<float*>(smem_f4) + PJ_BARS / 4;  // [RING][PJ_STAGE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockIdx.x, mt = blockIdx.y, T = a.K / PJ_BK;
  if (tid == 0) {
    for (int i = 0; i < PJ_RING; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, PJ_NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PJ_NT / 32) {  // the producer warp: one lane streams the stages
    if (lane == 0) {
      const float* ya = a.y3t + (size_t)mt * a.K * PJ_BM;
      const float* wb = a.wo + (size_t)nt * PJ_BN;
      for (int t = 0; t < T; ++t) {
        const int s = t % PJ_RING;
        if (t >= PJ_RING) mbar_wait(empty + s, (t / PJ_RING - 1) & 1);
        float* st = ring + s * PJ_STAGE;
        mbar_expect(full + s, PJ_STAGE * 4);
        bulk_copy(st, ya + (size_t)t * PJ_BK * PJ_BM, PJ_BK * PJ_BM * 4, full + s);
        for (int kk = 0; kk < PJ_BK; ++kk)
          bulk_copy(st + PJ_BK * PJ_BM + kk * PJ_BN, wb + (size_t)(t * PJ_BK + kk) * a.np,
                    PJ_BN * 4, full + s);
      }
    }
    return;
  }

  unsigned long long* row =
      a.stamps ? a.stamps + (size_t)(a.row0 + mt * gridDim.x + nt) * CE_NSTAMP : nullptr;
  unsigned long long last = 0;
  if (row != nullptr && tid == 0) stamp(row, last, 0);

  // this thread's rows tr 4 + i, 64 + tr 4 + i and columns tc 4 + j,
  // 64 + tc 4 + j
  const int tr = tid >> 4, tc = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = nt * PJ_BN + (j < 4 ? 0 : 64) + tc * 4 + (j & 3);
    const float b = n < a.dp ? __ldg(a.bo + n) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = b;
  }
  for (int t = 0; t < T; ++t) {
    const int s = t % PJ_RING;
    mbar_wait(full + s, (t / PJ_RING) & 1);
    const float* As = ring + s * PJ_STAGE;
    const float* Bs = As + PJ_BK * PJ_BM;
#pragma unroll
    for (int kk = 0; kk < PJ_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * PJ_BM + tr * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * PJ_BM + 64 + tr * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * PJ_BN + tc * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * PJ_BN + 64 + tc * 4);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) fma8(acc[i], x[i], b0, b1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the stage
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = mt * PJ_BM + (i < 4 ? 0 : 64) + tr * 4 + (i & 3);
    if (m >= a.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * PJ_BN + 64 * h + tc * 4 + 2 * e;
        if (n < a.dp)
          *reinterpret_cast<float2*>(a.out + (size_t)m * a.dp + n) =
              make_float2(acc[i][4 * h + 2 * e], acc[i][4 * h + 2 * e + 1]);
      }
  }
  if (row != nullptr) {
    consumers_sync();
    if (tid == 0) {
      stamp(row, last, 5);
      stamp(row, last, CE_NSTAMP - 1);
    }
  }
}

static size_t pj_smem() { return PJ_BARS + (size_t)PJ_RING * PJ_STAGE * 4; }

template <int C1>
static int ct_launch(const CtArgs& a, int blocks, size_t smem, bool front, cudaStream_t stream) {
  cudaError_t err = allow_smem(front ? conv_front_kernel<C1> : conv_stack_kernel<C1>, smem);
  if (err != cudaSuccess) return (int)err;
  if (front)
    conv_front_kernel<C1><<<blocks, CT_NT, smem, stream>>>(a);
  else
    conv_stack_kernel<C1><<<blocks, CT_NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 16 (from_front 0) or 17 (1) on a plan of ops/conv_embed_kernels.py
// `conv_embed_plan`: the conv stack on `blocks` persistent blocks of groups
// of nw windows (smem: the plan's bytes a block), then the projection. c2,
// c3 and dp are the padded widths of `embed_weight_forms`; np the weight's
// columns (dp rounded up to PJ_BN); y3t the scratch of ceil(P S / PJ_BM) x
// K x PJ_BM floats. Returns cudaGetLastError() of the launches; -1 for a
// shape the kernel does not take, -2 where the plan's shared-memory bytes
// differ from this file's.
extern "C" int conv_embed_tile(const float* front, const float* w1, const float* b1,
                               const void* w2k, const float* b2, const void* w3k, const float* b3,
                               const float* wo, const float* bo, float* y3t, float* out,
                               void* stamps, int S, int W, int mel, int P, int step, int seg,
                               int c1, int c2, int c3, int dp, int np, int nw, int blocks, int smem,
                               int from_front, void* stream) {
  if ((c1 != 4 && c1 != 8) || c2 % CT_CG || c3 % CT_CG || c2 < CT_CG || c3 < CT_CG || dp % 2 ||
      np % PJ_BN || np < dp || nw < 1 || blocks < 1 || S < 1 || P < 1 || mel < 5 ||
      (seg != 7 && seg != 9) || W != (P - 1) * step + seg)
    return -1;
  CtArgs a;
  a.front = front; a.w1 = w1; a.b1 = b1; a.w2k = (const uint16_t*)w2k; a.b2 = b2;
  a.w3k = (const uint16_t*)w3k; a.b3 = b3; a.y3t = y3t;
  a.stamps = (unsigned long long*)stamps;
  a.g = ct_dims(c1, c2, c3, mel, seg, nw);
  a.S = S; a.W = W; a.P = P; a.step = step;
  const int M = P * S;
  a.groups = (M + nw - 1) / nw;
  if (blocks > a.groups) return -1;
  const size_t need = ct_layout(a.g, from_front ? CT_R1 + 2 : seg).total;
  if ((size_t)smem != need) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  const bool fr = from_front != 0;
  int rc = c1 == 8 ? ct_launch<8>(a, blocks, need, fr, st) : ct_launch<4>(a, blocks, need, fr, st);
  if (rc != 0) return rc;

  PjArgs p;
  p.y3t = y3t; p.wo = wo; p.bo = bo; p.out = out; p.stamps = (unsigned long long*)stamps;
  p.M = M; p.K = a.g.f3 * c3; p.dp = dp; p.np = np; p.row0 = blocks;
  cudaError_t err = allow_smem(conv_proj_kernel, pj_smem());
  if (err != cudaSuccess) return (int)err;
  conv_proj_kernel<<<dim3(np / PJ_BN, (M + PJ_BM - 1) / PJ_BM), PJ_NT + 32, pj_smem(), st>>>(p);
  return (int)cudaGetLastError();
}
