// Kernels 16 and 17: the conv embed of every pull window of a step, straight
// from the front buffer, on the CUDA cores. Kernel 17's port; for kernel 16
// the route takes csrc/conv_embed_tile.cu, and this kernel (its windows
// entry, count `conv_embed_simt`) only for the shapes that file's plan does
// not hold; the two give the same outputs, bit for bit.
//
// Replaces april_asr_tpu/ops/conv_embed_pallas.py `conv_embed_windows`
// (`_win_kernel`, kernel 16) and `conv_embed_from_front` (`_kernel`, kernel
// 17). Both take the un-stacked front buffer [S, W, mel] (W = (P-1)*step +
// seg) and give every window's embedding [P, S, d] with per-window zero
// padding, as conv_subsample over the stacked windows computes it: conv1
// (3x3, pad 1) -> DoubleSwish -> conv2 (3x3, stride 2) -> DoubleSwish ->
// conv3 (3x3, stride 2) -> DoubleSwish -> the projection of the (freq, ch)
// flattened row to d. Activations are rounded to bf16 before each product
// (x, the conv1 taps, the conv1 activations, y2, y3) and every sum is f32: a
// product of two bf16 values is exact in f32, so each FMA rounds only its
// sum, as the TPU kernels' bf16 x bf16 -> f32 products do (in another order).
//
// One block per (session, group of up to NWIN consecutive windows), every
// intermediate in shared memory:
//   1. the group's front rows, one halo row each side (zero outside the
//      buffer), bf16-rounded, with a zero column each side;
//   2. conv1. The windows entry (kernel 16) computes it per window on the
//      isolated window, zero-padded, as `_win_kernel` does. The from-front
//      entry (kernel 17) computes each buffer row's pre-activation once over
//      the whole buffer and, for each window's top row (and bottom row where
//      conv3 reads it, at seg = 7), subtracts the tap that leaked in from the
//      neighbouring buffer row before the activation, as `_kernel` does
//      (exact, conv1 being linear); the rows two groups share are computed
//      by both;
//   3. conv2 as an im2col product (K = 9*c1, rows ordered (dt, df, cin),
//      CG output channels per thread item);
//   4. conv3 likewise (K = 9*c2): one output row per window;
//   5. the projection of the group's [nw, f3*c3] rows by the (freq, ch)-
//      ordered weight, two output columns per thread.
// Conv3's single output row reads conv1 rows 0..6 and conv2 rows 0..2 only;
// the TPU kernels compute the other rows and drop them, this one does not.
//
// Bound on the H100: the products, ~0.8 M multiply-adds per window at the
// flagship geometry (c = 8, 32, 32; mel 80; d 512), most of them in conv2,
// conv3 and the projection; the bytes (the front read once, the output
// written once) take about two thirds of that time at the bf16 rate. This
// first kernel runs the products as f32 FMAs on the CUDA cores, from shared
// memory (the projection weight from L2); csrc/conv_embed_tile.cu keeps its
// sums and moves the data better.

#include "common.cuh"

#define NT 256
#define NWIN 9  // windows per block
#define R1 7    // conv1 rows that conv3's output reads
#define R2 3    // conv2 rows that conv3's output reads
#define CG 8    // output channels per thread item in conv2 and conv3

struct EmbedGeom {
  int S, W, mel, P, step, seg, c1, c2, c3, d, f2, f3, from_front;
};

struct Layout {
  size_t a1, y2, w2, w3, total;  // byte offsets in shared memory (the front rows at 0)
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// The shared-memory plan for groups of at most nw windows: front rows
// [nx][mel+2] f32; conv1 activations as bf16 bits (per window [nw][R1][mel][c1],
// or the from-front rows [(nw-1)*step + R1][mel][c1] plus nw corrected top
// and nw bottom rows), later reused for y3 [nw][f3*c3] f32; y2
// [nw][R2][f2][c2] bf16 bits; w2k and w3k as f32.
__host__ __device__ inline Layout layout_of(const EmbedGeom& g, int nw) {
  const size_t nx = (size_t)(nw - 1) * g.step + g.seg + 2;
  const size_t plane = (size_t)g.mel * g.c1;
  const size_t a1_win = (size_t)nw * R1 * plane * 2;
  const size_t a1_front = ((size_t)(nw - 1) * g.step + R1 + 2 * nw) * plane * 2;
  const size_t y3 = (size_t)nw * g.f3 * g.c3 * 4;
  size_t a1 = a1_win > a1_front ? a1_win : a1_front;
  if (y3 > a1) a1 = y3;
  Layout L;
  L.a1 = align16(nx * (g.mel + 2) * 4);
  L.y2 = L.a1 + align16(a1);
  L.w2 = L.y2 + align16((size_t)nw * R2 * g.f2 * g.c2 * 2);
  L.w3 = L.w2 + align16((size_t)9 * g.c1 * g.c2 * 4);
  L.total = L.w3 + align16((size_t)9 * g.c2 * g.c3 * 4);
  return L;
}

// icefall DoubleSwish with the tanh-form logistic: x * sigmoid(x - 1).
__device__ __forceinline__ float dswish(float x) { return __fmul_rn(x, sig_tanh(__fsub_rn(x, 1.f))); }

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(NT) conv_embed_kernel(
    const float* __restrict__ front, const float* __restrict__ w1, const float* __restrict__ b1,
    const uint16_t* __restrict__ w2k, const float* __restrict__ b2,
    const uint16_t* __restrict__ w3k, const float* __restrict__ b3,
    const uint16_t* __restrict__ wo, const float* __restrict__ bo, float* __restrict__ out,
    EmbedGeom g, int nwmax) {
  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(smem_f4);
  const Layout L = layout_of(g, nwmax);
  float* xs = reinterpret_cast<float*>(base);
  uint16_t* a1 = reinterpret_cast<uint16_t*>(base + L.a1);
  float* y3 = reinterpret_cast<float*>(base + L.a1);  // after conv2, a1 is dead
  uint16_t* y2 = reinterpret_cast<uint16_t*>(base + L.y2);
  float* w2s = reinterpret_cast<float*>(base + L.w2);
  float* w3s = reinterpret_cast<float*>(base + L.w3);

  const int s = blockIdx.y;
  const int j0 = blockIdx.x * NWIN;
  const int nw = min(NWIN, g.P - j0);
  const int tid = threadIdx.x;
  const int mel = g.mel, c1 = g.c1, c2 = g.c2, c3 = g.c3, step = g.step, seg = g.seg;
  const int mp = mel + 2;
  const int plane = mel * c1;

  // 1. xs row lr holds buffer row j0*step - 1 + lr, column col frequency col - 1
  const int nx = (nw - 1) * step + seg + 2;
  const int r0 = j0 * step - 1;
  const float* src = front + (size_t)s * g.W * mel;
  for (int i = tid; i < nx * mp; i += NT) {
    const int lr = i / mp, col = i - lr * mp;
    const int r = r0 + lr, f = col - 1;
    xs[i] = (r >= 0 && r < g.W && f >= 0 && f < mel) ? round_bf16(src[(size_t)r * mel + f]) : 0.f;
  }
  for (int i = tid; i < 9 * c1 * c2; i += NT) w2s[i] = bf16_to_f32(w2k[i]);
  for (int i = tid; i < 9 * c2 * c3; i += NT) w3s[i] = bf16_to_f32(w3k[i]);
  __syncthreads();

  // 2. conv1 (w1: the bf16-rounded taps, [c1][dt*3 + df])
  const int ns = (nw - 1) * step + R1;   // from-front rows of the group
  uint16_t* top = a1 + (size_t)ns * plane;  // from-front: corrected top rows [nw][mel][c1]
  uint16_t* bot = top + (size_t)nw * plane;  // and bottom rows, read only at seg = 7
  const bool need_bot = seg - 1 < R1;
  if (!g.from_front) {
    for (int i = tid; i < nw * R1 * plane; i += NT) {
      const int c = i % c1, f = (i / c1) % mel, t = (i / plane) % R1, j = i / (plane * R1);
      const float* wc = w1 + c * 9;
      float acc = 0.f;
      for (int dt = 0; dt < 3; ++dt) {
        const int wr = t + dt - 1;  // the window's row; outside it, the zero pad
        if (wr < 0 || wr >= seg) continue;
        const float* xr = xs + (j * step + wr + 1) * mp + f;
        for (int df = 0; df < 3; ++df) acc = fmaf(xr[df], __ldg(wc + dt * 3 + df), acc);
      }
      a1[i] = bf16_bits(dswish(__fadd_rn(acc, __ldg(b1 + c))));
    }
  } else {
    for (int i = tid; i < ns * plane; i += NT) {
      const int c = i % c1, f = (i / c1) % mel, row = i / plane;
      const float* wc = w1 + c * 9;
      const float* xr = xs + row * mp + f;  // buffer rows j0*step + row - 1 + dt
      float acc = 0.f;
      for (int dt = 0; dt < 3; ++dt)
        for (int df = 0; df < 3; ++df) acc = fmaf(xr[dt * mp + df], __ldg(wc + dt * 3 + df), acc);
      acc = __fadd_rn(acc, __ldg(b1 + c));
      a1[i] = bf16_bits(dswish(acc));
      if (row % step == 0 && row / step < nw) {  // the top row of window row / step
        float ct = 0.f;
        for (int df = 0; df < 3; ++df) ct = fmaf(xr[df], __ldg(wc + df), ct);
        top[(size_t)(row / step) * plane + f * c1 + c] = bf16_bits(dswish(__fsub_rn(acc, ct)));
      }
      const int jb = row - (seg - 1);  // the bottom row of window jb / step
      if (need_bot && jb >= 0 && jb % step == 0 && jb / step < nw) {
        float cb = 0.f;
        for (int df = 0; df < 3; ++df) cb = fmaf(xr[2 * mp + df], __ldg(wc + 6 + df), cb);
        bot[(size_t)(jb / step) * plane + f * c1 + c] = bf16_bits(dswish(__fsub_rn(acc, cb)));
      }
    }
  }
  __syncthreads();

  // 3. conv2: y2[j][r][fo][co], r < R2
  const int f2 = g.f2, f3 = g.f3;
  const int ng2 = c2 / CG;
  for (int i = tid; i < nw * R2 * f2 * ng2; i += NT) {
    const int cg = i % ng2, fo = (i / ng2) % f2, r = (i / (ng2 * f2)) % R2, j = i / (ng2 * f2 * R2);
    float acc[CG];
#pragma unroll
    for (int k = 0; k < CG; ++k) acc[k] = 0.f;
    for (int dt = 0; dt < 3; ++dt) {
      const int t = 2 * r + dt;  // the window's conv1 row
      const uint16_t* arow;
      if (!g.from_front) arow = a1 + ((size_t)j * R1 + t) * plane;
      else if (t == 0) arow = top + (size_t)j * plane;
      else if (need_bot && t == seg - 1) arow = bot + (size_t)j * plane;
      else arow = a1 + (size_t)(j * step + t) * plane;
      for (int df = 0; df < 3; ++df) {
        const uint16_t* ap = arow + (2 * fo + df) * c1;
        const float* wp = w2s + (size_t)(dt * 3 + df) * c1 * c2 + cg * CG;
        for (int ci = 0; ci < c1; ++ci) {
          const float a = bf16_to_f32(ap[ci]);
          const float4 wa = *reinterpret_cast<const float4*>(wp + ci * c2);
          const float4 wb = *reinterpret_cast<const float4*>(wp + ci * c2 + 4);
          acc[0] = fmaf(a, wa.x, acc[0]); acc[1] = fmaf(a, wa.y, acc[1]);
          acc[2] = fmaf(a, wa.z, acc[2]); acc[3] = fmaf(a, wa.w, acc[3]);
          acc[4] = fmaf(a, wb.x, acc[4]); acc[5] = fmaf(a, wb.y, acc[5]);
          acc[6] = fmaf(a, wb.z, acc[6]); acc[7] = fmaf(a, wb.w, acc[7]);
        }
      }
    }
    uint16_t* yp = y2 + ((size_t)(j * R2 + r) * f2 + fo) * c2 + cg * CG;
#pragma unroll
    for (int k = 0; k < CG; ++k) yp[k] = bf16_bits(dswish(__fadd_rn(acc[k], __ldg(b2 + cg * CG + k))));
  }
  __syncthreads();

  // 4. conv3: y3[j][fo*c3 + co], bf16-rounded, in the a1 region
  const int ng3 = c3 / CG;
  const int K = f3 * c3;
  for (int i = tid; i < nw * f3 * ng3; i += NT) {
    const int cg = i % ng3, fo = (i / ng3) % f3, j = i / (ng3 * f3);
    float acc[CG];
#pragma unroll
    for (int k = 0; k < CG; ++k) acc[k] = 0.f;
    for (int dt = 0; dt < 3; ++dt) {
      for (int df = 0; df < 3; ++df) {
        const uint16_t* yp = y2 + ((size_t)(j * R2 + dt) * f2 + 2 * fo + df) * c2;
        const float* wp = w3s + (size_t)(dt * 3 + df) * c2 * c3 + cg * CG;
        for (int ci = 0; ci < c2; ++ci) {
          const float a = bf16_to_f32(yp[ci]);
          const float4 wa = *reinterpret_cast<const float4*>(wp + ci * c3);
          const float4 wb = *reinterpret_cast<const float4*>(wp + ci * c3 + 4);
          acc[0] = fmaf(a, wa.x, acc[0]); acc[1] = fmaf(a, wa.y, acc[1]);
          acc[2] = fmaf(a, wa.z, acc[2]); acc[3] = fmaf(a, wa.w, acc[3]);
          acc[4] = fmaf(a, wb.x, acc[4]); acc[5] = fmaf(a, wb.y, acc[5]);
          acc[6] = fmaf(a, wb.z, acc[6]); acc[7] = fmaf(a, wb.w, acc[7]);
        }
      }
    }
    float* op = y3 + (size_t)j * K + fo * c3 + cg * CG;
#pragma unroll
    for (int k = 0; k < CG; ++k) op[k] = round_bf16(dswish(__fadd_rn(acc[k], __ldg(b3 + cg * CG + k))));
  }
  __syncthreads();

  // 5. out[j0 + j][s][n] = bo[n] + sum_k y3[j][k] * wo[k][n]; columns 2q, 2q + 1
  const int d = g.d;
  const uint32_t* wo2 = reinterpret_cast<const uint32_t*>(wo);
  for (int q = tid; q < d / 2; q += NT) {
    float acc0[NWIN], acc1[NWIN];
    const float bl = __ldg(bo + 2 * q), bh = __ldg(bo + 2 * q + 1);
#pragma unroll
    for (int j = 0; j < NWIN; ++j) {
      acc0[j] = bl;
      acc1[j] = bh;
    }
    for (int k = 0; k < K; ++k) {
      const uint32_t u = __ldg(wo2 + (size_t)k * (d / 2) + q);
      const float wl = __uint_as_float(u << 16), wh = __uint_as_float(u & 0xffff0000u);
#pragma unroll
      for (int j = 0; j < NWIN; ++j) {
        if (j < nw) {
          const float y = y3[j * K + k];
          acc0[j] = fmaf(y, wl, acc0[j]);
          acc1[j] = fmaf(y, wh, acc1[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NWIN; ++j) {
      if (j < nw) {
        *reinterpret_cast<float2*>(out + ((size_t)(j0 + j) * g.S + s) * d + 2 * q) =
            make_float2(acc0[j], acc1[j]);
      }
    }
  }
}

// from_front selects kernel 17's conv1 (1) or kernel 16's (0). Returns minus
// the shared memory bytes a block needs when the device allows a block fewer,
// nothing launched; else cudaGetLastError() of the launch.
extern "C" int conv_embed_simt(const float* front, const float* w1, const float* b1,
                               const uint16_t* w2k, const float* b2, const uint16_t* w3k,
                               const float* b3, const uint16_t* wo, const float* bo, float* out,
                               int S, int W, int mel, int P, int step, int seg, int c1, int c2,
                               int c3, int d, int from_front, void* stream) {
  EmbedGeom g;
  g.S = S; g.W = W; g.mel = mel; g.P = P; g.step = step; g.seg = seg;
  g.c1 = c1; g.c2 = c2; g.c3 = c3; g.d = d; g.from_front = from_front;
  g.f2 = (mel - 3) / 2 + 1;
  g.f3 = (g.f2 - 3) / 2 + 1;
  const int nwmax = P < NWIN ? P : NWIN;
  const size_t smem = layout_of(g, nwmax).total;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return -(int)smem;
  err = allow_smem(conv_embed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + NWIN - 1) / NWIN, S);
  conv_embed_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(front, w1, b1, w2k, b2, w3k, b3, wo,
                                                               bo, out, g, nwmax);
  return (int)cudaGetLastError();
}
