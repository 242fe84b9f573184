// Kernel 5: the float engines' fbank frame DSP (hop-row buffer -> log-mel
// rows) for the H100, on the CUDA cores, bit for bit the kernel it replaces.
//
// Replaces april_asr_tpu/ops/fbank_pallas.py `logmel_rows_from_buf`
// (`_buf_kernel`). The CUDA-core kernel it displaces stays as
// `fbank_bf16x3_simt` (csrc/fbank_bf16x3.cu) for the shapes no plan holds;
// the rows of the two are equal bit for bit.
//
// The function, per frame row: the samples split exactly into bf16 planes
// x_hi = bf16(x), x_lo = bf16(x - x_hi); per view of `shift` samples of the
// K = n_views * shift window, the three products x_hi.d_hi, x_hi.d_lo and
// x_lo.d_hi against the folded DFT's bf16 planes (2 nfft columns, lo*lo
// dropped), summed in f32; the view sums added in view order; power = re^2 +
// im^2 split to bf16 hi / lo; the bf16x3 mel (hi.mel_hi + hi.mel_lo +
// lo.mel_hi); log(max(K_EPS, .)).
//
// Bound on the H100: operations. Every product of two bf16 values is exact in
// f32, so each sum rounds only at its adds, in fbank_bf16x3.cu's order: per
// (row, column) pre = fmaf(b, dh, fmaf(a, dl, fmaf(a, dh, pre))) for k in
// order, acc = acc + pre after each view. Any other order (the tensor cores'
// among them) moves values by an ulp and the float engines' decisions with
// them, so the sums stay sequential fmaf chains on the CUDA cores:
// 3 x padded x 2 nfft multiply-adds a frame, 20.3 G at S = 256, F = 101 (16
// kHz), ~0.61 ms at the f32 FMA rate; the bf16 tensor-core bound of the same
// work is 0.044 ms.
//
// Design. One block of 8 consumer warps and a producer warp takes M = 4 R
// consecutive rows of the flattened [S * F] frame list (a tile may span
// sessions; R = 6 or 7, the rows a thread holds, is chosen by the plan so
// that the tiles fill the SMs' waves; with 9 warps a block, three share an
// SM quarter's 16K registers, which caps a thread at 168, and R = 8 spills):
//   staging   the hop rows the tile's frames span (kernel 1's segment map)
//             are read once, split into the x_hi and x_lo planes as f32 and
//             stored as hop rows of 2 pitch floats, per run of 4 samples
//             their x_hi then their x_lo: frame f's sample k is hop row
//             f + k / shift at sample k % shift, so no frame matrix is
//             formed, and one address serves both planes. The pitch (shift,
//             or shift + 4 floats) is an odd number of 16-byte runs, so 4
//             consecutive frames' float4 reads fall in 4 distinct bank
//             groups.
//   DFT       the columns in chunks of 256 (128 bins, re and im). A warp
//             holds 32 columns of the chunk (16 bins) for all M rows: each
//             thread R rows (tr + 4 i) x 4 columns (the re and im of bins tc
//             and tc + 8), a per-view partial and a running sum for each.
//             Per 4 k it reads 2 R + 8 float4 (x_hi, x_lo of its rows; d_hi,
//             d_lo of its columns) for 48 R FFMA. The tables arrive as one
//             stream of 16 KB stages ([2 runs of 4 k][d_hi, d_lo][256
//             columns][4 k] f32, the bf16 values widened once on the host
//             and laid out in the threads' column order, so 8 neighbouring
//             threads read 8 distinct 16-byte runs), identical for every
//             block, through a 4-stage ring: one lane of the producer warp
//             copies each stage with the bulk-copy (TMA) engine onto the
//             slot's `full` mbarrier, each consumer warp waits for it alone
//             and releases the slot on its `empty` mbarrier, so no block
//             barrier stands in the loop. The stream holds rows
//             k < padded only: the rows fbank_bf16x3.cu also walks past
//             padded are zero, and fmaf(x, 0, p) leaves p as it is up to the
//             sign of a zero, which re^2 and im^2 erase.
//   power     p = re * re + im * im, split to bf16 hi / lo (held as f32) into
//             [M][nfft] rows, each step rounded as fbank_bf16x3.cu rounds it.
//   mel       one filter and 4 rows a thread: s1 = fmaf(hi, mel_hi, s1),
//             s2 = fmaf(hi, mel_lo, s2), s3 = fmaf(lo, mel_hi, s3) over the
//             filter's own bins (`mel_bands`) in order, then
//             logf(fmaxf(K_EPS, (s1 + s2) + s3)). The bins outside a filter,
//             which fbank_bf16x3.cu also walks, have zero weights: they add
//             +0 to sums that start at +0 and never reach -0.
//
// Numerics: every f32 step is fbank_bf16x3.cu's, in its order, so the rows
// equal `fbank_bf16x3_simt`'s bit for bit, and the plain version's within the
// repo's fbank bound. No atomics, no fast-math. All-zero samples give exactly
// log(K_EPS).
//
// The tile, the ring and the shared memory are planned in Python by
// ops/fbank_kernels.py `bf16x3_plan`; the C entry recomputes the bytes and
// refuses a plan that disagrees. With `stamps`, thread 0 adds each phase's
// global-timer nanoseconds after a barrier of the consumer warps
// (tools/profile_fbank.py).

#include "common.cuh"
#include "mbar_ring.cuh"

#define T5_NT 256       // 8 consumer warps
#define T5_NC 256       // DFT columns a chunk: 128 bins, re and im
#define T5_SK 8         // k a stage: two runs of 4
#define T5_STAGE 16384  // bytes a ring stage: [2 runs][2 planes][256 columns][4 k] f32
#define T5_RING 4       // ring stages
#define T5_NSTAMP 6     // start, staging, DFT, power, mel (ns), end
#define T5_BARS 128     // bytes before the ring: its full and empty mbarriers
#define K_EPS 0x1p-23f

struct T5Args {
  const float* buf;          // [S][nbuf * shift]
  const float* tab;          // [chunks][padded / 8][4096] f32 stage stream
  const uint16_t* mel_hi;    // [nfft][bins] bf16
  const uint16_t* mel_lo;
  const int* mel_plan;       // [bins] first bin, [bins] end bin, ...
  float* out;                // [S * F][bins]
  unsigned long long* stamps;  // null, or [blocks][T5_NSTAMP]
  int S, nbuf, F, shift, padded, nfft, bins, H, pitch, nv;
};

// One stage of the table stream copied by the bulk-copy (TMA) engine onto
// its `full` mbarrier.
__device__ __forceinline__ void bulk_stage(float* dst, const float* src, uint64_t* bar) {
  mbar_expect(bar, T5_STAGE);
  bulk_copy(dst, src, T5_STAGE, bar);
}

// Adds the nanoseconds since the last mark to the block's slot k (slot 0:
// the start time; the last slot: the end time), after a consumer barrier.
__device__ __forceinline__ void mark(const T5Args& a, unsigned long long& last, int k) {
  if (a.stamps == nullptr) return;
  consumers_sync();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* row = a.stamps + (size_t)blockIdx.x * T5_NSTAMP;
    if (k == 0 || k == T5_NSTAMP - 1)
      row[k] = t;
    else
      row[k] += t - last;
    last = t;
  }
}

// One k of fbank_bf16x3.cu's three passes: x_hi.d_hi, x_hi.d_lo, x_lo.d_hi.
__device__ __forceinline__ float bf16x3_step(float pre, float a, float b, float dh, float dl) {
  return fmaf(b, dh, fmaf(a, dl, fmaf(a, dh, pre)));
}

template <int R>
__global__ void __launch_bounds__(T5_NT + 32, 1) fbank_tile_kernel(const T5Args a) {
  constexpr int M = 4 * R;
  extern __shared__ float4 smem_f4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_f4);             // [RING]
  uint64_t* empty = full + T5_RING;                                  // [RING]
  float* ring = reinterpret_cast<float*>(smem_f4) + T5_BARS / 4;    // [RING][4096]
  float* xs = ring + T5_RING * (T5_STAGE / 4);      // [H][pitch / 4][x_hi 4, x_lo 4]
  float* ph = xs + 2 * a.H * a.pitch;               // [M][nfft] power, bf16 hi
  float* pl = ph + M * a.nfft;                      // [M][nfft] power, bf16 lo

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SPC = a.padded / T5_SK, NCH = 2 * a.nfft / T5_NC, T = NCH * SPC;
  if (tid == 0) {
    for (int i = 0; i < T5_RING; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, T5_NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T5_NT / 32) {  // the producer warp: one lane streams the table
    if (lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int s = t % T5_RING;
        if (t >= T5_RING) mbar_wait(empty + s, (t / T5_RING - 1) & 1);
        bulk_stage(ring + s * (T5_STAGE / 4), a.tab + (size_t)t * (T5_STAGE / 4), full + s);
      }
    }
    return;
  }

  const int tr = lane >> 3, tc = lane & 7;
  unsigned long long last = 0;
  mark(a, last, 0);

  // the tile's rows: segment 0 holds frames f0.. of session s0, each later
  // segment frames 0.. of the next session, each with its n_views - 1 extra
  // hop rows
  const int R0 = blockIdx.x * M;
  const int nrows = min(M, a.S * a.F - R0);
  const int s0 = R0 / a.F, f0 = R0 - s0 * a.F;
  const int n0 = min(a.F - f0, nrows);
  const int nv1 = a.nv - 1, seg0 = n0 + nv1, segn = a.F + nv1;
  const int hops = nrows + (1 + (nrows - n0 + a.F - 1) / a.F) * nv1;
  const int q4 = a.shift >> 2, n4 = hops * q4, rs = 2 * a.pitch;  // rs: a hop row's floats
  for (int i = tid; i < n4; i += T5_NT) {
    const int r = i / q4, j = (i - r * q4) * 4;
    int s = s0, h = f0 + r;
    if (r >= seg0) {
      const int k = (r - seg0) / segn;
      s = s0 + 1 + k;
      h = r - seg0 - k * segn;
    }
    const float4 v = *reinterpret_cast<const float4*>(a.buf + ((size_t)s * a.nbuf + h) * a.shift + j);
    float4 hi, lo;
    hi.x = round_bf16(v.x); lo.x = round_bf16(__fsub_rn(v.x, hi.x));
    hi.y = round_bf16(v.y); lo.y = round_bf16(__fsub_rn(v.y, hi.y));
    hi.z = round_bf16(v.z); lo.z = round_bf16(__fsub_rn(v.z, hi.z));
    hi.w = round_bf16(v.w); lo.w = round_bf16(__fsub_rn(v.w, hi.w));
    *reinterpret_cast<float4*>(xs + r * rs + 2 * j) = hi;
    *reinterpret_cast<float4*>(xs + r * rs + 2 * j + 4) = lo;
  }

  // a tile row's hop row; rows past the tile read hop row 0 and are never
  // stored
  auto hop_of = [&](int i) {
    if (i < n0) return i;
    if (i >= nrows) return 0;
    const int k = (i - n0) / a.F;
    return seg0 + k * segn + (i - n0 - k * a.F);
  };
  const float* xr[R];  // this thread's rows tr + 4 i: their hop rows
#pragma unroll
  for (int i = 0; i < R; ++i) xr[i] = xs + hop_of(tr + 4 * i) * rs;
  // this thread's 4 columns of a stage: slot 32 warp + 8 j + tc
  const int slot = (32 * warp + tc) * 4;
  mark(a, last, 1);
  consumers_sync();  // the staged rows, for every consumer

  int t = 0;
  for (int ch = 0; ch < NCH; ++ch) {
    float acc[R][4], pre[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = pre[i][j] = 0.f;
    int kofs = 0, kin = 0;  // the stage's offset in a frame's hop rows; k within its view
    for (int st = 0; st < SPC; ++st, ++t) {
      const int sl = t % T5_RING;
      mbar_wait(full + sl, (t / T5_RING) & 1);
      const float* sg = ring + sl * (T5_STAGE / 4) + slot;
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // the stage's two runs of 4 k
        float4 dh[4], dl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dh[j] = *reinterpret_cast<const float4*>(sg + (2 * u) * 1024 + 32 * j);
          dl[j] = *reinterpret_cast<const float4*>(sg + (2 * u + 1) * 1024 + 32 * j);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float* x = xr[i] + kofs + 8 * u;
          const float4 xa = *reinterpret_cast<const float4*>(x);
          const float4 xb = *reinterpret_cast<const float4*>(x + 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float p = pre[i][j];
            p = bf16x3_step(p, xa.x, xb.x, dh[j].x, dl[j].x);
            p = bf16x3_step(p, xa.y, xb.y, dh[j].y, dl[j].y);
            p = bf16x3_step(p, xa.z, xb.z, dh[j].z, dl[j].z);
            p = bf16x3_step(p, xa.w, xb.w, dh[j].w, dl[j].w);
            pre[i][j] = p;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + sl);  // this warp is done with the stage
      kin += T5_SK;
      kofs += 2 * T5_SK;
      if (kin == a.shift || st == SPC - 1) {  // a view ends: add its sums in turn
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = __fadd_rn(acc[i][j], pre[i][j]);
            pre[i][j] = 0.f;
          }
        kofs += rs - 2 * kin;
        kin = 0;
      }
    }
    mark(a, last, 2);
    // the power of this thread's bins b (columns 0, 1) and b + 8 (2, 3)
    const int b = ch * (T5_NC / 2) + 16 * warp + tc;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float re = acc[i][2 * e], im = acc[i][2 * e + 1];
        const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        const float hi = round_bf16(p);
        const int at = (tr + 4 * i) * a.nfft + b + 8 * e;
        ph[at] = hi;
        pl[at] = round_bf16(__fsub_rn(p, hi));
      }
    mark(a, last, 3);
  }
  consumers_sync();

  // the mel: one filter and 4 rows a thread, over the filter's own bins
  const int* mel_first = a.mel_plan;
  const int* mel_end = mel_first + a.bins;
  for (int it = tid; it < R * a.bins; it += T5_NT) {
    const int g = it / a.bins, m = it - g * a.bins;
    const float* hr = ph + 4 * g * a.nfft;
    const float* lr = pl + 4 * g * a.nfft;
    float s1[4], s2[4], s3[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) s1[q] = s2[q] = s3[q] = 0.f;
    for (int j = __ldg(mel_first + m), je = __ldg(mel_end + m); j < je; ++j) {
      const float mh = bf16_to_f32(__ldg(a.mel_hi + j * a.bins + m));
      const float ml = bf16_to_f32(__ldg(a.mel_lo + j * a.bins + m));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float h = hr[q * a.nfft + j], l = lr[q * a.nfft + j];
        s1[q] = fmaf(h, mh, s1[q]);
        s2[q] = fmaf(h, ml, s2[q]);
        s3[q] = fmaf(l, mh, s3[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * g + q < nrows)
        a.out[(size_t)(R0 + 4 * g + q) * a.bins + m] =
            logf(fmaxf(K_EPS, __fadd_rn(__fadd_rn(s1[q], s2[q]), s3[q])));
  }
  mark(a, last, 4);
  mark(a, last, T5_NSTAMP - 1);
}

// Dynamic shared-memory bytes of a block of 4 R rows that stages at most H
// hop rows (the sum ops/fbank_kernels.py `bf16x3_smem` computes).
static size_t t5_smem(int R, int H, int pitch, int nfft) {
  return T5_BARS + (size_t)T5_RING * T5_STAGE +
         2 * sizeof(float) * ((size_t)H * pitch + (size_t)4 * R * nfft);
}

template <int R>
static int t5_launch(const T5Args& a, int blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(fbank_tile_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  fbank_tile_kernel<R><<<blocks, T5_NT + 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() of the launch; -1 for a shape the kernel does
// not take, -2 where the plan's shared-memory bytes differ from this file's.
extern "C" int fbank_bf16x3_tile(const float* buf, const float* tab, const void* mel_hi,
                                 const void* mel_lo, const int* mel_plan, float* out, void* stamps,
                                 int S, int nbuf, int F, int shift, int padded, int nfft, int bins,
                                 int R, int H, int smem, void* stream) {
  if (shift % 8 || padded % T5_SK || nfft % (T5_NC / 2) || bins < 1 || S < 1 || F < 1) return -1;
  if (R != 6 && R != 7) return -1;
  T5Args a;
  a.buf = buf; a.tab = tab;
  a.mel_hi = (const uint16_t*)mel_hi; a.mel_lo = (const uint16_t*)mel_lo; a.mel_plan = mel_plan;
  a.out = out; a.stamps = (unsigned long long*)stamps;
  a.S = S; a.nbuf = nbuf; a.F = F; a.shift = shift; a.padded = padded; a.nfft = nfft;
  a.bins = bins; a.H = H;
  a.pitch = (shift / 4) % 2 ? shift : shift + 4;
  a.nv = (padded + shift - 1) / shift;
  const size_t need = t5_smem(R, H, a.pitch, nfft);
  if ((size_t)smem != need) return -2;
  const int blocks = (S * F + 4 * R - 1) / (4 * R);
  cudaStream_t st = (cudaStream_t)stream;
  return R == 6 ? t5_launch<6>(a, blocks, need, st) : t5_launch<7>(a, blocks, need, st);
}
