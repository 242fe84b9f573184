// Kernel 1: the int8 engines' fbank frame DSP (hop-row buffer -> log-mel
// rows) for the H100: the int8 DFT planes on the tensor cores, the bf16
// residual and the mel on the CUDA cores in the CUDA-core kernel's order.
//
// Replaces april_asr_tpu/ops/fbank_pallas.py `logmel_rows_from_buf_i8`
// (`_buf_kernel_i8`). The CUDA-core kernel it displaces stays as
// `fbank_i8_simt` (csrc/fbank_i8.cu) for the shapes no plan holds; the rows
// of the two are equal bit for bit.
//
// The function is three products per frame row, contracted over the padded
// window K (512 at 16 kHz): the sample planes a = floor(pcm / 256) and
// b = rint(pcm - 256 a) - 128 (int8, exact) against the int8 hi plane of the
// folded DFT (2 x 2 nfft columns, int32), the bf16-rounded samples against
// its bf16 residual (f32), then the power spectrum's bf16 hi / lo halves
// against the mel filters' (bf16x3, f32), and log(max(K_EPS, .)).
//
// Bound on the H100: operations. At S = 256, F = 101 the int8 products are
// 27 G operations (13.7 us at the int8 peak), the residual 13.6 G and the mel
// 3.2 G at bf16 (17 us); the buffer read once and the rows written once are
// 25 MB (7.6 us). What this design pays for equal bits: the residual's f32
// sums stay sequential in k (fbank_i8.cu's fmaf chain), so its 6.8 G
// multiply-adds run on the CUDA cores (~0.2 ms at the f32 rate). Any other
// order moves ~5% of the spectrum's values by an ulp, and the int8 encoder
// turns those into decisions that part from the CUDA-core kernel's.
//
// Design. One block of 8 warps takes M = 128 consecutive rows of the
// flattened [S * F] frame list (a tile may span sessions):
//   staging   the hop rows its frames span (each session's frames f0..f1
//             need hops f0..f1 + n_views - 1) are read once, split into the
//             three planes (a8, b8 int8; xb bf16) and stored as [hop][pitch]
//             rows: frame f's window is hop rows f.. at column 0, so a frame
//             matrix is never formed. Every 16-byte run of a window lies in
//             one hop row (shift % 16 == 0), so each lane of `ldmatrix` gives
//             its own frame's address; the pitch (shift, or shift + 16
//             bytes) makes 8 consecutive frames' runs fall in 8 distinct
//             16-byte bank groups.
//   int8      per chunk of 64 DFT columns (32 bins, re at 2j, im at 2j + 1,
//             so one accumulator pair holds a bin's re and im): `mma.sync`
//             m16n8k32 s8 -> s32 over K, planes a and b into separate int32
//             accumulators, folded to hs = (f32(acc_a) * 256 + f32(acc_b) +
//             corr) * s_hi. Warps are 4 (rows) x 2 (columns) of 32 x 32.
//   residual  on the CUDA cores, each thread on the rows and columns its
//             `mma.sync` accumulators hold (4 rows x 8 columns): for k = 0,
//             1, .. K - 1 in turn, acc = fmaf(x, r, acc), as fbank_i8.cu. The
//             k-steps past K that fbank_i8.cu also takes (its whole views)
//             multiply zero rows and leave each sum as it is.
//             The tables arrive as one stream of 8 KB stages per chunk, the
//             int8 ones ([64 columns][128 k], k-contiguous per column as
//             `ldmatrix` wants, 16-byte runs XOR-swizzled by column) then the
//             residual's f32 ones ([8 runs of 4 k][64 columns][4 k], so that
//             the 4 columns a warp reads at once fill 4 bank groups and each
//             read is a base register plus a constant), laid out once on the
//             host (`fbank_constants`) and identical for every block, through
//             a 4-stage cp.async ring.
//   power     re = hs + acc_r, power = re * re + im * im, split to bf16
//             hi / lo into a window of shared memory that holds two chunks'
//             bins, each step rounded as fbank_i8.cu rounds it.
//   mel       the mel bins whose filter ends in this chunk (every filter
//             spans at most two chunks: `fbank_plan`), one filter and 8 rows
//             a thread: s1 = fmaf(hi, mel_hi, s1), s2 = fmaf(hi, mel_lo, s2),
//             s3 = fmaf(lo, mel_hi, s3) over the filter's bins in order, then
//             logf(fmaxf(K_EPS, (s1 + s2) + s3)) for rows below S * F. The
//             bins outside a filter, which fbank_i8.cu also walks, have zero
//             weights: they add +0 to sums that start at +0 and never reach
//             -0, so leaving them out leaves every sum as it is.
//
// Numerics: the int8 dots are exact in any order and every f32 step is
// fbank_i8.cu's, in its order: the rows equal the CUDA-core kernel's bit for
// bit, and the plain version's within the repo's fbank bound. No atomics.
// All-zero samples give exactly log(K_EPS): acc_b = -128 colsum(dhi) =
// -corr. No fast-math.
//
// The tile, the ring and the shared memory are planned in Python by
// ops/fbank_kernels.py `fbank_plan`; the C entry recomputes the bytes and
// refuses a plan that disagrees. With `stamps`, thread 0 adds each phase's
// global-timer nanoseconds after a block barrier (tools/profile_fbank.py).

#include "common.cuh"
#include "mma_tc.cuh"

#define FB_M 128       // frame rows a block
#define FB_NT 256      // 8 warps: 4 (rows) x 2 (columns)
#define FB_NC 64       // DFT columns a chunk
#define FB_STAGE 8192  // bytes a ring stage: [64 columns][128 bytes]
#define FB_RING 4      // ring stages
#define FB_PW 72       // bf16 pitch of a power row: two chunks' 32 bins + 8
#define FB_SPLIT 8     // sample vectors a thread loads before it splits them
#define FB_NSTAMP 7    // start, staging, int8, residual, power, mel (ns), end
#define K_EPS 0x1p-23f

struct FbArgs {
  const float* buf;          // [S][nbuf * shift]
  const uint8_t* tc;         // [chunks][K / 128 + K / 32][8192 bytes] stage stream
  const float* shi;          // [2 nfft], columns interleaved
  const float* corr;         // [2 nfft], columns interleaved
  const uint16_t* mel_hi;    // [nfft][bins] bf16
  const uint16_t* mel_lo;
  const int* mel_plan;       // [bins] first bin, [bins] end bin, [bins] mel bins by
                             // the chunk their filter ends in, [chunks + 1] offsets
  float* out;                // [S * F][bins]
  unsigned long long* stamps;  // null, or [blocks][FB_NSTAMP]
  int S, nbuf, F, shift, K, nfft, bins, H, p8, pb, nv;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Adds the nanoseconds since the last mark to the block's slot k (slot 0:
// the start time; the last slot: the end time), after a block barrier.
__device__ __forceinline__ void mark(const FbArgs& a, unsigned long long& last, int k) {
  if (a.stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* row = a.stamps + (size_t)blockIdx.x * FB_NSTAMP;
    if (k == 0 || k == FB_NSTAMP - 1)
      row[k] = t;
    else
      row[k] += t - last;
    last = t;
  }
}

// One sample's planes, as fbank_i8.cu splits it: a = floor(pcm / 256),
// b = rint(pcm - 256 a) - 128 clipped to int8, and the bf16-rounded sample.
__device__ __forceinline__ void split(float v, uint32_t& a, uint32_t& b, uint32_t& x) {
  const float pcm = __fmul_rn(v, 32768.f);
  const float af = floorf(__fmul_rn(pcm, 0x1p-8f));
  const float bf = fminf(fmaxf(__fsub_rn(rintf(__fsub_rn(pcm, __fmul_rn(256.f, af))), 128.f),
                               -128.f), 127.f);
  a = (uint32_t)(int)af & 0xffu;
  b = (uint32_t)(int)bf & 0xffu;
  x = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(FB_NT, 1) fbank_mma_kernel(const FbArgs a) {
  extern __shared__ uint4 smem_u4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_u4);
  uint16_t* ph = reinterpret_cast<uint16_t*>(ring + FB_RING * FB_STAGE);  // [M][PW] power hi
  uint16_t* pl = ph + FB_M * FB_PW;                                       // [M][PW] power lo
  uint16_t* xb = pl + FB_M * FB_PW;                                       // [H][pb] samples
  uint8_t* a8 = reinterpret_cast<uint8_t*>(xb + (size_t)a.H * a.pb);      // [H][p8]
  uint8_t* b8 = a8 + (size_t)a.H * a.p8;                                  // [H][p8]
  int* ko8 = reinterpret_cast<int*>(b8 + (size_t)a.H * a.p8);  // 16-sample run -> offset
  int* kob = ko8 + a.K / 16;                                   // 8-sample run -> offset

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int S8 = a.K / 128, SR = a.K / 32, NCH = 2 * a.nfft / FB_NC, T = NCH * (S8 + SR);
  unsigned long long last = 0;
  mark(a, last, 0);

  // the first stages of the table stream, in flight during the staging
  auto load_stage = [&](int t) {
    const uint8_t* src = a.tc + (size_t)t * FB_STAGE;
    uint8_t* dst = ring + (t % FB_RING) * FB_STAGE;
#pragma unroll
    for (int i = 0; i < FB_STAGE / 16 / FB_NT; ++i) {
      const int off = (tid + i * FB_NT) * 16;
      cp_async16(dst + off, src + off);
    }
  };
#pragma unroll
  for (int t = 0; t < FB_RING - 1; ++t) {
    if (t < T) load_stage(t);
    cp_commit();
  }

  // the tile's rows: segment 0 holds frames f0.. of session s0, each later
  // segment frames 0.. of the next session, each with its n_views - 1 extra
  // hop rows
  const int R0 = blockIdx.x * FB_M;
  const int nrows = min(FB_M, a.S * a.F - R0);
  const int s0 = R0 / a.F, f0 = R0 - s0 * a.F;
  const int n0 = min(a.F - f0, nrows);
  const int nv1 = a.nv - 1, seg0 = n0 + nv1, segn = a.F + nv1;
  const int hops = nrows + (1 + (nrows - n0 + a.F - 1) / a.F) * nv1;
  // FB_SPLIT vectors of 4 samples in flight a thread, then split and stored
  const int q4 = a.shift >> 2, n4 = hops * q4;
  for (int i0 = tid; i0 < n4; i0 += FB_SPLIT * FB_NT) {
    float4 v[FB_SPLIT];
    int hr[FB_SPLIT], col[FB_SPLIT];
#pragma unroll
    for (int u = 0; u < FB_SPLIT; ++u) {
      const int i = i0 + u * FB_NT;
      hr[u] = -1;
      if (i < n4) {
        const int r = i / q4, j = (i - r * q4) * 4;
        int s = s0, h = f0 + r;
        if (r >= seg0) {
          const int k = (r - seg0) / segn;
          s = s0 + 1 + k;
          h = r - seg0 - k * segn;
        }
        v[u] = *reinterpret_cast<const float4*>(a.buf + ((size_t)s * a.nbuf + h) * a.shift + j);
        hr[u] = r;
        col[u] = j;
      }
    }
#pragma unroll
    for (int u = 0; u < FB_SPLIT; ++u) {
      if (hr[u] < 0) continue;
      uint32_t av[4], bv[4], xv[4];
      split(v[u].x, av[0], bv[0], xv[0]);
      split(v[u].y, av[1], bv[1], xv[1]);
      split(v[u].z, av[2], bv[2], xv[2]);
      split(v[u].w, av[3], bv[3], xv[3]);
      const int o8 = hr[u] * a.p8 + col[u], ob = hr[u] * a.pb + col[u];
      *reinterpret_cast<uint32_t*>(a8 + o8) = av[0] | av[1] << 8 | av[2] << 16 | av[3] << 24;
      *reinterpret_cast<uint32_t*>(b8 + o8) = bv[0] | bv[1] << 8 | bv[2] << 16 | bv[3] << 24;
      *reinterpret_cast<uint2*>(xb + ob) = make_uint2(xv[0] | xv[1] << 16, xv[2] | xv[3] << 16);
    }
  }
  for (int u = tid; u < a.K / 16; u += FB_NT) ko8[u] = (16 * u / a.shift) * a.p8 + 16 * u % a.shift;
  for (int u = tid; u < a.K / 8; u += FB_NT) kob[u] = (8 * u / a.shift) * a.pb + 8 * u % a.shift;

  // a tile row's hop row; rows past the tile read hop row 0 and are never
  // stored
  auto hop_of = [&](int i) {
    if (i < n0) return i;
    if (i >= nrows) return 0;
    const int k = (i - n0) / a.F;
    return seg0 + k * segn + (i - n0 - k * a.F);
  };
  // this lane's int8 A rows (ldmatrix: lanes 8i..8i+7 address matrix i =
  // rows 0-7 / 8-15 x k-half 0 / 1) and its accumulator rows (32 wm + 16 mf
  // + 8 h + g), as hop-row offsets
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, khalf = lane >> 4;
  int hb8[2], rb[2][2];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    hb8[mf] = hop_of(32 * wm + 16 * mf + lrow) * a.p8;
#pragma unroll
    for (int h = 0; h < 2; ++h) rb[mf][h] = hop_of(32 * wm + 16 * mf + 8 * h + g) * a.pb;
  }
  // this lane's B rows in an int8 stage (matrices: n-tile 2p, k-run 0 / 1,
  // then n-tile 2p + 1) and its swizzle key
  const int br = lane & 7, bc = (lane >> 3) & 1;
  int boff[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) boff[p] = (32 * wn + 16 * p + 8 * (lane >> 4) + br) * 128;
  // this lane's columns in a residual stage: run u of column 32 wn + 8 nf +
  // 2 q + e at byte u * 1024 + 16 * column
  const int wcol = (32 * wn + 2 * q) * 16;
  const int* mel_first = a.mel_plan;
  const int* mel_end = mel_first + a.bins;
  const int* mel_order = mel_end + a.bins;
  const int* mel_off = mel_order + a.bins;
  mark(a, last, 1);

  // the next stage of the stream: wait for it, release the slot the
  // previous stage used, and put the stage FB_RING - 1 ahead in flight
  int t = 0;
  auto next_stage = [&]() -> const uint8_t* {
    cp_wait<FB_RING - 2>();
    __syncthreads();
    if (t + FB_RING - 1 < T) load_stage(t + FB_RING - 1);
    cp_commit();
    return ring + (t++ % FB_RING) * FB_STAGE;
  };

  for (int c = 0; c < NCH; ++c) {
    // corr and s_hi of this lane's column pairs (re, im), read before the
    // products so that the fold does not wait for them
    float cr[4][2], sh[4][2];
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      const int col = c * FB_NC + 32 * wn + 8 * nf + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cr[nf][e] = __ldg(a.corr + col + e);
        sh[nf][e] = __ldg(a.shi + col + e);
      }
    }
    float hs[2][4][4];
    {
      int ia[2][4][4], ib[2][4][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) ia[mf][nf][e] = ib[mf][nf][e] = 0;
      for (int j = 0; j < S8; ++j) {
        const uint8_t* st = next_stage();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ko = ko8[8 * j + 2 * kk + khalf];
          uint32_t bf[2][4];
#pragma unroll
          for (int p = 0; p < 2; ++p) ldmatrix_x4(bf[p], st + boff[p] + (((2 * kk + bc) ^ br) << 4));
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            uint32_t fa[4], fb[4];
            ldmatrix_x4(fa, a8 + hb8[mf] + ko);
            ldmatrix_x4(fb, b8 + hb8[mf] + ko);
#pragma unroll
            for (int nf = 0; nf < 4; ++nf) {
              const uint32_t b0 = bf[nf >> 1][2 * (nf & 1)], b1 = bf[nf >> 1][2 * (nf & 1) + 1];
              mma_s8_16832(ia[mf][nf], fa, b0, b1);
              mma_s8_16832(ib[mf][nf], fb, b0, b1);
            }
          }
        }
      }
      // fold: hs = (f32(acc_a) * 256 + f32(acc_b) + corr) * s_hi
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float hre = __fadd_rn(
                __fadd_rn(__fmul_rn((float)ia[mf][nf][e], 256.f), (float)ib[mf][nf][e]),
                cr[nf][e & 1]);
            hs[mf][nf][e] = __fmul_rn(hre, sh[nf][e & 1]);
          }
    }
    mark(a, last, 2);
    // the residual, k in order: rr[mf][nf][2h + e] is row 32 wm + 16 mf +
    // 8 h + g, column 32 wn + 8 nf + 2 q + e (the accumulator layout of hs)
    float rr[2][4][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) rr[mf][nf][e] = 0.f;
    for (int jr = 0; jr < SR; ++jr) {
      const uint8_t* st = next_stage();
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // 4-k runs of the stage's 32 k
        const int ko = kob[4 * jr + (u >> 1)] + 4 * (u & 1);
        float x[2][2][4], w[4][2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 v = *reinterpret_cast<const uint2*>(xb + rb[mf][h] + ko);
            x[mf][h][0] = __uint_as_float(v.x << 16);
            x[mf][h][1] = __uint_as_float(v.x & 0xffff0000u);
            x[mf][h][2] = __uint_as_float(v.y << 16);
            x[mf][h][3] = __uint_as_float(v.y & 0xffff0000u);
          }
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 v =
                *reinterpret_cast<const float4*>(st + wcol + u * 1024 + (8 * nf + e) * 16);
            w[nf][e][0] = v.x;
            w[nf][e][1] = v.y;
            w[nf][e][2] = v.z;
            w[nf][e][3] = v.w;
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mf = 0; mf < 2; ++mf)
#pragma unroll
            for (int nf = 0; nf < 4; ++nf)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  rr[mf][nf][2 * h + e] = fmaf(x[mf][h][kk], w[nf][e][kk], rr[mf][nf][2 * h + e]);
      }
    }
    mark(a, last, 3);
    // the power of this warp's 16 bins, split to bf16 hi / lo into the
    // window's half for this chunk (last read by chunk c - 2's mel, before
    // this chunk's first stage barrier)
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = __fadd_rn(hs[mf][nf][2 * h], rr[mf][nf][2 * h]);
          const float im = __fadd_rn(hs[mf][nf][2 * h + 1], rr[mf][nf][2 * h + 1]);
          const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
          const __nv_bfloat16 hi = __float2bfloat16_rn(p);
          const int at = (32 * wm + 16 * mf + g + 8 * h) * FB_PW + 32 * (c & 1) + 16 * wn + 4 * nf + q;
          ph[at] = __bfloat16_as_ushort(hi);
          pl[at] = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(p, __bfloat162float(hi))));
        }
    __syncthreads();
    mark(a, last, 4);
    // the mel bins whose filter ends in this chunk: bin j sits at window
    // column j % 64
    const int m0 = __ldg(mel_off + c), nm = __ldg(mel_off + c + 1) - m0;
    for (int it = tid; it < ((nrows + 7) >> 3) * nm; it += FB_NT) {
      const int r0 = it / nm, m = __ldg(mel_order + m0 + it - r0 * nm);
      const uint16_t* hr = ph + 8 * r0 * FB_PW;
      const uint16_t* lr = pl + 8 * r0 * FB_PW;
      float s1[8], s2[8], s3[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s1[i] = s2[i] = s3[i] = 0.f;
      for (int j = __ldg(mel_first + m), je = __ldg(mel_end + m); j < je; ++j) {
        const float mh = bf16_to_f32(__ldg(a.mel_hi + j * a.bins + m));
        const float ml = bf16_to_f32(__ldg(a.mel_lo + j * a.bins + m));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float h = bf16_to_f32(hr[i * FB_PW + (j & 63)]);
          const float l = bf16_to_f32(lr[i * FB_PW + (j & 63)]);
          s1[i] = fmaf(h, mh, s1[i]);
          s2[i] = fmaf(h, ml, s2[i]);
          s3[i] = fmaf(l, mh, s3[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (8 * r0 + i < nrows)
          a.out[(size_t)(R0 + 8 * r0 + i) * a.bins + m] =
              logf(fmaxf(K_EPS, __fadd_rn(__fadd_rn(s1[i], s2[i]), s3[i])));
    }
    mark(a, last, 5);
  }
  cp_wait<0>();
  mark(a, last, FB_NSTAMP - 1);
}

// Shared-memory bytes of a block that stages at most H hop rows (the sum
// ops/fbank_kernels.py `fbank_smem` computes).
static size_t fbank_smem(int H, int p8, int pb, int K) {
  return (size_t)FB_RING * FB_STAGE + 2 * (size_t)FB_M * FB_PW * 2 + (size_t)H * (2 * pb + 2 * p8)
         + 4 * (size_t)(K / 16 + K / 8);
}

// Returns cudaGetLastError() of the launch; -1 for a shape the kernel does
// not take, -2 where the plan's shared-memory bytes differ from this file's.
extern "C" int fbank_mma(const float* buf, const uint8_t* tc, const float* shi, const float* corr,
                         const void* mel_hi, const void* mel_lo, const int* mel_plan, float* out,
                         void* stamps, int S, int nbuf, int F, int shift, int padded, int nfft,
                         int bins, int H, int smem, void* stream) {
  if (shift % 16 || padded % 128 || nfft % 32 || bins < 1 || S < 1 || F < 1) return -1;
  FbArgs a;
  a.buf = buf; a.tc = tc; a.shi = shi; a.corr = corr;
  a.mel_hi = (const uint16_t*)mel_hi; a.mel_lo = (const uint16_t*)mel_lo; a.mel_plan = mel_plan;
  a.out = out; a.stamps = (unsigned long long*)stamps;
  a.S = S; a.nbuf = nbuf; a.F = F; a.shift = shift; a.K = padded; a.nfft = nfft; a.bins = bins;
  a.H = H;
  a.p8 = (shift / 16) % 2 ? shift : shift + 16;
  a.pb = (shift / 8) % 2 ? shift : shift + 8;
  a.nv = (padded + shift - 1) / shift;
  const size_t need = fbank_smem(H, a.p8, a.pb, padded);
  if ((size_t)smem != need) return -2;
  cudaError_t err = allow_smem(fbank_mma_kernel, need);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (S * F + FB_M - 1) / FB_M;
  fbank_mma_kernel<<<blocks, FB_NT, need, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
