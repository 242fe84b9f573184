// Kernel 6: the fbank frame DSP on frames formed beforehand ([S, F, padded]
// -> log-mel rows [S, F, bins]) for the H100, on the CUDA cores, bit for bit
// the kernel it replaces.
//
// Replaces april_asr_tpu/ops/fbank_pallas.py `logmel_rows_fused` (`_kernel`).
// The CUDA-core kernel it displaces stays as `fbank_frames_simt`
// (csrc/fbank_bf16x3.cu `fbank_frames`) for the shapes no plan holds; the
// rows of the two are equal bit for bit.
//
// The function, per frame row: the DFT as one f32 product with the folded
// DFT [padded, 2 nfft] (the TPU kernel's HIGHEST precision; DC removal,
// pre-emphasis and window folded in), power = re^2 + im^2 split to bf16 hi
// / lo, the bf16x3 mel (hi.mel_hi + hi.mel_lo + lo.mel_hi), log(max(K_EPS,
// .)). fbank_bf16x3.cu computes each (row, column) as one fmaf chain from +0
// over k = 0 .. padded - 1 in order; the products are of two f32 values and
// not exact, so any other order (the tensor cores' among them) moves the
// rows, and the chains stay on the CUDA cores.
//
// Bound on the H100: operations, the padded x 2 nfft f32 multiply-adds a
// frame: 6.78 G at S = 256, F = 101 (16 kHz), 0.202 ms at the f32 FMA rate.
//
// Design: kernel 5's (csrc/fbank_bf16x3_tile.cu) with one plane. One block
// of 8 consumer warps and a producer warp takes M consecutive rows of the
// flattened [S * F] frame matrix (a tile may span sessions; M = WR x 4 R,
// R = 6..9 the rows a thread holds, chosen by the plan so that the tiles
// fill the SMs' waves; with 9 warps a block a thread has 168 registers, and
// R = 10 spills):
//   staging   one lane of the producer warp copies each of the tile's rows
//             (padded floats) by bulk copy (TMA) onto one mbarrier, at a row
//             pitch of padded + 4 floats, an odd number of 16-byte runs, so
//             4 consecutive rows' float4 reads fall in 4 distinct bank
//             groups; rows past the last frame are not copied, and their
//             results are never stored.
//   DFT       the 2 nfft columns (256 or 512) in one chunk: WC = 2 nfft / 64
//             warps across the columns, WR = 8 / WC across the rows. A warp
//             holds 64 columns (32 bins, re and im) for 4 R rows: each thread
//             R rows (tr + 4 i) x 8 columns (the re and im of bins tc, tc + 8,
//             tc + 16, tc + 24 of its warp's 32), one running sum each. Per 4
//             k it reads R + 8 float4 (its rows' x, its columns' d) for 32 R
//             FFMA, three times kernel 5's share of loads, bought with the
//             registers x_lo and d_lo left free. The table arrives as one
//             stream of stages of 8 k ([2 runs of 4 k][2 nfft slots][4 k]
//             f32, laid out in the threads' column order, so 8 neighbouring
//             threads read 8 distinct 16-byte runs), identical for every
//             block, through kernel 5's 4-stage ring (csrc/mbar_ring.cuh): one
//             lane of the producer warp copies each stage onto its slot's
//             `full` mbarrier, each consumer warp releases it on its `empty`
//             one.
//   power     p = re * re + im * im, split to bf16 hi / lo (held as f32) into
//             [M][nfft] rows in the frames' space, which every warp has done
//             reading, each step rounded as fbank_bf16x3.cu rounds it.
//   mel       kernel 5's: one filter and 4 rows a thread, over the filter's
//             own bins (`mel_bands`) in order, then logf(fmaxf(K_EPS, (s1 +
//             s2) + s3)); the bins outside a filter, which fbank_bf16x3.cu
//             also walks, have zero weights and add +0 to sums that start at
//             +0 and never reach -0.
//
// Numerics: every f32 step is fbank_bf16x3.cu's `fbank_frames_kernel`, in
// its order, so the rows equal `fbank_frames_simt`'s bit for bit, and the
// plain version's within the repo's fbank bound. No atomics, no fast-math.
// All-zero frames give exactly log(K_EPS).
//
// The tile and the shared memory are planned in Python by
// ops/fbank_kernels.py `frames_plan`, the stream laid out by `t6_stream`;
// the C entry recomputes the bytes and refuses a plan that disagrees. With
// `stamps`, thread 0 adds each phase's global-timer nanoseconds after a
// barrier of the consumer warps (tools/profile_fbank.py).

#include "common.cuh"
#include "mbar_ring.cuh"

#define T6_NT 256     // 8 consumer warps
#define T6_SK 8       // k a stage: two runs of 4
#define T6_RING 4     // ring stages
#define T6_NSTAMP 6   // start, staging, DFT, power, mel (ns), end
#define T6_BARS 128   // bytes before the ring: its full, empty and frames mbarriers
#define K_EPS 0x1p-23f

struct T6Args {
  const float* frames;         // [rows][padded]
  const float* tab;            // [padded / 8 stages][2 runs][2 nfft slots][4 k] f32
  const uint16_t* mel_hi;      // [nfft][bins] bf16
  const uint16_t* mel_lo;
  const int* mel_plan;         // [bins] first bin, [bins] end bin, ...
  float* out;                  // [rows][bins]
  unsigned long long* stamps;  // null, or [blocks][T6_NSTAMP]
  int rows, padded, nfft, bins, pitch;
};

// Adds the nanoseconds since the last mark to the block's slot k (slot 0:
// the start time; the last slot: the end time), after a consumer barrier.
__device__ __forceinline__ void mark(const T6Args& a, unsigned long long& last, int k) {
  if (a.stamps == nullptr) return;
  consumers_sync();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* row = a.stamps + (size_t)blockIdx.x * T6_NSTAMP;
    if (k == 0 || k == T6_NSTAMP - 1)
      row[k] = t;
    else
      row[k] += t - last;
    last = t;
  }
}

template <int R>
__global__ void __launch_bounds__(T6_NT + 32, 1) fbank_frames_tile_kernel(const T6Args a) {
  extern __shared__ float4 smem_f4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_f4);          // [RING]
  uint64_t* empty = full + T6_RING;                               // [RING]
  uint64_t* xbar = empty + T6_RING;                               // the frames' copies
  const int NC = 2 * a.nfft, ST = T6_SK * NC;                     // columns; floats a stage
  float* ring = reinterpret_cast<float*>(smem_f4) + T6_BARS / 4;  // [RING][ST]
  float* xs = ring + T6_RING * ST;  // [M][pitch] frames; then [M][nfft] power hi, lo
  float* ph = xs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int WC = NC / 64, WR = (T6_NT / 32) / WC, M = WR * 4 * R;
  float* pl = ph + M * a.nfft;
  const int R0 = blockIdx.x * M, nrows = min(M, a.rows - R0);
  const int T = a.padded / T6_SK;
  if (tid == 0) {
    for (int i = 0; i < T6_RING; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, T6_NT / 32);
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == T6_NT / 32) {  // the producer warp: one lane copies the rows, then the table
    if (lane == 0) {
      const unsigned rb = (unsigned)a.padded * 4;
      mbar_expect(xbar, (unsigned)nrows * rb);
      for (int r = 0; r < nrows; ++r)
        bulk_copy(xs + r * a.pitch, a.frames + (size_t)(R0 + r) * a.padded, rb, xbar);
      for (int t = 0; t < T; ++t) {
        const int s = t % T6_RING;
        if (t >= T6_RING) mbar_wait(empty + s, (t / T6_RING - 1) & 1);
        mbar_expect(full + s, ST * 4);
        bulk_copy(ring + s * ST, a.tab + (size_t)t * ST, ST * 4, full + s);
      }
    }
    return;
  }

  const int tr = lane >> 3, tc = lane & 7, wc = warp % WC, wr = warp / WC;
  unsigned long long last = 0;
  mark(a, last, 0);
  mbar_wait(xbar, 0);
  mark(a, last, 1);

  const float* xr = xs + (wr * 4 * R + tr) * a.pitch;  // row tr + 4 i at xr + 4 i pitch
  const int slot = (64 * wc + tc) * 4;  // this thread's column j: slot 64 wc + 8 j + tc
  float acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < T; ++t) {
    const int sl = t % T6_RING;
    mbar_wait(full + sl, (t / T6_RING) & 1);
    const float* sg = ring + sl * ST + slot;
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // the stage's two runs of 4 k
      float4 d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = *reinterpret_cast<const float4*>(sg + u * 4 * NC + 32 * j);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xr + 4 * i * a.pitch + T6_SK * t + 4 * u);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p = acc[i][j];
          p = fmaf(x.x, d[j].x, p);
          p = fmaf(x.y, d[j].y, p);
          p = fmaf(x.z, d[j].z, p);
          p = fmaf(x.w, d[j].w, p);
          acc[i][j] = p;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + sl);  // this warp is done with the stage
  }
  mark(a, last, 2);
  consumers_sync();  // every warp is done with the frames: their space takes the power

  // the power of this thread's bins 32 wc + 8 q + tc (columns 2 q, 2 q + 1)
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float re = acc[i][2 * q], im = acc[i][2 * q + 1];
      const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      const float hi = round_bf16(p);
      const int at = (wr * 4 * R + tr + 4 * i) * a.nfft + 32 * wc + 8 * q + tc;
      ph[at] = hi;
      pl[at] = round_bf16(__fsub_rn(p, hi));
    }
  mark(a, last, 3);
  consumers_sync();

  // the mel: one filter and 4 rows a thread, over the filter's own bins
  const int* mel_first = a.mel_plan;
  const int* mel_end = mel_first + a.bins;
  for (int it = tid; it < (M / 4) * a.bins; it += T6_NT) {
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
  mark(a, last, T6_NSTAMP - 1);
}

// Dynamic shared-memory bytes of a block of M rows (the sum
// ops/fbank_kernels.py `frames_smem` computes): the mbarriers, the ring, and
// the frames' rows, whose space the power rows (hi, lo) reuse.
static size_t t6_smem(int M, int padded, int nfft) {
  const size_t xb = (size_t)M * (padded + 4) * 4, pb = (size_t)M * nfft * 8;
  return T6_BARS + (size_t)T6_RING * T6_SK * 2 * nfft * 4 + (xb > pb ? xb : pb);
}

template <int R>
static int t6_launch(const T6Args& a, int blocks, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(fbank_frames_tile_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  fbank_frames_tile_kernel<R><<<blocks, T6_NT + 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 6 on a plan of `frames_plan`: `rows` = S * F frames of `padded`
// samples, R the rows a thread holds. Returns cudaGetLastError() of the
// launch; -1 for a shape the kernel does not take, -2 where the plan's
// shared-memory bytes differ from this file's.
extern "C" int fbank_frames_tile(const float* frames, const float* tab, const void* mel_hi,
                                 const void* mel_lo, const int* mel_plan, float* out, void* stamps,
                                 int rows, int padded, int nfft, int bins, int R, int smem,
                                 void* stream) {
  if (padded % T6_SK || padded < T6_SK || (nfft != 128 && nfft != 256) || bins < 1 || rows < 1)
    return -1;
  if (R < 6 || R > 9) return -1;
  T6Args a;
  a.frames = frames; a.tab = tab;
  a.mel_hi = (const uint16_t*)mel_hi; a.mel_lo = (const uint16_t*)mel_lo; a.mel_plan = mel_plan;
  a.out = out; a.stamps = (unsigned long long*)stamps;
  a.rows = rows; a.padded = padded; a.nfft = nfft; a.bins = bins; a.pitch = padded + 4;
  const int M = (T6_NT / 32) / (2 * nfft / 64) * 4 * R;
  const size_t need = t6_smem(M, padded, nfft);
  if ((size_t)smem != need) return -2;
  const int blocks = (rows + M - 1) / M;
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 6: return t6_launch<6>(a, blocks, need, st);
    case 7: return t6_launch<7>(a, blocks, need, st);
    case 8: return t6_launch<8>(a, blocks, need, st);
    default: return t6_launch<9>(a, blocks, need, st);
  }
}
