// Kernel 5: bf16x3 fbank frame DSP, hop-row buffer -> log-mel rows (and
// kernel 6 on pre-formed frames, below).
//
// Replaces april_asr_tpu/ops/fbank_pallas.py `logmel_rows_from_buf`
// (`_buf_kernel`), the frontend of every engine that is not int8. One block
// per (frame tile of FT frames, session), framed as csrc/fbank_i8.cu frames:
// the block loads the FT + n_views - 1 hop rows its frames span into shared
// memory once and splits every sample exactly into two bf16 planes
// (x_hi = bf16_rn(x), x_lo = bf16_rn(x - x_hi), round half to even as
// jnp.astype), so frame f's K = n_views * shift window is the contiguous
// span [f * shift, f * shift + K) of those rows. Each thread owns one
// frequency bin: the re and im columns of the folded DFT's bf16 hi and lo
// planes, for all FT frames. Per view (shift rows of K) it sums the three
// products x_hi*d_hi, x_hi*d_lo and x_lo*d_hi (the lo*lo term is dropped, as
// the TPU kernel drops it) in f32; every product of two bf16 values is exact
// in f32, so each FMA rounds only its sum. The view sums add up across
// views in the TPU kernel's order. Then power = re^2 + im^2, the bf16x3 mel
// projection (hi*hi + hi*lo + lo*hi) and logf(fmaxf(K_EPS, mel)).
//
// Why three passes and not one: log magnifies absolute spectral error near
// the K_EPS floor, and one bf16 pass of the DFT leaves ~2^-8 relative error
// in re/im (fbank_pallas.py:84-95).
//
// Bound on the H100: the f32 multiply-adds, 3 x 640 x 512 per frame for the
// DFT plus 3 x 256 x 80 for the mel. The DFT planes (2 x 0.66 MB bf16) stay
// in L2 and every block re-reads them; the samples are read once per block
// and each output written once. No fast-math: logf as written.
//
// Kernel 6, the second entry (`fbank_frames`): the same DSP on pre-formed
// frames [S, F, padded], replacing `logmel_rows_fused` (`_kernel`) of the same
// file. Its DFT is one product at full f32 precision (the TPU kernel's
// HIGHEST) with the folded DFT [padded, 2 * nfft]: one block per (tile of
// FT6 frames, session) holds its frames in shared memory, each thread owns a
// frequency bin's re and im columns and sums f32 FMAs over the padded
// window. The power, bf16x3 mel and log tail is kernel 5's (`store_power`,
// `mel_log_rows`). Bound: the 512 x 512 f32 multiply-adds per frame; the
// 1 MB DFT stays in L2, re-read by every block.

#include "common.cuh"

#define FT 8
#define FT6 16
#define NT 256
#define K_EPS 0x1p-23f

// The power spectrum of NF frames' sums for bin j, split into the bf16 hi and
// lo planes of the mel projection.
template <int NF>
__device__ __forceinline__ void store_power(float* ph, float* pl, int nfft, int j, const float* re,
                                            const float* im) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const float p = __fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f]));
    const float hi = round_bf16(p);
    ph[f * nfft + j] = hi;
    pl[f * nfft + j] = round_bf16(__fsub_rn(p, hi));
  }
}

// The bf16x3 mel projection (hi*hi + hi*lo + lo*hi) and logf(fmaxf(K_EPS, .))
// of the first `nrows` of NF power rows into out [nrows][bins].
template <int NF>
__device__ __forceinline__ void mel_log_rows(const float* ph, const float* pl,
                                             const uint16_t* __restrict__ mel_hi,
                                             const uint16_t* __restrict__ mel_lo,
                                             float* __restrict__ out, int nrows, int nfft, int bins,
                                             int tid) {
  for (int o = tid; o < NF * bins; o += NT) {
    const int f = o / bins, m = o - f * bins;
    if (f >= nrows) continue;
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int j = 0; j < nfft; ++j) {
      const float mh = bf16_to_f32(mel_hi[j * bins + m]);
      const float ml = bf16_to_f32(mel_lo[j * bins + m]);
      const float h = ph[f * nfft + j], l = pl[f * nfft + j];
      s1 = fmaf(h, mh, s1);
      s2 = fmaf(h, ml, s2);
      s3 = fmaf(l, mh, s3);
    }
    const float mel = __fadd_rn(__fadd_rn(s1, s2), s3);
    out[f * bins + m] = logf(fmaxf(K_EPS, mel));
  }
}

__global__ void __launch_bounds__(NT) fbank_bf16x3_kernel(
    const float* __restrict__ buf, const uint16_t* __restrict__ dhi,
    const uint16_t* __restrict__ dlo, const uint16_t* __restrict__ mel_hi,
    const uint16_t* __restrict__ mel_lo, float* __restrict__ out, int nbuf, int F, int shift,
    int n_views, int nfft, int bins) {
  extern __shared__ float4 smem_f4[];
  const int NS = (FT + n_views - 1) * shift;
  const int N2 = 2 * nfft;
  float* xh = reinterpret_cast<float*>(smem_f4);  // [NS] bf16 hi plane of the samples
  float* xl = xh + NS;                            // [NS] bf16 lo plane
  float* ph = xl + NS;                            // [FT][nfft] power, bf16 hi
  float* pl = ph + FT * nfft;                     // [FT][nfft] power, bf16 lo

  const int s = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* src = buf + ((size_t)s * nbuf + f0) * shift;
  const int avail = (nbuf - f0) * shift;
  for (int i = tid; i < NS; i += NT) {
    const float v = i < avail ? src[i] : 0.f;
    const float hi = round_bf16(v);
    xh[i] = hi;
    xl[i] = round_bf16(__fsub_rn(v, hi));
  }
  __syncthreads();

  for (int j = tid; j < nfft; j += NT) {
    float acc_re[FT], acc_im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) acc_re[f] = acc_im[f] = 0.f;
    for (int v = 0; v < n_views; ++v) {
      float pre[FT], pim[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) pre[f] = pim[f] = 0.f;
      for (int kk = 0; kk < shift; ++kk) {
        const int k = v * shift + kk;
        const float hre = bf16_to_f32(dhi[(size_t)k * N2 + j]);
        const float him = bf16_to_f32(dhi[(size_t)k * N2 + nfft + j]);
        const float lre = bf16_to_f32(dlo[(size_t)k * N2 + j]);
        const float lim = bf16_to_f32(dlo[(size_t)k * N2 + nfft + j]);
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          const int idx = f * shift + k;
          const float a = xh[idx], b = xl[idx];
          pre[f] = fmaf(b, hre, fmaf(a, lre, fmaf(a, hre, pre[f])));
          pim[f] = fmaf(b, him, fmaf(a, lim, fmaf(a, him, pim[f])));
        }
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        acc_re[f] = __fadd_rn(acc_re[f], pre[f]);
        acc_im[f] = __fadd_rn(acc_im[f], pim[f]);
      }
    }
    store_power<FT>(ph, pl, nfft, j, acc_re, acc_im);
  }
  __syncthreads();
  mel_log_rows<FT>(ph, pl, mel_hi, mel_lo, out + ((size_t)s * F + f0) * bins, F - f0, nfft, bins,
                   tid);
}

extern "C" int fbank_bf16x3(const float* buf, const uint16_t* dhi, const uint16_t* dlo,
                            const uint16_t* mel_hi, const uint16_t* mel_lo, float* out, int S,
                            int nbuf, int F, int shift, int n_views, int nfft, int bins,
                            void* stream) {
  const int NS = (FT + n_views - 1) * shift;
  const size_t smem = sizeof(float) * (size_t)(2 * NS + 2 * FT * nfft);
  cudaError_t err = allow_smem(fbank_bf16x3_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + FT - 1) / FT, S);
  fbank_bf16x3_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      buf, dhi, dlo, mel_hi, mel_lo, out, nbuf, F, shift, n_views, nfft, bins);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(NT) fbank_frames_kernel(
    const float* __restrict__ frames, const float* __restrict__ dft,
    const uint16_t* __restrict__ mel_hi, const uint16_t* __restrict__ mel_lo,
    float* __restrict__ out, int F, int padded, int nfft, int bins) {
  extern __shared__ float4 smem_f4[];
  float* xf = reinterpret_cast<float*>(smem_f4);  // [FT6][padded] frames
  float* ph = xf + FT6 * padded;                  // [FT6][nfft] power, bf16 hi
  float* pl = ph + FT6 * nfft;                    // [FT6][nfft] power, bf16 lo

  const int s = blockIdx.y;
  const int f0 = blockIdx.x * FT6;
  const int tid = threadIdx.x;
  const int N2 = 2 * nfft;
  const float* src = frames + ((size_t)s * F + f0) * padded;
  const int avail = (F - f0) * padded;
  for (int i = tid; i < FT6 * padded; i += NT) xf[i] = i < avail ? src[i] : 0.f;
  __syncthreads();

  for (int j = tid; j < nfft; j += NT) {
    float re[FT6], im[FT6];
#pragma unroll
    for (int f = 0; f < FT6; ++f) re[f] = im[f] = 0.f;
    for (int k = 0; k < padded; ++k) {
      const float dr = __ldg(dft + (size_t)k * N2 + j);
      const float di = __ldg(dft + (size_t)k * N2 + nfft + j);
#pragma unroll
      for (int f = 0; f < FT6; ++f) {
        const float x = xf[f * padded + k];
        re[f] = fmaf(x, dr, re[f]);
        im[f] = fmaf(x, di, im[f]);
      }
    }
    store_power<FT6>(ph, pl, nfft, j, re, im);
  }
  __syncthreads();
  mel_log_rows<FT6>(ph, pl, mel_hi, mel_lo, out + ((size_t)s * F + f0) * bins, F - f0, nfft, bins,
                    tid);
}

extern "C" int fbank_frames(const float* frames, const float* dft, const uint16_t* mel_hi,
                            const uint16_t* mel_lo, float* out, int S, int F, int padded, int nfft,
                            int bins, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(FT6 * padded + 2 * FT6 * nfft);
  cudaError_t err = allow_smem(fbank_frames_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + FT6 - 1) / FT6, S);
  fbank_frames_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(frames, dft, mel_hi, mel_lo, out, F,
                                                                padded, nfft, bins);
  return (int)cudaGetLastError();
}
