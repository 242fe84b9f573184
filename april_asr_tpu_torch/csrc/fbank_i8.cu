// Kernel 1: int8-DFT fbank frame DSP, hop-row buffer -> log-mel rows.
//
// Replaces april_asr_tpu/ops/fbank_pallas.py `logmel_rows_from_buf_i8`
// (`_buf_kernel_i8`). One block per (frame tile of FT frames, session). The
// block loads the FT + n_views - 1 hop rows its frames span into shared
// memory once and splits every sample exactly as the TPU kernel does
// (pcm = x * 32768, a = floor(pcm / 256), b = rint(pcm - 256a) - 128 clipped
// to int8, plus the bf16-rounded sample for the residual dot), so frame f's
// K = n_views * shift window is the contiguous span [f * shift, f * shift + K)
// of those rows. Each thread owns one frequency bin: the re and im columns of
// the folded DFT's int8 hi plane (exact int32 dots of both sample planes)
// and of its bf16 residual (f32 accumulation of exact bf16 products), for
// all FT frames. Then spec = (acc_a * 256 + acc_b + corr) * s_hi + resid,
// power = re^2 + im^2, the bf16x3 mel projection (hi*hi + hi*lo + lo*hi, each
// an f32 sum of exact products) and logf(fmaxf(K_EPS, mel)).
//
// Bound on the H100: the integer and f32 multiply-adds (2 x 640 x 512 per
// frame for the two planes plus 640 x 512 for the residual). The DFT tables
// (0.3 MB int8 + 0.6 MB bf16) stay in L2 and every block re-reads them;
// the samples are read once per block (4 / FT re-reads across tiles) and
// each output written once. No fast-math: logf as written.

#include "common.cuh"

#define FT 8
#define NT 256
#define K_EPS 0x1p-23f

__global__ void __launch_bounds__(NT) fbank_kernel(
    const float* __restrict__ buf, const int8_t* __restrict__ dhi,
    const uint16_t* __restrict__ rlo, const float* __restrict__ s_hi,
    const float* __restrict__ corr, const uint16_t* __restrict__ mel_hi,
    const uint16_t* __restrict__ mel_lo, float* __restrict__ out, int nbuf, int F, int shift,
    int n_views, int nfft, int bins) {
  extern __shared__ float4 smem_f4[];
  const int NS = (FT + n_views - 1) * shift;
  const int K = n_views * shift;
  const int N2 = 2 * nfft;
  float* xb = reinterpret_cast<float*>(smem_f4);  // [NS] bf16-rounded samples
  float* ph = xb + NS;                            // [FT][nfft] power, bf16 hi
  float* pl = ph + FT * nfft;                     // [FT][nfft] power, bf16 lo
  int8_t* a8 = reinterpret_cast<int8_t*>(pl + FT * nfft);  // [NS]
  int8_t* b8 = a8 + NS;                                    // [NS]

  const int s = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* src = buf + ((size_t)s * nbuf + f0) * shift;
  const int avail = (nbuf - f0) * shift;
  for (int i = tid; i < NS; i += NT) {
    const float v = i < avail ? src[i] : 0.f;
    const float pcm = __fmul_rn(v, 32768.f);
    const float a = floorf(__fmul_rn(pcm, 0x1p-8f));
    const float b = fminf(fmaxf(__fsub_rn(rintf(__fsub_rn(pcm, __fmul_rn(256.f, a))), 128.f), -128.f), 127.f);
    a8[i] = (int8_t)(int)a;
    b8[i] = (int8_t)(int)b;
    xb[i] = round_bf16(v);
  }
  __syncthreads();

  for (int j = tid; j < nfft; j += NT) {
    int aa_re[FT], bb_re[FT], aa_im[FT], bb_im[FT];
    float rr_re[FT], rr_im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      aa_re[f] = bb_re[f] = aa_im[f] = bb_im[f] = 0;
      rr_re[f] = rr_im[f] = 0.f;
    }
    for (int k = 0; k < K; ++k) {
      const int wre = dhi[(size_t)k * N2 + j];
      const int wim = dhi[(size_t)k * N2 + nfft + j];
      const float rre = bf16_to_f32(rlo[(size_t)k * N2 + j]);
      const float rim = bf16_to_f32(rlo[(size_t)k * N2 + nfft + j]);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const int idx = f * shift + k;
        const int av = a8[idx], bv = b8[idx];
        const float xv = xb[idx];
        aa_re[f] += av * wre;
        bb_re[f] += bv * wre;
        aa_im[f] += av * wim;
        bb_im[f] += bv * wim;
        rr_re[f] = fmaf(xv, rre, rr_re[f]);
        rr_im[f] = fmaf(xv, rim, rr_im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const float hre = __fadd_rn(__fadd_rn(__fmul_rn((float)aa_re[f], 256.f), (float)bb_re[f]), corr[j]);
      const float him = __fadd_rn(__fadd_rn(__fmul_rn((float)aa_im[f], 256.f), (float)bb_im[f]), corr[nfft + j]);
      const float re = __fadd_rn(__fmul_rn(hre, s_hi[j]), rr_re[f]);
      const float im = __fadd_rn(__fmul_rn(him, s_hi[nfft + j]), rr_im[f]);
      const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      const float hi = round_bf16(p);
      ph[f * nfft + j] = hi;
      pl[f * nfft + j] = round_bf16(__fsub_rn(p, hi));
    }
  }
  __syncthreads();

  for (int o = tid; o < FT * bins; o += NT) {
    const int f = o / bins, m = o - f * bins;
    if (f0 + f >= F) continue;
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
    out[((size_t)s * F + f0 + f) * bins + m] = logf(fmaxf(K_EPS, mel));
  }
}

extern "C" int fbank_i8(const float* buf, const int8_t* dhi, const uint16_t* rlo,
                        const float* s_hi, const float* corr, const uint16_t* mel_hi,
                        const uint16_t* mel_lo, float* out, int S, int nbuf, int F, int shift,
                        int n_views, int nfft, int bins, void* stream) {
  const int NS = (FT + n_views - 1) * shift;
  const size_t smem = sizeof(float) * (size_t)(NS + 2 * FT * nfft) + 2 * (size_t)NS;
  cudaError_t err = allow_smem(fbank_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + FT - 1) / FT, S);
  fbank_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      buf, dhi, rlo, s_hi, corr, mel_hi, mel_lo, out, nbuf, F, shift, n_views, nfft, bins);
  return (int)cudaGetLastError();
}
