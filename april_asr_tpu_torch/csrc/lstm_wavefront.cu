// Kernel 15: a slab of Lk int8 residual LSTMP layers on the anti-diagonal
// (wavefront) schedule.
//
// Replaces april_asr_tpu/ops/lstm_wavefront_pallas.py
// `lstm_slab_wavefront_i8` (`_wavefront_kernel_i8`). At diagonal D every
// layer l with 0 <= D - l < P runs its timestep t = D - l, FFN and norm
// included; the (l, t) items of one diagonal are independent, so the layers'
// recurrences overlap. The TPU kernel walks a diagonal's layers on one core
// in descending order, so that layer l reads ring[l - 1] (layer l - 1's
// output of the previous diagonal) before layer l - 1 overwrites it.
//
// Here one launch runs one diagonal: blockIdx.y is the layer (from the
// diagonal's first live layer), blockIdx.x a tile of TS = 2 sessions, and
// every block runs `layer_step_i8` (csrc/lstm_i8.cuh, kernel 11's step) once.
// All layers of a diagonal run at once, so the inter-layer ring is double
// buffered by diagonal parity: layer l reads ring[(D - 1) & 1][l - 1] and
// writes ring[D & 1][l], and launches on one stream order one diagonal's
// writes after the last one's reads. Layer 0 reads x[t], the last layer
// writes y[t]. The carried h/c of each layer live in h2/c2 (read from h/c
// at t = 0), loaded into the block's shared memory and written back once
// per step; where t >= n_pulls they keep their values, and y is ungated.
// One C call launches the slab's P + Lk - 1 diagonals (one count).
//
// Why launches and not one cooperative kernel with a grid barrier per
// diagonal: the launch boundary is the barrier, costs a few microseconds
// against a diagonal's work (a whole layer step of every live layer), and
// puts no co-residency limit on the grid (S / TS x Lk blocks of 53 KB
// shared memory each at flagship dims).
//
// Bound on the H100: a diagonal runs up to Lk x S / TS blocks, each
// re-reading its layer's 6.8 MB of int8 weights from L2. A 6-layer slab's
// weights (40.9 MB) fit the 50 MB L2 beside the ring (2 x Lk x S x d f32:
// 6.3 MB at S = 256); a 12-layer slab's (81.8 MB) do not, so its diagonals
// read weights from device memory. The TPU kernel keeps the inter-layer
// activations out of HBM; here the ring is device memory that stays in L2.
//
// Numerics as kernels 2 and 3 (csrc/lstm_i8.cu).

#include "lstm_i8.cuh"

constexpr int TS_WAVE = 2;  // sessions per block

__global__ void __launch_bounds__(REC_NT) wavefront_kernel(
    const float* __restrict__ x, const float* __restrict__ h0, const float* __restrict__ c0,
    const int* __restrict__ npulls, LayerI8 w0, float* __restrict__ ring, float* __restrict__ y,
    float* __restrict__ h2, float* __restrict__ c2, int D, int l_lo, int P, int S, int d, int H,
    int F, int Lk) {
  constexpr int TS = TS_WAVE;
  extern __shared__ float4 smem_f4[];
  const LayerSmem m = layer_smem<TS>(reinterpret_cast<float*>(smem_f4), d, H, F);
  const int l = l_lo + blockIdx.y, t = D - l, s0 = blockIdx.x * TS;
  const size_t sd = (size_t)S * d, sh = (size_t)S * H;
  int np[TS];
#pragma unroll
  for (int r = 0; r < TS; ++r) np[r] = (s0 + r < S) ? npulls[s0 + r] : 0;
  load_rows<TS>(m.hsh, (t == 0 ? h0 : h2) + l * sd, s0, S, d);
  load_rows<TS>(m.csh, (t == 0 ? c0 : c2) + l * sh, s0, S, H);
  const float* xsrc = l == 0 ? x + t * sd : ring + (((D - 1) & 1) * Lk + (l - 1)) * sd;
  float* out = l == Lk - 1 ? y + t * sd : ring + ((D & 1) * Lk + l) * sd;
  layer_step_i8<TS>(m, layer_at(w0, l, d, H, F), xsrc, out, np, t, s0, S, d, H, F);
  store_rows<TS>(h2 + l * sd, m.hsh, s0, S, d);
  store_rows<TS>(c2 + l * sh, m.csh, s0, S, H);
}

// ring: the wrapper's [2, Lk, S, d] scratch. Outputs y [P, S, d],
// h2 [Lk, S, d], c2 [Lk, S, H].
extern "C" int lstm_wavefront_i8(const float* x, const float* h, const float* c,
                                 const int* npulls, const int8_t* wih, const float* wihs,
                                 const int8_t* whh, const float* whhs, const void* bias,
                                 const int8_t* whr, const float* whrs, const int8_t* ff1,
                                 const float* ff1s, const void* f1b, const int8_t* ff2,
                                 const float* ff2s, const void* f2b, const float* eps,
                                 float* ring, float* y, float* h2, float* c2, int P, int S, int d,
                                 int H, int F, int Lk, int bias_bf16, int f1b_bf16, int f2b_bf16,
                                 void* stream) {
  const LayerI8 w = {wih, whh, whr, ff1, ff2, wihs, whhs, whrs, ff1s, ff2s, eps,
                     bias, f1b, f2b, bias_bf16, f1b_bf16, f2b_bf16};
  const size_t smem = layer_smem_bytes<TS_WAVE>(d, H, F);
  const int fit = smem_fits(smem);
  if (fit) return fit;
  cudaError_t err = allow_smem(wavefront_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (S + TS_WAVE - 1) / TS_WAVE;
  for (int D = 0; D < P + Lk - 1; ++D) {
    const int lo = D - P + 1 > 0 ? D - P + 1 : 0, hi = D < Lk - 1 ? D : Lk - 1;
    wavefront_kernel<<<dim3(tiles, hi - lo + 1), REC_NT, smem, (cudaStream_t)stream>>>(
        x, h, c, npulls, w, ring, y, h2, c2, D, lo, P, S, d, H, F, Lk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
