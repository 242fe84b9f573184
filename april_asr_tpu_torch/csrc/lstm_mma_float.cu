// Kernel 12, the float per-pull layer, as one persistent cooperative launch
// (pieces in csrc/lstm_mma.cuh: the float phases on `tile_pass`, the grid
// helpers, `Stamps`; kernel 10, csrc/lstm_chunk_mma.cu, runs the same phases).
//
// lstm_step_float_mma replaces april_asr_tpu/ops/lstm_pallas.py
// `lstm_layer_fused` (`_layer_kernel`, f32 or bf16 weights): one timestep
// of a residual LSTMP layer for S sessions,
//
//   gates = dot(x, w_ih) + dot(h, w_hh) + b;  c' = sig(f) c + sig(i) tanh g
//   hc = sig(o) tanh c';  h' = dot(hc, w_hr);  y = x + h'
//   mid = DoubleSwish(dot(y, ff1) + b1);  yn = y + dot(mid, ff2) + b2
//   out = yn * rsqrt(mean(yn^2) + eps)
//   with a gate column: h2 = gt h' + (1 - gt) h, c2 likewise (`blend`),
//
// each dot's activation rounded to the weight type and summed in f32.
//
// What bounds it on the H100. At flagship widths (d 512, H 1024, F 2048)
// and S = 256 the layer is 6.82 M weights (27.3 MB at f32, 13.6 MB at bf16)
// and 1.75 G multiply-adds: at f32 the CUDA cores' 67 TFLOP/s bound it
// (0.0521 ms), at bf16 the weight bytes (0.0053 ms). The three-pass kernel
// it replaces (csrc/lstm_step.cu `lstm_step_float`, kept as chip_smoke.py's
// yardstick) re-read each weight slice from L2 for every session tile and
// ran even the bf16 products as FFMA loops. Here:
//
//   * one cooperative launch of at most one block per SM; four phases of
//     tile items (ops/lstm_mma.py `float_step_plan`), a grid barrier
//     between them: gates and cell | projection, h2, y = x + h' | ff1 and
//     DoubleSwish | ff2 and the residual | BasicNorm of whole rows, summed
//     in csrc/ffn_norm.cuh's order (four barriers);
//   * each item streams its weight columns once, beside its activation
//     rows, through one shared ring (`tile_pass`): the weights cross from
//     device memory once per launch, and each weight feeds nr rows;
//   * bf16 weights: `mma.sync` m16n8k16 bf16 -> f32; f32 weights: FFMA on
//     register tiles of 8 x 4 outputs a thread (no TF32, no split);
//   * a gate item owns ub hidden units with their four gate columns, so the
//     cell stays in the block; hc, y and mid go to scratch in f32 and are
//     read back through L2 (cp.async.cg, __ldcg); their rounding to bf16
//     happens where they become A fragments, which is the same rounding.
//
// Numerics: the products are the JAX kernel's (exact bf16 x bf16 in f32, or
// f32 FMA), summed in another order; every f32 step outside the dots is
// rounded separately (__fadd_rn/__fmul_rn) in the JAX op order; tanhf and
// rsqrtf are CUDA's (no fast-math). chip_smoke.py holds it to the plain
// version at f32 atol/rtol 1e-4 and at bf16 5e-2 / 1e-3.

#include "lstm_mma.cuh"

struct FStepArgs {
  const float *x, *h, *c, *gate;
  const void *wih, *whh, *bias, *whr, *ff1, *f1b, *ff2, *f2b;
  const float* eps;
  float *y, *h2, *c2;
  float *hc, *yf, *mid;  // scratch [S][H], [S][d], [S][F]
  int S, d, H, F, bias_bf16, f1b_bf16, f2b_bf16, ub, half8;
  TileSplit g, pj, f1, f2;  // gates (nc = 4 ub), projection, ff1, ff2
  Stamps stamp;             // 10 a block: start, each phase's end and each barrier's
};

template <class W>
__global__ void __launch_bounds__(MMA_NT, 1) lstm_step_float_mma_kernel(const FStepArgs a) {
  extern __shared__ float4 smem_f4[];
  cg::grid_group grid = cg::this_grid();
  const int S = a.S, d = a.d, H = a.H, F = a.F;
  const TileSplit sps[4] = {a.g, a.pj, a.f1, a.f2};
  const FloatRing fr = float_ring<W>(smem_f4, sps, a.half8 != 0);
  a.stamp(0);

  // gates and cell; c2 blended by the gate column
  float_gates<W>(a.g, a.ub, fr, a.x, static_cast<const W*>(a.wih), a.h,
                 static_cast<const W*>(a.whh), a.bias, a.bias_bf16, a.c, a.hc, S, d, H,
                 [&](int row, size_t k, float cold, float cn) {
                   a.c2[k] = a.gate ? blend(a.gate[row], cn, cold) : cn;
                 });
  a.stamp(1);
  grid.sync();
  a.stamp(2);

  // projection: h' = dot(hc, w_hr), h2, y = x + h'
  float_cols<W>(a.pj, fr, a.hc, static_cast<const W*>(a.whr), H, d, S,
                [&](int row, int col, float hn) {
                  const size_t k = (size_t)row * d + col;
                  a.h2[k] = a.gate ? blend(a.gate[row], hn, a.h[k]) : hn;
                  a.yf[k] = __fadd_rn(a.x[k], hn);
                });
  a.stamp(3);
  grid.sync();
  a.stamp(4);

  // ff1 + DoubleSwish
  float_cols<W>(a.f1, fr, a.yf, static_cast<const W*>(a.ff1), d, F, S,
                [&](int row, int col, float v) {
                  a.mid[(size_t)row * F + col] = ff1_dswish(v, a.f1b, col, a.f1b_bf16);
                });
  a.stamp(5);
  grid.sync();
  a.stamp(6);

  // ff2 + bias + residual, in place (each (row, column) has one owner)
  float_cols<W>(a.f2, fr, a.mid, static_cast<const W*>(a.ff2), F, d, S,
                [&](int row, int col, float v) {
                  const size_t k = (size_t)row * d + col;
                  const float ff = __fadd_rn(v, load_vec(a.f2b, col, a.f2b_bf16));
                  a.yf[k] = __fadd_rn(__ldcg(a.yf + k), ff);
                });
  a.stamp(7);
  grid.sync();
  a.stamp(8);

  // BasicNorm, one warp a row, in basic_norm_rows' order (csrc/ffn_norm.cuh)
  float_norm(a.yf, a.y, a.eps[0], S, d);
  a.stamp(9);
}

// Kernel 12. gate: [S] f32 or null (ungated). Scratch: hc [S][H], yf [S][d],
// mid [S][F] f32; stamps null or [nb][10]. Every row pointer (x, h, the
// weights, the scratch) 16-byte aligned, d, H and F multiples of 4. The
// plan (ops/lstm_mma.py `float_step_plan`): ub, nb, then each phase's
// TileSplit (nr, nc, ncg, items, ks, ntw) for the gates, the projection,
// ff1 and ff2. Returns minus the shared-memory bytes where they do not fit,
// else the launch's CUDA error.
extern "C" int lstm_step_float_mma(
    const float* x, const float* h, const float* c, const float* gate, const void* wih,
    const void* whh, const void* bias, const void* whr, const void* ff1, const void* f1b,
    const void* ff2, const void* f2b, const float* eps, float* y, float* h2, float* c2, float* hc,
    float* yf, float* mid, unsigned long long* stamps, int S, int d, int H, int F, int w_bf16,
    int bias_bf16, int f1b_bf16, int f2b_bf16, int ub, int nb, int g_nr, int g_nc, int g_ncg,
    int g_items, int g_ks, int g_ntw, int p_nr, int p_nc, int p_ncg, int p_items, int p_ks,
    int p_ntw, int f1_nr, int f1_nc, int f1_ncg, int f1_items, int f1_ks, int f1_ntw, int f2_nr,
    int f2_nc, int f2_ncg, int f2_items, int f2_ks, int f2_ntw, void* stream) {
  const TileSplit sps[4] = {{g_nr, g_nc, g_ncg, g_items, g_ks, g_ntw},
                            {p_nr, p_nc, p_ncg, p_items, p_ks, p_ntw},
                            {f1_nr, f1_nc, f1_ncg, f1_items, f1_ks, f1_ntw},
                            {f2_nr, f2_nc, f2_ncg, f2_items, f2_ks, f2_ntw}};
  const int half8 = w_bf16 && ((d | H | F) & 7);
  const FStepArgs a{x, h, c, gate, wih, whh, bias, whr, ff1, f1b, ff2, f2b, eps, y, h2, c2, hc,
                    yf, mid, S, d, H, F, bias_bf16, f1b_bf16, f2b_bf16, ub, half8,
                    sps[0], sps[1], sps[2], sps[3], Stamps{stamps, 10}};
  const size_t smem = float_smem(sps, w_bf16 ? 2 : 4);
  if (w_bf16) return coop_launch(lstm_step_float_mma_kernel<uint16_t>, a, nb, smem, stream);
  return coop_launch(lstm_step_float_mma_kernel<float>, a, nb, smem, stream);
}
