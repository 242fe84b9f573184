// Kernel 10, the float whole-layer chunk of the encoder, as one persistent
// cooperative launch on kernel 12's phases (csrc/lstm_mma.cuh: `float_gates`,
// `float_cols`, `float_norm` on `tile_pass`).
//
// lstm_chunk_float_mma replaces april_asr_tpu/ops/lstm_pallas.py
// `lstm_layer_chunk_fused` (`_chunk_kernel`, f32 or bf16 weights): one
// residual LSTMP layer with its DoubleSwish FFN and BasicNorm over P steps
// of S sessions,
//
//   for t < P:  gates = dot(x_t, w_ih) + dot(h, w_hh) + b
//               c' = sig(f) c + sig(i) tanh g;  hc = sig(o) tanh c'
//               h' = dot(hc, w_hr);  y_t = x_t + h'
//               h, c = h', c' where t < n_pulls[s] (a prefix mask), else kept
//   mid = DoubleSwish(dot(y, ff1) + b1);  yn = y + dot(mid, ff2) + b2
//   out = yn * rsqrt(mean(yn^2) + eps)        over the P * S rows of y,
//
// each dot's activation rounded to the weight type and summed in f32. No
// step's FFN feeds the recurrence, so the FFN runs once over all P * S rows
// after the time loop; the values are the TPU kernel's step-by-step ones.
//
// What bounds it on the H100. At flagship widths (d 512, H 1024, F 2048),
// S = 256 and P = 27 the layer is 47 G multiply-adds: at f32 the CUDA
// cores' 67 TFLOP/s bound it (1.41 ms), at bf16 the same work at the
// tensor cores' rate (0.095 ms). The two-kernel version it replaces
// (csrc/lstm_chunk.cu, kept as chip_smoke.py's yardstick) ran 64 blocks of 4
// sessions that re-read the recurrent weights from L2 at every step and
// every product as an FFMA loop, ~10% of the f32 rate. Here:
//
//   * one cooperative launch of at most one block per SM: for each step,
//     the gate items (kernel 12's, over the S rows) then the projection
//     items, a grid barrier after each; then ff1 and ff2 items over the
//     P * S rows and the BasicNorm of whole rows (2 P + 2 barriers);
//   * every product streams its weight columns beside its activation rows
//     through one shared three-stage ring (`tile_pass`): each weight feeds
//     an item's nr rows; bf16 on `mma.sync` m16n8k16, f32 on FFMA register
//     tiles (no TF32, no tensor cores);
//   * the carried h and c live in the outputs h2 and c2 (read at t = 0 from
//     h and c): each element is read and written by the same thread, so the
//     mask is a select in the epilogue; hc [S][H] and mid [P * S][F] go to
//     scratch in f32, y_t = x_t + h' to the output y, which ff2 updates and
//     the norm scales in place.
//
// Numerics: the products are the JAX kernel's, summed in another order;
// every f32 step outside the dots is rounded separately (__fadd_rn,
// __fmul_rn) in the JAX op order; tanhf and rsqrtf are CUDA's (no
// fast-math). chip_smoke.py holds it to the plain version at f32 atol/rtol
// 1e-4 and at bf16 5e-2 / 1e-3.

#include "lstm_mma.cuh"

struct FChunkArgs {
  const float *x, *h, *c;
  const int* npulls;
  const void *wih, *whh, *bias, *whr, *ff1, *f1b, *ff2, *f2b;
  const float* eps;
  float *y, *h2, *c2;
  float *hc, *mid;  // scratch [S][H], [P * S][F]
  int P, S, d, H, F, bias_bf16, f1b_bf16, f2b_bf16, ub, half8, dn;  // dn: the norm's width
  TileSplit g, pj, f1, f2;  // gates (nc = 4 ub) and projection over S rows; ff1, ff2 over P * S
  Stamps stamp;             // 4 P + 6 a block: start, each phase's end and each barrier's
};

template <class W>
__global__ void __launch_bounds__(MMA_NT, 1) lstm_chunk_float_mma_kernel(const FChunkArgs a) {
  extern __shared__ float4 smem_f4[];
  cg::grid_group grid = cg::this_grid();
  const int S = a.S, d = a.d, H = a.H, F = a.F, R = a.P * S;
  const TileSplit sps[4] = {a.g, a.pj, a.f1, a.f2};
  const FloatRing fr = float_ring<W>(smem_f4, sps, a.half8 != 0);
  a.stamp(0);

  for (int t = 0; t < a.P; ++t) {
    const float* hcur = t ? a.h2 : a.h;
    const float* ccur = t ? a.c2 : a.c;
    const float* xt = a.x + (size_t)t * S * d;
    float* yt = a.y + (size_t)t * S * d;
    // gates and cell; the carried c kept where t >= n_pulls
    float_gates<W>(a.g, a.ub, fr, xt, static_cast<const W*>(a.wih), hcur,
                   static_cast<const W*>(a.whh), a.bias, a.bias_bf16, ccur, a.hc, S, d, H,
                   [&](int row, size_t k, float cold, float cn) {
                     a.c2[k] = t < a.npulls[row] ? cn : cold;
                   });
    a.stamp(1 + 4 * t);
    grid.sync();
    a.stamp(2 + 4 * t);
    // projection: h' = dot(hc, w_hr), the carried h, y_t = x_t + h'
    float_cols<W>(a.pj, fr, a.hc, static_cast<const W*>(a.whr), H, d, S,
                  [&](int row, int col, float hn) {
                    const size_t k = (size_t)row * d + col;
                    a.h2[k] = t < a.npulls[row] ? hn : __ldcg(hcur + k);
                    yt[k] = __fadd_rn(xt[k], hn);
                  });
    a.stamp(3 + 4 * t);
    grid.sync();
    a.stamp(4 + 4 * t);
  }
  const int s0 = 1 + 4 * a.P;

  // ff1 + DoubleSwish over the P * S rows
  float_cols<W>(a.f1, fr, a.y, static_cast<const W*>(a.ff1), d, F, R,
                [&](int row, int col, float v) {
                  a.mid[(size_t)row * F + col] = ff1_dswish(v, a.f1b, col, a.f1b_bf16);
                });
  a.stamp(s0);
  grid.sync();
  a.stamp(s0 + 1);

  // ff2 + bias + residual, in place (each (row, column) has one owner)
  float_cols<W>(a.f2, fr, a.mid, static_cast<const W*>(a.ff2), F, d, R,
                [&](int row, int col, float v) {
                  const size_t k = (size_t)row * d + col;
                  const float ff = __fadd_rn(v, load_vec(a.f2b, col, a.f2b_bf16));
                  a.y[k] = __fadd_rn(__ldcg(a.y + k), ff);
                });
  a.stamp(s0 + 2);
  grid.sync();
  a.stamp(s0 + 3);

  // BasicNorm of whole rows, in place, the mean over dn columns
  float_norm(a.y, a.y, a.eps[0], R, d, a.dn);
  a.stamp(s0 + 4);
}

// Kernel 10. x [P][S][d], h [S][d], c [S][H] f32, npulls [S] i32 prefix
// lengths; outputs y [P][S][d], h2 [S][d], c2 [S][H]. Scratch: hc [S][H],
// mid [P * S][F] f32; stamps null or [nb][4 P + 6]. Every row pointer (x,
// h, the weights, the scratch) 16-byte aligned, d, H and F multiples of 4.
// The plan (ops/lstm_mma.py `float_chunk_plan`): ub, nb, then each phase's
// TileSplit (nr, nc, ncg, items, ks, ntw) for the gates, the projection,
// ff1 and ff2. Returns minus the shared-memory bytes where they do not fit,
// else the launch's CUDA error.
extern "C" int lstm_chunk_float_mma(
    const float* x, const float* h, const float* c, const int* npulls, const void* wih,
    const void* whh, const void* bias, const void* whr, const void* ff1, const void* f1b,
    const void* ff2, const void* f2b, const float* eps, float* y, float* h2, float* c2, float* hc,
    float* mid, unsigned long long* stamps, int P, int S, int d, int H, int F, int w_bf16,
    int bias_bf16, int f1b_bf16, int f2b_bf16, int ub, int nb, int g_nr, int g_nc, int g_ncg,
    int g_items, int g_ks, int g_ntw, int p_nr, int p_nc, int p_ncg, int p_items, int p_ks,
    int p_ntw, int f1_nr, int f1_nc, int f1_ncg, int f1_items, int f1_ks, int f1_ntw, int f2_nr,
    int f2_nc, int f2_ncg, int f2_items, int f2_ks, int f2_ntw, int dn, void* stream) {
  const TileSplit sps[4] = {{g_nr, g_nc, g_ncg, g_items, g_ks, g_ntw},
                            {p_nr, p_nc, p_ncg, p_items, p_ks, p_ntw},
                            {f1_nr, f1_nc, f1_ncg, f1_items, f1_ks, f1_ntw},
                            {f2_nr, f2_nc, f2_ncg, f2_items, f2_ks, f2_ntw}};
  const int half8 = w_bf16 && ((d | H | F) & 7);
  const FChunkArgs a{x, h, c, npulls, wih, whh, bias, whr, ff1, f1b, ff2, f2b, eps, y, h2, c2, hc,
                     mid, P, S, d, H, F, bias_bf16, f1b_bf16, f2b_bf16, ub, half8, dn,
                     sps[0], sps[1], sps[2], sps[3], Stamps{stamps, 4 * P + 6}};
  const size_t smem = float_smem(sps, w_bf16 ? 2 : 4);
  if (w_bf16) return coop_launch(lstm_chunk_float_mma_kernel<uint16_t>, a, nb, smem, stream);
  return coop_launch(lstm_chunk_float_mma_kernel<float>, a, nb, smem, stream);
}
