// Kernels 2 and 7 on the tensor cores: persistent, weight-stationary int8
// `mma.sync` layer kernels (pieces in csrc/lstm_mma.cuh).
//
// lstm_rec_stream2_i8 (kernel 2, the int8 engine step's recurrent core)
// replaces april_asr_tpu/ops/lstm_pallas.py `lstm_layer_chunk_rec_stream2_i8`
// (`_rec_stream2_kernel_i8`): one layer over P steps -- _rowq8(x_t) and
// _rowq8(h), the int8 gate dots, the f32 cell, _rowq8(hc), the int8
// projection; hseq[t] written ungated, h and c kept where t >= n_pulls.
// lstm_step_i8 (kernel 7, the flush's per-pull layer) replaces
// `lstm_layer_fused_i8` (`_layer_kernel_i8`): one timestep of the whole
// residual layer -- the same gates, cell and projection, y = x + h', the
// int8 FFN with DoubleSwish, BasicNorm, and an optional gate column that
// blends h' and c' with the carried state (`blend`).
//
// What bounds them on the H100, and the design. At flagship widths (d 512,
// H 1024, F 2048) and S = 256 a step's products are 2.4 G int8 operations
// for kernel 2 (about 1.2 us at the tensor cores' 1,979 TOP/s) and its
// weights 4.7 MB; kernel 7 moves 6.8 MB of weights once (2 us at 3.35 TB/s),
// which bounds it. The kernels they replace ran CUDA-core IMAD loops over
// char4 weight strips, each block of session tiles re-reading the layer's
// weights from L2 every step (kernel 2: 16 GB a layer). Here:
//
//   * one cooperative launch of at most one block per SM, the work split by
//     columns and, where the blocks allow, by rows (ops/lstm_mma.py
//     `mma_plan`): at flagship widths a gate item owns 16 hidden units with
//     their four gate columns for half the rows (64 x 2 items), so the cell
//     stays in the block; projection and ff2 items own 16 columns x 64
//     rows, ff1 items 16 columns x every row;
//   * each block stages its weight slices into shared memory once per launch
//     (83 KB for kernel 2, 125 KB for kernel 7 at flagship widths), so the
//     weights cross from L2 once per launch, not once per step and tile;
//   * every dot is `mma.sync` m16n8k32 s8 -> s32 with exact accumulators,
//     the activation rows streamed from L2 in 128-row passes;
//   * _rowq8 across blocks: partial row amaxes folded by atomicMax, a grid
//     barrier, then each block quantizes its slice (`lstm_mma.cuh`).
//
// What binds them then (the phase stamps of tools/profile_lstm_mma.py):
// the gate and projection phases, each the stream of a row range's
// activation rows from L2 into every block of that range plus the
// epilogue that follows it, take most of a step; each grid barrier takes
// about a microsecond and a half; the tensor cores' own work is a small
// part.
//
// Kernel 2's phases: the _rowq8 of every step's x rows and of h0 (whole rows,
// one warp each) into int8 scratch, then per step t: gates and cell (amax of
// hc) | hcq | the projection, hseq[t], the carried h (amax of h) | hq for
// t + 1 |, where | is a grid barrier (four a step, two at the last).
// Kernel 7's: _rowq8 of x and h | gates, cell, c' (amax of hc) | hcq |
// projection, h', y = x + h' (amax of y) | yq | ff1 + DoubleSwish (amax of
// mid) | mq | ff2 + residual | BasicNorm of whole rows, summed in
// csrc/ffn_norm.cuh's order (eight barriers).
//
// The integer dots are exact in any order and every f32 step keeps the op
// order of the kernels these replace (csrc/lstm_i8.cu `lstm_rec_kernel`,
// csrc/lstm_step.cu's three passes), so the results equal theirs bit for
// bit; chip_smoke.py holds them to that.

#include "lstm_mma.cuh"

struct RecArgs {
  const float *x, *h0, *c0;
  const int* np;
  const int8_t *wih, *whh, *whr;
  const float *wihs, *whhs, *whrs;
  const void* bias;
  float *hseq, *h2, *c2;
  int8_t *xq, *hq, *hcq;  // [P][Sp][dp], [Sp][dp], [Sp][hp]
  float *hcf, *scl;       // [S][H]; [P + 2][Sp]: x_t, h, hc row scales
  unsigned* amax;         // [4][Sp]: hc (two slots), h (two slots)
  int P, S, d, H, bias_bf16, Sp, dp, hp;
  GateSplit gs;
  ColSplit pj;
  Stamps stamp;           // 3 + 8 P a block: start, phase 0, its barrier; per
                          // step each phase and each barrier's end
};

template <int NTG>
__global__ void __launch_bounds__(MMA_NT, 1) lstm_rec_mma_kernel(const RecArgs a) {
  constexpr int UB = 2 * NTG, NC = 8 * NTG;
  extern __shared__ float4 smem_f4[];
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, tid = threadIdx.x;
  const int S = a.S, d = a.d, H = a.H, Sp = a.Sp, dp = a.dp, hp = a.hp, P = a.P;
  const int ldg = 2 * dp + 16, ldp = hp + 16, pc = a.pj.ct * 8;
  uint8_t* Bg = reinterpret_cast<uint8_t*>(smem_f4);  // [NC][ldg]: w_ih | w_hh columns
  uint8_t* Bp = Bg + NC * ldg;                         // [pc][ldp]: w_hr columns
  uint8_t* stage = Bp + pc * ldp;                      // the A ring
  float* gbuf = reinterpret_cast<float*>(stage + MMA_RING);  // [8][16][NC + 8]
  float* gcs = gbuf + 8 * 16 * (NC + 8);               // [3][NC]
  float* pcs = gcs + 3 * NC;                           // [pc]: w_hr column scales
  float* xs = a.scl;
  float* hs = xs + (size_t)P * Sp;
  float* hcs = hs + Sp;
  unsigned* am_hc = a.amax;
  unsigned* am_h = a.amax + 2 * Sp;
  int u0 = 0, g0 = 0, g1 = 0;
  const bool gate_blk = gate_item(a.gs, b, UB, Sp, u0, g0, g1);
  Item pi;
  const bool proj_blk = col_item(a.pj, b, d, Sp, pi);
  a.stamp(0);

  if (gate_blk) {
    auto gcol = [&](int n) {
      const int gi = n / UB, U = u0 + n - gi * UB;
      return U < H ? gi * H + U : -1;
    };
    stage_cols(Bg, ldg, 0, a.wih, 4 * H, d, dp, NC, gcol);
    stage_cols(Bg, ldg, dp, a.whh, 4 * H, d, dp, NC, gcol);
    stage_gate_consts(gcs, NC, a.wihs, a.whhs, a.bias, a.bias_bf16, gcol);
  }
  if (proj_blk) {
    stage_cols(Bp, ldp, 0, a.whr, d, H, hp, pc,
               [&](int n) { return pi.c0 + n < pi.c1 ? pi.c0 + n : -1; });
    stage_item_consts(pcs, pi, pc, 1, [&](int, int col) { return a.whrs[col]; });
  }
  quant_rows((P + 1) * S, [&](int r, const float*& src, int8_t*& dst, float*& sc, int& len) {
    len = d;
    if (r < P * S) {
      const int t = r / S, s = r - t * S;
      src = a.x + (size_t)r * d;
      dst = a.xq + ((size_t)t * Sp + s) * dp;
      sc = xs + (size_t)t * Sp + s;
    } else {
      const int s = r - P * S;
      src = a.h0 + (size_t)s * d;
      dst = a.hq + (size_t)s * dp;
      sc = hs + s;
    }
  });
  grid_copy(a.h2, a.h0, (size_t)S * d);
  grid_copy(a.c2, a.c0, (size_t)S * H);
  grid_zero(a.amax, 4 * Sp);
  a.stamp(1);
  grid.sync();
  a.stamp(2);

  for (int t = 0; t < P; ++t) {
    const int k0 = 3 + 8 * t;
    const int sl = t & 1;
    // the other slots were last read before the barrier that ended step t - 1
    // and are next written after the one that ends step t
    if (b == 0)
      for (int i = tid; i < Sp; i += MMA_NT) am_hc[(sl ^ 1) * Sp + i] = am_h[(sl ^ 1) * Sp + i] = 0u;
    if (gate_blk) {
      const GateIn g{a.xq + (size_t)t * Sp * dp, a.hq, xs + (size_t)t * Sp, hs, a.c2, a.hcf,
                     am_hc + sl * Sp};
      gate_phase<NTG>(
          g, Bg, ldg, gcs, gbuf, stage, u0, g0, g1, S, dp, H,
          [&](int row) { return t < __ldg(a.np + row) ? 1.f : 0.f; },
          [&](int, size_t k, float, float cn, float live) {
            if (live != 0.f) a.c2[k] = cn;
          });
    }
    a.stamp(k0);
    grid.sync();
    a.stamp(k0 + 1);
    if (gate_blk)
      quant_region(a.hcf, H, a.hcq, hp, am_hc + sl * Sp, hcs, u0 == 0, g0, min(g1, S), u0,
                   min(u0 + UB, H));
    a.stamp(k0 + 2);
    grid.sync();
    a.stamp(k0 + 3);
    const bool last = t + 1 == P;
    if (proj_blk)
      cols_phase<MMA_NTW>(
          pi, a.hcq, hp, Bp, ldp, stage, S, last ? nullptr : am_h + sl * Sp,
          [&](int row) {
            return make_float2(__ldcg(hcs + row), t < __ldg(a.np + row) ? 1.f : 0.f);
          },
          [&](int row, int col) { return make_float2(__ldcg(a.h2 + (size_t)row * d + col), 0.f); },
          [&](int row, int col, int acc, float2 r, float2 e) {
            const float hn = __fmul_rn((float)acc, __fmul_rn(r.x, pcs[col - pi.c0]));
            const size_t k = (size_t)row * d + col;
            a.hseq[(size_t)t * S * d + k] = hn;
            if (r.y != 0.f) {
              a.h2[k] = hn;
              return fabsf(hn);
            }
            return fabsf(e.x);
          });
    a.stamp(k0 + 4);
    if (last) break;
    grid.sync();
    a.stamp(k0 + 5);
    if (proj_blk)
      quant_region(a.h2, d, a.hq, dp, am_h + sl * Sp, hs, pi.c0 == 0, pi.r0, min(pi.r1, S), pi.c0,
                   pi.c1);
    a.stamp(k0 + 6);
    grid.sync();
    a.stamp(k0 + 7);
  }
}

struct StepArgs {
  const float *x, *h, *c, *gate;
  const int8_t *wih, *whh, *whr, *ff1, *ff2;
  const float *wihs, *whhs, *whrs, *ff1s, *ff2s, *eps;
  const void *bias, *f1b, *f2b;
  float *y, *h2, *c2;
  int8_t *xq, *hq, *hcq, *yq, *mq;  // [Sp][dp] x3 (x, h, y), [Sp][hp], [Sp][fp]
  float *hcf, *yf, *mf, *scl;       // [S][H], [S][d], [S][F]; [5][Sp]: x, h, hc, y, mid
  unsigned* amax;                   // [3][Sp]: hc, y, mid
  int S, d, H, F, bias_bf16, f1b_bf16, f2b_bf16, Sp, dp, hp, fp, dn;  // dn: the norm's width
  GateSplit gs;
  ColSplit pj, f1;  // the projection and ff2 (d columns); ff1 (F columns)
  Stamps stamp;     // 18 a block: start, then each phase and each barrier's end
};

template <int NTG>
__global__ void __launch_bounds__(MMA_NT, 1) lstm_step_mma_kernel(const StepArgs a) {
  constexpr int UB = 2 * NTG, NC = 8 * NTG;
  extern __shared__ float4 smem_f4[];
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = a.S, d = a.d, H = a.H, F = a.F, Sp = a.Sp, dp = a.dp, hp = a.hp, fp = a.fp;
  const int ldg = 2 * dp + 16, ldp = hp + 16, ld1 = dp + 16, ld2 = fp + 16;
  const int pc = a.pj.ct * 8, fc = a.f1.ct * 8;
  uint8_t* Bg = reinterpret_cast<uint8_t*>(smem_f4);  // [NC][ldg]: w_ih | w_hh
  uint8_t* Bp = Bg + NC * ldg;                         // [pc][ldp]: w_hr
  uint8_t* B1 = Bp + pc * ldp;                         // [fc][ld1]: ff1
  uint8_t* B2 = B1 + fc * ld1;                         // [pc][ld2]: ff2
  uint8_t* stage = B2 + pc * ld2;
  float* gbuf = reinterpret_cast<float*>(stage + MMA_RING);  // [8][16][NC + 8]
  float* gcs = gbuf + 8 * 16 * (NC + 8);               // [3][NC]
  float* pcs = gcs + 3 * NC;                           // [3][pc]: w_hr, ff2 scales; ff2 bias
  float* fcs = pcs + 3 * pc;                           // [2][fc]: ff1 scales and bias
  float* xs = a.scl;
  float* hs = xs + Sp;
  float* hcs = hs + Sp;
  float* ys = hcs + Sp;
  float* ms = ys + Sp;
  unsigned* am_hc = a.amax;
  unsigned* am_y = am_hc + Sp;
  unsigned* am_m = am_y + Sp;
  int u0 = 0, g0 = 0, g1 = 0;
  const bool gate_blk = gate_item(a.gs, b, UB, Sp, u0, g0, g1);
  Item pi, fi;
  const bool proj_blk = col_item(a.pj, b, d, Sp, pi);
  const bool ff1_blk = col_item(a.f1, b, F, Sp, fi);
  a.stamp(0);

  if (gate_blk) {
    auto gcol = [&](int n) {
      const int gi = n / UB, U = u0 + n - gi * UB;
      return U < H ? gi * H + U : -1;
    };
    stage_cols(Bg, ldg, 0, a.wih, 4 * H, d, dp, NC, gcol);
    stage_cols(Bg, ldg, dp, a.whh, 4 * H, d, dp, NC, gcol);
    stage_gate_consts(gcs, NC, a.wihs, a.whhs, a.bias, a.bias_bf16, gcol);
  }
  if (proj_blk) {
    auto pcol = [&](int n) { return pi.c0 + n < pi.c1 ? pi.c0 + n : -1; };
    stage_cols(Bp, ldp, 0, a.whr, d, H, hp, pc, pcol);
    stage_cols(B2, ld2, 0, a.ff2, d, F, fp, pc, pcol);
    stage_item_consts(pcs, pi, pc, 3, [&](int v, int col) {
      return v == 0 ? a.whrs[col] : v == 1 ? a.ff2s[col] : load_vec(a.f2b, col, a.f2b_bf16);
    });
  }
  if (ff1_blk) {
    stage_cols(B1, ld1, 0, a.ff1, F, d, dp, fc,
               [&](int n) { return fi.c0 + n < fi.c1 ? fi.c0 + n : -1; });
    stage_item_consts(fcs, fi, fc, 2, [&](int v, int col) {
      return v == 0 ? a.ff1s[col] : load_vec(a.f1b, col, a.f1b_bf16);
    });
  }
  quant_rows(2 * S, [&](int r, const float*& src, int8_t*& dst, float*& sc, int& len) {
    const int s = r < S ? r : r - S;
    len = d;
    src = (r < S ? a.x : a.h) + (size_t)s * d;
    dst = (r < S ? a.xq : a.hq) + (size_t)s * dp;
    sc = (r < S ? xs : hs) + s;
  });
  grid_zero(a.amax, 3 * Sp);
  a.stamp(1);
  grid.sync();
  a.stamp(2);

  if (gate_blk) {
    const GateIn g{a.xq, a.hq, xs, hs, a.c, a.hcf, am_hc};
    gate_phase<NTG>(
        g, Bg, ldg, gcs, gbuf, stage, u0, g0, g1, S, dp, H,
        [&](int row) { return a.gate ? a.gate[row] : 0.f; },
        [&](int, size_t k, float cold, float cn, float gt) {
          a.c2[k] = a.gate ? blend(gt, cn, cold) : cn;
        });
  }
  a.stamp(3);
  grid.sync();
  a.stamp(4);
  if (gate_blk)
    quant_region(a.hcf, H, a.hcq, hp, am_hc, hcs, u0 == 0, g0, min(g1, S), u0, min(u0 + UB, H));
  a.stamp(5);
  grid.sync();
  a.stamp(6);
  if (proj_blk)
    cols_phase<MMA_NTW>(
        pi, a.hcq, hp, Bp, ldp, stage, S, am_y,
        [&](int row) { return make_float2(__ldcg(hcs + row), a.gate ? a.gate[row] : 0.f); },
        [&](int row, int col) {
          const size_t k = (size_t)row * d + col;
          return make_float2(a.x[k], a.h[k]);
        },
        [&](int row, int col, int acc, float2 r, float2 e) {
          const float hn = __fmul_rn((float)acc, __fmul_rn(r.x, pcs[col - pi.c0]));
          const size_t k = (size_t)row * d + col;
          a.h2[k] = a.gate ? blend(r.y, hn, e.y) : hn;
          const float y = __fadd_rn(e.x, hn);
          a.yf[k] = y;
          return fabsf(y);
        });
  a.stamp(7);
  grid.sync();
  a.stamp(8);
  if (proj_blk)
    quant_region(a.yf, d, a.yq, dp, am_y, ys, pi.c0 == 0, pi.r0, min(pi.r1, S), pi.c0, pi.c1);
  a.stamp(9);
  grid.sync();
  a.stamp(10);
  if (ff1_blk)
    cols_phase<MMA_NTW>(
        fi, a.yq, dp, B1, ld1, stage, S, am_m,
        [&](int row) { return make_float2(__ldcg(ys + row), 0.f); },
        [&](int, int) { return make_float2(0.f, 0.f); },
        [&](int row, int col, int acc, float2 r, float2) {
          const int n = col - fi.c0;
          const float m = __fadd_rn(__fmul_rn((float)acc, __fmul_rn(r.x, fcs[n])), fcs[fc + n]);
          const float mid = __fmul_rn(m, sig_tanh(__fsub_rn(m, 1.f)));
          a.mf[(size_t)row * F + col] = mid;
          return fabsf(mid);
        });
  a.stamp(11);
  grid.sync();
  a.stamp(12);
  if (ff1_blk)
    quant_region(a.mf, F, a.mq, fp, am_m, ms, fi.c0 == 0, fi.r0, min(fi.r1, S), fi.c0, fi.c1);
  a.stamp(13);
  grid.sync();
  a.stamp(14);
  if (proj_blk)
    cols_phase<MMA_NTW>(
        pi, a.mq, fp, B2, ld2, stage, S, nullptr,
        [&](int row) { return make_float2(__ldcg(ms + row), 0.f); },
        [&](int row, int col) { return make_float2(__ldcg(a.yf + (size_t)row * d + col), 0.f); },
        [&](int row, int col, int acc, float2 r, float2 e) {
          const int n = col - pi.c0;
          const float ff = __fadd_rn(__fmul_rn((float)acc, __fmul_rn(r.x, pcs[pc + n])),
                                     pcs[2 * pc + n]);
          a.yf[(size_t)row * d + col] = __fadd_rn(e.x, ff);
          return 0.f;
        });
  a.stamp(15);
  grid.sync();
  a.stamp(16);
  // BasicNorm, one warp a row, in basic_norm_rows' order (csrc/ffn_norm.cuh),
  // the mean over dn columns (d, or d_model where d is zero-padded)
  const float e = a.eps[0];
  for (int row = b * (MMA_NT / 32) + warp; row < S; row += gridDim.x * (MMA_NT / 32)) {
    const float* yr = a.yf + (size_t)row * d;
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = __ldcg(yr + k);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
    ss = warp_sum(ss);
    const float rs = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)a.dn), e));
    for (int k = lane; k < d; k += 32) a.y[(size_t)row * d + k] = __fmul_rn(__ldcg(yr + k), rs);
  }
  a.stamp(17);
}

static size_t rec_smem(int ub, int dp, int hp, int pj_ct) {
  return gate_smem(ub, dp) + item_smem(pj_ct, hp, 1) + MMA_RING;
}

static size_t step_smem(int ub, int dp, int hp, int fp, int pj_ct, int f1_ct) {
  return gate_smem(ub, dp) + item_smem(pj_ct, hp, 3) + item_smem(f1_ct, dp, 2)
         + item_smem(pj_ct, fp, 0) + MMA_RING;
}

// Kernel 2. Scratch from the wrapper: xq [P][Sp][dp], hq [Sp][dp], hcq
// [Sp][hp] int8, hcf [S][H] and scl [P + 2][Sp] f32, amax [4][Sp]; stamps
// null, or [nb][3 + 8 P] for the phase times (`Stamps`); the plan: ub (4, 8
// or 16 hidden units a gate item), nb blocks, the gate split's rows, unit
// groups and items, the projection's ColSplit. Returns minus the
// shared-memory bytes where they do not fit, else the launch's CUDA error.
extern "C" int lstm_rec_stream2_i8(const float* x, const float* h, const float* c,
                                   const int* npulls, const int8_t* wih, const float* wihs,
                                   const int8_t* whh, const float* whhs, const void* bias,
                                   const int8_t* whr, const float* whrs, float* hseq, float* h2,
                                   float* c2, int8_t* xq, int8_t* hq, int8_t* hcq, float* hcf,
                                   float* scl, unsigned* amax, unsigned long long* stamps, int P,
                                   int S, int d, int H, int bias_bf16, int Sp, int dp, int hp,
                                   int ub, int nb, int g_rows, int g_ngu, int g_items, int pj_ct,
                                   int pj_rows, int pj_ncg, int pj_items, void* stream) {
  const RecArgs a{x, h, c, npulls, wih, whh, whr, wihs, whhs, whrs, bias, hseq, h2, c2, xq, hq,
                  hcq, hcf, scl, amax, P, S, d, H, bias_bf16, Sp, dp, hp,
                  GateSplit{g_rows, g_ngu, g_items}, ColSplit{pj_ct, pj_rows, pj_ncg, pj_items},
                  Stamps{stamps, 3 + 8 * P}};
  const size_t smem = rec_smem(ub, dp, hp, pj_ct);
  if (ub == 4) return coop_launch(lstm_rec_mma_kernel<2>, a, nb, smem, stream);
  if (ub == 8) return coop_launch(lstm_rec_mma_kernel<4>, a, nb, smem, stream);
  if (ub == 16) return coop_launch(lstm_rec_mma_kernel<8>, a, nb, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 7. gate: [S] f32 or null (ungated). Scratch: xq, hq, yq [Sp][dp],
// hcq [Sp][hp], mq [Sp][fp] int8, hcf [S][H], yf [S][d], mf [S][F] and scl
// [5][Sp] f32, amax [3][Sp]; stamps null or [nb][18]; the plan as kernel
// 2's, with ff1's ColSplit.
extern "C" int lstm_step_i8(const float* x, const float* h, const float* c, const float* gate,
                            const int8_t* wih, const float* wihs, const int8_t* whh,
                            const float* whhs, const void* bias, const int8_t* whr,
                            const float* whrs, const int8_t* ff1, const float* ff1s,
                            const void* f1b, const int8_t* ff2, const float* ff2s, const void* f2b,
                            const float* eps, float* y, float* h2, float* c2, int8_t* xq,
                            int8_t* hq, int8_t* hcq, int8_t* yq, int8_t* mq, float* hcf, float* yf,
                            float* mf, float* scl, unsigned* amax, unsigned long long* stamps,
                            int S, int d, int H, int F, int bias_bf16, int f1b_bf16, int f2b_bf16,
                            int Sp, int dp, int hp, int fp, int ub, int nb, int g_rows, int g_ngu,
                            int g_items, int pj_ct, int pj_rows, int pj_ncg, int pj_items,
                            int f1_ct, int f1_rows, int f1_ncg, int f1_items, int dn,
                            void* stream) {
  const StepArgs a{x, h, c, gate, wih, whh, whr, ff1, ff2, wihs, whhs, whrs, ff1s, ff2s, eps,
                   bias, f1b, f2b, y, h2, c2, xq, hq, hcq, yq, mq, hcf, yf, mf, scl, amax,
                   S, d, H, F, bias_bf16, f1b_bf16, f2b_bf16, Sp, dp, hp, fp, dn,
                   GateSplit{g_rows, g_ngu, g_items},
                   ColSplit{pj_ct, pj_rows, pj_ncg, pj_items},
                   ColSplit{f1_ct, f1_rows, f1_ncg, f1_items}, Stamps{stamps, 18}};
  const size_t smem = step_smem(ub, dp, hp, fp, pj_ct, f1_ct);
  if (ub == 4) return coop_launch(lstm_step_mma_kernel<2>, a, nb, smem, stream);
  if (ub == 8) return coop_launch(lstm_step_mma_kernel<4>, a, nb, smem, stream);
  if (ub == 16) return coop_launch(lstm_step_mma_kernel<8>, a, nb, smem, stream);
  return (int)cudaErrorInvalidValue;
}
