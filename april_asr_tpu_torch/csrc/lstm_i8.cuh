// The int8 residual LSTMP step, in pieces shared by the chunk-layer kernels:
// the recurrent cores 2, 13 and 14 (csrc/lstm_i8.cu), the fused whole layer
// 11 (csrc/lstm_chunk_i8.cu) and the wavefront slab 15
// (csrc/lstm_wavefront.cu). All run blocks of REC_NT threads that own a tile
// of TS sessions, with the tile's rows in shared memory.
//
//   rec_gates_cell: gates = dot(xq, w_ih) * (xs * s_ih) + dot(hq, w_hh) *
//     (hs * s_hh) + b (exact int32 dots), the f32 cell with the tanh-form
//     sigmoid; writes hc, and c where t < n_pulls. Each thread owns 4
//     consecutive hidden units (one char4 per gate row), so the cell needs
//     no exchange between threads.
//   rec_proj: h_new = dot(hcq, w_hr) * (hcs * s_hr), each thread 4
//     consecutive output columns; hands each value to the caller's `out`.
//   layer_step_i8: one timestep of the whole layer (kernels 11 and 15): the
//     two pieces above, y = x + h_new (ungated), then the FFN + BasicNorm of
//     csrc/ffn_norm.cuh (`ffn_norm_tile`) on the tile's TS rows.
//
// Numerics as csrc/common.cuh: _rowq8 per row, exact integer dots, every f32
// step rounded separately (no FMA contraction) in the JAX op order.
#pragma once

#include "ffn_norm.cuh"

#define REC_NT 256  // threads per block (= FFN_NT: layer_step_i8 runs both)

// Rows s0..s0+TS-1 of a row-major [S, n] matrix into a [TS][n] tile (rows
// past S read as zero), and back (rows past S not written).
template <int TS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int s0,
                                          int S, int n) {
  for (int i = threadIdx.x; i < TS * n; i += REC_NT) {
    const int r = i / n, s = s0 + r;
    dst[i] = s < S ? src[(size_t)s * n + (i - r * n)] : 0.f;
  }
}

template <int TS>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, int s0,
                                           int S, int n) {
  for (int i = threadIdx.x; i < TS * n; i += REC_NT) {
    const int r = i / n, s = s0 + r;
    if (s < S) dst[(size_t)s * n + (i - r * n)] = src[i];
  }
}

template <int TS>
__device__ __forceinline__ void rec_gates_cell(
    const int8_t* xq, const float* xs, const int8_t* hq, const float* hs,
    const int8_t* __restrict__ wih, const float* __restrict__ wihs,
    const int8_t* __restrict__ whh, const float* __restrict__ whhs, const void* __restrict__ bias,
    int bias_bf16, float* csh, float* hcs, const int (&np)[TS], int t, int d, int H) {
  const int G = 4 * H;
  for (int ug = threadIdx.x; ug < H / 4; ug += REC_NT) {
    const int u0 = ug * 4;
    float gate[4][TS][4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      int ax[TS][4], ah[TS][4];
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) ax[r][j] = ah[r][j] = 0;
      const int8_t* wx = wih + g * H + u0;
      const int8_t* wh = whh + g * H + u0;
      for (int k = 0; k < d; ++k) {
        const char4 a = *reinterpret_cast<const char4*>(wx + (size_t)k * G);
        const char4 b = *reinterpret_cast<const char4*>(wh + (size_t)k * G);
#pragma unroll
        for (int r = 0; r < TS; ++r) {
          imad4(ax[r], xq[r * d + k], a);
          imad4(ah[r], hq[r * d + k], b);
        }
      }
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = g * H + u0 + j;
          const float gx = __fmul_rn((float)ax[r][j], __fmul_rn(xs[r], wihs[col]));
          const float gh = __fmul_rn((float)ah[r][j], __fmul_rn(hs[r], whhs[col]));
          gate[g][r][j] = __fadd_rn(__fadd_rn(gx, gh), load_vec(bias, col, bias_bf16));
        }
    }
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = r * H + u0 + j;
        const float cold = csh[u];
        const float cn = __fadd_rn(__fmul_rn(sig_tanh(gate[1][r][j]), cold),
                                   __fmul_rn(sig_tanh(gate[0][r][j]), tanhf(gate[2][r][j])));
        hcs[u] = __fmul_rn(sig_tanh(gate[3][r][j]), tanhf(cn));
        if (t < np[r]) csh[u] = cn;
      }
  }
}

// out(r, col, h_new) for every row r < TS and column col < d; hcsc [TS] are
// the rows' _rowq8 scales
template <int TS, class Out>
__device__ __forceinline__ void rec_proj(const int8_t* hcq, const float* hcsc,
                                         const int8_t* __restrict__ whr,
                                         const float* __restrict__ whrs, int d, int H, Out out) {
  for (int cg = threadIdx.x; cg < d / 4; cg += REC_NT) {
    int acc[TS][4];
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    const int8_t* w = whr + cg * 4;
    for (int k = 0; k < H; ++k) {
      const char4 a = *reinterpret_cast<const char4*>(w + (size_t)k * d);
#pragma unroll
      for (int r = 0; r < TS; ++r) imad4(acc[r], hcq[r * H + k], a);
    }
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg * 4 + j;
        out(r, col, __fmul_rn((float)acc[r][j], __fmul_rn(hcsc[r], whrs[col])));
      }
  }
}

// One layer's weights (int8 with f32 column scales; biases f32 or bf16)
struct LayerI8 {
  const int8_t *wih, *whh, *whr, *ff1, *ff2;
  const float *wihs, *whhs, *whrs, *ff1s, *ff2s, *eps;
  const void *bias, *f1b, *f2b;
  int bias_bf16, f1b_bf16, f2b_bf16;
};

// Layer l of a stack whose layer 0 is w (the [L, ...] leaves of the params)
__device__ __forceinline__ LayerI8 layer_at(const LayerI8& w, int l, int d, int H, int F) {
  const size_t G = 4 * (size_t)H;
  LayerI8 o = w;
  o.wih += l * d * G;
  o.whh += l * d * G;
  o.whr += (size_t)l * H * d;
  o.ff1 += (size_t)l * d * F;
  o.ff2 += (size_t)l * F * d;
  o.wihs += l * G;
  o.whhs += l * G;
  o.whrs += (size_t)l * d;
  o.ff1s += (size_t)l * F;
  o.ff2s += (size_t)l * d;
  o.eps += l;
  o.bias = w.bias_bf16 ? (const void*)((const uint16_t*)w.bias + l * G)
                       : (const void*)((const float*)w.bias + l * G);
  o.f1b = w.f1b_bf16 ? (const void*)((const uint16_t*)w.f1b + (size_t)l * F)
                     : (const void*)((const float*)w.f1b + (size_t)l * F);
  o.f2b = w.f2b_bf16 ? (const void*)((const uint16_t*)w.f2b + (size_t)l * d)
                     : (const void*)((const float*)w.f2b + (size_t)l * d);
  return o;
}

// The shared memory of layer_step_i8: the carried h [TS][d] and c [TS][H],
// hc [TS][H], x_t [TS][d], y [TS][d], mid [TS][F], the row scales and the
// int8 rows.
struct LayerSmem {
  float *hsh, *csh, *hcs, *xt, *y, *mid, *sc, *fsc;
  int8_t *xq, *hq, *hcq, *yq, *mq;
};

template <int TS>
__device__ __forceinline__ LayerSmem layer_smem(float* base, int d, int H, int F) {
  LayerSmem m;
  m.hsh = base;
  m.csh = m.hsh + TS * d;
  m.hcs = m.csh + TS * H;
  m.xt = m.hcs + TS * H;
  m.y = m.xt + TS * d;
  m.mid = m.y + TS * d;
  m.sc = m.mid + TS * F;  // [3][TS]: x, h, hc
  m.fsc = m.sc + 4 * TS;  // [2][TS]: y, mid
  m.xq = reinterpret_cast<int8_t*>(m.fsc + 4 * TS);
  m.hq = m.xq + TS * d;
  m.hcq = m.hq + TS * d;
  m.yq = m.hcq + TS * H;
  m.mq = m.yq + TS * d;
  return m;
}

template <int TS>
static size_t layer_smem_bytes(int d, int H, int F) {
  return sizeof(float) * (size_t)(TS * (3 * d + 2 * H + F) + 8 * TS) + (size_t)TS * (3 * d + H + F);
}

// One timestep t of the whole layer for the tile s0.. (h, c carried in
// m.hsh, m.csh): x_t rows from xsrc [S, d], y rows to out [S, d]. y comes
// from the ungated h_new; h and c keep their values where t >= n_pulls.
template <int TS>
__device__ __forceinline__ void layer_step_i8(const LayerSmem& m, const LayerI8& w,
                                              const float* __restrict__ xsrc,
                                              float* __restrict__ out, const int (&np)[TS], int t,
                                              int s0, int S, int d, int H, int F) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows<TS>(m.xt, xsrc, s0, S, d);
  __syncthreads();
  if (warp < TS) {
    const float s = warp_rowq8(m.xt + warp * d, d, m.xq + warp * d, lane);
    if (lane == 0) m.sc[warp] = s;
  } else if (warp < 2 * TS) {
    const int r = warp - TS;
    const float s = warp_rowq8(m.hsh + r * d, d, m.hq + r * d, lane);
    if (lane == 0) m.sc[TS + r] = s;
  }
  __syncthreads();
  rec_gates_cell<TS>(m.xq, m.sc, m.hq, m.sc + TS, w.wih, w.wihs, w.whh, w.whhs, w.bias,
                     w.bias_bf16, m.csh, m.hcs, np, t, d, H);
  __syncthreads();
  if (warp < TS) {
    const float s = warp_rowq8(m.hcs + warp * H, H, m.hcq + warp * H, lane);
    if (lane == 0) m.sc[2 * TS + warp] = s;
  }
  __syncthreads();
  rec_proj<TS>(m.hcq, m.sc + 2 * TS, w.whr, w.whrs, d, H, [&](int r, int col, float hn) {
    m.y[r * d + col] = __fadd_rn(m.xt[r * d + col], hn);
    if (t < np[r]) m.hsh[r * d + col] = hn;
  });
  ffn_norm_tile<TS, TS>(m.y, m.mid, m.fsc, m.yq, m.mq, w.ff1, w.ff1s, w.f1b, w.ff2, w.ff2s, w.f2b,
                        w.eps, out, s0, S, d, F, w.f1b_bf16, w.f2b_bf16, d);
  __syncthreads();
}
