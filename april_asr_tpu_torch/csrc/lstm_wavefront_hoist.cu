// Kernel 15 redesigned for the H100: a slab of Lk int8 residual LSTMP layers
// on the anti-diagonal (wavefront) schedule as one persistent cooperative
// launch whose diagonals run every live layer's step as tile phases.
//
// Replaces april_asr_tpu/ops/lstm_wavefront_pallas.py
// `lstm_slab_wavefront_i8` (`_wavefront_kernel_i8`): at diagonal D every
// layer l with 0 <= t = D - l < P runs its timestep t, FFN and norm
// included, so the layers' recurrences overlap. Layer 0 reads x[t], layer l
// > 0 layer l - 1's output of diagonal D - 1, the last layer writes y[t];
// y comes from the ungated h_new, h and c keep their values where t >=
// n_pulls. The CUDA-core template it replaced stays as
// csrc/lstm_wavefront.cu (`lstm_wavefront_i8_simt`): one launch per
// diagonal, blocks of 2 sessions x 1 layer, each re-reading its layer's 6.8
// MB of int8 weights from L2 and multiplying them on IMAD loops (63 ms a
// 6-layer slab at the flagship, S = 256, P = 27, on an H100; PERF.md).
//
// What bounds it on the H100. A diagonal at the flagship (d 512, H 1024, F
// 2048), S = 256, six live layers is ~21 G int8 operations (gates 12.9 G,
// projection 1.6 G, ff1 and ff2 6.4 G): 11 us at 1,979 TOP/s. Its weights
// are 41 MB for six layers (they stay in the 50 MB L2) and 82 MB for twelve
// (they do not). Here every product is a phase of 128 x 128 int8 tiles on
// `mma.sync` m16n8k32 s8 (csrc/mma_tile.cuh: kernel 3's loop, the depth in
// 64-byte stages through two shared stages, the next stage's A rows and
// weights loaded into registers while the warps multiply), the tiles of
// every live layer walked over the launch's blocks, so the weights cross
// from L2 once per 128-row band per diagonal and the diagonal's live layers
// give the phase its parallelism (384 gate tiles at S = 256 and six live
// layers for 132 SMs). No matrix stays stationary in shared memory: the FFN
// tile stages come back on every diagonal, so stationary weights would
// have to sit beside them, and a stationary slice would tie each item to
// one block on every diagonal. A block's shared memory (WF_SMEM, 107,008
// bytes) is kernel 3's two tile stages, a tile's row amax slots and the
// gate tile's x-side gates, parked while it runs the h-side dot.
//
// A diagonal's phases, each over every live layer's rows or tiles, with a
// grid barrier after each (csrc/lstm_mma.cuh, cooperative groups):
//
//   gates: tile (layer, 128-row band, 32 hidden units). Its 128 columns are
//     the four gates of 32 units, laid out so that an mma lane's four
//     8-column tiles are the four gates of its units (`wf_gate_load`): the
//     x-side dot over d, then the h-side dot over d, both exact int32 sums;
//     gate = fl(fl(dot_x * fl(xs * s_ih) + dot_h * fl(hs * s_hh)) + b) and
//     the f32 cell in registers; hc to a scratch, c where t < n_pulls.
//   hcq: _rowq8 of every hc row, one warp a row.
//   projection: tile (layer, band, 128 columns of d): h_new into hseq, the
//     carried h where t < n_pulls.
//   yq, ff1, mq, ff2, norm: kernel 3's five passes (csrc/ffn_mma.cuh, as
//     kernel 11 runs them) on each live layer's S rows, ff2's output into
//     layer l's slot of the inter-layer ring (y[t] for the last layer).
//     The warp that norms a row also quantizes it as layer l + 1's input
//     (the same warp_rowq8 the next layer would run), and the same phase
//     quantizes x[D + 1] for layer 0 and the carried h of every layer live
//     at D + 1: so a diagonal has 8 phases and 8 grid barriers.
//
// Layer l's output of diagonal D is read by layer l + 1 at D + 1 (its
// residual, in yq and ff2) while layer l writes its next output, so the
// ring [2][Lk][S][d] is double buffered by diagonal parity, as the template
// has it. Every other buffer is one per layer: its writes and reads lie in
// one diagonal, or in the row phase that ends diagonal D and the gate phase
// of D + 1, with grid barriers between. The mid row amax slots are zeroed
// by the yq pass of every diagonal. Items and rows of dead layers are
// never enumerated.
//
// Numerics: the integer dots are exact in any order; the gates and cell in
// csrc/lstm_i8.cuh `rec_gates_cell`'s op order, the projection in
// `rec_proj`'s, the quantizations by `warp_rowq8`, the FFN and norm by
// kernel 3's passes (bit for bit csrc/ffn_norm.cuh `ffn_norm_tile`), so the
// outputs equal the template's, `layer_step_i8` on every (layer, step), bit
// for bit; chip_smoke.py holds them to that.

#include "ffn_mma.cuh"   // kernel 3's passes; mma_tile.cuh's tile loop
#include "lstm_mma.cuh"  // grid barriers, Stamps, coop_launch

#define WF_UNITS 32                  // hidden units of a gate tile (x 4 gates = FM_BN columns)
#define WF_WARPS (FM_NT / 32)        // rows of a one-warp-a-row phase a block and round
#define WF_STAMPS 16                 // stamps a diagonal: after each of 8 phases and barriers
#define WF_GX 64                     // x-side gates a thread of a gate tile parks in shared memory
// Bytes of the block's shared memory: kernel 3's two tile stages and a
// tile's row amax slots, then the gate tile's parked x-side gates
#define WF_SMEM (FM_TILE_SMEM + WF_GX * FM_NT * 4)

struct WfArgs {
  const float *x, *h0, *c0;  // [P][S][d], [Lk][S][d], [Lk][S][H]
  const int* np;             // [S]
  const int8_t *wih, *whh, *whr, *ff1, *ff2;  // [Lk][...] int8
  const float *wihs, *whhs, *whrs, *ff1s, *ff2s, *eps;
  const void *bias, *f1b, *f2b;               // f32 or bf16
  float *y, *h2, *c2;                         // [P][S][d], [Lk][S][d], [Lk][S][H]
  int8_t *xq, *hq, *hcq, *yq, *mq;            // [Lk][sp][dp | dp | hp | dp | fp]
  float* scl;                                 // [5][Lk][sp]: x, h, hc, y, mid row scales
  unsigned* amax;                             // [Lk][sp]: mid's row amax
  float *hcf, *hseq, *mid, *ring;  // [Lk][S][H], [Lk][S][d], [Lk][S][F], [2][Lk][S][d]
  int P, S, d, H, F, Lk, bias_bf16, f1b_bf16, f2b_bf16, sp, dp, hp, fp;
  Stamps stamp;  // 3 + WF_STAMPS (P + Lk - 1) a block
};

// Row scales of kind k (0 x, 1 h, 2 hc, 3 y, 4 mid) of layer l
__device__ __forceinline__ float* wf_scl(const WfArgs& a, int k, int l) {
  return a.scl + ((size_t)k * a.Lk + l) * a.sp;
}

// Layer l's input rows at diagonal D (its step t = D - l), and its output
__device__ __forceinline__ const float* wf_in(const WfArgs& a, int D, int l) {
  const size_t sd = (size_t)a.S * a.d;
  return l == 0 ? a.x + (size_t)D * sd : a.ring + ((size_t)((D - 1) & 1) * a.Lk + l - 1) * sd;
}

__device__ __forceinline__ float* wf_out(const WfArgs& a, int D, int l) {
  const size_t sd = (size_t)a.S * a.d;
  return l == a.Lk - 1 ? a.y + (size_t)(D - l) * sd : a.ring + ((size_t)(D & 1) * a.Lk + l) * sd;
}

__device__ __forceinline__ const void* wf_vec(const void* p, size_t off, int bf16) {
  return bf16 ? (const void*)((const uint16_t*)p + off) : (const void*)((const float*)p + off);
}

// Kernel 3's operands for layer l at diagonal D over its S rows
__device__ __forceinline__ FfnArgs wf_ffn(const WfArgs& a, int D, int l) {
  const size_t S = a.S, d = a.d, F = a.F, sp = a.sp;
  return FfnArgs{wf_in(a, D, l), a.hseq + l * S * d, a.ff1 + l * d * F, a.ff2 + l * F * d,
                 a.ff1s + l * F, a.ff2s + l * d, a.eps + l, wf_vec(a.f1b, l * F, a.f1b_bf16),
                 wf_vec(a.f2b, l * d, a.f2b_bf16), wf_out(a, D, l), a.yq + l * sp * a.dp,
                 a.mq + l * sp * a.fp, wf_scl(a, 3, l), a.mid + l * S * F, wf_scl(a, 4, l),
                 a.amax + l * sp, a.S, a.d, a.F, a.dp, a.fp, a.f1b_bf16, a.f2b_bf16, a.d};
}

// _rowq8 of one row of n floats into q (row stride at least np, zero past
// n), its scale into *sc; one warp
__device__ __forceinline__ void wf_rowq8(const float* v, int n, int np, int8_t* q, float* sc,
                                         int lane) {
  const float s = warp_rowq8(v, n, q, lane);
  for (int k = n + lane; k < np; k += 32) q[k] = 0;
  if (lane == 0) *sc = s;
}

// fm_load with the gate tile's columns: local column n of B is gate (n % 32)
// / 8 of unit u0 + (n / 32) * 8 + n % 8 of W [K][4H], so that mma column
// tile ni of every warp holds gate ni (zero past K and past H)
__device__ __forceinline__ void wf_gate_load(FmStaged& st, const int8_t* __restrict__ A, int lda,
                                             const int8_t* __restrict__ W, int K, int H, int m0,
                                             int u0, int k0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = tid + j * FM_NT, row = c >> 2, p = c & 3;
    st.a[j] = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + row) * lda + k0 + p * 16);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int wb = j * 8 + warp, kg = (wb >> 2) * 4 + (lane >> 3), ng = (wb & 3) * 8 + (lane & 7);
    const int k = k0 + kg * 4, U = u0 + (ng >> 3) * 8 + (ng & 1) * 4, col = ((ng & 7) >> 1) * H + U;
    const bool ok = k < K && U < H;  // K and H are multiples of 4
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st.b[j][r] =
          ok ? __ldg(reinterpret_cast<const unsigned*>(W + (size_t)(k + r) * 4 * H + col)) : 0u;
  }
}

// The gate tile of layer l at step t: rows [m0, m0 + 128), hidden units
// [u0, u0 + 32). acc[mi][gi][e] is gate gi of unit u0 + wn * 8 + 2 (lane %
// 4) + (e & 1) for row wm * 64 + mi * 16 + lane / 4 (+ 8 for e >= 2). The
// x-side gates wait for the h-side dot in the thread's own WF_GX slots of
// gxs (slot j at gxs[j * FM_NT + thread]), not in registers: held there
// beside both dots' operands they pushed the kernel past 255 registers.
__device__ __forceinline__ void wf_gate_tile(const WfArgs& a, uint8_t (*smem)[FM_STAGE],
                                             float* gxs, int l, int t, int m0, int u0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int S = a.S, d = a.d, H = a.H, G = 4 * H, dp = a.dp;
  const int8_t* xq = a.xq + (size_t)l * a.sp * dp;
  const int8_t* hq = a.hq + (size_t)l * a.sp * dp;
  const int8_t* wih = a.wih + (size_t)l * d * G;
  const int8_t* whh = a.whh + (size_t)l * d * G;
  const float* wihs = a.wihs + (size_t)l * G;
  const float* whhs = a.whhs + (size_t)l * G;
  float* gx = gxs + tid;
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int KT = dp / FM_KT;  // depth stages of each side
  FmStaged st;
  wf_gate_load(st, xq, dp, wih, d, H, m0, u0, 0);
  fm_store(st, smem[0]);
  __syncthreads();
  for (int kt = 0; kt < 2 * KT; ++kt) {
    const int nk = kt + 1;
    const bool hside = nk >= KT;
    if (nk < 2 * KT)
      wf_gate_load(st, hside ? hq : xq, dp, hside ? whh : wih, d, H, m0, u0,
                   (hside ? nk - KT : nk) * FM_KT);
    fm_mma(acc, smem[kt & 1], wm, wn);
    if (kt == KT - 1) {  // the x-side dot is whole: gx = fl(dot * fl(xs * s_ih)), acc restarts
      const float* xs = wf_scl(a, 0, l);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + wm * 64 + mi * 16 + g + (e >> 1) * 8;
          const int U = u0 + wn * 8 + 2 * q + (e & 1);
          const float s = row < S ? __ldcg(xs + row) : 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            gx[((mi * 4 + ni) * 4 + e) * FM_NT] =
                U < H ? __fmul_rn((float)acc[mi][ni][e], __fmul_rn(s, wihs[ni * H + U])) : 0.f;
            acc[mi][ni][e] = 0;
          }
        }
    }
    if (nk < 2 * KT) fm_store(st, smem[nk & 1]);
    __syncthreads();
  }

  // gh, the gates and the cell (rec_gates_cell's op order), a lane's units
  // U, U + 1 of rows gq and gq + 8 of each 16-row tile
  const float* hs = wf_scl(a, 1, l);
  const int U = u0 + wn * 8 + 2 * q;  // even, and H is a multiple of 4: U + 1 < H too
  if (U >= H) return;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 64 + mi * 16 + g + hh * 8;
      if (row >= S) continue;
      const float hsr = __ldcg(hs + row);
      const size_t k = ((size_t)l * S + row) * H + U;
      const float2 cold = __ldcg(reinterpret_cast<const float2*>(a.c2 + k));
      float hc[2], cn[2];
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float v[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
          const int col = gi * H + U + o, e = 2 * hh + o;
          const float gh = __fmul_rn((float)acc[mi][gi][e], __fmul_rn(hsr, whhs[col]));
          v[gi] = __fadd_rn(__fadd_rn(gx[((mi * 4 + gi) * 4 + e) * FM_NT], gh),
                            load_vec(a.bias, (size_t)l * G + col, a.bias_bf16));
        }
        const float c = o ? cold.y : cold.x;
        cn[o] = __fadd_rn(__fmul_rn(sig_tanh(v[1]), c), __fmul_rn(sig_tanh(v[0]), tanhf(v[2])));
        hc[o] = __fmul_rn(sig_tanh(v[3]), tanhf(cn[o]));
      }
      __stcg(reinterpret_cast<float2*>(a.hcf + k), make_float2(hc[0], hc[1]));
      if (t < __ldg(a.np + row))
        __stcg(reinterpret_cast<float2*>(a.c2 + k), make_float2(cn[0], cn[1]));
    }
}

// The projection tile of layer l at step t: rows [m0, m0 + 128), columns
// [n0, n0 + 128) of h_new = fl(dot(hcq, w_hr) * fl(hcs * s_hr)) into hseq,
// and into the carried h where t < n_pulls (rec_proj's op order)
__device__ __forceinline__ void wf_proj_tile(const WfArgs& a, uint8_t (*smem)[FM_STAGE], int l,
                                             int t, int m0, int n0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int S = a.S, d = a.d, H = a.H, hp = a.hp;
  const int8_t* A = a.hcq + (size_t)l * a.sp * hp;
  const int8_t* W = a.whr + (size_t)l * H * d;
  const float* whrs = a.whrs + (size_t)l * d;
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int KT = hp / FM_KT;
  FmStaged st;
  fm_load(st, A, hp, W, H, d, m0, n0, 0);
  fm_store(st, smem[0]);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fm_load(st, A, hp, W, H, d, m0, n0, (kt + 1) * FM_KT);
    fm_mma(acc, smem[kt & 1], wm, wn);
    if (kt + 1 < KT) fm_store(st, smem[(kt + 1) & 1]);
    __syncthreads();
  }

  const float* hcs = wf_scl(a, 2, l);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * 64 + mi * 16 + g + hh * 8;
      if (row >= S) continue;
      const float r = __ldcg(hcs + row);
      const bool live = t < __ldg(a.np + row);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + q * 2;
        if (col >= d) continue;  // d is a multiple of 4: col + 1 < d too
        float2 hn;
        hn.x = __fmul_rn((float)acc[mi][ni][2 * hh], __fmul_rn(r, whrs[col]));
        hn.y = __fmul_rn((float)acc[mi][ni][2 * hh + 1], __fmul_rn(r, whrs[col + 1]));
        const size_t k = ((size_t)l * S + row) * d + col;
        __stcg(reinterpret_cast<float2*>(a.hseq + k), hn);
        if (live) __stcg(reinterpret_cast<float2*>(a.h2 + k), hn);
      }
    }
}

// The row phase that ends diagonal D: rows [0, nl S) norm live layer l = lo
// + r / S's output row and quantize it as layer l + 1's input; then, where
// D + 1 < P, x[D + 1]'s rows into layer 0's input; then the carried h rows
// of every layer live at D + 1 (lo1 .. lo1 + nl1 - 1). One warp a row.
__device__ __forceinline__ void wf_end_rows(const WfArgs& a, int D, int lo, int nl, int lo1,
                                            int nl1) {
  const int lane = threadIdx.x & 31, S = a.S, d = a.d;
  const int nx = D + 1 < a.P ? S : 0, n = nl * S + nx + nl1 * S;
  for (int r = blockIdx.x * WF_WARPS + (threadIdx.x >> 5); r < n; r += gridDim.x * WF_WARPS) {
    if (r < nl * S) {
      const int l = lo + r / S, row = r % S;
      const FfnArgs f = wf_ffn(a, D, l);
      ffn_norm_row(f, row, lane);
      if (l + 1 < a.Lk) {
        __syncwarp();
        const size_t q = (size_t)(l + 1) * a.sp + row;
        wf_rowq8(f.out + (size_t)row * d, d, a.dp, a.xq + q * a.dp, wf_scl(a, 0, l + 1) + row,
                 lane);
      }
    } else if (r < nl * S + nx) {
      const int row = r - nl * S;
      wf_rowq8(a.x + ((size_t)(D + 1) * S + row) * d, d, a.dp, a.xq + (size_t)row * a.dp,
               wf_scl(a, 0, 0) + row, lane);
    } else {
      const int i = r - nl * S - nx, l = lo1 + i / S, row = i % S;
      const size_t q = (size_t)l * a.sp + row;
      wf_rowq8(a.h2 + ((size_t)l * S + row) * d, d, a.dp, a.hq + q * a.dp, wf_scl(a, 1, l) + row,
               lane);
    }
  }
}

// Live layers [lo, lo + n) at diagonal D >= 0 (none past the last)
__device__ __forceinline__ void wf_live(const WfArgs& a, int D, int& lo, int& n) {
  lo = max(0, D - a.P + 1);
  n = max(0, min(D, a.Lk - 1) - lo + 1);
}

// The slab: h2, c2 from h0, c0, layer 0's first x and h rows quantized;
// then every diagonal's 8 phases, a grid barrier after each. Tile i of a
// product phase is (live layer lo + i / T, row band, column tile) with T
// tiles a layer in (band, column) order, on block i mod nb.
__global__ void __launch_bounds__(FM_NT, 1)
    lstm_wavefront_hoist_kernel(const __grid_constant__ WfArgs a) {
  extern __shared__ float4 smem_f4[];  // WF_SMEM bytes
  uint8_t(*stage)[FM_STAGE] = reinterpret_cast<uint8_t(*)[FM_STAGE]>(smem_f4);
  unsigned* rmax = reinterpret_cast<unsigned*>(stage + 2);
  float* gxs = reinterpret_cast<float*>(rmax + FM_BM);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, S = a.S, Lk = a.Lk;
  const int w0 = blockIdx.x * WF_WARPS + (threadIdx.x >> 5), ws = gridDim.x * WF_WARPS;
  const int bands = a.sp / FM_BM, ngu = (a.H + WF_UNITS - 1) / WF_UNITS;
  const int gt = bands * ngu, pt = bands * ((a.d + FM_BN - 1) / FM_BN),
            ft = bands * ((a.F + FM_BN - 1) / FM_BN);
  auto sync = [&](int k) {
    a.stamp(k);
    grid.sync();
    a.stamp(k + 1);
  };
  a.stamp(0);
  grid_copy(a.h2, a.h0, (size_t)Lk * S * a.d);
  grid_copy(a.c2, a.c0, (size_t)Lk * S * a.H);
  for (int r = w0; r < 2 * S; r += ws) {  // layer 0's x[0] and h0 rows
    const bool xr = r < S;
    const int row = xr ? r : r - S;
    wf_rowq8((xr ? a.x : a.h0) + (size_t)row * a.d, a.d, a.dp,
             (xr ? a.xq : a.hq) + (size_t)row * a.dp, wf_scl(a, xr ? 0 : 1, 0) + row, lane);
  }
  sync(1);
  for (int D = 0; D < a.P + Lk - 1; ++D) {
    int lo, nl, lo1, nl1;
    wf_live(a, D, lo, nl);
    wf_live(a, D + 1, lo1, nl1);
    const int k0 = 3 + WF_STAMPS * D;
    for (int i = blockIdx.x; i < nl * gt; i += gridDim.x) {
      const int l = lo + i / gt, j = i % gt;
      wf_gate_tile(a, stage, gxs, l, D - l, (j / ngu) * FM_BM, (j % ngu) * WF_UNITS);
    }
    sync(k0);
    for (int r = w0; r < nl * S; r += ws) {
      const int l = lo + r / S, row = r % S;
      const size_t q = (size_t)l * a.sp + row;
      wf_rowq8(a.hcf + ((size_t)l * S + row) * a.H, a.H, a.hp, a.hcq + q * a.hp,
               wf_scl(a, 2, l) + row, lane);
    }
    sync(k0 + 2);
    for (int i = blockIdx.x; i < nl * pt; i += gridDim.x) {
      const int l = lo + i / pt, j = i % pt, nx = pt / bands;
      wf_proj_tile(a, stage, l, D - l, (j / nx) * FM_BM, (j % nx) * FM_BN);
    }
    sync(k0 + 4);
    for (int r = w0; r < nl * S; r += ws) ffn_yq_row(wf_ffn(a, D, lo + r / S), r % S, lane);
    sync(k0 + 6);
    for (int i = blockIdx.x; i < nl * ft; i += gridDim.x) {
      const int j = i % ft, nx = ft / bands;
      ffn_tile<true>(wf_ffn(a, D, lo + i / ft), stage, rmax, j / nx, j % nx);
    }
    sync(k0 + 8);
    for (int r = w0; r < nl * S; r += ws) ffn_mq_row(wf_ffn(a, D, lo + r / S), r % S, lane);
    sync(k0 + 10);
    for (int i = blockIdx.x; i < nl * pt; i += gridDim.x) {
      const int j = i % pt, nx = pt / bands;
      ffn_tile<false>(wf_ffn(a, D, lo + i / pt), stage, rmax, j / nx, j % nx);
    }
    sync(k0 + 12);
    wf_end_rows(a, D, lo, nl, lo1, nl1);
    sync(k0 + 14);
  }
}

// Kernel 15: one cooperative launch of nb blocks on the caller's stream.
// Scratch from the wrapper (ops/lstm_mma.py `WavefrontPlan.scratch`): xq,
// hq [Lk][sp][dp], hcq [Lk][sp][hp], yq [Lk][sp][dp], mq [Lk][sp][fp] int8,
// the row scales [5][Lk][sp] f32, mid's amax slots [Lk][sp], hc [Lk][S][H],
// hseq [Lk][S][d], mid [Lk][S][F] and the ring [2][Lk][S][d] f32; stamps
// null, or [nb][3 + 16 (P + Lk - 1)]; the plan (`wavefront_plan`): sp = S
// rounded up to 128, dp, hp, fp = d, H, F rounded up to 64, nb blocks.
// Returns minus WF_SMEM where that exceeds the device's shared memory,
// cudaErrorInvalidValue for widths or paddings it does not take, else the
// launch's CUDA error.
extern "C" int lstm_wavefront_hoist_i8(
    const float* x, const float* h, const float* c, const int* npulls, const int8_t* wih,
    const float* wihs, const int8_t* whh, const float* whhs, const void* bias, const int8_t* whr,
    const float* whrs, const int8_t* ff1, const float* ff1s, const void* f1b, const int8_t* ff2,
    const float* ff2s, const void* f2b, const float* eps, float* y, float* h2, float* c2,
    int8_t* xq, int8_t* hq, int8_t* hcq, int8_t* yq, int8_t* mq, float* scl, unsigned* amax,
    float* hcf, float* hseq, float* mid, float* ring, unsigned long long* stamps, int P, int S,
    int d, int H, int F, int Lk, int bias_bf16, int f1b_bf16, int f2b_bf16, int sp, int dp, int hp,
    int fp, int nb, void* stream) {
  if (P < 1 || S < 1 || Lk < 1 || nb < 1 || d < 4 || H < 4 || F < 4 || d % 4 || H % 4 || F % 4 ||
      sp % FM_BM || sp < S || dp % FM_KT || dp < d || hp % FM_KT || hp < H || fp % FM_KT || fp < F)
    return (int)cudaErrorInvalidValue;
  const WfArgs a{x,    h,    c,    npulls, wih,  whh,  whr,  ff1,  ff2,   wihs,     whhs,
                 whrs, ff1s, ff2s, eps,    bias, f1b,  f2b,  y,    h2,    c2,       xq,
                 hq,   hcq,  yq,   mq,     scl,  amax, hcf,  hseq, mid,   ring,     P,
                 S,    d,    H,    F,      Lk,   bias_bf16, f1b_bf16, f2b_bf16, sp, dp,
                 hp,   fp,   Stamps{stamps, 3 + WF_STAMPS * (P + Lk - 1)}};
  return coop_launch(lstm_wavefront_hoist_kernel, a, nb, WF_SMEM, stream);
}
