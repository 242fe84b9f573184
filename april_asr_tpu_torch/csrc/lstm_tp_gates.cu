// Kernels 18 and 19 as one launch each: the tensor-parallel step's gates and
// cell (and, for kernel 18, the recurrent projection's partial), bit for bit
// the two-pass kernels they replace (csrc/lstm_tp.cu `tp_gate_cell_proj_simt`,
// `tp_gates_cell_i8_simt`).
//
// Replace april_asr_tpu/ops/lstm_tp_pallas.py:
//   tp_gate_cell_proj (18) `lstm_gate_cell_proj` (`_gcp_kernel`), f32 or bf16
//     weights: gates = dot(x, w_ih) + dot(h, w_hh) + b over the shard's
//     gate-shuffled [d, 4Hs] slice, the f32 cell, hp = dot(hc, w_hr[Hs, d])
//     (ungated), c2 = gt * c' + (1 - gt) * c.
//   tp_gates_cell_i8 (19) `lstm_gates_cell_i8` (`_gc_kernel_i8`): the same
//     gates and cell on int8 weights with column scales, x and h quantized
//     per row (_rowq8); writes hc (ungated, not quantized) and c2.
//
// What bounds them on the H100 at the flagship shard (m = 2: d 512, Hs 512,
// S = 256): kernel 18 is 0.604 G multiply-adds, 18 us at the f32 FMA rate;
// kernel 19 moves 2.1 MB of int8 weights and 2.6 MB of rows, 1.4 us. The
// kernels they replace ran the gate pass on 64 blocks (68 SMs idle), each
// restaging its weight columns for its 32 sessions, then a second launch for
// the projection.
//
// Kernel 18 (`tp_gcp_kernel`). To keep bits every output stays one fmaf
// chain over k in increasing order, as `step_gates` and `tp_cols` sum it:
// x.w_ih and h.w_hh in two chains added in the epilogue, hc.w_hr in one; so
// the products stay on the CUDA cores. One launch, two phases of items:
//
//   gate items: ub hidden units (all four gates) x nr1 = 1024 / ub rows.
//     Each lane of the first 32 / TR warps owns one unit's four gate
//     columns for TR rows, so the cell is computed in registers. The
//     weights come from a form laid out once per weights on the host
//     (ops/lstm_tp_kernels.py `tp_weight_forms`: [2][d][Hs][4] f32, the
//     four gates of a unit side by side, bf16 widened exactly), so a unit's
//     four gate weights at depth k are one float4; x, h and the weights
//     stream through a cp.async ring of DK-deep stages (Ring<DK>: 64 deep,
//     three stages at the plans' default) that every warp fills. At TR = 4
//     a thread does 8 + 8 LDS.128 for 128 FFMA per 4 depths. hc goes to an
//     f32 scratch (rounded to bf16 at bf16 weights: the projection's
//     activation).
//   a grid barrier (a cooperative launch: every block resident);
//   projection items: 32 columns x 32 rows of hp = hc . w_hr in 128-deep
//     stages, hc read back through L2 (cp.async.cg); each lane of the first
//     8 / PR warps owns 4 columns of PR rows.
//
// On the H100 at the flagship shard (tools/profile_tp.py) the gate phase
// takes ~42 of ~53 us, and 35-37 us without the steady ring loads: at TR = 4
// that is the 16 KB its LDS.128s read a depth per SM at ~128 bytes a cycle,
// twice the FFMA time; TR = 8 reads a quarter less on one warp a scheduler
// and took the same (32- or 64-deep stages and ub 8-32 landed within 10%
// too). A form with a cluster barrier in place
// of the grid's (each cluster a tile of rows holding every hidden unit of
// them) streamed each weight column into 8 times as many blocks and took
// 2-4x as long; it was measured and removed.
//
// Kernel 19 (`tp_gc_i8_kernel`) is kernel 7's gate phase (csrc/lstm_mma.cuh
// `gate_phase`: the block's w_ih and w_hh columns staged once as [n][k],
// `mma.sync` m16n8k32 s8 into two exact int32 accumulators, the row-scale
// fold and `step_gates`' f32 epilogue order) on the plan of
// ops/lstm_mma.py `gate_split`. x and h are quantized by `warp_rowq8`
// across the grid into int8 scratch before a grid barrier (each block
// quantizing its own row range instead, with no barrier, took twice as long:
// its blocks read every row of their range from L2); integer dots are exact
// in any order, so hc and c2 equal the simt kernel's.
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn) in the JAX op order; tanhf is CUDA's (no fast-math).

#include "lstm_mma.cuh"

#define TPG_KC2 128              // depth of a projection stage
#define TPG_LDA2 (TPG_KC2 + 4)   // f32 stride of a staged hc row
#define TPG_TR 4                 // rows a thread in a gate item (its 32 / TR warps compute)
#define TPG_PR 2                 // rows a thread in a projection item (8 / PR warps compute)

// The ring of a plan whose gate stages are DK deep (32 or 64): x and h rows
// of DK + 4 floats, and as many stages as fit an H100 block at ub 16
template <int DK>
struct Ring {
  static constexpr int LDA = DK + 4, ST = DK == 32 ? 4 : 3;
};

// The plan (ops/tp_plan.py `gcp_plan`): gate items of ub units (a power of
// 2 from 8) x 1024 / ub rows, projection items of 32 columns x 32 rows;
// block b walks items b, b + gridDim.x, ... of each phase.
struct GcpArgs {
  const float *x, *h, *c, *gate, *wg, *wr;
  const void* bias;
  float *hc, *hp, *c2;
  int S, d, Hs, bias_bf16, ub;
  Stamps stamp;  // 4 a block: start, gates done, barrier passed, projection done
};

__host__ __device__ constexpr size_t gcp_stage_gates(int ub, int kc) {
  return (size_t)2 * (1024 / ub) * (kc + 4) * 4 + (size_t)2 * kc * ub * 16;
}

// a projection stage: hc [32][TPG_LDA2], w_hr [TPG_KC2][32]
constexpr size_t GCP_STAGE_PROJ = (size_t)32 * TPG_LDA2 * 4 + (size_t)TPG_KC2 * 32 * 4;

__host__ __device__ constexpr size_t gcp_stage(int ub, int kc) {
  return gcp_stage_gates(ub, kc) > GCP_STAGE_PROJ ? gcp_stage_gates(ub, kc) : GCP_STAGE_PROJ;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Gate item: units [u0, u0 + ub), rows [r0, rend).
template <bool RND, int DK>
__device__ __forceinline__ void gcp_gates(const GcpArgs& a, uint8_t* ring, size_t stb, int u0,
                                          int r0, int rend) {
  const int ub = a.ub, lub = __ffs(ub) - 1, nr = 1024 >> lub, lnr = 10 - lub;
  const int d = a.d, Hs = a.Hs, ldb = 4 * ub;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the first GW warps compute, each lane one unit's four gates for TR rows
  // rl + i RL; every warp loads
  constexpr int TR = TPG_TR, GW = 32 / TR;
  const int uw = ub >> 3, wr = warp >> (lub - 3), RL = (GW >> (lub - 3)) * 4;
  const int ul = (warp & (uw - 1)) * 8 + (lane & 7), rl = wr * 4 + (lane >> 3);
  const bool live = warp < GW && r0 + wr * 4 < rend;  // a computing warp with a row
  constexpr int LDA = Ring<DK>::LDA, ST = Ring<DK>::ST;
  const int nch = (d + DK - 1) / DK;
  // x and h rows: copy i is row i / (DK / 4) of the 2 nr (x, then h), depth
  // 4 (i % (DK / 4)); weights: copy i is unit i & (ub - 1) at depth
  // (i >> lub) % DK of matrix (i >> lub) / DK
  auto load = [&](int ch) {
    if (ch < nch) {
      float* xa = reinterpret_cast<float*>(ring + (ch % ST) * stb);
      float* wx = xa + 2 * nr * LDA;
      const int kb = ch * DK;
      for (int i = tid; i < 2 * nr * (DK / 4); i += MMA_NT) {
        const int rr = i / (DK / 4), k = (i % (DK / 4)) * 4, m = rr >> lnr;
        const int row = r0 + (rr & (nr - 1));
        float* dst = xa + rr * LDA + k;
        if (row < rend && kb + k < d) mma_cp16(dst, (m ? a.h : a.x) + (size_t)row * d + kb + k);
        else zero16(dst);
      }
      for (int i = tid; i < 2 * DK * ub; i += MMA_NT) {
        const int u = i & (ub - 1), t = i >> lub, k = t & (DK - 1), m = t / DK;
        float* dst = wx + t * ldb + u * 4;
        if (kb + k < d && u0 + u < Hs)
          mma_cp16(dst, a.wg + (((size_t)m * d + kb + k) * Hs + u0 + u) * 4);
        else zero16(dst);
      }
    }
    mma_cp_commit();
  };
  float ax[TR][4], ah[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) ax[i][g] = ah[i][g] = 0.f;
#pragma unroll
  for (int ch = 0; ch < ST - 1; ++ch) load(ch);
  for (int ch = 0; ch < nch; ++ch) {
    mma_cp_wait<ST - 2>();  // chunk ch has landed
    __syncthreads();            // ... for every thread; stage (ch - 1) % ST is free
    float* xa = reinterpret_cast<float*>(ring + (ch % ST) * stb);
    if constexpr (RND) {  // the activations as jnp's astype(bfloat16) rounds them
      float4* v = reinterpret_cast<float4*>(xa);
      for (int i = tid; i < 2 * nr * LDA / 4; i += MMA_NT) {
        const float4 t = v[i];
        v[i] = make_float4(round_bf16(t.x), round_bf16(t.y), round_bf16(t.z), round_bf16(t.w));
      }
      __syncthreads();
    }
    load(ch + ST - 1);
    if (!live) continue;
    const float* ha = xa + nr * LDA;
    const float* wx = xa + 2 * nr * LDA + ul * 4;
    const float* wh = wx + DK * ldb;
#pragma unroll 2
    for (int kk = 0; kk < DK; kk += 4) {
      float4 xv[TR], hv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        xv[i] = *reinterpret_cast<const float4*>(xa + (rl + i * RL) * LDA + kk);
        hv[i] = *reinterpret_cast<const float4*>(ha + (rl + i * RL) * LDA + kk);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 bx = *reinterpret_cast<const float4*>(wx + (kk + j) * ldb);
        const float4 bh = *reinterpret_cast<const float4*>(wh + (kk + j) * ldb);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float xs = comp(xv[i], j), hs = comp(hv[i], j);
          ax[i][0] = fmaf(xs, bx.x, ax[i][0]);
          ax[i][1] = fmaf(xs, bx.y, ax[i][1]);
          ax[i][2] = fmaf(xs, bx.z, ax[i][2]);
          ax[i][3] = fmaf(xs, bx.w, ax[i][3]);
          ah[i][0] = fmaf(hs, bh.x, ah[i][0]);
          ah[i][1] = fmaf(hs, bh.y, ah[i][1]);
          ah[i][2] = fmaf(hs, bh.z, ah[i][2]);
          ah[i][3] = fmaf(hs, bh.w, ah[i][3]);
        }
      }
    }
  }
  __syncthreads();  // the ring is free for the next item
  const int U = u0 + ul;
  if (!live || U >= Hs) return;
  float bv[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bv[g] = load_vec(a.bias, g * Hs + U, a.bias_bf16);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = r0 + rl + i * RL;
    if (row >= rend) continue;
    float gt[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) gt[g] = __fadd_rn(__fadd_rn(ax[i][g], ah[i][g]), bv[g]);
    const size_t k = (size_t)row * Hs + U;
    const float cold = a.c[k];
    const float cn = __fadd_rn(__fmul_rn(sig_tanh(gt[1]), cold),
                               __fmul_rn(sig_tanh(gt[0]), tanhf(gt[2])));
    const float hcv = __fmul_rn(sig_tanh(gt[3]), tanhf(cn));
    a.hc[k] = RND ? round_bf16(hcv) : hcv;
    a.c2[k] = a.gate ? blend(a.gate[row], cn, cold) : cn;
  }
}

// Projection item: columns [c0, c0 + 32) of hp, rows [r0, rend).
template <int ST>
__device__ __forceinline__ void gcp_proj(const GcpArgs& a, uint8_t* ring, size_t stb, int c0,
                                         int r0, int rend) {
  // the first PW warps compute, each lane 4 columns cl.. of PR rows
  // rl + i PW 4; every warp loads
  constexpr int nc = 32, lnc = 5, nr = 32, PR = TPG_PR, PW = 8 / PR;
  const int K = a.Hs, N = a.d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cl = (lane & 7) * 4, rl = warp * 4 + (lane >> 3);
  const bool live = warp < PW && r0 + warp * 4 < rend;
  const int nch = (K + TPG_KC2 - 1) / TPG_KC2;
  constexpr int K4 = TPG_KC2 / 4;
  auto load = [&](int ch) {
    if (ch < nch) {
      float* sa = reinterpret_cast<float*>(ring + (ch % ST) * stb);
      float* sb = sa + nr * TPG_LDA2;
      const int kb = ch * TPG_KC2;
      for (int i = tid; i < nr * K4; i += MMA_NT) {
        const int r = i / K4, k = (i & (K4 - 1)) * 4, row = r0 + r;
        float* dst = sa + r * TPG_LDA2 + k;
        if (row < rend && kb + k < K) mma_cp16(dst, a.hc + (size_t)row * K + kb + k);
        else zero16(dst);
      }
      for (int i = tid; i < TPG_KC2 * (nc >> 2); i += MMA_NT) {
        const int k = i >> (lnc - 2), n = (i & ((nc >> 2) - 1)) * 4;
        float* dst = sb + k * nc + n;
        if (kb + k < K && c0 + n < N) mma_cp16(dst, a.wr + (size_t)(kb + k) * N + c0 + n);
        else zero16(dst);
      }
    }
    mma_cp_commit();
  };
  float acc[PR][4];
#pragma unroll
  for (int i = 0; i < PR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int ch = 0; ch < ST - 1; ++ch) load(ch);
  for (int ch = 0; ch < nch; ++ch) {
    mma_cp_wait<ST - 2>();
    __syncthreads();
    load(ch + ST - 1);
    if (!live) continue;
    const float* sa = reinterpret_cast<const float*>(ring + (ch % ST) * stb) + rl * TPG_LDA2;
    const float* sb = reinterpret_cast<const float*>(ring + (ch % ST) * stb) +
                      nr * TPG_LDA2 + cl;
#pragma unroll 2
    for (int kk = 0; kk < TPG_KC2; kk += 4) {
      float4 av[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i)
        av[i] = *reinterpret_cast<const float4*>(sa + i * PW * 4 * TPG_LDA2 + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(sb + (kk + j) * nc);
#pragma unroll
        for (int i = 0; i < PR; ++i) {
          const float v = comp(av[i], j);
          acc[i][0] = fmaf(v, b.x, acc[i][0]);
          acc[i][1] = fmaf(v, b.y, acc[i][1]);
          acc[i][2] = fmaf(v, b.z, acc[i][2]);
          acc[i][3] = fmaf(v, b.w, acc[i][3]);
        }
      }
    }
  }
  __syncthreads();
  const int col = c0 + cl;
  if (!live || col >= N) return;
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int row = r0 + rl + i * PW * 4;
    if (row < rend)
      *reinterpret_cast<float4*>(a.hp + (size_t)row * N + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <bool RND, int DK>
__global__ void __launch_bounds__(MMA_NT, 1) tp_gcp_kernel(const __grid_constant__ GcpArgs a) {
  extern __shared__ float4 smem_f4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_f4);
  const size_t stb = gcp_stage(a.ub, DK);
  const int nr1 = 1024 / a.ub, ngu = (a.Hs + a.ub - 1) / a.ub, ncg = (a.d + 31) / 32;
  a.stamp(0);
  const int n1 = ngu * ((a.S + nr1 - 1) / nr1);
  for (int j = blockIdx.x; j < n1; j += gridDim.x) {
    const int r0 = (j / ngu) * nr1;
    gcp_gates<RND, DK>(a, ring, stb, (j % ngu) * a.ub, r0, min(r0 + nr1, a.S));
  }
  a.stamp(1);
  cg::this_grid().sync();
  a.stamp(2);
  const int n2 = ncg * ((a.S + 31) / 32);
  for (int j = blockIdx.x; j < n2; j += gridDim.x) {
    const int r0 = (j / ncg) * 32;
    gcp_proj<Ring<DK>::ST>(a, ring, stb, (j % ncg) * 32, r0, min(r0 + 32, a.S));
  }
  a.stamp(3);
}

static const void* gcp_pick(int rnd, int kc) {
  if (kc == 64)
    return rnd ? reinterpret_cast<const void*>(tp_gcp_kernel<true, 64>)
               : reinterpret_cast<const void*>(tp_gcp_kernel<false, 64>);
  return rnd ? reinterpret_cast<const void*>(tp_gcp_kernel<true, 32>)
             : reinterpret_cast<const void*>(tp_gcp_kernel<false, 32>);
}

// Kernel 18's shared memory for the plan's ub and stage depth kc (minus
// where they are not a plan's).
extern "C" int tp_gcp_smem(int ub, int kc) {
  if ((ub != 8 && ub != 16 && ub != 32) || (kc != 32 && kc != 64)) return -1;
  return (int)((kc == 32 ? Ring<32>::ST : Ring<64>::ST) * gcp_stage(ub, kc));
}

// Kernel 18. gate: [S] f32 or null (ungated). wg: the [2][d][Hs][4] f32 gate
// form, wr: w_hr [Hs][d] as f32; hc [S][Hs] f32 scratch. Outputs hp [S][d]
// (ungated) and c2 [S][Hs]. w_bf16: the weights were bf16 (the activations
// are then rounded to bf16). The plan: ub, kc, nb blocks (all co-resident),
// smem bytes. stamps: null or [nb][4]. Returns minus this kernel's bytes
// where they differ from smem or exceed the device's limit, 1
// (cudaErrorInvalidValue) for a plan it does not take, else the launch's
// CUDA error.
extern "C" int tp_gate_cell_proj(const float* x, const float* h, const float* c,
                                 const float* gate, const float* wg, const void* bias,
                                 const float* wr, float* hc, float* hp, float* c2,
                                 unsigned long long* stamps, int S, int d, int Hs, int w_bf16,
                                 int bias_bf16, int ub, int kc, int nb, int smem, void* stream) {
  const int want = tp_gcp_smem(ub, kc);
  if (want < 0 || S < 1 || d < 4 || Hs < 4 || d % 4 || Hs % 4 || nb < 1)
    return (int)cudaErrorInvalidValue;
  if (want != smem) return -want;
  const void* fn = gcp_pick(w_bf16, kc);
  const int ready = prepare_once(fn, smem);
  if (ready) return ready;
  const GcpArgs a{x, h, c, gate, wg, wr, bias, hc, hp, c2, S, d, Hs, bias_bf16, ub,
                  Stamps{stamps, 4}};
  void* params[] = {const_cast<GcpArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(MMA_NT), params, smem,
                                          (cudaStream_t)stream);
}

struct GcI8Args {
  const float *x, *h, *c, *gate;
  const int8_t *wih, *whh;
  const float *wihs, *whhs;
  const void* bias;
  float *hc, *c2;
  int8_t *xq, *hq;  // [Sp][dp]
  float* scl;       // [2][Sp]: x and h row scales
  unsigned* amax;   // [Sp]: gate_phase folds |hc| into it (read by nothing here)
  int S, d, H, bias_bf16, Sp, dp;
  GateSplit gs;
  Stamps stamp;  // 4 a block: start, weights staged and rows quantized, barrier, gates done
};

template <int NTG>
__global__ void __launch_bounds__(MMA_NT, 1) tp_gc_i8_kernel(const __grid_constant__ GcI8Args a) {
  constexpr int UB = 2 * NTG, NC = 8 * NTG;
  extern __shared__ float4 smem_f4[];
  const int b = blockIdx.x, S = a.S, d = a.d, dp = a.dp, ldg = 2 * dp + 16;
  uint8_t* Bg = reinterpret_cast<uint8_t*>(smem_f4);  // [NC][ldg]: w_ih | w_hh columns
  uint8_t* stage = Bg + NC * ldg;                      // the A ring
  float* gbuf = reinterpret_cast<float*>(stage + MMA_RING);  // [8][16][NC + 8]
  float* gcs = gbuf + 8 * 16 * (NC + 8);               // [3][NC]
  int u0 = 0, g0 = 0, g1 = 0;
  const bool gate_blk = gate_item(a.gs, b, UB, a.Sp, u0, g0, g1);
  a.stamp(0);
  if (gate_blk) {
    auto gcol = [&](int n) {
      const int gi = n / UB, U = u0 + n - gi * UB;
      return U < a.H ? gi * a.H + U : -1;
    };
    stage_cols(Bg, ldg, 0, a.wih, 4 * a.H, d, dp, NC, gcol);
    stage_cols(Bg, ldg, dp, a.whh, 4 * a.H, d, dp, NC, gcol);
    stage_gate_consts(gcs, NC, a.wihs, a.whhs, a.bias, a.bias_bf16, gcol);
  }
  int8_t *xq = a.xq, *hq = a.hq;
  float *xs = a.scl, *hs = a.scl + a.Sp;
  quant_rows(2 * S, [&](int r, const float*& src, int8_t*& dst, float*& sc, int& len) {
    const int s = r < S ? r : r - S;
    len = d;
    src = (r < S ? a.x : a.h) + (size_t)s * d;
    dst = (r < S ? xq : hq) + (size_t)s * dp;
    sc = (r < S ? xs : hs) + s;
  });
  a.stamp(1);
  cg::this_grid().sync();
  a.stamp(2);
  if (gate_blk) {
    const GateIn g{xq, hq, xs, hs, a.c, a.hc, a.amax};
    gate_phase<NTG>(
        g, Bg, ldg, gcs, gbuf, stage, u0, g0, g1, S, dp, a.H,
        [&](int row) { return a.gate ? a.gate[row] : 0.f; },
        [&](int, size_t k, float cold, float cn, float gt) {
          a.c2[k] = a.gate ? blend(gt, cn, cold) : cn;
        });
  }
  a.stamp(3);
}

// Kernel 19. gate: [S] f32 or null (ungated). Scratch: xq, hq [Sp][dp]
// int8, scl [2][Sp] f32, amax [Sp]. Outputs hc [S][H] (ungated, f32) and
// c2 [S][H]. The plan: ub (4, 8 or 16 units a gate item), nb
// blocks, the gate split's rows, unit groups and items; stamps null or
// [nb][4]. Returns minus the shared-memory bytes where they do not fit, else
// the launch's CUDA error.
extern "C" int tp_gates_cell_i8(const float* x, const float* h, const float* c,
                                const float* gate, const int8_t* wih, const float* wihs,
                                const int8_t* whh, const float* whhs, const void* bias, float* hc,
                                float* c2, int8_t* xq, int8_t* hq, float* scl, unsigned* amax,
                                unsigned long long* stamps, int S, int d, int H, int bias_bf16,
                                int Sp, int dp, int ub, int nb, int g_rows, int g_ngu,
                                int g_items, void* stream) {
  const GcI8Args a{x, h, c, gate, wih, whh, wihs, whhs, bias, hc, c2, xq, hq, scl, amax,
                   S, d, H, bias_bf16, Sp, dp, GateSplit{g_rows, g_ngu, g_items},
                   Stamps{stamps, 4}};
  const int smem = (int)(gate_smem(ub, dp) + MMA_RING);
  const void* fn = ub == 4   ? reinterpret_cast<const void*>(tp_gc_i8_kernel<2>)
                   : ub == 8  ? reinterpret_cast<const void*>(tp_gc_i8_kernel<4>)
                   : ub == 16 ? reinterpret_cast<const void*>(tp_gc_i8_kernel<8>)
                              : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int ready = prepare_once(fn, smem);
  if (ready) return ready;
  void* params[] = {const_cast<GcI8Args*>(&a)};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(MMA_NT), params, smem,
                                          (cudaStream_t)stream);
}
