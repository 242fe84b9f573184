// Kernels 20 and 21 as one launch each: the tensor-parallel step's FFN
// pieces, bit for bit the column passes they replace (csrc/lstm_tp.cu
// `tp_ffn_partial_simt`, `tp_ffn_mid_i8_simt`).
//
// Replace april_asr_tpu/ops/lstm_tp_pallas.py:
//   tp_ffn_partial (20) `ffn_partial` (`_ffn_kernel`), f32 or bf16 weights:
//     DoubleSwish(dot(y, ff1[d, Fs]) + b1) then dot(., ff2[Fs, d]): the
//     shard's partial FFN sum, without the second bias or the norm.
//   tp_ffn_mid_i8 (21) `ffn_mid_i8` (`_ffn_mid_kernel_i8`): _rowq8(y), the
//     int8 ff1 with column scales, + b1, DoubleSwish -> mid [S, Fs] f32.
//
// What bounds them on the H100 at the flagship shard (m = 2: d 512, Fs
// 1024, S = 256): kernel 20 is 2 S d Fs = 268 M multiply-adds, 8.0 us at the
// f32 FMA rate (at bf16 too: to keep its bits it stays on the CUDA cores);
// kernel 21 moves 0.5 MB of int8 weights and 1.5 MB of rows, 0.6 us. The
// kernels they replace ran kernel 20 as two launches with mid between them,
// each block restaging its weight columns for 16 sessions, each thread one
// activation and one LDS.128 of weights for 4 FMA; and kernel 21's 134 M
// int8 products on IMAD.
//
// Kernel 20 (`tp_ffn_kernel`). To keep bits every output stays one fmaf
// chain over k in increasing order, the activation rounded to the weight
// type, as `tp_cols` sums it; so no split depth and no tensor cores. One
// cooperative launch, three phases with a grid barrier after each of the
// first two:
//
//   y into row tiles (`yt`, rounded to bf16 at bf16 weights), across the
//     grid;
//   ff1 items: TR rows x TC columns of mid = DoubleSwish(y . ff1 + b1)
//     (rounded to bf16 at bf16 weights: the ff2 product's activation),
//     stored into the row tiles ff2 reads (`mt`, 1.1 MB at S = 256, in L2);
//   ff2 items: TR rows x TC columns of out = mid . ff2.
//
// A stage is 64 depths of an item's rows and weight columns, both laid out
// in device memory as the stage takes them (rows [TR][68], the weights
// tiled once per weights on the host: ops/lstm_tp_kernels.py
// `ffn_tile_forms`), so thread 0 brings it by two bulk copies (TMA) onto
// its slot's mbarrier, through a ring of three stages. On the H100, rows
// fetched 16 bytes a cp.async by every thread streamed at ~12 GB/s a block
// whatever the item shape (each phase took its bytes at that rate), and a
// bulk copy per row took ~20 ns a copy, 2.5x slower; the two large copies
// a stage took kernel 20 from 38.6 to 31.4 us (PERF.md). An item's
// first wr x wc warps compute (`FfnTile`), each lane rm rows x 4 nq
// columns: per 4 depths it reads rm + 4 nq LDS.128 (512 bytes each of the
// 128 a cycle shared memory serves) for 16 rm nq FFMA; the plan
// (ops/tp_plan.py `ffn_plan`) ranks the shapes by those two costs added,
// as the card's sweeps ranked them (at the flagship shard ff1 on 64 x 32
// items, 4 x 4 a lane on 4 warps; ff2 on 32 x 32 items, 2 x 4 a lane on 4
// warps). The ring does not grow with d or Fs.
//
// Kernel 21 (`tp_mid_i8_kernel`): y quantized by `warp_rowq8` (_rowq8 is
// exact where it is taken: y is replicated) across the grid into int8
// scratch while each block stages its first item's ff1 columns as [n][k]
// (`stage_cols`, zero past d); one grid barrier; then items of TR rows x
// TC columns on `mma.sync` m16n8k32 s8 (csrc/mma_tc.cuh), the item's int8
// rows brought from the scratch, each warp one 16-row tile x NTW 8-column
// tiles. Integer dots are exact in any order and the epilogue is
// `tp_cols`' (I8Ops::deq, + b1, DoubleSwish), so mid equals the simt
// kernel's. Each block quantizing its own rows, with no barrier, was
// measured slower (11.2 against 9.8 us at S = 256; 53.1 against 32.3 at
// 2048) and removed.
//
// Numerics: f32 adds and multiplies outside the dots are rounded separately
// (__fadd_rn/__fmul_rn) in the JAX op order; tanhf is CUDA's (no fast-math).

#include "lstm_mma.cuh"
#include "mbar_ring.cuh"

#define FFN_DK 64               // depth of a ring stage
#define FFN_LDA (FFN_DK + 4)    // f32 stride of a staged row
#define FFN_ST 3                // ring stages (two in flight)

// An item shape (ops/tp_plan.py `FfnTile`): the item's first wr * wc warps
// compute (the others only wait), warp w at row group w / wc and column
// group w % wc; a lane owns rm rows x nq float4s of columns, so an item is
// TR = 4 wr rm rows x TC = 32 nq wc columns.
struct FfnTile {
  int rm, nq, wr, wc;
  __host__ __device__ int tr() const { return 4 * wr * rm; }
  __host__ __device__ int tc() const { return 32 * nq * wc; }
};

// Bytes of one ring stage of an item: rows [TR][FFN_LDA], weight rows
// [FFN_DK][TC], f32 (as the tiled operands lie in device memory)
__host__ __device__ inline size_t ffn_stage(const FfnTile& t) {
  return ((size_t)t.tr() * FFN_LDA + (size_t)FFN_DK * t.tc()) * 4;
}

__host__ __device__ inline size_t ffn_stb(const FfnTile& t1, const FfnTile& t2) {
  return ffn_stage(t1) > ffn_stage(t2) ? ffn_stage(t1) : ffn_stage(t2);
}

// Kernel 20's plan (ops/tp_plan.py `FfnPlan`): each phase's item shape;
// block b walks items b, b + gridDim.x, ..., item j at column group j % ncg,
// row tile j / ncg. The operands lie in device memory as the stages take
// them, so that a stage is two bulk copies: the rows tiled [row tile][depth
// chunk][TR][FFN_LDA] (y by the kernel's first phase, mid by ff1's
// epilogue: `yt`, `mt`), the weights [column group][depth chunk][FFN_DK][TC]
// (ops/lstm_tp_kernels.py `ffn_tile_forms`, zero past the widths).
struct FfnArgs {
  const float* y;          // [S][d]
  const float *w1, *w2;    // the tiled ff1 (TC1 columns a group), ff2 (TC2)
  const void* b1;
  float *yt, *mt, *out;    // scratch: y and mid tiled; out [S][d]
  int S, d, Fs, b1_bf16;
  FfnTile t1, t2;  // ff1 and ff2 items
  Stamps stamp;    // 4 a block: start, ff1 done, barrier passed, ff2 done
};

enum { FFN_PLAIN = 0, FFN_DSWISH = 1 };

// Item (row tile rt, column group cg) of act(A) . W over depth K, N
// columns: At the tiled rows, Wt the tiled weights; thread 0 brings each
// stage by two bulk copies onto its slot's `full` mbarrier (the ring's
// fills counted by `fill` across the launch: slot fill % FFN_ST, parity
// (fill / FFN_ST) & 1). A lane's rows rl + i 4 wr, its columns cl + q 32 +
// 0..3. EPI FFN_DSWISH adds the bias, applies DoubleSwish, rounds to bf16
// with RND and stores into the tiled mid (row tiles of TRO rows); FFN_PLAIN
// stores out [S][N].
template <int RM, int NQ, bool RND, int EPI>
__device__ __forceinline__ void ffn_item(const float* At, const float* Wt, const void* bias,
                                         int bias_bf16, float* out, int S, int K, int N, int rt,
                                         int cg, int TRO, const FfnTile& t, uint8_t* ring,
                                         size_t stb, uint64_t* full, int& fill) {
  constexpr int LDA = FFN_LDA, ST = FFN_ST, DK = FFN_DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lwc = __ffs(t.wc) - 1, TR = t.tr(), TC = t.tc();
  const int r0 = rt * TR, c0 = cg * TC, nch = (K + DK - 1) / DK;
  const int wrow = warp >> lwc, wcol = warp & (t.wc - 1);
  const int rl = wrow * 4 + (lane >> 3), cl = wcol * 32 * NQ + (lane & 7) * 4;
  const bool live = warp < t.wr * t.wc && r0 + wrow * 4 < S && c0 + wcol * 32 * NQ < N;
  const unsigned abytes = (unsigned)TR * LDA * 4, wbytes = (unsigned)DK * TC * 4;
  const float* asrc = At + (size_t)rt * nch * TR * LDA;
  const float* wsrc = Wt + (size_t)cg * nch * DK * TC;
  auto load = [&](int ch) {
    if (ch >= nch || tid != 0) return;
    const int slot = (fill + ch) % ST;
    float* sa = reinterpret_cast<float*>(ring + slot * stb);
    // the slot's last reads before the engine's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(full + slot, abytes + wbytes);
    bulk_copy(sa, asrc + (size_t)ch * TR * LDA, abytes, full + slot);
    bulk_copy(sa + TR * LDA, wsrc + (size_t)ch * DK * TC, wbytes, full + slot);
  };
  float acc[RM][NQ][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[i][q][0] = acc[i][q][1] = acc[i][q][2] = acc[i][q][3] = 0.f;
  for (int ch = 0; ch < ST - 1; ++ch) load(ch);
  for (int ch = 0; ch < nch; ++ch) {
    const int slot = (fill + ch) % ST;
    mbar_wait(full + slot, ((fill + ch) / ST) & 1);  // stage ch has landed
    __syncthreads();  // ... and every thread is past stage ch - 1: its slot is free
    load(ch + ST - 1);
    if (!live) continue;
    const float* sa = reinterpret_cast<const float*>(ring + slot * stb);
    const float* pa = sa + rl * LDA;
    const float* pw = sa + TR * LDA + cl;
    // 4 depths: RM float4 of rows, 4 NQ float4 of weights, 16 RM NQ fmaf
    auto step4 = [&](int kk) {
      float4 av[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        av[i] = *reinterpret_cast<const float4*>(pa + i * 4 * t.wr * LDA + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 b[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          b[q] = *reinterpret_cast<const float4*>(pw + (kk + j) * TC + q * 32);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float v = j == 0 ? av[i].x : j == 1 ? av[i].y : j == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            acc[i][q][0] = fmaf(v, b[q].x, acc[i][q][0]);
            acc[i][q][1] = fmaf(v, b[q].y, acc[i][q][1]);
            acc[i][q][2] = fmaf(v, b[q].z, acc[i][q][2]);
            acc[i][q][3] = fmaf(v, b[q].w, acc[i][q][3]);
          }
        }
      }
    };
    const int kn = min(DK, K - ch * DK);  // a multiple of 4: no product past K
    if (kn == DK) {
#pragma unroll 4
      for (int kk = 0; kk < DK; kk += 4) step4(kk);
    } else {
      for (int kk = 0; kk < kn; kk += 4) step4(kk);
    }
  }
  __syncthreads();  // the ring is free for the next item
  fill += nch;
  if (!live) return;
  const int nco = (N + DK - 1) / DK;  // depth chunks of the tiled mid
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int col = c0 + cl + q * 32;
    if (col >= N) continue;  // N is a multiple of 4: all four columns or none
    float bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (EPI == FFN_DSWISH) {
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[e] = load_vec(bias, col + e, bias_bf16);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = r0 + rl + i * 4 * t.wr;
      if (row >= S) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][q][e];
        if (EPI == FFN_DSWISH) {
          v[e] = __fadd_rn(v[e], bv[e]);
          v[e] = __fmul_rn(v[e], sig_tanh(__fsub_rn(v[e], 1.f)));
          if (RND) v[e] = round_bf16(v[e]);
        }
      }
      float* dst = EPI == FFN_DSWISH
                       ? out + (((size_t)(row / TRO) * nco + col / DK) * TRO + row % TRO) * LDA +
                             col % DK
                       : out + (size_t)row * N + col;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// A phase's items on the tile t, (RM, NQ) by their values
template <bool RND, int EPI>
__device__ __forceinline__ void ffn_phase(const float* At, const float* Wt, const void* bias,
                                          int bias_bf16, float* out, int S, int K, int N, int TRO,
                                          const FfnTile& t, uint8_t* ring, size_t stb,
                                          uint64_t* full, int& fill) {
  const int TR = t.tr(), TC = t.tc(), ncg = (N + TC - 1) / TC;
  const int n = ncg * ((S + TR - 1) / TR);
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
#define FFN_ITEM(R, Q)                                                                        \
  ffn_item<R, Q, RND, EPI>(At, Wt, bias, bias_bf16, out, S, K, N, j / ncg, j % ncg, TRO, t, \
                           ring, stb, full, fill)
    if (t.nq == 1) {
      if (t.rm == 1) FFN_ITEM(1, 1);
      else if (t.rm == 2) FFN_ITEM(2, 1);
      else FFN_ITEM(4, 1);
    } else {
      if (t.rm == 1) FFN_ITEM(1, 2);
      else if (t.rm == 2) FFN_ITEM(2, 2);
      else FFN_ITEM(4, 2);
    }
#undef FFN_ITEM
  }
}

template <bool RND>
__global__ void __launch_bounds__(MMA_NT, 1) tp_ffn_kernel(const __grid_constant__ FfnArgs a) {
  extern __shared__ float4 smem_f4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem_f4);
  const size_t stb = ffn_stb(a.t1, a.t2);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FFN_ST * stb);  // [FFN_ST]
  const int S = a.S, d = a.d, TR1 = a.t1.tr(), nch1 = (d + FFN_DK - 1) / FFN_DK;
  if (threadIdx.x < FFN_ST) mbar_init(full + threadIdx.x, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  int fill = 0;
  a.stamp(0);
  // y into its tiles, rounded to bf16 at bf16 weights (rows past S and
  // depths past d are never read into a stored product)
  for (size_t i = (size_t)blockIdx.x * MMA_NT + threadIdx.x; i < (size_t)S * (d / 4);
       i += (size_t)gridDim.x * MMA_NT) {
    const int row = (int)(i / (d / 4)), k = (int)(i - (size_t)row * (d / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(a.y + (size_t)row * d + k);
    if (RND) v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
    *reinterpret_cast<float4*>(
        a.yt + (((size_t)(row / TR1) * nch1 + k / FFN_DK) * TR1 + row % TR1) * FFN_LDA +
        k % FFN_DK) = v;
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");  // for the bulk copies
  cg::this_grid().sync();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  ffn_phase<RND, FFN_DSWISH>(a.yt, a.w1, a.b1, a.b1_bf16, a.mt, S, d, a.Fs, a.t2.tr(), a.t1,
                             ring, stb, full, fill);
  a.stamp(1);
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cg::this_grid().sync();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  a.stamp(2);
  ffn_phase<false, FFN_PLAIN>(a.mt, a.w2, nullptr, 0, a.out, S, a.Fs, d, 0, a.t2, ring, stb,
                              full, fill);
  a.stamp(3);
}

static bool ffn_tile_ok(const FfnTile& t) {
  auto pow2 = [](int v) { return v == 1 || v == 2 || v == 4 || v == 8; };
  return (t.rm == 1 || t.rm == 2 || t.rm == 4) && (t.nq == 1 || t.nq == 2) && pow2(t.wr) &&
         pow2(t.wc) && t.wr * t.wc <= 8;
}

// Kernel 20's shared memory for a plan's item shapes (minus where they are
// not a plan's): the ring, then its slots' mbarriers
extern "C" int tp_ffn_smem(int rm1, int nq1, int wr1, int wc1, int rm2, int nq2, int wr2,
                           int wc2) {
  const FfnTile t1{rm1, nq1, wr1, wc1}, t2{rm2, nq2, wr2, wc2};
  if (!ffn_tile_ok(t1) || !ffn_tile_ok(t2)) return -1;
  return (int)(FFN_ST * ffn_stb(t1, t2) + 8 * FFN_ST);
}

// Kernel 20. y [S][d]; w1, w2 the tiled weights (ops/lstm_tp_kernels.py
// `ffn_tile_forms`, f32; bf16 weights widened: w_bf16 then rounds the
// activations to bf16); yt, mt the tiled rows' scratch; out [S][d]. The
// plan: each phase's rm, nq, wr, wc; nb blocks (all co-resident), smem
// bytes; stamps null or [nb][4]. Returns minus this kernel's bytes where
// they differ from smem or exceed the device's limit, 1
// (cudaErrorInvalidValue) for a plan it does not take, else the launch's
// CUDA error.
extern "C" int tp_ffn(const float* y, const float* w1, const void* b1, const float* w2,
                      float* yt, float* mt, float* out, unsigned long long* stamps, int S, int d,
                      int Fs, int w_bf16, int b1_bf16, int rm1, int nq1, int wr1, int wc1, int rm2,
                      int nq2, int wr2, int wc2, int nb, int smem, void* stream) {
  const int want = tp_ffn_smem(rm1, nq1, wr1, wc1, rm2, nq2, wr2, wc2);
  if (want < 0 || S < 1 || d < 4 || Fs < 4 || d % 4 || Fs % 4 || nb < 1)
    return (int)cudaErrorInvalidValue;
  if (want != smem) return -want;
  const void* fn = w_bf16 ? reinterpret_cast<const void*>(tp_ffn_kernel<true>)
                          : reinterpret_cast<const void*>(tp_ffn_kernel<false>);
  const int ready = prepare_once(fn, smem);
  if (ready) return ready;
  const FfnArgs a{y, w1, w2, b1, yt, mt, out, S, d, Fs, b1_bf16, FfnTile{rm1, nq1, wr1, wc1},
                  FfnTile{rm2, nq2, wr2, wc2}, Stamps{stamps, 4}};
  void* params[] = {const_cast<FfnArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(MMA_NT), params, smem,
                                          (cudaStream_t)stream);
}

// Kernel 21's plan (ops/tp_plan.py `MidPlan`): items of tr rows x tc
// columns (item j at column group j % ncg, row tile j / ncg), each warp a
// 16-row tile x NTW 8-column tiles, (tr / 16) (tc / 8) = 8 NTW.
struct MidArgs {
  const float* y;
  const int8_t* w;  // ff1 [d][Fs]
  const float* ws;  // [Fs] column scales
  const void* b1;
  float* mid;       // [S][Fs]
  int8_t* yq;       // [S][dp] scratch
  float* ys;        // [S] row scales
  int S, d, Fs, b1_bf16, dp, tr, tc;
  Stamps stamp;  // 4 a block: start, weights staged and y quantized, barrier, done
};

__host__ __device__ constexpr size_t mid_smem(int tr, int tc, int dp) {
  return (size_t)(tr + tc) * (dp + 16) + (size_t)tr * 4;
}

template <int NTW>
__global__ void __launch_bounds__(MMA_NT, 1) tp_mid_i8_kernel(const __grid_constant__ MidArgs a) {
  extern __shared__ float4 smem_f4[];
  const int ldb = a.dp + 16, S = a.S, d = a.d, Fs = a.Fs;
  uint8_t* Bs = reinterpret_cast<uint8_t*>(smem_f4);    // [tc][ldb]: the item's ff1 columns
  uint8_t* As = Bs + (size_t)a.tc * ldb;                // [tr][ldb]: its rows, int8
  float* sc = reinterpret_cast<float*>(As + (size_t)a.tr * ldb);  // [tr] row scales
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int ncg = (Fs + a.tc - 1) / a.tc, n = ncg * ((S + a.tr - 1) / a.tr);
  const int mt = a.tr >> 4;  // row tiles; warp w takes tile w % mt, column tiles (w / mt) NTW..
  auto stage = [&](int j) {
    const int c0 = (j % ncg) * a.tc;
    stage_cols(Bs, ldb, 0, a.w, Fs, d, a.dp, a.tc,
               [&](int nn) { return c0 + nn < Fs ? c0 + nn : -1; });
  };
  a.stamp(0);
  if ((int)blockIdx.x < n) stage(blockIdx.x);
  quant_rows(S, [&](int r, const float*& src, int8_t*& dst, float*& s, int& len) {
    src = a.y + (size_t)r * d;
    dst = a.yq + (size_t)r * a.dp;
    s = a.ys + r;
    len = d;
  });
  a.stamp(1);
  cg::this_grid().sync();
  a.stamp(2);
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
    if (j != (int)blockIdx.x) {
      __syncthreads();  // the last item's operands are consumed
      stage(j);
    }
    const int r0 = (j / ncg) * a.tr, c0 = (j % ncg) * a.tc;
    const int nr = min(a.tr, S - r0);
    const int w16 = a.dp >> 4;  // the rows the grid quantized, through L2
    for (int i = tid; i < nr * w16; i += MMA_NT) {
      const int r = i / w16, p = i - r * w16;
      mma_cp16(As + (size_t)r * ldb + p * 16, a.yq + (size_t)(r0 + r) * a.dp + p * 16);
    }
    mma_cp_commit();
    for (int r = tid; r < nr; r += MMA_NT) sc[r] = __ldcg(a.ys + r0 + r);
    mma_cp_wait<0>();
    __syncthreads();
    // bytes of rows past S and depths past d are never set: their products
    // meet B's zero depths or are never stored
    const int rt = warp % mt, ct0 = (warp / mt) * NTW;
    int acc[NTW][4];
#pragma unroll
    for (int t = 0; t < NTW; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
    if (rt * 16 < nr) {
      const uint8_t* sa = As + (size_t)(rt * 16 + (lane & 15)) * ldb + (lane >> 4) * 16;
      const uint8_t* sb = Bs + (size_t)(ct0 * 8 + (lane & 7)) * ldb + (lane >> 3) * 16;
      for (int ks = 0; ks < a.dp; ks += 64) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, sa + ks);
        ldmatrix_x4(a1, sa + ks + 32);
#pragma unroll
        for (int t = 0; t < NTW; ++t) {
          uint32_t b[4];  // b[0..1]: depth ks..ks+31, b[2..3]: ks+32..ks+63
          ldmatrix_x4(b, sb + (size_t)t * 8 * ldb + ks);
          mma_s8_16832(acc[t], a0, b[0], b[1]);
          mma_s8_16832(acc[t], a1, b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NTW; ++t) {
        const int col = c0 + (ct0 + t) * 8 + 2 * q;
        if (col >= Fs) continue;
        const float s0 = a.ws[col], s1 = a.ws[col + 1];
        const float b0 = load_vec(a.b1, col, a.b1_bf16), b1 = load_vec(a.b1, col + 1, a.b1_bf16);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = rt * 16 + gq + hh * 8;
          if (r >= nr) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = __fmul_rn((float)acc[t][hh * 2 + e], __fmul_rn(sc[r], e ? s1 : s0));
            x = __fadd_rn(x, e ? b1 : b0);
            v[e] = __fmul_rn(x, sig_tanh(__fsub_rn(x, 1.f)));
          }
          *reinterpret_cast<float2*>(a.mid + (size_t)(r0 + r) * Fs + col) = make_float2(v[0], v[1]);
        }
      }
    }
  }
  a.stamp(3);
}

static const void* mid_pick(int ntw) {
  return ntw == 1   ? reinterpret_cast<const void*>(tp_mid_i8_kernel<1>)
         : ntw == 2 ? reinterpret_cast<const void*>(tp_mid_i8_kernel<2>)
         : ntw == 4 ? reinterpret_cast<const void*>(tp_mid_i8_kernel<4>)
                    : nullptr;
}

// Kernel 21. ff1 [d][Fs] int8, ws [Fs]; outputs mid [S][Fs]. Scratch: yq
// [S][dp] int8, ys [S] f32. The plan: tr rows and tc columns an item ((tr /
// 16)(tc / 8) = 8, 16 or 32), nb blocks (all co-resident), smem bytes;
// stamps null or [nb][4]. Returns minus the bytes where they differ from the
// plan's or exceed the device's limit, 1 for a plan it does not take, else
// the launch's CUDA error.
extern "C" int tp_ffn_mid_i8(const float* y, const int8_t* ff1, const float* ff1s,
                             const void* f1b, float* mid, int8_t* yq, float* ys,
                             unsigned long long* stamps, int S, int d, int Fs, int f1b_bf16,
                             int dp, int tr, int tc, int nb, int smem, void* stream) {
  const int pairs = (tr / 16) * (tc / 8);
  if (S < 1 || d < 4 || Fs < 4 || d % 4 || Fs % 4 || dp % 64 || dp < d || tr % 16 || tc % 8 ||
      tr > 128 || tc > 128 || (pairs != 8 && pairs != 16 && pairs != 32) || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int want = (int)mid_smem(tr, tc, dp);
  if (want != smem) return -want;
  const void* fn = mid_pick(pairs / 8);
  const int ready = prepare_once(fn, smem);
  if (ready) return ready;
  const MidArgs a{y, ff1, ff1s, f1b, mid, yq, ys, S, d, Fs, f1b_bf16, dp, tr, tc,
                  Stamps{stamps, 4}};
  void* params[] = {const_cast<MidArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(MMA_NT), params, smem,
                                          (cudaStream_t)stream);
}
