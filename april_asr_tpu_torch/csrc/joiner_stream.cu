// Kernel 9 for the H100: the joiner and the blank-excluded argmax over a
// large vocabulary as one cooperative launch, W's columns sliced over the
// blocks, t computed once a call.
//
// Replaces april_asr_tpu/ops/joiner_pallas.py `joiner_argmax_fused`
// (`_kernel`) and computes what csrc/joiner.cu's `joiner_argmax` (kept as
// `joiner_argmax_simt` for the shapes this plan does not hold) computes, bit
// for bit, at bf16 and f32 weights: logits = wd(tanh(eout + dout)) @ W + jb,
// blank_val = logits[blank], and the largest logit with the blank column at
// -1e30 (first index on ties).
//
// What binds it. A call is 2 S J V flops, f32 multiply-adds on the CUDA
// cores whatever the weight type (tensor cores would change the sum order):
// 4.29 GFLOP at S = 256, J = 512, V = 16,383, 0.064 ms at the f32 rate, over
// 16.8 MB (bf16) or 33.5 MB (f32) of W. The kept kernel runs a block per
// (256 columns, 16 sessions): W crosses L2 once per session tile, every
// column block recomputes tanh for its sessions, and each thread's 1 column
// x 16 sessions takes four LDS.128 per 16 FFMA; with its memset and
// finalization, three stream operations a call.
//
// Design (planned by ops/joiner_plan.py `joiner_plan`): one cooperative
// launch of blocks of JS_NT threads; block b holds W's columns [v0, v0 +
// Vc) (slice b % n_vs) for its run of `rounds` session tiles of TS sessions
// (group b / n_vs). The wrapper lays W out once per weights as f32
// [n_vs][J][Vc] (ops/joiner_kernels.py `stream_weight_form`, zero past V;
// bf16 weights widened exactly, which spares the inner loop an unpack a
// weight for twice the bytes), so a slice's KC-row chunks are contiguous.
// At the vocab cells (S = 256, V = 16,383) a block streams its 128 columns
// once a tile of 128 sessions, the second time from L2: a bf16 slice kept
// resident took 0.154 ms a call against 0.121 on the H100 (PERF.md).
//   1. t = wd(tanh(eout + dout)) once a call, the grid's threads sharing the
//      S x J values, written to a scratch laid out [tile][J][TS] (sessions
//      past S zero); one grid barrier. Meanwhile the slice's chunks, where
//      the plan keeps W resident (WRES), land by bulk copy, one mbarrier per
//      group of chunks.
//   2. Per session tile, the KC-row chunks of t (and of W where it streams)
//      come by bulk copy through a ring of JS_NS stages, one thread starting
//      and a block barrier before a stage is refilled; each thread
//      accumulates an RC x RS register tile (columns x sessions: RC weights
//      and RS t values per k as vector loads, RC RS FFMA), k in order.
//   3. Each block reduces its columns to joiner.cu's 64-bit argmax key a
//      session (warp shuffles; where several warps share a session, then a
//      shared-memory atomicMax) and merges it into the [S] key buffer with
//      atomicMax; the blank column's block writes blank_val. The last
//      block to finish (a fence and a ticket)
//      turns the keys into max_idx / max_val and resets keys and ticket to
//      zero for the next call: no memset, no finalization kernel. So a key
//      buffer serves one stream at a time.
//
// Numerics: each logit is one fmaf chain over k = 0 .. J-1 from +0, then
// __fadd_rn of the bias (joiner.cu's order); t is Wt<WT>::act(tanhf(
// __fadd_rn(eout, dout))) as written (no fast-math); the keys are
// joiner.cu's, and their maximum does not depend on the merge order.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mbar_ring.cuh"

namespace cg = cooperative_groups;

#define JS_NT 256     // threads a block
#define JS_KC 32      // k rows a ring stage (and a resident chunk) holds
#define JS_NS 4       // ring stages
#define JS_WBARS 16   // mbarriers of a resident slice (groups of chunks)
#define NEG_INF_F (-1e30f)

struct JsLayout {
  size_t w, t, keys, total;
};

__host__ __device__ inline size_t js_up(size_t n) { return (n + 127) / 128 * 128; }

// Byte offsets of a block's shared memory; ops/joiner_plan.py
// `joiner_smem` computes the same total.
__host__ __device__ inline JsLayout js_layout(int J, int Vc, int TS, int wres) {
  JsLayout L;
  size_t o = 0;
  L.w = o;    o += js_up((size_t)(wres ? J : JS_NS * JS_KC) * Vc * 4);   // W [J or stages x KC][Vc]
  L.t = o;    o += js_up((size_t)JS_NS * JS_KC * TS * 4);                // t ring [stages x KC][TS]
  L.keys = o; o += js_up((size_t)TS * 8);                                // a tile's keys [TS]
  L.total = o;
  return L;
}

// (value, index) as one key whose unsigned order is the argmax order:
// larger value first, then lower index (joiner.cu's key): the value's
// order bits above the inverted index.
__device__ __forceinline__ unsigned order_bits(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long argmax_key(unsigned ord, int i) {
  return ((unsigned long long)ord << 32) | (0xffffffffu - (unsigned)i);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  const unsigned ord = (unsigned)(k >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// The global nanosecond timer, by thread 0 after a block barrier, into the
// block's row of `at` (tools/profile_decode.py reads the phases).
__device__ __forceinline__ void js_stamp(unsigned long long* at, int n, int k) {
  if (at == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    at[(size_t)blockIdx.x * n + k] = t;
  }
}

// N adjacent f32 values, one vector load.
template <int N>
__device__ __forceinline__ void ld4(const float* p, float* t) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    t[0] = v.x; t[1] = v.y;
  } else {
    t[0] = *p;
  }
}

// One chunk of KC k rows into a thread's RC x RS tile: w points at the
// thread's first column in row 0 ([KC][Vc]), t at its first session in row
// 0 ([KC][TS]); the other column groups are wstep apart, the session groups
// tstep apart. Each acc[i][j] is one fmaf chain, k in order.
template <int RC, int RS>
__device__ __forceinline__ void chunk_fma(const float* w, const float* t, int Vc, int TS, int wstep,
                                          int tstep, float (&acc)[RS][RC]) {
  constexpr int GC = RC < 4 ? RC : 4;
  constexpr int GS = RS < 4 ? RS : 4;
#pragma unroll
  for (int kk = 0; kk < JS_KC; ++kk) {
    float wv[RC], tv[RS];
#pragma unroll
    for (int j = 0; j < RC / GC; ++j) ld4<GC>(w + (size_t)kk * Vc + j * wstep, wv + j * GC);
#pragma unroll
    for (int i = 0; i < RS / GS; ++i) ld4<GS>(t + (size_t)kk * TS + i * tstep, tv + i * GS);
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = fmaf(tv[i], wv[j], acc[i][j]);
  }
}

struct JsArgs {
  const float* eout;            // [S][J]
  const float* dout;            // [S][J]
  const float* wf;              // W's slices [n_vs][J][Vc], f32
  const float* jb;              // [V]
  int* mi;
  float* mv;
  float* bv;
  float* tbuf;                  // t [n_st][J][TS]
  unsigned long long* keys;     // [S] argmax keys, zero between calls
  unsigned* ticket;             // blocks finished, zero between calls
  unsigned long long* stamps;   // null, or [blocks][5 + 3 rounds] global-timer ns
  int S, J, V, blank, Vc, TS, n_vs, n_st, rounds;
};

// WT: the weights' type (t is rounded to it).
template <typename WT, int RC, int RS, bool WRES>
__global__ void __launch_bounds__(JS_NT, 1) joiner_stream_kernel(const __grid_constant__ JsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t tbar[JS_NS];    // the ring's stages
  __shared__ uint64_t wbar[JS_WBARS]; // the resident slice's groups of chunks
  __shared__ int last;
  constexpr int GC = RC < 4 ? RC : 4;              // columns a vector load brings
  constexpr int GS = RS < 4 ? RS : 4;              // sessions a vector load brings
  // the arguments as locals (a pointer to the parameters, once taken, would
  // make every read of them a load that a store may alias)
  const int S = a.S, J = a.J, V = a.V, Vc = a.Vc, TS = a.TS, blank = a.blank;
  const int n_vs = a.n_vs, n_st = a.n_st, rounds = a.rounds;
  const float* __restrict__ eout = a.eout;
  const float* __restrict__ dout = a.dout;
  const float* __restrict__ jb = a.jb;
  float* tbuf = a.tbuf;
  float* bv = a.bv;
  int* mi = a.mi;
  float* mv = a.mv;
  unsigned long long* keys = a.keys;
  unsigned* ticket = a.ticket;
  unsigned long long* stamps = a.stamps;
  const int TC = Vc / RC, TSg = TS / RS;  // column groups, session groups
  const int nkc = J / JS_KC;
  const int tid = threadIdx.x;
  const int v0 = (blockIdx.x % n_vs) * Vc;
  const int r0 = (blockIdx.x / n_vs) * rounds;
  const int nr = min(rounds, n_st - r0);  // this block's session tiles
  const int nst = 5 + 3 * rounds;  // stamps a block: entry, tanh, barrier, load, rounds, end
  const JsLayout L = js_layout(J, Vc, TS, WRES);
  float* Ws = reinterpret_cast<float*>(smem + L.w);
  float* Ts = reinterpret_cast<float*>(smem + L.t);
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem + L.keys);
  const float* wsrc = a.wf + (size_t)(v0 / Vc) * J * Vc;
  const int nwb = min(nkc, JS_WBARS), cpb = (nkc + nwb - 1) / nwb;  // chunks a W mbarrier covers

  // stage q of this block: t rows [c KC, (c + 1) KC) of tile r0 + q / nkc
  // (and W's, where it streams), onto the slot's mbarrier
  const auto stage_in = [&](int q) {
    const int slot = q % JS_NS, r = r0 + q / nkc, c = q % nkc;
    const unsigned tb = JS_KC * TS * 4, wbytes = WRES ? 0 : JS_KC * Vc * 4;
    mbar_expect(&tbar[slot], tb + wbytes);
    bulk_copy(Ts + (size_t)slot * JS_KC * TS, tbuf + ((size_t)r * J + (size_t)c * JS_KC) * TS,
              tb, &tbar[slot]);
    if (!WRES)
      bulk_copy(Ws + (size_t)slot * JS_KC * Vc, wsrc + (size_t)c * JS_KC * Vc, wbytes, &tbar[slot]);
  };

  if (tid == 0) {
    for (int i = 0; i < JS_NS; ++i) mbar_init(&tbar[i], 1);
    for (int i = 0; i < JS_WBARS; ++i) mbar_init(&wbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (WRES)
      for (int i = 0; i < nwb; ++i) {
        const int c0 = i * cpb, c1 = min(nkc, c0 + cpb);
        if (c0 >= c1) continue;
        const unsigned bytes = (unsigned)((c1 - c0) * JS_KC * Vc * 4);
        mbar_expect(&wbar[i], bytes);
        bulk_copy(Ws + (size_t)c0 * JS_KC * Vc, wsrc + (size_t)c0 * JS_KC * Vc, bytes, &wbar[i]);
      }
  }
  for (int i = tid; i < TS; i += JS_NT) skey[i] = 0;
  __syncthreads();
  js_stamp(stamps, nst, 0);

  // 1. t for every session tile, across the grid (sessions past S zero);
  // consecutive threads take consecutive sessions, so that the scratch's
  // rows are written whole
  {
    const int Sp = n_st * TS;
    const size_t n4 = (size_t)Sp * (J / 4);
    for (size_t i = (size_t)blockIdx.x * JS_NT + tid; i < n4; i += (size_t)gridDim.x * JS_NT) {
      const int k = 4 * (int)(i / Sp), s = (int)(i - (size_t)(k / 4) * Sp);
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < S) {
        const float4 e = *reinterpret_cast<const float4*>(eout + (size_t)s * J + k);
        const float4 d = *reinterpret_cast<const float4*>(dout + (size_t)s * J + k);
        y[0] = Wt<WT>::act(tanhf(__fadd_rn(e.x, d.x)));
        y[1] = Wt<WT>::act(tanhf(__fadd_rn(e.y, d.y)));
        y[2] = Wt<WT>::act(tanhf(__fadd_rn(e.z, d.z)));
        y[3] = Wt<WT>::act(tanhf(__fadd_rn(e.w, d.w)));
      }
      const int r = s / TS, sl = s - r * TS;
      float* dst = tbuf + ((size_t)r * J + k) * TS + sl;
#pragma unroll
      for (int u = 0; u < 4; ++u) dst[(size_t)u * TS] = y[u];
    }
  }
  // the scratch, written by this proxy, is read by the bulk-copy engine
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  js_stamp(stamps, nst, 1);
  cg::this_grid().sync();
  js_stamp(stamps, nst, 2);

  // 2. the session tiles, chunk by chunk through the ring
  const int nq = nr * nkc;
  if (tid == 0) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int q = 0; q < min(JS_NS, nq); ++q) stage_in(q);
  }
  const int cgi = tid % TC, sg = tid / TC;
  const bool on = sg < TSg;
  // this thread's columns and their biases, loaded under the first tile's
  // product
  int vj[RC];
  float bj[RC];
  bool has_blank = false;
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    vj[j] = v0 + (j / GC) * TC * GC + cgi * GC + j % GC;
    bj[j] = on && vj[j] < V ? __ldg(jb + vj[j]) : 0.f;
    has_blank |= vj[j] == blank;
  }
  int q = 0;
  for (int rr = 0; rr < nr; ++rr) {
    float acc[RS][RC];
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < nkc; ++c, ++q) {
      const int slot = q % JS_NS;
      mbar_wait(&tbar[slot], (q / JS_NS) & 1);
      if (WRES && rr == 0 && c % cpb == 0) mbar_wait(&wbar[c / cpb], 0);
      if (q == 0) js_stamp(stamps, nst, 3);  // the first stage and W's first chunk landed
      if (on) {
        const float* wk = Ws + (size_t)(WRES ? c : slot) * JS_KC * Vc + cgi * GC;
        const float* tk = Ts + (size_t)slot * JS_KC * TS + sg * GS;
        chunk_fma<RC, RS>(wk, tk, Vc, TS, TC * GC, TSg * GS, acc);
      }
      __syncthreads();
      if (tid == 0 && q + JS_NS < nq) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        stage_in(q + JS_NS);
      }
    }
    js_stamp(stamps, nst, 4 + 3 * rr);

    // 3. per session, the largest key of this block's columns: the largest
    // order bits (argmax_key's) over the thread's columns, the first on
    // ties (its columns rise with j), as one key; then the largest over the
    // lanes that share the session
    const int s0 = (r0 + rr) * TS;
    unsigned long long key[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      unsigned best = 0;
      int bi = -1;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        float lv = __fadd_rn(acc[i][j], bj[j]);
        if (has_blank && vj[j] == blank) {
          const int s = s0 + (i / GS) * TSg * GS + sg * GS + i % GS;
          if (on && s < S) bv[s] = lv;
          lv = NEG_INF_F;
        }
        const unsigned ord = order_bits(lv);
        if (vj[j] < V && (bi < 0 || ord > best)) {
          best = ord;
          bi = vj[j];
        }
      }
      key[i] = on && bi >= 0 ? argmax_key(best, bi) : 0ull;  // 0: below every real key
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      if (o >= TC) break;
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const unsigned long long ok = __shfl_xor_sync(0xffffffffu, key[i], o);
        key[i] = ok > key[i] ? ok : key[i];
      }
    }
    js_stamp(stamps, nst, 5 + 3 * rr);
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int row = (i / GS) * TSg * GS + sg * GS + i % GS, s = s0 + row;
      if (!on || (cgi & 31) != 0 || s >= S) continue;
      if (TC > 32)
        atomicMax(skey + row, key[i]);
      else  // one warp holds the session's columns
        atomicMax(keys + s, key[i]);
    }
    if (TC > 32) {
      __syncthreads();
      for (int row = tid; row < TS; row += JS_NT) {
        if (s0 + row < S) atomicMax(keys + s0 + row, skey[row]);
        skey[row] = 0;
      }
    }
    js_stamp(stamps, nst, 6 + 3 * rr);
  }
  for (int rr = nr; rr < rounds; ++rr)
    for (int u = 4; u < 7; ++u) js_stamp(stamps, nst, u + 3 * rr);

  // the last block to finish turns the keys into the outputs and leaves
  // keys and ticket zero
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int s = tid; s < S; s += JS_NT) {
      const unsigned long long k = atomicExch(keys + s, 0ull);
      mi[s] = (int)(0xffffffffu - (unsigned)(k & 0xffffffffu));
      mv[s] = key_value(k);
    }
    if (tid == 0) atomicExch(ticket, 0u);
  }
  js_stamp(stamps, nst, 4 + 3 * rounds);
}

// the register tiles (RC columns x RS sessions a thread), by the plan's index
#define JS_TILES 4
static const int TILE_RC[JS_TILES] = {8, 4, 2, 1};
static const int TILE_RS[JS_TILES] = {8, 4, 2, 1};

template <int T, typename WT, bool R>
static const void* kern() {
  constexpr int rc = T == 0 ? 8 : T == 1 ? 4 : T == 2 ? 2 : 1;
  return reinterpret_cast<const void*>(joiner_stream_kernel<WT, rc, rc, R>);
}

// the instantiation for the weights' type (w_f32) and W resident or streamed
template <int T>
static const void* pick_tile(int w_f32, int wres) {
  if (w_f32) return wres ? kern<T, float, true>() : kern<T, float, false>();
  return wres ? kern<T, uint16_t, true>() : kern<T, uint16_t, false>();
}

static const void* pick(int tile, int w_f32, int wres) {
  switch (tile) {
    case 0: return pick_tile<0>(w_f32, wres);
    case 1: return pick_tile<1>(w_f32, wres);
    case 2: return pick_tile<2>(w_f32, wres);
    default: return pick_tile<3>(w_f32, wres);
  }
}

// Opts an instantiation in to `smem` bytes of dynamic shared memory: a
// runtime call only where this device's setting is smaller (it only grows),
// so a call of the wrapper makes none once its shape has run.
static cudaError_t allow_once(int tile, int w_f32, int wres, int smem) {
  static int set[16][JS_TILES * 4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* cur = dev < 16 ? &set[dev][tile * 4 + 2 * w_f32 + wres] : nullptr;
  if (cur != nullptr && *cur >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(pick(tile, w_f32, wres), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && cur != nullptr) *cur = smem;
  return err;
}

// How many blocks of the instantiation (register tile `tile`, the weights'
// type, W resident or streamed) with `smem` bytes this device runs at once
// on an SM, or minus a CUDA error.
extern "C" int joiner_stream_fit(int tile, int w_f32, int wres, int smem, void* stream) {
  (void)stream;
  if (tile < 0 || tile >= JS_TILES) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow_once(tile, w_f32, wres, smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pick(tile, w_f32, wres), JS_NT, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// w_f32 selects the type of W (1: f32, 0: bf16); tile, wres, Vc, TS,
// rounds, blocks and smem are the plan's; wf W's slices [n_vs][J][Vc] f32;
// tbuf the [n_st][J][TS] f32 scratch; keys [S + 1] u64, zero, the last one
// the ticket (the kernel leaves them zero). Returns minus the bytes of this
// kernel's layout where they differ from `smem` (nothing launched), 1
// (cudaErrorInvalidValue) for shapes it does not take, else the launch's
// error (cudaErrorCooperativeLaunchTooLarge where the grid cannot be
// co-resident).
extern "C" int joiner_stream(const float* eout, const float* dout, const float* wf, const float* jb,
                             int* mi, float* mv, float* bv, float* tbuf, unsigned long long* keys,
                             unsigned long long* stamps, int S, int J, int V, int blank, int w_f32,
                             int tile, int wres, int Vc, int TS, int rounds, int blocks, int smem,
                             void* stream) {
  if (tile < 0 || tile >= JS_TILES) return (int)cudaErrorInvalidValue;
  const int RC = TILE_RC[tile], RS = TILE_RS[tile];
  const JsLayout L = js_layout(J, Vc, TS, wres);
  if (L.total != (size_t)smem) return -(int)L.total;
  if (S < 1 || V < 1 || J < JS_KC || J % JS_KC || Vc < RC || Vc % RC || TS < RS || TS % RS ||
      rounds < 1 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  const int TC = Vc / RC, TSg = TS / RS;
  const int n_vs = (V + Vc - 1) / Vc, n_st = (S + TS - 1) / TS;
  if (TC * TSg > JS_NT || (TC < 32 ? (TC & (TC - 1)) != 0 : TC % 32 != 0) ||
      blocks != n_vs * ((n_st + rounds - 1) / rounds))
    return (int)cudaErrorInvalidValue;
  JsArgs a;
  a.eout = eout; a.dout = dout; a.wf = wf; a.jb = jb; a.mi = mi; a.mv = mv; a.bv = bv;
  a.tbuf = tbuf; a.keys = keys; a.ticket = reinterpret_cast<unsigned*>(keys + S);
  a.stamps = stamps;
  a.S = S; a.J = J; a.V = V; a.blank = blank; a.Vc = Vc; a.TS = TS; a.n_vs = n_vs;
  a.n_st = n_st; a.rounds = rounds;
  cudaError_t err = allow_once(tile, w_f32, wres, smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(pick(tile, w_f32, wres), dim3(blocks), dim3(JS_NT), params,
                                    (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
