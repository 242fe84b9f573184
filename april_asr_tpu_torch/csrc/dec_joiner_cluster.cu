// Kernel 8 for the H100: one round of the greedy decode (the lazy decoder
// refresh, the joiner and the blank-excluded argmax) as one launch of
// thread-block clusters.
//
// Replaces april_asr_tpu/ops/joiner_pallas.py `decoder_joiner_argmax_fused`
// (`_dj_kernel`) and computes what csrc/joiner.cu's `dec_joiner_simt` (kept
// for the shapes no cluster slice holds) computes, bit for bit, at bf16 and
// f32 weights: for the sessions whose need_dec is set, pre = T0[c0] + T1[c1]
// (exact f32 row gathers), new = wd(relu(pre)) @ dec_proj + b and the blend
// dout' = n * new + (1 - n) * dout (n = 1); the other rows keep dout; then
// logits = wd(tanh(eout + dout')) @ W + jb, blank_val = logits[blank] and
// the largest logit with the blank column excluded (first index on ties).
//
// What binds it. A call is 2 S J (V + d) flops at most over 1 MB (bf16) or
// 2 MB (f32) of weights, ~0.001-0.004 ms on the H100. The kept kernel makes
// four stream operations of a call (a memset of the argmax keys, the refresh
// on S / 16 blocks, the joiner on ceil(V / 256) x S / 16 blocks, a
// finalization): 16 and 32 of the 132 SMs at S = 256, each thread's 16 or 32
// chains reading their weights from L2, and it refreshes every session, then
// blends. In a flush round most sessions emitted blank and need no refresh.
//
// Design: kernel 4's round (csrc/chunk_decode_cluster.cu, phases A-C)
// without the heuristics, on the pieces they share
// (csrc/chunk_decode_cluster.cuh). A cluster of C blocks owns a tile of TS
// sessions; block r holds W's columns [r Vc, (r + 1) Vc) and, where the plan
// says so, dec_proj's [r Jc, (r + 1) Jc) in shared memory, each column's
// weights contiguous (K + KPAD apart). The wrapper lays both matrices out
// once in that form (ops/joiner_kernels.py `dj_weight_forms`), so a block's
// slice is one contiguous range that the bulk-copy engine brings onto an
// mbarrier: dec_proj's right after the refresh list is known, W's at entry,
// landing while phase A runs. Where both slices exceed a block (f32), the
// dec_proj columns stream from L2 as tensor-map boxes through a TMA ring,
// as kernel 4's. One launch:
//   A. the refreshing sessions' decoder inputs (table rows, relu, wd), this
//      block's Jc columns of their new dout, blended as dec_refresh blends;
//      then this block's columns of dout' (the other rows copy dout), written
//      out, and of a = wd(tanh(eout + dout')); cluster barrier.
//   B. every block's columns of a through distributed shared memory; the
//      logits of this block's Vc columns for the tile; per session the
//      largest of them (the blank's at -1e30) as dec_joiner_simt's 64-bit
//      argmax key, stored, with the blank's logit, into the block that owns
//      the session (session i: block i % C); cluster barrier.
//   C. each block merges its sessions' keys in rank order (their maximum:
//      the larger logit, then the lower index, with -0 below +0 as the kept
//      kernel's atomicMax orders them) and writes max_idx, max_val and
//      blank_val. No memset, no atomic, no finalization kernel.
// The plan (ops/decode_kernels.py `dj_plan`) takes the fewest waves of
// clusters, then the fewest weight bytes staged a call, since every cluster
// loads its slices in every call.
//
// Numerics: each sum is one thread's fmaf chain over k = 0 .. K-1, then the
// bias, in joiner.cu's order; tanhf as written (no fast-math). The rows
// that refresh are written as dec_refresh writes them,
// fl(fl(n * fl(acc + b)) + fl(fl(1 - n) * dout)). A row that does not
// refresh copies dout, where dec_refresh writes fl(fl(0 * new) + dout) with
// `new` computed anyway: the two differ only where `new` is not finite (0 *
// inf is NaN) or dout is exactly -0 (and 0 * new is +0, so the sum is +0).
// chip_smoke.py holds the outputs equal to dec_joiner_simt's.

#include "chunk_decode_cluster.cuh"

#define NEG_INF_F (-1e30f)
#define DJ_STAMPS 12   // per block: entry and the ends of 11 phases
#define SLICE_CHUNK 32768  // bytes a bulk copy of a slice carries at most

struct DjLayout {
  size_t ws, dps, x, r2, aloc, dout, part, blank, lists, total;
};

// Byte offsets of a block's shared memory; ops/decode_kernels.py `dj_smem`
// computes the same total.
__host__ __device__ inline DjLayout dj_layout(int TS, int J, int d, int Vc, int Jc, int C, int wb,
                                              int dp_smem) {
  DjLayout L;
  size_t o = 0;
  L.ws = o;    o += up16((size_t)Vc * (J + KPAD) * wb);                 // W columns [Vc][J + KPAD]
  L.dps = o;   o += dp_smem ? up16((size_t)Jc * (d + KPAD) * wb) : 0;  // dec_proj [Jc][d + KPAD]
  L.x = o;     o += up16((size_t)TS * (J > d ? J : d) * 4);  // refresh input, then joiner input
  L.r2 = o;    o += up16(max_sz((size_t)TS * Vc * 4,         // logits, or the dec_proj ring
                                dp_smem ? 0 : (size_t)2 * RING_ROWS * Jc * wb + 128));
  L.aloc = o;  o += up16((size_t)TS * Jc * 4);               // this block's columns of a
  L.dout = o;  o += up16((size_t)TS * Jc * 4);               // refreshed dout columns
  L.part = o;  o += up16((size_t)C * TS * 8);                // argmax keys [C][TS]
  L.blank = o; o += up16((size_t)TS * 4);                    // blank logits [TS]
  L.lists = o; o += up16((size_t)2 * TS * 4);                // refresh list, row of each session
  L.total = o;
  return L;
}

// (value, index) as one key whose unsigned order is the argmax order:
// larger value first, then lower index (joiner.cu's key).
__device__ __forceinline__ unsigned long long argmax_key(float v, int i) {
  const unsigned b = __float_as_uint(v);
  const unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)ord << 32) | (0xffffffffu - (unsigned)i);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  const unsigned ord = (unsigned)(k >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// A slice of `bytes` (a multiple of 16, both ends 16-byte aligned) copied
// from global to shared memory by the bulk-copy engine onto `bar`, in
// copies of at most SLICE_CHUNK bytes; by one thread.
__device__ __forceinline__ void load_slice(void* dst, const void* src, unsigned bytes,
                                           uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
  for (unsigned o = 0; o < bytes; o += SLICE_CHUNK) {
    const unsigned n = bytes - o < SLICE_CHUNK ? bytes - o : SLICE_CHUNK;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(static_cast<char*>(dst) + o)), "l"(static_cast<const char*>(src) + o),
        "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_done(bar, parity)) {
  }
}

struct alignas(64) DjArgs {
  CUtensorMap dp_map;            // dec_proj as a [d][J] tensor, boxes of RING_ROWS x Jc (streamed)
  const int* ctx;                // [S][2]
  const unsigned char* nd;       // need_dec [S], bool
  const float* dout;             // [S][J]
  const float* eout;             // [S][J]
  const float* dec_table;        // [2][V][d]
  const void* dpf;               // dec_proj's columns [C Jc][d + KPAD] (resident), or null
  const float* dpb;              // [J]
  const void* wf;                // W's columns [C Vc][J + KPAD]
  const float* jb;               // [V]
  int* mi;
  float* mv;
  float* bv;
  float* dout_out;               // [S][J]
  unsigned long long* stamps;    // null, or [blocks][DJ_STAMPS] global-timer ns
  int S, J, d, V, blank, C, TS, Vc, Jc;
};

template <typename WT, bool DP_SMEM>
__global__ void __launch_bounds__(CNT, 1) dec_joiner_cluster_kernel(const __grid_constant__ DjArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int n_ref;
  __shared__ uint64_t slice_bars[2];  // W's slice, dec_proj's
  __shared__ uint64_t ring_bars[8];   // the streamed ring's stage mbarriers
  unsigned ph = 0;                    // their phase parities
  cg::cluster_group cl = cg::this_cluster();
  const int C = a.C, TS = a.TS, Vc = a.Vc, Jc = a.Jc;
  const int J = a.J, d = a.d, V = a.V, S = a.S;
  const int rank = (int)cl.block_rank();
  const int s0 = (blockIdx.x / C) * TS;
  const int ns = max(0, min(TS, S - s0));
  const int v0 = rank * Vc, vn = max(0, min(Vc, V - v0));
  const int j0 = rank * Jc, jn = max(0, min(Jc, J - j0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const DjLayout L = dj_layout(TS, J, d, Vc, Jc, C, (int)sizeof(WT), DP_SMEM);
  WT* Ws = reinterpret_cast<WT*>(smem + L.ws);
  WT* Dps = reinterpret_cast<WT*>(smem + L.dps);
  float* X = reinterpret_cast<float*>(smem + L.x);        // [row][d] phase A, [session][J] phase B
  float* Lg = reinterpret_cast<float*>(smem + L.r2);      // [session][Vc], phase B
  float* aloc = reinterpret_cast<float*>(smem + L.aloc);  // [TS][Jc], read by every block
  float* Dout = reinterpret_cast<float*>(smem + L.dout);  // [refresh row][Jc]
  unsigned long long* part = reinterpret_cast<unsigned long long*>(smem + L.part);  // written by every block
  float* blankv = reinterpret_cast<float*>(smem + L.blank);  // written by the blank's block
  int* ref = reinterpret_cast<int*>(smem + L.lists);  // the refreshing sessions, in order
  int* pos = ref + TS;                                // each session's refresh row, or -1
  const bool has_blank = a.blank >= v0 && a.blank < v0 + vn;

  stamp(a.stamps, DJ_STAMPS, 0);
  if (warp == 0) {
    if (lane == 0) {
      mbar_init(slice_bars);
      mbar_init(slice_bars + 1);
      if (!DP_SMEM)
        for (int i = 0; i < 8; ++i) mbar_init(ring_bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (vn > 0)
        load_slice(Ws, static_cast<const WT*>(a.wf) + (size_t)v0 * (J + KPAD),
                   (unsigned)((size_t)Vc * (J + KPAD) * sizeof(WT)), slice_bars);
    }
    const unsigned below = (1u << lane) - 1;
    int n = 0;
    for (int b = 0; b < ns; b += 32) {
      const int i = b + lane;
      const bool r = i < ns && a.nd[s0 + i] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, r);
      if (i < ns) pos[i] = r ? n + __popc(m & below) : -1;
      if (r) ref[n + __popc(m & below)] = i;
      n += __popc(m);
    }
    if (lane == 0) {
      n_ref = n;
      if (DP_SMEM && n > 0 && jn > 0)
        load_slice(Dps, static_cast<const WT*>(a.dpf) + (size_t)j0 * (d + KPAD),
                   (unsigned)((size_t)Jc * (d + KPAD) * sizeof(WT)), slice_bars + 1);
    }
  }
  __syncthreads();
  const int nR = n_ref;
  const bool refresh = nR > 0 && jn > 0;
  if (DP_SMEM && refresh) mbar_wait(slice_bars + 1, 0);
  stamp(a.stamps, DJ_STAMPS, 1);

  // A. the refreshing rows' decoder inputs, then this block's columns of
  // their new dout
  if (refresh) {
    const int d4 = d / 4;
    for (int i = tid; i < nR * d4; i += CNT) {
      const int sl = i / d4, k = 4 * (i - sl * d4);
      const int s = s0 + ref[sl];
      const float4 t0 =
          __ldg(reinterpret_cast<const float4*>(a.dec_table + (size_t)a.ctx[2 * s] * d + k));
      const float4 t1 = __ldg(
          reinterpret_cast<const float4*>(a.dec_table + ((size_t)V + a.ctx[2 * s + 1]) * d + k));
      float4 h;
      h.x = Wt<WT>::act(fmaxf(__fadd_rn(t0.x, t1.x), 0.f));
      h.y = Wt<WT>::act(fmaxf(__fadd_rn(t0.y, t1.y), 0.f));
      h.z = Wt<WT>::act(fmaxf(__fadd_rn(t0.z, t1.z), 0.f));
      h.w = Wt<WT>::act(fmaxf(__fadd_rn(t0.w, t1.w), 0.f));
      *reinterpret_cast<float4*>(X + (size_t)sl * d + k) = h;
    }
  }
  stamp(a.stamps, DJ_STAMPS, 2);
  if (refresh) {
    __syncthreads();
    const float* dpb = a.dpb + j0;
    const auto row = [&](int b) { return X + (size_t)b * d; };
    const auto out = [&](int b, int j, float acc) {
      const int s = s0 + ref[b];
      const float n = (float)a.nd[s];
      Dout[(size_t)b * Jc + j] =
          __fadd_rn(__fmul_rn(n, __fadd_rn(acc, dpb[j])),
                    __fmul_rn(__fsub_rn(1.f, n), a.dout[(size_t)s * J + j0 + j]));
    };
    if constexpr (DP_SMEM) {
      rows_by_cols_spread(nR, Jc, jn, d, row, Dps, out);
    } else {
      // the ring takes the room of X past the nR refresh rows and of the
      // logits (128-byte aligned): at least the two stages the plan keeps
      // in the logits'
      const size_t base = smem_u32(smem);
      const size_t from = ((base + L.x + (size_t)nR * d * 4 + 127) & ~(size_t)127) - base;
      WT* ring = reinterpret_cast<WT*>(smem + from);
      const int slots = min(8, (int)((L.aloc - from) / ((size_t)RING_ROWS * Jc * sizeof(WT))));
      if (item_rows(nR, Jc) == 1)
        refresh_streamed<1, WT>(nR, Jc, d, &a.dp_map, j0, ring, slots, ring_bars, ph, row, out);
      else
        refresh_streamed<GS, WT>(nR, Jc, d, &a.dp_map, j0, ring, slots, ring_bars, ph, row, out);
    }
    __syncthreads();
  }
  stamp(a.stamps, DJ_STAMPS, 3);
  // this block's columns of dout' (written out) and of a
  if (jn > 0) {
    const int q4 = jn / 4;
    for (int i = tid; i < ns * q4; i += CNT) {
      const int s = i / q4, j = 4 * (i - s * q4);
      const size_t g = (size_t)(s0 + s) * J + j0 + j;
      const float4 o = pos[s] >= 0
                           ? *reinterpret_cast<const float4*>(Dout + (size_t)pos[s] * Jc + j)
                           : *reinterpret_cast<const float4*>(a.dout + g);
      const float4 e = *reinterpret_cast<const float4*>(a.eout + g);
      *reinterpret_cast<float4*>(a.dout_out + g) = o;
      float4 y;
      y.x = Wt<WT>::act(tanhf(__fadd_rn(e.x, o.x)));
      y.y = Wt<WT>::act(tanhf(__fadd_rn(e.y, o.y)));
      y.z = Wt<WT>::act(tanhf(__fadd_rn(e.z, o.z)));
      y.w = Wt<WT>::act(tanhf(__fadd_rn(e.w, o.w)));
      *reinterpret_cast<float4*>(aloc + (size_t)s * Jc + j) = y;
    }
  }
  stamp(a.stamps, DJ_STAMPS, 4);
  cl.sync();
  stamp(a.stamps, DJ_STAMPS, 5);

  // B. every block's columns of a, then the logits of this block's columns
  // and their argmax key per session
  gather_a(cl, aloc, X, ns, J, Jc, [](int sl) { return sl; });
  stamp(a.stamps, DJ_STAMPS, 6);
  if (vn > 0) {
    mbar_wait(slice_bars, 0);
    __syncthreads();
    const float* jb = a.jb + v0;
    rows_by_cols_spread(
        ns, Vc, vn, J, [&](int b) { return X + (size_t)b * J; }, Ws,
        [&](int b, int v, float acc) { Lg[(size_t)b * Vc + v] = __fadd_rn(acc, jb[v]); });
  }
  stamp(a.stamps, DJ_STAMPS, 7);
  if (vn > 0) {
    __syncthreads();
    for (int sl = warp; sl < ns; sl += CNT / 32) {
      unsigned long long k = 0;  // below every real key
      for (int v = lane; v < vn; v += 32) {
        const float lv = v0 + v == a.blank ? NEG_INF_F : Lg[(size_t)sl * Vc + v];
        const unsigned long long kv = argmax_key(lv, v0 + v);
        k = kv > k ? kv : k;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long ok = __shfl_xor_sync(0xffffffffu, k, o);
        k = ok > k ? ok : k;
      }
      if (lane == 0) {
        const int owner = sl % C;
        cl.map_shared_rank(part, owner)[rank * TS + sl] = k;
        if (has_blank) cl.map_shared_rank(blankv, owner)[sl] = Lg[(size_t)sl * Vc + a.blank - v0];
      }
    }
  }
  stamp(a.stamps, DJ_STAMPS, 8);
  cl.sync();
  stamp(a.stamps, DJ_STAMPS, 9);

  // C. this block's sessions (rank, rank + C, ...): the keys of the blocks
  // that hold columns, merged in rank order
  const int nv = min(C, (V + Vc - 1) / Vc);
  const int sl = rank + C * tid;
  unsigned long long best = 0;
  if (sl < ns)
    for (int r = 0; r < nv; ++r) {
      const unsigned long long k = part[r * TS + sl];
      best = k > best ? k : best;
    }
  stamp(a.stamps, DJ_STAMPS, 10);
  if (sl < ns) {
    const int s = s0 + sl;
    a.mi[s] = (int)(0xffffffffu - (unsigned)(best & 0xffffffffu));
    a.mv[s] = key_value(best);
    a.bv[s] = blankv[sl];
  }
  stamp(a.stamps, DJ_STAMPS, 11);
}

template <typename WT, bool DP>
static const void* kernel_of() {
  return reinterpret_cast<const void*>(dec_joiner_cluster_kernel<WT, DP>);
}

static int pick_index(int w_f32, int dp_smem) { return 2 * w_f32 + dp_smem; }

static const void* pick(int w_f32, int dp_smem) {
  if (w_f32) return dp_smem ? kernel_of<float, true>() : kernel_of<float, false>();
  return dp_smem ? kernel_of<uint16_t, true>() : kernel_of<uint16_t, false>();
}

// Opts an instantiation in to `smem` bytes of dynamic shared memory: a
// driver call only where this device's setting is smaller (it only grows),
// so a call of the wrapper makes none once its shape has run.
static cudaError_t allow_once(int w_f32, int dp_smem, int smem) {
  static int set[16][4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* cur = dev < 16 ? &set[dev][pick_index(w_f32, dp_smem)] : nullptr;
  if (cur != nullptr && *cur >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(pick(w_f32, dp_smem), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cur != nullptr) *cur = smem;
  return err;
}

// dec_proj's tensor map, encoded once per (pointer, shape, slice, type) of
// the last eight used.
static int cached_map(CUtensorMap* map, const void* dp, int J, int d, int Jc, int w_f32) {
  struct Entry {
    CUtensorMap map;
    const void* dp;
    int J, d, Jc, w_f32;
  };
  static Entry cache[8];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.dp == dp && e.J == J && e.d == d && e.Jc == Jc && e.w_f32 == w_f32) {
      *map = e.map;
      return 0;
    }
  }
  const int err = dp_tensor_map(map, dp, J, d, Jc, w_f32);
  if (err) return err;
  Entry& e = cache[next];
  e.map = *map;
  e.dp = dp;
  e.J = J;
  e.d = d;
  e.Jc = Jc;
  e.w_f32 = w_f32;
  next = (next + 1) % 8;
  used = used < 8 ? used + 1 : 8;
  return 0;
}

// How many clusters of C blocks with `smem` bytes each this device runs at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int dec_joiner_cluster_fit(int C, int smem, int w_f32, int dp_smem, void* stream) {
  cudaError_t err = allow_once(w_f32, dp_smem, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, C, smem, (cudaStream_t)stream, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, pick(w_f32, dp_smem), &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// w_f32 selects the type of dec_proj and W (1: f32, 0: bf16); C, TS, Vc, Jc,
// dp_smem and smem are the plan's; dpf and wf the slices' layout of dec_proj
// (null where it streams) and W; dp dec_proj itself [d][J] (the streamed
// ring's tensor map). Returns minus the bytes of this kernel's layout where
// they differ from `smem` (nothing launched), 1 (cudaErrorInvalidValue) for
// shapes it does not take, else the launch's error.
extern "C" int dec_joiner_cluster(const int* ctx, const unsigned char* nd, const float* dout,
                                  const float* eout, const float* dec_table, const void* dp,
                                  const void* dpf, const float* dpb, const void* wf,
                                  const float* jb, int* mi, float* mv, float* bv, float* dout_out,
                                  unsigned long long* stamps, int S, int J, int d, int V,
                                  int blank, int w_f32, int C, int TS, int Vc, int Jc,
                                  int dp_smem, int smem, void* stream) {
  const DjLayout L = dj_layout(TS, J, d, Vc, Jc, C, w_f32 ? 4 : 2, dp_smem);
  if (L.total != (size_t)smem) return -(int)L.total;
  const int wb = w_f32 ? 4 : 2;
  if (J % 16 || d % 16 || Jc % 4 || Vc % 8 || C < 1 || C > 8 || TS < 1 || S < 1 ||
      C * Jc < J || C * Vc < V || blank < 0 || blank >= V || (dp_smem && dpf == nullptr) ||
      (!dp_smem && (d % RING_ROWS || (TS + GS - 1) / GS * Jc > CNT || C * Jc != J ||
                    Jc * wb % 16 || Jc > 256 || reinterpret_cast<uintptr_t>(dp) % 16)))
    return (int)cudaErrorInvalidValue;
  DjArgs a;
  a.ctx = ctx; a.nd = nd; a.dout = dout; a.eout = eout; a.dec_table = dec_table; a.dpf = dpf;
  a.dpb = dpb; a.wf = wf; a.jb = jb; a.mi = mi; a.mv = mv; a.bv = bv; a.dout_out = dout_out;
  a.stamps = stamps;
  a.S = S; a.J = J; a.d = d; a.V = V; a.blank = blank; a.C = C; a.TS = TS; a.Vc = Vc; a.Jc = Jc;
  if (!dp_smem) {
    const int err = cached_map(&a.dp_map, dp, J, d, Jc, w_f32);
    if (err) return err;
  }
  cudaError_t err = allow_once(w_f32, dp_smem, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config((S + TS - 1) / TS * C, C, smem, (cudaStream_t)stream, attr);
  void* params[] = {&a};
  err = cudaLaunchKernelExC(&cfg, pick(w_f32, dp_smem), params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
