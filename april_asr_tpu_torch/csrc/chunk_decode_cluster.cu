// Kernel 4 for the H100: the whole chunk's greedy transducer decode as one
// launch of thread-block clusters, the joiner and decoder weights resident
// in shared memory for the whole launch.
//
// Replaces april_asr_tpu/ops/decode_pallas.py `chunk_decode_fused`
// (`_chunk_decode_kernel`) and computes what csrc/chunk_decode.cu (kept as
// `chunk_decode_simt`) computes, bit for bit, at bf16 and f32 decode
// weights.
//
// What binds it. The P x 3 rounds are a chain: each round's decoder refresh
// (dout = wd(relu(T0[c0] + T1[c1])) @ dec_proj + b), joiner
// (wd(tanh(eout + dout)) @ W + b), blank-excluded argmax and heuristics
// need the last round's decisions. The products are 2 J (V + d) flops a
// session-round over 1 MB (bf16) or 2 MB (f32) of weights. The CUDA-core
// kernel gave each block 4 sessions (64 blocks at S = 256) and re-read both
// matrices from L2 in every round, one load per 4 multiply-adds: it waited
// on L2 latency, ~105 us a round. Here a round (~17 us at S = 256, bf16;
// tools/profile_decode.py) is bound by its two sequential 512-long fmaf
// chains and their shared-memory loads (~5.5 us each), the heuristics
// (~2.5 us), the decoder-table gather, the exchange of a and two cluster
// barriers; at f32 also by the streamed dec_proj columns.
//
// Design. A cluster of C blocks owns a tile of TS sessions for the whole
// launch. Block r of the cluster holds columns [r Vc, (r + 1) Vc) of W and,
// where the plan says so, columns [r Jc, (r + 1) Jc) of dec_proj in shared
// memory, loaded once (the last slices ragged, maybe empty), each column's
// weights contiguous so that one load brings four. Otherwise (f32 weights,
// whose two slices exceed a block) its dec_proj columns stream from L2 in
// every round that refreshes, as tensor-map boxes of 32 rows that the TMA
// engine copies into a ring in the room the round leaves free (2 to 8
// stages). Every block keeps the tile's decode state, token windows and
// token masks, and its own Jc columns of dout. A round:
//   A. refresh: each block computes its Jc columns of dout for the sessions
//      that need it, then its Jc columns of a = wd(tanh(eout + dout)) for
//      the active sessions; cluster barrier.
//   B. joiner: each block reads every block's columns of a through
//      distributed shared memory, computes the logits of its Vc columns
//      for the active sessions, their blank-excluded argmax (largest,
//      lowest index on ties) and the blank's logit, and stores them into
//      every block; cluster barrier.
//   C. every block merges the C partial argmaxes in rank order (largest,
//      lowest index on ties: the whole row's first argmax) and runs every
//      heuristic (csrc/chunk_decode.cuh; the sessions spread over the
//      warps), so all blocks keep the same state without a third barrier;
//      block 0 writes the events and, at the end, the state; each block
//      writes its dout columns.
// Each sum is one thread's fmaf chain over k = 0 .. K-1, then the bias, in
// the CUDA-core kernel's order; tanhf as written, no fast-math. A thread's
// item is one column for one session where few are active (the shortest
// critical path) and for 4 otherwise (each weight read feeds 4 chains).
// The columns of a that a block reads in phase B are rewritten only in the
// next phase A, after the barrier that every block passes once its reads
// are done; the partials it stores are read in phase C and rewritten only
// after the next barrier A. So one copy of each suffices. The plan
// (ops/decode_kernels.py `decode_plan`) picks C, TS and the slices so that
// the clusters fit one wave where the shared memory allows. The pieces it
// shares with kernel 8 (csrc/dec_joiner_cluster.cu) are in
// csrc/chunk_decode_cluster.cuh.

#include "chunk_decode.cuh"
#include "chunk_decode_cluster.cuh"

struct Partial {
  float v;
  int i;
};

struct Layout {
  size_t ws, dps, x, r2, aloc, dout, es, words, part, blank, can, st, lists, tmask, total;
};

// Byte offsets of a block's shared memory; ops/decode_kernels.py
// `cluster_smem` computes the same total.
__host__ __device__ inline Layout cluster_layout(int TS, int J, int d, int V, int Vc, int Jc,
                                                 int T, int C, int wb, int dp_smem) {
  Layout L;
  size_t o = 0;
  L.ws = o;    o += up16((size_t)Vc * (J + KPAD) * wb);         // W columns [Vc][J + KPAD]
  L.dps = o;   o += dp_smem ? up16((size_t)Jc * (d + KPAD) * wb) : 0;  // dec_proj [Jc][d + KPAD]
  L.x = o;     o += up16((size_t)TS * (J > d ? J : d) * 4);     // refresh input, then joiner input
  L.r2 = o;    o += up16(max_sz((size_t)TS * Vc * 4,            // logits, or the dec_proj ring
                                dp_smem ? 0 : (size_t)2 * RING_ROWS * Jc * wb + 128));
  L.aloc = o;  o += up16((size_t)TS * Jc * 4);                  // this block's columns of a
  L.dout = o;  o += up16((size_t)TS * Jc * 4);                  // this block's columns of dout
  L.es = o;    o += up16((size_t)2 * TS * Jc * 4);              // eout columns, 2 pulls
  L.words = o; o += up16((size_t)TS * T * 4);                   // token windows [TS][T]
  L.part = o;  o += up16((size_t)C * TS * sizeof(Partial));     // partial argmaxes [C][TS]
  L.blank = o; o += up16((size_t)TS * 4);                       // blank logits [TS]
  L.can = o;   o += up16((size_t)2 * TS * 4);                   // pull masks, 2 pulls
  L.st = o;    o += up16((size_t)TS * sizeof(SessState));       // decode state [TS]
  L.lists = o; o += up16((size_t)2 * TS * 4);                   // active and refresh lists
  L.tmask = o; o += up16((size_t)V * 4);                        // token masks [V]
  L.total = o;
  return L;
}

struct alignas(64) ClusterArgs {
  CUtensorMap dp_map;  // dec_proj as a [d][J] tensor, boxes of RING_ROWS x Jc (streamed)
  const float* eouts;
  const int* can;
  const int* ctx_in;
  const float* dout_in;
  const int* nd_in;
  const int* words_in;
  const int* head_in;
  const int* lastcall_in;
  const int* time_in;
  const int* lastemit_in;
  const int* sil_in;
  const float* dec_table;
  const void* dp;
  const float* dpb;
  const void* W;
  const float* jb;
  const int* tmask;
  int* ctx_out;
  float* dout_out;
  int* words_out;
  int* nd_out;
  int* head_out;
  int* lastcall_out;
  int* time_out;
  int* lastemit_out;
  int* sil_out;
  int* ev_ops;
  int* ev_tok;
  float* ev_lp;
  int* ev_flags;
  int* ev_time;
  int* ev_fink;
  unsigned long long* stamps;  // null, or [blocks][3 + 27 P] global-timer ns
  DecCfg c;
  int C, TS, Vc, Jc;
};

// Pull p's eout columns [j0, j0 + jn) of the tile's ns sessions into Es[buf]
// and its mask into Can[buf], by cp.async.
__device__ void issue_pull(const ClusterArgs& a, int p, int buf, float* Es, int* Can, int s0,
                           int ns, int j0, int jn) {
  const int S = a.c.S, J = a.c.J, TS = a.TS, Jc = a.Jc, q4 = jn / 4;
  for (int i = threadIdx.x; i < ns * q4; i += blockDim.x) {
    const int s = i / q4, q = i - s * q4;
    cp_async(Es + ((size_t)buf * TS + s) * Jc + 4 * q,
                            a.eouts + ((size_t)p * S + s0 + s) * J + j0 + 4 * q, 16);
  }
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    cp_async(Can + buf * TS + i, a.can + (size_t)p * S + s0 + i, 4);
}

// The tile's active sessions (valid, not done) and those whose decoder
// output must be refreshed (nd), in session order, by warp 0.
__device__ void make_lists(const SessState* st, int TS, int* act, int* ref, int* n_act,
                           int* n_ref) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1;
  int na = 0, nr = 0;
  for (int b = 0; b < TS; b += 32) {
    const int i = b + lane;
    const bool ia = i < TS && st[i].valid && !st[i].done;
    const bool ir = i < TS && st[i].nd;
    const unsigned ma = __ballot_sync(0xffffffffu, ia), mr = __ballot_sync(0xffffffffu, ir);
    if (ia) act[na + __popc(ma & below)] = i;
    if (ir) ref[nr + __popc(mr & below)] = i;
    na += __popc(ma);
    nr += __popc(mr);
  }
  if (lane == 0) {
    *n_act = na;
    *n_ref = nr;
  }
}

template <typename WT, bool DP_SMEM>
__global__ void __launch_bounds__(CNT, 1)
    chunk_decode_cluster_kernel(const __grid_constant__ ClusterArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_act, n_ref;
  __shared__ uint64_t bars[8];  // the streamed ring's stage mbarriers
  unsigned ph = 0;              // their phase parities
  cg::cluster_group cl = cg::this_cluster();
  const DecCfg& c = a.c;
  const int C = a.C, TS = a.TS, Vc = a.Vc, Jc = a.Jc;
  const int J = c.J, d = c.d, V = c.V, T = c.T, S = c.S;
  const int rank = (int)cl.block_rank();
  const int s0 = (blockIdx.x / C) * TS;
  const int ns = max(0, min(TS, S - s0));
  const int v0 = rank * Vc, vn = max(0, min(Vc, V - v0));
  const int j0 = rank * Jc, jn = max(0, min(Jc, J - j0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nst = 3 + 27 * c.P;
  const Layout L = cluster_layout(TS, J, d, V, Vc, Jc, T, C, (int)sizeof(WT), DP_SMEM);
  WT* Ws = reinterpret_cast<WT*>(smem + L.ws);
  WT* Dps = reinterpret_cast<WT*>(smem + L.dps);
  float* X = reinterpret_cast<float*>(smem + L.x);      // [slot][d] phase A, [slot][J] phase B
  float* Lg = reinterpret_cast<float*>(smem + L.r2);    // [active slot][Vc], phase B
  float* aloc = reinterpret_cast<float*>(smem + L.aloc);  // [TS][Jc], read by every block
  float* Dout = reinterpret_cast<float*>(smem + L.dout);
  float* Es = reinterpret_cast<float*>(smem + L.es);
  int* words = reinterpret_cast<int*>(smem + L.words);
  Partial* part = reinterpret_cast<Partial*>(smem + L.part);  // written by every block
  float* blankv = reinterpret_cast<float*>(smem + L.blank);   // written by the blank's block
  int* Can = reinterpret_cast<int*>(smem + L.can);
  SessState* st = reinterpret_cast<SessState*>(smem + L.st);
  int* act = reinterpret_cast<int*>(smem + L.lists);
  int* ref = act + TS;
  int* tmask = reinterpret_cast<int*>(smem + L.tmask);
  const bool has_blank = c.blank >= v0 && c.blank < v0 + vn;

  stamp(a.stamps, nst, 0);
  if (!DP_SMEM && tid == 0) {
    for (int i = 0; i < 8; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_columns<WT>(Ws, Vc, J, static_cast<const WT*>(a.W), V, v0, vn);
  if constexpr (DP_SMEM) load_columns<WT>(Dps, Jc, d, static_cast<const WT*>(a.dp), J, j0, jn);
  issue_pull(a, 0, 0, Es, Can, s0, ns, j0, jn);
  for (int i = tid; i < V; i += CNT) cp_async(tmask + i, a.tmask + i, 4);
  cp_commit();
  for (int i = tid; i < TS; i += CNT) {
    const int s = s0 + i;
    SessState& q = st[i];
    q.valid = i < ns;
    if (q.valid) {
      q.ctx0 = a.ctx_in[2 * s];
      q.ctx1 = a.ctx_in[2 * s + 1];
      q.nd = a.nd_in[s];
      q.head = a.head_in[s];
      q.last_call = a.lastcall_in[s];
      q.time = a.time_in[s];
      q.last_emit = a.lastemit_in[s];
      q.sil = a.sil_in[s];
    } else {
      q.ctx0 = q.ctx1 = c.blank;
      q.nd = q.head = q.last_call = q.time = q.last_emit = 0;
      q.sil = 1;
    }
  }
  for (int i = tid; i < TS * Jc; i += CNT) {
    const int si = i / Jc, j = i - si * Jc;
    Dout[i] = si < ns && j < jn ? a.dout_in[(size_t)(s0 + si) * J + j0 + j] : 0.f;
  }
  for (int i = tid; i < TS * T; i += CNT) {
    const int si = i / T;
    words[i] = si < ns ? a.words_in[(size_t)(s0 + si) * T + (i - si * T)] : 0;
  }
  cp_wait<0>();
  cl.sync();  // every block of the cluster runs, with its slices, before any peer access
  stamp(a.stamps, nst, 1);

  for (int p = 0; p < c.P; ++p) {
    const int buf = p & 1;
    cp_wait<0>();
    __syncthreads();
    if (p + 1 < c.P) issue_pull(a, p + 1, buf ^ 1, Es, Can, s0, ns, j0, jn);
    cp_commit();
    for (int i = tid; i < TS; i += CNT) {
      SessState& q = st[i];
      const int cn = q.valid ? (Can[buf * TS + i] != 0) : 0;
      q.time += c.stride * cn;
      q.done = !cn;
    }
    __syncthreads();
    make_lists(st, TS, act, ref, &n_act, &n_ref);
    __syncthreads();
    for (int r = 0; r < 3; ++r) {
      const int k0 = 2 + 9 * (3 * p + r);
      const int nA = n_act, nR = n_ref;
      // A. refresh this block's dout columns, then its columns of a
      if (nR > 0 && jn > 0) {
        const int d4 = d / 4;
        for (int i = tid; i < nR * d4; i += CNT) {
          const int sl = i / d4, k = 4 * (i - sl * d4);
          const SessState& q = st[ref[sl]];
          const float4 t0 =
              __ldg(reinterpret_cast<const float4*>(a.dec_table + (size_t)q.ctx0 * d + k));
          const float4 t1 =
              __ldg(reinterpret_cast<const float4*>(a.dec_table + ((size_t)V + q.ctx1) * d + k));
          float4 h;
          h.x = Wt<WT>::act(fmaxf(__fadd_rn(t0.x, t1.x), 0.f));
          h.y = Wt<WT>::act(fmaxf(__fadd_rn(t0.y, t1.y), 0.f));
          h.z = Wt<WT>::act(fmaxf(__fadd_rn(t0.z, t1.z), 0.f));
          h.w = Wt<WT>::act(fmaxf(__fadd_rn(t0.w, t1.w), 0.f));
          *reinterpret_cast<float4*>(X + (size_t)sl * d + k) = h;
        }
      }
      stamp(a.stamps, nst, k0);
      if (nR > 0 && jn > 0) {
        __syncthreads();
        const float* dpb = a.dpb + j0;
        const auto row = [&](int b) { return X + (size_t)b * d; };
        const auto out = [&](int b, int j, float acc) {
          Dout[(size_t)ref[b] * Jc + j] = __fadd_rn(acc, dpb[j]);
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
            refresh_streamed<1, WT>(nR, Jc, d, &a.dp_map, j0, ring, slots, bars, ph, row, out);
          else
            refresh_streamed<GS, WT>(nR, Jc, d, &a.dp_map, j0, ring, slots, bars, ph, row, out);
        }
        __syncthreads();
      }
      stamp(a.stamps, nst, k0 + 1);
      if (nA > 0 && jn > 0) {
        const int q4 = jn / 4;
        for (int i = tid; i < nA * q4; i += CNT) {
          const int s = act[i / q4], j = 4 * (i - i / q4 * q4);
          const float4 e = *reinterpret_cast<const float4*>(Es + ((size_t)buf * TS + s) * Jc + j);
          const float4 o = *reinterpret_cast<const float4*>(Dout + (size_t)s * Jc + j);
          float4 y;
          y.x = Wt<WT>::act(tanhf(__fadd_rn(e.x, o.x)));
          y.y = Wt<WT>::act(tanhf(__fadd_rn(e.y, o.y)));
          y.z = Wt<WT>::act(tanhf(__fadd_rn(e.z, o.z)));
          y.w = Wt<WT>::act(tanhf(__fadd_rn(e.w, o.w)));
          *reinterpret_cast<float4*>(aloc + (size_t)s * Jc + j) = y;
        }
      }
      stamp(a.stamps, nst, k0 + 2);
      cl.sync();
      stamp(a.stamps, nst, k0 + 3);
      // B. every block's columns of a, then the joiner's logits of this
      // block's columns and their argmax
      if (nA > 0) gather_a(cl, aloc, X, nA, J, Jc, [&](int sl) { return act[sl]; });
      stamp(a.stamps, nst, k0 + 4);
      if (nA > 0) {
        __syncthreads();
        if (vn > 0) {
          const float* jb = a.jb + v0;
          rows_by_cols_spread(
              nA, Vc, vn, J, [&](int b) { return X + (size_t)b * J; }, Ws,
              [&](int b, int v, float acc) { Lg[(size_t)b * Vc + v] = __fadd_rn(acc, jb[v]); });
        }
      }
      stamp(a.stamps, nst, k0 + 5);
      if (nA > 0) {
        __syncthreads();
        for (int sl = warp; sl < nA; sl += CNT / 32) {
          float best = -INFINITY;
          int bi = 0x7fffffff;
          for (int v = lane; v < vn; v += 32) {
            const float lv = v0 + v == c.blank ? NEG_INF_F : Lg[(size_t)sl * Vc + v];
            if (lv > best) { best = lv; bi = v0 + v; }
          }
          for (int o = 16; o > 0; o >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
          }
          if (lane < C) {  // lane r2 stores into block r2
            const int s = act[sl];
            cl.map_shared_rank(part, lane)[rank * TS + s] = Partial{best, bi};
            if (has_blank) cl.map_shared_rank(blankv, lane)[s] = Lg[(size_t)sl * Vc + c.blank - v0];
          }
        }
      }
      stamp(a.stamps, nst, k0 + 6);
      cl.sync();
      stamp(a.stamps, nst, k0 + 7);
      // C. merge the partials, then every heuristic, in every block: session
      // i on warp i % 16, lane i / 16, so that few sessions share a warp
      for (int i = warp + (CNT / 32) * lane; i < TS; i += CNT) {
        SessState q = st[i];  // in registers: the words stores cannot alias it
        int e_ops = 0, e_tok = 0, e_flags = 0, e_time = 0, e_fink = 0;
        float e_lp = 0.f;
        if (q.done) {
          q.nd = 0;  // inactive: no emission, no context change
        } else {
          float best = -INFINITY;
          int bi = 0x7fffffff;
          for (int r2 = 0; r2 < C; ++r2) {
            const Partial pv = part[r2 * TS + i];
            if (pv.v > best || (pv.v == best && pv.i < bi)) { best = pv.v; bi = pv.i; }
          }
          q.mi = bi;
          q.mv = best;
          q.bv = blankv[i];
          heuristics(q, words + i * T, tmask, c, r, e_ops, e_tok, e_lp, e_flags, e_time, e_fink);
        }
        if (rank == 0 && q.valid) {
          const size_t e = ((size_t)p * S + s0 + i) * 3 + r;
          a.ev_ops[e] = e_ops; a.ev_tok[e] = e_tok; a.ev_lp[e] = e_lp;
          a.ev_flags[e] = e_flags; a.ev_time[e] = e_time; a.ev_fink[e] = e_fink;
        }
        st[i] = q;
      }
      __syncthreads();
      make_lists(st, TS, act, ref, &n_act, &n_ref);
      __syncthreads();
      stamp(a.stamps, nst, k0 + 8);
    }
  }

  if (rank == 0) {
    for (int i = tid; i < ns; i += CNT) {
      const int s = s0 + i;
      const SessState& q = st[i];
      a.ctx_out[2 * s] = q.ctx0;
      a.ctx_out[2 * s + 1] = q.ctx1;
      a.nd_out[s] = q.nd;
      a.head_out[s] = q.head;
      a.lastcall_out[s] = q.last_call;
      a.time_out[s] = q.time;
      a.lastemit_out[s] = q.last_emit;
      a.sil_out[s] = q.sil;
    }
    for (int i = tid; i < ns * T; i += CNT) a.words_out[(size_t)s0 * T + i] = words[i];
  }
  for (int i = tid; i < ns * jn; i += CNT) {
    const int si = i / jn, j = i - si * jn;
    a.dout_out[(size_t)(s0 + si) * J + j0 + j] = Dout[(size_t)si * Jc + j];
  }
  stamp(a.stamps, nst, nst - 1);
}

template <typename WT, bool DP>
static const void* kernel_of() {
  return reinterpret_cast<const void*>(chunk_decode_cluster_kernel<WT, DP>);
}

static const void* pick(int w_f32, int dp_smem) {
  if (w_f32) return dp_smem ? kernel_of<float, true>() : kernel_of<float, false>();
  return dp_smem ? kernel_of<uint16_t, true>() : kernel_of<uint16_t, false>();
}

// How many clusters of C blocks with `smem` bytes each this device runs at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int chunk_decode_cluster_fit(int C, int smem, int w_f32, int dp_smem, void* stream) {
  const void* kern = pick(w_f32, dp_smem);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, C, smem, (cudaStream_t)stream, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// w_f32 selects the type of dec_proj and W (1: f32, 0: bf16); C, TS, Vc, Jc,
// dp_smem and smem are the plan's. Returns minus the bytes of this kernel's
// layout where they differ from `smem` (nothing launched), 1
// (cudaErrorInvalidValue) for widths it does not take (J and d multiples of
// 16), else the launch's
// error. A streamed dec_proj needs J = C Jc, 16-byte multiples of Jc and at
// most 256 of them (a tensor-map box).
extern "C" int chunk_decode_cluster(
    const float* eouts, const int* can, const int* ctx_in, const float* dout_in, const int* nd_in,
    const int* words_in, const int* head_in, const int* lastcall_in, const int* time_in,
    const int* lastemit_in, const int* sil_in, const float* dec_table, const void* dp,
    const float* dpb, const void* W, const float* jb, const int* tmask, int* ctx_out,
    float* dout_out, int* words_out, int* nd_out, int* head_out, int* lastcall_out,
    int* time_out, int* lastemit_out, int* sil_out, int* ev_ops, int* ev_tok, float* ev_lp,
    int* ev_flags, int* ev_time, int* ev_fink, unsigned long long* stamps, int P, int S, int J,
    int d, int V, int T, int blank, int stride, int w_f32, int C, int TS, int Vc, int Jc,
    int dp_smem, int smem, float ramp0, float ramp1, float ramp2, float punct_margin,
    float conf_margin, float conf_penalty, float long_sil_ms, float decay_ms, void* stream) {
  const Layout L = cluster_layout(TS, J, d, V, Vc, Jc, T, C, w_f32 ? 4 : 2, dp_smem);
  if (L.total != (size_t)smem) return -(int)L.total;
  const int wb = w_f32 ? 4 : 2;
  if (J % 16 || d % 16 || Jc % 4 || Vc % 8 || C < 1 || TS < 1 || C * Jc < J || C * Vc < V ||
      (!dp_smem && (d % RING_ROWS || (TS + GS - 1) / GS * Jc > CNT || C * Jc != J ||
                    Jc * wb % 16 || Jc > 256 || reinterpret_cast<uintptr_t>(dp) % 16)))
    return (int)cudaErrorInvalidValue;
  ClusterArgs a;
  a.eouts = eouts; a.can = can; a.ctx_in = ctx_in; a.dout_in = dout_in; a.nd_in = nd_in;
  a.words_in = words_in; a.head_in = head_in; a.lastcall_in = lastcall_in; a.time_in = time_in;
  a.lastemit_in = lastemit_in; a.sil_in = sil_in; a.dec_table = dec_table; a.dp = dp;
  a.dpb = dpb; a.W = W; a.jb = jb; a.tmask = tmask; a.ctx_out = ctx_out; a.dout_out = dout_out;
  a.words_out = words_out; a.nd_out = nd_out; a.head_out = head_out;
  a.lastcall_out = lastcall_out; a.time_out = time_out; a.lastemit_out = lastemit_out;
  a.sil_out = sil_out; a.ev_ops = ev_ops; a.ev_tok = ev_tok; a.ev_lp = ev_lp;
  a.ev_flags = ev_flags; a.ev_time = ev_time; a.ev_fink = ev_fink; a.stamps = stamps;
  DecCfg& c = a.c;
  c.P = P; c.S = S; c.J = J; c.d = d; c.V = V; c.T = T; c.blank = blank; c.stride = stride;
  c.ramp[0] = ramp0; c.ramp[1] = ramp1; c.ramp[2] = ramp2;
  c.punct_margin = punct_margin; c.conf_margin = conf_margin; c.conf_penalty = conf_penalty;
  c.long_sil_ms = long_sil_ms; c.decay_ms = decay_ms;
  a.C = C; a.TS = TS; a.Vc = Vc; a.Jc = Jc;
  if (!dp_smem) {
    const int err = dp_tensor_map(&a.dp_map, dp, J, d, Jc, w_f32);
    if (err) return err;
  }
  const void* kern = pick(w_f32, dp_smem);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config((S + TS - 1) / TS * C, C, smem, (cudaStream_t)stream, attr);
  void* params[] = {&a};
  err = cudaLaunchKernelExC(&cfg, kern, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
