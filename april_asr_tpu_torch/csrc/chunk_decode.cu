// Kernel 4 on the CUDA cores, one block per TSD sessions: the whole chunk's
// greedy transducer decode in one launch. The engine runs it as
// `chunk_decode_simt` only where the thread-block-cluster kernel
// (csrc/chunk_decode_cluster.cu) has no plan (ops/decode_kernels.py
// `decode_plan`: a vocabulary whose joiner slice does not fit a block); the
// two are equal bit for bit (chip_smoke.py). The session state and
// `heuristics` live in csrc/chunk_decode.cuh.
//
// Replaces april_asr_tpu/ops/decode_pallas.py `chunk_decode_fused`
// (`_chunk_decode_kernel`). On the TPU the grid is (session tiles, P pulls)
// with the decode state in VMEM scratch across the sequential pull axis;
// here one block owns TSD sessions and loops over the P pulls and the 3
// rounds of the early-emit ramp itself, with the decode state (context,
// dout, 72-token window, heads, clocks) in shared memory throughout. Per
// round:
//   1. lazy decoder refresh for sessions whose context changed:
//      dout = wd(relu(T0[c0] + T1[c1])) @ dec_proj + b   (threads over d, J)
//   2. joiner for sessions still active: wd(tanh(eout + dout)) @ W + b
//      (threads over the vocab; f32 sums)
//   where wd(.) rounds to the weight type, as the TPU kernel's
//   `y.astype(dp_ref.dtype)` does: bf16 weights see bf16-rounded
//   activations and exact products, f32 weights unrounded activations and
//   true f32 FMAs (the kernel is instantiated for both weight types).
//   3. blank-excluded argmax (one warp per session, first index on ties)
//   4. every heuristic of decode_step_pre (decode/greedy.py), one thread per
//      session: early-emit ramp, repeat guard, punctuation margin, digit-dot
//      exception, forced finalize, 72-token window with word-split finalize,
//      silence decay, confident-blank dedup, long-silence reset.
// Each pull first adds stride_ms to the time of sessions that pull.
//
// Bound on the H100: the joiner and dec_proj reads. Every round re-reads
// W (J x V: 0.5 MB bf16, 1 MB f32) and, for refreshing sessions, dec_proj
// from L2; the multiply-adds are 2 x J x (V + d) per session-round. TSD = 4
// sessions share each weight read. The vocabulary is not padded: the loops
// run to V, which is what the TPU kernel's -1e30 pad columns amount to.
// No fast-math: tanhf as written.

#include "chunk_decode.cuh"

#define TSD 4
#define NT 256

template <typename WT>
__global__ void __launch_bounds__(NT) chunk_decode_kernel(
    const float* __restrict__ eouts, const int* __restrict__ can,
    const int* __restrict__ ctx_in, const float* __restrict__ dout_in,
    const int* __restrict__ nd_in, const int* __restrict__ words_in,
    const int* __restrict__ head_in, const int* __restrict__ lastcall_in,
    const int* __restrict__ time_in, const int* __restrict__ lastemit_in,
    const int* __restrict__ sil_in, const float* __restrict__ dec_table,
    const void* __restrict__ dp_v, const float* __restrict__ dpb,
    const void* __restrict__ W_v, const float* __restrict__ jb,
    const int* __restrict__ tmask, int* __restrict__ ctx_out, float* __restrict__ dout_out,
    int* __restrict__ words_out, int* __restrict__ nd_out, int* __restrict__ head_out,
    int* __restrict__ lastcall_out, int* __restrict__ time_out, int* __restrict__ lastemit_out,
    int* __restrict__ sil_out, int* __restrict__ ev_ops, int* __restrict__ ev_tok,
    float* __restrict__ ev_lp, int* __restrict__ ev_flags, int* __restrict__ ev_time,
    int* __restrict__ ev_fink, DecCfg c) {
  extern __shared__ float4 smem_f4[];
  const WT* __restrict__ dp = static_cast<const WT*>(dp_v);
  const WT* __restrict__ W = static_cast<const WT*>(W_v);
  const int J = c.J, d = c.d, V = c.V, T = c.T, S = c.S;
  const int Dm = J > d ? J : d;
  float* dout = reinterpret_cast<float*>(smem_f4);  // [TSD][J]
  float* tv = dout + TSD * J;                        // [TSD][Dm]
  float* logits = tv + TSD * Dm;                     // [TSD][V]
  int* words = reinterpret_cast<int*>(logits + TSD * V);  // [TSD][T]
  __shared__ SessState st[TSD];

  const int s0 = blockIdx.x * TSD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid < TSD) {
    const int s = s0 + tid;
    SessState& q = st[tid];
    q.valid = s < S;
    if (q.valid) {
      q.ctx0 = ctx_in[2 * s];
      q.ctx1 = ctx_in[2 * s + 1];
      q.nd = nd_in[s];
      q.head = head_in[s];
      q.last_call = lastcall_in[s];
      q.time = time_in[s];
      q.last_emit = lastemit_in[s];
      q.sil = sil_in[s];
    } else {
      q.ctx0 = q.ctx1 = c.blank;
      q.nd = q.head = q.last_call = q.time = q.last_emit = 0;
      q.sil = 1;
    }
  }
  for (int i = tid; i < TSD * J; i += NT) {
    const int si = i / J, s = s0 + si;
    dout[i] = s < S ? dout_in[(size_t)s * J + (i - si * J)] : 0.f;
  }
  for (int i = tid; i < TSD * T; i += NT) {
    const int si = i / T, s = s0 + si;
    words[i] = s < S ? words_in[(size_t)s * T + (i - si * T)] : 0;
  }
  __syncthreads();

  for (int p = 0; p < c.P; ++p) {
    if (tid < TSD) {
      SessState& q = st[tid];
      const int cn = q.valid ? (can[(size_t)p * S + s0 + tid] != 0) : 0;
      q.time += c.stride * cn;
      q.done = !cn;
    }
    __syncthreads();
    for (int r = 0; r < 3; ++r) {
      // 1. lazy decoder refresh
      for (int i = tid; i < TSD * d; i += NT) {
        const int si = i / d, k = i - si * d;
        if (!st[si].nd) continue;
        const float pre = __fadd_rn(dec_table[(size_t)st[si].ctx0 * d + k],
                                    dec_table[((size_t)V + st[si].ctx1) * d + k]);
        tv[si * Dm + k] = Wt<WT>::act(fmaxf(pre, 0.f));
      }
      __syncthreads();
      for (int i = tid; i < TSD * J; i += NT) {
        const int si = i / J, j = i - si * J;
        if (!st[si].nd) continue;
        float acc = 0.f;
        for (int k = 0; k < d; ++k) acc = fmaf(tv[si * Dm + k], Wt<WT>::ld(dp, (size_t)k * J + j), acc);
        dout[i] = __fadd_rn(acc, dpb[j]);
      }
      __syncthreads();
      // 2. joiner for the sessions still active
      for (int i = tid; i < TSD * J; i += NT) {
        const int si = i / J, j = i - si * J;
        if (st[si].done) continue;
        const float e = eouts[((size_t)p * S + s0 + si) * J + j];
        tv[si * Dm + j] = Wt<WT>::act(tanhf(__fadd_rn(e, dout[i])));
      }
      __syncthreads();
      bool any_active = false;
#pragma unroll
      for (int si = 0; si < TSD; ++si) any_active = any_active || !st[si].done;
      if (any_active) {
        for (int v = tid; v < V; v += NT) {
          float acc[TSD];
#pragma unroll
          for (int si = 0; si < TSD; ++si) acc[si] = 0.f;
          for (int j = 0; j < J; ++j) {
            const float w = Wt<WT>::ld(W, (size_t)j * V + v);
#pragma unroll
            for (int si = 0; si < TSD; ++si) acc[si] = fmaf(tv[si * Dm + j], w, acc[si]);
          }
#pragma unroll
          for (int si = 0; si < TSD; ++si) logits[si * V + v] = __fadd_rn(acc[si], jb[v]);
        }
      }
      __syncthreads();
      // 3. blank-excluded argmax, one warp per session
      if (warp < TSD && !st[warp].done) {
        float best = -INFINITY;
        int bi = 0x7fffffff;
        for (int v = lane; v < V; v += 32) {
          const float lv = v == c.blank ? NEG_INF_F : logits[warp * V + v];
          if (lv > best) { best = lv; bi = v; }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
        }
        if (lane == 0) {
          st[warp].mi = bi;
          st[warp].mv = best;
          st[warp].bv = logits[warp * V + c.blank];
        }
      }
      __syncthreads();
      // 4. heuristics, one thread per session
      if (tid < TSD) {
        SessState& q = st[tid];
        int e_ops = 0, e_tok = 0, e_flags = 0, e_time = 0, e_fink = 0;
        float e_lp = 0.f;
        if (q.done) {
          q.nd = 0;  // inactive: no emission, no context change
        } else {
          heuristics(q, words + tid * T, tmask, c, r, e_ops, e_tok, e_lp, e_flags, e_time, e_fink);
        }
        if (q.valid) {
          const size_t e = ((size_t)p * S + s0 + tid) * 3 + r;
          ev_ops[e] = e_ops; ev_tok[e] = e_tok; ev_lp[e] = e_lp;
          ev_flags[e] = e_flags; ev_time[e] = e_time; ev_fink[e] = e_fink;
        }
      }
      __syncthreads();
    }
  }

  if (tid < TSD && st[tid].valid) {
    const int s = s0 + tid;
    const SessState& q = st[tid];
    ctx_out[2 * s] = q.ctx0;
    ctx_out[2 * s + 1] = q.ctx1;
    nd_out[s] = q.nd;
    head_out[s] = q.head;
    lastcall_out[s] = q.last_call;
    time_out[s] = q.time;
    lastemit_out[s] = q.last_emit;
    sil_out[s] = q.sil;
  }
  for (int i = tid; i < TSD * J; i += NT) {
    const int si = i / J, s = s0 + si;
    if (s < S) dout_out[(size_t)s * J + (i - si * J)] = dout[i];
  }
  for (int i = tid; i < TSD * T; i += NT) {
    const int si = i / T, s = s0 + si;
    if (s < S) words_out[(size_t)s * T + (i - si * T)] = words[i];
  }
}

// w_f32 selects the type of dec_proj and W (1: f32, 0: bf16). Returns
// minus the shared memory bytes a block needs when the device allows a block
// fewer (a vocabulary too large for the [TSD][V] logits rows), nothing
// launched; else cudaGetLastError() of the launch.
extern "C" int chunk_decode_simt(
    const float* eouts, const int* can, const int* ctx_in, const float* dout_in, const int* nd_in,
    const int* words_in, const int* head_in, const int* lastcall_in, const int* time_in,
    const int* lastemit_in, const int* sil_in, const float* dec_table, const void* dp,
    const float* dpb, const void* W, const float* jb, const int* tmask, int* ctx_out,
    float* dout_out, int* words_out, int* nd_out, int* head_out, int* lastcall_out,
    int* time_out, int* lastemit_out, int* sil_out, int* ev_ops, int* ev_tok, float* ev_lp,
    int* ev_flags, int* ev_time, int* ev_fink, int P, int S, int J, int d, int V, int T,
    int blank, int stride, int w_f32, float ramp0, float ramp1, float ramp2, float punct_margin,
    float conf_margin, float conf_penalty, float long_sil_ms, float decay_ms, void* stream) {
  DecCfg c;
  c.P = P; c.S = S; c.J = J; c.d = d; c.V = V; c.T = T; c.blank = blank; c.stride = stride;
  c.ramp[0] = ramp0; c.ramp[1] = ramp1; c.ramp[2] = ramp2;
  c.punct_margin = punct_margin; c.conf_margin = conf_margin; c.conf_penalty = conf_penalty;
  c.long_sil_ms = long_sil_ms; c.decay_ms = decay_ms;
  const int Dm = J > d ? J : d;
  const size_t smem = sizeof(float) * (size_t)TSD * (J + Dm + V) + sizeof(int) * (size_t)TSD * T;
  const int fit = smem_fits(smem);
  if (fit) return fit;
  const auto kern = w_f32 ? chunk_decode_kernel<float> : chunk_decode_kernel<uint16_t>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + TSD - 1) / TSD);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
      eouts, can, ctx_in, dout_in, nd_in, words_in, head_in, lastcall_in, time_in, lastemit_in,
      sil_in, dec_table, dp, dpb, W, jb, tmask, ctx_out, dout_out, words_out, nd_out, head_out,
      lastcall_out, time_out, lastemit_out, sil_out, ev_ops, ev_tok, ev_lp, ev_flags, ev_time,
      ev_fink, c);
  return (int)cudaGetLastError();
}
