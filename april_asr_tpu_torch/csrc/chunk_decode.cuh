// Kernel 4's shared pieces: the decode state of one session, the event
// codes, and `heuristics`, every rule of decode_step_pre (decode/greedy.py)
// for one session and one round. Included by csrc/chunk_decode.cu (the
// CUDA-core kernel, `chunk_decode_simt`) and csrc/chunk_decode_cluster.cu
// (the thread-block-cluster kernel), so both decide alike.
#pragma once

#include "common.cuh"

#define NEG_INF_F (-1e30f)

#define OP_FIX_PREV_EOS 1
#define OP_FINAL 2
#define OP_RESET_TOKENS 4
#define OP_APPEND 8
#define OP_PARTIAL 16
#define OP_POP 32
#define OP_SILENCE 64
#define FLAG_WB 1
#define FLAG_EOS 2
#define MASK_WB 1
#define MASK_EOS 2
#define MASK_PUNCT 4
#define MASK_DIGIT 8
#define MASK_DOT 16
#define FLAG_SHIFT 16

struct DecCfg {
  int P, S, J, d, V, T, blank, stride;
  float ramp[3];
  float punct_margin, conf_margin, conf_penalty, long_sil_ms, decay_ms;
};

struct SessState {
  int ctx0, ctx1, nd, head, last_call, time, last_emit, sil, done, mi, valid;
  float mv, bv;
};

__device__ __forceinline__ int tmask_at(const int* tmask, int v, int V) {
  return (v >= 0 && v < V) ? tmask[v] : 0;
}

// decode_step_pre for one session and one round; words is its T-slot window.
__device__ void heuristics(SessState& st, int* words, const int* tmask, const DecCfg& c, int r,
                           int& e_ops, int& e_tok, float& e_lp, int& e_flags, int& e_time,
                           int& e_fink) {
  const int T = c.T;
  const bool active = !st.done;
  const int mi = st.mi;
  const float mv = st.mv, bv = st.bv;
  const bool was_cleared = st.ctx1 == c.blank;
  const bool eq_prev = st.ctx1 == mi;
  const float eff = eq_prev ? 0.f : c.ramp[r];
  bool is_blank = __fsub_rn(bv, eff) > mv;

  const int mask_max = tmask_at(tmask, mi, c.V);
  const bool wb = (mask_max & MASK_WB) != 0;
  bool eos = (mask_max & MASK_EOS) != 0;
  bool punct = (mask_max & MASK_PUNCT) != 0;

  int head = st.head;
  const int hp = max(head - 1, 0);
  const int prev_word = words[hp];
  const int prev_tok = prev_word & ((1 << FLAG_SHIFT) - 1);
  const int prev_flags = prev_word >> FLAG_SHIFT;
  const int mask_prev = tmask_at(tmask, prev_tok, c.V);
  const bool digit_exc = punct && head > 0 && (mask_prev & MASK_DIGIT) && (mask_max & MASK_DOT);
  eos = eos && !digit_exc;
  punct = punct && !digit_exc;
  const int tok_flags = (wb ? FLAG_WB : 0) | (eos ? FLAG_EOS : 0);

  const bool boost = !was_cleared && punct && !eq_prev && (mv > __fsub_rn(bv, c.punct_margin));
  is_blank = is_blank && !boost;
  const bool nb = active && !is_blank;
  const bool bl = active && is_blank;

  int ops = 0, tok = 0, flags = 0, fink = 0;
  float lp = 0.f;

  // ---- non-blank path
  if (nb) {
    st.last_emit = st.time;
    st.ctx0 = st.ctx1;
    st.ctx1 = mi;
  }
  bool need_dec = nb;
  bool is_final = nb && head >= T - 1;
  const bool check = nb && head > 0 && wb;
  const bool prev_is_eos = (mask_prev & MASK_EOS) != 0;
  const bool fix_prev = check && prev_is_eos && (prev_flags & FLAG_EOS) == 0;
  if (fix_prev) {
    words[hp] |= (FLAG_EOS << FLAG_SHIFT);
    ops |= OP_FIX_PREV_EOS;
  }
  is_final = is_final || (check && prev_is_eos);

  int sow = -1;  // last word start in (2, head - 1]
  for (int i = 3; i <= head - 1 && i < T; ++i)
    if ((words[i] >> FLAG_SHIFT) & FLAG_WB) sow = i;
  const bool full_fin = is_final && head > 0 && (wb || sow < 0);
  const bool shift_fin = is_final && head > 0 && !wb && sow >= 0;
  if (full_fin) {
    ops |= OP_FINAL;
    fink = head;
    st.last_call = head;
    head = 0;
  }
  if (shift_fin) {
    ops |= OP_FINAL;
    fink = sow;
    for (int i = 0; i < head - sow; ++i) words[i] = words[i + sow];
    head -= sow;
  }
  const bool no_room = nb && head >= T - 1;
  if (no_room) {
    ops |= OP_RESET_TOKENS;
    head = 0;
  }
  const int new_word = mi | (tok_flags << FLAG_SHIFT);
  if (nb) {
    words[min(max(head, 0), T - 1)] = new_word;
    head += 1;
    ops |= OP_APPEND | OP_PARTIAL;
    tok = mi;
    lp = mv;
    flags = tok_flags;
    st.last_call = head;
    st.sil = 0;
  }
  const int time_ev = active ? st.time : 0;

  // ---- blank path
  const float t_since = (float)(st.time - st.last_emit);
  const float decayed = __fsub_rn(mv, __fdiv_rn(t_since, c.decay_ms));
  const bool confident = !eq_prev && (decayed > __fsub_rn(bv, c.conf_margin));
  const bool long_sil = t_since >= c.long_sil_ms;
  const bool ls = bl && long_sil;
  if (ls && head > 0) {
    ops |= OP_FINAL;
    fink = head;
    st.last_call = head;
    head = 0;
  }
  if (ls && st.ctx0 != c.blank) {
    st.ctx0 = st.ctx1 = c.blank;
    need_dec = true;
  }
  if (ls && st.sil == 0) ops |= OP_SILENCE;
  if (ls) st.sil = 1;

  const bool conf = bl && !long_sil && confident;
  const int hc = min(max(head, 0), T - 1);
  const int stale = words[hc] & ((1 << FLAG_SHIFT) - 1);
  const bool dedup = (st.last_call == head + 1) && (stale == mi);
  const bool conf_emit = conf && !dedup;
  if (conf_emit) {
    words[hc] = new_word;
    ops |= OP_APPEND | OP_PARTIAL | OP_POP;
    tok = mi;
    lp = __fsub_rn(mv, c.conf_penalty);
    flags = tok_flags;
    st.last_call = head + 1;
  }
  const bool bare = bl && !long_sil && !confident && (st.last_call != head);
  if (bare) {
    ops |= OP_PARTIAL;
    st.last_call = head;
  }

  st.head = head;
  st.nd = need_dec ? 1 : 0;
  st.done = st.done || is_blank;
  e_ops = ops; e_tok = tok; e_lp = lp; e_flags = flags; e_time = time_ev; e_fink = fink;
}
