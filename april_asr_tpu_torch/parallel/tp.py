"""Tensor-parallel weight layout for the TP engine path (port of
april_asr_tpu/parallel/tp.py, the LSTM family).

The TP path runs one process per model shard (parallel/mesh.py); each
process holds a contiguous slice of every sharded weight and runs the TP
kernels (ops/lstm_tp_kernels.py) on it, with the per-layer partial sums
all-reduced over the model group. That requires each shard's contiguous
slice to be a self-contained smaller LSTMP layer, which the stock
[.., 4H] gate-concatenated layout does not give (a contiguous 4H/m slice of
[i|f|g|o] spans partial gates).

`shuffle_gate_columns` permutes the 4H gate axis into per-shard blocks —
shard k's contiguous slice holds [i_k | f_k | g_k | o_k] for its H/m hidden
units — so a contiguous slice of the last axis hands every shard a standard
smaller layer, and the cell state c shards as the contiguous
[.., k*H/m:(k+1)*H/m] slice with NO permutation (the shuffle maps shard k
exactly onto that hidden-unit range).

The Conformer family's TP layout (the JAX module's `conformer_tp_specs`,
`glu_shuffle_*`, `prepare_conformer_tp_weights`) comes with the Conformer
slice of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# Weight keys carrying a gate-concatenated 4H last axis.
_GATE_KEYS = ("w_ih_t", "w_hh_t", "bias", "w_ih_t_q8", "w_ih_t_q8s",
              "w_hh_t_q8", "w_hh_t_q8s")

# The axis of each weight that shards over the model axis (the JAX table's
# PartitionSpecs: P(None, None, "model") is axis 2, P(None, "model") and
# P(None, "model", None) axis 1). ONLY the encoder LSTM stack is tensor-
# parallel; the conv embed, decoder and joiner are tiny and stay replicated
# (they run identically on every model shard, so event outputs agree), as do
# the int8 column scales of the row-sharded w_hr and ff2.
_TP_SPECS: Dict[str, Optional[int]] = {
    "w_ih_t": 2,
    "w_hh_t": 2,
    "bias": 1,
    "w_hr_t": 1,
    "ff1_t": 2,
    "ff1_b": 1,
    "ff2_t": 1,
    "ff2_b": None,
    "w_ih_t_q8": 2,
    "w_ih_t_q8s": 2,
    "w_hh_t_q8": 2,
    "w_hh_t_q8s": 2,
    "w_hr_t_q8": 1,
    "w_hr_t_q8s": None,
    "ff1_t_q8": 2,
    "ff1_t_q8s": 2,
    "ff2_t_q8": 1,
    "ff2_t_q8s": None,
}


def gate_shuffle_perm(H: int, m: int) -> np.ndarray:
    """Permutation of the 4H gate axis: output position
    k*4*(H/m) + g*(H/m) + j  <-  g*H + k*(H/m) + j  (shard k, gate g)."""
    if H % m:
        raise ValueError(f"hidden {H} not divisible by model_parallel {m}")
    Hs = H // m
    perm = np.empty(4 * H, np.int64)
    pos = 0
    for k in range(m):
        for g in range(4):
            perm[pos : pos + Hs] = g * H + k * Hs + np.arange(Hs)
            pos += Hs
    return perm


def shuffle_gate_columns(params: Dict[str, torch.Tensor], m: int) -> Dict[str, torch.Tensor]:
    """Gate-shuffle every 4H-axis weight for an m-way model axis (no-op for
    m == 1). Idempotence is NOT a property — apply exactly once, to the
    stock layout."""
    if m == 1:
        return params
    out = dict(params)
    for k in _GATE_KEYS:
        if k not in params:
            continue
        w = params[k]
        perm = torch.from_numpy(gate_shuffle_perm(w.shape[-1] // 4, m)).to(w.device)
        out[k] = torch.index_select(w, w.ndim - 1, perm)
    return out


def tp_param_specs(params: Dict) -> Dict[str, Optional[int]]:
    """The sharded axis of each param on the TP path (gate-shuffled layout),
    None where it is replicated: anything not in the TP table is."""
    return {k: _TP_SPECS.get(k) for k in params}


def tp_shard_map_eligible(params: Dict, dims) -> bool:
    """Whether the explicit TP path can serve these weights: native
    LSTM-family params with the full layer stack present."""
    return all(
        k in params
        for k in ("w_ih_t", "w_hh_t", "bias", "w_hr_t", "ff1_t", "ff2_t", "norm_eps")
    )


def prepare_tp_weights(params: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Gate-shuffle, then keep this rank's contiguous slice of every sharded
    weight (`tp_param_specs`) and the whole of every replicated one."""
    m, k = mesh.model_parallel, mesh.rank
    shuffled = shuffle_gate_columns(params, m)
    out = {}
    for name, axis in tp_param_specs(shuffled).items():
        w = shuffled[name]
        if axis is not None:
            n = w.shape[axis] // m
            w = w.narrow(axis, k * n, n).contiguous()
        out[name] = w
    return out
