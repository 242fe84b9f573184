"""Carry JAX-package weights into the port.

`from_jax_params` turns a dict of numpy arrays (the JAX params pytree,
each leaf passed through `np.asarray`) into torch tensors on `device`,
keeping the JAX key names (`w_ih_t_q8`, `w_ih_t_q8s`, `bias`, `ff1_t_q8`,
`norm_eps`, `dec_table`, `dec_proj_t`, `join_t`, `join_b`, ...) and layouts.

bfloat16 leaves: `np.asarray` of a JAX bf16 array has the ml_dtypes
`bfloat16` dtype, which `torch.from_numpy` refuses. Such arrays are read
through a `uint16` view of the same bits and reinterpreted as
`torch.bfloat16` (this module imports no ml_dtypes; it recognizes the dtype
by name). A caller may also hand in that `uint16` view directly: the JAX
params tree has no uint16 leaves, so uint16 always means bf16 bits here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_torch(arr, device="cpu") -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        return torch.from_numpy(np.array(a)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    return {k: to_torch(v, device) for k, v in params.items()}
