"""The model-parallel mesh over torch.distributed and the state rule of the
TP engine (port of the tensor-parallel part of april_asr_tpu/parallel/mesh.py).

The JAX package runs tensor parallelism as one `shard_map` program over a
(data, model) device mesh. The port runs it SPMD: one process per model
shard, all in the default process group, each running the whole replicated
step (fbank, embed, decode, replay) and its own shard of the encoder layers.
The JAX collectives map to `torch.distributed` on the model group:

    lax.psum  -> all_reduce(SUM)   (f32 partials, or int32 accumulators)
    lax.pmax  -> all_reduce(MAX)

The backend is the process group's: gloo on the CPU, and gloo for two ranks
on one card (NCCL refuses two ranks on one GPU). The caller initialises the
default group (address, world size and rank: nothing in the environment
tells a program of a cluster) before `make_mesh`.

A data axis (data_parallel > 1) is not served yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from ..config import MeshConfig

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """This process's place on a (data, model) mesh with one data shard:
    `rank` of `model_parallel` shards, meeting over `group`."""

    group: object
    rank: int
    model_parallel: int
    axis_names: tuple = ("data", "model")

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """A reduced copy of `t` over the model group (`op` "sum" or "max"),
        on t's device."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out


def make_mesh(model_parallel: int = 1, *, cfg: MeshConfig = MeshConfig()) -> TPMesh:
    """The mesh over the initialised default process group: its world is
    data x model_parallel ranks, and only data = 1 is served."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    if n // model_parallel > 1:
        raise NotImplementedError(
            f"{n} ranks at model_parallel={model_parallel}: data-parallel serving (a data axis "
            "of the mesh) is not ported yet (ROADMAP queue 1 item 9)")
    return TPMesh(group=dist.group.WORLD, rank=dist.get_rank(), model_parallel=model_parallel,
                  axis_names=(cfg.data_axis, cfg.model_axis))


def state_spec_tree(state: Dict, tp_axes=None) -> Dict:
    """The sharded axis of each engine state leaf, None where replicated.
    Under the TP path (`tp_axes` set) the cell state c [L, S, H] shards its
    hidden axis over the model axis (gate-shuffled layout, parallel/tp.py);
    h and everything else is replicated."""
    return {k: (state_spec_tree(v, tp_axes) if isinstance(v, dict)
                else (2 if k == "c" and tp_axes else None))
            for k, v in state.items()}


def shard_state(state: Dict, mesh: TPMesh, tp_axes) -> Dict:
    """This rank's slice of every sharded state leaf (`state_spec_tree`)."""

    def take(tree, spec):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = take(v, spec[k])
            elif spec[k] is None:
                out[k] = v
            else:
                n = v.shape[spec[k]] // mesh.model_parallel
                out[k] = v.narrow(spec[k], mesh.rank * n, n).contiguous()
        return out

    return take(state, state_spec_tree(state, tp_axes))
