from .mesh import TPMesh, make_mesh, shard_state, state_spec_tree
from .tp import (
    gate_shuffle_perm,
    prepare_tp_weights,
    shuffle_gate_columns,
    tp_param_specs,
    tp_shard_map_eligible,
)

__all__ = [
    "TPMesh",
    "make_mesh",
    "shard_state",
    "state_spec_tree",
    "gate_shuffle_perm",
    "prepare_tp_weights",
    "shuffle_gate_columns",
    "tp_param_specs",
    "tp_shard_map_eligible",
]
