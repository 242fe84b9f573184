"""Per-speaker session state snapshots on the batched engine (port of
april_asr_tpu/engine/speaker.py).

The reference reserves this (april_api.h:78-84, `AprilSpeakerID`:
"Currently not implemented"); the JAX package implements it, and so does
the port. A session's carried state is four rows (the LSTM's h and c, the
decoder's context and output), so a snapshot is a device-to-host copy kept
under (model name, speaker key) and a restore is a row write into the
engine's state. The file name, its directory (`APRIL_SPEAKER_CACHE`, shared
with the JAX package) and its npz keys (`h`, `c`, `dout` f32, `context`
int32) are the JAX package's, so a snapshot written by either package
restores in the other.

On a tensor-parallel engine each rank holds its contiguous [L, S, H/m]
slice of c (parallel/mesh.py `shard_state`; the gate shuffle maps shard k
onto hidden units [k H/m, (k + 1) H/m), parallel/tp.py), so the whole c is
the ranks' slices in rank order, which is what JAX's `canonical_state` and
`rows_from_canonical` give an LSTM. A save gathers it over the process group
(a collective: every rank saves together); a restore takes this rank's
slice.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch

log = logging.getLogger(__name__)


def speaker_dir() -> str:
    return os.environ.get(
        "APRIL_SPEAKER_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "april_asr_tpu", "speakers"),
    )


def speaker_path(model_name: str, speaker_key: str) -> str:
    h = hashlib.sha256((model_name + "\0" + speaker_key).encode()).hexdigest()[:32]
    return os.path.join(speaker_dir(), f"{h}.npz")


def _whole_c(engine) -> torch.Tensor:
    """The engine's cell state [L, S, H]: on a TP engine the ranks' slices
    gathered in rank order (a collective)."""
    c = engine.state["c"]
    mesh = engine.prog.mesh if engine.prog.tp_axes else None
    if mesh is None:
        return c
    import torch.distributed as dist

    parts = [torch.empty_like(c) for _ in range(mesh.model_parallel)]
    dist.all_gather(parts, c.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=2)


def save_speaker_state(engine, slot: int, model_name: str, speaker_key: str) -> bool:
    """Snapshot `slot`'s carried state under (model, speaker). Never raises
    (a failed snapshot must not fail a session's close); returns success."""
    try:
        # under _step_lock: a tick on another thread must not move the state
        # between the reads
        with engine._step_lock, torch.no_grad():
            st = engine.state
            rows = {
                "h": st["h"][:, slot],
                "c": _whole_c(engine)[:, slot],
                "context": st["decode"]["context"][slot],
                "dout": st["decode"]["dout"][slot],
            }
            rows = {k: v.cpu().numpy() for k, v in rows.items()}
        rows = {k: v.astype(np.int32 if k == "context" else np.float32) for k, v in rows.items()}
        path = speaker_path(model_name, speaker_key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # every rank of a TP engine writes the same rows: each through its
        # own file, renamed into place
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **rows)
        os.replace(tmp, path)
        return True
    except Exception as e:  # noqa: BLE001 - never fail a close on a snapshot
        log.warning("speaker state save failed: %s", e)
        return False


def restore_speaker_state(engine, slot: int, model_name: str, speaker_key: str) -> bool:
    """Load a prior snapshot into `slot` (nothing where none exists);
    returns whether one was applied."""
    path = speaker_path(model_name, speaker_key)
    if not os.path.exists(path):
        return False
    try:
        with np.load(path) as data:
            rows = {k: torch.from_numpy(np.asarray(data[k])) for k in ("h", "c", "context", "dout")}
        if engine.prog.tp_axes:
            mesh = engine.prog.mesh
            n = rows["c"].shape[1] // mesh.model_parallel
            rows["c"] = rows["c"][:, mesh.rank * n : (mesh.rank + 1) * n]
        # under _step_lock: a tick finishing between the read and the write
        # below would be rewound for every slot
        with engine._step_lock, torch.no_grad():
            st = dict(engine.state)
            st["decode"] = dict(st["decode"])
            for key in ("h", "c"):
                v = st[key].clone()
                v[:, slot] = rows[key].to(v.device, v.dtype)
                st[key] = v
            for key in ("context", "dout"):
                v = st["decode"][key].clone()
                v[slot] = rows[key].to(v.device, v.dtype)
                st["decode"][key] = v
            engine.state = st
        log.info("restored speaker state for %r", speaker_key)
        return True
    except Exception as e:  # noqa: BLE001 - a bad snapshot starts the session fresh
        log.warning("speaker state restore failed: %s", e)
        return False
