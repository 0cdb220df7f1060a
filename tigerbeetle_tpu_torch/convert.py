"""Carry a ledger state between the JAX package and the port.

The JAX package's state, fetched to the host (`jax.device_get`), is a
nested dict of numpy arrays: u64 lanes as uint64, row counts as int32.
The port holds the same bits as int64 and int32 tensors. The functions
below convert each way without changing a bit, so the two packages can
run the same batches from the same state: `state_*` a single-chip
state, `partitioned_*` a partitioned one (the JAX package's one pytree
stacked on a leading shard axis; the port's tuple of per-shard dicts).
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(np_state: dict, device) -> dict:
    """A host (numpy) ledger state -> the port's tensors on `device`
    (uint64 -> int64 views, int32 kept, bool kept)."""
    out = {}
    for k, v in np_state.items():
        if isinstance(v, dict):
            out[k] = state_from_numpy(v, device)
            continue
        a = np.asarray(v)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        elif a.dtype not in (np.int64, np.int32, np.bool_):
            raise TypeError(f"state_from_numpy: {k} has dtype {a.dtype}")
        out[k] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's state -> host numpy with the JAX package's dtypes
    (int64 -> uint64 views, int32 kept)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = state_to_numpy(v)
            continue
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint64) if a.dtype == np.int64 else a
    return out


def partitioned_from_numpy(np_stacked: dict, mesh) -> tuple:
    """A host (numpy) partitioned state stacked on a leading shard axis
    (the JAX package's layout) -> the port's tuple of per-shard state
    dicts, shard s on `mesh.devices[s]`."""
    def shard(tree, s):
        return {k: shard(v, s) if isinstance(v, dict) else np.asarray(v)[s]
                for k, v in tree.items()}

    return tuple(state_from_numpy(shard(np_stacked, s), d)
                 for s, d in enumerate(mesh.devices))


def partitioned_to_numpy(state) -> dict:
    """The port's partitioned state -> host numpy stacked on a leading
    shard axis, in the JAX package's dtypes."""
    subs = [state_to_numpy(sub) for sub in state]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    return stack(subs)
