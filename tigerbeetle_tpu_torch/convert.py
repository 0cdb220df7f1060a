"""Carry a ledger state between the JAX package and the port.

The JAX package's state, fetched to the host (`jax.device_get`), is a
nested dict of numpy arrays: u64 lanes as uint64, row counts as int32.
The port holds the same bits as int64 and int32 tensors. The two
functions below convert each way without changing a bit, so the two
packages can run the same batches from the same state.
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
