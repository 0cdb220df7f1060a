"""tigerbeetle_tpu_torch — the PyTorch/CUDA port of tigerbeetle_tpu for
one NVIDIA H100.

The JAX package `tigerbeetle_tpu` stays the reference; this package
computes the same results from the same inputs, bit for bit, and
imports nothing of it (nor of JAX). It holds the create_transfers /
create_accounts main path on a device ledger, through the plain tier and
the limit fixpoint tiers of the escalation ladder, with two hand-written
CUDA kernels: the two-choice hash probe (`csrc/ht_probe.cu`) and the row
gather (`csrc/row_gather.cu`).
"""

from .convert import state_from_numpy, state_to_numpy
from .ops.ledger import DeviceLedger

__all__ = ["DeviceLedger", "state_from_numpy", "state_to_numpy"]
