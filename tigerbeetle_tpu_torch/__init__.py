"""tigerbeetle_tpu_torch — the PyTorch/CUDA port of tigerbeetle_tpu for
one NVIDIA H100.

The JAX package `tigerbeetle_tpu` stays the reference; this package
computes the same results from the same inputs, bit for bit, and
imports nothing of it (nor of JAX). It holds the create_transfers /
create_accounts main path on a device ledger, through the plain tier and
the limit fixpoint tiers of the escalation ladder, the imported and
balancing tiers (per batch and as windows), the exact path
behind them (the host-mirror regime on the port's copy of the oracle,
`oracle/`, and the sequential create kernels), and commit windows of
many prepares, each one replay of a CUDA graph on the card
(`ops/window_graph.py`), with three hand-written
CUDA kernels: the two-choice hash probe (`csrc/ht_probe.cu`), the row
gather (`csrc/row_gather.cu`) and the sequential kernel
(`csrc/create_seq.cu`). Its serving entry point is `StateMachine`
(`state_machine.py`): wire bodies in, reply bytes out, on the device
ledger with a write-through host mirror (`ops/lazy_mirror.py`), on the
sequential kernel, or on the oracle. In front of a write-through ledger
`ServingSupervisor` (`serving.py`) retries dispatches, verifies epochs
against the oracle and recovers by bounded replay; `admission.py` admits
and sheds client requests into its windows; `trace/` is the tracing
core; `testing/chaos.py` the seeded single-chip chaos harness;
`benchmark.py` the load harness (`main.py benchmark`); `aof.py`,
`metrics.py`, `repl.py`, `cdc.py` and `amqp.py` the operator's side of
the server (`main.py`).
"""

__version__ = "0.1.0"


from .convert import state_from_numpy, state_to_numpy
from .ops.ledger import DeviceLedger
from .serving import ServingSupervisor
from .state_machine import StateMachine

__all__ = ["DeviceLedger", "ServingSupervisor", "StateMachine",
           "state_from_numpy", "state_to_numpy"]
