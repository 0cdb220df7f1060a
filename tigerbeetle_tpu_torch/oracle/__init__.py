"""Sequential, spec-exact oracle of the accounting state machine: the
port's copy of the JAX package's oracle, and the exact semantics its
host-mirror regime runs on. reference: src/state_machine.zig."""

from .state_machine import AccountEventRecord, StateMachineOracle

__all__ = ["StateMachineOracle", "AccountEventRecord"]
