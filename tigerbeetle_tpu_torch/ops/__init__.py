"""Device kernels and state of the port: the ledger state and its entry points
(`ledger`), the plain-tier batch kernels (`fast_kernels`), the hash
tables (`hash_table`) with the fused CUDA probe (`fused_probe`), u128
limb arithmetic on int64-carried u64 lanes (`u128`, `u64`) and the state
digest (`state_epoch`)."""
