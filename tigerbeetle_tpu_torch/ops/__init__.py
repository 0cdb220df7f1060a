"""Device kernels and state of the port: the ledger state and its entry points
(`ledger`), the plain-tier batch kernels (`fast_kernels`), the hash
tables (`hash_table`) with the fused CUDA probe (`fused_probe`), the row
gather (`row_gather`), the host packing and prefetch (`batch`), the
sequential create kernels (`create_kernels`, CUDA in `create_seq`), u128
limb arithmetic on int64-carried u64 lanes (`u128`, `u64`) and the state
digest (`state_epoch`)."""
