"""Device-mesh parallelism for batch validation.

The reference's intra-batch axis is the 8190-event hot loop (reference:
docs/ARCHITECTURE.md:358-362). The port maps it onto an in-process mesh
of devices (`shard_utils.Mesh`): the full create_transfers kernel runs
sharded — per-event validation on each shard's slice of the batch, the
compact per-event bundle all-gathered, and the deterministic global tail
replicated (parallel/full_sharded.py). parallel/partitioned.py shards
the state itself by the id hash: each prepare exchanges the rows it
touches (`shard_utils.psum`), judges them on a mini-state, and writes
back to the owning shards. parallel/resharding.py moves a hash range
between those shards under live traffic, and parallel/multihost.py
spreads the mesh over processes (torch.distributed on gloo).
"""

from .full_sharded import make_sharded_create_transfers, shard_batch

__all__ = ["make_sharded_create_transfers", "shard_batch"]
