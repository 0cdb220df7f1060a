"""LSM storage engine (reference: src/lsm/), a copy of the JAX package's
`lsm/` (host code, no device work).

A log-structured merge forest over a copy-on-write block grid:

- grid.py    — block allocator/store with checksummed blocks and an
               EWAH-persisted free set (reference: src/vsr/grid.zig +
               src/vsr/free_set.zig)
- table.py   — immutable sorted runs serialized into grid blocks
               (reference: src/lsm/table.zig)
- tree.py    — memtable + leveled tables, growth factor 8, deterministic
               least-overlap compaction (reference: src/lsm/tree.zig,
               compaction.zig, manifest.zig)
- forest.py  — named trees sharing one grid; checkpoint/open
               (reference: src/lsm/forest.zig)
- scan.py, k_way_merge.py, zig_zag_merge.py, query.py — index scans and
               the forest-served queries (reference: src/lsm/scan_*.zig)

Given the same puts, removes and beats, the grid zone it writes is byte
for byte the JAX package's.
"""

from .forest import Forest
from .grid import Grid
from .tree import Tree

__all__ = ["Forest", "Grid", "Tree"]
