"""Grid scrubber: proactive background validation of LSM grid blocks.

reference: src/vsr/grid_scrubber.zig:1-20 — latent sector errors are only
caught when a block is read; rarely-read blocks (deep LSM levels) could
decay silently past the point of repair. The scrubber tours every
reachable block (all tables of all trees plus the manifest chain) in a
deterministic cycle, surfacing corruption early while peers still hold
good copies.

Design, matching the reference's shape (grid_scrubber.zig:101-138,
165-190) re-derived for the sans-io runtime:

- **Cycle pacing**: a full tour is budgeted over `cycle_ticks` ticks; each
  tick reads ceil(remaining blocks / remaining ticks) blocks, so the tour
  finishes on schedule whether the grid holds ten blocks or a million —
  the reference derives its read rate from the target cycle duration the
  same way ("latent sector errors ... discovered by a scrubber that
  cycles every 2 weeks", grid_scrubber.zig:12-14). A hard
  `reads_per_tick_max` bounds the IO burst of any single tick.
- **Per-replica tour origin** (grid_scrubber.zig:170-182): each replica
  starts its tour at a different rotation of the block sequence so
  replicas scrub the same block at different times — minimizing the
  window where an unscrubbed latent fault on one replica intersects the
  same fault on another (the double-fault scenario the scrubber exists
  to prevent).
- **Fault→repair handoff**: `tick()` returns the faulty addresses found;
  the replica queues them in `block_repair` and requests validated
  copies from peers (grids are byte-identical across replicas —
  docs/ARCHITECTURE.md:281-307). Blocks freed by compaction mid-tour
  are never queued (the reference's `released` status,
  grid_scrubber.zig:65-72).

The free set and client sessions live in the superblock-referenced A/B
snapshot zone here, not in grid blocks (documented substitution —
ROUND3.md), so the checkpoint-trailer legs of the reference's tour have
no grid analog; the snapshot zone is checksummed and quorum-protected on
its own read path.

A copy of the JAX package's `vsr/grid_scrubber.py`.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..lsm.forest import Forest
from ..lsm.grid import BlockAddress
from ..trace import Event, NullTracer


class GridScrubber:
    def __init__(self, forest: Forest, *, cycle_ticks: int = 1024,
                 reads_per_tick_max: int = 64, origin_seed: int = 0,
                 tracer=None):
        self.forest = forest
        self.tracer = tracer if tracer is not None else NullTracer()
        # Tour pacing: finish one full cycle per `cycle_ticks` ticks.
        self.cycle_ticks = max(1, cycle_ticks)
        self.reads_per_tick_max = reads_per_tick_max
        # Per-replica origin rotation (decorrelates replica tours).
        self.origin_seed = origin_seed
        self._iter: Optional[Iterator[tuple[str, BlockAddress, int]]] = None
        self._tour_remaining = 0  # blocks left in the current tour
        self._ticks_remaining = 0  # ticks left in the current cycle
        self.cycles = 0  # completed full tours
        self.checked = 0  # blocks validated, lifetime
        self.tour_blocks_scrubbed = 0  # blocks validated, current tour
        self.tour_size = 0  # blocks in the current tour at its start
        # block index -> (tree, address, size); deduped across tours.
        self.faults: dict[int, tuple[str, BlockAddress, int]] = {}

    def _blocks(self) -> Iterator[tuple[str, BlockAddress, int]]:
        """Every reachable (tree, address, size) at tour start. Tables hold
        their index block address in the manifest; value-block addresses
        live inside the index block (already parsed by Table)."""
        for name, tree in sorted(self.forest.trees.items()):
            for level in tree.levels:
                for table in level:
                    yield name, table.info.index_address, table.info.index_size
                    for i, addr in enumerate(table.block_addresses):
                        yield name, addr, table.block_sizes[i]
        # The checkpoint's manifest chain is reachable grid state too —
        # a decayed chain block would make the NEXT restart unrecoverable
        # locally even though every table block is fine.
        for addr, size in self.forest.manifest_chain_blocks:
            yield "__manifest__", addr, size

    def _tour(self) -> Iterator[tuple[str, BlockAddress, int]]:
        """One full tour, rotated to this replica's origin. The rotation
        point is `origin_seed mod tour_size`, recomputed per tour so the
        origin tracks grid growth (reference grid_scrubber.zig:179-182
        selects an origin uniformly across blocks the same way)."""
        blocks = list(self._blocks())
        self.tour_size = len(blocks)
        if not blocks:
            return iter(())
        start = self.origin_seed % len(blocks)
        return iter(blocks[start:] + blocks[:start])

    def certify(self) -> list[tuple[str, BlockAddress, int]]:
        """One immediate, unpaced full tour: validate EVERY reachable
        block now and return the faults (also recorded in self.faults).
        This is the post-rebuild certification pass — a freshly installed
        checkpoint (recover --from-cluster) is only trusted once every
        block it reaches has been read back from the media and matched
        its parent-held checksum. Orthogonal to the paced background
        tour: the incremental iterator/pacing state is untouched."""
        found: list[tuple[str, BlockAddress, int]] = []
        with self.tracer.span(Event.grid_scrub_certify):
            for name, address, size in self._blocks():
                self.checked += 1
                try:
                    self.forest.grid.read_block(address, size,
                                                bypass_cache=True)
                except IOError:
                    found.append((name, address, size))
                    self.faults[address.index] = (name, address, size)
        return found

    def still_referenced(self, address: BlockAddress) -> bool:
        """True iff the CURRENT manifests still reach this exact address.
        The tour snapshot is taken at tour start, so a block freed and
        reused mid-tour can surface as a stale read failure — such an
        address must never be queued for repair (peers hold the NEW content
        too, so the repair could never converge)."""
        return any(a == address for _, a, _ in self._blocks())

    def reads_this_tick(self) -> int:
        """Cycle pacing: spread the remaining tour evenly over the
        remaining ticks of the cycle (ceil division keeps the tour ahead
        of schedule; the max bounds any single tick's IO burst)."""
        if self._iter is None:
            return 1  # first tick of a tour: open it, then pace
        if self._ticks_remaining <= 0:
            return min(self._tour_remaining, self.reads_per_tick_max)
        need = -(-self._tour_remaining // self._ticks_remaining)
        return min(max(need, 0), self.reads_per_tick_max)

    def tick(self) -> list[tuple[str, BlockAddress, int]]:
        """Validate the tick's block budget; returns faults found now
        (the replica queues them for peer repair via request_blocks)."""
        with self.tracer.span(Event.grid_scrub_tick):
            return self._tick()

    def _tick(self) -> list[tuple[str, BlockAddress, int]]:
        found: list[tuple[str, BlockAddress, int]] = []
        if self._iter is None:
            self._iter = self._tour()
            self._tour_remaining = self.tour_size
            self._ticks_remaining = self.cycle_ticks
            self.tour_blocks_scrubbed = 0
        budget = self.reads_this_tick()
        self._ticks_remaining -= 1
        for _ in range(budget):
            try:
                name, address, size = next(self._iter)
            except StopIteration:
                self._iter = None
                self.cycles += 1
                break
            self.checked += 1
            self.tour_blocks_scrubbed += 1
            self._tour_remaining -= 1
            try:
                self.forest.grid.read_block(address, size,
                                            bypass_cache=True)
            except IOError:
                if self.still_referenced(address):
                    found.append((name, address, size))
                    self.faults[address.index] = (name, address, size)
        else:
            # Tour exhausted exactly at the budget boundary (the tour is
            # a fixed snapshot, so remaining==0 means the iterator is
            # spent): close it now so the next tick opens a fresh tour
            # instead of burning a tick on StopIteration.
            if self._tour_remaining <= 0 and self._iter is not None:
                self._iter = None
                self.cycles += 1
        # Faults whose tables were since compacted away resolve themselves.
        if self.faults:
            live = {a for _, a, _ in self._blocks()}
            for index in [i for i, (_, a, _) in self.faults.items()
                          if a not in live]:
                del self.faults[index]
        return found
