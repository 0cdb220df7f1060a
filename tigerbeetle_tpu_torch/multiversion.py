"""Release/upgrade management.

reference: src/multiversion.zig — the reference packs multiple release
binaries into one executable and re-execs into the version matching the
cluster's checkpoint. A Python deployment upgrades differently (the
interpreter reloads code), so this module keeps the protocol-visible parts:

- a monotonically increasing release number stamped into every message
  header (`release` field) and checkpoint;
- compatibility gating: a replica refuses to run a data file checkpointed
  by a NEWER release (it must be upgraded first), and records the release
  floor peers advertise so operators can see when a rolling upgrade is
  complete.

The in-binary multi-release packing itself is deliberately out of scope —
its job (atomic coordinated upgrades) is served by release gating plus
process restarts in this runtime.

A copy of the JAX package's `multiversion.py`: the same release numbers, so data files move between the packages.
"""

from __future__ import annotations

import dataclasses

# Bump on every protocol-visible change.
# r2: manifest chain headers + full secondary-index tree schema (r1 data
#     files must be rebuilt via `recover`).
# r3: manifest entries carry (snapshot_min, snapshot_max) ranges
#     (lsm/manifest_level.py) — the packed layout shifted by 16 bytes per
#     table entry.
# r4: tree manifests persist the op clock (beat) and per-level insertion
#     sequences (next_seq + per-entry seq) so restores preserve level-0
#     recency and seq determinism.
RELEASE = 4

# Oldest checkpoint format this binary still opens. Checkpoints below the
# floor are refused at open with a rebuild instruction — enforcing the
# "old data files must be rebuilt" requirement instead of silently
# misparsing the shifted manifest layout.
FORMAT_FLOOR = 4


def release_str(release: int) -> str:
    """Human form: the reference renders releases as triples
    (major.minor.patch packed into a u32); ours is a plain counter."""
    return f"r{release}"


@dataclasses.dataclass
class ReleaseTracker:
    """Per-replica view of the cluster's release spread."""

    own: int = RELEASE
    peers: dict = dataclasses.field(default_factory=dict)

    def observe(self, replica: int, release: int) -> None:
        self.peers[replica] = release

    @property
    def cluster_min(self) -> int:
        return min([self.own, *self.peers.values()])

    def compatible(self, checkpoint_release: int) -> bool:
        """A data file written by a newer release cannot be opened by an
        older binary (reference: multiversion re-exec decision)."""
        return checkpoint_release <= self.own

    def openable(self, checkpoint_release: int) -> bool:
        """compatible() plus the format floor: too-old checkpoints need a
        `recover` rebuild, too-new ones need a binary upgrade."""
        return (FORMAT_FLOOR <= checkpoint_release
                and self.compatible(checkpoint_release))
