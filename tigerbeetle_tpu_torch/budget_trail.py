"""The budget trail: committed budget files are pinned in rounds
(`<prefix>_r<N>.json`), and a reader takes the newest round, so a new
pinned round shows up without an edit to its readers.

Shared by devhub's panels and torchhound's capture auditor (the JAX
package's `jaxhound/core.py` helper); it imports only the standard
library, so rendering the dashboard loads no analysis tool.
"""

from __future__ import annotations

import glob
import os
import re


def newest_round_path(budget_dir: str, prefix: str) -> str:
    """The newest committed `<prefix>_r<N>.json` (highest round number)
    under budget_dir."""
    best, best_round = None, -1
    for p in glob.glob(os.path.join(budget_dir, f"{prefix}_r*.json")):
        m = re.search(rf"{prefix}_r(\d+)\.json$", os.path.basename(p))
        if m and int(m.group(1)) > best_round:
            best_round, best = int(m.group(1)), p
    if best is None:
        raise FileNotFoundError(
            f"no {prefix}_r*.json under {budget_dir!r}")
    return best
