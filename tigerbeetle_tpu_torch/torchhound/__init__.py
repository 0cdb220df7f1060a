"""torchhound: the port's whole-stack static verifier.

The counterpart of the JAX package's `jaxhound/` (whose name the JAX
package keeps). Its passes do not check a JAX program: they check the
system's load-bearing invariant — every replica computes the same bytes
— and the device-dispatch design serving relies on (a window replays one
captured CUDA graph a key), each in its PyTorch form:

  core         the op census: one eager call under a counting dispatch
               mode (`trace/profiler.py`), aten ops by name and heavy
               class, the kernel wrappers' launches and bytes, the mesh
               collectives; the closure-constant, host-sync and
               state-gather lints; the `report` of `main.py torchhound`.
  determinism  device determinism: RNG without an explicit generator,
               host round trips, floating-point collectives,
               floating-point scatters that combine duplicates.
  hostdet      host determinism: a Python-AST lint over the replay
               plane (wall-clock reads, unseeded `random`, set-iteration
               order, env reads) with a `# torchhound: allow(<rule>)`
               pragma allowlist.
  retrace      the capture auditor: the route matrix's call signatures
               across W in {1, 2, 8, 32}, pinned in
               trace/tracebudget_r*.json; a live capture probe on a
               DeviceLedger's window graphs; the state and poison-carry
               check.
  shardspec    the partitioned layout: per-shard state on its shard's
               device at the per-shard size, no shared storage, written
               in place, no whole-state operand.
  registry     the serving-entry registry the passes run over.
  opbudget     the op budget: the heavy-op census of every dispatch tier
               pinned in trace/opbudget_r*.json (`--write`, `--check`),
               the telemetry pack's lanes, and the lints (`--lint`).

CLI: ``python -m tigerbeetle_tpu_torch.torchhound [--kernel K] [--json]
[--pass determinism|host|retrace|sharding|all] [--device D]``; the
gate's `static` leg (testing/static_smoke.py) runs every pass plus the
negative injected-violation proofs.
"""

from __future__ import annotations

from . import (  # noqa: F401 — the pass modules
    core,
    determinism,
    hostdet,
    registry,
    retrace,
    shardspec,
)
from .cli import main  # noqa: F401
from .core import (  # noqa: F401 — the census and its lints
    CLOSURE_CONST_LIMIT,
    HEAVY_CLASSES,
    HEAVY_CLASS_ORDER,
    STATE_GATHER_LIMIT,
    Trace,
    census,
    closure_constants,
    heavy_census,
    kernels,
    newest_budget_path,
    newest_tracebudget_path,
    report,
    state_gathers,
    telemetry_census,
    trace,
    while_ops,
    window_body_census,
)
