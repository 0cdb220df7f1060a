"""Device determinism pass: nondeterminism hazards in a serving call.

The port's counterpart of the JAX package's `jaxhound/determinism.py`.
The system's load-bearing invariant is byte-for-byte determinism across
replicas: corrupted state is repaired from peers precisely because
every replica computes identical bytes. This pass reads each registered
serving entry's census (`core.trace`: one eager call under a counting
dispatch mode) and REDs on the JAX package's four hazard classes, each
in its PyTorch form:

  rng_no_key        an RNG op (rand*, randint, randperm, bernoulli,
                    normal, uniform_, random_, multinomial,
                    exponential_, ...) without an explicit `generator`:
                    it draws from the process-global generator, whose
                    state is the baked key — a replica that ran anything
                    else before mints different bits.
  host_callback     a host round trip inside the call:
                    `_local_scalar_dense` (`.item()`, `int(t)`),
                    `is_nonzero` (`bool(t)`), `nonzero`, `equal`, a
                    boolean-mask index or a copy to the host. It leaves
                    the device stream, and it breaks a CUDA-graph
                    capture.
  float_collective  a mesh collective (`shard_utils.all_gather` /
                    `psum`) or a torch.distributed collective on a
                    floating-point tensor: a float sum depends on its
                    order, so the same window commits different bytes on
                    another mesh. The partitioned exchange must stay
                    integer.
  float_scatter_dup a scatter that combines values (`index_put_` with
                    accumulate, `index_add_`, `scatter_add_`,
                    `scatter_reduce`, ...) into a floating-point table:
                    the order duplicates combine in is unspecified on the
                    card, so float accumulation — and the committed
                    bytes — can vary.

Findings are strings prefixed with the rule name; an empty list means
the entry is determinism-clean.
"""

from __future__ import annotations

from .core import Trace


def findings_for(tr: Trace, name: str = "entry") -> list[str]:
    """Device-determinism findings for one traced call (empty =
    clean)."""
    findings: list[str] = []
    for op, has_generator in tr.rng:
        if not has_generator:
            findings.append(
                f"rng_no_key: `{op}` in {name} draws from the global "
                "generator — pass an explicit generator")
    for op, detail in tr.syncs:
        findings.append(
            f"host_callback: `{op}` ({detail}) in {name} — a host round "
            "trip escapes the device stream and breaks graph capture")
    for c in tr.collectives:
        if c["floating"]:
            findings.append(
                f"float_collective: `{c['name']}` on floating operands "
                f"({', '.join(c['dtypes'])}) in {name} — a float sum's "
                "order varies across meshes; the exchange must stay "
                "integer")
    for op, floating in tr.dist:
        if floating:
            findings.append(
                f"float_collective: torch.distributed `{op}` on floating "
                f"operands in {name} — the exchange must stay integer")
    for op, dtype in tr.accumulate:
        if dtype.is_floating_point:
            findings.append(
                f"float_scatter_dup: `{op}` into a {dtype} table in "
                f"{name} — duplicate combination order is unspecified")
    return findings


def run(traces: dict) -> list[str]:
    """Run the pass over `name -> Trace`; returns RED strings."""
    fails = []
    for name, tr in traces.items():
        fails.extend(f"{name}: {f}" for f in findings_for(tr, name))
    return fails
