"""Static-analysis smoke: the gate's `static` leg.

The port's counterpart of the JAX package's `testing/static_smoke.py`.
Runs torchhound's four whole-stack passes over the full serving-entry
registry (flat, chain, sharded, partitioned, partitioned chain; the mesh
entries on 8 logical shards of the device):

  1. device determinism (torchhound/determinism.py) over every entry's
     census at the representative depth;
  2. host determinism (torchhound/hostdet.py) AST lint over the commit
     path's host modules, pragma allowlist honored;
  3. the capture audit (torchhound/retrace.py): canonical signatures
     across W in {1, 2, 8, 32} against the committed
     trace/tracebudget_r*.json head, every entry's state and poison
     carry, and a live capture probe on a DeviceLedger (chain and super
     windows at W = 4, then 8; at the ledger's default caps on the card,
     small on the CPU);
  4. the partitioned layout (torchhound/shardspec.py) of every
     partitioned entry.

Then proves each pass can actually fail — NEGATIVE injected-violation
proofs, each of which must RED on a planted violation and stay clean on
its paired fixed form:

  determinism  a float `shard_utils.psum` (vs an int one) and an RNG op
               drawing from the global generator (vs one given
               `generator=`);
  host         a fixture module reading the wall clock via `time.time`
               (vs the same line under `# torchhound: allow(wall_clock)`);
  retrace      an entry whose argument dtype drifts with W (polymorphic
               RED) and a tampered budget digest (drift RED);
  sharding     a shard state replicated at whole size in one storage (vs
               the per-shard layout clean).

Writes static_status.json (the JAX package's schema: per-pass ok flags,
finding samples, negative-proof verdicts, the retrace table; plus the
capture probe's counters and the census of `create_transfers_fast`) for
the devhub panel, then raises on any RED — a silently-passing verifier
never gates anything.

The passes are the CLI's (`torchhound.cli.run_passes`), so the CLI's
`--pass all` gives the leg's verdict on the same tree. Run it with
``python -c "from tigerbeetle_tpu_torch.testing import static_smoke;
static_smoke.static_smoke(device='cpu')"`` (None: the card).
"""

from __future__ import annotations

import json
import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STATUS_PATH = os.path.join(REPO, "tigerbeetle_tpu_torch", "trace",
                           "static_status.json")

def _negative_proofs(entries, device) -> dict[str, bool]:
    """name -> ok; each proof plants one violation that must RED its
    pass (and checks the paired clean form stays clean)."""
    import numpy as np
    import torch

    from ..parallel.shard_utils import Mesh, psum
    from ..torchhound import core, determinism, hostdet, retrace, shardspec
    from ..torchhound.registry import Entry

    out: dict[str, bool] = {}

    # -- determinism: float collective + RNG off the global generator ---
    mesh2 = Mesh([device] * 2)

    def parts(dtype):
        return [torch.ones(4, dtype=dtype, device=device)] * 2

    psum_f = core.trace(psum, mesh2, parts(torch.float32))
    psum_i = core.trace(psum, mesh2, parts(torch.int64))
    x = torch.ones(4, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    baked = core.trace(lambda v: v + torch.rand(4, device=device), x)
    threaded = core.trace(
        lambda v: v + torch.rand(4, device=device, generator=gen), x)
    out["determinism_float_collective"] = (
        any("float_collective" in f
            for f in determinism.findings_for(psum_f, "neg"))
        and not determinism.findings_for(psum_i, "pos"))
    out["determinism_baked_key"] = (
        any("rng_no_key" in f
            for f in determinism.findings_for(baked, "neg"))
        and not determinism.findings_for(threaded, "pos"))

    # -- host: wall-clock fixture, pragma suppression -------------------
    red_src = "import time\n\ndef f():\n    return time.time()\n"
    ok_src = ("import time\n\ndef f():\n    return time.time()"
              "  # torchhound: allow(wall_clock)\n")
    out["host_wall_clock"] = (
        any("wall_clock" in f
            for f in hostdet.scan_source(red_src, "fixture.py"))
        and not hostdet.scan_source(ok_src, "fixture.py"))

    # -- retrace: polymorphic dtype across W + tampered budget digest ---
    poly = Entry(
        name="neg_poly", route="flat", fn=None,
        make_args=lambda d: (np.zeros(
            8, np.int32 if d < 8 else np.int64),),
        depths=(1, 2, 8, 32))
    _, poly_fails = retrace.canonical_signature(poly)
    tampered, _ = retrace.audit(
        {"create_transfers_fast": entries["create_transfers_fast"]})
    tampered["create_transfers_fast"]["digest"] = "0" * 16
    drift = retrace.check_budget({}, table=dict(tampered))
    out["retrace_polymorphic"] = any(
        "polymorphic_dtype" in f for f in poly_fails)
    out["retrace_budget_drift"] = any("digest" in f for f in drift)

    # -- sharding: the state replicated at whole size -------------------
    mesh8 = Mesh([device] * 8)
    expect = torch.empty((1, 128), dtype=torch.int64, device="meta")

    def step(state):
        for s in state:
            s.add_(1)
        return state, {}

    def verdict(state):
        tr = core.trace(step, state)
        return (shardspec.verify_layout(mesh8, state, expect, 1, "t")
                + shardspec.verify_step(tr, mesh8, "t"))

    whole = torch.zeros((8, 128), dtype=torch.int64, device=device)
    red = verdict(tuple(whole for _ in range(8)))
    clean = verdict(tuple(torch.zeros((1, 128), dtype=torch.int64,
                                      device=device) for _ in range(8)))
    out["sharding_replicated_donor"] = bool(red) and not clean
    return out


def static_smoke(status_path: str | None = None, device=None) -> dict:
    """Run the four passes and the negative proofs on `device` (None: the
    card), write the status to `status_path` (None: the port's
    trace/static_status.json) and return it; raise on any RED."""
    from ..ops.device import resolve_device
    from ..torchhound import core
    from ..torchhound.cli import run_passes

    t0 = time.perf_counter()
    device = resolve_device(device)
    if status_path is None:
        status_path = STATUS_PATH

    passes, seen = run_passes("all", device=device)
    entries = seen["entries"]
    print(f"[static] {len(entries)} registry entries on {device}",
          flush=True)
    negatives = _negative_proofs(entries, device)
    census = core.census(seen.pop("traces")["create_transfers_fast"])

    status = {
        "n_entries": len(entries),
        "tracebudget": seen["tracebudget"],
        "passes": {
            name: {"ok": not fails, "n_findings": len(fails),
                   "findings": fails[:20]}
            for name, fails in passes.items()},
        "negatives": negatives,
        "retrace_table": seen["table"],
        "capture": seen["capture"],
        "census": {"create_transfers_fast": census},
        "device": device.type,
    }
    with open(status_path, "w") as f:
        json.dump(status, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"[static] wrote {status_path}", flush=True)

    reds: list[str] = []
    for name, fails in passes.items():
        print(f"[static] pass {name}: "
              + ("clean" if not fails else f"{len(fails)} RED"),
              flush=True)
        reds.extend(f"{name}: {f}" for f in fails)
    for name, ok in negatives.items():
        print(f"[static] negative {name}: "
              + ("reds as required" if ok else "FAILED TO RED"),
              flush=True)
        if not ok:
            reds.append(f"negative proof {name}: injected violation "
                        "did not RED (the pass cannot fail)")
    if reds:
        raise AssertionError("[static] RED:\n  " + "\n  ".join(reds))
    print(f"[static] GREEN in {time.perf_counter() - t0:.1f} s", flush=True)
    return status


if __name__ == "__main__":
    static_smoke()
