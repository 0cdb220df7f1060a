"""Causality gate leg: causal request tracing end to end on a REAL cluster.

The port's counterpart of the JAX package's `testing/causality_smoke.py`
(the gate's `causality` leg). Spins a 3-replica vortex (real
`python -m tigerbeetle_tpu_torch` processes, real TCP through the fault
proxies) with tracing on, drives requests from a real vsr client under a
recording tracer at sampling 1.0, merges the client's trace with every
replica's dumped trace on one timeline, and asserts the tentpole
property: every request assembles into exactly ONE complete causal
tree — a single client_request root, zero orphan spans, and the commit
work causally attributed to the request (a commit_execute span inside
the tree).

Two negative proofs keep the check honest (a checker that cannot fail
proves nothing):

- **dropped header**: strip the causal args from every non-root span —
  the shape a deployment that drops the wire trace-context block would
  produce. The trees degenerate to bare roots and the commit-
  attribution check must RED.
- **dropped root**: remove the client_request spans — every downstream
  span's parent now points nowhere and the orphan detector must RED.

The replicas run the oracle engine (as the JAX package's vortex does),
so the leg launches no kernel. `platform` names where their state
machines live: None is the card, "cpu" the CPU.

``python -m tigerbeetle_tpu_torch.testing.causality_smoke [--platform cpu]``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

CLIENT_PID = 99
REQUESTS = 6


def _check_assembly(asm: dict, requests: int) -> list:
    """The causal acceptance predicate: one complete orphan-free tree
    per request, rooted at client_request, with the commit causally
    inside it. Returns a list of problem strings (empty = green)."""
    problems = []
    if asm["total"] != requests:
        problems.append(
            f"expected {requests} traces, assembled {asm['total']}")
    if asm["orphan_spans"]:
        problems.append(f"{asm['orphan_spans']} orphan spans "
                        f"(broken parent linkage)")
    if asm["complete"] != asm["total"]:
        problems.append(
            f"only {asm['complete']}/{asm['total']} traces complete")
    for t in asm["traces"]:
        names = {s["name"] for s in t["spans"]}
        root = t["root"]
        if root is None or root["name"] != "client_request":
            problems.append(
                f"trace {t['trace_id'][:8]}: root is "
                f"{root['name'] if root else None}, not client_request")
        elif "commit_execute" not in names:
            problems.append(
                f"trace {t['trace_id'][:8]}: commit never causally "
                f"attributed (spans: {sorted(names)})")
        cp = t.get("critical_path") or {}
        if not cp.get("total_us"):
            problems.append(
                f"trace {t['trace_id'][:8]}: empty critical path")
    return problems


def _strip_headers(doc: dict) -> dict:
    """Simulate a deployment that drops the wire trace-context block:
    every span NOT recorded by the client loses its causal args (a
    replica that never saw the header records plain spans)."""
    out = dict(doc, traceEvents=[])
    for e in doc.get("traceEvents", []):
        e = dict(e)
        if e.get("name") != "client_request" and e.get("args"):
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("trace_id", "span_id",
                                      "parent_id", "links")}
        out["traceEvents"].append(e)
    return out


def _strip_roots(doc: dict) -> dict:
    """Remove the client_request root spans: downstream parent ids now
    point at a span that is not in the document."""
    return dict(doc, traceEvents=[
        e for e in doc.get("traceEvents", [])
        if e.get("name") != "client_request"])


def causality_main(requests: int = REQUESTS,
                   platform: Optional[str] = None) -> int:
    """Gate entry: returns 0 green / 1 red, printing every problem."""
    from .. import multi_batch
    from ..main import _parse_addresses
    from ..trace import Tracer, assemble_traces, merge_traces
    from ..types import Account, Operation, Transfer
    from ..vsr.client import Client
    from .vortex import VortexSupervisor

    failures = 0
    with tempfile.TemporaryDirectory(prefix="tb_torch_causality_") as tmp:
        sup = VortexSupervisor(tmp, replica_count=3, seed=11, trace=True,
                               platform=platform)
        client_tracer = Tracer(pid=CLIENT_PID)
        client = Client(cluster=sup.cluster, client_id=21,
                        replica_addresses=_parse_addresses(sup.addresses),
                        tracer=client_tracer, trace_head_rate=1.0)
        try:
            deadline = time.monotonic() + 120
            while True:  # retry until the quorum is up (slow torch import)
                try:
                    client.request(
                        Operation.create_accounts, multi_batch.encode(
                            [b"".join(Account(id=i, ledger=1,
                                              code=1).pack()
                                      for i in (1, 2))], 128))
                    break
                except TimeoutError:
                    if time.monotonic() >= deadline:
                        raise
            for k in range(requests - 1):
                client.request(
                    Operation.create_transfers, multi_batch.encode(
                        [Transfer(id=100 + k, debit_account_id=1,
                                  credit_account_id=2, amount=1 + k,
                                  ledger=1, code=1).pack()], 128))
            sup.wait_caught_up()
        finally:
            client.close()
            sup.shutdown()
        docs = []
        for i in range(sup.replica_count):
            path = sup.trace_path(i)
            if os.path.exists(path):
                with open(path) as f:
                    docs.append(json.load(f))
        if not docs:
            print("[causality] RED: no replica dumped a trace",
                  flush=True)
            return 1
        # One merge over RAW documents (replicas + client): the common
        # wall-clock rebase puts everything on one timeline, and the
        # matched bus send/recv pairs drive per-pid skew correction.
        merged = merge_traces(docs + [client_tracer.chrome_dict()])
    asm = assemble_traces(merged, head_rate=1.0)
    problems = _check_assembly(asm, requests)
    for p in problems:
        print(f"[causality] RED: {p}", flush=True)
    failures += len(problems)
    if not problems:
        owners = sorted({(t["critical_path"] or {}).get("owner")
                         for t in asm["traces"]})
        print(f"[causality] {asm['total']} requests -> "
              f"{asm['complete']} complete trees, 0 orphans, "
              f"clock offsets {asm['clock_offsets_us']}, "
              f"critical-path owners {owners}", flush=True)
    # Negative proofs: each stripped document MUST trip the checker.
    for label, mutate in (("dropped-header", _strip_headers),
                          ("dropped-root", _strip_roots)):
        bad = assemble_traces(mutate(merged), head_rate=1.0)
        if not _check_assembly(bad, requests):
            failures += 1
            print(f"[causality] RED: {label} negative proof did not "
                  f"trip the checker (the gate is vacuous)", flush=True)
        else:
            print(f"[causality] negative proof ok: {label} detected",
                  flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    return causality_main(platform=args.platform)


if __name__ == "__main__":
    raise SystemExit(main())
