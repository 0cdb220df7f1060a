#!/usr/bin/env python3
"""The sequential create_transfers and create_accounts kernels, one tree
against another on one card, in turns.

    python3 scripts/chip_seq_turns.py OTHER_TREE [--turns 2]

Run from the repo root on a machine with one H100.
OTHER_TREE is another checkout of the repo, e.g. the parent commit
unpacked with `git archive` under the git-ignored `scratch/`. Each turn is
a child process that imports one tree's `tigerbeetle_tpu_torch`, builds
that tree's `csrc/create_seq.cu` into the tree's own `build/`, and times
both kernels on the inputs chip_smoke.py's seq phase times (this
checkout's chip_smoke.py makes them in every turn): the transfers kernel
on the 8,190-event config-3 batch and the config-4 pend and post/void
batches, the accounts kernel on 8,190 new accounts and on the
8,190-event mixed batch. Times are the kernel's device ms from
torch.profiler (chip_smoke.py `kernel_ms`), the kernel's own
%globaltimer stamps (first to last, median of 5, and the stage split
where the tree's kernel has stages), and the "kernel" span
`run_create_*` records on the host clock (the launch, the wait and the
outputs' copy back; median of 3, each on a fresh oracle). Turns run
other, this, this, other (`--turns` pairs). Each turn prints one JSON
line; the last line holds the card, the means by tree and batch, and
whether every turn's outputs had the same digest.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BATCHES = ("config3", "config4_pend", "config4_post_void", "accounts_new",
           "accounts_mixed")


def _harness():
    """This checkout's chip_smoke.py, whichever tree is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke_harness",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import inspect

    import numpy as np
    import torch

    from tigerbeetle_tpu_torch.ops import _build, create_seq
    from tigerbeetle_tpu_torch.ops import create_kernels as CK

    CS = _harness()
    _build.build("create_seq")
    inputs = dict(zip(BATCHES, (CS.seq_config3_inputs(),
                                *CS.seq_config4_inputs(),
                                CS.seq_accounts_inputs(),
                                CS.seq_mixed_accounts_inputs())))
    # The parent's stage_ms() reads the transfers kernel alone.
    staged = inspect.signature(create_seq.stage_ms).parameters
    out = {"tree": tree, "ms": {}, "stamp_ms": {}, "digest": {},
           "stage_ms": {}}
    for name, inp in inputs.items():
        kind = "accounts" if name.startswith("accounts") else "transfers"
        run = getattr(create_seq, f"create_{kind}_seq")
        tin = CK.inputs_to_device(inp, "cuda")
        got = run(tin)
        h = hashlib.sha256()
        for k in sorted(got):
            h.update(k.encode() + got[k].cpu().numpy().tobytes())
        out["digest"][name] = h.hexdigest()[:16]
        out["ms"][name] = CS.kernel_ms(lambda: run(tin),
                                       f"create_{kind}_seq", reps=5)
        stamps = []
        for _ in range(5):
            run(tin)
            stamps.append(create_seq.device_ms(kind))
        out["stamp_ms"][name] = float(np.median(stamps))
        if staged or kind == "transfers":
            out["stage_ms"][name] = (create_seq.stage_ms(kind) if staged
                                     else create_seq.stage_ms())
        torch.cuda.synchronize()
    out["span_ms"] = run_create_spans(CS, create_seq)
    return out


def run_create_spans(CS, create_seq, reps: int = 3) -> dict:
    """The median `run_create_*` "kernel" span (host clock: the launch,
    the wait and the outputs' copy back; `create_seq.SPANS`) of each
    batch, on a fresh oracle each time."""
    import numpy as np

    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
    from tigerbeetle_tpu_torch.types import (Account, AccountFlags,
                                             TransferFlags)

    n = CS.BATCH

    def config3():
        o = StateMachineOracle()
        o.create_accounts([Account(id=i, ledger=1, code=1)
                           for i in range(1, 1001)], 1000)
        return o

    def config4(pended: bool):
        o = StateMachineOracle()
        o.create_accounts(CS.config4_accounts(Account, AccountFlags),
                          CS.C4_ACCOUNTS)
        if pended:
            o.create_transfers(transfers_from_arrays(pend), 10**12 + n + 10)
        return o

    pend, rev, _ = CS.config4_pair(np.random.default_rng(4), 10**7,
                                   TransferFlags, n)
    cases = {
        "config3": (config3, transfers_from_arrays(CS.config3_batch(
            np.random.default_rng(3), 0, n, 1000)), 10**7),
        "config4_pend": (lambda: config4(False),
                         transfers_from_arrays(pend), 10**12 + n + 10),
        "config4_post_void": (lambda: config4(True),
                              transfers_from_arrays(rev),
                              10**12 + 2 * (n + 10)),
        "accounts_new": (StateMachineOracle, [
            Account(id=i, ledger=1, code=1) for i in range(1, n + 1)],
            10**7),
        "accounts_mixed": (lambda: CS.seq_mixed_accounts_case(n)[0],
                           *CS.seq_mixed_accounts_case(n)[1:]),
    }
    spans = {}
    for name, (state, events, ts) in cases.items():
        run = (create_seq.run_create_accounts if name.startswith("accounts")
               else create_seq.run_create_transfers)
        ms = []
        for _ in range(reps):
            run(state(), events, ts)
            ms.append(create_seq.SPANS["kernel"])
        spans[name] = sorted(ms)[reps // 2]
    return spans


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    other = argv[0]
    turns = int(argv[argv.index("--turns") + 1]) if "--turns" in argv else 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    order = [other, str(REPO), str(REPO), other] * (turns // 2)
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True, cwd=REPO)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    means = {}
    for key in ("ms", "stamp_ms", "span_ms"):
        for tree in (other, str(REPO)):
            ms = [r[key] for r in runs if r["tree"] == tree]
            means.setdefault(key, {})[
                "this" if tree == str(REPO) else "other"] = {
                b: sum(m[b] for m in ms) / len(ms) for b in BATCHES}
    same = all(r["digest"] == runs[0]["digest"] for r in runs)
    print(json.dumps({"card": card, "mean_ms": means["ms"],
                      "mean_stamp_ms": means["stamp_ms"],
                      "mean_span_ms": means["span_ms"],
                      "same_outputs": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
