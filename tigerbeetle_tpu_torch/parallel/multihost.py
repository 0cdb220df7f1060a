"""A mesh across processes: torch.distributed on gloo, and the two-process
leg.

A port of the JAX package's `parallel/multihost.py`. The partitioned route
(`parallel/partitioned.py`) shards the ledger over a mesh and does not
care which process holds a shard: its only cross-shard steps are the
mesh's `psum` and `all_gather` (`shard_utils`), which on a mesh of several
processes reduce this process's shards first and then call
`torch.distributed`. This module supplies the rest:

  - `init_multihost`: idempotent `torch.distributed.init_process_group`
    on gloo, its coordinator address, process count and process index
    from the arguments, or else from the launcher's standard variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), which torch's env://
    rendezvous reads. Every process runs the same program.
  - `global_mesh`: a `shard_utils.Mesh` of process_count x k shards,
    shard s held by process s // k; this process holds and computes its
    own k shards only.
  - `two_process_smoke`: two processes on this host, 4 logical shards
    each, drive one fused partitioned chain window and hold every result
    to the oracle in each process.

gloo is the one backend: NCCL refuses two ranks on one card, and gloo
runs where the tests do. A CUDA tensor goes through gloo as a copy to
host memory and back inside the collective: that is the path, not a
fallback, and a mesh that asks for another backend raises. A gloo
collective cannot sit inside a captured CUDA graph, so a multi-process
mesh runs its chain windows eagerly (`PartitionedRouter.step_window`;
the ledger's `WindowGraphs` refuses such a mesh).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time

_INITIALIZED = False
_DEVICE = None


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> bool:
    """Bring up the process group (gloo). Returns True when it is up (or
    already was), False when torch.distributed cannot start here: callers
    read False as a single-process mesh, not an error. The coordinator's
    address ("host:port"), the process count and this process's index
    come together; with none of them, torch's env:// rendezvous reads the
    launcher's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, and where
    the launcher set none this is a single-process no-op that returns
    True. `device` is where `global_mesh` puts this process's shards by
    default (None: the card)."""
    global _INITIALIZED, _DEVICE
    _DEVICE = device
    if _INITIALIZED:
        return True
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given) and any(v is None for v in given):
        raise ValueError("init_multihost: give the coordinator's address, "
                         "the process count and the process index together")
    import torch.distributed as dist

    if coordinator_address is None:
        init, kw = "env://", {}
    else:
        init = f"tcp://{coordinator_address}"
        kw = dict(world_size=int(num_processes), rank=int(process_id))
    try:
        dist.init_process_group("gloo", init_method=init,
                                timeout=datetime.timedelta(seconds=120),
                                **kw)
    except ValueError as e:
        if init == "env://" and "env://" in str(e):
            # No launcher: one process, whose mesh is the global mesh.
            return True
        print(f"[multihost] distributed init unavailable: {e!r}",
              flush=True)
        return False
    except Exception as e:  # the runtime is absent or refuses
        print(f"[multihost] distributed init unavailable: {e!r}",
              flush=True)
        return False
    _INITIALIZED = True
    return True


def global_mesh(shards_per_process: int = 1, device=None,
                backend: str = "gloo"):
    """The 1-D partitioned mesh over every process: `shards_per_process`
    logical shards of this process's device (None: the one given to
    `init_multihost`, else the card) for each process of the group, shard
    s held by process s // shards_per_process. Without a process group,
    the mesh of this process's shards alone."""
    import torch.distributed as dist

    from ..ops.device import resolve_device
    from .shard_utils import Mesh

    dev = resolve_device(device if device is not None else _DEVICE)
    if dist.is_available() and dist.is_initialized():
        return Mesh([dev] * shards_per_process,
                    process_count=dist.get_world_size(),
                    process_index=dist.get_rank(), backend=backend)
    return Mesh([dev] * shards_per_process, backend=backend)


# ------------------------------------------------ the two-process leg

_WORKER = r"""
import sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
device = sys.argv[4]
sys.path.insert(0, sys.argv[5])
try:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from tigerbeetle_tpu_torch.parallel import multihost
    if not multihost.init_multihost(coord, nproc, pid, device=device):
        print("MULTIHOST_SKIP: distributed init unavailable", flush=True)
        sys.exit(0)
    import torch.distributed as dist
    if dist.get_world_size() != nproc:
        print(f"MULTIHOST_SKIP: world size {dist.get_world_size()}, "
              f"expected {nproc}", flush=True)
        sys.exit(0)
    from tigerbeetle_tpu_torch.ops import fused_probe, row_gather
    from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays
    from tigerbeetle_tpu_torch.oracle.state_machine import \
        StateMachineOracle
    from tigerbeetle_tpu_torch.parallel.partitioned import PartitionedRouter
    from tigerbeetle_tpu_torch.types import Account, Transfer

    mesh = multihost.global_mesh(4, device)
    oracle = StateMachineOracle()
    oracle.create_accounts(
        [Account(id=i, ledger=1, code=1) for i in range(1, 17)], 50)
    router = PartitionedRouter(mesh, a_cap=1 << 8, t_cap=1 << 9)
    state = router.from_oracle(oracle)
    rng = np.random.default_rng(31)
    nid, ts = 10 ** 6, 10 ** 9
    window, tss = [], []
    for _ in range(2):  # W = 2: one fused chain window across processes
        evs = []
        for _ in range(6):
            dr, cr = (int(x) for x in rng.choice(
                np.arange(1, 17), 2, replace=False))
            evs.append(Transfer(id=nid, debit_account_id=dr,
                                credit_account_id=cr,
                                amount=int(rng.integers(1, 20)),
                                ledger=1, code=1))
            nid += 1
        ts += 300
        window.append(evs)
        tss.append(ts)
    state, results = router.step_window(
        state, [transfers_to_arrays(e) for e in window], tss)
except AssertionError:
    raise  # a parity break is a red, not a skip
except Exception as e:
    print(f"MULTIHOST_SKIP: {e!r}"[:300], flush=True)
    sys.exit(0)
# The route and parity asserts run outside the skip net: once the runtime
# is up, a wrong answer fails the leg.
assert router.window_routes.get("partitioned_chain") == 1, \
    router.window_routes
assert router.host_fallbacks == 0, router.stats()
for evs, t, (st, rts) in zip(window, tss, results):
    want = oracle.create_transfers(evs, t)
    got = [(int(rts[i]), int(st[i])) for i in range(len(evs))]
    assert got == [(r.timestamp, int(r.status)) for r in want], got
print(f"MULTIHOST_LAUNCHES {fused_probe.LAUNCHES} {row_gather.LAUNCHES}",
      flush=True)
print(f"MULTIHOST_OK process={pid}", flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _smoke_attempt(timeout: float, device: str, stats) -> str:
    coord = f"127.0.0.1:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(pid), "2", coord, device, repo],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    deadline = time.time() + timeout
    outs = []
    for p in procs:
        left = max(1.0, deadline - time.time())
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            # A wedged handshake is the environment's, not the ledger's.
            return ("skipped: 2-process leg timed out (coordinator "
                    "handshake unavailable?)")
        outs.append(out or "")
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            if "AssertionError" in out:
                # A parity or route break with the runtime up: a red.
                raise RuntimeError(
                    f"multihost 2-process leg RED (rc={p.returncode}):\n"
                    + out[-2000:])
            return ("skipped: worker crashed in the multi-process runtime "
                    f"(rc={p.returncode}): " + out[-200:])
    if all("MULTIHOST_OK" in o for o in outs):
        if stats is not None:
            # Each worker's kernel launches (its own counters), summed.
            launches = [0, 0]
            for o in outs:
                for line in o.splitlines():
                    if line.startswith("MULTIHOST_LAUNCHES"):
                        for i, v in enumerate(line.split()[1:3]):
                            launches[i] += int(v)
            stats["launches"] = tuple(launches)
            stats["outputs"] = outs
        return "ok"
    reason = next((line for o in outs for line in o.splitlines()
                   if line.startswith("MULTIHOST_SKIP")),
                  "MULTIHOST_SKIP: no marker")
    return "skipped: " + reason.split(":", 1)[-1].strip()


def two_process_smoke(device=None, timeout: float = 300.0,
                      attempts: int = 2, stats: dict | None = None) -> str:
    """Run the two-process leg on this host: two processes, 4 logical
    shards each on `device` (None: the card; "cpu" keeps them on the CPU),
    one gloo process group, one fused partitioned chain window over the
    mesh of 8 shards. Returns "ok", or "skipped: <reason>" when the
    multi-process runtime is unavailable here (a transport crash retries
    once before that); raises on a parity break. The kernels are built
    here first, so the workers load them and build none. `stats`, when
    given, receives the workers' summed kernel launches (probe, gather)
    under "launches"."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.load_ht_probe()
        _build.load_row_gather()
    last = "skipped: not attempted"
    for _ in range(attempts):
        last = _smoke_attempt(timeout, dev.type, stats)
        if last == "ok":
            return last
    return last


if __name__ == "__main__":
    print(f"[multihost] {two_process_smoke()}")
