"""The multi-process mesh (`parallel/multihost.py`, `shard_utils` on
torch.distributed), on the CPU.

- `two_process_smoke(device="cpu")` returns "ok": two processes of 4
  logical shards each drive one fused partitioned chain window through a
  gloo process group, every result equal to the oracle in each process.
- In two gloo processes, `psum` and `all_gather` over a mesh of 2 x 4
  shards equal the in-process mesh of 8 on the same parts (int64 sums
  wrap as u64 sums do), and `partitioned_state_digest` of the two halves
  of a partitioned state, wrap-summed across the processes, equals the
  whole state's.
- `WindowGraphs` refuses a multi-process mesh; a mesh that asks for
  another backend than gloo raises; with no coordinator `init_multihost`
  is a single-process no-op.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch.ops import state_epoch as TSE
from tigerbeetle_tpu_torch.ops.window_graph import WindowGraphs
from tigerbeetle_tpu_torch.oracle.state_machine import StateMachineOracle
from tigerbeetle_tpu_torch.parallel import multihost
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU
from tigerbeetle_tpu_torch.types import Account, Transfer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parts(seed=3):
    """One (8, 5) int64 block a shard of 8, the first lanes at the int64
    edges, and a bool vector a shard."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-(1 << 63), (1 << 63) - 1, (8, 8, 5), dtype=np.int64)
    ints[:, 0, 0] = (1 << 63) - 1
    ints[:, 0, 1] = -1
    bools = rng.random((8, 16)) < 0.5
    return ints, bools


def _oracle():
    sm = StateMachineOracle()
    sm.create_accounts([Account(id=i, ledger=1, code=1)
                        for i in range(1, 17)], 50)
    sm.create_transfers([Transfer(id=100 + i, debit_account_id=1 + i % 16,
                                  credit_account_id=1 + (i * 7 + 3) % 16,
                                  amount=1 + i, ledger=1, code=1)
                         for i in range(40) if i % 16 != (i * 7 + 3) % 16],
                        10 ** 9)
    return sm


_COLLECTIVES = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[4])
from tests.test_torch_multihost import _oracle, _parts
from tigerbeetle_tpu_torch.ops import state_epoch as TSE
from tigerbeetle_tpu_torch.parallel import multihost
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU
pid, coord = int(sys.argv[1]), sys.argv[2]
assert multihost.init_multihost(coord, 2, pid, device="cpu")
mesh = multihost.global_mesh(4)
assert mesh.size == 8 and mesh.local == tuple(range(4 * pid, 4 * pid + 4))
ints, bools = _parts()
mine = list(mesh.local)
s_int = TSU.psum(mesh, [torch.from_numpy(ints[s]) for s in mine])[0]
s_bool = TSU.psum(mesh, [torch.from_numpy(bools[s]) for s in mine])[0]
g = TSU.all_gather(mesh, [{"a": torch.from_numpy(ints[s]),
                           "b": torch.from_numpy(bools[s])}
                          for s in mine])[0]
wrap = TSU.psum(mesh, [torch.tensor([(1 << 63) - 1, -1])
                       if s == 0 else torch.tensor([1, 1]) if s == 4
                       else torch.zeros(2, dtype=torch.int64)
                       for s in mine])[0]
state = TP.partitioned_from_oracle(_oracle(), mesh, a_cap=1 << 8,
                                   t_cap=1 << 9)
digest = TSE.partitioned_state_digest(state, mesh=mesh)
out = dict(int=s_int.tolist(), bool=s_bool.tolist(), a=g["a"].tolist(),
           b=g["b"].tolist(), wrap=wrap.tolist(),
           digest={k: str(v) for k, v in digest.items()})
print("RESULT " + json.dumps(out), flush=True)
import torch.distributed as dist
dist.destroy_process_group()
"""


def test_collectives_across_two_processes_equal_the_in_process_mesh():
    coord = f"127.0.0.1:{multihost._free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _COLLECTIVES, str(pid), coord, "", REPO],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    res = [json.loads(next(line[7:] for line in o.splitlines()
                           if line.startswith("RESULT "))) for o in outs]
    assert res[0] == res[1]
    got = res[0]
    ints, bools = _parts()
    mesh = TSU.Mesh(["cpu"] * 8)
    assert got["int"] == TSU.psum(
        mesh, [torch.from_numpy(p) for p in ints])[0].tolist()
    assert got["bool"] == TSU.psum(
        mesh, [torch.from_numpy(p) for p in bools])[0].tolist()
    g = TSU.all_gather(mesh, [{"a": torch.from_numpy(a),
                               "b": torch.from_numpy(b)}
                              for a, b in zip(ints, bools)])[0]
    assert got["a"] == g["a"].tolist() and got["b"] == g["b"].tolist()
    assert got["wrap"] == [-(1 << 63), 0]
    whole = TSE.partitioned_state_digest(TP.partitioned_from_oracle(
        _oracle(), mesh, a_cap=1 << 8, t_cap=1 << 9))
    assert {k: int(v) for k, v in got["digest"].items()} == whole
    assert whole == TSE.partitioned_oracle_digest(_oracle(), 1 << 8, 8)


def test_two_process_smoke_on_the_cpu():
    stats = {}
    assert multihost.two_process_smoke(device="cpu", timeout=240,
                                       stats=stats) == "ok"
    # On the CPU the wrappers run their plain twins: no launch.
    assert stats["launches"] == (0, 0)
    assert all("MULTIHOST_OK" in o for o in stats["outputs"])


def test_window_graphs_refuse_a_multi_process_mesh():
    mesh = TSU.Mesh(["cpu"] * 4, process_count=2, process_index=1)
    assert mesh.size == 8 and mesh.local == (4, 5, 6, 7)
    wg = WindowGraphs(torch.device("cpu"))
    with pytest.raises(ValueError, match="several processes"):
        wg.check_mesh(mesh)
    wg.check_mesh(TSU.Mesh(["cpu"] * 8))
    router = TP.PartitionedRouter(mesh, a_cap=1 << 8, t_cap=1 << 9)
    evs = [{"id_lo": np.zeros(1, dtype=np.uint64)}] * 2
    with pytest.raises(ValueError, match="several processes"):
        router.chain_dispatch((), evs, [1, 2], n_pad=1024,
                              staged=torch.zeros((1, 2, 1024),
                                                 dtype=torch.int64),
                              graphs=wg)


def test_another_backend_raises_and_one_process_is_a_no_op(monkeypatch):
    with pytest.raises(ValueError, match="gloo"):
        TSU.Mesh(["cpu"], backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        multihost.global_mesh(2, "cpu", backend="nccl")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_multihost(device="cpu")
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        multihost.init_multihost("127.0.0.1:1", device="cpu")
    mesh = multihost.global_mesh(2, "cpu")
    assert (mesh.size, mesh.process_count, mesh.local) == (2, 1, (0, 1))
    # A collective on a mesh of several processes needs the group.
    with pytest.raises(RuntimeError, match="torch.distributed"):
        TSU.psum(TSU.Mesh(["cpu"], process_count=2, process_index=0),
                 [torch.zeros(1, dtype=torch.int64)])
