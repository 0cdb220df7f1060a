"""The port's chaos harness (`tigerbeetle_tpu_torch/testing/chaos.py`)
against the JAX package's (`tigerbeetle_tpu/testing/chaos.py`), on the
CPU.

For the gate seeds and for each traffic shape, the port's
`run_chaos_seed(seed)` must return the JAX package's summary, both with
the mesh scenarios off: the faults injected, the recoveries by cause,
the retries and the backoff, the windows replayed and the epochs
verified. Each run holds itself to a clean oracle replay (history and
device state) and fails on any silent corruption. At both defaults the
seed's generator draws whether the mesh scenarios run, in the same place
in both packages: one run of each package a seed, nothing stubbed (the
mesh scenarios recorded as they are called), shared by the module, must
give the same traffic and the same summary, for a seed that draws them
(2: the supervisor part, and shard_loss, shard_resync and reshard, names
aside) and one that does not (4). After that run, the mesh scenarios
alone for more seeds (shard_resync 2 and 10, reshard 2, 10 and 3), on
the JAX package's routers that run compiled, with their flight dumps
and a fresh router on a given mesh. The plan, the traffic shapes and
the Zipfian generator are compared draw for draw.
"""

import dataclasses
import glob
import random

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import constants as JC
from tigerbeetle_tpu.testing import chaos as JCH
from tigerbeetle_tpu.utils import zipfian as JZ
from tigerbeetle_tpu_torch import constants as TC
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU
from tigerbeetle_tpu_torch.testing import chaos as TCH
from tigerbeetle_tpu_torch.utils import zipfian as TZ
from tests.port_verify import port_verify_restored  # noqa: F401

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)


@pytest.mark.parametrize("seed, traffic", [
    (1, None), (2, None), (3, None), (7, None),
    (5, "hot_skew"), (5, "pending_storm"), (5, "open_close_burst")])
def test_chaos_seed_summary_equals_the_jax_packages(seed, traffic):
    was_t, was_j = TC.VERIFY, JC.VERIFY
    got = TCH.run_chaos_seed(seed, traffic=traffic, mesh_scenario=False,
                             device="cpu")
    want = JCH.run_chaos_seed(seed, traffic=traffic, mesh_scenario=False)
    assert got == want
    # VERIFY is restored, and the port read no environment variable for
    # the spot rate (the JAX run set and restored its own).
    assert (TC.VERIFY, JC.VERIFY) == (was_t, was_j)
    if set(got["faults"]) & TCH.CORRUPTION_KINDS:
        assert sum(got["recoveries"].values()) >= 1


MESH_KEYS = ("shard_loss", "shard_resync", "reshard")


@pytest.fixture(scope="module")
def default_runs():
    """`run_chaos_seed(seed)` at its defaults, once a seed in each
    package, nothing stubbed: every generated batch and every call of a
    mesh scenario recorded (the call goes through)."""
    runs = {}

    def run(seed):
        if seed in runs:
            return runs[seed]
        traffic = {TCH: [], JCH: []}
        called = {TCH: [], JCH: []}
        with pytest.MonkeyPatch.context() as mp:
            for mod in (TCH, JCH):
                def recording(*args, _gen=mod._chaos_workload,
                              _log=traffic[mod]):
                    events, nid = _gen(*args)
                    _log.append([dataclasses.asdict(e) for e in events])
                    return events, nid
                mp.setattr(mod, "_chaos_workload", recording)
                for name in ("shard_loss_scenario", "shard_resync_scenario",
                             "reshard_chaos_scenario"):
                    def through(s, *a, _fn=getattr(mod, name), _n=name,
                                _log=called[mod], **k):
                        _log.append((_n, s))
                        return _fn(s, *a, **k)
                    mp.setattr(mod, name, through)
            got = TCH.run_chaos_seed(seed, device="cpu")
            want = JCH.run_chaos_seed(seed)
        runs[seed] = dict(got=got, want=want, traffic=traffic,
                          called=called)
        return runs[seed]

    return run


def _no_names(summary: dict) -> dict:
    return {k: v for k, v in summary.items()
            if k not in ("dropped", "flight_dump")}


@pytest.mark.parametrize("seed, draws", [(4, False), (2, True)])
def test_default_seed_draws_the_mesh_scenario_as_the_jax_package(
        seed, draws, default_runs):
    """Both at their defaults: the same mesh draw from the seed's
    generator, so the same traffic (every generated batch recorded) and
    the same supervisor summary; a seed that draws the mesh scenarios
    returns `reshard` equal to the JAX package's."""
    run = default_runs(seed)
    got, want, traffic = run["got"], run["want"], run["traffic"]
    assert traffic[TCH] == traffic[JCH] and traffic[TCH]
    assert run["called"][JCH] == run["called"][TCH] == (
        [("shard_loss_scenario", seed), ("shard_resync_scenario", seed),
         ("reshard_chaos_scenario", seed)] if draws else [])
    assert set(want) & set(MESH_KEYS) == (set(MESH_KEYS) if draws
                                          else set())
    assert {k: v for k, v in got.items() if k not in MESH_KEYS} == \
        {k: v for k, v in want.items() if k not in MESH_KEYS}
    if draws:
        assert got["shard_loss"] == {"devices": 8, "dropped": "cpu",
                                     "reroutes": 2}
        assert got["reshard"] == want["reshard"]
        assert got["reshard"]["aborts"] == 6
    else:
        assert "shard_loss" not in got and "reshard" not in got


def test_mesh_seed_returns_shard_loss_and_shard_resync(default_runs,
                                                       monkeypatch):
    """A default seed that draws the mesh scenario (2) runs shard_loss,
    shard_resync and reshard in both packages, each equal to the JAX
    package's, names aside; the supervisor part is compared above."""
    run = default_runs(2)
    got, want = run["got"], run["want"]
    assert set(got) == set(want) and set(MESH_KEYS) <= set(got)
    for key in MESH_KEYS:
        assert _no_names(got[key]) == _no_names(want[key]), key
    assert got["shard_resync"]["resyncs"] == 1
    assert got["reshard"]["devices"] == 2
    monkeypatch.setattr(TCH, "_run_supervisor_chaos", lambda *a, **k: {})
    assert not TCH.run_chaos_seed(4, device="cpu")


# The mesh scenarios alone, for more seeds. The JAX package's cached
# routers (`_PART_ROUTER` on its 8 host devices, `_RESHARD_ROUTER` on 2)
# are the ones its seed-2 run above compiled; they come back to base
# ownership after each scenario.

@pytest.mark.parametrize("seed", [2, 10])
def test_shard_resync_scenario_equals_the_jax_packages(seed, tmp_path):
    """The port's shard_resync_scenario equals the JAX package's (the
    dropped device's and the flight dump's names aside)."""
    got = TCH.shard_resync_scenario(seed, device="cpu",
                                    flight_dir=str(tmp_path))
    want = JCH.shard_resync_scenario(seed)
    assert _no_names(got) == _no_names(want)
    assert got["resyncs"] == 1 and got["devices"] == 8
    assert got["flight_dump"].startswith("FLIGHT_0_shard_loss_quarantine_")
    assert (tmp_path / got["flight_dump"]).exists()
    # A given mesh gets a fresh router.
    two = TCH.shard_resync_scenario(seed, mesh=TSU.Mesh(["cpu"] * 2),
                                    flight_dir=str(tmp_path))
    assert two["devices"] == 2 and two["resyncs"] == 1


@pytest.mark.parametrize("seed", [2, 10, 3])
def test_reshard_chaos_scenario_equals_the_jax_packages(seed, tmp_path):
    got = TCH.reshard_chaos_scenario(seed, device="cpu",
                                     flight_dir=str(tmp_path))
    want = JCH.reshard_chaos_scenario(seed)
    assert got == want
    assert got["aborts"] == got["artifacts"] == 6
    assert len(glob.glob(str(tmp_path / "FLIGHT_*_reshard_*"))) == 6
    # The cached router comes back with base ownership; a given mesh gets
    # a fresh router.
    routers = [r for k, r in TCH._RESHARD_ROUTERS.items()
               if k == ("cpu", str(tmp_path))]
    assert routers and routers[0].ownership.entries == ()
    assert TCH.reshard_chaos_scenario(seed, mesh=TSU.Mesh(["cpu"] * 2)) \
        == got


@pytest.mark.parametrize("seed", [2])
def test_mesh_seed_reshard_runs_through_the_supervisor_chaos(seed,
                                                           default_runs):
    """The port's default chaos seed that draws the mesh scenario returns
    `reshard` beside `shard_loss` and `shard_resync` (the module's one
    run of the seed)."""
    got = default_runs(seed)["got"]
    assert {"shard_loss", "shard_resync", "reshard"} <= set(got)
    assert got["reshard"]["aborts"] == 6
    assert got["reshard"]["migrations"] == 1


@pytest.mark.parametrize("seed", range(12))
def test_fault_plan_equals_the_jax_packages(seed):
    t = TCH.FaultPlan(seed, 8)
    j = JCH.FaultPlan(seed, 8)
    assert t.schedule == j.schedule
    assert t.summary() == j.summary()
    assert TCH.FAULT_KINDS == JCH.FAULT_KINDS
    assert TCH.CORRUPTION_KINDS == JCH.CORRUPTION_KINDS
    assert TCH.CORRUPTION_KINDS <= set(TCH.FAULT_KINDS)


def test_every_kind_appears_across_seeds():
    seen = set()
    for seed in range(12):
        seen.update(f["kind"] for f in TCH.FaultPlan(seed, 8)
                    .schedule.values())
    assert seen == set(TCH.FAULT_KINDS)


@pytest.mark.parametrize("shape", TCH.TRAFFIC_SHAPES)
def test_traffic_shapes_generate_the_jax_packages_events(shape):
    out = []
    for mod in (TCH, JCH):
        gen = mod.TrafficShape(shape, 9, 16, 8)
        rng, nid, pend, evs = random.Random(9), 1_000, [], []
        for w in range(8):
            batch, nid = gen.batch(w, rng, nid, 48, pend)
            evs.append([dataclasses.asdict(e) for e in batch])
        out.append((evs, list(pend)))
    assert out[0] == out[1]
    base_rng = random.Random(4)
    t_evs, _ = TCH._chaos_workload(base_rng, 16, 1_000, 64, [])
    base_rng = random.Random(4)
    j_evs, _ = JCH._chaos_workload(base_rng, 16, 1_000, 64, [])
    assert ([dataclasses.asdict(e) for e in t_evs]
            == [dataclasses.asdict(e) for e in j_evs])


@pytest.mark.parametrize("n, theta, seed", [(16, 1.2, 3), (100_000, 1.1, 83),
                                            (1000, 0.99, 0)])
def test_zipfian_draws_equal(n, theta, seed):
    t = TZ.ZipfianGenerator(n, theta=theta, seed=seed)
    j = JZ.ZipfianGenerator(n, theta=theta, seed=seed)
    for count in (1, 7, 500):
        np.testing.assert_array_equal(t.draw(count), j.draw(count))
    np.testing.assert_array_equal(t.grow(2 * n).draw(64),
                                  j.grow(2 * n).draw(64))


def test_bitflip_injection_is_in_place_and_skips_empty_stores():
    """The port's injector XORs the int64 carrier in place (the storage a
    captured window graph reads stays put) and reports nothing to flip
    on an empty store."""
    from tigerbeetle_tpu_torch.ops.ledger import DeviceLedger
    from tigerbeetle_tpu_torch.types import Account

    led = DeviceLedger(a_cap=1 << 6, t_cap=1 << 8, device="cpu")
    f = {"target": "transfers_u64", "row_pick": 1, "col_pick": 2, "bit": 63}
    assert not TCH.inject_state_bitflip(led, f)
    led.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in (1, 2, 3)], 10)
    u64 = led.state["accounts"]["u64"]
    ptr, before = u64.data_ptr(), u64.clone()
    f = {"target": "accounts_u64", "row_pick": 4, "col_pick": 0, "bit": 63}
    assert TCH.inject_state_bitflip(led, f)
    assert led.state["accounts"]["u64"] is u64 and u64.data_ptr() == ptr
    flipped = (u64 ^ before).nonzero().tolist()
    assert flipped == [[1, 0]]             # row 4 % 3 live rows
    assert int((u64 ^ before)[1, 0]) == -(1 << 63)   # bit 63, as int64


def test_gate_main_runs_the_single_chip_seeds(capsys):
    assert TCH.gate_main(seeds=(3,), device="cpu") == 0
    assert "[chaos] seed 3 ok" in capsys.readouterr().out
