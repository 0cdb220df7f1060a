"""Port parity: the JAX gate's device legs, on the CPU.

The port's `tigerbeetle_tpu_torch/testing/` chain, partitioned_chain,
overlap, reshard and telemetry smokes at the JAX package's sizes
(`device="cpu"`; the overload and observatory legs in
tests/test_torch_gate_legs_serving.py), held to the JAX package:

- each leg's traffic builder and the JAX leg's, fed the same seed, build
  the same events (numpy and types, no JAX program);
- each leg's history and digests equal the JAX package's pure-Python
  oracle on that traffic (no JAX leg runs here: the reshard leg with the
  JAX controller in lockstep is tests/test_torch_resharding.py's);
- every negative arm goes red;
- the kernels each leg calls equal `chip_smoke.gl_calls`, the card's
  prediction;
- the timing predicates only where they are deterministic: the
  forced-sync staging arm at exactly 1.0.

Each leg runs once in this module (a module-scoped fixture), its kernel
wrappers' calls counted.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu.ops import state_epoch as JSE
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.testing import chain_smoke as JC
from tigerbeetle_tpu.testing import overlap_smoke as JO
from tigerbeetle_tpu.testing import partitioned_chain_smoke as JPC
from tigerbeetle_tpu.testing import reshard_smoke as JRS
from tigerbeetle_tpu.testing import telemetry_smoke as JTS
import chip_smoke as CS
from tigerbeetle_tpu_torch.testing import chain_smoke as PC
from tigerbeetle_tpu_torch.testing import overlap_smoke as PO
from tigerbeetle_tpu_torch.testing import partitioned_chain_smoke as PPC
from tigerbeetle_tpu_torch.testing import reshard_smoke as PRS
from tigerbeetle_tpu_torch.testing import telemetry_smoke as PTS
from tigerbeetle_tpu_torch.torchhound import core, opbudget
from tests.port_verify import verify_off

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

LEGS = {"chain": PC.chain_smoke,
        "partitioned_chain": PPC.partitioned_chain_smoke,
        "overlap": PO.overlap_smoke,
        "telemetry": PTS.telemetry_smoke}


def leg_runner(legs: dict):
    """name -> (the leg's summary on the CPU, its (probe, row gather)
    kernel calls as `chip_smoke.KernelCalls` counts them), each leg of
    `legs` run once, when first asked for, with the port's VERIFY off as
    in the card's child process (the flag is process-global, and an
    earlier test in the same worker may have left it on: the port's
    simulated Cluster turns it on, and a VERIFY drain audit adds a probe
    and a gather)."""
    runs = {}

    def get(name):
        if name not in runs:
            with verify_off(), CS.KernelCalls() as kc:
                summary = legs[name]("cpu")
            runs[name] = (summary, tuple(kc.calls))
        return runs[name]

    return get


@pytest.fixture(scope="module")
def leg():
    return leg_runner(LEGS)


def _jax(transfers):
    """Port Transfer objects -> the JAX package's."""
    return [JT.Transfer(**dataclasses.asdict(t)) for t in transfers]


def _same(port_objs, jax_objs):
    assert [dataclasses.asdict(t) for t in port_objs] == \
        [dataclasses.asdict(t) for t in jax_objs]


def _replay(orc, batches, tss):
    return [[(r.timestamp, int(r.status))
             for r in orc.create_transfers(_jax(b), t)]
            for b, t in zip(batches, tss)]


# ------------------------------------------------------ traffic builders

def _chain_windows(smoke):
    rng = np.random.default_rng(smoke.CLUSTER_SEED)
    return [smoke._windows(rng, 3, poison_window=p,
                           base=(1 + (p or 0)) * 10 ** 6) for p in (None, 1)]


def _pchain_windows(smoke, n):
    return smoke._windows(np.random.default_rng(smoke.SEED), n)


def _telemetry_prepares(smoke, n):
    from tigerbeetle_tpu.types import TransferFlags as JTF

    wb = smoke._WindowBuilder(np.random.default_rng(smoke.SEED), n)
    p0, _ = wb.prepare(flags=int(JTF.pending))
    out = [p0, wb.prepare()[0], wb.closes(p0)[0]]
    out += [wb.prepare(poison=(b == 1))[0] for b in range(3)]
    return out + [[], [(wb.nid, wb.ts)]]


def _reshard_windows(smoke):
    rng = np.random.default_rng(smoke.SEED + 2)
    nid, ts = [10 ** 6], [10 ** 9]
    return [smoke._window(rng, nid, ts) for _ in range(4)]


def _flat(obj):
    """Nested lists / tuples of Transfer objects -> plain data."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if isinstance(obj, (list, tuple)):
        return [_flat(x) for x in obj]
    return obj


@pytest.mark.parametrize("name,build", [
    ("chain", lambda m: _chain_windows(m)),
    ("partitioned_chain_1", lambda m: _pchain_windows(m, 1)),
    ("partitioned_chain_8", lambda m: _pchain_windows(m, 8)),
    ("overlap", lambda m: m._mk_windows(np.random.default_rng(m.SEED))),
    ("telemetry_1", lambda m: _telemetry_prepares(m, 1)),
    ("telemetry_2", lambda m: _telemetry_prepares(m, 2)),
    ("telemetry_8", lambda m: _telemetry_prepares(m, 8)),
    ("reshard", lambda m: _reshard_windows(m)),
])
def test_traffic_builders_equal_the_jax_packages(name, build):
    port = {"chain": PC, "partitioned_chain": PPC, "overlap": PO,
            "telemetry": PTS, "reshard": PRS}
    jax = {"chain": JC, "partitioned_chain": JPC, "overlap": JO,
           "telemetry": JTS, "reshard": JRS}
    key = name.rsplit("_", 1)[0] if name[-1].isdigit() else name
    assert _flat(build(port[key])) == _flat(build(jax[key]))


# ------------------------------------------------------------- the legs

@pytest.mark.parametrize(
    "name", [n for n in sorted(LEGS) if n in CS.GL_RUNS or n in CS.GL_PAIRS])
def test_each_legs_kernel_calls_are_the_cards_prediction(leg, name):
    """The CPU's calls are the card's prediction; an overhead leg's at the
    pairs the CPU times, and the card's pairs are its module's."""
    pairs = None
    if name in CS.GL_PAIRS:
        mod = LEGS[name].__module__
        mod = __import__(mod, fromlist=["OVERHEAD_PAIRS"])
        assert mod.OVERHEAD_PAIRS == CS.GL_PAIRS[name]
        pairs = mod.OVERHEAD_PAIRS_UNTIMED
    assert leg(name)[1] == CS.gl_calls(name, pairs)


def test_chain_leg_equals_the_jax_oracle(leg):
    out, _ = leg("chain")
    for arm, (windows) in zip(("clean", "poisoned"), _chain_windows(PC)):
        orc = JOracle()
        orc.create_accounts([JT.Account(id=i, ledger=1, code=1)
                             for i in range(1, 65)], 120)
        want = [_replay(orc, evs, tss) for evs, tss in windows]
        got = [[list(zip(ts, st)) for st, ts in w]
               for w in out[arm]["history"]]
        assert got == want
        assert out[arm]["pipelined"]["routes"]["windows"]["chain"] >= 1
    assert out["clean"]["pipelined"]["host_fallbacks"] == 0
    assert out["poisoned"]["pipelined"]["routes"]["chain_batch_fallbacks"][
        "e2_collision"] >= 1


def test_chain_legs_budget_check_reds_a_heavier_body():
    with open(core.newest_budget_path()) as f:
        budget = json.load(f)["budget"]
    PC.check_budget(budget)
    heavy = dict(budget, chain_body_w8=dict(
        budget["chain_body_w8"],
        heavy_total=budget["plain"]["heavy_total"] + 1))
    with pytest.raises(AssertionError, match="chain body"):
        PC.check_budget(heavy)
    with pytest.raises(AssertionError, match="lacks chain_w8"):
        PC.check_budget({k: v for k, v in budget.items() if k != "chain_w8"})


def test_partitioned_chain_leg_equals_the_jax_oracle(leg):
    out, _ = leg("partitioned_chain")
    for n in (1, 8):
        flags = int(JT.AccountFlags.debits_must_not_exceed_credits)
        orc = JOracle()
        orc.create_accounts([JT.Account(id=i, ledger=1, code=1,
                                        flags=flags if i <= 4 else 0)
                             for i in range(1, 41)], 50)
        want = []
        for evs, tss in _pchain_windows(PPC, n):
            want += _replay(orc, evs, tss)
        assert out[n]["history"] == want
        assert out[n]["digest"] == JSE.partitioned_oracle_digest(
            orc, PPC.A_CAP, n)
        assert out[n]["host_fallbacks"] == (0, 0)
        assert out[n]["chain_batch_fallbacks"]["e3_limit"] >= 1
    assert out[8]["cross_shard_transfers"] > 0


def test_partitioned_chain_legs_budget_check_reds_a_heavier_body():
    with open(core.newest_budget_path()) as f:
        budget = json.load(f)["budget"]
    PPC.check_budget(budget)
    body = budget["partitioned_chain_body"]
    grown = dict(body, heavy_total=body["heavy_total"] + 1,
                 heavy=dict(body["heavy"], gather=body["heavy"]["gather"] + 1))
    with pytest.raises(AssertionError):
        PPC.check_budget(dict(budget, partitioned_chain_body=grown))


def test_overlap_leg_equals_the_jax_oracle_and_its_sync_arm_reds(leg):
    out, _ = leg("overlap")
    flags = int(JT.AccountFlags.debits_must_not_exceed_credits)
    orc = JOracle()
    orc.create_accounts([JT.Account(id=i, ledger=1, code=1,
                                    flags=flags if i <= 4 else 0)
                         for i in range(1, PO.N_ACCOUNTS + 1)],
                        PO.N_ACCOUNTS + 10)
    want = [_replay(orc, b, t)
            for b, t in PO._mk_windows(np.random.default_rng(PO.SEED))]
    assert out["history"] == want
    # The forced-sync arm: exactly 1.0, failing the predicate.
    assert out["sync_fraction"] == 1.0
    assert not (out["sync_fraction"] < PO.STALL_CEILING)
    assert out["sync_staging"]["staged"] == 0
    assert out["staging"]["staged"] >= PO.WINDOWS - 1
    part = out["partitioned"]
    porc = JOracle()
    porc.create_accounts([JT.Account(id=i, ledger=1, code=1)
                          for i in range(1, 41)], 50)
    pwant = []
    for b, t in PO._partitioned_windows(np.random.default_rng(PO.SEED + 1)):
        pwant.append(_replay(porc, b, t))
    assert part["history"] == pwant
    assert part["digest"] == JSE.partitioned_oracle_digest(
        porc, PO.A_CAP, PO.PART_SHARDS)
    assert part["staging"][1]["host_stall_fraction"] == 1.0


def test_telemetry_leg_decodes_the_jax_hosts_words_and_the_grown_pack_reds(
        leg):
    out, _ = leg("telemetry")
    assert out["census"]["lanes"] == 12 and out["census"]["sites"] >= 1
    assert any("lanes 13" in r for r in out["negative_reds"])
    assert set(out["decode"]) == {1, 2, 8}
    assert all(d["fix_rounds"] >= 1 for d in out["decode"].values())
    # The host recomputation the decode is held to is the JAX package's.
    for n in (1, 2, 8):
        prepares = _telemetry_prepares(PTS, n)[:6]
        live = {p.id: (p.debit_account_id, p.credit_account_id)
                for p in prepares[0]}
        for evs in prepares:
            created = {int(e.id) for e in evs[::2]}
            assert PTS._expected_words(evs, live, 16, n, created) == \
                JTS._expected_words(_jax(evs), live, 16, n, created)


def test_the_grown_telemetry_pack_reds_the_budget_check():
    from tigerbeetle_tpu_torch.parallel.partitioned import (TEL_WORDS,
                                                            _telemetry_pack)

    words = [torch.full((), i, dtype=torch.int64) for i in range(TEL_WORDS)]
    real = core.telemetry_census(core.trace(
        lambda: _telemetry_pack(*words, device=torch.device("cpu"))))
    grown = core.telemetry_census(core.trace(
        lambda: _telemetry_pack(*words, words[0],
                                device=torch.device("cpu"))))
    assert (real["lanes"], grown["lanes"]) == (12, 13)
    report = {"pack_sites": 1, "chain_body_heavy_delta": 0}
    assert opbudget.check_telemetry(
        dict(report, lanes=real["lanes"], pack_ops=real["ops"])) == []
    reds = opbudget.check_telemetry(
        dict(report, lanes=grown["lanes"], pack_ops=grown["ops"]))
    assert any("lanes 13 != committed 12" in r for r in reds)
    assert any("dead telemetry plane" in r for r in opbudget.check_telemetry(
        dict(report, lanes=12, pack_ops=0, pack_sites=0)))
