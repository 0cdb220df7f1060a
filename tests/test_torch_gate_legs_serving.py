"""Port parity: the JAX gate's serving legs, on the CPU.

The port's `testing/overload_smoke.py` and `testing/observatory_smoke.py`
at the JAX package's sizes (`device="cpu"`), held to the JAX package as
tests/test_torch_gate_legs.py holds the other legs (a file of its own
spreads the suite's load): the request builder and the class budgets
equal the JAX leg's, the admitted history equals the JAX package's
oracle on the admitted script, every negative arm goes red, and the
observatory leg's kernel calls equal `chip_smoke.gl_calls` (the
overload leg's have no prediction: a wall clock steers its shed level).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.testing import overlap_smoke as JO
from tigerbeetle_tpu.testing import overload_smoke as JOL
from tigerbeetle_tpu.utils.zipfian import ZipfianGenerator as JZipf
import chip_smoke as CS
from tigerbeetle_tpu_torch.testing import observatory_smoke as POB
from tigerbeetle_tpu_torch.testing import overlap_smoke as PO
from tigerbeetle_tpu_torch.testing import overload_smoke as POL
from tigerbeetle_tpu_torch.utils.zipfian import ZipfianGenerator as PZipf
from tests.test_torch_gate_legs import _replay, _same, leg_runner

torch.set_num_threads(1)

LEGS = {"overload": POL.overload_smoke,
        "observatory": POB.observatory_smoke}


@pytest.fixture(scope="module")
def leg():
    return leg_runner(LEGS)


def _overload_requests(smoke, zipf_cls):
    zipf = zipf_cls(smoke.SESSIONS, theta=smoke.ZIPF_THETA, seed=smoke.SEED)
    rng = np.random.default_rng(smoke.SEED)
    nid, out = 10 ** 6, []
    for r in range(3):
        reqs, nid = smoke._mk_requests(zipf, rng, r, nid)
        out += reqs
    return out


def test_overload_requests_equal_the_jax_packages():
    got = _overload_requests(POL, PZipf)
    want = _overload_requests(JOL, JZipf)
    assert [(s, c) for s, c, _ in got] == [(s, c) for s, c, _ in want]
    for (_, _, pe), (_, _, je) in zip(got, want):
        _same(pe, je)
    assert [(c.name, c.priority, c.slo_ms, c.deadline_ms)
            for c in POL.CLASSES] == [(c.name, c.priority, c.slo_ms,
                                       c.deadline_ms) for c in JOL.CLASSES]
    assert PO.STALL_CEILING == JO.STALL_CEILING


def test_a_leg_runs_with_the_ports_verify_off(monkeypatch):
    """The runner runs a leg with the port's VERIFY off, the card child's
    state, whatever an earlier test left, and restores the flag."""
    from tigerbeetle_tpu_torch import constants

    seen = []
    monkeypatch.setattr(constants, "VERIFY", True)
    run = leg_runner({"probe": lambda device: seen.append(
        constants.VERIFY)})
    run("probe")
    assert seen == [False] and constants.VERIFY is True


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


def test_overload_leg_equals_the_jax_oracle_and_its_negative_reds(leg):
    out, _ = leg("overload")
    orc = JOracle()
    hist = []
    for kind, payload, ts in out["admitted_log"]:
        if kind == "accounts":
            hist.append([(r.timestamp, int(r.status))
                         for r in orc.create_accounts(
                             [JT.Account(**dataclasses.asdict(a))
                              for a in payload], ts)])
        else:
            hist.append(_replay(orc, payload, ts))
    assert hist == out["history"]
    # Its kernels have no prediction (chip_smoke.GL_RUNS: a wall clock
    # steers its shed level), but it runs both.
    assert all(leg("overload")[1])
    cons = out["conservation"]
    assert cons["submitted"] == cons["admitted"] + cons["shed"]
    assert out["shed_classes"]
    assert set(out["classes"]["critical"]["shed"]) <= {"no_credit",
                                                       "queue_full"}
    for c in POL.CLASSES:
        assert out["classes"][c.name]["admit_wait_ms"]["p99"] <= c.slo_ms
    # The no-shed negative collapsed past the largest budget.
    assert out["negative_worst_p99_ms"] > max(c.slo_ms for c in POL.CLASSES)


def test_observatory_legs_negatives_red(leg):
    out, _ = leg("observatory")
    assert {"chain", "per_batch"} <= set(out["profiler"]["routes"])
    assert all(0 < f < float("inf")
               for f in out["profiler"]["fractions"].values())
    assert out["memwatch"]["leak_reds"] >= 1
    assert out["alerts"]["fired"] == 1
    assert out["alerts"]["resolved_tick"] is not None
