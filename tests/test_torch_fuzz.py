"""The port's fuzzer registry against the JAX package's.

The registry's names, order (cfo's selection indexes it) and default
iterations equal the JAX package's; its bit-edge generator draws what
the JAX package's draws; every fuzzer runs clean on the CPU at small
iterations, those that build device state on `device="cpu"` (the plain
twins of `create_seq`, the probe and the row gather); the fuzzers whose
JAX counterparts are pure Python consume the same draws as those; and
the `device_ledger` fuzzer fails when the ledger diverges from the
oracle. The JAX package's kernel and device engines are not run: they
compile for tens of seconds.
"""

import random

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.testing import fuzz as J
from tigerbeetle_tpu_torch import constants
from tigerbeetle_tpu_torch.ops import ledger as P_ledger
from tigerbeetle_tpu_torch.testing import fuzz as P

# Small sizes (the JAX tests' where they are small): name -> (seed,
# iterations). state_machine and device_ledger at the JAX tests' own.
SMALL = {
    "ewah": (1, 20), "multi_batch": (1, 30), "superblock_quorums": (1, 15),
    "journal": (1, 6), "lsm_tree": (5, 2), "lsm_manifest_level": (1, 8),
    "state_machine": (9, 30), "client_sessions": (1, 8),
    "device_ledger": (4, 15), "durability": (1, 6), "message_bus": (1, 6),
    "storage_faults": (1, 1), "vopr_smoke": (1, 1),
}
# Fuzzers whose JAX counterparts run no JAX program.
PURE = ("ewah", "multi_batch", "superblock_quorums", "journal", "lsm_tree",
        "lsm_manifest_level", "client_sessions", "durability",
        "message_bus")


def test_registry_equals_the_jax_packages():
    assert list(P.FUZZERS) == list(J.FUZZERS)
    assert P.DEFAULT_ITERATIONS == J.DEFAULT_ITERATIONS
    assert set(SMALL) == set(P.FUZZERS)
    assert P.DEVICE_FUZZERS == {"state_machine", "device_ledger",
                                "durability", "storage_faults",
                                "vopr_smoke"}


@pytest.mark.parametrize("seed", [0, 1, 9])
@pytest.mark.parametrize("bits", [4, 8, 16, 128])
def test_int_edgy_draws_the_jax_packages_ints(seed, bits):
    jr, pr = random.Random(seed), random.Random(seed)
    got = [P.int_edgy(pr, bits) for _ in range(500)]
    assert got == [J.int_edgy(jr, bits) for _ in range(500)]
    assert all(0 <= v < 1 << bits for v in got)


@pytest.mark.parametrize("name", list(SMALL))
def test_every_fuzzer_runs_clean_on_the_cpu(name):
    seed, iterations = SMALL[name]
    was = constants.VERIFY
    P.run(name, seed, iterations, device="cpu")
    assert constants.VERIFY == was


@pytest.mark.parametrize("name", PURE)
def test_fuzzer_consumes_the_jax_packages_draws(name):
    """The same seed leaves both generators in the same state: the port's
    fuzzer drew what the JAX package's drew, call for call."""
    seed, iterations = SMALL[name]
    jr, pr = random.Random(seed), random.Random(seed)
    J.FUZZERS[name](jr, iterations)
    kw = {"device": "cpu"} if name in P.DEVICE_FUZZERS else {}
    P.FUZZERS[name](pr, iterations, **kw)
    assert pr.getstate() == jr.getstate()


def test_smoke_runs_every_fuzzer(monkeypatch):
    ran = []
    for name in P.FUZZERS:
        def fuzzer(prng, iterations, _name=name, **kw):
            ran.append((_name, iterations, kw))
        monkeypatch.setitem(P.FUZZERS, name, fuzzer)
    P.run("smoke", 3, device="cpu")
    assert [r[0] for r in ran] == list(P.FUZZERS)
    for name, iterations, kw in ran:
        assert iterations == max(1, P.DEFAULT_ITERATIONS[name] // 10)
        assert kw == ({"device": "cpu"} if name in P.DEVICE_FUZZERS else {})


def test_device_ledger_fuzzer_catches_a_flipped_status(monkeypatch):
    """A DeviceLedger that reports one status wrong, once: the fuzzer
    must raise, so it checks something."""
    real = P_ledger.DeviceLedger.create_transfers
    flipped = []

    def create_transfers(self, events, ts, *args, **kwargs):
        results = real(self, events, ts, *args, **kwargs)
        if not flipped and len(results) > 1:
            r = results[1]
            status = type(r.status)
            r.status = (status.exists if r.status != status.exists
                        else status.created)
            flipped.append(r)
        return results

    monkeypatch.setattr(P_ledger.DeviceLedger, "create_transfers",
                        create_transfers)
    with pytest.raises(AssertionError, match="ledger/oracle diverged"):
        P.run("device_ledger", 4, 15, device="cpu")
    assert flipped
