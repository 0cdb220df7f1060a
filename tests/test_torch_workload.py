"""The port's workload and auditor against the JAX package's.

`testing/workload.py` encodes each transfer's expected outcome into its
id through a reversible u128 permutation, and the auditor decodes it to
check a reply. The port's copy must give the same permutation, draw the
same batches from the same seed (packed byte for byte), and accept and
reject the same reply sets. Pure Python on both sides.
"""

import random

import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.testing import workload as J
from tigerbeetle_tpu.types import (CreateTransferResult as J_Result,
                                   CreateTransferStatus as J_Status)
from tigerbeetle_tpu_torch.oracle import StateMachineOracle
from tigerbeetle_tpu_torch.testing import workload as P
from tigerbeetle_tpu_torch.types import (CreateTransferResult as P_Result,
                                         CreateTransferStatus as P_Status)

MASK = (1 << 128) - 1
ACCOUNTS = list(range(1, 9))


def _values(seed: int, n: int = 1000) -> list:
    """n seeded u128 values, the edges among them."""
    limbs = np.random.default_rng(seed).integers(
        0, np.iinfo(np.uint64).max, size=(n, 2), dtype=np.uint64,
        endpoint=True)
    vals = [int(hi) << 64 | int(lo) for hi, lo in limbs]
    return [0, 1, 2, MASK, MASK - 1, 1 << 64, (1 << 64) - 1] + vals


@pytest.mark.parametrize("seed", [0, 1, 0xA5A5, 2**40 + 7])
def test_id_permutation_equals_the_jax_packages(seed):
    """encode and decode equal JAX's on 1,000 seeded values; decode
    inverts encode (encode never gives 0 or u128 max)."""
    jp, pp = J.IdPermutation(seed), P.IdPermutation(seed)
    assert pp.key == jp.key
    for v in _values(seed):
        e = pp.encode(v)
        assert e == jp.encode(v)
        assert pp.decode(v) == jp.decode(v)
        assert e not in (0, MASK)
        # The two values whose mix is 0 or u128 max are moved to 2 and
        # u128 max - 2; every other value decodes back.
        assert pp.decode(e) == v or e in (2, MASK ^ 2)


@pytest.mark.parametrize("seed", [1, 7, 515, 101])
def test_workload_batches_pack_the_jax_packages_bytes(seed):
    """Workload(seed): the same accounts and 20 batches (sizes drawn, and
    one of a fixed size), packed byte for byte, and the same generator
    state after them."""
    jw, pw = J.Workload(seed, ACCOUNTS), P.Workload(seed, ACCOUNTS)
    assert [a.pack() for a in pw.accounts()] == \
        [a.pack() for a in jw.accounts()]
    for i in range(20):
        size = 12 if i == 10 else None
        assert [t.pack() for t in pw.batch(size)] == \
            [t.pack() for t in jw.batch(size)]
    assert pw.prng.getstate() == jw.prng.getstate()
    assert pw._pending_open == jw._pending_open


def _replies(seed: int, batches: int = 20):
    """A workload's batches and the port oracle's replies to them."""
    w = P.Workload(seed, ACCOUNTS)
    oracle = StateMachineOracle()
    oracle.create_accounts(w.accounts(), 1000)
    ts = 10**9
    for _ in range(batches):
        ts += 10_000
        events = w.batch()
        yield events, oracle.create_transfers(events, ts)


def _verdict(auditor, events, results) -> str:
    try:
        auditor.check(events, results)
    except AssertionError as exc:
        return f"rejected: {exc}"
    return "accepted"


@pytest.mark.parametrize("seed", [3, 9])
def test_auditor_accepts_and_rejects_the_same_reply_sets(seed):
    """The oracle's replies are accepted by both auditors; every reply
    set with one status swapped for a drawn one gets the same verdict
    (and message) from both; both count the same checks."""
    rng = random.Random(seed)
    statuses = list(P_Status)
    # The workload's own permutation (Workload keys it seed ^ 0xA5A5).
    ja = J.Auditor(J.IdPermutation(seed ^ 0xA5A5))
    pa = P.Auditor(P.IdPermutation(seed ^ 0xA5A5))
    verdicts = set()
    for events, results in _replies(seed):
        jr = [J_Result(r.timestamp, J_Status(int(r.status)))
              for r in results]
        assert _verdict(pa, events, results) == "accepted"
        assert _verdict(ja, events, jr) == "accepted"
        for _ in range(4):
            k = rng.randrange(len(results))
            s = rng.choice(statuses)
            bad = list(results)
            bad[k] = P_Result(results[k].timestamp, s)
            jbad = list(jr)
            jbad[k] = J_Result(results[k].timestamp, J_Status(int(s)))
            got = _verdict(pa, events, bad)
            assert got == _verdict(ja, events, jbad)
            verdicts.add(got == "accepted")
        assert pa.checked == ja.checked
    assert verdicts == {True, False}
