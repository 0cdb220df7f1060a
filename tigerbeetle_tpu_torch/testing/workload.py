"""Workload/Auditor: verifiable random workloads with id-encoded outcomes.

reference: src/testing/id.zig:9 (IdPermutation — a reversible permutation
so ids look random on the wire but decode back to structured metadata) +
src/state_machine/workload.zig:1-18 and auditor.zig:1-38 (the expected
outcome of every event is encoded INTO its id, so any reply can be audited
in O(1) memory per in-flight request — no expectations table).

The permutation here is a 128-bit Feistel-free mix: multiply by an odd
constant mod 2^128 (invertible via the modular inverse) then XOR-fold.

A copy of the JAX package's `testing/workload.py` on the port's types: it
draws from `random.Random` call for call as that module does, so one seed
gives the same batches, ids and expectations in both packages.
"""

from __future__ import annotations

import enum
import random
from typing import Optional

from ..types import Account, CreateTransferStatus, Transfer, TransferFlags

_M = 0x9E3779B97F4A7C15F39CC0605CEDC835  # odd: invertible mod 2^128
_M_INV = pow(_M, -1, 1 << 128)
_MASK = (1 << 128) - 1


class IdPermutation:
    """Reversible u128 permutation keyed by a seed."""

    def __init__(self, seed: int):
        self.key = random.Random(seed).getrandbits(128) | 1

    def encode(self, value: int) -> int:
        x = (value ^ self.key) & _MASK
        x = (x * _M) & _MASK
        x ^= x >> 64
        return x if x not in (0, _MASK) else (x ^ 2)

    def decode(self, id_: int) -> int:
        x = id_
        x ^= x >> 64
        x = (x * _M_INV) & _MASK
        return (x ^ self.key) & _MASK


class Expect(enum.IntEnum):
    """Outcome class baked into each transfer id (low tag bits)."""

    created = 0
    debit_account_not_found = 1
    credit_account_not_found = 2
    accounts_must_be_different = 3
    ledger_must_not_be_zero = 4
    exceeds_pending = 5  # post amount above the pending amount

    @property
    def statuses(self) -> set:
        S = CreateTransferStatus
        return {
            Expect.created: {S.created, S.exists},
            Expect.debit_account_not_found: {S.debit_account_not_found,
                                             S.id_already_failed},
            Expect.credit_account_not_found: {S.credit_account_not_found,
                                              S.id_already_failed},
            Expect.accounts_must_be_different: {S.accounts_must_be_different},
            Expect.ledger_must_not_be_zero: {S.ledger_must_not_be_zero},
            Expect.exceeds_pending: {S.exceeds_pending_transfer_amount,
                                     S.id_already_failed},
        }[self]


_TAG_BITS = 4


class Workload:
    """Generates transfer batches whose ids carry their expected outcome."""

    def __init__(self, seed: int, account_ids: list[int], ledger: int = 1):
        self.prng = random.Random(seed)
        self.permutation = IdPermutation(seed ^ 0xA5A5)
        self.account_ids = account_ids
        self.ledger = ledger
        self.sequence = 0
        # (id, amount, timeout) of open pendings; success-expectation
        # resolutions only target UNTIMED ones — a timed pending can
        # legitimately expire mid-soak (sim time advances ~600 s per
        # chaos step), flipping the post to pending_transfer_expired.
        self._pending_open: list[tuple[int, int, int]] = []

    def accounts(self) -> list[Account]:
        return [Account(id=i, ledger=self.ledger, code=1)
                for i in self.account_ids]

    def _next_id(self, expect: Expect) -> int:
        self.sequence += 1
        return self.permutation.encode(
            (self.sequence << _TAG_BITS) | int(expect))

    def batch(self, size: Optional[int] = None) -> list[Transfer]:
        prng = self.prng
        out: list[Transfer] = []
        for _ in range(size or prng.randrange(1, 10)):
            dr = prng.choice(self.account_ids)
            cr = prng.choice([a for a in self.account_ids if a != dr])
            amount = prng.randrange(1, 1000)
            roll = prng.random()
            if roll < 0.60:
                flags = 0
                timeout = 0
                if prng.random() < 0.2:
                    flags = int(TransferFlags.pending)
                    timeout = prng.choice((0, 3600))
                tid = self._next_id(Expect.created)
                out.append(Transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=self.ledger, code=1,
                    flags=flags, timeout=timeout))
                if flags:
                    self._pending_open.append((tid, amount, timeout))
            elif roll < 0.70:
                out.append(Transfer(
                    id=self._next_id(Expect.debit_account_not_found),
                    debit_account_id=max(self.account_ids) + 777,
                    credit_account_id=cr, amount=amount,
                    ledger=self.ledger, code=1))
            elif roll < 0.80:
                out.append(Transfer(
                    id=self._next_id(Expect.credit_account_not_found),
                    debit_account_id=dr,
                    credit_account_id=max(self.account_ids) + 778,
                    amount=amount, ledger=self.ledger, code=1))
            elif roll < 0.88:
                out.append(Transfer(
                    id=self._next_id(Expect.accounts_must_be_different),
                    debit_account_id=dr, credit_account_id=dr,
                    amount=amount, ledger=self.ledger, code=1))
            elif roll < 0.94:
                out.append(Transfer(
                    id=self._next_id(Expect.ledger_must_not_be_zero),
                    debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=0, code=1))
            elif self._pending_open:
                sub = prng.random()
                untimed = [i for i, (_, _, to) in
                           enumerate(self._pending_open) if to == 0]
                if sub < 0.4 or not untimed:
                    # Post above the pending amount: must fail — and is
                    # expiry-immune (the amount check precedes the
                    # expiry check in both engines), so timed pendings
                    # are safe targets here.
                    pid, p_amount, _ = self._pending_open.pop(
                        prng.randrange(len(self._pending_open)))
                    out.append(Transfer(
                        id=self._next_id(Expect.exceeds_pending),
                        pending_id=pid, amount=p_amount + 1,
                        flags=int(TransferFlags.post_pending_transfer)))
                elif sub < 0.7:
                    # Successful (possibly partial) post of an UNTIMED
                    # pending — when it was created EARLIER IN THIS
                    # SAME BATCH this exercises the kernel's in-window
                    # pending resolution under the swarm.
                    pid, p_amount, _ = self._pending_open.pop(
                        untimed[prng.randrange(len(untimed))])
                    out.append(Transfer(
                        id=self._next_id(Expect.created),
                        pending_id=pid,
                        amount=prng.randrange(0, p_amount + 1),
                        flags=int(TransferFlags.post_pending_transfer)))
                else:
                    # Successful void (amount 0 = full-amount sentinel).
                    pid, _, _ = self._pending_open.pop(
                        untimed[prng.randrange(len(untimed))])
                    out.append(Transfer(
                        id=self._next_id(Expect.created),
                        pending_id=pid, amount=0,
                        flags=int(TransferFlags.void_pending_transfer)))
            else:
                out.append(Transfer(
                    id=self._next_id(Expect.created),
                    debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=self.ledger, code=1))
        return out


class Auditor:
    """Checks replies against the expectation decoded from each id —
    stateless beyond the permutation (reference: auditor.zig O(1) memory)."""

    def __init__(self, permutation: IdPermutation):
        self.permutation = permutation
        self.checked = 0

    def check(self, events: list[Transfer], results) -> None:
        assert len(events) == len(results)
        for event, result in zip(events, results):
            decoded = self.permutation.decode(event.id)
            expect = Expect(decoded & ((1 << _TAG_BITS) - 1))
            # A linked/chain outcome never appears here (the workload emits
            # no chains); retried requests may surface `exists`.
            assert result.status in expect.statuses, (
                f"id {event.id:#x} expected {expect.name}, "
                f"got {result.status.name}")
            self.checked += 1
