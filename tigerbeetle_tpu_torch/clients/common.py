"""Typed request helpers shared by every client stack.

Both the pure-Python client (vsr/client.py) and the native C binding
(clients/c_client.py) expose `request(operation, body) -> bytes`; these
helpers
encode/decode the operation payloads on top of it (reference: the
per-language typed wrappers over tb_client share batch encoding the same
way, src/clients/*).

A copy of the JAX package's `clients/common.py`.
"""

from __future__ import annotations

from .. import multi_batch
from ..state_machine import OPERATION_SPECS
from ..types import (
    Account,
    CreateAccountResult,
    CreateTransferResult,
    Operation,
    Transfer,
)


class ClientHelpers:
    """Mixin over a `request(operation: Operation, body: bytes) -> bytes`."""

    def create_accounts(self, accounts: list[Account]) -> list[CreateAccountResult]:
        body = multi_batch.encode([b"".join(a.pack() for a in accounts)], 128)
        out = self.request(Operation.create_accounts, body)
        (payload,) = multi_batch.decode(out, 16)
        return [CreateAccountResult.unpack(payload[i:i + 16])
                for i in range(0, len(payload), 16)]

    def create_transfers(self, transfers: list[Transfer]) -> list[CreateTransferResult]:
        body = multi_batch.encode([b"".join(t.pack() for t in transfers)], 128)
        out = self.request(Operation.create_transfers, body)
        (payload,) = multi_batch.decode(out, 16)
        return [CreateTransferResult.unpack(payload[i:i + 16])
                for i in range(0, len(payload), 16)]

    def lookup_accounts(self, ids: list[int]) -> list[Account]:
        body = multi_batch.encode(
            [b"".join(i.to_bytes(16, "little") for i in ids)], 16)
        out = self.request(Operation.lookup_accounts, body)
        (payload,) = multi_batch.decode(out, 128)
        return [Account.unpack(payload[i:i + 128])
                for i in range(0, len(payload), 128)]

    def lookup_transfers(self, ids: list[int]) -> list[Transfer]:
        body = multi_batch.encode(
            [b"".join(i.to_bytes(16, "little") for i in ids)], 16)
        out = self.request(Operation.lookup_transfers, body)
        (payload,) = multi_batch.decode(out, 128)
        return [Transfer.unpack(payload[i:i + 128])
                for i in range(0, len(payload), 128)]

    def query(self, operation: Operation, filter_obj) -> bytes:
        """Single-filter query ops; returns the raw result payload."""
        spec = OPERATION_SPECS[operation]
        body = filter_obj.pack()
        if operation.is_multi_batch():
            body = multi_batch.encode([body], spec.event_size)
        out = self.request(operation, body)
        if operation.is_multi_batch():
            (out,) = multi_batch.decode(out, spec.result_size)
        return out
