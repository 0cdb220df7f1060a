"""The port's native C client (`tigerbeetle_tpu_torch/clients/c_client.py`
over `csrc/tb_client.cpp`, built by g++ at first use) on the CPU.

- Echo mode: bodies of 0 B to 64 KiB come back unchanged, many packets in
  a row, close twice.
- Against `python -m tigerbeetle_tpu_torch start --platform=cpu --small`
  on the oracle and the device engine: the C client and the port's
  pure-Python `vsr/client.Client` send the same requests, each on ids of
  its own (accounts, a body of transfers with failing events, two-phase
  transfers, lookups); every create reply's statuses equal, every lookup
  reply equal byte for byte (both look up both clients' ids).
- The port's `CClient` against the JAX package's `CClient` (over
  native/tb_client.cpp, built here by g++ into a temporary directory):
  echo replies equal; on the same server each sends the same requests on
  ids of its own, every create reply equal byte for byte with the
  timestamps zeroed, every lookup reply equal byte for byte.
- The C++ example (clients/cpp/example.cpp) builds against the port's
  csrc/tb_client.cpp and passes its echo run.

Skipped, as the JAX package's tests/test_tb_client.py is, where g++ is
missing.
"""

import ctypes
import os
import shutil
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from tigerbeetle_tpu_torch import multi_batch
from tigerbeetle_tpu_torch.clients import CClient, c_client_available
from tigerbeetle_tpu_torch.types import (Account, AccountFlags, Operation,
                                         Transfer, TransferFlags)
from tigerbeetle_tpu_torch.vsr.client import Client

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _native_client():
    """Decided when the module's first test runs, not at collection: the
    library is built with g++ then (atomically), and only a host without
    the toolchain skips."""
    if not c_client_available():
        pytest.skip("native toolchain unavailable")

OFFSET = 1_000_000   # the pure-Python client's ids: the C client's + this


@pytest.fixture(scope="module")
def jax_client(tmp_path_factory):
    """The JAX package's `CClient`, its `native.load_client` returning
    native/tb_client.cpp built into a temporary directory (the JAX
    package's own build writes native/, where its tests build too)."""
    from tigerbeetle_tpu import native
    from tigerbeetle_tpu.clients.c_client import CClient as JaxCClient

    lib = tmp_path_factory.mktemp("jax_tb_client") / "libtb_client.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-pthread", "-o",
                    str(lib), str(REPO / "native" / "tb_client.cpp")],
                   check=True, capture_output=True, timeout=300)
    cdll = ctypes.CDLL(str(lib))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "load_client", lambda: cdll)
        yield JaxCClient


class TestEcho:
    def test_echo_roundtrip(self):
        client = CClient(cluster=1, replica_addresses=[], echo=True)
        try:
            for size in (0, 1, 128, 64 * 1024):
                body = os.urandom(size)
                assert client.request(Operation.create_transfers, body) == body
        finally:
            client.close()

    def test_echo_many_packets(self):
        client = CClient(cluster=1, replica_addresses=[], echo=True)
        try:
            bodies = [os.urandom(64) for _ in range(50)]
            for body in bodies:
                assert client.request(Operation.lookup_accounts, body) == body
        finally:
            client.close()

    def test_echo_equals_the_jax_packages(self, jax_client):
        ours = CClient(cluster=1, replica_addresses=[], echo=True)
        theirs = jax_client(cluster=1, replica_addresses=[], echo=True)
        try:
            for size in (0, 1, 128, 64 * 1024):
                body = os.urandom(size)
                got = ours.request(Operation.create_transfers, body)
                want = theirs.request(Operation.create_transfers, body)
                assert got == want == body
        finally:
            ours.close()
            theirs.close()

    def test_shutdown_clean(self):
        client = CClient(cluster=1, replica_addresses=[], echo=True)
        client.close()
        client.close()  # idempotent


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module", params=["oracle", "device"])
def server(request, tmp_path_factory):
    """A port server on the CPU, the small layout, the given engine."""
    path = str(tmp_path_factory.mktemp(request.param) / "0_0.tigerbeetle")
    subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "format",
         "--cluster=9", "--replica=0", "--replica-count=1", "--small", path],
        check=True, cwd=str(REPO), timeout=120, stdout=subprocess.DEVNULL)
    port = _port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         f"--addresses=127.0.0.1:{port}", "--replica=0", "--cluster=9",
         "--platform=cpu", f"--engine={request.param}", "--small", path],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = ""
        while "listening" not in line:
            line = proc.stdout.readline()
            assert line, "the server exited before listening"
        yield port
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out


def _shift(obj, d: int):
    """The same event on ids d higher (account, transfer and pending)."""
    import dataclasses

    fields = {f: getattr(obj, f) + d for f in (
        "id", "debit_account_id", "credit_account_id", "pending_id")
        if hasattr(obj, f) and getattr(obj, f)}
    return dataclasses.replace(obj, **fields)


def _requests():
    limit = int(AccountFlags.debits_must_not_exceed_credits)
    accounts = [Account(id=i, ledger=700, code=10,
                        flags=limit if i % 4 == 0 else 0)
                for i in range(1, 13)]
    plain = [Transfer(id=100 + k, debit_account_id=1 + k % 12,
                      credit_account_id=1 + (k * 5 + 1) % 12,
                      amount=1 + k, ledger=700, code=10)
             for k in range(40)]
    plain.append(Transfer(id=150, debit_account_id=1, credit_account_id=99,
                          amount=1, ledger=700, code=10))  # no account
    plain.append(Transfer(id=100, debit_account_id=1, credit_account_id=2,
                          amount=1, ledger=700, code=10))  # exists
    pending = [Transfer(id=200 + k, debit_account_id=1 + k,
                        credit_account_id=2 + k, amount=10, ledger=700,
                        code=10, flags=int(TransferFlags.pending))
               for k in range(6)]
    resolve = [Transfer(id=300 + k, pending_id=200 + k, amount=0 if k % 2
                        else 10, ledger=700, code=10,
                        flags=int(TransferFlags.void_pending_transfer
                                  if k % 2 else
                                  TransferFlags.post_pending_transfer))
               for k in range(6)]
    return [("create_accounts", accounts), ("create_transfers", plain),
            ("create_transfers", pending), ("create_transfers", resolve)]


def _ids_body(ids) -> bytes:
    return multi_batch.encode(
        [b"".join(i.to_bytes(16, "little") for i in ids)], 16)


def test_c_client_replies_equal_the_python_clients(server):
    c = CClient(cluster=9, replica_addresses=[("127.0.0.1", server)],
                client_id=21)
    py = Client(cluster=9, client_id=22,
                replica_addresses=[("127.0.0.1", server)])
    try:
        n = 0
        for what, events in _requests():
            got = getattr(c, what)(events)
            want = getattr(py, what)([_shift(e, OFFSET) for e in events])
            assert [r.status for r in got] == [r.status for r in want], what
            n += sum(r.status.name == "created" for r in got)
        # Most created; the limited accounts' overdrafts, the missing
        # account and the existing id not.
        assert 50 <= n < 12 + 42 + 6 + 6
        accounts = [i for i in range(1, 14)]
        transfers = [100, 139, 150, 200, 201, 300, 301, 999]
        for op, ids in ((Operation.lookup_accounts, accounts),
                        (Operation.lookup_transfers, transfers)):
            body = _ids_body(ids + [i + OFFSET for i in ids])
            raw_c = c.request(op, body)
            raw_py = py.request(op, body, timeout_s=120)
            assert raw_c == raw_py and len(raw_c) > 0, op
        looked = c.lookup_accounts([1, 2])
        assert looked[0].debits_posted > 0 and looked[1].credits_posted > 0
    finally:
        c.close()
        py.close()


def _events_body(events) -> bytes:
    return multi_batch.encode([b"".join(e.pack() for e in events)], 128)


def _results_masked(raw: bytes) -> tuple:
    """A create reply with every result's timestamp zeroed: the two
    clients' events commit at different times."""
    (payload,) = multi_batch.decode(raw, 16)
    return len(raw), b"".join(b"\x00" * 8 + payload[i + 8:i + 16]
                              for i in range(0, len(payload), 16))


def test_c_client_replies_equal_the_jax_packages(server, jax_client):
    """The port's and the JAX package's C clients on one server: the
    same requests, each on ids of its own (2 and 3 x OFFSET up), give
    create replies equal with the timestamps zeroed and lookup replies
    equal byte for byte."""
    ours = CClient(cluster=9, replica_addresses=[("127.0.0.1", server)],
                   client_id=31)
    theirs = jax_client(cluster=9, client_id=32,
                        replica_addresses=[("127.0.0.1", server)])
    shift = {ours: 2 * OFFSET, theirs: 3 * OFFSET}
    try:
        for what, events in _requests():
            op = Operation[what]
            raw = {c: c.request(op, _events_body(
                [_shift(e, d) for e in events])) for c, d in shift.items()}
            assert _results_masked(raw[ours]) == \
                _results_masked(raw[theirs]), what
            assert raw[ours] != raw[theirs], what   # timestamps differ
        accounts = [i for i in range(1, 14)]
        transfers = [100, 139, 150, 200, 201, 300, 301, 999]
        for op, ids in ((Operation.lookup_accounts, accounts),
                        (Operation.lookup_transfers, transfers)):
            body = _ids_body([i + d for d in shift.values() for i in ids])
            raw_ours = ours.request(op, body)
            raw_theirs = theirs.request(op, body)
            assert raw_ours == raw_theirs and len(raw_ours) > 0, op
    finally:
        ours.close()
        theirs.close()


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_cpp_example_builds_against_the_ports_runtime(tmp_path):
    exe = tmp_path / "example"
    subprocess.run(
        ["g++", "-O2", "-std=c++17",
         str(REPO / "clients" / "cpp" / "example.cpp"),
         str(REPO / "tigerbeetle_tpu_torch" / "csrc" / "tb_client.cpp"),
         "-o", str(exe), "-pthread"], check=True, timeout=300)
    p = subprocess.run([str(exe), "echo"], capture_output=True, text=True,
                       timeout=60)
    assert p.returncode == 0 and "echo ok" in p.stdout, p.stderr
