"""`python -m tigerbeetle_tpu_torch format / start / inspect` against the
JAX package's `main.py`.

`format` writes the same data file. A server started with `start
--platform cpu --small` in a subprocess answers a client's requests over
TCP (replies checked against a CPU oracle `StateMachine` fed the same
bodies at the replies' timestamps) and stops on SIGTERM, dumping its
trace; `inspect` (plain, `--digest` and `--integrity`) of that file
prints, line for line, what the JAX package's `inspect` prints. The JAX
side scans the WAL on its Python path: its native scan checks a header
over the trace context that rides outside the header's checksum, and
takes a traced prepare (every request the client sends is traced) for an
unknown slot.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import main as J_main
from tigerbeetle_tpu import native as J_native
from tigerbeetle_tpu_torch import StateMachine, main as P_main, multi_batch
from tigerbeetle_tpu_torch.types import (
    Account, AccountFilter, AccountFilterFlags, AccountFlags, Operation,
    Transfer, TransferFlags)
from tigerbeetle_tpu_torch.vsr.client import Client

REPO = Path(__file__).resolve().parent.parent


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_format_file_equal_to_the_jax_packages(tmp_path, capsys):
    for args in (["--cluster=0", "--replica=0", "--replica-count=1"],
                 ["--cluster=7", "--replica=2", "--replica-count=3"]):
        assert P_main.main(["format", *args, "--small",
                            str(tmp_path / "p.tb")]) == 0
        assert J_main.main(["format", *args, "--small",
                            str(tmp_path / "j.tb")]) == 0
        assert (tmp_path / "p.tb").read_bytes() == \
            (tmp_path / "j.tb").read_bytes()
        out = capsys.readouterr().out.splitlines()
        assert out[0].replace("p.tb", "j.tb") == out[1]
        for f in ("p.tb", "j.tb"):
            (tmp_path / f).unlink()


def _enc(objs) -> bytes:
    return multi_batch.encode([b"".join(o.pack() for o in objs)], 128)


def test_start_serves_a_client_then_inspect_equals_the_jax_packages(
        tmp_path, capsys, monkeypatch):
    path = str(tmp_path / "0_0.tigerbeetle")
    assert P_main.main(["format", "--cluster=0", "--replica=0",
                        "--replica-count=1", "--small", path]) == 0
    port = _port()
    trace = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    server = subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         f"--addresses=127.0.0.1:{port}", "--replica=0", "--platform=cpu",
         "--small", f"--trace={trace}", path],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    requests = [
        (Operation.create_accounts, _enc(
            [Account(id=i, ledger=1, code=1,
                     flags=int(AccountFlags.history) if i == 2 else 0)
             for i in range(1, 9)])),
        *[(Operation.create_transfers, _enc(
            [Transfer(id=100 + 20 * k + j, debit_account_id=1 + j % 8,
                      credit_account_id=1 + (j + 1) % 8, amount=1 + j,
                      ledger=1, code=1,
                      flags=int(TransferFlags.pending) if j == 3 else 0)
             for j in range(20)])) for k in range(19)],
        (Operation.lookup_accounts, multi_batch.encode(
            [b"".join(i.to_bytes(16, "little") for i in (1, 2, 77))], 16)),
        (Operation.get_account_transfers, multi_batch.encode(
            [AccountFilter(account_id=2, limit=10, flags=int(
                AccountFilterFlags.debits
                | AccountFilterFlags.credits)).pack()], 128)),
    ]
    client = Client(cluster=0, client_id=12,
                    replica_addresses=[("127.0.0.1", port)])
    try:
        line = ""
        while "listening" not in line:
            line = server.stdout.readline()
            assert line, "the server exited before listening"
        oracle = StateMachine("oracle", device="cpu")
        for op, body in requests:
            got = client.request(op, body, timeout_s=120)
            ts = client._reply.header.timestamp
            assert got == oracle.commit(op, body, ts)
    finally:
        client.close()
        server.send_signal(signal.SIGTERM)
        out, _ = server.communicate(timeout=120)
    assert server.returncode == 0, out
    assert "commit=" in out
    doc = json.loads(trace.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    assert any(e.get("name") == "commit_execute" for e in events)

    monkeypatch.setattr(J_native, "available", lambda: False)
    for flags in ([], ["--digest"], ["--integrity"]):
        capsys.readouterr()
        rc_p = P_main.main(["inspect", "--small", *flags, path])
        mine = capsys.readouterr().out.splitlines()
        rc_j = J_main.main(["inspect", "--small", *flags, path])
        theirs = capsys.readouterr().out.splitlines()
        assert rc_p == rc_j == 0, (flags, mine)
        assert mine == theirs, flags
    journal = [ln for ln in mine if ln.startswith("journal:")]
    assert journal and ", 0 faulty, 0 unknown;" in journal[0]
    assert not any("CORRUPT" in ln for ln in mine)
