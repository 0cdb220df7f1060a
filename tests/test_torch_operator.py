"""The operator's commands of the port against the JAX package's: the AOF
(`aof.py`, `start --aof`, `recover`), `recover --from-cluster`, the
metrics endpoint and the SLO engine (`metrics.py`, `trace/slo.py`,
`start --metrics-port`), the REPL, CDC over AMQP, `version` and
`multiversion`.

AOF frames are byte-equal and each package reads the other's files,
torn and gapped ones included; a server started with `start --platform
cpu --small --aof --metrics-port 0` answers a client, its endpoint
parses and counts the commits, and the port's `recover` of its AOF
checkpoints the state the JAX package's `recover` does (`inspect
--digest` line for line). Two port servers of a three-replica cluster
rebuild the third's lost data file through `recover --from-cluster`.
For the same tracer contents the exposition and the SLO rows are the
JAX package's; the REPL sends the same request bytes and prints the
same lines; the CDC runner puts the same bytes on the wire to an
in-process AMQP broker.
"""

import dataclasses
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tests.test_amqp import MiniBroker
from tigerbeetle_tpu import aof as J_aof
from tigerbeetle_tpu import amqp as J_amqp
from tigerbeetle_tpu import cdc as J_cdc
from tigerbeetle_tpu import main as J_main
from tigerbeetle_tpu import metrics as J_metrics
from tigerbeetle_tpu import multi_batch as J_mb
from tigerbeetle_tpu import native as J_native
from tigerbeetle_tpu import repl as J_repl
from tigerbeetle_tpu import state_machine as J_sm
from tigerbeetle_tpu import trace as J_trace
from tigerbeetle_tpu import types as J_types
from tigerbeetle_tpu.trace import slo as J_slo
from tigerbeetle_tpu.vsr import header as J_header
from tigerbeetle_tpu_torch import aof as P_aof
from tigerbeetle_tpu_torch import amqp as P_amqp
from tigerbeetle_tpu_torch import cdc as P_cdc
from tigerbeetle_tpu_torch import main as P_main
from tigerbeetle_tpu_torch import metrics as P_metrics
from tigerbeetle_tpu_torch import multi_batch as P_mb
from tigerbeetle_tpu_torch import repl as P_repl
from tigerbeetle_tpu_torch import state_machine as P_sm
from tigerbeetle_tpu_torch import trace as P_trace
from tigerbeetle_tpu_torch import types as P_types
from tigerbeetle_tpu_torch.trace import slo as P_slo
from tigerbeetle_tpu_torch.vsr import header as P_header
from tigerbeetle_tpu_torch.vsr.client import Client

REPO = Path(__file__).resolve().parent.parent
PKGS = {
    "P": dict(aof=P_aof, header=P_header, types=P_types, mb=P_mb,
              sm=lambda: P_sm.StateMachine("oracle", device="cpu")),
    "J": dict(aof=J_aof, header=J_header, types=J_types, mb=J_mb,
              sm=lambda: J_sm.StateMachine(engine="oracle")),
}


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------------------ AOF

def _prepares(pkg: str) -> list:
    """Accounts, a transfer, a pending and its post, a pulse: prepares
    1..5 of one package."""
    m = PKGS[pkg]
    T, H = m["types"], m["header"]
    accounts = b"".join(T.Account(id=i, ledger=1, code=1).pack()
                        for i in (1, 2, 3))
    transfers = b"".join(t.pack() for t in (
        T.Transfer(id=9, debit_account_id=1, credit_account_id=2,
                   amount=5, ledger=1, code=1),
        T.Transfer(id=10, debit_account_id=2, credit_account_id=3,
                   amount=7, ledger=1, code=1,
                   flags=int(T.TransferFlags.pending))))
    post = T.Transfer(id=11, pending_id=10, amount=7,
                      flags=int(T.TransferFlags.post_pending_transfer))
    ops = [(T.Operation.create_accounts, m["mb"].encode([accounts], 128)),
           (T.Operation.create_transfers, m["mb"].encode([transfers], 128)),
           (T.Operation.create_transfers, m["mb"].encode([post.pack()], 128)),
           (T.Operation.pulse, b""),
           (T.Operation.lookup_accounts, m["mb"].encode(
               [b"".join(i.to_bytes(16, "little") for i in (1, 3))], 16))]
    out = []
    for op_no, (operation, body) in enumerate(ops, start=1):
        h = H.Header(command=H.Command.prepare, cluster=1, op=op_no,
                     operation=int(operation), timestamp=10**13 + op_no * 100)
        out.append(H.Message(h.finalize(body), body=body))
    return out


def _write_aof(pkg: str, path: str, prepares) -> None:
    aof = PKGS[pkg]["aof"].AOF(path)
    for msg in prepares:
        aof.append(msg)
    aof.close()


def test_aof_frames_equal_and_read_across_packages(tmp_path):
    """The same prepares framed by each package: byte-equal files; each
    package iterates and recovers the other's file into the state its
    own recovery of its own file gives."""
    paths = {pkg: str(tmp_path / f"{pkg}.aof") for pkg in PKGS}
    for pkg in PKGS:
        _write_aof(pkg, paths[pkg], _prepares(pkg))
    assert Path(paths["P"]).read_bytes() == Path(paths["J"]).read_bytes()
    states = {}
    for reader in PKGS:
        for writer in PKGS:
            msgs = list(PKGS[reader]["aof"].AOF.iterate(paths[writer]))
            assert [m.pack() for m in msgs] == \
                [m.pack() for m in _prepares(reader)]
            sm = PKGS[reader]["sm"]()
            assert PKGS[reader]["aof"].recover(paths[writer], sm) == 5
            states[(reader, writer)] = (
                sorted(a.pack() for a in sm.state.accounts.values()),
                sorted(t.pack() for t in sm.state.transfers.values()))
    assert len(set(map(repr, states.values()))) == 1
    assert len(states[("P", "J")][1]) == 3


@pytest.mark.parametrize("case", ["torn", "gap", "reopen", "mid_life"])
def test_aof_faults_handled_as_the_jax_package_does(tmp_path, case):
    """A torn tail stops iteration (and a reopening writer truncates it);
    a gapped file fails recovery; reopening dedupes and refuses a gap;
    an empty AOF refuses a first op past 1 — each alike in both
    packages, on either package's file."""
    outcomes = {}
    for pkg in PKGS:
        A = PKGS[pkg]["aof"]
        msgs = _prepares(pkg)
        path = str(tmp_path / f"{case}_{pkg}.aof")
        seen = []
        if case == "torn":
            _write_aof(pkg, path, msgs[:2])
            with open(path, "ab") as f:
                f.write(b"TBTPUAOF\xff\xff")  # a torn frame
            seen.append(len(list(A.AOF.iterate(path))))
            aof = A.AOF(path)   # truncates the torn tail
            seen.append(aof.last_op)
            aof.append(msgs[2])
            aof.close()
            seen.append([m.header.op for m in A.AOF.iterate(path)])
        elif case == "gap":
            aof = A.AOF(path)
            aof.append(msgs[0])
            aof.last_op = 2    # a gap on disk: op 3 follows op 1
            aof.append(msgs[2])
            aof.close()
            with pytest.raises(ValueError, match="not contiguous"):
                A.recover(path, PKGS[pkg]["sm"]())
            seen.append([m.header.op for m in A.AOF.iterate(path)])
        elif case == "reopen":
            _write_aof(pkg, path, msgs[:2])
            aof = A.AOF(path)
            seen.append(aof.last_op)
            aof.append(msgs[1])   # a WAL replay's re-commit: a no-op
            aof.append(msgs[2])
            with pytest.raises(RuntimeError, match="gap"):
                aof.append(msgs[4])
            aof.close()
            seen.append([m.header.op for m in A.AOF.iterate(path)])
        else:
            aof = A.AOF(path)
            with pytest.raises(RuntimeError, match="mid-life"):
                aof.append(msgs[2])
            aof.close()
            seen.append(os.path.getsize(path))
        outcomes[pkg] = (seen, Path(path).read_bytes())
    assert outcomes["P"] == outcomes["J"]


# ------------------------------------------- start --aof --metrics-port

def _enc(T, mb, objs) -> bytes:
    return mb.encode([b"".join(o.pack() for o in objs)], 128)


def _requests():
    T = P_types
    return [
        (T.Operation.create_accounts, _enc(T, P_mb, [
            T.Account(id=i, ledger=1, code=1,
                      flags=int(T.AccountFlags.history) if i == 2 else 0)
            for i in range(1, 9)])),
        *[(T.Operation.create_transfers, _enc(T, P_mb, [
            T.Transfer(id=100 + 20 * k + j, debit_account_id=1 + j % 8,
                       credit_account_id=1 + (j + 1) % 8, amount=1 + j,
                       ledger=1, code=1,
                       flags=int(T.TransferFlags.pending) if j == 3 else 0)
            for j in range(20)])) for k in range(6)],
        (T.Operation.create_transfers, _enc(T, P_mb, [
            T.Transfer(id=900, pending_id=103, amount=4,
                       flags=int(T.TransferFlags.post_pending_transfer))])),
    ]


def _start(path, port, *flags):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         f"--addresses={port}", "--replica=0", "--platform=cpu", "--small",
         *flags, path],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_start_aof_metrics_then_recover_equals_the_jax_packages(
        tmp_path, capsys, monkeypatch):
    """A server with --aof and --metrics-port 0 answers a client; one
    scrape parses with the port's parse_prometheus and counts at least
    the commits the client saw; the AOF holds ops 1..n contiguously, each
    frame the prepare the server committed; the port's `recover` of it
    and the JAX package's write data files whose `inspect --digest`
    prints the same lines in either package."""
    path = str(tmp_path / "0_0.tigerbeetle")
    aof_path = str(tmp_path / "0_0.aof")
    assert P_main.main(["format", "--cluster=0", "--replica=0",
                        "--replica-count=1", "--small", path]) == 0
    port = _port()
    server = _start(path, f"127.0.0.1:{port}", f"--aof={aof_path}",
                    "--metrics-port=0")
    client = Client(cluster=0, client_id=21,
                    replica_addresses=[("127.0.0.1", port)])
    try:
        metrics_url, line = None, ""
        while "listening" not in line:
            line = server.stdout.readline()
            assert line, "the server exited before listening"
            got = re.search(r"metrics on (http://\S+/metrics)", line)
            if got:
                metrics_url = got.group(1)
        assert metrics_url is not None
        for op, body in _requests():
            client.request(op, body, timeout_s=120)
        with urllib.request.urlopen(metrics_url, timeout=30) as r:
            assert r.status == 200
            scraped = P_metrics.parse_prometheus(r.read().decode())
    finally:
        client.close()
        server.send_signal(signal.SIGTERM)
        out, _ = server.communicate(timeout=120)
    assert server.returncode == 0, out
    commits = sum(v for _, v in scraped["tb_tpu_commits_total"])
    assert commits >= len(_requests())
    assert "tb_tpu_commit_execute_us_count" in scraped

    frames = list(P_aof.AOF.iterate(aof_path))
    ops = [m.header.op for m in frames]
    assert ops == list(range(1, len(frames) + 1))
    assert len(frames) >= len(_requests())
    assert [m.pack() for m in J_aof.AOF.iterate(aof_path)] == \
        [m.pack() for m in frames]

    p_path, j_path = str(tmp_path / "p.tb"), str(tmp_path / "j.tb")
    args = ["recover", "--replica=0", "--replica-count=1", "--small"]
    assert P_main.main([*args, aof_path, p_path]) == 0
    assert J_main.main([*args, aof_path, j_path]) == 0
    said = capsys.readouterr().out.splitlines()
    assert said[-2].replace(p_path, j_path) == said[-1]
    assert f"recovered {len(frames)} ops" in said[-1]
    monkeypatch.setattr(J_native, "available", lambda: False)
    digests = {}
    for pkg, main in (("P", P_main), ("J", J_main)):
        for f in (p_path, j_path):
            assert main.main(["inspect", "--small", "--digest", f]) == 0
            digests[(pkg, f)] = capsys.readouterr().out.splitlines()
    assert len({repr(v) for v in digests.values()}) == 1
    assert any(ln.startswith("digest: checkpoint_op=")
               for ln in digests[("P", p_path)])


def test_recover_usage_errors_match_the_jax_packages(tmp_path, capsys):
    path = str(tmp_path / "x.tb")
    for argv in (["recover", "--replica=0", "--replica-count=1"],
                 ["recover", "--replica=0", "--replica-count=1",
                  "--from-cluster", path],
                 ["recover", "--replica=0", "--replica-count=2",
                  "--from-cluster", "--addresses=127.0.0.1:1", path]):
        assert P_main.main(argv) == J_main.main(argv) == 2
        mine, theirs = capsys.readouterr().out.splitlines()
        assert mine == theirs


# ------------------------------------------------ recover --from-cluster

def test_recover_from_cluster_rebuilds_a_lost_data_file(tmp_path):
    """Replicas 0 and 1 of three serve (a quorum) past the 32-slot WAL;
    replica 2's data file was never written. `recover --from-cluster`
    installs a peer's checkpoint over state sync, repairs the suffix and
    certifies the grid; the rebuilt file's forest digest equals the
    peer's at the same checkpoint."""
    ports = [_port() for _ in range(3)]
    addresses = ",".join(f"127.0.0.1:{p}" for p in ports)
    paths = [str(tmp_path / f"0_{i}.tigerbeetle") for i in range(3)]
    for i in (0, 1):
        assert P_main.main(["format", "--cluster=0", f"--replica={i}",
                            "--replica-count=3", "--small", paths[i]]) == 0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    servers = [subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "start",
         f"--addresses={addresses}", f"--replica={i}", "--engine=oracle",
         "--platform=cpu", "--small", paths[i]],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
    client = Client(cluster=0, client_id=31, replica_addresses=[
        ("127.0.0.1", p) for p in ports])
    T = P_types
    try:
        for srv in servers:
            line = ""
            while "listening" not in line:
                line = srv.stdout.readline()
                assert line, "a server exited before listening"
        client.request(T.Operation.create_accounts, _enc(T, P_mb, [
            T.Account(id=i, ledger=1, code=1) for i in (1, 2)]),
            timeout_s=120)
        for k in range(40):
            client.request(T.Operation.create_transfers, _enc(T, P_mb, [
                T.Transfer(id=100 + k, debit_account_id=1,
                           credit_account_id=2, amount=1, ledger=1,
                           code=1)]), timeout_s=60)
        rebuild = subprocess.run(
            [sys.executable, "-m", "tigerbeetle_tpu_torch", "recover",
             "--from-cluster", f"--addresses={addresses}", "--replica=2",
             "--replica-count=3", "--small", "--timeout-s=150", paths[2]],
            cwd=str(REPO), env=env, capture_output=True, text=True,
            timeout=200)
    finally:
        client.close()
        for srv in servers:
            srv.send_signal(signal.SIGTERM)
        outs = [srv.communicate(timeout=120)[0] for srv in servers]
    assert rebuild.returncode == 0, rebuild.stdout + rebuild.stderr
    assert "state-synced" in rebuild.stdout, rebuild.stdout
    assert all(srv.returncode == 0 for srv in servers), outs

    def digest(path):
        proc = subprocess.run(
            [sys.executable, "-m", "tigerbeetle_tpu_torch", "inspect",
             "--small", "--digest", path], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout
        line = proc.stdout.splitlines()[-1]
        got = re.match(r"digest: checkpoint_op=(\d+) combined=(\w+)", line)
        return int(got.group(1)), got.group(2)

    ck, rebuilt = digest(paths[2])
    peers = [digest(p) for p in paths[:2]]
    assert ck > 0
    assert any(p_ck == ck for p_ck, _ in peers), (ck, peers)
    assert all(d == rebuilt for p_ck, d in peers if p_ck == ck)


# ---------------------------------------------------- metrics and SLOs

def _tracer(trace):
    """The same contents in either package's recording tracer: spans of
    fixed durations, counters, a gauge, a histogram-kind sample and one
    traced span (an exemplar)."""
    E = trace.Event
    t = trace.Tracer(pid=0)
    t0 = t.now_ns()
    for k, (route, tier) in enumerate((("chain", "scan"), ("chain", "scan"),
                                       ("per_batch", "fallback"))):
        t.record_span(E.window_commit, t0, (k + 1) * 7_000_000,
                      route=route, tier=tier)
    t.record_span(E.commit_execute, t0, 3_300_000, op=5, operation=129,
                  window=1)
    t.record_span(E.window_commit, t0, 400_000_000, route="chain",
                  tier="scan", ctx=trace.TraceContext(trace_id=0xABC))
    t.count(E.serving_retries, 3)
    t.count(E.commits, 11)
    t.gauge(E.bus_pool_used, 7)
    t.observe(E.serving_replay_windows, 4)
    return t


def test_metrics_render_equal_to_the_jax_packages():
    p, j = _tracer(P_trace), _tracer(J_trace)
    text_p = P_metrics.render_prometheus(p)
    assert text_p == J_metrics.render_prometheus(j)
    assert P_metrics.render_prometheus([p, _tracer(P_trace)]) == \
        J_metrics.render_prometheus([j, _tracer(J_trace)])
    parsed = P_metrics.parse_prometheus(text_p)
    assert parsed == J_metrics.parse_prometheus(text_p)
    assert parsed["tb_tpu_commits_total"] == [({}, 11.0)]
    assert len(parsed["__exemplars__"]["tb_tpu_window_commit_us_bucket"]) \
        == 1
    srv = P_metrics.MetricsServer(lambda: text_p, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as r:
            assert "version=0.0.4" in r.headers["Content-Type"]
            assert r.read().decode() == text_p
    finally:
        srv.close()


def test_slo_engine_equal_to_the_jax_packages():
    """perf/slo.json loads against the port's catalog into the JAX
    package's objectives; evaluation (with its breach counters), burn
    rates and a bench record's rows are the JAX package's."""
    cfg_p, cfg_j = P_slo.load_objectives(), J_slo.load_objectives()
    assert [dataclasses.asdict(o) for o in cfg_p["objectives"]] == \
        [dataclasses.asdict(o) for o in cfg_j["objectives"]]
    assert (cfg_p["burn_window_runs"], cfg_p["burn_budget"]) == \
        (cfg_j["burn_window_runs"], cfg_j["burn_budget"])
    p, j = _tracer(P_trace), _tracer(J_trace)
    forced = {}
    for pkg, slo, cfg, t in (("P", P_slo, cfg_p, p), ("J", J_slo, cfg_j, j)):
        rows = slo.evaluate(t, cfg["objectives"], emit_to=t)
        low = [dataclasses.replace(o, threshold=1.0)
               for o in cfg["objectives"]]
        rows_low = slo.evaluate(t, low, emit_to=t)
        burn = slo.burn_rates([rows, rows_low, rows], 2, 0.25)
        bench = slo.evaluate_bench_record(
            {"serving_batch_latency": {"p99_ms": 300.0}}, cfg["objectives"])
        forced[pkg] = (rows, rows_low, burn, bench,
                       t.counters.get("slo_breach"))
    assert forced["P"] == forced["J"]
    assert forced["P"][4] >= 1
    assert P_metrics.render_prometheus(p, slo_rows=forced["P"][0],
                                       burn=forced["P"][2]) == \
        J_metrics.render_prometheus(j, slo_rows=forced["J"][0],
                                    burn=forced["J"][2])


# ----------------------------------------------------------------- REPL

class _ReplClient:
    """Answers the REPL's requests from an oracle-engine StateMachine and
    records them."""

    def __init__(self, pkg):
        self.sm = PKGS[pkg]["sm"]()
        self.sent = []
        self.ts = 10**13

    def request(self, op, body):
        self.sent.append((int(op), body))
        self.ts += 1000
        return self.sm.commit(op, body, self.ts)


def test_repl_sends_and_prints_what_the_jax_packages_does():
    script = [
        "create_accounts id=1 code=10 ledger=700 flags=linked|history,",
        "  id=2 code=10 ledger=700;",
        "create_transfers id=1 debit_account_id=1 credit_account_id=2 "
        "amount=10 ledger=700 code=10, id=2 debit_account_id=1 "
        "credit_account_id=2 amount=5 ledger=700 code=10 flags=pending;",
        "lookup_accounts id=1, id=2; lookup_transfers id=2;",
        "get_account_transfers account_id=1 flags=debits|credits limit=10;",
        "get_account_balances account_id=1 flags=debits limit=10;",
        "query_accounts ledger=700 limit=10;",
        "create_transfers id=3 nonsense=1;",
        "frobnicate id=1;",
        "help",
        "exit",
    ]
    seen = {}
    for pkg, repl in (("P", P_repl), ("J", J_repl)):
        client, lines, printed = _ReplClient(pkg), iter(script), []
        repl.run_repl(client, input_fn=lambda _p: next(lines),
                      print_fn=printed.append)
        seen[pkg] = (client.sent, printed)
    assert seen["P"] == seen["J"]
    assert len(seen["P"][0]) == 7
    assert any("error" in ln for ln in seen["P"][1])
    for text in ("lookup_accounts id=1, id=2", "query_transfers ledger=1",
                 "get_change_events limit=3"):
        p, j = P_repl.parse_statement(text), J_repl.parse_statement(text)
        assert int(p.operation) == int(j.operation)
        assert repr(p.objects) == repr(j.objects)


# ----------------------------------------------------------- CDC / AMQP

def _cdc_source(pkg):
    T = PKGS[pkg]["types"]
    sm = PKGS[pkg]["sm"]()
    ts = 10**9
    sm.create_accounts([T.Account(id=i, ledger=1, code=1)
                        for i in (1, 2)], ts)
    sm.create_transfers([
        T.Transfer(id=10, debit_account_id=1, credit_account_id=2,
                   amount=5, ledger=1, code=1),
        T.Transfer(id=11, debit_account_id=1, credit_account_id=2,
                   amount=3, ledger=1, code=1,
                   flags=int(T.TransferFlags.pending)),
        T.Transfer(id=12, debit_account_id=2, credit_account_id=1,
                   amount=9, ledger=1, code=1)], ts + 1000)
    sm.create_transfers([T.Transfer(
        id=13, pending_id=11, amount=3,
        flags=int(T.TransferFlags.post_pending_transfer))], ts + 2000)
    return sm


def test_cdc_amqp_bytes_equal_the_jax_packages(monkeypatch):
    """The CDC runner over AmqpSink (no pipelining, progress in memory)
    sends the same bytes on the wire and the broker receives the same
    declarations, publishes and credentials, in each package; the codec
    encodes and parses alike."""
    seen = {}
    for pkg, amqp, cdc in (("P", P_amqp, P_cdc), ("J", J_amqp, J_cdc)):
        wire = []
        send = amqp.AmqpClient._send

        def recording(self, raw, send=send, wire=wire):
            wire.append(raw)
            send(self, raw)

        monkeypatch.setattr(amqp.AmqpClient, "_send", recording)
        broker = MiniBroker()
        try:
            sink = cdc.AmqpSink("127.0.0.1", broker.port, cluster=5,
                                user="svc", password="secret")
            runner = cdc.CDCRunner(_cdc_source(pkg), sink, batch_limit=2,
                                   pipeline=False)
            published = runner.run_until_idle()
            runner.close()
            sink.close()
        finally:
            broker.close()
        seen[pkg] = (published, b"".join(wire), broker.messages,
                     broker.declared_exchanges, broker.declared_queues,
                     broker.bindings, broker.auth)
    assert seen["P"] == seen["J"]
    assert seen["P"][0] == 4
    assert [rk for _, rk, _ in seen["P"][2]] == [
        "cdc.single_phase", "cdc.two_phase_pending", "cdc.single_phase",
        "cdc.two_phase_posted"]
    raw = (P_amqp.method_frame(1, P_amqp.BASIC_PUBLISH, b"\x00\x00"
                               + P_amqp.shortstr("e") + P_amqp.shortstr("k")
                               + b"\x00")
           + P_amqp.content_frames(1, b"payload" * 5000, 4096)
           + P_amqp.field_table({"product": "x", "n": 3}))
    assert raw == (J_amqp.method_frame(1, J_amqp.BASIC_PUBLISH, b"\x00\x00"
                                       + J_amqp.shortstr("e")
                                       + J_amqp.shortstr("k") + b"\x00")
                   + J_amqp.content_frames(1, b"payload" * 5000, 4096)
                   + J_amqp.field_table({"product": "x", "n": 3}))
    assert list(P_amqp.parse_publishes(raw)) == \
        list(J_amqp.parse_publishes(raw))


# --------------------------------------------- version and multiversion

def test_version_and_multiversion(tmp_path, capsys):
    import tigerbeetle_tpu_torch

    assert P_main.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == \
        f"tigerbeetle-tpu-torch {tigerbeetle_tpu_torch.__version__}"
    path = str(tmp_path / "m.tb")
    assert P_main.main(["format", "--replica=0", "--replica-count=1",
                        "--small", path]) == 0
    capsys.readouterr()
    assert P_main.main(["multiversion", "--small", path]) == 0
    mine = capsys.readouterr().out
    assert J_main.main(["multiversion", "--small", path]) == 0
    assert mine == capsys.readouterr().out
    shutil.copy(path, tmp_path / "blank.tb")
    with open(tmp_path / "blank.tb", "r+b") as f:
        f.write(b"\0" * 65536)   # no superblock quorum left
    assert P_main.main(["multiversion", "--small",
                        str(tmp_path / "blank.tb")]) == 1
    assert "no quorum" in capsys.readouterr().out
