"""Vortex: non-deterministic whole-system chaos testing.

reference: src/vortex.zig + src/testing/vortex/{supervisor,faulty_network}
.zig — unlike the deterministic VOPR (in-process, simulated everything),
vortex runs REAL replica processes over REAL TCP, injects packet-level
network faults through a byte proxy, pauses/kills/restarts processes, and
audits client-visible results. It exists to catch what simulation cannot:
kernel-level socket behavior, process lifecycle, actual fsync timing.

Topology: every replica address handed to the processes is a FaultyProxy
port; each proxy forwards to its replica's real port, so replica<->replica
and client->replica traffic all crosses the fault layer.

A copy of the JAX package's `testing/vortex.py`. The replicas are
`python -m tigerbeetle_tpu_torch` processes run from the root of the
checkout this module lives in; they inherit the caller's environment and
run the oracle engine, as the JAX package's do. `platform="cpu"` starts
them with `--platform cpu`; by default their state machines name the
card.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

# The checkout's root: the replicas' working directory, so `-m
# tigerbeetle_tpu_torch` imports this package wherever it is checked out.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "tigerbeetle_tpu_torch"


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class FaultyProxy:
    """Byte-level TCP proxy with injectable faults (reference:
    faulty_network.zig): per-direction forwarding threads that can delay,
    and a kill switch that resets every in-flight connection."""

    def __init__(self, listen_port: int, target_port: int,
                 seed: int = 0):
        self.listen_port = listen_port
        self.target_port = target_port
        self.prng = random.Random(seed)
        self.delay_max_s = 0.0
        self.broken = False  # refuse/kill all connections
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.listener = socket.socket()
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", listen_port))
        self.listener.listen(64)
        self.closing = False
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.thread.start()

    def _accept_loop(self) -> None:
        while not self.closing:
            try:
                downstream, _ = self.listener.accept()
            except OSError:
                return
            if self.broken:
                downstream.close()
                continue
            try:
                upstream = socket.create_connection(
                    ("127.0.0.1", self.target_port), timeout=5)
            except OSError:
                downstream.close()
                continue
            with self._lock:
                self._conns += [downstream, upstream]
            for a, b in ((downstream, upstream), (upstream, downstream)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                chunk = src.recv(64 * 1024)
                if not chunk or self.broken:
                    break
                if self.delay_max_s:
                    time.sleep(self.prng.random() * self.delay_max_s)
                dst.sendall(chunk)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass
        with self._lock:
            self._conns = [c for c in self._conns if c not in (src, dst)]

    def smash(self) -> None:
        """Reset every in-flight connection and refuse new ones."""
        self.broken = True
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass

    def heal(self) -> None:
        self.broken = False

    def close(self) -> None:
        self.closing = True
        self.smash()
        self.listener.close()


class VortexSupervisor:
    """Spawns real replica processes behind faulty proxies and drives
    faults (reference: testing/vortex/supervisor.zig)."""

    def __init__(self, tmp_dir: str, *, replica_count: int = 3,
                 cluster: int = 0xF0, seed: int = 0,
                 trace: bool = False, metrics: bool = False,
                 platform: Optional[str] = None):
        self.tmp_dir = tmp_dir
        self.replica_count = replica_count
        self.cluster = cluster
        self.prng = random.Random(seed)
        # platform="cpu": the replicas' state machines on the CPU (None:
        # the card).
        self.platform = platform
        # trace=True: every replica runs with --trace and dumps
        # r<i>.trace.json on SIGINT shutdown; collect_merged_trace()
        # then yields ONE Perfetto timeline for the whole cluster.
        self.trace = trace
        # metrics=True: every replica serves Prometheus text on its own
        # --metrics-port; scrape_metrics(i) reads it live. The scraped
        # histogram p99s must agree (within the histogram error bound)
        # with the offline merged-trace quantiles — the endpoint
        # acceptance check in tests/test_metrics.py.
        self.metrics = metrics
        n_ports = (3 if metrics else 2) * replica_count
        ports = free_ports(n_ports)
        self.real_ports = ports[:replica_count]
        self.proxy_ports = ports[replica_count:2 * replica_count]
        self.metrics_ports = (ports[2 * replica_count:] if metrics
                              else [])
        self.addresses = ",".join(
            f"127.0.0.1:{p}" for p in self.proxy_ports)
        self.proxies = [
            FaultyProxy(self.proxy_ports[i], self.real_ports[i],
                        seed=seed + i)
            for i in range(replica_count)]
        self.procs: list[Optional[subprocess.Popen]] = [None] * replica_count
        self.paused: set[int] = set()
        for i in range(replica_count):
            self._format(i)
            self.start_replica(i)

    def _data_path(self, i: int) -> str:
        return os.path.join(self.tmp_dir, f"r{i}.tigerbeetle")

    def _format(self, i: int) -> None:
        subprocess.run(
            [sys.executable, "-m", MODULE, "format",
             f"--cluster={self.cluster}", f"--replica={i}",
             f"--replica-count={self.replica_count}", "--small",
             self._data_path(i)],
            check=True, cwd=REPO_ROOT, timeout=60,
            stdout=subprocess.DEVNULL)

    def trace_path(self, i: int) -> str:
        return os.path.join(self.tmp_dir, f"r{i}.trace.json")

    def _log_path(self, i: int) -> str:
        return os.path.join(self.tmp_dir, f"r{i}.log")

    def start_replica(self, i: int) -> None:
        assert self.procs[i] is None
        # The replica listens on its REAL port but dials peers through
        # their proxies: addresses are proxy ports, with our own entry
        # overridden via --listen-port.
        cmd = [sys.executable, "-m", MODULE, "start",
               f"--addresses={self.addresses}", f"--replica={i}",
               f"--cluster={self.cluster}", "--engine=oracle", "--small",
               f"--listen-port={self.real_ports[i]}"]
        if self.platform is not None:
            cmd.append(f"--platform={self.platform}")
        if self.trace:
            cmd.append(f"--trace={self.trace_path(i)}")
        if self.metrics:
            cmd.append(f"--metrics-port={self.metrics_ports[i]}")
        # Never a PIPE nobody drains: a chatty replica would block on a
        # full pipe buffer and masquerade as a liveness failure. A real
        # FILE (truncated per start — the marker must come from THIS
        # process) keeps output flowing AND gives _wait_listening its
        # readiness marker.
        log = open(self._log_path(i), "wb")
        self.procs[i] = subprocess.Popen(
            cmd + [self._data_path(i)],
            cwd=REPO_ROOT, stdout=log, stderr=log)
        log.close()

    # -------------------------------------------------------------- faults

    def destroy_data_file(self, i: int) -> None:
        """Kill the replica and ZERO its data file in place (total
        single-replica durable-state loss — the fault `recover
        --from-cluster` exists for). Zeroing rather than unlinking keeps
        the torn-media flavor: the file is present, sized, and garbage."""
        self.kill_replica(i)
        path = self._data_path(i)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            chunk = 1 << 20
            for off in range(0, size, chunk):
                f.write(b"\x00" * min(chunk, size - off))
            f.flush()
            os.fsync(f.fileno())

    def run_rebuild(self, i: int, *, timeout_s: float = 180,
                    crash_after_s: Optional[float] = None) -> int:
        """Run `recover --from-cluster` for replica i as a real process
        (the replica itself must be down). With crash_after_s the
        process is SIGKILLed after that delay — the crash-mid-rebuild
        injection; a re-run must then restart the rebuild cleanly.
        Returns the process's exit code (negative = killed)."""
        assert self.procs[i] is None, "stop the replica before rebuilding"
        proc = subprocess.Popen(
            [sys.executable, "-m", MODULE, "recover",
             "--from-cluster", f"--addresses={self.addresses}",
             f"--replica={i}", f"--cluster={self.cluster}",
             f"--replica-count={self.replica_count}", "--small",
             f"--listen-port={self.real_ports[i]}",
             f"--timeout-s={timeout_s}", self._data_path(i)],
            cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        if crash_after_s is not None:
            time.sleep(crash_after_s)
            proc.kill()
        return proc.wait(timeout=timeout_s + 30)

    def forest_digest(self, i: int) -> tuple[int, int]:
        """(op_checkpoint, combined state-epoch digest) of replica i's
        data file, offline (the replica must be stopped). Replicas at
        the same op_checkpoint must digest bit-identically."""
        out = subprocess.run(
            [sys.executable, "-m", MODULE, "inspect",
             "--small", "--digest", self._data_path(i)],
            capture_output=True, text=True, cwd=REPO_ROOT, timeout=120)
        assert out.returncode == 0, f"r{i} digest: {out.stdout}"
        ckpt = digest = None
        for line in out.stdout.splitlines():
            if line.startswith("digest: "):
                parts = dict(kv.split("=") for kv in line.split()[1:])
                ckpt = int(parts["checkpoint_op"])
                digest = int(parts["combined"], 16)
        assert ckpt is not None, out.stdout
        return ckpt, digest

    def kill_replica(self, i: int) -> None:
        proc = self.procs[i]
        if proc is None:
            return
        proc.kill()
        proc.wait(timeout=10)
        self.procs[i] = None
        self.paused.discard(i)

    def restart_replica(self, i: int) -> None:
        if self.procs[i] is None:
            self.start_replica(i)

    def pause_replica(self, i: int) -> None:
        proc = self.procs[i]
        if proc is not None and i not in self.paused:
            proc.send_signal(signal.SIGSTOP)
            self.paused.add(i)

    def resume_replica(self, i: int) -> None:
        proc = self.procs[i]
        if proc is not None and i in self.paused:
            proc.send_signal(signal.SIGCONT)
            self.paused.discard(i)

    def down_count(self) -> int:
        return sum(1 for i in range(self.replica_count)
                   if self.procs[i] is None or i in self.paused
                   or self.proxies[i].broken)

    def random_fault(self, max_down: int) -> str:
        """Inject one random fault / heal step; returns a description."""
        i = self.prng.randrange(self.replica_count)
        roll = self.prng.random()
        if roll < 0.25 and self.procs[i] is not None \
                and self.down_count() < max_down:
            self.kill_replica(i)
            return f"kill r{i}"
        if roll < 0.45 and self.procs[i] is None:
            self.restart_replica(i)
            return f"restart r{i}"
        if roll < 0.6 and self.down_count() < max_down \
                and i not in self.paused:
            self.pause_replica(i)
            return f"pause r{i}"
        if roll < 0.75 and self.paused:
            victim = self.prng.choice(sorted(self.paused))
            self.resume_replica(victim)
            return f"resume r{victim}"
        if roll < 0.85 and self.down_count() < max_down:
            self.proxies[i].smash()
            return f"smash proxy r{i}"
        for proxy in self.proxies:
            proxy.heal()
        return "heal proxies"

    def heal_all(self) -> None:
        for proxy in self.proxies:
            proxy.heal()
        for i in sorted(self.paused):
            self.resume_replica(i)
        for i in range(self.replica_count):
            self.restart_replica(i)

    def _wait_listening(self, i: int, timeout_s: float = 60.0) -> None:
        """Block until replica i prints its 'listening on' marker (or
        exits). A replica is only SIGINT-safe once cmd_start's signal
        FLAG handler is installed; a 2-of-3 quorum lets the whole run
        finish while the third replica is still importing torch, and an
        interrupt landing mid-import kills it before it can dump its
        trace. The marker prints strictly after the handler exists
        (the bus SOCKET binds much earlier — probing the port is not
        enough)."""
        proc = self.procs[i]
        deadline = time.monotonic() + timeout_s
        while proc is not None and proc.poll() is None \
                and time.monotonic() < deadline:
            try:
                with open(self._log_path(i), "rb") as f:
                    if b"listening on" in f.read():
                        return
            except OSError:
                pass
            time.sleep(0.1)

    def _last_commit(self, i: int) -> int:
        """Highest `commit=N` progress marker in replica i's log (0 if
        none yet)."""
        try:
            with open(self._log_path(i), "rb") as f:
                text = f.read()
        except OSError:
            return 0
        n = 0
        for line in text.splitlines():
            if line.startswith(b"commit="):
                try:
                    n = int(line[len(b"commit="):])
                except ValueError:
                    pass
        return n

    def wait_caught_up(self, timeout_s: float = 30.0) -> None:
        """Block until every live replica reports the same commit level.
        Once a workload completes, the cluster commit number is fixed —
        but a backup that joined late (slow torch import) is still
        replaying; stopping it mid-catch-up would dump a trace with no
        commit stages, and scraping it early would show commit-free
        metrics. Equality is stable once reached (quiesced workload)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            live = [i for i, p in enumerate(self.procs)
                    if p is not None and p.poll() is None]
            if len({self._last_commit(i) for i in live}) <= 1:
                return
            time.sleep(0.1)

    def shutdown(self) -> None:
        self.heal_all()
        for i, proc in enumerate(self.procs):
            if proc is not None:
                self._wait_listening(i)
        self.wait_caught_up()
        for proc in self.procs:
            if proc is not None:
                proc.send_signal(signal.SIGINT)
        for i, proc in enumerate(self.procs):
            if proc is not None:
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    proc.kill()
        for proxy in self.proxies:
            proxy.close()

    def scrape_metrics(self, i: int, timeout_s: float = 30.0) -> str:
        """GET replica i's live /metrics exposition (metrics=True
        required). Retries connection refusals until the deadline: the
        cluster commits on a 2-of-3 quorum, so a client can make
        progress while the third replica is still opening (its endpoint
        not yet bound)."""
        import urllib.error
        import urllib.request

        assert self.metrics, "metrics=True required"
        url = f"http://127.0.0.1:{self.metrics_ports[i]}/metrics"
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                with urllib.request.urlopen(url, timeout=5.0) as resp:
                    return resp.read().decode()
            except (urllib.error.URLError, ConnectionError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)

    def collect_merged_trace(self, out_path: Optional[str] = None) -> dict:
        """After shutdown: merge every replica's dumped Chrome trace
        into one cluster-wide Perfetto document (pid = replica id, the
        tracers' wall-clock anchors give the common timeline). Replicas
        that died without dumping (SIGKILL) are simply absent."""
        from ..trace import merge_trace_files

        paths = [self.trace_path(i) for i in range(self.replica_count)
                 if os.path.exists(self.trace_path(i))]
        assert paths, "no replica dumped a trace (trace=True required)"
        return merge_trace_files(paths, out_path)

    def verify_data_files(self) -> None:
        """After shutdown: every data file must pass full integrity
        verification (reference: vortex's post-run liveness+consistency
        checks)."""
        for i in range(self.replica_count):
            out = subprocess.run(
                [sys.executable, "-m", MODULE, "inspect",
                 "--small", "--integrity", self._data_path(i)],
                capture_output=True, text=True, cwd=REPO_ROOT,
                timeout=120)
            assert out.returncode == 0, f"r{i}: {out.stdout}"
