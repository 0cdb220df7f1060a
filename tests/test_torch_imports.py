"""Import hygiene of the PyTorch port: `tigerbeetle_tpu_torch` and
`chip_smoke.py` import neither JAX nor the JAX package nor the TPU probe
scripts of `onchip/`, the port's modules import nothing that needs a
card or a compiler at import time, and the port reads no environment
variable (VERIFY, the spot rate and the flight directory are set by
call)."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tigerbeetle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tigerbeetle_tpu", "onchip")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tigerbeetle_tpu_torch, tigerbeetle_tpu_torch.ops."
        "ledger, tigerbeetle_tpu_torch.ops.state_epoch, "
        "tigerbeetle_tpu_torch.oracle, tigerbeetle_tpu_torch.ops.batch, "
        "tigerbeetle_tpu_torch.ops.create_kernels, "
        "tigerbeetle_tpu_torch.ops.create_seq, "
        "tigerbeetle_tpu_torch.ops.lazy_mirror, "
        "tigerbeetle_tpu_torch.multi_batch, "
        "tigerbeetle_tpu_torch.state_machine, "
        "tigerbeetle_tpu_torch.trace, tigerbeetle_tpu_torch.serving, "
        "tigerbeetle_tpu_torch.admission, "
        "tigerbeetle_tpu_torch.utils.zipfian, "
        "tigerbeetle_tpu_torch.testing.chaos, tigerbeetle_tpu_torch.ewah, "
        "tigerbeetle_tpu_torch.lsm, tigerbeetle_tpu_torch.lsm.query, "
        "tigerbeetle_tpu_torch.lsm.scan, "
        "tigerbeetle_tpu_torch.lsm.manifest_level, "
        "tigerbeetle_tpu_torch.lsm.cache_map, "
        "tigerbeetle_tpu_torch.lsm.k_way_merge, "
        "tigerbeetle_tpu_torch.lsm.zig_zag_merge, "
        "tigerbeetle_tpu_torch.lsm.schema, tigerbeetle_tpu_torch.vsr, "
        "tigerbeetle_tpu_torch.vsr.durable, "
        "tigerbeetle_tpu_torch.vsr.storage, "
        "tigerbeetle_tpu_torch.vsr.superblock, "
        "tigerbeetle_tpu_torch.main, tigerbeetle_tpu_torch.native, "
        "tigerbeetle_tpu_torch.multiversion, "
        "tigerbeetle_tpu_torch.vsr.journal, "
        "tigerbeetle_tpu_torch.vsr.client_sessions, "
        "tigerbeetle_tpu_torch.vsr.clock, "
        "tigerbeetle_tpu_torch.vsr.fault_detector, "
        "tigerbeetle_tpu_torch.vsr.repair_budget, "
        "tigerbeetle_tpu_torch.vsr.grid_scrubber, "
        "tigerbeetle_tpu_torch.vsr.snapshot, "
        "tigerbeetle_tpu_torch.vsr.replica, "
        "tigerbeetle_tpu_torch.vsr.message_bus, "
        "tigerbeetle_tpu_torch.vsr.client, "
        "tigerbeetle_tpu_torch.clients.common, "
        "tigerbeetle_tpu_torch.testing.cluster, "
        "tigerbeetle_tpu_torch.trace.merge, "
        "tigerbeetle_tpu_torch.trace.slo, tigerbeetle_tpu_torch.benchmark, "
        "tigerbeetle_tpu_torch.aof, tigerbeetle_tpu_torch.metrics, "
        "tigerbeetle_tpu_torch.repl, tigerbeetle_tpu_torch.cdc, "
        "tigerbeetle_tpu_torch.amqp, tigerbeetle_tpu_torch.testing, "
        "tigerbeetle_tpu_torch.testing.workload, "
        "tigerbeetle_tpu_torch.testing.vopr, "
        "tigerbeetle_tpu_torch.testing.fuzz, "
        "tigerbeetle_tpu_torch.testing.vortex, "
        "tigerbeetle_tpu_torch.testing.snap, tigerbeetle_tpu_torch.devhub, "
        "tigerbeetle_tpu_torch.trace.alerts, "
        "tigerbeetle_tpu_torch.trace.memwatch, "
        "tigerbeetle_tpu_torch.trace.profiler, "
        "tigerbeetle_tpu_torch.parallel, "
        "tigerbeetle_tpu_torch.parallel.shard_utils, "
        "tigerbeetle_tpu_torch.parallel.full_sharded, "
        "tigerbeetle_tpu_torch.parallel.partitioned, "
        "tigerbeetle_tpu_torch.convert, tigerbeetle_tpu_torch.clients, "
        "tigerbeetle_tpu_torch.clients.c_client, "
        "tigerbeetle_tpu_torch.clients.codegen, "
        "tigerbeetle_tpu_torch.clients.codegen_dotnet, "
        "tigerbeetle_tpu_torch.clients.codegen_java, "
        "tigerbeetle_tpu_torch.clients.codegen_ruby, "
        "tigerbeetle_tpu_torch.clients.codegen_rust, "
        "tigerbeetle_tpu_torch.clients.syntax_check, "
        "tigerbeetle_tpu_torch.testing.trace_coverage, "
        "tigerbeetle_tpu_torch.torchhound, "
        "tigerbeetle_tpu_torch.torchhound.__main__, "
        "tigerbeetle_tpu_torch.torchhound.cli, "
        "tigerbeetle_tpu_torch.torchhound.core, "
        "tigerbeetle_tpu_torch.torchhound.determinism, "
        "tigerbeetle_tpu_torch.torchhound.hostdet, "
        "tigerbeetle_tpu_torch.torchhound.registry, "
        "tigerbeetle_tpu_torch.torchhound.retrace, "
        "tigerbeetle_tpu_torch.torchhound.shardspec, "
        "tigerbeetle_tpu_torch.testing.static_smoke, "
        "tigerbeetle_tpu_torch.torchhound.opbudget, "
        "tigerbeetle_tpu_torch.testing.chain_smoke, "
        "tigerbeetle_tpu_torch.testing.partitioned_chain_smoke, "
        "tigerbeetle_tpu_torch.testing.overlap_smoke, "
        "tigerbeetle_tpu_torch.testing.reshard_smoke, "
        "tigerbeetle_tpu_torch.testing.telemetry_smoke, "
        "tigerbeetle_tpu_torch.testing.overload_smoke, "
        "tigerbeetle_tpu_torch.testing.observatory_smoke, "
        "tigerbeetle_tpu_torch.budget_trail\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_sources_name_no_jax_module(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "tigerbeetle_tpu." not in text.replace("tigerbeetle_tpu_torch",
                                                  "")
    assert "import onchip" not in text and "from onchip" not in text


def test_the_serving_modules_are_the_ports_own():
    """The serving path's modules exist in the port and import nothing
    of the JAX package (the AST check above covers their sources): the
    StateMachine, the multi-batch codec, the lazy mirror, the supervisor,
    the admission plane, the trace core, the Zipfian generator and the
    chaos harness."""
    for name in ("state_machine.py", "multi_batch.py",
                 "ops/lazy_mirror.py", "serving.py", "admission.py",
                 "trace/__init__.py", "trace/context.py", "trace/event.py",
                 "trace/histogram.py", "trace/statsd.py", "trace/tracer.py",
                 "trace/flight_recorder.py", "utils/zipfian.py",
                 "testing/chaos.py"):
        assert (PORT / name) in _sources(), name


def test_the_operators_modules_are_the_ports_own():
    """The benchmark harness and the operator's side of the server exist
    in the port (the AST check above covers their sources, the import
    check above their imports)."""
    for name in ("benchmark.py", "aof.py", "trace/slo.py", "metrics.py",
                 "repl.py", "cdc.py", "amqp.py"):
        assert (PORT / name) in _sources(), name


def test_the_static_verifiers_modules_are_the_ports_own():
    """torchhound, the counterpart of the JAX package's jaxhound/, and the
    static leg exist in the port (the AST checks above cover their
    sources, the import checks their imports)."""
    for name in ("torchhound/__init__.py", "torchhound/__main__.py",
                 "torchhound/cli.py", "torchhound/core.py",
                 "torchhound/determinism.py", "torchhound/hostdet.py",
                 "torchhound/registry.py", "torchhound/retrace.py",
                 "torchhound/shardspec.py", "testing/static_smoke.py",
                 "budget_trail.py"):
        assert (PORT / name) in _sources(), name


def test_the_drivers_modules_are_the_ports_own():
    """The test drivers exist in the port (the AST checks above cover
    their sources, the import checks their imports): the workload and
    auditor, the VOPR swarm, the fuzzer registry, vortex, snapshot
    assertions, devhub and the alert rules it reads."""
    for name in ("testing/workload.py", "testing/vopr.py",
                 "testing/fuzz.py", "testing/vortex.py", "testing/snap.py",
                 "devhub.py", "trace/alerts.py"):
        assert (PORT / name) in _sources(), name


def test_the_observatory_and_mesh_modules_are_the_ports_own():
    """The performance observatory (the dispatch profiler, the memory
    watermarks and the alert engine, with the port's own budget file)
    and the replicated-state mesh route exist in the port (the AST
    checks above cover their sources, the import check their imports)."""
    for name in ("trace/profiler.py", "trace/memwatch.py",
                 "trace/alerts.py", "parallel/__init__.py",
                 "parallel/shard_utils.py", "parallel/full_sharded.py"):
        assert (PORT / name) in _sources(), name
    assert (PORT / "trace" / "membudget.json").is_file()
    from tigerbeetle_tpu_torch.trace.alerts import AlertEngine  # noqa: F401
    import tigerbeetle_tpu_torch.ops.fast_kernels as fk
    assert not hasattr(fk, "_later_slices")


def test_the_partitioned_route_is_the_ports_own():
    """The partitioned-state mesh route and the state carry-over exist in
    the port (the AST checks above cover their sources: no JAX, nothing of
    the JAX package, no environment read); the telemetry block's width
    lives with the route, and memwatch reads it from there."""
    for name in ("parallel/partitioned.py", "convert.py"):
        assert (PORT / name) in _sources(), name
    from tigerbeetle_tpu_torch import convert
    from tigerbeetle_tpu_torch.parallel import partitioned
    from tigerbeetle_tpu_torch.trace import memwatch

    assert callable(convert.partitioned_from_numpy)
    assert callable(convert.partitioned_to_numpy)
    assert partitioned.TEL_WORDS == len(partitioned.TEL_LAYOUT) == 12
    assert not hasattr(memwatch, "TEL_WORDS")
    assert "from ..parallel.partitioned import TEL_WORDS" in (
        PORT / "trace" / "memwatch.py").read_text()


def test_the_drivers_name_the_ports_package_and_no_fixed_path():
    """vortex spawns `python -m tigerbeetle_tpu_torch` from the
    checkout's own root; no driver names a fixed directory."""
    import tigerbeetle_tpu_torch.testing.vortex as vortex

    assert vortex.MODULE == "tigerbeetle_tpu_torch"
    assert pathlib.Path(vortex.REPO_ROOT) == REPO
    for name in ("testing/vortex.py", "testing/fuzz.py", "testing/vopr.py",
                 "devhub.py", "main.py"):
        text = (PORT / name).read_text()
        assert 'cwd="/' not in text and '"-m", "tigerbeetle_tpu"' \
            not in text, name


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_sources_read_no_environment(path):
    """No `os.environ` / `os.getenv` / `os.putenv` anywhere in the port or
    chip_smoke.py: the JAX package's TB_VERIFY, TB_VERIFY_SPOT_RATE and
    TB_TPU_FLIGHT_DIR become constants.set_verify,
    DeviceLedger.verify_spot_rate and FlightRecorder(dump_dir=...)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv", "putenv",
                                     "environb"), (path, node.attr)
        if isinstance(node, ast.Name):
            assert node.id not in ("environ", "getenv"), (path, node.id)


def test_the_durable_modules_are_the_ports_own():
    """The durable layer's modules exist in the port (the AST check above
    covers their sources): the EWAH codec, `vsr/` (checksum, header,
    storage, superblock, durable) and `lsm/` (schema, cache map, grid,
    manifest levels, tables, trees, the forest, the merges, scans and
    the forest queries)."""
    for name in ("ewah.py", "vsr/__init__.py", "vsr/checksum.py",
                 "vsr/header.py", "vsr/storage.py", "vsr/superblock.py",
                 "vsr/durable.py", "lsm/__init__.py", "lsm/schema.py",
                 "lsm/cache_map.py", "lsm/grid.py", "lsm/manifest_level.py",
                 "lsm/table.py", "lsm/tree.py", "lsm/forest.py",
                 "lsm/k_way_merge.py", "lsm/zig_zag_merge.py",
                 "lsm/scan.py", "lsm/query.py"):
        assert (PORT / name) in _sources(), name


def test_port_modules_import_no_triton_or_build_at_import():
    code = (
        "import sys, tigerbeetle_tpu_torch.ops.fused_probe as fp\n"
        "import tigerbeetle_tpu_torch.ops.row_gather\n"
        "import tigerbeetle_tpu_torch.ops.ledger\n"
        "import tigerbeetle_tpu_torch.ops.create_seq as cs\n"
        "import tigerbeetle_tpu_torch.ops.create_kernels\n"
        "import tigerbeetle_tpu_torch.oracle\n"
        "import tigerbeetle_tpu_torch.state_machine\n"
        "import tigerbeetle_tpu_torch.serving\n"
        "import tigerbeetle_tpu_torch.admission\n"
        "import tigerbeetle_tpu_torch.testing.chaos\n"
        "import tigerbeetle_tpu_torch.vsr.durable\n"
        "import tigerbeetle_tpu_torch.lsm.query\n"
        "import tigerbeetle_tpu_torch.testing.vopr\n"
        "import tigerbeetle_tpu_torch.testing.fuzz\n"
        "import tigerbeetle_tpu_torch.main\n"
        "assert cs._launch == {}\n"
        "assert 'triton' not in sys.modules\n"
        "assert fp._build._libs == {}\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_replica_modules_are_the_ports_own():
    """The replica server's modules exist in the port (the AST checks
    above cover their sources): the entry points, the native storage
    engine's binding and its C++ sources, the release tracker, the
    journal, client sessions, clock, fault detector, repair budget, grid
    scrubber, snapshot codec, replica, message bus, client, the typed
    client helpers, the in-process cluster and the trace merge."""
    for name in ("main.py", "__main__.py", "native.py", "multiversion.py",
                 "vsr/journal.py", "vsr/client_sessions.py", "vsr/clock.py",
                 "vsr/fault_detector.py", "vsr/repair_budget.py",
                 "vsr/grid_scrubber.py", "vsr/snapshot.py",
                 "vsr/replica.py", "vsr/message_bus.py", "vsr/client.py",
                 "clients/__init__.py", "clients/common.py",
                 "testing/cluster.py", "trace/merge.py"):
        assert (PORT / name) in _sources(), name
    for name in ("storage_engine.cpp", "blake2b.h"):
        assert (PORT / "csrc" / name).exists(), name


def test_the_native_engine_builds_at_first_use_only():
    """Importing the replica, the storage and the entry points builds
    nothing: `g++` runs at the first `native.load()`, into the port's own
    build directory."""
    code = (
        "import tigerbeetle_tpu_torch.native as nat\n"
        "import tigerbeetle_tpu_torch.vsr.storage\n"
        "import tigerbeetle_tpu_torch.vsr.replica\n"
        "import tigerbeetle_tpu_torch.main\n"
        "assert nat._lib is None and not nat._tried\n"
        "assert nat.library_path().startswith(nat.BUILD_DIR)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_gate_and_the_clients_are_the_ports_own():
    """The trace-catalog gate, the C client's binding and source, and the
    client generators exist in the port (the AST checks above cover their
    sources); importing them builds nothing: `g++` runs at the first
    `native.load_client()`, into the port's own build directory."""
    for name in ("testing/trace_coverage.py", "clients/c_client.py",
                 "clients/codegen.py", "clients/codegen_dotnet.py",
                 "clients/codegen_java.py", "clients/codegen_ruby.py",
                 "clients/codegen_rust.py", "clients/syntax_check.py"):
        assert (PORT / name) in _sources(), name
    assert (PORT / "csrc" / "tb_client.cpp").is_file()
    code = (
        "import tigerbeetle_tpu_torch.native as nat\n"
        "import tigerbeetle_tpu_torch.clients\n"
        "import tigerbeetle_tpu_torch.clients.codegen\n"
        "import tigerbeetle_tpu_torch.testing.trace_coverage\n"
        "import tigerbeetle_tpu_torch.main\n"
        "assert nat._client_lib is None and not nat._client_tried\n"
        "p = nat.library_path(nat._CLIENT_SRC, 'tb_client')\n"
        "assert p.startswith(nat.BUILD_DIR) and 'libtb_client_' in p\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_gate_legs_and_the_op_budget_are_the_ports_own():
    """The JAX gate's seven device legs and the op budget exist in the
    port (the AST checks above cover their sources, the import check
    their imports), with the budget the port pinned."""
    for name in ("testing/chain_smoke.py", "testing/partitioned_chain_smoke.py",
                 "testing/overlap_smoke.py", "testing/reshard_smoke.py",
                 "testing/telemetry_smoke.py", "testing/overload_smoke.py",
                 "testing/observatory_smoke.py", "torchhound/opbudget.py"):
        assert (PORT / name) in _sources(), name
    assert (PORT / "trace" / "opbudget_r01.json").exists()
