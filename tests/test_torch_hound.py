"""torchhound, the port's static verifier, held to the JAX package's
jaxhound on the same fixtures (on the CPU).

- hostdet: the port's `scan_source` equals the JAX package's on the JAX
  tests' fixtures and on every file of the port's replay scope (pragma
  name mapped), and that scope is clean;
- every rule of the device passes: the port's fixture REDs the rule name
  the JAX fixture REDs, and each paired clean form stays clean;
- the capture auditor's signature rules equal the JAX package's on the
  same argument drivers; the committed tracebudget's schema and
  check_budget's REDs;
- the registry: every JAX entry name maps onto a port entry and back;
- the census and its lints; the CLI's JSON and exit codes;
  `main.py torchhound`.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.jaxhound import determinism as J_det
from tigerbeetle_tpu.jaxhound import hostdet as J_host
from tigerbeetle_tpu.jaxhound import retrace as J_retrace
from tigerbeetle_tpu.jaxhound.registry import Entry as J_Entry
from tigerbeetle_tpu_torch import main as P_main
from tigerbeetle_tpu_torch.parallel.shard_utils import Mesh, psum
from tigerbeetle_tpu_torch.torchhound import (cli, core, determinism,
                                              hostdet, registry, retrace,
                                              shardspec)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tigerbeetle_tpu_torch"


def _jax_pragmas(src: str) -> str:
    return src.replace("# torchhound: allow(", "# jaxhound: allow(")


# ------------------------------------------------------ host determinism

# The JAX tests' host fixtures (tests/test_jaxhound_static.py), each
# with a port pragma where it has one.
HOST_FIXTURES = {
    "wall_clock": "import time\n\ndef f():\n    return time.time()\n",
    "pragma": ("import time\n\ndef f():\n    return time.time()"
               "  # torchhound: allow(wall_clock)\n"),
    "wrong_pragma": ("import time\n\ndef f():\n    return time.time()"
                     "  # torchhound: allow(env_read)\n"),
    "alias": "import time as _t\n\ndef f():\n    return _t.monotonic()\n",
    "injected": ("class C:\n    def f(self):\n"
                 "        return self.time.monotonic()\n"),
    "random": "import random\n\ndef f():\n    return random.random()\n",
    "seeded": ("import random\n\ndef f():\n"
               "    return random.Random(7).random()\n"),
    "np_random": ("import numpy\n\ndef f():\n"
                  "    return numpy.random.randint(3)\n"),
    "np_rng": ("import numpy\n\ndef f():\n"
               "    return numpy.random.default_rng(7).integers(3)\n"),
    "set_iter": "def f(xs):\n    return [x for x in set(xs)]\n",
    "sorted_set": "def f(xs):\n    return [x for x in sorted(set(xs))]\n",
    "environ": "import os\n\ndef f():\n    return os.environ['X']\n",
    "getenv": "import os\n\ndef f():\n    return os.getenv('X')\n",
    "datetime": ("import datetime\n\ndef f():\n"
                 "    return datetime.datetime.now()\n"),
}


@pytest.mark.parametrize("name", sorted(HOST_FIXTURES))
def test_hostdet_equals_the_jax_lint_on_its_fixtures(name):
    src = HOST_FIXTURES[name]
    got = hostdet.scan_source(src, "fx.py")
    assert got == J_host.scan_source(_jax_pragmas(src), "fx.py")
    if name in ("wall_clock", "wrong_pragma", "alias", "random",
                "np_random", "set_iter", "environ", "getenv", "datetime"):
        assert got, name
    else:
        assert got == [], name


def test_hostdet_equals_the_jax_lint_on_the_ports_scope():
    """Every file of the port's replay scope: the same findings from both
    lints (none), with the pragma name mapped; the scope lists the JAX
    package's five paths under the port."""
    files = hostdet.scope_files()
    assert len(files) >= 10
    assert hostdet.SCOPE == tuple(
        p.replace("tigerbeetle_tpu/", "tigerbeetle_tpu_torch/")
        for p in J_host.SCOPE)
    for path in files:
        src = pathlib.Path(path).read_text()
        rel = str(pathlib.Path(path).relative_to(REPO))
        assert hostdet.scan_source(src, rel) == J_host.scan_source(
            _jax_pragmas(src), rel), rel
    assert hostdet.run() == []


def test_the_ports_pragmas_carry_the_jax_packages():
    """The seven JAX pragmas of the copied modules carry over, and the
    supervisor's three recovery-timing reads carry one each: without the
    pragmas the scope gives 10 findings."""
    n = 0
    for path in hostdet.scope_files():
        src = pathlib.Path(path).read_text()
        n += len(hostdet.scan_source(
            src.replace("# torchhound: allow(", "# x: allow("), path))
    assert n == 10


def test_torchhound_pragmas_name_real_rules():
    """Every `# torchhound: allow(<rule>)` pragma in the port names a
    rule hostdet enforces (a typo'd pragma suppresses nothing)."""
    seen = 0
    for path in sorted(PORT.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = hostdet._PRAGMA_RE.search(line)
            if m is None:
                continue
            seen += 1
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            unknown = rules - set(hostdet.RULES)
            assert not unknown, (path, i, sorted(unknown))
    assert seen >= 10


# ----------------------------------------------------- device determinism

def _jax_float_psum(dt):
    return jax.make_jaxpr(lambda x: jax.lax.psum(x, "i"),
                          axis_env=[("i", 2)])(jnp.ones(4, dt))


def _jax_rng(threaded):
    if threaded:
        return jax.make_jaxpr(lambda k, x: x + jax.random.uniform(k, (4,)))(
            jax.random.PRNGKey(0), jnp.ones(4))
    return jax.make_jaxpr(
        lambda x: x + jax.random.uniform(jax.random.PRNGKey(0), (4,)))(
        jnp.ones(4))


def _jax_callback(_clean):
    if _clean:
        return jax.make_jaxpr(lambda x: x * 2)(jnp.ones(4, jnp.float32))
    return jax.make_jaxpr(lambda x: jax.pure_callback(
        lambda v: np.asarray(v) * 2,
        jax.ShapeDtypeStruct((4,), jnp.float32), x))(
        jnp.ones(4, jnp.float32))


def _jax_scatter(dt):
    idx = jnp.zeros((4, 1), jnp.int32)
    return jax.make_jaxpr(lambda x, u: x.at[idx[:, 0]].add(u))(
        jnp.ones(8, dt), jnp.ones(4, dt))


def _torch_psum(dt):
    return core.trace(psum, Mesh(["cpu"] * 2),
                      [torch.ones(4, dtype=dt)] * 2)


def _torch_rng(threaded):
    gen = torch.Generator().manual_seed(0)
    kw = {"generator": gen} if threaded else {}
    return core.trace(lambda x: x + torch.rand(4, **kw), torch.ones(4))


def _torch_sync(how):
    x = torch.arange(8)
    fns = {
        "item": lambda v: v.sum().item(),
        "bool": lambda v: bool((v > 3).any()),
        "nonzero": lambda v: v.nonzero(),
        "mask": lambda v: v[v > 3],
        "clean": lambda v: torch.where(v > 3, v, 0),
    }
    return core.trace(fns[how], x)


def _torch_scatter(dt):
    return core.trace(lambda x, i, u: x.index_add_(0, i, u),
                      torch.ones(8, dtype=dt), torch.zeros(4, dtype=torch.long),
                      torch.ones(4, dtype=dt))


DEVICE_RULES = [
    ("float_collective", lambda: _jax_float_psum(jnp.float32),
     lambda: _jax_float_psum(jnp.int32), lambda: _torch_psum(torch.float32),
     lambda: _torch_psum(torch.int64)),
    ("rng_no_key", lambda: _jax_rng(False), lambda: _jax_rng(True),
     lambda: _torch_rng(False), lambda: _torch_rng(True)),
    ("host_callback", lambda: _jax_callback(False),
     lambda: _jax_callback(True), lambda: _torch_sync("item"),
     lambda: _torch_sync("clean")),
    ("float_scatter_dup", lambda: _jax_scatter(jnp.float32),
     lambda: _jax_scatter(jnp.int32), lambda: _torch_scatter(torch.float32),
     lambda: _torch_scatter(torch.int64)),
]


@pytest.mark.parametrize("rule,j_red,j_clean,t_red,t_clean", DEVICE_RULES,
                         ids=[r[0] for r in DEVICE_RULES])
def test_device_rule_reds_as_the_jax_pass_does(rule, j_red, j_clean, t_red,
                                               t_clean):
    def rules(findings):
        return {f.split(":")[0] for f in findings}

    assert rule in rules(J_det.findings_for(j_red(), "t"))
    assert rule not in rules(J_det.findings_for(j_clean(), "t"))
    assert rule in rules(determinism.findings_for(t_red(), "t"))
    assert determinism.findings_for(t_clean(), "t") == []


@pytest.mark.parametrize("how", ["item", "bool", "nonzero", "mask"])
def test_every_host_round_trip_is_a_host_callback(how):
    found = determinism.findings_for(_torch_sync(how), "t")
    assert found and all(f.startswith("host_callback:") for f in found)


# --------------------------------------------------------------- census

def test_census_classes_and_lints():
    """The heavy classes of a small call, its kernel-free census, and the
    lints: a host-made table copied to another device above 4 KiB, host
    syncs, an oversized collective part."""
    def f(x, i, t):
        s, _ = torch.sort(x)
        g = x[i]
        x.index_put_((i,), g)
        x.index_add_(0, i, g)
        c = torch.cumsum(x, 0)
        psum(Mesh(["cpu"] * 2), [c, c])
        big = torch.ones(2048, dtype=torch.int64).to("meta")
        small = torch.ones(8).to("meta")
        return s, big, small, t.sum().item()

    tr = core.trace(f, torch.arange(16), torch.tensor([1, 2]),
                    torch.ones(3))
    census = core.heavy_census(tr)
    assert census["heavy"] == {"sort": 1, "gather": 1, "scatter": 1,
                               "segment_sum": 1, "scan": 1,
                               "collective": 1}
    assert census["collective_operand_bytes"] == 2 * 16 * 8
    assert core.closure_constants(tr) == [("int64[2048]", 16384)]
    assert core.while_ops(tr) == 1
    assert core.state_gathers(tr, limit=64) == [("psum", 128)]
    assert core.state_gathers(tr) == []
    assert tr.launches == {"ht_probe": 0, "row_gather": 0}


def test_flat_entry_census_counts_its_kernel_calls():
    """The flat tier calls the probe once and the row gather four times
    (PERF.md section 3), launching neither on the CPU; it is
    determinism-clean, syncs nothing and keeps its state in place."""
    entry = registry.entries("cpu", include_mesh=False)[
        "create_transfers_fast"]
    tr = entry.trace()
    assert tr.kernel_calls == {"ht_probe": 1, "row_gather": 4}
    assert tr.launches == {"ht_probe": 0, "row_gather": 0}
    assert determinism.findings_for(tr) == []
    assert core.while_ops(tr) == 0 and core.closure_constants(tr) == []
    assert retrace.weak_carries(tr, "t", "flat") == []
    assert len(tr.state_before) == entry.n_state_leaves


# ------------------------------------------------------ capture auditor

SIGNATURE_DRIVERS = {
    "window_axis": lambda d: (np.zeros((d, 16), np.int32), np.uint64(5)),
    "dtype_drift": lambda d: (np.zeros(8, np.int32 if d < 8 else np.int64),),
    "weak_flap": lambda d: (7 if d == 1 else np.int32(7),),
    "not_as_w": lambda d: (np.zeros((d * 2, 4), np.int32),),
    "rank": lambda d: (np.zeros((d,) * (1 + (d > 2)), np.int32),),
}


@pytest.mark.parametrize("name", sorted(SIGNATURE_DRIVERS))
def test_signature_rules_equal_the_jax_auditors(name):
    make = SIGNATURE_DRIVERS[name]
    j = J_Entry(name="t", route="flat", jit_fn=None, raw_fn=None,
                make_args=make, depths=(1, 2, 8, 32))
    p = registry.Entry(name="t", route="flat", fn=None, make_args=make,
                       depths=(1, 2, 8, 32))
    j_canon, j_fails = J_retrace.canonical_signature(j)
    p_canon, p_fails = retrace.canonical_signature(p)
    assert ({f.split(":")[0] for f in p_fails}
            == {f.split(":")[0] for f in j_fails})
    assert [c[0] for c in p_canon] == [c[0] for c in j_canon]
    if name == "window_axis":
        assert p_fails == [] and p_canon[0][0] == ("W", 16)


def test_weak_carry_reds_as_the_jax_check_does():
    """A state leaf rebuilt in new storage, or a poison carry that is not
    a 0-dim bool, REDs `weak_carry`, as a weak-typed scan carry does in
    the JAX package; the in-place form stays clean."""
    def weak(x):
        def body(c, xi):
            return c + 1, xi
        return jax.lax.scan(body, 0, x)[0]

    assert any("weak_carry" in f for f in J_retrace.weak_carries(
        jax.make_jaxpr(weak)(jnp.zeros(3, jnp.int32)), "t"))

    def rebuild(state):
        state["x"] = state["x"] + 1
        return state, {"fallback": torch.zeros((), dtype=torch.bool)}

    def int_carry(state):
        state["x"].add_(1)
        return state, {"fallback": torch.zeros((), dtype=torch.int64)}

    def in_place(state):
        state["x"].add_(1)
        return state, {"fallback": torch.zeros((), dtype=torch.bool)}

    for fn in (rebuild, int_carry):
        got = retrace.weak_carries(core.trace(fn, {"x": torch.zeros(4)}),
                                   "t")
        assert got and all(": weak_carry:" in f for f in got)
    assert retrace.weak_carries(
        core.trace(in_place, {"x": torch.zeros(4)}), "t") == []


def test_committed_tracebudget_schema():
    """The committed pin: every registry entry with the full schema, one
    signature each, the chains over the whole W matrix; check_budget is
    clean against it, and the newest round resolves to it."""
    path = PORT / "trace" / "tracebudget_r01.json"
    doc = json.loads(path.read_text())
    assert doc["round"] == 1
    assert doc["matrix"]["depths"] == [1, 2, 8, 32]
    entries = doc["entries"]
    assert set(entries) == set(registry.JAX_NAMES.values())
    for name, e in entries.items():
        assert set(e) == {"route", "depths", "n_signatures", "n_leaves",
                          "digest"}, name
        assert e["n_signatures"] == 1 and e["n_leaves"] > 0, name
        if e["route"] in ("chain", "partitioned_chain"):
            assert e["depths"] == [1, 2, 8, 32], name
    assert core.newest_tracebudget_path() == str(path)
    assert retrace.check_budget(registry.entries("cpu"),
                                budget_path=str(path)) == []


def test_budget_drift_missing_and_new_entries_red(tmp_path):
    table = {"e": {"route": "flat", "depths": [1], "n_signatures": 1,
                   "n_leaves": 2, "digest": "a" * 16},
             "fresh": {"route": "flat", "depths": [1], "n_signatures": 2,
                       "n_leaves": 2, "digest": "c" * 16}}
    path = tmp_path / "tracebudget_r02.json"
    path.write_text(json.dumps({"entries": {
        "e": dict(table["e"], digest="b" * 16),
        "gone": dict(table["e"])}}))
    fails = retrace.check_budget({}, budget_path=str(path), table=table)
    assert any("e: canonical signature digest" in f for f in fails)
    assert any("gone: pinned" in f and "missing from the registry" in f
               for f in fails)
    assert any("fresh: not pinned" in f for f in fails)
    (tmp_path / "tracebudget_r01.json").write_text("{}")
    assert core.newest_tracebudget_path(str(tmp_path)) == str(path)
    with pytest.raises(FileNotFoundError):
        core.newest_tracebudget_path(str(tmp_path / "none"))


def test_budget_trail_family_equals_the_jax_helper(tmp_path):
    """`budget_trail.newest_round_path` resolves the newest round of each
    family as JAX `jaxhound.core._newest_round_path` does, and neither
    it nor devhub, whose panels use it, loads torchhound."""
    import subprocess
    import sys

    from tigerbeetle_tpu.jaxhound import core as J_core
    from tigerbeetle_tpu_torch.budget_trail import newest_round_path

    for name in ("opbudget_r01.json", "opbudget_r10.json",
                 "opbudget_r9.json", "tracebudget_r02.json",
                 "membudget_r03.json", "opbudget_rx.json"):
        (tmp_path / name).write_text("{}")
    for prefix in ("opbudget", "tracebudget", "membudget"):
        assert newest_round_path(str(tmp_path), prefix) == (
            J_core._newest_round_path(str(tmp_path), prefix)), prefix
    assert newest_round_path(str(tmp_path), "opbudget").endswith(
        "opbudget_r10.json")
    with pytest.raises(FileNotFoundError):
        newest_round_path(str(tmp_path), "nosuchbudget")
    code = ("import sys, tigerbeetle_tpu_torch.budget_trail\n"
            "import tigerbeetle_tpu_torch.devhub\n"
            "heavy = [m for m in sys.modules if 'torchhound' in m]\n"
            "assert not heavy, heavy\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------- partitioned layout

def _per_shard_fixture(whole: bool):
    mesh = Mesh(["cpu"] * 8)
    if whole:
        t = torch.zeros((8, 128), dtype=torch.int64)
        state = tuple(t for _ in range(8))
    else:
        state = tuple(torch.zeros((1, 128), dtype=torch.int64)
                      for _ in range(8))

    def step(st):
        for s in st:
            s.add_(1)
        return st, {}

    tr = core.trace(step, state)
    expect = torch.empty((1, 128), dtype=torch.int64, device="meta")
    return (shardspec.verify_layout(mesh, state, expect, 1, "t")
            + shardspec.verify_step(tr, mesh, "t"))


def test_replicated_state_reds_as_the_jax_verifier_does():
    """The shard state replicated at whole size in one storage REDs, as
    the JAX fixture's replicated donated state does
    (tests/test_jaxhound_static.py::test_replicated_donated_state_reds)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

    from tigerbeetle_tpu.jaxhound import shardspec as J_shard

    jmesh = JMesh(np.array(jax.devices()[:8]), ("batch",))
    sh = NamedSharding(jmesh, P())
    low = jax.jit(shard_map(lambda s: s + 1, mesh=jmesh, in_specs=P(),
                            out_specs=P()),
                  in_shardings=sh, out_shardings=sh, donate_argnums=0
                  ).lower(np.zeros((8, 128), np.int64))
    assert any("donated" in f for f in J_shard.verify_lowered(low, 1, "n"))
    got = _per_shard_fixture(whole=True)
    assert any(": replicated_state:" in f for f in got)
    assert any(": shared_storage:" in f for f in got)


def test_per_shard_state_clean():
    """The counterpart of the JAX seed test test_batch_sharded_state_clean:
    one (1, 128) state a shard, each its own storage, written in place."""
    assert _per_shard_fixture(whole=False) == []


def test_moved_state_and_state_sized_operands_red():
    mesh = Mesh(["cpu"] * 2)
    state = (torch.zeros(4, dtype=torch.int64),
             torch.zeros(4, dtype=torch.int64))

    def rebuild(st, table):
        return tuple(s + 1 for s in st), {}

    def ship(st, table):
        psum(mesh, [table, table])
        for s in st:
            s.add_(1)
        return st, {}

    moved = shardspec.verify_step(
        core.trace(rebuild, state, torch.zeros(1)), mesh, "t")
    assert any(": moved_state:" in f for f in moved)
    big = torch.zeros(8, dtype=torch.int64)
    shipped = shardspec.verify_step(core.trace(ship, state, big), mesh, "t")
    assert sum(": state_sized_operand:" in f for f in shipped) == 3
    assert sum("B part from one shard" in f for f in shipped) == 1


def test_a_gather_of_one_shards_state_reds():
    """A collective whose part from each shard is that shard's whole
    state REDs though it stays below the whole-ledger leaf size (8 x 2 x
    32 B here); a part one byte short stays clean."""
    mesh = Mesh(["cpu"] * 8)
    state = tuple({"a": torch.zeros(4, dtype=torch.int64),
                   "b": torch.zeros(4, dtype=torch.int64)}
                  for _ in range(8))

    def gather(st, n):
        psum(mesh, [torch.zeros(n, dtype=torch.int8)] * 8)
        for s in st:
            s["a"].add_(1)
        return st, {}

    red = shardspec.verify_step(core.trace(gather, state, 64), mesh, "t")
    assert red == ["t: state_sized_operand: `psum` moves a 64 B part from "
                   "one shard, one shard's state holds 64 B"]
    assert shardspec.verify_step(core.trace(gather, state, 63), mesh,
                                 "t") == []


# -------------------------------------------------------------- registry

def test_every_jax_entry_maps_onto_a_port_entry_and_back():
    """JAX registry.entries() on the 8 CPU devices (tests/conftest.py)
    against the port's: each JAX name maps onto a port entry of the same
    route, and every port entry is some JAX entry's counterpart."""
    from tigerbeetle_tpu.jaxhound import registry as J_registry

    jax_entries = J_registry.entries()
    port = registry.entries("cpu")
    assert set(jax_entries) == set(registry.JAX_NAMES)
    assert set(registry.JAX_NAMES.values()) == set(port)
    for j_name, p_name in registry.JAX_NAMES.items():
        assert jax_entries[j_name].route == port[p_name].route, j_name
        assert (tuple(jax_entries[j_name].depths)
                == tuple(port[p_name].depths)), j_name
    assert len(port) == 18
    assert {e.mesh.size for e in port.values() if e.mesh} == {8}


# ------------------------------------------------------------------ CLI

def test_cli_host_and_sharding_passes_json(capsys):
    assert cli.main(["--pass", "host", "--json", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"passes": {"host": {"ok": True, "findings": []}}}
    assert cli.main(["--pass", "sharding", "--device", "cpu"]) == 0
    assert "[torchhound] pass sharding: clean" in capsys.readouterr().out


def test_cli_red_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(hostdet, "run", lambda *a: ["x.py:1: wall_clock: t"])
    assert cli.main(["--pass", "host", "--json", "--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["passes"]["host"] == {"ok": False,
                                     "findings": ["x.py:1: wall_clock: t"]}


def test_cli_rejects_unknown_pass_and_needs_a_card():
    with pytest.raises(SystemExit):
        cli.main(["--pass", "nonsense"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--pass", "host"])


def test_cli_report_json_and_main_torchhound(capsys):
    """`--json` with no pass prints the census report; `main.py
    torchhound --device cpu` prints it for both kernels, and an unknown
    kernel exits 1."""
    assert cli.main(["--json", "--kernel", "create_accounts_fast",
                     "--device", "cpu"]) == 0
    lines = json.loads(capsys.readouterr().out)["report"]
    assert lines[0].startswith("create_accounts_fast: ")
    assert P_main.main(["torchhound", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    for name in ("create_transfers_fast", "create_accounts_fast"):
        assert f"{name}: " in text and " aten ops" in text
    assert "kernel calls: {'ht_probe': 1, 'row_gather': 4}" in text
    assert "host syncs 0" in text
    assert P_main.main(["torchhound", "--kernel", "nope",
                        "--device", "cpu"]) == 1
    assert "unknown kernel 'nope'" in capsys.readouterr().out
