"""The port's process-global `constants.VERIFY` does not leak between
tests: every `tests/test_torch_*.py` that imports a port module that
builds a simulated `Cluster` binds the autouse fixture that restores the
flag (`tests/port_verify.py`), and a Cluster built in one test leaves
the flag off for the next."""

import ast
import pathlib

from tests.port_verify import port_verify_restored  # noqa: F401
from tigerbeetle_tpu_torch import StateMachine, constants
from tigerbeetle_tpu_torch.testing import cluster as P_cluster

TESTS = pathlib.Path(__file__).resolve().parent
BUILDERS = {"cluster", "vopr", "fuzz", "trace_coverage", "chaos"}
PKG = "tigerbeetle_tpu_torch.testing"


def _imports_a_builder(tree) -> bool:
    """Whether the module imports, anywhere in it, the port's
    testing.cluster, vopr, fuzz, trace_coverage or chaos."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [f"{node.module}.{a.name}" for a in node.names]
            mods.append(node.module or "")
        else:
            continue
        for m in mods:
            head, _, rest = m.partition(PKG + ".")
            if not head and rest.split(".")[0] in BUILDERS:
                return True
    return False


def _binds_the_fixture(tree) -> bool:
    return any(
        isinstance(node, ast.ImportFrom) and node.module == "tests.port_verify"
        and any(a.name == "port_verify_restored" and a.asname is None
                for a in node.names)
        for node in tree.body)


def test_every_file_that_builds_a_cluster_restores_the_ports_verify():
    files = sorted(TESTS.glob("test_torch_*.py"))
    builders = [p.name for p in files
                if _imports_a_builder(ast.parse(p.read_text()))]
    assert {"test_torch_cluster.py", "test_torch_vopr.py",
            "test_torch_fuzz.py", "test_torch_chaos.py",
            "test_torch_trace_coverage.py", "test_torch_drivers_cli.py",
            "test_torch_chip_smoke.py",
            "test_torch_verify_flag.py"} <= set(builders)
    missing = [name for name in builders
               if not _binds_the_fixture(ast.parse(
                   (TESTS / name).read_text()))]
    assert not missing, missing


def test_a_cluster_turns_the_ports_verify_on():
    """The port's Cluster turns VERIFY on, as the JAX package's does, and
    leaves it on (the fixture restores it after the test)."""
    assert constants.VERIFY is False
    P_cluster.Cluster(seed=1, replica_count=1, state_machine_factory=lambda:
                      StateMachine("oracle", device="cpu"))
    assert constants.VERIFY is True


def test_the_next_test_sees_the_ports_verify_off():
    assert constants.VERIFY is False
