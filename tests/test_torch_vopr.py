"""The port's VOPR swarm against the JAX package's.

`run_swarm_seed` derives a cluster topology, a fault schedule and an
audited workload from one seed. The port's copy runs on the CPU on each
of its engines (the kernel engine through `create_seq`'s plain twin, the
device engine through the device tiers' plain twins); the JAX package's
runs on its oracle engine, pure Python, so no JAX program compiles. A
named engine makes no draw in either package, so the summaries (engine
aside) and every audited (events, results) pair must be equal; seed 1
draws its engine (the oracle) in both.
"""

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.testing import vopr as J
from tigerbeetle_tpu_torch import testing as P_testing
from tigerbeetle_tpu_torch.testing import vopr as P
from tests.port_verify import port_verify_restored  # noqa: F401


def _recording(monkeypatch, module) -> list:
    """Put a recording Auditor in `module`; returns its log of packed
    (events, results) pairs."""
    log = []
    base = module.Auditor

    class Recording(base):
        def check(self, events, results):
            log.append(([e.pack() for e in events],
                        [r.pack() for r in results]))
            super().check(events, results)

    monkeypatch.setattr(module, "Auditor", Recording)
    return log


def _swarm(monkeypatch, seed, engine):
    j_log, p_log = _recording(monkeypatch, J), _recording(monkeypatch, P)
    want = J.run_swarm_seed(seed, engine=None if engine is None
                            else "oracle")
    got = P.run_swarm_seed(seed, engine=engine, device="cpu")
    return want, got, j_log, p_log


@pytest.mark.parametrize("seed,engine", [
    (1, None),
    (515, "oracle"), (515, "kernel"), (515, "device"),
    (626, "oracle"), (626, "kernel"), (626, "device"),
    (101, "oracle"), (101, "kernel"), (101, "device"),
])
def test_swarm_seed_equals_the_jax_packages(monkeypatch, seed, engine):
    want, got, j_log, p_log = _swarm(monkeypatch, seed, engine)
    assert want.pop("engine") == "oracle"
    assert got.pop("engine") == (engine or "oracle")
    assert got == want
    assert p_log == j_log
    assert len(p_log) == got["steps"]
    assert sum(len(events) for events, _ in p_log) == got["audited"] > 0


def test_a_named_engine_skips_the_draw(monkeypatch):
    """Seed 10 draws the kernel engine; naming it makes no draw, so every
    later draw (the step count, the topology) shifts, as in the JAX
    package."""
    seen = []

    class Stop(Exception):
        pass

    def cluster(**kwargs):
        seen.append({k: kwargs[k] for k in ("replica_count",
                                            "standby_count")})
        raise Stop

    for module in (J, P):
        monkeypatch.setattr(module, "Cluster", cluster)
        for engine in (None, "kernel"):
            kw = {} if module is J else {"device": "cpu"}
            with pytest.raises(Stop):
                module.run_swarm_seed(10, engine=engine, **kw)
    drawn, named = seen[0], seen[1]
    assert drawn != named
    assert seen == [drawn, named, drawn, named]


def test_the_testing_package_exports_the_cluster():
    assert P_testing.__all__ == ["Cluster", "SimClient"]
    from tigerbeetle_tpu_torch.testing.cluster import Cluster, SimClient

    assert P_testing.Cluster is Cluster and P_testing.SimClient is SimClient
