"""The port's static leg (`testing/static_smoke.py`) on the CPU: the four
torchhound passes over the full registry clean, every negative proof red
as required, the status in the JAX package's schema; a RED pass or a
proof that cannot fail raises."""

import json

import pytest
import torch

from tigerbeetle_tpu_torch.testing import static_smoke as S
from tigerbeetle_tpu_torch.torchhound import (cli, determinism, hostdet,
                                              registry, retrace)

torch.set_num_threads(1)

NEGATIVES = {"determinism_float_collective", "determinism_baked_key",
             "host_wall_clock", "retrace_polymorphic",
             "retrace_budget_drift", "sharding_replicated_donor"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = tmp_path_factory.mktemp("static") / "static_status.json"
    status = S.static_smoke(status_path=str(path), device="cpu")
    return path, status


def test_every_pass_clean_and_every_negative_red(run):
    path, status = run
    assert json.loads(path.read_text()) == json.loads(
        json.dumps(status, sort_keys=True))
    assert status["n_entries"] == 18
    assert status["tracebudget"] == "tracebudget_r01.json"
    assert set(status["passes"]) == {"determinism", "host", "retrace",
                                     "sharding"}
    for name, p in status["passes"].items():
        assert p == {"ok": True, "n_findings": 0, "findings": []}, name
    assert status["negatives"] == {n: True for n in NEGATIVES}
    assert set(status["retrace_table"]) == set(registry.JAX_NAMES.values())


def test_capture_probe_and_census_on_the_cpu(run):
    """On the CPU every window runs eagerly: three at (route, 4, 1,024)
    and one at (route, 8, 1,024) a route, no capture, no drop; the flat
    entry calls the probe once and the row gather four times."""
    cap = run[1]["capture"]
    for route in ("chain", "super"):
        assert cap[repr((route, 4, 1024))] == {"eager": 3, "captures": 0,
                                               "replays": 0}
        assert cap[repr((route, 8, 1024))] == {"eager": 1, "captures": 0,
                                               "replays": 0}
    assert cap["drops"] == 0 and cap["device"] == "cpu"
    census = run[1]["census"]["create_transfers_fast"]
    assert census["kernel_calls"] == {"ht_probe": 1, "row_gather": 4}
    assert census["host_syncs"] == 0 and census["closure_constants"] == []
    assert census["heavy"]["collective"] == 0 and census["heavy_total"] > 0


def test_a_red_pass_raises_and_is_written(monkeypatch, tmp_path):
    """A host finding REDs the leg: the status says so and static_smoke
    raises (registry cut to one entry to keep it short)."""
    one = {"create_transfers_fast":
           registry.entries("cpu", include_mesh=False)[
               "create_transfers_fast"]}
    monkeypatch.setattr(registry, "entries", lambda *a, **k: one)
    monkeypatch.setattr(hostdet, "run",
                        lambda *a: ["x.py:1: wall_clock: time.time() read"])
    path = tmp_path / "s.json"
    with pytest.raises(AssertionError, match="wall_clock"):
        S.static_smoke(status_path=str(path), device="cpu")
    status = json.loads(path.read_text())
    assert status["passes"]["host"]["ok"] is False
    assert status["passes"]["determinism"]["ok"] is True


def test_a_pass_that_cannot_fail_fails_its_negative_proof(monkeypatch):
    monkeypatch.setattr(determinism, "findings_for", lambda *a, **k: [])
    entries = registry.entries("cpu", include_mesh=False)
    got = S._negative_proofs(entries, torch.device("cpu"))
    assert got["determinism_float_collective"] is False
    assert got["determinism_baked_key"] is False
    assert all(got[n] for n in NEGATIVES - {
        "determinism_float_collective", "determinism_baked_key"})


def test_committed_status_is_the_ports_green_verdict():
    """trace/static_status.json, the devhub panel's default, is a green
    run of this leg over the whole registry."""
    with open(S.STATUS_PATH) as f:
        status = json.load(f)
    assert status["n_entries"] == 18
    assert all(p["ok"] for p in status["passes"].values())
    assert set(status["negatives"]) == NEGATIVES
    assert all(status["negatives"].values())


def test_the_clis_retrace_pass_is_the_legs(monkeypatch, capsys):
    """The CLI's retrace pass runs the leg's capture probe (the small one
    off the card), and a probe RED turns its exit status to 1 (registry
    cut to one entry and the probe stubbed to keep it short; the leg's
    own run above drives the real probe through the same pass)."""
    one = {"create_transfers_fast":
           registry.entries("cpu", include_mesh=False)[
               "create_transfers_fast"]}
    monkeypatch.setattr(registry, "entries", lambda *a, **k: one)
    calls = []

    def probe(device, **kw):
        calls.append((device, kw))
        return {}, ["capture: probe RED"]

    monkeypatch.setattr(retrace, "capture_probe", probe)
    assert cli.main(["--pass", "retrace", "--json", "--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert "capture: probe RED" in out["passes"]["retrace"]["findings"]
    assert calls == [(torch.device("cpu"), cli.CPU_CAPTURE)]
