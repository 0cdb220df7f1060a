"""The port's driver commands: `main.py fuzz`, `cfo` and `devhub`.

`fuzz` runs one fuzzer of the registry; `cfo` interleaves fuzzer runs,
VOPR swarm seeds and serving-chaos seeds, its selection drawn as the JAX
package's draws it (checked by recording what both packages would run,
with every run replaced by a recorder); `devhub` records bench lines
and renders the dashboard, whose regressions and HTML must be the JAX
package's (the package name in the title aside). Every run here is on
the CPU (`--platform cpu`); without it the commands name the card.
"""

import json
import os
import random

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import devhub as J_devhub, main as J_main
from tigerbeetle_tpu.testing import chaos as J_chaos, fuzz as J_fuzz
from tigerbeetle_tpu.testing import vopr as J_vopr
from tigerbeetle_tpu_torch import devhub as P_devhub, main as P_main
from tigerbeetle_tpu_torch.testing import chaos as P_chaos
from tigerbeetle_tpu_torch.testing import fuzz as P_fuzz
from tigerbeetle_tpu_torch.testing import vopr as P_vopr

CFO_COUNTS = {"chaos": 1, "fuzz:durability": 1, "fuzz:ewah": 1,
              "fuzz:lsm_manifest_level": 1, "vopr": 4}


# ------------------------------------------------------------------ fuzz

def test_fuzz_list_and_unknown(capsys):
    assert P_main.main(["fuzz", "list"]) == 0
    assert capsys.readouterr().out.split() == list(P_fuzz.FUZZERS)
    assert P_main.main(["fuzz", "not_a_fuzzer"]) == 1
    assert "unknown fuzzer" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["fuzz", "ewah", "3", "--iterations", "20"],
    ["fuzz", "device_ledger", "4", "--iterations", "3", "--platform",
     "cpu"],
])
def test_fuzz_runs_a_fuzzer(capsys, argv):
    assert P_main.main(argv) == 0
    assert f"fuzz {argv[1]} seed={argv[2]}: OK" in capsys.readouterr().out


def test_fuzz_names_the_card_by_default():
    """A fuzzer that builds device state runs on CUDA unless told
    otherwise: on a host without a card it raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P_main.main(["fuzz", "state_machine", "1", "--iterations", "1"])


# ------------------------------------------------------------------- cfo

def test_cfo_seed_7_runs_eight_clean_runs(tmp_path, capsys):
    artifact = tmp_path / "CFO_7.json"
    assert P_main.main(["cfo", "--max-runs", "8", "--seed", "7",
                        "--platform", "cpu", "--artifact",
                        str(artifact)]) == 0
    got = json.loads(artifact.read_text())
    assert got["runs_clean"] == 8 and got["runs_failing"] == 0
    assert got["counts"] == CFO_COUNTS
    assert got["failing"] == []
    assert "cfo: 8 clean, 0 failing" in capsys.readouterr().out


def _recorders(monkeypatch, vopr, chaos, fuzz) -> list:
    """Replace a package's three run functions with recorders."""
    ran = []
    monkeypatch.setattr(vopr, "run_swarm_seed", lambda seed, **kw: ran.append(
        ("vopr", seed, kw.get("device"))))
    monkeypatch.setattr(chaos, "run_chaos_seed",
                        lambda seed, traffic=None, **kw: ran.append(
                            ("chaos", seed, traffic, kw.get("device"))))
    monkeypatch.setattr(fuzz, "run", lambda name, seed, iterations=None,
                        **kw: ran.append(("fuzz", name, seed, iterations,
                                          kw.get("device"))))
    return ran


@pytest.mark.parametrize("argv", [
    ["--seed", "7", "--max-runs", "200"],
    ["--seed", "1234", "--max-runs", "200"],
    ["--kind", "fuzz", "--seed", "5", "--max-runs", "50"],
    ["--kind", "vopr", "--seed", "5", "--max-runs", "20"],
    ["--kind", "vopr", "--seed", "99", "--max-runs", "1"],
    ["--kind", "chaos", "--seed", "42"],
    ["--kind", "chaos", "--seed", "42", "--traffic", "hot_skew"],
    ["--kind", "chaos", "--seed", "8", "--max-runs", "30"],
])
def test_cfo_selects_the_jax_packages_runs(monkeypatch, capsys, argv):
    """The same arguments select the same runs, seeds and traffic shapes
    in the same order in both packages; the port hands each its
    platform."""
    want = _recorders(monkeypatch, J_vopr, J_chaos, J_fuzz)
    got = _recorders(monkeypatch, P_vopr, P_chaos, P_fuzz)
    assert J_main.main(["cfo", *argv]) == 0
    assert P_main.main(["cfo", *argv, "--platform", "cpu"]) == 0
    assert len(got) == len(want) > 0
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    assert {r[-1] for r in got} == {"cpu"}


@pytest.mark.parametrize("kind,want", [
    ("fuzz", "python -m tigerbeetle_tpu_torch fuzz {name} {seed} "
             "--platform cpu"),
    ("vopr", "python -m tigerbeetle_tpu_torch cfo --kind vopr --seed "
             "{seed} --max-runs 1 --platform cpu"),
    ("chaos", "python -m tigerbeetle_tpu_torch cfo --kind chaos --seed "
              "{seed} --traffic pending_storm --platform cpu"),
])
def test_cfo_records_a_failing_run(monkeypatch, tmp_path, capsys, kind,
                                   want):
    """A run that raises: cfo exits 1, and the artifact, the failures file
    and the output carry its reproduction command, which names the
    port's package and its platform."""
    def boom(*args, **kwargs):
        raise AssertionError("planted")

    if kind == "fuzz":
        for name in P_fuzz.FUZZERS:
            monkeypatch.setitem(P_fuzz.FUZZERS, name, boom)
    else:
        monkeypatch.setattr(P_vopr, "run_swarm_seed", boom)
        monkeypatch.setattr(P_chaos, "run_chaos_seed", boom)
    artifact, failures = tmp_path / "a.json", tmp_path / "f.txt"
    argv = ["cfo", "--kind", kind, "--seed", "3", "--max-runs", "2",
            "--platform", "cpu", "--artifact", str(artifact),
            "--failures-file", str(failures)]
    if kind == "chaos":
        argv += ["--traffic", "pending_storm"]
    assert P_main.main(argv) == 1
    got = json.loads(artifact.read_text())
    assert got["runs_clean"] == 0 and got["runs_failing"] == 2
    for f in got["failing"]:
        assert f["kind"] == kind and "planted" in f["error"]
        assert f["reproduce"] == want.format(name=f["name"], seed=f["seed"])
    out = capsys.readouterr().out
    assert out.count("\n  reproduce: python -m tigerbeetle_tpu_torch") == 2
    assert len(failures.read_text().splitlines()) == 2


# ---------------------------------------------------------------- devhub

def _history(seed: int, n: int) -> list:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        base = 300_000 + rng.randrange(-20_000, 20_000)
        drop = 0.5 if (i == n - 1 and seed % 2) else 1.0
        out.append({
            "value": base * drop,
            "config2_10k_tps": rng.choice((None, base * 2)),
            "config6_serving_tps": base / 3,
            "config5_oracle_parity": rng.random() < 0.9,
            "serving_batch_latency": {
                "sustained_tps": 70_000 * drop,
                "p99_ms": 90.0 / drop, "p999_ms": 120.0},
            "trace": {"overhead_ratio": 1.05 / drop,
                      "ctx_overhead_ratio": 1.1},
        })
    return out


@pytest.mark.parametrize("seed", range(6))
def test_devhub_regressions_equal_the_jax_packages(seed):
    entries = _history(seed, 3 + 2 * seed)
    assert P_devhub.regressions(entries) == J_devhub.regressions(entries)
    if seed % 2:
        assert "value" in P_devhub.regressions(entries)


def _rich_record() -> dict:
    """A bench line that lights up every panel of the dashboard."""
    from tigerbeetle_tpu_torch.trace import Histogram

    h = Histogram()
    h.record_many([300.0] * 40)
    occ = Histogram()
    occ.record_many([40.0, 60.0, 90.0] * 10)
    diag = {
        "host_fallbacks": 2, "window_fallbacks": 1, "escalations": 3,
        "causes": {"breach": 2, "hard_flag": 1},
        "recovery": {"recoveries": {"checksum": 1}, "retries": 2,
                     "backoff_s": 0.5, "replayed_windows": 3,
                     "epochs_verified": 9, "checksum_mismatches": 1},
        "routes": {"windows": {"chain": 4, "super": 2},
                   "chain_batch_fallbacks": {"hard": 1},
                   "window_depths": [8, 32]},
        "staging": {"windows": 6, "staged": 5, "misses": 1,
                    "work_ms": 12.5, "stall_ms": 3.25,
                    "host_stall_fraction": 0.95, "overlap": True},
    }
    return {
        "value": 2_700_000.0, "config2_10k_tps": 2_740_000.0,
        "config1_2hot_tps": 1_000_000.0, "config5_oracle_parity": False,
        "serving_batch_latency": {"sustained_tps": 235_000.0,
                                  "p99_ms": 300.0, "p999_ms": 310.0,
                                  "histogram": h.to_dict()},
        "fallback_diagnostics": {"config2": diag, "config4": {
            "host_fallbacks": 0, "causes": {}}},
        "admission": {
            "classes": {
                "interactive": {"priority": 0, "submitted": 100,
                                "admitted": 90, "shed": {"queue_full": 10},
                                "admit_wait_ms": {"p99": 12.0},
                                "slo_ms": 10.0},
                "batch": {"priority": 1, "submitted": 50, "admitted": 50,
                          "shed": {}, "admit_wait_ms": {"p99": 1.0},
                          "slo_ms": 100.0}},
            "conservation": {"ok": False}},
        "opbudget": {"plain": {"heavy_total": 10**6,
                               "heavy": {"sort": 3, "scatter": 0},
                               "operand_mb": 12.5}},
        "shard_balance": {
            "events_per_shard": [100, 80, 0, 40], "exchange_overflows": 2,
            "state_bytes_per_device": 1000, "n_shards": 4,
            "state_bytes_replicated_equiv": 4000,
            "cross_shard_fraction": 0.25, "cross_shard_transfers": 55,
            "migration": {"kind": "split", "src": 0, "dst": 2,
                          "rows_copied": 77, "duration_s": 0.5,
                          "double_write_windows": 2, "windows_live": 3},
            "hot_range": {"verdict": "unsplittable", "shard": 1,
                          "fraction": 0.6, "note": "one hot account"},
            "telemetry": {
                "exchange_occupancy": occ.to_dict(),
                "fixpoint_rounds": {"count": 8, "p50": 2, "p99": 7,
                                    "max": 8},
                "device_poison_causes": {"overflow": 2},
                "writeback_rows": 12, "shard_capacity_hits": 1,
                "flight_windows": 4, "flight_dumps": 1}},
        "trace": {
            "overhead_ratio": 1.04, "ctx_overhead_ratio": 1.08,
            "null_s": 1.0, "recording_s": 1.04, "ops": 500,
            "commit_stages": {
                "commit_prefetch": {"count": 10, "sum_us": 1000.0},
                "commit_execute": {"count": 10, "sum_us": 5000.0},
                "commit_compact": {"count": 10, "sum_us": 2000.0}},
            "critical_path": {
                "window_event": "window_commit", "windows_total": 40,
                "windows_analyzed": 4, "slow_quantile": 0.9,
                "threshold_ms": 200.0, "p99_ms": 310.0,
                "stage_share": {"serving_dispatch": 0.7, "other": 0.3},
                "p99_owner": "serving_dispatch"},
            "request_waterfall": [
                {"trace_id": "ab" * 16, "total_us": 5000.0,
                 "owner": "commit", "keep_reason": "slow",
                 "stages": {"quorum_wait_us": 1000.0, "commit_us": 3000.0,
                            "device_dispatch_us": 500.0,
                            "network_other_us": 500.0}}]},
        "profile": {
            "roofline": {"plain": {"fraction": 0.4,
                                   "roofline_seconds": 0.001,
                                   "measured_p50_s": 0.0025}},
            "dispatch_device_time": {"plain": {"count": 5, "p50_us": 10.0,
                                               "p99_us": 20.0}},
            "sampler": {"dispatches": 10, "samples": 5, "sample_every": 2},
            "cost_model": {"platform": "gpu"},
            "memwatch": {"last": {"components": {"state": 10**9,
                                                 "graphs": 5},
                                  "total_bytes": 10**9 + 5,
                                  "headroom_bytes": 10**10},
                         "reds": ["state over pin"], "observations": 3},
            "alerts": {"active": ["window_latency_burn"], "ticks": 40,
                       "fired_total": 1, "rules": 1}},
    }


def test_devhub_renders_the_jax_packages_page(tmp_path):
    """The same history (the non-empty bench lines of BENCH_r01..r06 and
    a line lighting every panel) and the same cfo directory render the
    same page in both packages, the title's package name and the static
    panel's verifier name aside; the budget panels read the committed
    perf/ files as data, and the port's static panel is given the JAX
    package's (perf/static_status.json, perf/tracebudget_r01.json)."""
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    lines = [json.loads((repo / f"BENCH_r0{i}.json").read_text())["parsed"]
             for i in range(1, 7)]
    lines = [line for line in lines if line]
    history = tmp_path / "h.jsonl"
    for i, line in enumerate(lines + [_rich_record()]):
        J_devhub.record(str(history), line, timestamp=1_700_000_000 + i)
    cfo = tmp_path / "cfo"
    cfo.mkdir()
    (cfo / "CFO_r12.json").write_text(json.dumps({
        "runs_clean": 7, "runs_failing": 1, "elapsed_s": 5.0,
        "failing": [{"kind": "vopr", "name": "vopr", "seed": 777,
                     "error": "AssertionError('<x>')",
                     "reproduce": "python -m tigerbeetle_tpu_torch cfo "
                                  "--kind vopr --seed 777 --max-runs 1"}]}))
    pages = {}
    for key, mod, kw in (("J", J_devhub, {}),
                         ("P", P_devhub, {"static_dir": str(repo / "perf")})):
        out = tmp_path / f"{key}.html"
        assert mod.render(str(history), str(out), cfo_dir=str(cfo),
                          **kw) == len(lines) + 1
        pages[key] = out.read_text()
    assert pages["P"] == pages["J"].replace(
        "tigerbeetle-tpu devhub", "tigerbeetle-tpu-torch devhub").replace(
        "(jaxhound passes,", "(torchhound passes,")
    doc = pages["P"]
    for panel in ("op budget", "static analysis", "shard balance",
                  "device telemetry", "commit pipeline", "SLOs",
                  "critical path", "per-request waterfall",
                  "memory watermark", "burn-rate alerts",
                  "continuous fuzzing", "PARITY FAILURE RECORDED"):
        assert panel in doc, panel
    assert "--kind vopr --seed 777" in doc


def test_devhub_static_panel_reads_the_ports_own_status(tmp_path):
    """By default the static panel shows the port's verdict: the
    torchhound status and capture budget committed in the port's trace/,
    not the JAX package's perf/ files."""
    from pathlib import Path

    port_trace = Path(P_devhub.__file__).resolve().parent / "trace"
    status = json.loads((port_trace / "static_status.json").read_text())
    history = tmp_path / "h.jsonl"
    P_devhub.record(str(history), {"value": 1.0})
    out = tmp_path / "d.html"
    P_devhub.render(str(history), str(out))
    doc = out.read_text()
    assert "static analysis (torchhound passes, last gate leg)" in doc
    assert f"{status['n_entries']} registry entries" in doc
    assert status["tracebudget"] == "tracebudget_r01.json"
    pinned = json.loads((port_trace / "tracebudget_r01.json").read_text())
    assert (f"tracebudget_r01.json: {len(pinned['entries'])} entries "
            "pinned") in doc
    assert status["n_entries"] == len(pinned["entries"]) == 18
    assert "STATIC ANALYSIS RED" not in doc


def test_devhub_command_records_and_gates(tmp_path, capsys):
    """`devhub --record` appends a line and renders; with `--strict` a
    regression against the trailing median exits 2, as in the JAX
    package."""
    history, out = tmp_path / "h.jsonl", tmp_path / "d.html"
    for entry in _history(1, 6)[:-1]:
        P_devhub.record(str(history), entry)
    record = tmp_path / "r.json"
    record.write_text(json.dumps(_history(1, 6)[-1]))
    argv = ["devhub", "--record", str(record), "--history", str(history),
            "--out", str(out), "--cfo-dir", str(tmp_path / "none")]
    assert P_main.main(argv) == 0
    text = capsys.readouterr().out
    assert "devhub: 6 runs" in text and "REGRESSION value" in text
    assert P_main.main(["devhub", "--history", str(history), "--out",
                        str(out), "--strict"]) == 2
    assert "tigerbeetle-tpu-torch devhub" in out.read_text()


def test_devhub_budget_panels_read_the_ports_own_files(tmp_path, monkeypatch):
    """The op-budget and memory panels read the port's own pins,
    trace/opbudget_r01.json and trace/membudget.json (its SLO and alert
    panels its trace/slo.json), and devhub opens no file under perf/."""
    import builtins
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    port_trace = Path(P_devhub.__file__).resolve().parent / "trace"
    history = tmp_path / "h.jsonl"
    P_devhub.record(str(history), _rich_record())
    opened = []
    real_open = builtins.open

    def spy(file, *args, **kw):
        if isinstance(file, (str, os.PathLike)):
            opened.append(Path(file).resolve())
        return real_open(file, *args, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    P_devhub.render(str(history), str(tmp_path / "d.html"))
    monkeypatch.undo()
    assert port_trace / "opbudget_r01.json" in opened
    assert port_trace / "membudget.json" in opened
    assert port_trace / "slo.json" in opened
    assert not [p for p in opened if (repo / "perf") in p.parents]
    doc = (tmp_path / "d.html").read_text()
    for panel in ("op budget", "memory watermark", "SLOs",
                  "burn-rate alerts"):
        assert panel in doc, panel


def test_the_ports_slo_config_is_the_jax_packages():
    """The port's trace/slo.json is the JAX package's perf/slo.json."""
    from pathlib import Path

    from tigerbeetle_tpu_torch.trace.slo import DEFAULT_SLO_PATH

    repo = Path(__file__).resolve().parent.parent
    assert Path(DEFAULT_SLO_PATH).read_bytes() == \
        (repo / "perf" / "slo.json").read_bytes()
