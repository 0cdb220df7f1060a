"""The port's op budget (`torchhound/opbudget.py`), on the CPU.

One census of every registry tier on the CPU (a module-scoped fixture)
must equal the committed trace/opbudget_r01.json exactly (`--write`'s
output), pass its `--check` and its `--lint`; the checks red a tier over
its pin; the window body census is one prepare's share and refuses an
uneven one; the committed file carries the JAX budget's tier names for
every tier with a counterpart.
"""

import json

import pytest
import torch

from tigerbeetle_tpu_torch.torchhound import core, opbudget as OB

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def census():
    current, traces = OB.census_tiers("cpu", with_traces=True)
    return current, traces, OB.telemetry_report("cpu", traces)


@pytest.fixture(scope="module")
def committed():
    with open(OB.DEFAULT_BUDGET_PATH) as f:
        return json.load(f)


def test_the_committed_budget_equals_a_fresh_write_on_the_cpu(census,
                                                              committed):
    current, _, tel = census
    assert core.newest_budget_path() == OB.DEFAULT_BUDGET_PATH
    assert json.loads(json.dumps(OB.build_budget(current, tel))) == committed


def test_check_and_lint_are_green_on_the_cpu(census, committed):
    current, traces, tel = census
    assert OB.check_budgets(current, committed) == []
    assert OB.check_telemetry(tel, committed) == []
    assert OB.run_lints(traces) == []
    assert tel["lanes"] == 12 and tel["chain_body_heavy_delta"] == 0
    # Off the card no kernel launches; every call is counted as a kernel.
    for tier, c in current.items():
        assert c["heavy"]["kernel"] == sum(c["kernels"].values()), tier
        if tier in traces:
            assert c["launches"] == {"ht_probe": 0, "row_gather": 0}


def test_the_budget_carries_the_jax_budgets_tier_names(committed):
    with open("perf/opbudget_r10.json") as f:
        jax_tiers = set(json.load(f)["budget"])
    port = set(committed["budget"])
    assert jax_tiers <= port
    assert port - jax_tiers == {
        "create_transfers_super_ring", "create_transfers_super_deep_ring",
        "create_transfers_super_balancing", "create_transfers_chain_ring"}
    b = committed["budget"]
    assert b["chain_body_w8"]["heavy_total"] <= b["plain"]["heavy_total"]
    assert b["chain_w8"]["heavy_total"] == 4 * b["chain_w2"]["heavy_total"]


def test_check_budgets_reds_a_tier_over_its_pin(census, committed):
    current = census[0]
    over = {t: dict(c) for t, c in current.items()}
    over["plain"] = dict(over["plain"],
                         heavy_total=over["plain"]["heavy_total"] + 1,
                         heavy=dict(over["plain"]["heavy"],
                                    sort=over["plain"]["heavy"]["sort"] + 1),
                         heavy_operand_bytes=over["plain"][
                             "heavy_operand_bytes"] + 8)
    fails = OB.check_budgets(over, committed)
    assert len(fails) == 3 and all(f.startswith("plain:") for f in fails)
    del over["sharded_plain"]
    assert any("sharded_plain: no current census" in f
               for f in OB.check_budgets(over, committed))
    # On the card a tier whose launches differ from its calls reds.
    card = {"plain": dict(current["plain"],
                          launches={"ht_probe": 1, "row_gather": 3})}
    assert OB.check_budgets(card, {"budget": {}}, on_card=True) == [
        "plain: launches {'ht_probe': 1, 'row_gather': 3} != kernel calls "
        "{'ht_probe': 1, 'row_gather': 4}"]


def test_window_body_census_is_one_prepares_share():
    def c(total, nbytes):
        return {"heavy": {"sort": total}, "heavy_total": total,
                "heavy_operand_bytes": nbytes,
                "collective_operand_bytes": 0}

    body = core.window_body_census(c(8 * 3 + 2, 8 * 100 + 7),
                                   c(2 * 3 + 2, 2 * 100 + 7))
    assert body["heavy_total"] == 3 and body["heavy_operand_bytes"] == 100
    with pytest.raises(ValueError, match="sort moves by 19"):
        core.window_body_census(c(8 * 3 + 3, 800), c(2 * 3 + 2, 200))
