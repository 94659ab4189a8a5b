"""Ragged fleet gating of the port against the JAX package: per-lane
budgets, the chain short-circuit, the certificate finisher skip, parking,
compaction and early landing on the batched chunked path (the churn-skewed
drive of ``tests/test_fleet_gating.py``, scripted once in
``cruise_control_tpu_torch/fleet_script.py``: a hot tenant past the
dirty-seed budget beside idle tenants under it, gated and ungated fleets).

The reference's side runs in ONE fresh interpreter for this module
(``torch_reference.fleet_job``), started when the module is imported (under
xdist, once per session, in the background); the port's side runs on one
torch intra-op thread. Every comparison is exact.
The reference's ``test_budget_value_toggle_compiles_nothing`` counts XLA
compiles and has no counterpart in the port, which compiles nothing at run
time; the toggle's dispatches run here all the same, and their results
are held against the reference's."""
import numpy as np
import pytest

from cruise_control_tpu_torch import fleet_script as fs
from test_torch_fleet import same
from torch_reference import (
    background_reference, fleet_job, one_torch_thread, start_background_reference,
)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
_REFERENCE_JOBS = {"gating": fleet_job(("gating_cases",))}
start_background_reference("fleet_gating", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return background_reference(tmp_path_factory, "fleet_gating",
                                _REFERENCE_JOBS)["gating"]["gating_cases"]


@pytest.fixture(scope="module")
def skew():
    return fs.gating_cases(fs.port_fleet_ns("cpu"))


def test_gated_batched_parity_bit_identical_to_gated_solo(skew, ref):
    for cid, solo in skew["solo_r3"].items():
        batched = skew["gated_r3"][cid]
        assert same(batched["sets"], solo["sets"]), cid
        assert same(batched["final"], solo["final"]), cid
    assert same(skew["solo_r3"], ref["solo_r3"])
    assert same(skew["gated_r3"], ref["gated_r3"])


def test_gating_off_restores_ungated_path_same_sets(skew, ref):
    for cid, gated in skew["gated_r3"].items():
        assert same(gated["sets"], skew["ungated_r3"][cid]["sets"]), cid
        assert same(gated["final"], skew["ungated_r3"][cid]["final"]), cid
    for cid, c in skew["ungated_counters_r3"].items():
        assert c["parkedRounds"] == 0 and c["compactedRounds"] == 0, cid
        assert c["earlyInstalls"] == 0, cid
    assert same(skew["ungated_r3"], ref["ungated_r3"])
    assert same(skew["ungated_counters_r3"], ref["ungated_counters_r3"])


def test_idle_lanes_park_and_compact_hot_lane_does_not(skew, ref):
    hot = skew["hot"]
    for cid, c in skew["gated_counters_r3"].items():
        pre = skew["gated_counters_pre_r3"][cid]
        d_park = c["parkedRounds"] - pre["parkedRounds"]
        d_comp = c["compactedRounds"] - pre["compactedRounds"]
        if cid == hot:
            assert d_park == 0 and d_comp == 0, cid
        else:
            assert d_park >= 1 and d_comp >= 1, cid
            assert c["skippedGoals"] >= 1, cid
    assert same(skew["gated_counters_pre_r3"], ref["gated_counters_pre_r3"])
    assert same(skew["gated_counters_r3"], ref["gated_counters_r3"])


def test_uniform_churn_never_parks_or_compacts(skew, ref):
    for cid in skew["uniform_after"]:
        after, before = skew["uniform_after"][cid], skew["uniform_before"][cid]
        assert after["parkedRounds"] == before["parkedRounds"], cid
        assert after["compactedRounds"] == before["compactedRounds"], cid
    assert same(skew["uniform_after"], ref["uniform_after"])
    assert same(skew["uniform_results"], ref["uniform_results"])


def test_early_install_lands_parked_lanes_first_in_lane_seq_order(skew, ref):
    installs = [e for e in skew["r4_journal"]
                if e.get("kind") == "admission" and e.get("ev") == "install"]
    assert installs
    hot = skew["hot"]
    hot_pos = [i for i, e in enumerate(installs) if e["cid"] == hot]
    idle_pos = [i for i, e in enumerate(installs) if e["cid"] != hot]
    assert hot_pos and idle_pos
    assert max(idle_pos) < min(hot_pos)
    for i in idle_pos:
        assert installs[i].get("early") is True, installs[i]
    assert [installs[i]["lane"] for i in hot_pos] == ["heal", "rebalance"]
    assert same(skew["r4_journal"], ref["r4_journal"])
    assert same(skew["r4_results"], ref["r4_results"])


def test_budget_value_toggle_results(skew, ref):
    assert same(skew["toggle_results"], ref["toggle_results"])


def test_launch_statistics_agree_with_the_lanes(skew):
    """The gated round's launch-level statistics (parked lanes, compaction
    steps, lanes compacted out) agree with the lanes' own flags."""
    stats = skew["gated_round"]
    lanes = {cid: r["lane"] for cid, r in skew["gated_r3"].items()}
    assert stats["gated"] and stats["tenants"] == len(lanes)
    assert stats["parked"] == sum(1 for v in lanes.values() if v[4])
    assert stats["compacted_out"] == sum(1 for v in lanes.values() if v[5])
    assert (stats["compactions"] > 0) == (stats["compacted_out"] > 0)
    assert [row["parked_early"] for row in stats["lanes"]] == [v[4] for v in lanes.values()]
