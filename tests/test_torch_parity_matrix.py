"""The Java parity matrix (``PARITY.md``, ``tests/test_java_parity_matrix.py``)
through the port.

Each of the 29 rows of the reference's DeterministicClusterTest replay runs
``GoalOptimizer(device="cpu").optimizations`` on the port's copy of its
fixture with its constraint, goal chain and min-leader topic pattern, and
is held to:

- the transcribed Java outcome: it optimizes with every hard goal
  satisfied and the REGRESSION verification passing, or (the SMALL_CAP
  rows) raises with an UNDER_PROVISIONED recommendation, or (the two
  ``expectedException`` rows) raises;
- the JAX reference's outcome that PARITY.md records (the number of soft
  goals left violated, or how it raises), and for a raising row the status
  of the recommendation its failure carries (the reference's, checked live
  below).

``MATRIX`` transcribes the reference's matrix with the port's fixtures;
``test_matrix_is_the_references`` holds the transcription (rows, chains,
constraints, patterns, Java outcomes) to the reference's ``MATRIX`` and to
PARITY.md. The live reference rows (``slow``) run in a fresh interpreter
(torch_reference.py).
"""
import dataclasses
import re
from pathlib import Path

import pytest

from cruise_control_tpu_torch.analyzer.env import BalancingConstraint
from cruise_control_tpu_torch.analyzer.optimizer import (
    GoalOptimizer, OptimizationFailureError,
)
from cruise_control_tpu_torch.analyzer.verifier import verify_no_regression
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.detector.provisioner import ProvisionStatus
from cruise_control_tpu_torch.model import fixtures
from torch_reference import one_torch_thread, reference_matrix_rows

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

ROOT = Path(__file__).resolve().parent.parent

# TestConstants.java:36-46
ZERO, LOW, MEDIUM, HIGH = 1.00, 1.05, 1.25, 1.65
CAP_HIGH, CAP_MEDIUM, CAP_LOW = 0.9, 0.8, 0.7
LARGE_CAP, MEDIUM_CAP, SMALL_CAP = 300_000.0, 200_000.0, 10.0

FULL_CHAIN = [
    "RackAwareGoal", "RackAwareDistributionGoal",
    "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
    "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal", "ReplicaDistributionGoal", "PotentialNwOutGoal",
    "DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
    "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
    "TopicReplicaDistributionGoal", "PreferredLeaderElectionGoal",
]
KAFKA_ASSIGNER_CHAIN = ["KafkaAssignerEvenRackAwareGoal",
                        "KafkaAssignerDiskUsageDistributionGoal"]
MIN_LEADER_CHAIN = ["MinTopicLeadersPerBrokerGoal"]
# the hard goals tools/gen_parity_table.py names in its outcome
HARD = ("RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
        "DiskCapacityGoal", "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
        "CpuCapacityGoal", "KafkaAssignerEvenRackAwareGoal")


def _constraint(balance_pct=None, capacity_threshold=None, max_replicas=6,
                min_topic_leaders=1):
    kw = dict(max_replicas_per_broker=max_replicas,
              min_topic_leaders_per_broker=min_topic_leaders)
    if balance_pct is not None:
        kw["resource_balance_percentage"] = (balance_pct,) * 4
    if capacity_threshold is not None:
        kw["capacity_threshold"] = (capacity_threshold,) * 4
    return dataclasses.replace(BalancingConstraint(), **kw)


def _cap(value):
    return {Resource.CPU: value, Resource.DISK: value, Resource.NW_IN: value,
            Resource.NW_OUT: value}


def _capacity(factory, cap):
    return lambda: factory(_cap(cap))


_CAP_ROWS = _constraint(balance_pct=MEDIUM, capacity_threshold=CAP_LOW)
# (row id, fixture, chain, constraint, min-leader topic regex, Java outcome,
#  the reference's outcome as PARITY.md records it)
MATRIX = [
    ("swap-disk-dist", fixtures.unbalanced_two_brokers, ["DiskUsageDistributionGoal"],
     _constraint(balance_pct=ZERO), None, "ok", "optimized (0 soft violated)"),
    ("swap-intra-disk", fixtures.unbalanced_two_brokers,
     ["IntraBrokerDiskUsageDistributionGoal"], _constraint(balance_pct=ZERO), None, "ok",
     "optimized (1 soft violated)"),
    *[(f"small-bal-{pct}", fixtures.small_cluster_java, FULL_CHAIN,
       _constraint(balance_pct=pct, capacity_threshold=CAP_MEDIUM), "T2", "ok",
       f"optimized ({n} soft violated)") for pct, n in ((HIGH, 1), (MEDIUM, 5), (LOW, 6))],
    *[(f"medium-bal-{pct}", fixtures.medium_cluster_java, FULL_CHAIN,
       _constraint(balance_pct=pct, capacity_threshold=CAP_MEDIUM), "A", "ok",
       f"optimized ({n} soft violated)") for pct, n in ((HIGH, 1), (MEDIUM, 1), (LOW, 3))],
    *[(f"small-cap-{thr}", fixtures.small_cluster_java, FULL_CHAIN,
       _constraint(balance_pct=MEDIUM, capacity_threshold=thr), None, "ok",
       "optimized (5 soft violated)") for thr in (CAP_HIGH, CAP_MEDIUM, CAP_LOW)],
    *[(f"medium-cap-{thr}", fixtures.medium_cluster_java, FULL_CHAIN,
       _constraint(balance_pct=MEDIUM, capacity_threshold=thr), None, "ok",
       "optimized (1 soft violated)") for thr in (CAP_HIGH, CAP_MEDIUM, CAP_LOW)],
    *[(f"small-cluster-capacity-{cap}", _capacity(fixtures.small_cluster_java, cap),
       FULL_CHAIN, _CAP_ROWS, None, "ok" if cap != SMALL_CAP else "ok_or_underprovisioned",
       "optimized (5 soft violated)" if cap != SMALL_CAP else "raises (UNDER_PROVISIONED)")
      for cap in (LARGE_CAP, MEDIUM_CAP, SMALL_CAP)],
    *[(f"medium-cluster-capacity-{cap}", _capacity(fixtures.medium_cluster_java, cap),
       FULL_CHAIN, _CAP_ROWS, None, "ok" if cap != SMALL_CAP else "ok_or_underprovisioned",
       "optimized (1 soft violated)" if cap != SMALL_CAP else "raises (UNDER_PROVISIONED)")
      for cap in (LARGE_CAP, MEDIUM_CAP, SMALL_CAP)],
    ("ka-small", fixtures.small_cluster_java, KAFKA_ASSIGNER_CHAIN, _CAP_ROWS, None, "ok",
     "optimized (0 soft violated)"),
    ("ka-medium", fixtures.medium_cluster_java, KAFKA_ASSIGNER_CHAIN, _CAP_ROWS, None, "ok",
     "optimized (0 soft violated)"),
    ("ka-rack-satisfiable", fixtures.rack_aware_satisfiable, KAFKA_ASSIGNER_CHAIN,
     _CAP_ROWS, None, "ok", "optimized (0 soft violated)"),
    ("ka-rack-unsatisfiable", fixtures.rack_aware_unsatisfiable, KAFKA_ASSIGNER_CHAIN,
     _CAP_ROWS, None, "raise", "raises"),
    ("minlead-satisfiable", fixtures.min_leader_satisfiable, MIN_LEADER_CHAIN,
     _constraint(), fixtures.TOPIC_MIN_LEADER, "ok", "optimized (0 soft violated)"),
    ("minlead-satisfiable2", fixtures.min_leader_satisfiable2, MIN_LEADER_CHAIN,
     _constraint(), fixtures.TOPIC_MIN_LEADER, "ok", "optimized (0 soft violated)"),
    ("minlead-unsatisfiable", fixtures.min_leader_unsatisfiable, MIN_LEADER_CHAIN,
     _constraint(), fixtures.TOPIC_MIN_LEADER, "raise", "raises"),
    ("minlead-satisfiable3", fixtures.min_leader_satisfiable3, MIN_LEADER_CHAIN,
     _constraint(min_topic_leaders=4), fixtures.TOPIC_MIN_LEADER, "ok",
     "optimized (0 soft violated)"),
    ("minlead-satisfiable4", fixtures.min_leader_satisfiable4, MIN_LEADER_CHAIN,
     _constraint(), r"topic\d", "ok", "optimized (0 soft violated)"),
]
IDS = [m[0] for m in MATRIX]
# the status of the recommendation each raising row's failure carries in
# the reference (tools/gen_parity_table.py's run, checked live below)
RAISING_STATUS = {
    "small-cluster-capacity-10.0": ProvisionStatus.UNDER_PROVISIONED,
    "medium-cluster-capacity-10.0": ProvisionStatus.UNDER_PROVISIONED,
    "ka-rack-unsatisfiable": ProvisionStatus.RIGHT_SIZED,
    "minlead-unsatisfiable": ProvisionStatus.RIGHT_SIZED,
}


def run_row(i: int):
    """(outcome as tools/gen_parity_table.py words it, the result or None,
    the failure's recommendation or None)."""
    _rid, factory, chain, constraint, pattern, _java, _ref = MATRIX[i]
    ct, meta = factory()
    try:
        res = GoalOptimizer(constraint=constraint, device="cpu").optimizations(
            ct, meta, goal_names=chain, skip_hard_goal_check=True,
            min_leader_topic_pattern=pattern)
    except OptimizationFailureError as e:
        under = e.recommendation.status == ProvisionStatus.UNDER_PROVISIONED
        return ("raises (UNDER_PROVISIONED)" if under else "raises"), None, e.recommendation
    hard = [g.name for g in res.goal_results if g.violated_after and g.name in HARD]
    got = (("hard goals violated: " + ",".join(hard)) if hard
           else f"optimized ({len(res.violated_goals_after)} soft violated)")
    return got, res, None


@pytest.mark.parametrize("i", range(len(MATRIX)), ids=IDS)
def test_port_matrix_row(i):
    rid, _f, _chain, _c, _p, java, want = MATRIX[i]
    got, res, rec = run_row(i)
    assert got == want
    if res is not None:
        # the Java contract: hard goals satisfied, REGRESSION verified
        assert java in ("ok", "ok_or_underprovisioned")
        assert verify_no_regression(res) == []
        assert not [g for g in res.goal_results if g.violated_after and g.name in HARD]
    else:
        assert java == "raise" or (java == "ok_or_underprovisioned"
                                   and rec.status == ProvisionStatus.UNDER_PROVISIONED)
        assert rec.status == RAISING_STATUS[rid]
        assert rec.reason or rec.status == ProvisionStatus.RIGHT_SIZED


def test_matrix_is_the_references():
    """The transcription against the reference's ``MATRIX`` and PARITY.md."""
    from cruise_control_tpu.model import fixtures as ref_fixtures
    from test_java_parity_matrix import MATRIX as REF_MATRIX
    assert len(MATRIX) == len(REF_MATRIX) == 29
    for mine, ref in zip(MATRIX, REF_MATRIX):
        assert mine[0] == ref[0]
        assert mine[2] == ref[2] and mine[4] == ref[4] and mine[5] == ref[5]
        assert dataclasses.asdict(mine[3]) == dataclasses.asdict(ref[3])
        name = getattr(ref[1], "__name__", "<lambda>")
        if name != "<lambda>":
            assert mine[1].__name__ == name and hasattr(ref_fixtures, name)
    parity = {}
    for line in (ROOT / "PARITY.md").read_text().splitlines():
        m = re.match(r"\| (\S+) \| [^|]+ \| [^|]+ \| [^|]+ \| [^|]+ \| ([^|]+) \| yes \|$",
                     line)
        if m and m.group(1) in IDS:
            parity[m.group(1)] = m.group(2).strip()
    assert parity == {m[0]: m[6] for m in MATRIX}


@pytest.mark.slow
@pytest.mark.parametrize("half", [0, 1])
def test_matrix_rows_match_live_reference(tmp_path, half):
    """Each row through the reference (fresh interpreter): the same outcome
    and, for a raising row, the same recommendation status."""
    rows = list(range(len(MATRIX)))[half::2]
    ref = reference_matrix_rows(tmp_path, rows)
    for i, r in zip(rows, ref):
        got, _res, rec = run_row(i)
        assert got == r["got"] == MATRIX[i][6], IDS[i]
        assert (None if rec is None else rec.status.value) == r["status"], IDS[i]
