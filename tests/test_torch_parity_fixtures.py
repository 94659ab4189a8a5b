"""The DeterministicCluster parity cases of the reference's
tests/test_parity_fixtures.py, through the port.

Each case runs ``GoalOptimizer(device="cpu")`` on the port's copy of the
reference fixture (``model/fixtures.py``) and is held to the same
hand-derived outcome and the same OptimizationVerifier checks
(``tests/optimization_verifier.py``: NEW_BROKERS, BROKEN_BROKERS,
REGRESSION). The reference's detector case
(``test_goal_violation_detector_reports_under_provisioned``) needs the load
monitor and the detector (ROADMAP.md Queue 1 items 11 and 12).
"""
import dataclasses

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer.optimizer import (
    GoalOptimizer, OptimizationFailureError,
)
from cruise_control_tpu_torch.detector.provisioner import ProvisionStatus
from cruise_control_tpu_torch.model import fixtures
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
from optimization_verifier import verify
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

DEFAULT_CHAIN = [
    "RackAwareGoal", "RackAwareDistributionGoal", "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
    "PotentialNwOutGoal", "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal", "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal", "TopicReplicaDistributionGoal",
    "PreferredLeaderElectionGoal",
]


def _optimize(ct, meta, goals, **kw):
    return GoalOptimizer(device="cpu").optimizations(
        ct, meta, goal_names=goals, skip_hard_goal_check=True, **kw)


def test_unbalanced_default_chain_heals():
    """unbalanced(): both half-capacity partitions on broker 0; the chain
    spreads them and ends with every hard goal satisfied."""
    ct, meta = fixtures.unbalanced()
    res = _optimize(ct, meta, DEFAULT_CHAIN, raise_on_failure=True)
    hard = {"RackAwareGoal", "RackAwareDistributionGoal", "ReplicaCapacityGoal",
            "DiskCapacityGoal", "NetworkInboundCapacityGoal",
            "NetworkOutboundCapacityGoal", "CpuCapacityGoal"}
    assert not (set(res.violated_goals_after) & hard)
    counts = res.final_state.replica_count.numpy()[res.env.broker_alive.numpy()]
    assert counts.max() <= 1
    verify(ct, meta, res, ["REGRESSION"])


def test_unbalanced2_replica_distribution():
    """unbalanced2(): replica counts 5/1/0 land inside the [1, 3] band."""
    ct, meta = fixtures.unbalanced2()
    res = _optimize(ct, meta, ["ReplicaDistributionGoal"])
    assert "ReplicaDistributionGoal" not in res.violated_goals_after
    counts = np.sort(res.final_state.replica_count.numpy()[:3])
    assert counts[0] >= 1 and counts[-1] <= 3
    assert counts.sum() == 6
    verify(ct, meta, res, ["REGRESSION"])


def test_unbalanced_with_a_follower_leadership():
    """unbalancedWithAFollower(): the transfer to broker 2 would push it over
    its own threshold; the goal rejects it and stays violated."""
    ct, meta = fixtures.unbalanced_with_a_follower()
    res = _optimize(ct, meta, ["LeaderBytesInDistributionGoal"])
    assert res.final_state.leader_count.numpy()[0] == 2
    assert "LeaderBytesInDistributionGoal" in res.violated_goals_after


def test_preferred_leader_election_moves_to_position_zero():
    ct, meta = fixtures.preferred_leader_skewed()
    res = _optimize(ct, meta, ["PreferredLeaderElectionGoal"])
    leaders = res.final_state.leader_count.numpy()
    assert leaders[meta.broker_index(1)] == 2
    assert leaders[meta.broker_index(0)] == 0
    assert res.num_leadership_movements == 2


def test_rack_aware_satisfiable_fixed_by_one_move():
    ct, meta = fixtures.rack_aware_satisfiable()
    res = _optimize(ct, meta, ["RackAwareGoal"], raise_on_failure=True)
    assert "RackAwareGoal" not in res.violated_goals_after
    prc = res.final_state.part_rack_count.numpy()
    assert (prc[0] <= 1).all() and prc[0].sum() == 2
    assert res.num_replica_movements == 1
    verify(ct, meta, res, ["REGRESSION"])


def test_rack_aware_unsatisfiable_raises():
    """RF=3 with 2 racks (DeterministicClusterTest expectedException case)."""
    ct, meta = fixtures.rack_aware_unsatisfiable()
    with pytest.raises(OptimizationFailureError) as ei:
        _optimize(ct, meta, ["RackAwareGoal"], raise_on_failure=True)
    assert ei.value.recommendation is not None


def test_unbalanced4_disk_distribution_swaps():
    """unbalanced4(): both brokers end inside the 1.10 disk band."""
    ct, meta = fixtures.unbalanced_two_brokers()
    res = _optimize(ct, meta, ["DiskUsageDistributionGoal"])
    assert "DiskUsageDistributionGoal" not in res.violated_goals_after
    util = res.final_state.util.numpy()[:, 3]
    avg = util[:2].mean()
    dev = (1.10 - 1.0) * 0.9
    assert util[:2].max() <= avg * (1 + dev) + 100.0
    assert util[:2].min() >= avg * (1 - dev) - 100.0
    verify(ct, meta, res, ["REGRESSION"])


def test_unbalanced4_intra_broker_disk_distribution():
    """unbalanced4(): the intra-broker goal balances the logdirs without any
    inter-broker movement."""
    ct, meta = fixtures.unbalanced_two_brokers()
    res = _optimize(ct, meta, ["IntraBrokerDiskUsageDistributionGoal"])
    R = ct.num_replicas
    np.testing.assert_array_equal(res.final_state.replica_broker.numpy()[:R],
                                  np.asarray(ct.replica_broker))
    assert "IntraBrokerDiskUsageDistributionGoal" not in res.violated_goals_after


def test_new_broker_rebalance_only_targets_new_brokers():
    """NEW_BROKERS: with broker 2 flagged new, replicas only move onto it."""
    ct, meta = fixtures.unbalanced2()
    new = np.zeros(ct.num_brokers, bool)
    new[meta.broker_index(2)] = True
    ct = dataclasses.replace(ct, broker_new=new)
    res = _optimize(ct, meta, ["ReplicaDistributionGoal"])
    verify(ct, meta, res, ["NEW_BROKERS", "REGRESSION"])
    assert res.proposals, "expected the new broker to receive replicas"


def test_broken_broker_self_healing():
    """BROKEN_BROKERS over the dead-broker fixture."""
    ct, meta = fixtures.dead_broker_cluster()
    res = _optimize(ct, meta, ["RackAwareGoal", "ReplicaCapacityGoal",
                               "DiskCapacityGoal", "ReplicaDistributionGoal"])
    verify(ct, meta, res, ["BROKEN_BROKERS"])


def test_overfull_cluster_raises_with_provision_recommendation():
    """An over-full cluster raises with an UNDER_PROVISIONED recommendation
    and a broker count: 9 x 320 MB against 3 x 1000 x 0.8 allowed."""
    b = ClusterModelBuilder()
    for i in range(3):
        b.add_broker(i, rack=f"r{i}", capacity={3: 1000.0})
    for p in range(9):
        b.add_replica("T1", p, broker_id=p % 3, is_leader=True,
                      load=[1.0, 10.0, 20.0, 320.0])
    ct, meta = b.build()
    with pytest.raises(OptimizationFailureError) as ei:
        _optimize(ct, meta, ["DiskCapacityGoal"], raise_on_failure=True)
    rec = ei.value.recommendation
    assert rec is not None
    assert rec.status is ProvisionStatus.UNDER_PROVISIONED
    assert rec.num_brokers == 1
    assert "DISK" in rec.reason
    assert "UNDER_PROVISIONED" in str(ei.value)
