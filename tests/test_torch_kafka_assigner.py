"""The kafka-assigner mode of the port (``goals/kafka_assigner.py``).

The library cases of the reference's tests/test_kafka_assigner.py, through
the port on the same hand-built clusters and held to the same assertions
(swap-only disk balancing keeps every broker's replica count; the even
rack-aware goal spreads RF 2 over 2 racks; the goal-name substitution).
The reference's ``test_rebalance_kafka_assigner_mode`` drives the facade's
``rebalance(kafka_assigner=True)``; its port runs over HTTP through the
port's REST server (``/rebalance?kafka_assigner=true``).

The kafka-assigner chain (``kafka_assigner_goal_names([])``) on spec-32b runs
against the reference in a fresh interpreter (torch_reference.py): counts,
swap actions, assignment and proposals bit for bit.
"""
import dataclasses

import numpy as np
import pytest

from cruise_control_tpu_torch.analyzer import init_state, make_env
from cruise_control_tpu_torch.analyzer.engine import EngineParams, optimize_goal
from cruise_control_tpu_torch.analyzer.goals import kafka_assigner_goal_names, make_goal
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model import random_cluster as port_rc
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
from torch_reference import one_torch_thread, reference_chain

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SMALL = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
             max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)


def _disk_skewed_cluster():
    """4 brokers, equal replica counts, wildly unequal disk load."""
    b = ClusterModelBuilder()
    for i in range(4):
        b.add_broker(i, rack=f"r{i % 2}")
    p = 0
    sizes = {0: 900.0, 1: 500.0, 2: 120.0, 3: 30.0}
    for broker, size in sizes.items():
        for _ in range(4):
            b.add_replica("t", p, broker, is_leader=True, load=[1.0, 10.0, 0.0, size])
            p += 1
    return b.build()


def _rack_skewed_cluster():
    """RF=2 partitions all packed into rack r0 (brokers 0, 2); r1 empty."""
    b = ClusterModelBuilder()
    for i in range(4):
        b.add_broker(i, rack=f"r{i % 2}")
    for p in range(6):
        b.add_replica("t", p, 0, is_leader=True, load=[1.0, 10.0, 20.0, 100.0])
        b.add_replica("t", p, 2, is_leader=False, load=[1.0, 10.0, 20.0, 100.0])
    return b.build()


def _run(goal_name, ct, meta):
    env = make_env(ct, meta, device="cpu")
    st = init_state(env, ct.replica_broker, ct.replica_is_leader, ct.replica_offline,
                    ct.replica_disk)
    st2, info = optimize_goal(env, st, make_goal(goal_name), (), EngineParams(max_iters=64))
    return st, st2, info


def test_assigner_disk_goal_swaps_only():
    st0, st, info = _run("KafkaAssignerDiskUsageDistributionGoal", *_disk_skewed_cluster())
    assert np.array_equal(st.replica_count.numpy(), st0.replica_count.numpy())
    du0 = st0.util[:, 3].numpy()
    du1 = st.util[:, 3].numpy()
    assert du1.std() < du0.std()
    assert int(st.moved.sum()) > 0
    assert info["swap_actions"] > 0 and info["move_actions"] == 0


def test_assigner_even_rack_aware_goal():
    _, st, info = _run("KafkaAssignerEvenRackAwareGoal", *_rack_skewed_cluster())
    assert not bool(info["violated_after"])
    assert (st.part_rack_count.numpy().max(axis=1) <= 1).all()


def test_goal_name_substitution():
    assert kafka_assigner_goal_names([]) == [
        "KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]
    out = kafka_assigner_goal_names(
        ["RackAwareGoal", "DiskUsageDistributionGoal", "ReplicaDistributionGoal"])
    assert out == ["KafkaAssignerEvenRackAwareGoal",
                   "KafkaAssignerDiskUsageDistributionGoal", "ReplicaDistributionGoal"]
    assert kafka_assigner_goal_names(["RackAwareGoal", "RackAwareDistributionGoal"]) == [
        "KafkaAssignerEvenRackAwareGoal"]


def test_kafka_assigner_chain_spec32_matches_reference(tmp_path):
    """The mode's two goals on spec-32b: the rack goal's move waves, then
    the disk goal's swap passes alone (its finisher returns at once)."""
    goals = kafka_assigner_goal_names([])
    ref = reference_chain(tmp_path, SMALL, goals)
    ct, meta = port_rc.generate_scale(port_rc.RandomClusterSpec(**SMALL))
    res = GoalOptimizer(device="cpu").optimizations(
        ct, meta, goal_names=goals, skip_hard_goal_check=True, raise_on_failure=False)
    g = res.goal_results
    counts = dict(before=res.violated_goals_before, after=res.violated_goals_after,
                  actions=[r.iterations for r in g], passes=[r.passes for r in g],
                  moves=res.num_replica_movements, leads=res.num_leadership_movements)
    assert counts == ref["counts"]
    assert counts["actions"] == [60, 100] and counts["after"] == []
    assert [r.swap_actions for r in g] == ref["swaps"] == [0, 100]
    assert [r.move_actions for r in g][1] == 0
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(res.final_state, name).numpy()), name
    assert [dataclasses.astuple(p) for p in res.proposals] == ref["proposals"]


def test_rebalance_kafka_assigner_mode_over_rest():
    """``POST /rebalance?kafka_assigner=true&dryrun=true`` runs the two
    kafka-assigner goals, in their order (the reference's
    ``test_rebalance_kafka_assigner_mode``, through the port's server)."""
    import json
    import urllib.request

    from cruise_control_tpu_torch.api import CruiseControlServer
    from cruise_control_tpu_torch.app import CruiseControl
    from cruise_control_tpu_torch.backend import SimulatedClusterBackend
    from cruise_control_tpu_torch.config import cruise_control_config
    be = SimulatedClusterBackend()
    for i in range(4):
        be.add_broker(i, f"r{i % 2}")
    for p in range(8):
        be.create_partition("t", p, [p % 2 * 2, p % 2 * 2 + 1], size_mb=100.0 * (1 + p % 4),
                            bytes_in_rate=10.0, bytes_out_rate=5.0, cpu_util=1.0)
    cc = CruiseControl(be, cruise_control_config({
        "num.metrics.windows": 5, "min.samples.per.metrics.window": 1}), device="cpu")
    cc.start_up()
    for i in range(8):
        cc.load_monitor.sample_once(now_ms=i * 300_000.0)
    srv = CruiseControlServer(cc, port=0, max_block_ms=120_000.0)
    srv.start()
    try:
        req = urllib.request.Request(
            f"{srv.base_url}/rebalance?kafka_assigner=true&dryrun=true", method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = json.loads(resp.read().decode())
    finally:
        srv.stop()
    assert out["operation"] == "REBALANCE"
    assert [g["goal"] for g in out["result"]["goalSummary"]] == [
        "KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]
