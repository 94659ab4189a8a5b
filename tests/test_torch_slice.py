"""The port's move-branch slice end to end: ``GoalOptimizer.optimizations``
against the JAX package, both run live in the test on the same cluster.

- The 16-broker integer-load fixture (``__graft_entry__._fixture_cluster``)
  is bit-exact: per-goal counts, violation sets, final assignment and
  proposals.
- The 32-broker skewed ``generate_scale`` spec matches too: its loads are
  not integers, but every float the slice adds up follows the reference's
  order (see test_torch_kernels_plain.py), so counts and the assignment are
  equal as well.
- Requests the slice cannot serve raise ``NotImplementedError``.
- The full 1,000-broker slice (``slow``) compares outcomes at size.
"""
import dataclasses

import numpy as np
import pytest

from __graft_entry__ import _fixture_cluster
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as RefOptimizer
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer.engine import EngineParams
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model import random_cluster as port_rc

GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "ReplicaDistributionGoal"]
SMALL = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
             max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
FULL = dict(num_brokers=1000, num_racks=20, num_topics=200, num_partitions=50000,
            max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
KW = dict(goal_names=GOALS, skip_hard_goal_check=True, raise_on_failure=False)


def _run_both(ct, meta):
    ref = RefOptimizer().optimizations(ct, meta, **KW)
    pct, pmeta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    port = GoalOptimizer(device="cpu").optimizations(pct, pmeta, **KW)
    return ref, port


@pytest.fixture(scope="module")
def fixture16():
    return _run_both(*_fixture_cluster())


@pytest.fixture(scope="module")
def spec32():
    return _run_both(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SMALL)))


def _counts(res):
    return dict(before=res.violated_goals_before, after=res.violated_goals_after,
                actions=[g.iterations for g in res.goal_results],
                passes=[g.passes for g in res.goal_results],
                moves=res.num_replica_movements, leads=res.num_leadership_movements)


def _proposals(res):
    return [dataclasses.astuple(p) for p in res.proposals]


def test_fixture16_bit_exact(fixture16):
    ref, port = fixture16
    assert _counts(port) == _counts(ref)
    assert _counts(port) == dict(before=["ReplicaDistributionGoal"], after=[],
                                 actions=[0, 0, 0, 0, 81], passes=[3, 3, 3, 3, 9],
                                 moves=74, leads=57)
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(np.asarray(getattr(ref.final_state, name)),
                              getattr(port.final_state, name).numpy()), name
    assert _proposals(port) == _proposals(ref)
    assert port.balancedness_after == ref.balancedness_after


def test_fixture16_stats_match(fixture16):
    ref, port = fixture16
    for key in ("avg", "max", "min", "std"):
        np.testing.assert_allclose(port.stats_after[key], ref.stats_after[key],
                                   rtol=1e-6)
    assert port.stats_after["replica_count_max"] == ref.stats_after["replica_count_max"]
    assert port.stats_after["num_replicas"] == ref.stats_after["num_replicas"]


def test_spec32_matches_reference(spec32):
    ref, port = spec32
    assert _counts(port) == _counts(ref)
    assert _counts(port) == dict(
        before=["RackAwareGoal", "ReplicaDistributionGoal"], after=[],
        actions=[60, 0, 0, 0, 207], passes=[6, 3, 3, 3, 15], moves=245, leads=170)
    assert np.array_equal(np.asarray(ref.final_state.replica_broker),
                          port.final_state.replica_broker.numpy())
    assert _proposals(port) == _proposals(ref)


def test_port_generator_feeds_the_same_run(spec32):
    """The port's own random_cluster gives the run the reference's cluster."""
    _, port = spec32
    ct, meta = port_rc.generate_scale(port_rc.RandomClusterSpec(**SMALL))
    own = GoalOptimizer(device="cpu").optimizations(ct, meta, **KW)
    assert _counts(own) == _counts(port)
    assert np.array_equal(own.final_state.replica_broker.numpy(),
                          port.final_state.replica_broker.numpy())


def _mid_cluster():
    # padded R of 12,288: the reference runs the chunked dispatch + finisher
    return port_rc.generate_scale(port_rc.RandomClusterSpec(
        num_brokers=64, num_racks=4, num_topics=8, num_partitions=8000,
        max_replication=3, seed=3))


UNSUPPORTED = {
    "goal outside the slice": (dict(goal_names=["CpuCapacityGoal"]), None),
    "deep-tail goal": (dict(goal_names=["DiskUsageDistributionGoal"]), None),
    "preferred leader election": (
        dict(goal_names=GOALS + ["PreferredLeaderElectionGoal"]), None),
    "session": (dict(session=object()), None),
    "measured goal durations": (dict(measure_goal_durations=True), None),
    "chunked / finisher size": ({}, _mid_cluster),
    "bf16": ({}, "bf16"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_requests_raise(case):
    extra, special = UNSUPPORTED[case]
    kw = {**KW, **extra}
    if special is _mid_cluster:
        ct, meta = _mid_cluster()
    else:
        ct, meta = _fixture_cluster()
        ct, meta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    params = EngineParams(compute_dtype="bfloat16") if special == "bf16" else None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GoalOptimizer(engine_params=params, device="cpu").optimizations(ct, meta, **kw)


def test_config_surface_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GoalOptimizer(config={"goals": GOALS}, device="cpu")


@pytest.mark.slow
def test_full_slice_matches_reference():
    """The first slice at its real size (1,000 brokers, 98,326 replicas,
    padded R = 114,688: the fused prefix chain)."""
    ref, port = _run_both(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**FULL)))
    assert _counts(port)["before"] == ["RackAwareGoal", "ReplicaDistributionGoal"]
    assert _counts(port)["after"] == []
    assert _counts(port) == _counts(ref)
