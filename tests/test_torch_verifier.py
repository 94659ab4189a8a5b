"""The port's verification modules against the JAX package's functions.

- ``analyzer/verifier.py`` (``verify_no_regression``,
  ``verify_no_dead_placement``, ``verify_proposals``,
  ``verify_operation_result``) and ``detector/provisioner.py``
  ``recommendation_from_result``: the port's function and the reference's
  on the SAME port results (the reference's functions read the result's
  arrays through numpy), including tampered copies that must report;
  the lists, statuses, counts and reasons must be equal.
- ``model/stats.py`` ``cluster_stats`` and ``model/sanity.py``
  ``sanity_check`` on the same clusters (the reference's ClusterTensor and
  the port's copy by ``convert``): counts, maxima and minima exact; the
  means and standard deviations within 1e-6 relative (their f32 sums over
  brokers take another order than XLA's); the same ``SanityCheckError``
  messages on broken clusters.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import verifier as ref_verifier
from cruise_control_tpu.analyzer.env import BalancingConstraint as RefConstraint
from cruise_control_tpu.detector.provisioner import (
    recommendation_from_result as ref_recommendation,
)
from cruise_control_tpu.model import cluster_stats as ref_cluster_stats
from cruise_control_tpu.model import fixtures as ref_fixtures
from cruise_control_tpu.model import sanity_check as ref_sanity_check
from cruise_control_tpu.model.sanity import SanityCheckError as RefSanityError
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import verifier
from cruise_control_tpu_torch.analyzer.env import BalancingConstraint
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.detector import ProvisionStatus, recommendation_from_result
from cruise_control_tpu_torch.model import (
    SanityCheckError, cluster_stats, fixtures, sanity_check,
)
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _run(ct, meta, goals, constraint=None):
    return GoalOptimizer(constraint=constraint, device="cpu").optimizations(
        ct, meta, goal_names=goals, skip_hard_goal_check=True, raise_on_failure=False)


def _overfull():
    b = ClusterModelBuilder()
    for i in range(3):
        b.add_broker(i, rack=f"r{i}", capacity={3: 1000.0})
    for p in range(9):
        b.add_replica("T1", p, broker_id=p % 3, is_leader=True,
                      load=[1.0, 10.0, 20.0, 320.0])
    return b.build()


@pytest.fixture(scope="module")
def results():
    return {
        "unbalanced2": _run(*fixtures.unbalanced2(), ["ReplicaDistributionGoal"]),
        "dead_broker": _run(*fixtures.dead_broker_cluster(),
                            ["RackAwareGoal", "ReplicaDistributionGoal"]),
        "dead_broker_unhealed": _run(*fixtures.dead_broker_cluster(),
                                     ["LeaderReplicaDistributionGoal"]),
        "overfull": _run(*_overfull(), ["DiskCapacityGoal"]),
        "small_java": _run(*fixtures.small_cluster_java(),
                           ["RackAwareGoal", "ReplicaDistributionGoal",
                            "DiskUsageDistributionGoal"]),
    }


def _tampered(res):
    """A copy whose first goal regressed, whose offline count grew and whose
    proposals break every structural rule once."""
    goal = dataclasses.replace(res.goal_results[0], stat_before=1.0, stat_after=2.0)
    p = res.proposals[0]
    b0 = p.new_replicas[0][0]
    bad = [
        dataclasses.replace(p, new_replicas=()),
        dataclasses.replace(p, new_replicas=((b0, -1), (b0, -1))),
        dataclasses.replace(p, new_leader=10_000),
        dataclasses.replace(p, new_replicas=p.new_replicas + ((10_001, -1),)),
    ]
    return types.SimpleNamespace(
        goal_results=[goal] + res.goal_results[1:], proposals=bad + list(res.proposals),
        stats_before=dict(res.stats_before, num_offline_replicas=0),
        stats_after=dict(res.stats_after, num_offline_replicas=3),
        env=res.env, final_state=res.final_state, meta=res.meta)


@pytest.mark.parametrize("name", ["unbalanced2", "dead_broker", "dead_broker_unhealed",
                                  "small_java", "tampered"])
def test_verifier_matches_reference(results, name):
    res = (_tampered(results["small_java"]) if name == "tampered" else results[name])
    for fn in ("verify_no_regression", "verify_no_dead_placement"):
        assert getattr(verifier, fn)(res) == getattr(ref_verifier, fn)(res), fn
    for op in ("", "TOPIC_REPLICATION_FACTOR"):
        assert (verifier.verify_proposals(res, op)
                == ref_verifier.verify_proposals(res, op))
    assert (verifier.verify_proposals(res, max_proposals=2)
            == ref_verifier.verify_proposals(res, max_proposals=2))
    out = verifier.verify_operation_result("REBALANCE", res)
    assert out == ref_verifier.verify_operation_result("REBALANCE", res)
    assert verifier.verify_operation_result("REBALANCE", None) == []
    if name == "tampered":
        assert len(out) >= 6
    elif name != "dead_broker_unhealed":
        assert out == []
    if name == "dead_broker_unhealed":
        assert verifier.verify_no_dead_placement(res) != []


@pytest.mark.parametrize("case", ["overfull", "dead_broker_unhealed", "small_java",
                                  "low_utilization"])
def test_recommendation_matches_reference(results, case):
    if case == "low_utilization":
        # every resource far below a low-utilization threshold: the
        # OVER_PROVISIONED branch and its floors
        low = (0.5, 0.5, 0.5, 0.5)
        res = _run(*fixtures.medium_cluster_java(), ["ReplicaDistributionGoal"],
                   BalancingConstraint(low_utilization_threshold=low))
        port_c = BalancingConstraint(low_utilization_threshold=low)
        ref_c = RefConstraint(low_utilization_threshold=low)
    else:
        res = results[case]
        port_c, ref_c = BalancingConstraint(), RefConstraint()
    got = recommendation_from_result(res, port_c)
    want = ref_recommendation(res, ref_c)
    assert (got.status.value, got.num_brokers, got.reason) == (
        want.status.value, want.num_brokers, want.reason)
    assert got.to_json() == want.to_json()
    expect = {"overfull": ProvisionStatus.UNDER_PROVISIONED,
              "dead_broker_unhealed": ProvisionStatus.UNDER_PROVISIONED,
              "small_java": ProvisionStatus.RIGHT_SIZED}.get(case)
    if expect is not None:
        assert got.status is expect


def _clusters():
    out = {}
    for name in ("small_cluster", "dead_broker_cluster", "medium_cluster_java",
                 "unbalanced_two_brokers"):
        ct, meta = getattr(ref_fixtures, name)()
        out[name] = (ct, convert.cluster_from_arrays(convert.leaves(ct), meta)[0])
    return out


CLUSTERS = _clusters()
EXACT = ("max", "min", "replica_count_avg", "replica_count_max", "replica_count_min",
         "leader_count_max", "potential_nw_out_max", "num_alive_brokers", "num_replicas",
         "num_offline_replicas")


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_cluster_stats_matches_reference(name):
    rct, pct = CLUSTERS[name]
    want = ref_cluster_stats(rct)
    got = cluster_stats(pct, device="cpu")
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name), np.float64)
        g = getattr(got, f.name).numpy().astype(np.float64)
        if f.name in EXACT:
            assert np.array_equal(w, g), f.name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f.name)


def _broken(kind, ct):
    """(field, numpy value) breaking one invariant of ``ct``."""
    broker = np.array(ct.replica_broker)
    leader = np.array(ct.replica_is_leader)
    valid = np.asarray(ct.replica_valid)
    part = np.asarray(ct.replica_partition)
    if kind == "out_of_range":
        broker[0] = ct.num_brokers + 3
        return "replica_broker", broker
    if kind == "two_leaders":
        p = part[0]
        leader[(part == p) & valid] = True
        return "replica_is_leader", leader
    if kind == "same_broker":
        p = part[0]
        rows = np.flatnonzero((part == p) & valid)
        broker[rows[1]] = broker[rows[0]]
        return "replica_broker", broker
    if kind == "dead_not_offline":
        return "replica_offline", np.zeros_like(np.asarray(ct.replica_offline))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["ok", "out_of_range", "two_leaders", "same_broker",
                                  "dead_not_offline"])
def test_sanity_check_matches_reference(kind):
    rct, pct = CLUSTERS["dead_broker_cluster"]
    if kind == "ok":
        assert ref_sanity_check(rct) is None and sanity_check(pct) is None
        return
    field, value = _broken(kind, pct)
    rct = dataclasses.replace(rct, **{field: jnp.asarray(value)})
    pct = dataclasses.replace(pct, **{field: value})
    with pytest.raises(RefSanityError) as want:
        ref_sanity_check(rct)
    with pytest.raises(SanityCheckError) as got:
        sanity_check(pct)
    assert str(got.value) == str(want.value)


def test_stats_are_computed_on_the_requested_device():
    _, pct = CLUSTERS["small_cluster"]
    assert cluster_stats(pct, device="cpu").avg.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cluster_stats(pct)
