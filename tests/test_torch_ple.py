"""The preferred-leader election pass of the port against the JAX package.

- the goal's ``_preferred_leader``, ``_current_leader``, ``violated`` and
  ``apply`` (the K12 twin, then ``refresh``) on ``preferred_leader_skewed``
  and on the 32-broker JBOD state with brokers demoted and dead, the
  reference's side from one fresh interpreter (``reference_ple_cases``);
- the ``/demote_broker`` request (``["PreferredLeaderElectionGoal"]`` alone,
  an empty chain) through ``GoalOptimizer.optimizations`` in the unfused
  shape and in the fused shape (padded R 65,536), and a chain with the pass
  appended, each against the reference's run in a fresh interpreter (see
  torch_reference.py): counts, the PLE result, the final assignment and
  the proposals. Exact throughout (tolerance 0)."""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals.leader_election import (
    PreferredLeaderElectionGoal as RefPLE,
)
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import fixtures as ref_fixtures
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer.goals import make_goal
from cruise_control_tpu_torch.analyzer.optimizer import (
    FUSED_MIN_REPLICAS, GoalOptimizer,
)
from cruise_control_tpu_torch.model import cluster_tensor as port_ct_mod
from cruise_control_tpu_torch.model import fixtures
from cruise_control_tpu_torch.model import random_cluster as port_rc
from torch_reference import one_torch_thread, reference_cases, reference_chain

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

JBOD32 = dict(num_brokers=32, num_racks=4, num_topics=8, num_partitions=1000,
              max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
              target_cpu_util=0.45, num_dead_brokers=1, num_brokers_with_dead_disk=2)
FUSED = dict(JBOD32, num_brokers=64, num_partitions=50000)
PLE = ["PreferredLeaderElectionGoal"]
DEMOTED = [3, 7, 11]


def _states(ct, meta, demoted=()):
    dem = np.zeros(ct.num_brokers, bool)
    dem[list(demoted)] = True
    ct = dataclasses.replace(ct, broker_demoted=jnp.asarray(dem))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    return (renv, rst, convert.env_from_arrays(convert.leaves(renv), "cpu"),
            convert.state_from_arrays(convert.leaves(rst), "cpu"))


def _same_leaves(rst, pst, names):
    for n in names:
        a, b = np.asarray(getattr(rst, n)), getattr(pst, n).numpy()
        if a.dtype.kind == "f":
            assert np.array_equal(a.astype(np.float32).view(np.int32), b.view(np.int32)), n
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), n


CASES = ["skewed", "jbod32", "jbod32-demoted"]


def reference_ple_cases() -> dict:
    """The reference's side of ``test_goal_matches_reference`` for every
    case, as numpy values: run by ``torch_reference.reference_cases`` in a
    fresh interpreter, so the test worker compiles nothing of JAX."""
    out = {}
    for case in CASES:
        if case == "skewed":
            ct, meta = ref_fixtures.preferred_leader_skewed()
            demoted = ()
        else:
            ct, meta = ref_ct_mod.pad_cluster(
                *ref_rc.generate_scale(ref_rc.RandomClusterSpec(**JBOD32)))
            demoted = DEMOTED if case.endswith("demoted") else ()
        renv, rst, _penv, _pst = _states(ct, meta, demoted)
        rg = RefPLE()
        rst2 = rg.apply(renv, rst)
        out[case] = dict(env=convert.leaves(renv), st=convert.leaves(rst),
                         preferred=np.asarray(rg._preferred_leader(renv, rst)),
                         current=np.asarray(rg._current_leader(renv, rst)),
                         was=bool(rg.violated(renv, rst)), st2=convert.leaves(rst2),
                         still=bool(rg.violated(renv, rst2)))
    return out


@pytest.fixture(scope="module")
def ref_ple(tmp_path_factory):
    return reference_cases(tmp_path_factory.mktemp("ple"), "test_torch_ple",
                           "reference_ple_cases")


@pytest.mark.parametrize("case", CASES)
def test_goal_matches_reference(case, ref_ple):
    ref = ref_ple[case]
    penv = convert.env_from_arrays(ref["env"], "cpu")
    pst = convert.state_from_arrays(ref["st"], "cpu")
    rst2 = SimpleNamespace(**ref["st2"])
    pg = make_goal("PreferredLeaderElectionGoal")
    assert np.array_equal(ref["preferred"], pg._preferred_leader(penv, pst).numpy())
    assert np.array_equal(ref["current"], pg._current_leader(penv, pst).numpy())
    was = ref["was"]
    assert was == bool(pg.violated(penv, pst)) == (case != "jbod32")
    pwas, pst2, pstill = pg.run(penv, pst)
    assert bool(pwas) == was and bool(pstill) == ref["still"] is False
    _same_leaves(rst2, pst2, ("replica_is_leader", "leadership_moved", "leader_count",
                              "util", "leader_util", "topic_leader_count", "disk_util"))
    _same_leaves(rst2, pg.apply(penv, pst), ("replica_is_leader",))


def _port_run(spec, goals, demoted=()):
    if isinstance(spec, str):
        ct, meta = getattr(fixtures, spec)()
    else:
        ct, meta = port_rc.generate_scale(port_rc.RandomClusterSpec(**spec))
    dem = np.zeros(ct.num_brokers, bool)
    dem[list(demoted)] = True
    ct = dataclasses.replace(ct, broker_demoted=ct.broker_demoted | dem)
    return ct, meta, GoalOptimizer(device="cpu").optimizations(
        ct, meta, goal_names=goals, skip_hard_goal_check=True, raise_on_failure=False)


def _check_against_reference(tmp_path, spec, goals, demoted):
    ref = reference_chain(tmp_path, spec, goals, demoted=demoted)
    ct, meta, res = _port_run(spec, goals, demoted)
    g = res.goal_results
    counts = dict(before=res.violated_goals_before, after=res.violated_goals_after,
                  actions=[r.iterations for r in g], passes=[r.passes for r in g],
                  moves=res.num_replica_movements, leads=res.num_leadership_movements)
    assert counts == ref["counts"]
    assert [r.disk_actions for r in g] == ref["disk"]
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(res.final_state, name).numpy()), name
    for name in ("util", "disk_util"):
        assert np.array_equal(ref["final"][name].view(np.int32),
                              getattr(res.final_state, name).numpy().view(np.int32)), name
    assert [dataclasses.astuple(p) for p in res.proposals] == ref["proposals"]
    assert res.balancedness_after == ref["balancedness_after"]
    return ct, res


@pytest.mark.parametrize("demoted", [(), DEMOTED], ids=["steady", "demote"])
def test_demote_request_unfused(tmp_path, demoted):
    ct, res = _check_against_reference(tmp_path, JBOD32, PLE, list(demoted))
    (ple,) = res.goal_results
    assert ple.name == PLE[0] and ple.passes == 0 and ple.stat_after == 0.0
    assert ple.violated_after is False
    assert ple.violated_before == bool(demoted) == (ple.iterations == 1)
    assert res.num_replica_movements == 0
    assert (res.num_leadership_movements > 0) == bool(demoted)


def test_demote_request_fused(tmp_path):
    """The fused shape (padded R >= 65,536) with an empty chain: no fused
    prefix, the pass in the closing step."""
    ct, res = _check_against_reference(tmp_path, FUSED, PLE, DEMOTED)
    assert port_ct_mod.pad_cluster(ct, res.meta)[0].num_replicas >= FUSED_MIN_REPLICAS
    assert [r.name for r in res.goal_results] == PLE
    assert res.goal_results[0].violated_before and res.num_leadership_movements > 0


def test_chain_with_the_pass_appended(tmp_path):
    """Three inter-broker goals and both intra-broker goals, then the pass,
    with brokers demoted; PLE reports last."""
    goals = ["RackAwareGoal", "DiskCapacityGoal", "ReplicaDistributionGoal",
             "IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"] + PLE
    _ct, res = _check_against_reference(tmp_path, JBOD32, goals, DEMOTED)
    assert [r.name for r in res.goal_results] == goals
    assert res.goal_results[-1].violated_before
    assert res.goal_results[-1].violated_after is False


def test_preferred_leader_skewed_fixture(tmp_path):
    """``tests/test_parity_fixtures.py``'s preferred-leader case: leadership
    returns to the position-0 replicas on broker 1."""
    _ct, res = _check_against_reference(tmp_path, "preferred_leader_skewed", PLE, [])
    leaders = res.final_state.leader_count.numpy()
    assert leaders[res.meta.broker_index(1)] == 2
    assert leaders[res.meta.broker_index(0)] == 0
    assert res.num_leadership_movements == 2


def test_ple_wrapper_on_cpu_counts_no_launch():
    from cruise_control_tpu_torch import kernels as K
    K.reset_launches()
    _ct, _meta, res = _port_run("preferred_leader_skewed", PLE)
    assert res.goal_results[0].iterations == 1
    assert K.launches()["preferred_leader"] == 0
    assert isinstance(res.final_state.replica_is_leader, torch.Tensor)
