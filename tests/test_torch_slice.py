"""The port's chains end to end: ``GoalOptimizer.optimizations`` against the
JAX package, both run live in the test on the same cluster.

The five move-branch goals of the first slice (``GOALS``):

- The 16-broker integer-load fixture (``__graft_entry__._fixture_cluster``)
  is bit-exact: per-goal counts, violation sets, final assignment and
  proposals.
- The 32-broker skewed ``generate_scale`` spec matches too: its loads are
  not integers, but every float the slice adds up follows the reference's
  order (see test_torch_kernels_plain.py), so counts and the assignment are
  equal as well.
- The goals that used to raise (RackAwareDistributionGoal and the two
  kafka-assigner goals) run and match the reference on fixture16; so do the
  requests that used to raise for their engine paths: a goal without wave
  budgets alone and in front of LeaderReplicaDistributionGoal (the
  one-move-per-broker wave and the sequential leadership fallback), the
  pooled candidate keying and the per-goal accept masks.
- The full 1,000-broker slice (``slow``) compares outcomes at size.

Every reference outcome comes from a fresh interpreter (torch_reference.py).

The default chain minus its swap goals (``CHAIN``, eleven goals with the
leadership branch, the finisher and the chunked dispatch; the reference's
outcome comes from a fresh interpreter, see torch_reference.py):
- fixture16 bit for bit (counts, assignment, proposals); spec-32b counts and
  assignment; mid-64b (padded R 12,288: every goal chunked, finisher on)
  counts, ``fixpoint_proven`` and ``finisher_rounds`` per goal;
- the full 1,000-broker slice (``slow``: fused prefix of nine goals, two
  chunked deep-tail goals with the finisher).

The sixteen default goals (``DEFAULT_GOALS``, with the swap branch; the
reference again from a fresh interpreter):
- fixture16 bit for bit (counts, swap actions, assignment, proposals);
  spec-32b counts, swap actions and assignment; mid-64b counts,
  ``fixpoint_proven``, ``finisher_rounds`` and ``swap_window_remaining``
  per goal (the four usage goals' swap windows read 0);
- the full 1,000-broker slice (``slow``: fused prefix of nine goals, seven
  chunked goals with the finisher).

The 18-goal chain of the Java parity matrix (``FULL_CHAIN``: the sixteen
goals with RackAwareDistributionGoal after RackAwareGoal and
TopicReplicaDistributionGoal last, then the preferred-leader pass) on
fixture16 and at 1,000 brokers, and the kafka-assigner chain at 1,000
brokers (all ``slow``): counts, swap actions, finisher fields, assignment
and proposals against the reference (the tier-1 sizes are in
test_torch_parity_matrix.py and test_torch_kafka_assigner.py).

The JBOD self-healing path (four logdirs per broker, dead brokers and dead
disks; the reference again from a fresh interpreter):
- the intra-broker chain (``rebalance_disk``) and the ten-goal chain of
  ``bench.py``'s rung 5 (eight inter-broker goals, then both intra-broker
  goals) at 32 brokers (unfused) and 64 brokers (padded R 10,240: chunked,
  the intra-broker goals with their finisher gated out): counts, disk
  actions, proposals and the final assignment with ``replica_disk``;
- at 1,000 brokers (``slow``): both chains and the ``/demote_broker``
  request (PreferredLeaderElectionGoal alone, five brokers demoted).
"""
import dataclasses

import numpy as np
import pytest

from __graft_entry__ import _fixture_cluster
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer.engine import EngineParams
from cruise_control_tpu_torch.analyzer.goals import GOAL_CLASSES, GoalKernel
from cruise_control_tpu_torch.analyzer.goals.distribution import (
    LeaderReplicaDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.optimizer import DEFAULT_GOALS, GoalOptimizer
from cruise_control_tpu_torch.model import random_cluster as port_rc
from torch_reference import (
    background_reference, chains_job, one_torch_thread, reference_chain,
    start_background_reference,
)

GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "ReplicaDistributionGoal"]
SMALL = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
             max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
FULL = dict(num_brokers=1000, num_racks=20, num_topics=200, num_partitions=50000,
            max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
KW = dict(goal_names=GOALS, skip_hard_goal_check=True, raise_on_failure=False)
CHAIN = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
         "DiskCapacityGoal", "NetworkInboundCapacityGoal",
         "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
         "PotentialNwOutGoal", "LeaderReplicaDistributionGoal",
         "LeaderBytesInDistributionGoal"]
MID = dict(num_brokers=64, num_racks=4, num_topics=8, num_partitions=8000,
           max_replication=3, seed=3)
# the Java parity matrix's 18 goals and the kafka-assigner mode's two
FULL_CHAIN = (["RackAwareGoal", "RackAwareDistributionGoal"] + DEFAULT_GOALS[1:13]
              + ["LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
                 "TopicReplicaDistributionGoal", "PreferredLeaderElectionGoal"])
KAFKA_ASSIGNER = ["KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]


# the requests that raised until their goals were ported, on fixture16
FORMERLY_UNPORTED = {
    "swap goal": ["KafkaAssignerDiskUsageDistributionGoal"],
    "deep-tail goal": ["DiskUsageDistributionGoal",
                       "KafkaAssignerDiskUsageDistributionGoal"],
    "rack-aware distribution goal": ["RackAwareDistributionGoal"],
    "kafka-assigner rack goal": GOALS + ["KafkaAssignerEvenRackAwareGoal"],
}


@dataclasses.dataclass(frozen=True)
class _NoLeaderBudgetGoal(LeaderReplicaDistributionGoal):
    """A leadership goal whose acceptance has no cumulative (wave) form:
    its chain needs the reference's sequential leadership fallback and its
    one-move-per-broker wave (the reference's child registers its twin)."""
    wave_budgets = GoalKernel.wave_budgets

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "name", "NoLeaderBudgetGoal")


# the requests that raised until their engine paths were ported, on
# fixture16: (goals, EngineParams fields); the pooled keying with a pool
# below fixture16's R (the default pool covers it), so both branches run
FORMERLY_RAISING = {
    "sequential leadership fallback": (["NoLeaderBudgetGoal"], None),
    "fallbacks behind a non-budget goal": (
        ["NoLeaderBudgetGoal", "LeaderReplicaDistributionGoal"], None),
    "pooled candidate keying": (GOALS, dict(compact_keying=True, compact_pool=64,
                                            num_candidates=16)),
    "per-goal accept masks": (GOALS, dict(chain_cache=False)),
}


# this module's tensors are small: one intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _port_run(spec, goals=GOALS, params=None):
    """The port's run of ``goals`` on the reference's cluster (``spec`` None:
    fixture16), with ``params`` (EngineParams fields) when given."""
    ct, meta = (_fixture_cluster() if spec is None
                else ref_rc.generate_scale(ref_rc.RandomClusterSpec(**spec)))
    pct, pmeta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    opt = GoalOptimizer(device="cpu",
                        engine_params=EngineParams(**params) if params else None)
    return opt.optimizations(pct, pmeta, **{**KW, "goal_names": goals})


# the reference's fixture16 runs of ``GOALS``, ``FORMERLY_UNPORTED`` and
# ``FORMERLY_RAISING`` in one fresh interpreter (the chains share their
# programs at this shape), started when the module is imported (under
# xdist, once per session, in the background)
_FIXTURE16_JOBS = {"runs": chains_job(
    [dict(spec=None, goals=GOALS)]
    + [dict(spec=None, goals=g) for g in FORMERLY_UNPORTED.values()]
    + [dict(spec=None, goals=g, params=p) for g, p in FORMERLY_RAISING.values()])}
start_background_reference("slice_fixture16", _FIXTURE16_JOBS)


@pytest.fixture(scope="module")
def fixture16_refs(tmp_path_factory):
    """The reference's fixture16 runs, once per test session."""
    out = background_reference(tmp_path_factory, "slice_fixture16", _FIXTURE16_JOBS)["runs"]
    return dict(zip(["GOALS", *FORMERLY_UNPORTED, *FORMERLY_RAISING], out))


@pytest.fixture(scope="module")
def fixture16(fixture16_refs):
    return fixture16_refs["GOALS"], _port_run(None)


@pytest.fixture(scope="module")
def spec32(tmp_path_factory):
    return (reference_chain(tmp_path_factory.mktemp("spec32"), SMALL, GOALS),
            _port_run(SMALL))


def _counts(res):
    return dict(before=res.violated_goals_before, after=res.violated_goals_after,
                actions=[g.iterations for g in res.goal_results],
                passes=[g.passes for g in res.goal_results],
                moves=res.num_replica_movements, leads=res.num_leadership_movements)


def _proposals(res):
    return [dataclasses.astuple(p) for p in res.proposals]


def test_fixture16_bit_exact(fixture16):
    ref, port = fixture16
    assert _counts(port) == ref["counts"]
    assert _counts(port) == dict(before=["ReplicaDistributionGoal"], after=[],
                                 actions=[0, 0, 0, 0, 81], passes=[3, 3, 3, 3, 9],
                                 moves=74, leads=57)
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(port.final_state, name).numpy()), name
    assert _proposals(port) == ref["proposals"]
    assert port.balancedness_after == ref["balancedness_after"]


def test_fixture16_stats_match(fixture16):
    ref, port = fixture16
    for key in ("avg", "max", "min", "std"):
        np.testing.assert_allclose(port.stats_after[key], ref["stats_after"][key],
                                   rtol=1e-6)
    assert (port.stats_after["replica_count_max"]
            == ref["stats_after"]["replica_count_max"])
    assert port.stats_after["num_replicas"] == ref["stats_after"]["num_replicas"]


def test_spec32_matches_reference(spec32):
    ref, port = spec32
    assert _counts(port) == ref["counts"]
    assert _counts(port) == dict(
        before=["RackAwareGoal", "ReplicaDistributionGoal"], after=[],
        actions=[60, 0, 0, 0, 207], passes=[6, 3, 3, 3, 15], moves=245, leads=170)
    assert np.array_equal(ref["final"]["replica_broker"],
                          port.final_state.replica_broker.numpy())
    assert _proposals(port) == ref["proposals"]


def test_port_generator_feeds_the_same_run(spec32):
    """The port's own random_cluster gives the run the reference's cluster."""
    _, port = spec32
    ct, meta = port_rc.generate_scale(port_rc.RandomClusterSpec(**SMALL))
    own = GoalOptimizer(device="cpu").optimizations(ct, meta, **KW)
    assert _counts(own) == _counts(port)
    assert np.array_equal(own.final_state.replica_broker.numpy(),
                          port.final_state.replica_broker.numpy())


@pytest.mark.parametrize("case", sorted(FORMERLY_RAISING))
def test_formerly_raising_requests_run(fixture16_refs, case, monkeypatch):
    """A goal without wave budgets (alone, and in front of
    LeaderReplicaDistributionGoal: the one-move-per-broker wave and
    ``seq_body``), ``compact_keying`` and ``chain_cache=False`` (formerly
    ``NotImplementedError``s of item 5b): the request runs and gives the
    reference's own run of the same settings bit for bit (counts, swap
    actions, certificate fields, assignment, proposals). The pooled case
    takes the pool and the full sweep both."""
    from cruise_control_tpu_torch.kernels import pool_branch_counts, reset_pool_branches
    monkeypatch.setitem(GOAL_CLASSES, "NoLeaderBudgetGoal", _NoLeaderBudgetGoal)
    goals, params = FORMERLY_RAISING[case]
    reset_pool_branches()
    ref, port = fixture16_refs[case], _port_run(None, goals, params)
    assert _counts(port) == ref["counts"]
    assert [g.swap_actions for g in port.goal_results] == ref["swaps"]
    assert ([g.fixpoint_proven for g in port.goal_results],
            [g.finisher_rounds for g in port.goal_results],
            [g.swap_window_remaining for g in port.goal_results]) == (
        ref["finisher"]["proven"], ref["finisher"]["rounds"], ref["finisher"]["swleft"])
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(port.final_state, name).numpy()), name
    assert _proposals(port) == ref["proposals"]
    branches = pool_branch_counts()
    if params and params.get("compact_keying"):
        assert branches["pooled"] > 0 and branches["full"] > 0, branches
    else:
        assert branches == {"pooled": 0, "full": 0}


def test_measured_goal_durations_give_the_unmeasured_outcome():
    """``measure_goal_durations=True`` (formerly a NotImplementedError of
    this module's unsupported requests) runs the per-goal dispatch with a
    device wait after each goal: the same outcome as the default run, and
    every goal its own wall."""
    ct, meta = _fixture_cluster()
    ct, meta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    plain = GoalOptimizer(device="cpu").optimizations(ct, meta, **KW)
    measured = GoalOptimizer(device="cpu").optimizations(ct, meta, measure_goal_durations=True,
                                                         **KW)
    assert _counts(measured) == _counts(plain)
    assert _proposals(measured) == _proposals(plain)
    assert measured.durations_measured and not plain.durations_measured
    assert all(g.duration_s > 0 for g in measured.goal_results)


@pytest.mark.parametrize("case", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_goals_run(fixture16_refs, case):
    """RackAwareDistributionGoal, the kafka-assigner goals, a swap-only goal
    alone and behind a deep-tail goal: the request runs and gives the
    reference's counts, swap actions, assignment and proposals."""
    ref, port = fixture16_refs[case], _port_run(None, FORMERLY_UNPORTED[case])
    assert _counts(port) == ref["counts"]
    assert [g.swap_actions for g in port.goal_results] == ref["swaps"]
    for name in ("replica_broker", "replica_is_leader"):
        assert np.array_equal(ref["final"][name],
                              getattr(port.final_state, name).numpy()), name
    assert _proposals(port) == ref["proposals"]


def test_config_surface_raises():
    """The config surface is ported (tests/test_torch_config.py); the
    sharded engine it can ask for is not."""
    from cruise_control_tpu_torch.config import cruise_control_config
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GoalOptimizer(config=cruise_control_config({"tpu.mesh.axis.brokers": 2}),
                      device="cpu")


@pytest.mark.slow
def test_full_slice_matches_reference(tmp_path):
    """The first slice at its real size (1,000 brokers, 98,326 replicas,
    padded R = 114,688: the fused prefix chain)."""
    ref, port = _run_chain(tmp_path, FULL, GOALS)
    assert _counts(port)["before"] == ["RackAwareGoal", "ReplicaDistributionGoal"]
    assert _counts(port)["after"] == []
    assert _counts(port) == ref["counts"]


# --- the default chain minus its swap goals ---------------------------------
def _run_chain(tmp_path, spec, goals=CHAIN):
    """The JAX reference's outcome (computed in a fresh interpreter, see
    torch_reference.py) and the port's run on the same cluster."""
    return reference_chain(tmp_path, spec, goals), _port_run(spec, goals)


def _finisher_fields(res):
    return dict(proven=[g.fixpoint_proven for g in res.goal_results],
                rounds=[g.finisher_rounds for g in res.goal_results],
                quiesce=[g.quiesce_chunk for g in res.goal_results],
                swleft=[g.swap_window_remaining for g in res.goal_results])


def _swaps(res):
    return [g.swap_actions for g in res.goal_results]


def _same_final(ref, port, names):
    for name in names:
        assert np.array_equal(ref["final"][name],
                              getattr(port.final_state, name).numpy()), name


def test_chain_fixture16_bit_exact(tmp_path):
    ref, port = _run_chain(tmp_path, None)
    assert _counts(port) == ref["counts"]
    assert _counts(port) == dict(
        before=["ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
                "LeaderBytesInDistributionGoal"],
        after=["LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"],
        actions=[0, 0, 0, 0, 0, 0, 0, 81, 0, 5, 2],
        passes=[3, 3, 3, 3, 3, 3, 3, 9, 3, 35, 36], moves=74, leads=63)
    _same_final(ref, port, ("replica_broker", "replica_is_leader", "replica_disk"))
    assert _proposals(port) == ref["proposals"]
    assert port.balancedness_after == ref["balancedness_after"]


def test_chain_spec32_matches_reference(tmp_path):
    ref, port = _run_chain(tmp_path, SMALL)
    assert _counts(port) == ref["counts"]
    assert _counts(port) == dict(
        before=["RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"],
        after=["LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"],
        actions=[60, 0, 0, 0, 0, 0, 19, 178, 0, 19, 23],
        passes=[6, 3, 3, 3, 3, 3, 4, 12, 3, 35, 59], moves=258, leads=204)
    _same_final(ref, port, ("replica_broker", "replica_is_leader"))


def test_chain_mid64_matches_reference(tmp_path):
    """Padded R 12,288: the unfused chain, every goal through the chunked
    dispatch and the finisher (four goals end as proven fixpoints)."""
    ref, port = _run_chain(tmp_path, MID)
    assert _counts(port) == ref["counts"]
    assert _finisher_fields(port) == ref["finisher"]
    assert _finisher_fields(port)["proven"] == [False] * 6 + [True, True, False,
                                                              True, True]
    assert _counts(port)["passes"] == [14, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8]
    _same_final(ref, port, ("replica_broker",))


@pytest.mark.slow
def test_chain_full_slice_matches_reference(tmp_path):
    """The chain at its real size (1,000 brokers, padded R = 114,688): the
    fused prefix of nine goals, then the two deep-tail goals chunked with
    the finisher."""
    ref, port = _run_chain(tmp_path, FULL)
    assert _counts(port) == ref["counts"]
    assert _counts(port)["actions"] == [3051, 0, 0, 0, 0, 0, 557, 18136, 0, 1393, 1680]
    assert (_counts(port)["moves"], _counts(port)["leads"]) == (18469, 10751)
    assert _finisher_fields(port) == ref["finisher"]
    _same_final(ref, port, ("replica_broker",))


# --- the sixteen default goals ----------------------------------------------
def test_default_fixture16_bit_exact(tmp_path):
    ref, port = _run_chain(tmp_path, None, DEFAULT_GOALS)
    assert _counts(port) == ref["counts"]
    assert _swaps(port) == ref["swaps"]
    assert _counts(port) == dict(
        before=["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
                "NetworkInboundUsageDistributionGoal",
                "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"],
        after=[], actions=[0, 0, 0, 0, 0, 0, 0, 81, 0, 1, 0, 11, 0, 0, 0, 0],
        passes=[3, 3, 3, 3, 3, 3, 3, 9, 3, 4, 3, 10, 3, 3, 3, 3], moves=83, leads=66)
    assert _swaps(port)[9:14] == [0, 0, 1, 0, 0]
    _same_final(ref, port, ("replica_broker", "replica_is_leader", "replica_disk"))
    assert _proposals(port) == ref["proposals"]
    assert port.balancedness_after == ref["balancedness_after"]


def test_default_spec32_matches_reference(tmp_path):
    ref, port = _run_chain(tmp_path, SMALL, DEFAULT_GOALS)
    assert _counts(port) == ref["counts"]
    assert _swaps(port) == ref["swaps"]
    assert _counts(port)["actions"] == [60, 0, 0, 0, 0, 0, 19, 178, 0, 19, 20, 26, 18,
                                        0, 0, 8]
    assert (_counts(port)["moves"], _counts(port)["leads"]) == (307, 242)
    assert _swaps(port)[9:14] == [1, 1, 4, 1, 0]
    _same_final(ref, port, ("replica_broker", "replica_is_leader"))


def test_default_mid64_matches_reference(tmp_path):
    """Padded R 12,288: every goal chunked with the finisher; the four usage
    goals end as proven fixpoints whose swap windows read 0."""
    ref, port = _run_chain(tmp_path, MID, DEFAULT_GOALS)
    assert _counts(port) == ref["counts"]
    assert _finisher_fields(port) == ref["finisher"]
    assert _finisher_fields(port)["swleft"] == [-1] * 9 + [0, 0, 0, 0, -1, -1, -1]
    assert _finisher_fields(port)["proven"] == ([False] * 6 + [True, True, False]
                                                + [True] * 4 + [False, True, True])
    _same_final(ref, port, ("replica_broker",))


@pytest.mark.slow
def test_default_full_slice_matches_reference(tmp_path):
    """The sixteen goals at their real size (1,000 brokers, padded R =
    114,688): the fused prefix of nine goals, then seven goals chunked with
    the finisher."""
    ref, port = _run_chain(tmp_path, FULL, DEFAULT_GOALS)
    assert _counts(port) == ref["counts"]
    assert _swaps(port) == ref["swaps"]
    assert _counts(port)["actions"] == [3051, 0, 0, 0, 0, 0, 557, 18136, 0, 1247, 1082,
                                        1248, 1585, 617, 808, 1125]
    assert (_counts(port)["moves"], _counts(port)["leads"]) == (22642, 12778)
    assert _finisher_fields(port) == ref["finisher"]
    _same_final(ref, port, ("replica_broker",))


# --- the Java parity matrix's 18-goal chain and the kafka-assigner mode -------


@pytest.mark.slow
def test_full_chain_fixture16_bit_exact(tmp_path):
    """The 18 goals on fixture16 (``slow``: the reference compiles 18 goal
    programs, about 60 s): RackAwareDistributionGoal behind RackAwareGoal
    (its limit-1 veto in every later goal's K2 and K7 calls), then PLE:
    counts, swap actions, assignment and proposals bit for bit."""
    ref, port = _run_chain(tmp_path, None, FULL_CHAIN)
    assert _counts(port) == ref["counts"]
    assert _counts(port)["actions"] == [0] * 8 + [81, 0, 1, 0, 11, 0, 0, 0, 0, 1]
    assert _swaps(port) == ref["swaps"]
    _same_final(ref, port, ("replica_broker", "replica_is_leader", "replica_disk"))
    assert _proposals(port) == ref["proposals"]
    assert port.balancedness_after == ref["balancedness_after"]


@pytest.mark.slow
def test_full_chain_full_slice_matches_reference(tmp_path):
    """DeterministicClusterTest's 18 goals at the real size (1,000 brokers,
    20 racks: every rack limit 1): the fused prefix of ten goals, then
    seven chunked goals with the finisher, then the preferred-leader pass."""
    ref, port = _run_chain(tmp_path, FULL, FULL_CHAIN)
    assert _counts(port) == ref["counts"]
    assert _swaps(port) == ref["swaps"]
    assert _counts(port)["actions"] == [3051, 0, 0, 0, 0, 0, 0, 557, 18136, 0, 1247,
                                        1082, 1248, 1585, 772, 1111, 581, 1]
    assert (_counts(port)["moves"], _counts(port)["leads"]) == (22641, 10764)
    assert _finisher_fields(port) == ref["finisher"]
    _same_final(ref, port, ("replica_broker", "replica_is_leader"))
    assert _proposals(port) == ref["proposals"]


@pytest.mark.slow
def test_kafka_assigner_full_slice_matches_reference(tmp_path):
    """The kafka-assigner mode at the real size: the even rack goal in the
    fused prefix, then the swap-only disk goal chunked (194 passes)."""
    ref, port = _run_chain(tmp_path, FULL, KAFKA_ASSIGNER)
    assert _counts(port) == ref["counts"]
    assert _swaps(port) == ref["swaps"] == [0, 833]
    assert _counts(port)["passes"] == [7, 194]
    assert _finisher_fields(port) == ref["finisher"]
    _same_final(ref, port, ("replica_broker", "replica_is_leader"))
    assert _proposals(port) == ref["proposals"]


# --- the JBOD self-healing path ---------------------------------------------
INTRA = ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
JBOD_CHAIN = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
              "DiskCapacityGoal", "NetworkInboundCapacityGoal",
              "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
              "ReplicaDistributionGoal"] + INTRA
_JBOD = dict(num_racks=4, num_topics=8, max_replication=3, skew=1.0, seed=3143,
             logdirs_per_broker=4, target_cpu_util=0.45, num_dead_brokers=1,
             num_brokers_with_dead_disk=2)
JBOD = {"jbod-32b": dict(_JBOD, num_brokers=32, num_partitions=1000),
        "jbod-64b": dict(_JBOD, num_brokers=64, num_partitions=8000)}
JBOD_FULL = dict(num_brokers=1000, num_racks=20, num_topics=200, num_partitions=50000,
                 max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
                 target_cpu_util=0.45, num_dead_brokers=3,
                 num_brokers_with_dead_disk=7)
# the JAX reference's rows, held live against the reference below
JBOD_ROWS = {
    ("jbod-32b", "intra"): dict(actions=[13, 93], passes=[4, 9]),
    ("jbod-32b", "chain"): dict(actions=[78, 0, 0, 0, 0, 0, 5, 95, 0, 65],
                                passes=[6, 3, 3, 3, 3, 3, 4, 8, 3, 7]),
    ("jbod-64b", "intra"): dict(actions=[71, 137], passes=[4, 5]),
    ("jbod-64b", "chain"): dict(actions=[581, 0, 0, 0, 0, 0, 6, 794, 0, 86],
                                passes=[9, 3, 3, 3, 3, 3, 4, 19, 3, 5]),
}


def _jbod_run(tmp_path, spec, goals, demoted=None):
    """The reference's outcome (fresh interpreter) and the port's run on the
    same JBOD cluster (the port's own generator, demoted brokers set as
    ``/demote_broker`` sets them)."""
    ref = reference_chain(tmp_path, spec, goals, demoted=demoted)
    ct, meta = port_rc.generate_scale(port_rc.RandomClusterSpec(**spec))
    if demoted:
        dem = np.zeros(ct.num_brokers, bool)
        dem[demoted] = True
        ct = dataclasses.replace(ct, broker_demoted=dem)
    port = GoalOptimizer(device="cpu").optimizations(
        ct, meta, **{**KW, "goal_names": goals})
    return ref, port


def _disk(res):
    return [g.disk_actions for g in res.goal_results]


@pytest.mark.parametrize("chain", ["intra", "chain"])
@pytest.mark.parametrize("size", sorted(JBOD))
def test_jbod_matches_reference(tmp_path, size, chain):
    goals = INTRA if chain == "intra" else JBOD_CHAIN
    ref, port = _jbod_run(tmp_path, JBOD[size], goals)
    assert _counts(port) == ref["counts"]
    assert _disk(port) == ref["disk"]
    row = JBOD_ROWS[(size, chain)]
    assert _counts(port)["actions"] == row["actions"]
    assert _counts(port)["passes"] == row["passes"]
    assert _counts(port)["before"] == [g for g in goals
                                       if g != "MinTopicLeadersPerBrokerGoal"]
    assert _counts(port)["after"] == []
    assert _disk(port)[-1] == row["actions"][-1] > 0
    _same_final(ref, port, ("replica_broker", "replica_is_leader", "replica_disk"))
    for name in ("util", "disk_util"):      # the incremental tallies, bit for bit
        assert np.array_equal(ref["final"][name].view(np.int32),
                              getattr(port.final_state, name).numpy().view(np.int32)), name
    assert _proposals(port) == ref["proposals"]


@pytest.mark.slow
@pytest.mark.parametrize("request_kind", ["intra", "chain", "demote"])
def test_jbod_full_slice_matches_reference(tmp_path, request_kind):
    """The JBOD path at its real size (1,000 brokers x 4 logdirs, 101,862
    replicas, 492 offline, padded R 114,688: the fused shape): the three
    requests of the slice."""
    goals = {"intra": INTRA, "chain": JBOD_CHAIN,
             "demote": ["PreferredLeaderElectionGoal"]}[request_kind]
    demoted = [11, 222, 444, 666, 888] if request_kind == "demote" else None
    ref, port = _jbod_run(tmp_path, JBOD_FULL, goals, demoted)
    assert _counts(port) == ref["counts"]
    assert _disk(port) == ref["disk"]
    assert _counts(port)["after"] == []
    want = {"intra": ([165, 2713], 0, 0, 2313),
            "chain": ([3799, 0, 0, 0, 0, 0, 105, 12173, 0, 3068], 13717, 5113, 14319),
            "demote": ([1], 0, 173, None)}[request_kind]
    assert _counts(port)["actions"] == want[0]
    assert (_counts(port)["moves"], _counts(port)["leads"]) == want[1:3]
    if want[3] is not None:
        assert len(port.proposals) == want[3]
    _same_final(ref, port, ("replica_broker", "replica_is_leader", "replica_disk"))
    for name in ("util", "disk_util"):
        assert np.array_equal(ref["final"][name].view(np.int32),
                              getattr(port.final_state, name).numpy().view(np.int32)), name
