"""Deterministic cluster fixtures for optimizer tests (counterpart of
``cruise_control_tpu/model/fixtures.py``, the same topologies, loads and
insertion order, built with the port's builder).

Analogue of the reference's test fixture factory
(cruise-control/src/test/java/com/linkedin/kafka/cruisecontrol/common/
DeterministicCluster.java:32): small hand-built topologies with known
imbalance used by DeterministicClusterTest and the BASELINE config-1 run.
Topology shapes mirror the reference's (RACK_BY_BROKER = {0:0, 1:0, 2:1},
two-broker 'unbalanced' clusters with linearly-varying partition loads,
homogeneous capacity TYPICAL_CPU=100 / LARGE=300000 / MEDIUM=200000); the
builder API and load rows are our own.
"""
from __future__ import annotations

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder

# Reference TestConstants.java values (shape parity for fixtures)
TYPICAL_CPU_CAPACITY = 100.0
LARGE_BROKER_CAPACITY = 300_000.0
MEDIUM_BROKER_CAPACITY = 200_000.0

BROKER_CAPACITY = {
    Resource.CPU: TYPICAL_CPU_CAPACITY,
    Resource.DISK: LARGE_BROKER_CAPACITY,
    Resource.NW_IN: LARGE_BROKER_CAPACITY,
    Resource.NW_OUT: MEDIUM_BROKER_CAPACITY,
}

# rack layouts (DeterministicCluster.RACK_BY_BROKER{,2,3})
RACK_BY_BROKER = {0: "0", 1: "0", 2: "1"}
RACK_BY_BROKER2 = {0: "0", 1: "1", 2: "1"}
RACK_BY_BROKER3 = {0: "0", 1: "1", 2: "1", 3: "1"}


def _homogeneous(rack_by_broker: dict, capacity=None, logdirs=None) -> ClusterModelBuilder:
    b = ClusterModelBuilder()
    for broker_id, rack in rack_by_broker.items():
        b.add_broker(broker_id, rack, capacity=capacity or BROKER_CAPACITY, logdirs=logdirs)
    return b


def small_cluster():
    """3 brokers / 2 racks, 2 topics x 2 partitions, RF=2, modest imbalance.

    Role of DeterministicCluster.smallClusterModel: a well-formed baseline
    topology for goal unit tests.
    """
    b = _homogeneous(RACK_BY_BROKER)
    # loads: [cpu%, nw_in, nw_out, disk]
    loads = {
        ("A", 0): [10.0, 1000.0, 2000.0, 30000.0],
        ("A", 1): [8.0, 800.0, 1500.0, 25000.0],
        ("B", 0): [6.0, 600.0, 1200.0, 20000.0],
        ("B", 1): [4.0, 400.0, 800.0, 15000.0],
    }
    assignment = {
        ("A", 0): [0, 1],
        ("A", 1): [0, 2],
        ("B", 0): [0, 1],
        ("B", 1): [0, 2],
    }
    for (t, p), brokers in assignment.items():
        for i, broker in enumerate(brokers):
            b.add_replica(t, p, broker, is_leader=(i == 0), load=loads[(t, p)])
    return b.build()


def unbalanced_two_brokers(num_partitions: int = 8, topics=("T1",)):
    """2 brokers / 2 racks / 2 logdirs each; all RF=1 replicas crowd broker 0
    (partitions > 3 land on broker 1).

    Role of DeterministicCluster.unbalanced4/5 (createUnbalanced,
    DeterministicCluster.java:80-106): linearly varying loads
    cap/5 + cap/50 * (i/2 - 1.5).
    """
    rack_by_broker = {0: "0", 1: "1"}
    b = _homogeneous(rack_by_broker, logdirs=["/mnt/i00", "/mnt/i01"])
    for topic in topics:
        for i in range(num_partitions):
            broker = 1 if i > 3 else 0
            logdir = "/mnt/i00" if i % 4 < 2 else "/mnt/i01"
            f = i / 2.0 - 1.5
            load = [TYPICAL_CPU_CAPACITY / 5 + TYPICAL_CPU_CAPACITY / 50 * f,
                    LARGE_BROKER_CAPACITY / 5 + LARGE_BROKER_CAPACITY / 50 * f,
                    MEDIUM_BROKER_CAPACITY / 5 + MEDIUM_BROKER_CAPACITY / 50 * f,
                    LARGE_BROKER_CAPACITY / 5 + LARGE_BROKER_CAPACITY / 50 * f]
            b.add_replica(topic, i, broker, is_leader=True, load=load, logdir=logdir)
    return b.build()


def leaders_skewed():
    """2 topics x 1 partition, RF=2; both leaders on broker 0, broker 2 empty
    (role of DeterministicCluster.unbalanced3: leadership imbalance)."""
    b = _homogeneous(RACK_BY_BROKER)
    load = [TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
            MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]
    for t in ("T1", "T2"):
        b.add_replica(t, 0, broker_id=0, is_leader=True, load=load)
        b.add_replica(t, 0, broker_id=1, is_leader=False, load=load)
    return b.build()


def rack_violated():
    """RF=2 partitions with both replicas in rack '0' (brokers 0,1) while
    rack '1' (broker 2) is free — RackAwareGoal must move one replica of each.
    """
    b = _homogeneous(RACK_BY_BROKER)
    load = [5.0, 500.0, 1000.0, 10_000.0]
    for p in range(2):
        b.add_replica("T1", p, broker_id=0, is_leader=True, load=load)
        b.add_replica("T1", p, broker_id=1, is_leader=False, load=load)
    return b.build()


def dead_broker_cluster():
    """small_cluster with broker 1 dead: its replicas are offline and must be
    relocated by self-healing (RandomSelfHealingTest role)."""
    b = _homogeneous(RACK_BY_BROKER)
    loads = {
        ("A", 0): [10.0, 1000.0, 2000.0, 30000.0],
        ("A", 1): [8.0, 800.0, 1500.0, 25000.0],
        ("B", 0): [6.0, 600.0, 1200.0, 20000.0],
        ("B", 1): [4.0, 400.0, 800.0, 15000.0],
    }
    assignment = {
        ("A", 0): [0, 1],
        ("A", 1): [0, 2],
        ("B", 0): [0, 1],
        ("B", 1): [0, 2],
    }
    for (t, p), brokers in assignment.items():
        for i, broker in enumerate(brokers):
            b.add_replica(t, p, broker, is_leader=(i == 0), load=loads[(t, p)])
    ct, meta = b.build()
    ct = ct.set_broker_alive(meta.broker_index(1), False)
    return ct, meta


def capacity_violated():
    """Broker 0 pushed over the DISK capacity threshold (0.8 x cap) while
    brokers 1-2 are near-empty; CapacityGoal must shed load."""
    b = _homogeneous(RACK_BY_BROKER)
    # 6 RF=1 partitions of 45,000 MB each on broker 0 => 270,000 > 0.8*300,000
    for p in range(6):
        b.add_replica("T1", p, broker_id=0, is_leader=True,
                      load=[2.0, 100.0, 200.0, 45_000.0])
    b.add_replica("T2", 0, broker_id=1, is_leader=True, load=[1.0, 50.0, 100.0, 5_000.0])
    b.add_replica("T2", 1, broker_id=2, is_leader=True, load=[1.0, 50.0, 100.0, 5_000.0])
    return b.build()


def unbalanced():
    """DeterministicCluster.unbalanced (:206-229): 2 racks / 3 brokers, T1-0
    and T2-0 (RF=1) both led from broker 0 at half-capacity loads — brokers 1
    and 2 idle."""
    b = _homogeneous(RACK_BY_BROKER)
    load = [TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
            MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]
    b.add_replica("T1", 0, broker_id=0, is_leader=True, load=load)
    b.add_replica("T2", 0, broker_id=0, is_leader=True, load=load)
    return b.build()


def unbalanced2():
    """DeterministicCluster.unbalanced2 (:157-183): unbalanced() + four more
    RF=1 partitions, three of them also crowding broker 0 (replica counts
    5/1/0)."""
    b = _homogeneous(RACK_BY_BROKER)
    load = [TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
            MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]
    for t, p, broker in (("T1", 0, 0), ("T2", 0, 0), ("T1", 1, 1),
                         ("T2", 1, 0), ("T1", 2, 0), ("T2", 2, 0)):
        b.add_replica(t, p, broker_id=broker, is_leader=True, load=load)
    return b.build()


def unbalanced_with_a_follower():
    """DeterministicCluster.unbalancedWithAFollower (:186-199): unbalanced()
    plus a follower of T1-0 on broker 2."""
    b = _homogeneous(RACK_BY_BROKER)
    load = [TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
            MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]
    foll = [TYPICAL_CPU_CAPACITY / 8, LARGE_BROKER_CAPACITY / 2, 0.0,
            LARGE_BROKER_CAPACITY / 2]
    b.add_replica("T1", 0, broker_id=0, is_leader=True, load=load)
    b.add_replica("T2", 0, broker_id=0, is_leader=True, load=load)
    b.add_replica("T1", 0, broker_id=2, is_leader=False,
                  leader_load=foll, follower_load=foll)
    return b.build()


def preferred_leader_skewed():
    """DeterministicCluster.unbalanced3 (:128-150): RF=2, the position-0
    (preferred) replica of each partition sits on broker 1 but leadership is
    held by the position-1 replica on broker 0 — PreferredLeaderElectionGoal
    must move leadership to broker 1."""
    b = _homogeneous(RACK_BY_BROKER)
    load = [TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
            MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]
    for t in ("T1", "T2"):
        # insertion order defines replica-list position: broker 1 first
        b.add_replica(t, 0, broker_id=1, is_leader=False, load=load)
        b.add_replica(t, 0, broker_id=0, is_leader=True, load=load)
    return b.build()


def rack_aware_satisfiable():
    """DeterministicCluster.rackAwareSatisfiable (:235-258): one RF=2
    partition on brokers 0 and 1 — both in rack '0', while broker 2 (rack
    '1') is free, so RackAwareGoal is satisfiable by one move."""
    b = _homogeneous(RACK_BY_BROKER)
    b.add_replica("T1", 0, broker_id=0, is_leader=True,
                  load=[40.0, 100.0, 130.0, 75.0])
    b.add_replica("T1", 0, broker_id=1, is_leader=False,
                  load=[5.0, 100.0, 0.0, 75.0])
    return b.build()


def rack_aware_unsatisfiable():
    """DeterministicCluster.rackAwareUnsatisfiable (:291-301):
    rack_aware_satisfiable + a third replica on broker 2 — RF=3 > 2 racks, so
    RackAwareGoal must fail (OptimizationFailureException parity)."""
    b = _homogeneous(RACK_BY_BROKER)
    b.add_replica("T1", 0, broker_id=0, is_leader=True,
                  load=[40.0, 100.0, 130.0, 75.0])
    b.add_replica("T1", 0, broker_id=1, is_leader=False,
                  load=[5.0, 100.0, 0.0, 75.0])
    b.add_replica("T1", 0, broker_id=2, is_leader=False,
                  load=[60.0, 100.0, 130.0, 75.0])
    return b.build()


def jbod_cluster():
    """2 brokers x 2 logdirs with one crowded disk (intra-broker goal target)."""
    rack_by_broker = {0: "0", 1: "1"}
    b = _homogeneous(rack_by_broker, logdirs=["/mnt/i00", "/mnt/i01"])
    for p in range(6):
        b.add_replica("T1", p, broker_id=0, is_leader=True,
                      load=[2.0, 100.0, 200.0, 30_000.0], logdir="/mnt/i00")
    b.add_replica("T2", 0, broker_id=1, is_leader=True,
                  load=[1.0, 50.0, 100.0, 5_000.0], logdir="/mnt/i01")
    return b.build()


# ---------------------------------------------------------------------------
# Exact-Java parity fixtures (loads transcribed verbatim from
# DeterministicCluster.java; used by tests/test_java_parity_matrix.py to
# replay DeterministicClusterTest.java's parameter matrix)
# ---------------------------------------------------------------------------
TOPIC_MIN_LEADER = "must_have_leader_replica_on_broker_topic"


def _add_rf2(b, topic, part, leader_broker, follower_broker, leader_row,
             follower_row):
    """One RF=2 partition with explicit leader-role / follower-role load rows
    (each replica carries both: what it bears now and what it would bear
    after a leadership transfer — ClusterModel.setReplicaLoad +
    ModelUtils attribution collapsed into two rows)."""
    b.add_replica(topic, part, leader_broker, is_leader=True,
                  leader_load=np.asarray(leader_row, float),
                  follower_load=np.asarray(follower_row, float))
    b.add_replica(topic, part, follower_broker, is_leader=False,
                  leader_load=np.asarray(leader_row, float),
                  follower_load=np.asarray(follower_row, float))


def small_cluster_java(capacity: dict | None = None):
    """DeterministicCluster.smallClusterModel (:712-768) verbatim: 3 brokers
    / 2 racks (RACK_BY_BROKER), T1 x2 + T2 x3 partitions, RF=2, loads
    (cpu, nw_in, nw_out, disk) exactly as setReplicaLoad lines."""
    b = _homogeneous(RACK_BY_BROKER, capacity=capacity)
    _add_rf2(b, "T1", 0, 0, 2, [20.0, 100.0, 130.0, 75.0], [5.0, 100.0, 0.0, 75.0])
    _add_rf2(b, "T1", 1, 1, 0, [15.0, 90.0, 110.0, 55.0], [4.5, 90.0, 0.0, 55.0])
    _add_rf2(b, "T2", 0, 1, 2, [5.0, 5.0, 6.0, 5.0], [4.0, 5.0, 0.0, 5.0])
    _add_rf2(b, "T2", 1, 0, 2, [25.0, 25.0, 45.0, 55.0], [10.5, 25.0, 0.0, 55.0])
    _add_rf2(b, "T2", 2, 0, 1, [20.0, 45.0, 120.0, 95.0], [8.0, 45.0, 0.0, 95.0])
    return b.build()


def medium_cluster_java(capacity: dict | None = None):
    """DeterministicCluster.mediumClusterModel (:833-893) verbatim: topics
    A(x3)/B/C/D, RF=2 each, 3 brokers / 2 racks."""
    b = _homogeneous(RACK_BY_BROKER, capacity=capacity)
    _add_rf2(b, "A", 0, 1, 0, [5.0, 4.0, 10.0, 10.0], [5.0, 5.0, 0.0, 4.0])
    _add_rf2(b, "A", 1, 0, 2, [5.0, 3.0, 10.0, 8.0], [3.0, 4.0, 0.0, 6.0])
    _add_rf2(b, "A", 2, 0, 2, [5.0, 2.0, 10.0, 6.0], [4.0, 5.0, 0.0, 3.0])
    _add_rf2(b, "B", 0, 1, 2, [5.0, 4.0, 10.0, 7.0], [2.0, 2.0, 0.0, 5.0])
    _add_rf2(b, "C", 0, 2, 1, [1.0, 8.0, 10.0, 4.0], [5.0, 6.0, 0.0, 4.0])
    _add_rf2(b, "D", 0, 1, 2, [5.0, 5.0, 10.0, 6.0], [2.0, 8.0, 0.0, 7.0])
    return b.build()


_HALF_LOAD = [TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
              MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]
_HALF_FOLLOWER = [TYPICAL_CPU_CAPACITY / 4, LARGE_BROKER_CAPACITY / 2, 0.0,
                  LARGE_BROKER_CAPACITY / 2]


def _min_leader_cluster(assignment, rack_by_broker=None, load_scale=0.01):
    """Builder for the minLeaderReplicaPerBroker* fixtures: ``assignment``
    maps partition -> (leader_broker, [follower_brokers...]); loads are a
    small uniform row (the goal only counts leaders)."""
    b = _homogeneous(rack_by_broker or RACK_BY_BROKER2)
    row = [x * load_scale for x in _HALF_LOAD]
    frow = [x * load_scale for x in _HALF_FOLLOWER]
    for (topic, part), (leader, followers) in assignment.items():
        b.add_replica(topic, part, leader, is_leader=True,
                      leader_load=np.asarray(row, float),
                      follower_load=np.asarray(frow, float))
        for f in followers:
            b.add_replica(topic, part, f, is_leader=False,
                          leader_load=np.asarray(row, float),
                          follower_load=np.asarray(frow, float))
    return b.build()


def min_leader_satisfiable():
    """minLeaderReplicaPerBrokerSatisfiable (:349): B0 {P0L, P1L},
    B1 {P2L, P0F}, B2 {P2F, P1F} — B2 needs a leadership transfer."""
    T = TOPIC_MIN_LEADER
    return _min_leader_cluster({(T, 0): (0, [1]), (T, 1): (0, [2]),
                                (T, 2): (1, [2])})


def min_leader_satisfiable2():
    """minLeaderReplicaPerBrokerSatisfiable2 (:400): all three leaders on
    B0; followers P1F->B1, P0F/P2F->B2."""
    T = TOPIC_MIN_LEADER
    return _min_leader_cluster({(T, 0): (0, [2]), (T, 1): (0, [1]),
                                (T, 2): (0, [2])})


def min_leader_satisfiable3():
    """minLeaderReplicaPerBrokerSatisfiable3 (:522): 4 brokers
    (RACK_BY_BROKER3), 16 partitions, leader+follower pairs co-located
    (B1: P0-3, B2: P4-9, B3: P10-15), min 4 leaders per broker -> B0 needs
    4 leader replicas moved in."""
    T = TOPIC_MIN_LEADER
    assignment = {}
    for i in range(16):
        broker = 1 if i < 4 else (2 if i < 10 else 3)
        assignment[(T, i)] = (broker, [broker])
    return _min_leader_cluster(assignment, rack_by_broker=RACK_BY_BROKER3)


def min_leader_satisfiable4():
    """minLeaderReplicaPerBrokerSatisfiable4 (:453): topics topic0/topic1
    (x3 partitions each), all leaders on B0, all followers on B1, B2 empty;
    min 1 leader of EACH topic per broker."""
    assignment = {}
    for t in ("topic0", "topic1"):
        for i in range(3):
            assignment[(t, i)] = (0, [1])
    return _min_leader_cluster(assignment)


def min_leader_unsatisfiable():
    """leaderReplicaPerBrokerUnsatisfiable (:589): 2 partitions / 3 brokers
    each requiring a leader -> impossible."""
    T = TOPIC_MIN_LEADER
    return _min_leader_cluster({(T, 0): (0, [2]), (T, 1): (0, [1])})


def synthetic_cluster(num_brokers: int, num_replicas: int,
                      num_partitions: int | None = None,
                      num_topics: int = 8, num_racks: int = 4,
                      logdirs_per_broker: int = 1,
                      max_replication: int | None = None):
    """Shape-accurate throwaway cluster for GoalOptimizer.warmup: the engine
    programs are compiled per PADDED shape bucket, so a synthetic cluster
    with the same broker/replica/partition/topic counts (plus rack count,
    logdir width and max RF — the remaining static axes) compiles exactly
    the programs a real cluster of that shape will execute. Built fully
    vectorized: warmup must not reintroduce the host-side build cost it
    exists to hide.

    Loads are smooth and non-degenerate (every resource non-zero) so the
    compiled programs are the generic ones, but warmup runs them under
    near-zero traced budgets — the values never matter."""
    num_partitions = num_partitions or max(1, num_replicas // 2)
    P = min(num_partitions, num_replicas)
    R = max(num_replicas, P)
    B = max(num_brokers, 1)
    F = min(max_replication or -(-R // P), B)
    if R > P * F:
        raise ValueError(f"{R} replicas do not fit {P} partitions at RF<={F}")
    b = ClusterModelBuilder()
    for i in range(B):
        b.add_broker(i, rack=f"rack{i % max(num_racks, 1)}",
                     logdirs=[f"/d{j}" for j in range(max(logdirs_per_broker, 1))])
    nrep = np.full(P, R // P, np.int64)
    nrep[:R % P] += 1
    # guarantee the max-RF static axis: bump the first partition to F by
    # stealing surplus replicas from the tail
    need = int(F - nrep[0])
    if need > 0:
        donors = np.flatnonzero(nrep[1:] > 1)[::-1][:need] + 1
        if donors.size < need:
            need = int(donors.size)
        nrep[donors[:need]] -= 1
        nrep[0] += need
    rep_ptr = np.zeros(P + 1, np.int64)
    np.cumsum(nrep, out=rep_ptr[1:])
    rep_part = np.repeat(np.arange(P, dtype=np.int64), nrep)
    rank = np.arange(R, dtype=np.int64) - rep_ptr[rep_part]
    rep_bidx = ((rep_part + rank) % B).astype(np.int64)
    rep_disk = ((rep_part + rank) % max(logdirs_per_broker, 1)).astype(np.int64)
    rep_leader = rank == 0
    M = len(Resource)
    leader_load = np.zeros((R, M), np.float32)
    leader_load[:, Resource.CPU] = 0.5 + (rep_part % 7) * 0.1
    leader_load[:, Resource.NW_IN] = 5.0 + (rep_part % 11)
    leader_load[:, Resource.NW_OUT] = 10.0 + (rep_part % 13)
    leader_load[:, Resource.DISK] = 50.0 + (rep_part % 17) * 10.0
    follower_load = leader_load.copy()
    follower_load[:, Resource.CPU] *= 0.5
    follower_load[:, Resource.NW_OUT] = 0.0
    T = max(num_topics, 1)
    topics = [f"warmup{t}" for t in range(T)]
    partitions = [(topics[p % T], p) for p in range(P)]
    partition_topic = np.arange(P, dtype=np.int64) % T
    # topic names sort lexicographically only up to 10 topics; recompute
    # indices against the sorted list the builder will use
    order = sorted(range(T), key=topics.__getitem__)
    remap = np.empty(T, np.int64)
    remap[order] = np.arange(T)
    return b.build_from_arrays(
        topics=sorted(topics), partitions=partitions,
        replica_partition=rep_part, replica_broker=rep_bidx,
        replica_disk=rep_disk, replica_is_leader=rep_leader,
        replica_offline=np.zeros(R, bool),
        leader_load=leader_load, follower_load=follower_load,
        partition_topic=remap[partition_topic])
