"""(Counterpart of ``cruise_control_tpu/backend/interface.py``, copied with the
port's imports.) ClusterBackend: the pluggable boundary to the managed cluster.

The reference talks to a real Kafka deployment through three transports
(SURVEY §2.10): the Kafka wire protocol (metrics consumer, sample-store
producer, AdminClient), ZooKeeper (reassignment znodes Executor.java:1272,
broker liveness watches BrokerFailureDetector.java:84, throttle configs
ReplicationThrottleHelper.java:36-42) and HTTP. This interface abstracts all
actuation + metadata behind one SPI so the framework runs identically against
the simulated backend (tests/dev — the embedded-Kafka role of
CCKafkaIntegrationTestHarness) or a thin adapter to a real cluster.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np


@dataclasses.dataclass
class BrokerNode:
    broker_id: int
    rack: str
    alive: bool = True
    logdirs: dict = dataclasses.field(default_factory=dict)   # logdir -> capacity MB
    dead_logdirs: set = dataclasses.field(default_factory=set)
    cpu_capacity: float = 100.0
    nw_in_capacity: float = 50_000.0
    nw_out_capacity: float = 50_000.0


@dataclasses.dataclass
class PartitionInfo:
    topic: str
    partition: int
    replicas: list                      # broker ids, preferred leader first
    leader: int                         # broker id, -1 = none
    logdir_by_broker: dict = dataclasses.field(default_factory=dict)
    size_mb: float = 0.0
    bytes_in_rate: float = 0.0          # KB/s produced to the leader
    bytes_out_rate: float = 0.0         # KB/s consumed from the leader
    cpu_util: float = 0.0               # leader CPU percent
    isr: list | None = None             # in-sync replica ids; None = derive
    #                                     from replicas on alive brokers


@dataclasses.dataclass
class ClusterSnapshot:
    """Columnar cluster metadata: the dense-array twin of ``partitions()``.

    At 500k partitions the dict-of-PartitionInfo snapshot costs tens of
    seconds of host time to build AND to consume (per-replica Python loops in
    the model build); this carries the same information as flat numpy arrays
    so the monitor can assemble a ClusterTensor with array joins.

    Layout contracts (the model build and the dict path must stay
    bit-identical):
    - ``partition_keys`` is SORTED by (topic, partition); all per-partition
      arrays and the CSR replica axis follow that order.
    - replicas keep their metadata order (preferred leader first).
    - ``rep_disk`` indexes each replica's logdir within its broker's
      ``broker_logdirs`` row, which mirrors ``BrokerNode.logdirs`` order
      (``["/logdir0"]`` when a broker reports none); replicas whose logdir is
      unknown/unresolvable map to index 0, matching the dict path's fallback.
    """
    generation: int
    topics: list                     # sorted topic names
    partition_keys: list             # sorted [(topic, partition)]
    partition_topic: np.ndarray      # i64[P] index into topics
    partition_leader: np.ndarray     # i64[P] leader broker id (-1 = none)
    rep_ptr: np.ndarray              # i64[P + 1] CSR offsets into the rep_* axes
    rep_bid: np.ndarray              # i64[Rv] broker id per replica
    rep_leader: np.ndarray           # bool[Rv] replica is the partition leader
    rep_disk: np.ndarray             # i64[Rv] logdir index on its broker
    broker_ids: np.ndarray           # i64[B] sorted broker ids
    broker_alive: np.ndarray         # bool[B]
    broker_rack: list                # [B] rack names
    broker_logdirs: list             # [B] per-broker logdir name lists

    @property
    def num_partitions(self) -> int:
        return len(self.partition_keys)

    @property
    def num_replicas(self) -> int:
        return int(self.rep_bid.shape[0])


def snapshot_from_metadata(brokers: dict, partitions: dict,
                           generation: int = -1) -> ClusterSnapshot:
    """Derive a ClusterSnapshot from the dict-shaped metadata — the default
    shim for backends that do not maintain columnar state natively (e.g. the
    RPC adapter). One tight pass over the partition dict instead of the
    model build's former per-replica generator sweeps."""
    tps = sorted(partitions)
    P = len(tps)
    broker_ids = np.asarray(sorted(brokers), dtype=np.int64)
    broker_alive = np.asarray([brokers[b].alive for b in broker_ids], bool) \
        if P or len(broker_ids) else np.zeros(0, bool)
    broker_rack = [brokers[b].rack for b in broker_ids]
    broker_logdirs = [list(brokers[b].logdirs) or ["/logdir0"]
                      for b in broker_ids]
    dix = {(int(b), ld): d for b, lds in zip(broker_ids, broker_logdirs)
           for d, ld in enumerate(lds)}
    topics: list = []
    tindex: dict = {}
    ptopic = np.empty(P, np.int64)
    pleader = np.empty(P, np.int64)
    nrep = np.empty(P, np.int64)
    rep_bid: list = []
    rep_leader: list = []
    rep_disk: list = []
    for i, tp in enumerate(tps):
        info = partitions[tp]
        t = tp[0]
        ti = tindex.get(t)
        if ti is None:
            ti = tindex[t] = len(topics)
            topics.append(t)
        ptopic[i] = ti
        pleader[i] = info.leader
        nrep[i] = len(info.replicas)
        ld_of = info.logdir_by_broker
        for b in info.replicas:
            rep_bid.append(b)
            rep_leader.append(b == info.leader)
            rep_disk.append(dix.get((b, ld_of.get(b)), 0))
    rep_ptr = np.zeros(P + 1, np.int64)
    np.cumsum(nrep, out=rep_ptr[1:])
    # topics were discovered in sorted-key order, so they are already sorted
    return ClusterSnapshot(
        generation=generation, topics=topics, partition_keys=tps,
        partition_topic=ptopic, partition_leader=pleader, rep_ptr=rep_ptr,
        rep_bid=np.asarray(rep_bid, np.int64),
        rep_leader=np.asarray(rep_leader, bool),
        rep_disk=np.asarray(rep_disk, np.int64),
        broker_ids=broker_ids, broker_alive=broker_alive,
        broker_rack=broker_rack, broker_logdirs=broker_logdirs)


class ClusterBackend(Protocol):
    """Everything the monitor/executor/detector layers need from the cluster."""

    # -- clock --
    # canonical accessor: every backend exposes now_ms() as a METHOD (the
    # simulated backend advances it via advance(); wire clients forward it)
    def now_ms(self) -> float: ...

    # -- metadata (MetadataClient role) --
    def brokers(self) -> dict: ...                       # id -> BrokerNode
    def partitions(self) -> dict: ...                    # (topic, part) -> PartitionInfo
    def snapshot(self) -> ClusterSnapshot: ...           # columnar metadata
    def metadata_generation(self) -> int: ...

    # -- metrics (metrics-reporter topic / Prometheus role) --
    def partition_metrics(self) -> dict: ...             # (t, p) -> {metric: value}
    def broker_metrics(self) -> dict: ...                # id -> {metric: value}

    # -- actuation (ZK znodes + AdminClient role) --
    def alter_partition_reassignments(self, assignments: dict) -> None: ...
    def ongoing_reassignments(self) -> dict: ...
    def cancel_reassignments(self, tps: list) -> None: ...
    def elect_leaders(self, tps_to_leader: dict) -> None: ...
    # declarative/idempotent: assigns each (topic, part, broker) replica to a
    # target log dir — re-submitting a move that already landed re-asserts
    # the same assignment (census adoption after failover relies on this)
    def alter_replica_logdirs(self, moves: dict) -> None: ...
    def describe_logdirs(self) -> dict: ...              # broker -> {logdir: alive}
    def set_replication_throttle(self, rate_bytes_per_sec: int | None) -> None: ...
    def replication_throttle(self) -> int | None: ...
    # per-topic config writes (alterConfigs role): the throttle helper sets
    # leader/follower.replication.throttled.replicas lists per topic and
    # deletes them (value None) after execution
    def set_topic_config(self, topic: str, key: str, value) -> None: ...
    def topic_configs(self) -> dict: ...

    # -- coordination (ZK ephemeral-node / lease role) --
    # atomic compare-and-swap lease: acquire grants when the key is free,
    # expired on the backend clock, or already held by ``holder`` (renewal);
    # the epoch is a fencing token that increments on every ownership change.
    # Returns {"key", "holder", "expiresMs", "epoch", "acquired": bool} —
    # on a refused acquire the CURRENT holder's row comes back.
    def lease_acquire(self, key: str, holder: str, ttl_ms: float) -> dict: ...
    def lease_release(self, key: str, holder: str) -> bool: ...
    def lease_get(self, key: str) -> dict | None: ...
