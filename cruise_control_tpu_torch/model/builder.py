"""Host-side cluster model assembly (counterpart of
``cruise_control_tpu/model/builder.py``).

A ``ClusterModelBuilder`` accumulates plain-Python topology + loads and
``build()`` emits the numeric ``ClusterTensor`` (numpy) plus the
name-mapping ``ClusterMeta``. Load convention: CPU in percent of one
broker's total, NW in KB/s, DISK in MB; followers carry no NW_OUT and half
the leader's CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.model.cluster_tensor import ClusterMeta, ClusterTensor


@dataclasses.dataclass
class _BrokerSpec:
    broker_id: int
    rack: str
    capacity: dict  # Resource -> float
    alive: bool = True
    new: bool = False
    demoted: bool = False
    logdirs: list = dataclasses.field(default_factory=lambda: ["/logdir0"])
    disk_capacity: list = dataclasses.field(default_factory=list)  # per logdir, MB
    dead_disks: set = dataclasses.field(default_factory=set)       # logdir names


@dataclasses.dataclass
class _ReplicaSpec:
    topic: str
    partition: int
    broker_id: int
    is_leader: bool
    leader_load: np.ndarray     # [M]
    follower_load: np.ndarray   # [M]
    logdir: str | None = None
    offline: bool = False


# follower CPU share of the leader's when the caller supplies one load row
FOLLOWER_CPU_FRACTION = 0.5


def split_leader_follower(load: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Derive (leader_load, follower_load) from one combined load row."""
    leader = np.asarray(load, dtype=np.float64).copy()
    follower = leader.copy()
    follower[Resource.NW_OUT] = 0.0
    follower[Resource.CPU] = leader[Resource.CPU] * FOLLOWER_CPU_FRACTION
    return leader, follower


class ClusterModelBuilder:
    def __init__(self):
        self._brokers: dict[int, _BrokerSpec] = {}
        self._replicas: list[_ReplicaSpec] = []
        self._excluded_topics: set[str] = set()
        self._excluded_brokers_for_move: set[int] = set()
        self._excluded_brokers_for_leadership: set[int] = set()

    # ---- topology ----
    def add_broker(self, broker_id: int, rack: str, capacity: dict | None = None,
                   alive: bool = True, new: bool = False, demoted: bool = False,
                   logdirs: list | None = None, disk_capacity: list | None = None,
                   dead_disks: set | None = None) -> "ClusterModelBuilder":
        if broker_id in self._brokers:
            raise ValueError(f"duplicate broker {broker_id}")
        cap = {Resource.CPU: 100.0, Resource.DISK: 500_000.0,
               Resource.NW_IN: 50_000.0, Resource.NW_OUT: 50_000.0}
        if capacity:
            cap.update(capacity)
        spec = _BrokerSpec(broker_id=broker_id, rack=str(rack), capacity=cap,
                           alive=alive, new=new, demoted=demoted,
                           logdirs=list(logdirs) if logdirs else ["/logdir0"],
                           disk_capacity=list(disk_capacity) if disk_capacity else [],
                           dead_disks=set(dead_disks or ()))
        if not spec.disk_capacity:
            per = cap[Resource.DISK] / len(spec.logdirs)
            spec.disk_capacity = [per] * len(spec.logdirs)
        self._brokers[broker_id] = spec
        return self

    def add_replica(self, topic: str, partition: int, broker_id: int, is_leader: bool,
                    load: np.ndarray | list | None = None,
                    leader_load: np.ndarray | list | None = None,
                    follower_load: np.ndarray | list | None = None,
                    logdir: str | None = None, offline: bool = False) -> "ClusterModelBuilder":
        """Add one replica: a combined ``load`` row [cpu, nw_in, nw_out, disk]
        (split by :func:`split_leader_follower`) or explicit rows."""
        if broker_id not in self._brokers:
            raise ValueError(f"unknown broker {broker_id}")
        if load is not None:
            lead, foll = split_leader_follower(np.asarray(load, dtype=np.float64))
        else:
            if leader_load is None or follower_load is None:
                raise ValueError("need either load= or leader_load= and follower_load=")
            lead = np.asarray(leader_load, dtype=np.float64)
            foll = np.asarray(follower_load, dtype=np.float64)
        self._replicas.append(_ReplicaSpec(topic=topic, partition=int(partition),
                                           broker_id=broker_id, is_leader=bool(is_leader),
                                           leader_load=lead, follower_load=foll,
                                           logdir=logdir, offline=offline))
        return self

    def exclude_topics(self, *topics: str) -> "ClusterModelBuilder":
        self._excluded_topics.update(topics)
        return self

    def exclude_brokers_for_replica_move(self, *broker_ids: int) -> "ClusterModelBuilder":
        self._excluded_brokers_for_move.update(broker_ids)
        return self

    def exclude_brokers_for_leadership(self, *broker_ids: int) -> "ClusterModelBuilder":
        self._excluded_brokers_for_leadership.update(broker_ids)
        return self

    # ---- assembly ----
    def broker_arrays(self, broker_ids: list, ridx: dict):
        """Public alias of :meth:`_broker_arrays`: the resident session's
        broker-axis refresh recomputes these dense arrays without a build."""
        return self._broker_arrays(broker_ids, ridx)

    def _broker_arrays(self, broker_ids: list, ridx: dict):
        """Dense broker topology arrays shared by both assembly paths."""
        B = len(broker_ids)
        D = max(len(s.logdirs) for s in self._brokers.values())
        M = NUM_RESOURCES
        specs = self._brokers
        broker_capacity = np.zeros((B, M), np.float32)
        broker_rack = np.zeros(B, np.int32)
        broker_alive = np.zeros(B, bool)
        broker_new = np.zeros(B, bool)
        broker_demoted = np.zeros(B, bool)
        broker_excl_move = np.zeros(B, bool)
        broker_excl_lead = np.zeros(B, bool)
        broker_disk_capacity = np.zeros((B, D), np.float32)
        broker_disk_alive = np.zeros((B, D), bool)
        logdirs_per_broker: list[list[str]] = []
        for i, b_id in enumerate(broker_ids):
            s = specs[b_id]
            for res in Resource:
                broker_capacity[i, res] = s.capacity[res]
            broker_rack[i] = ridx[s.rack]
            broker_alive[i] = s.alive
            broker_new[i] = s.new
            broker_demoted[i] = s.demoted
            broker_excl_move[i] = b_id in self._excluded_brokers_for_move
            broker_excl_lead[i] = b_id in self._excluded_brokers_for_leadership
            for d, ld in enumerate(s.logdirs):
                broker_disk_capacity[i, d] = s.disk_capacity[d]
                broker_disk_alive[i, d] = s.alive and (ld not in s.dead_disks)
            logdirs_per_broker.append(list(s.logdirs))
        return (broker_capacity, broker_rack, broker_alive, broker_new,
                broker_demoted, broker_excl_move, broker_excl_lead,
                broker_disk_capacity, broker_disk_alive, logdirs_per_broker)

    def build_from_arrays(self, topics: list, partitions: list,
                          replica_partition: np.ndarray,
                          replica_broker: np.ndarray,
                          replica_disk: np.ndarray,
                          replica_is_leader: np.ndarray,
                          replica_offline: np.ndarray,
                          leader_load: np.ndarray, follower_load: np.ndarray,
                          pad_replicas_to: int | None = None,
                          partition_topic: np.ndarray | None = None
                          ) -> tuple[ClusterTensor, ClusterMeta]:
        """Vectorized assembly: topology from prior ``add_broker`` calls,
        replicas from dense arrays. ``replica_partition`` indexes
        ``partitions``; ``replica_broker`` indexes the sorted broker ids;
        ``replica_disk`` indexes that broker's logdir list;
        ``partition_topic`` (optional) indexes the SORTED ``topics``."""
        if not self._brokers:
            raise ValueError("no brokers")
        broker_ids = sorted(self._brokers)
        racks = sorted({s.rack for s in self._brokers.values()})
        ridx = {r: i for i, r in enumerate(racks)}
        given_topics = list(topics)
        given_partition_topic = partition_topic
        topics = sorted(set(topics) | self._excluded_topics)
        tidx = {t: i for i, t in enumerate(topics)}

        (broker_capacity, broker_rack, broker_alive, broker_new,
         broker_demoted, broker_excl_move, broker_excl_lead,
         broker_disk_capacity, broker_disk_alive,
         logdirs_per_broker) = self._broker_arrays(broker_ids, ridx)

        R_valid = int(replica_partition.shape[0])
        R = pad_replicas_to or max(R_valid, 1)
        if R < R_valid:
            raise ValueError(f"pad_replicas_to={R} < {R_valid} replicas")
        P = max(len(partitions), 1)
        T = max(len(topics), 1)

        leaders_per_part = np.bincount(
            replica_partition[replica_is_leader.astype(bool)], minlength=P)
        if (leaders_per_part > 1).any():
            bad = int(np.argmax(leaders_per_part > 1))
            raise ValueError(f"two leaders for {partitions[bad]}")

        if (given_partition_topic is not None and partitions
                and topics == sorted(set(given_topics))):
            partition_topic = np.asarray(given_partition_topic, np.int32)
        elif partitions:
            partition_topic = np.fromiter(
                (tidx[t] for t, _ in partitions), dtype=np.int32,
                count=len(partitions))
        else:
            partition_topic = np.zeros(P, np.int32)
        topic_excluded = np.zeros(T, bool)
        for t in self._excluded_topics:
            topic_excluded[tidx[t]] = True

        def pad(a, dtype, fill=0):
            out = np.full((R,) + a.shape[1:], fill, dtype)
            out[:R_valid] = a
            return out

        replica_valid = np.zeros(R, bool)
        replica_valid[:R_valid] = True
        rb = pad(replica_broker.astype(np.int32), np.int32)
        ct = ClusterTensor(
            replica_broker=rb,
            replica_disk=pad(replica_disk.astype(np.int32), np.int32),
            replica_partition=pad(replica_partition.astype(np.int32), np.int32),
            replica_topic=pad(partition_topic[replica_partition].astype(np.int32),
                              np.int32),
            replica_is_leader=pad(replica_is_leader.astype(bool), bool),
            replica_valid=replica_valid,
            replica_offline=pad(replica_offline.astype(bool), bool),
            replica_original_broker=rb.copy(),
            leader_load=pad(leader_load.astype(np.float32), np.float32),
            follower_load=pad(follower_load.astype(np.float32), np.float32),
            broker_capacity=broker_capacity,
            broker_rack=broker_rack,
            broker_alive=broker_alive,
            broker_new=broker_new,
            broker_demoted=broker_demoted,
            broker_excluded_for_replica_move=broker_excl_move,
            broker_excluded_for_leadership=broker_excl_lead,
            broker_disk_capacity=broker_disk_capacity,
            broker_disk_alive=broker_disk_alive,
            topic_excluded=topic_excluded,
            partition_topic=partition_topic,
        )
        meta = ClusterMeta(topic_names=topics, partition_ids=list(partitions),
                           broker_ids=broker_ids, rack_ids=racks,
                           logdirs=logdirs_per_broker, num_racks=len(racks),
                           num_valid_replicas=R_valid)
        return ct, meta

    def build(self, pad_replicas_to: int | None = None) -> tuple[ClusterTensor, ClusterMeta]:
        if not self._brokers:
            raise ValueError("no brokers")
        broker_ids = sorted(self._brokers)
        bidx = {b: i for i, b in enumerate(broker_ids)}
        racks = sorted({s.rack for s in self._brokers.values()})
        ridx = {r: i for i, r in enumerate(racks)}
        topics = sorted({r.topic for r in self._replicas} | self._excluded_topics)
        tidx = {t: i for i, t in enumerate(topics)}
        partitions = sorted({(r.topic, r.partition) for r in self._replicas})
        pidx = {tp: i for i, tp in enumerate(partitions)}

        R_valid = len(self._replicas)
        R = pad_replicas_to or max(R_valid, 1)
        if R < R_valid:
            raise ValueError(f"pad_replicas_to={R} < {R_valid} replicas")
        T = max(len(topics), 1)
        P = max(len(partitions), 1)
        M = NUM_RESOURCES

        specs = self._brokers
        (broker_capacity, broker_rack, broker_alive, broker_new,
         broker_demoted, broker_excl_move, broker_excl_lead,
         broker_disk_capacity, broker_disk_alive,
         logdirs_per_broker) = self._broker_arrays(broker_ids, ridx)

        replica_broker = np.zeros(R, np.int32)
        replica_disk = np.zeros(R, np.int32)
        replica_partition = np.zeros(R, np.int32)
        replica_topic = np.zeros(R, np.int32)
        replica_is_leader = np.zeros(R, bool)
        replica_valid = np.zeros(R, bool)
        replica_offline = np.zeros(R, bool)
        leader_load = np.zeros((R, M), np.float32)
        follower_load = np.zeros((R, M), np.float32)

        if R_valid:
            reps = self._replicas
            dix = {(b, ld): d for b, s in specs.items()
                   for d, ld in enumerate(s.logdirs)}
            replica_broker[:R_valid] = np.fromiter(
                (bidx[r.broker_id] for r in reps), np.int32, R_valid)
            try:
                replica_disk[:R_valid] = np.fromiter(
                    (0 if r.logdir is None else dix[(r.broker_id, r.logdir)]
                     for r in reps), np.int32, R_valid)
            except KeyError as e:
                raise ValueError(f"unknown logdir for replica: {e}") from None
            replica_partition[:R_valid] = np.fromiter(
                (pidx[(r.topic, r.partition)] for r in reps), np.int32,
                R_valid)
            replica_topic[:R_valid] = np.fromiter(
                (tidx[r.topic] for r in reps), np.int32, R_valid)
            replica_is_leader[:R_valid] = np.fromiter(
                (r.is_leader for r in reps), bool, R_valid)
            replica_valid[:R_valid] = True
            leaders_per_part = np.bincount(
                replica_partition[:R_valid][replica_is_leader[:R_valid]],
                minlength=P)
            if (leaders_per_part > 1).any():
                bad = partitions[int(np.argmax(leaders_per_part > 1))]
                raise ValueError(f"two leaders for {bad[0]}-{bad[1]}")
            sorted_specs = [specs[b] for b in broker_ids]
            D = max(len(s.logdirs) for s in sorted_specs)
            dead_tbl = np.zeros((len(broker_ids), D), bool)
            alive_tbl = np.zeros(len(broker_ids), bool)
            for i, s in enumerate(sorted_specs):
                alive_tbl[i] = s.alive
                for d, ld in enumerate(s.logdirs):
                    dead_tbl[i, d] = ld in s.dead_disks
            flagged = np.fromiter((r.offline for r in reps), bool, R_valid)
            rb = replica_broker[:R_valid]
            replica_offline[:R_valid] = (
                flagged | ~alive_tbl[rb]
                | dead_tbl[rb, replica_disk[:R_valid]])
            leader_load[:R_valid] = [r.leader_load for r in reps]
            follower_load[:R_valid] = [r.follower_load for r in reps]

        partition_topic = np.zeros(P, np.int32)
        for (t, _p), i in pidx.items():
            partition_topic[i] = tidx[t]
        topic_excluded = np.zeros(T, bool)
        for t in self._excluded_topics:
            if t in tidx:
                topic_excluded[tidx[t]] = True

        ct = ClusterTensor(
            replica_broker=replica_broker,
            replica_disk=replica_disk,
            replica_partition=replica_partition,
            replica_topic=replica_topic,
            replica_is_leader=replica_is_leader,
            replica_valid=replica_valid,
            replica_offline=replica_offline,
            replica_original_broker=replica_broker.copy(),
            leader_load=leader_load,
            follower_load=follower_load,
            broker_capacity=broker_capacity,
            broker_rack=broker_rack,
            broker_alive=broker_alive,
            broker_new=broker_new,
            broker_demoted=broker_demoted,
            broker_excluded_for_replica_move=broker_excl_move,
            broker_excluded_for_leadership=broker_excl_lead,
            broker_disk_capacity=broker_disk_capacity,
            broker_disk_alive=broker_disk_alive,
            topic_excluded=topic_excluded,
            partition_topic=partition_topic,
        )
        meta = ClusterMeta(topic_names=topics, partition_ids=partitions,
                           broker_ids=broker_ids, rack_ids=racks,
                           logdirs=logdirs_per_broker, num_racks=len(racks),
                           num_valid_replicas=R_valid)
        return ct, meta
