"""ClusterTensor: the cluster workload model as flat, replica-major arrays.

Counterpart of ``cruise_control_tpu/model/cluster_tensor.py``. The model is
built and padded on the host, so here it is a frozen dataclass of numpy
arrays; ``analyzer.env.make_env`` / ``analyzer.state.init_state`` move it to
the device as torch tensors.

- axis R: replicas (padded; ``replica_valid`` masks the tail)
- axis B: brokers
- axis M: resources (``common.Resource`` column order: CPU, NW_IN, NW_OUT, DISK)
- axis P: partitions, axis T: topics, axis D: disks per broker
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterTensor:
    # -------- replica axis (R) --------
    replica_broker: np.ndarray            # i32[R] current broker
    replica_disk: np.ndarray              # i32[R] disk index on its broker
    replica_partition: np.ndarray         # i32[R] global partition index
    replica_topic: np.ndarray             # i32[R] topic index
    replica_is_leader: np.ndarray         # bool[R]
    replica_valid: np.ndarray             # bool[R] padding mask
    replica_offline: np.ndarray           # bool[R] on a dead broker / disk
    replica_original_broker: np.ndarray   # i32[R] broker at model build time
    leader_load: np.ndarray               # f32[R, M] load if this replica leads
    follower_load: np.ndarray             # f32[R, M] load if it follows
    # -------- broker axis (B) --------
    broker_capacity: np.ndarray           # f32[B, M]
    broker_rack: np.ndarray               # i32[B]
    broker_alive: np.ndarray              # bool[B]
    broker_new: np.ndarray                # bool[B]
    broker_demoted: np.ndarray            # bool[B]
    broker_excluded_for_replica_move: np.ndarray  # bool[B]
    broker_excluded_for_leadership: np.ndarray    # bool[B]
    broker_disk_capacity: np.ndarray      # f32[B, D]
    broker_disk_alive: np.ndarray         # bool[B, D]
    # -------- topic / partition axes --------
    topic_excluded: np.ndarray            # bool[T]
    partition_topic: np.ndarray           # i32[P]

    @property
    def num_replicas(self) -> int:
        return self.replica_broker.shape[0]

    @property
    def num_brokers(self) -> int:
        return self.broker_capacity.shape[0]

    @property
    def num_topics(self) -> int:
        return self.topic_excluded.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.partition_topic.shape[0]

    @property
    def num_disks(self) -> int:
        return self.broker_disk_capacity.shape[1]

    def set_broker_alive(self, broker: int, alive: bool) -> "ClusterTensor":
        """Mark broker death or revival (cluster_tensor.py:220): the hosted
        replicas' offline flags and the broker's disk aliveness follow. On
        death the broker's disk row reads dead; on revival a row that is all
        dead comes back alive and a row with some alive disks stays as it
        is (a disk that failed on its own stays dead)."""
        alive_arr = self.broker_alive.copy()
        alive_arr[broker] = alive
        disk_alive = self.broker_disk_alive.copy()
        row = disk_alive[broker]
        disk_alive[broker] = (row | ~row.any()) if alive else np.zeros_like(row)
        on_broker = (self.replica_broker == broker) & self.replica_valid
        disk_ok = disk_alive[self.replica_broker, self.replica_disk]
        offline = np.where(on_broker, ~(bool(alive) & disk_ok), self.replica_offline)
        return dataclasses.replace(self, broker_alive=alive_arr,
                                   replica_offline=offline,
                                   broker_disk_alive=disk_alive)


@dataclasses.dataclass
class ClusterMeta:
    """Host-side companion: names and id mappings."""
    topic_names: list[str]
    partition_ids: list[tuple[str, int]]     # partition index -> (topic, partition)
    broker_ids: list[int]                    # broker axis index -> external broker id
    rack_ids: list[str]                      # rack index -> rack id string
    logdirs: list[list[str]]                 # per broker: disk index -> logdir path
    num_racks: int
    num_valid_replicas: int
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    def broker_index(self, broker_id: int) -> int:
        return self.broker_ids.index(broker_id)


# Compact index dtypes. The reference stores these narrow in device memory
# (an HBM diet on the TPU); the port keeps int32/int64 on the device and
# uses the policy only for the packed final-assignment fetch.
COMPACT_IDX_MAX16 = 32_767
COMPACT_IDX_MAX8 = 127


def broker_index_dtype(num_brokers: int, compact: bool = True):
    """Dtype for broker-valued index arrays."""
    return np.int16 if (compact and num_brokers <= COMPACT_IDX_MAX16) \
        else np.int32


def disk_index_dtype(num_disks: int, compact: bool = True):
    """Dtype for logdir-valued index arrays."""
    return np.int8 if (compact and num_disks <= COMPACT_IDX_MAX8) \
        else np.int32


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round up to the next size in a {1, 1.25, 1.5, 1.75} x 2^k ladder."""
    n = max(int(n), minimum)
    k = int(math.floor(math.log2(n)))
    for m in (1.0, 1.25, 1.5, 1.75, 2.0):
        v = int(math.ceil(m * (1 << k)))
        if v >= n:
            return v
    return 1 << (k + 1)


def pad_cluster(ct: ClusterTensor, meta: ClusterMeta,
                min_replicas: int = 1024, min_brokers: int = 16,
                min_partitions: int = 256,
                min_topics: int = 16) -> tuple[ClusterTensor, ClusterMeta]:
    """Pad the replica/broker/partition/topic axes up to bucket sizes.

    Padded replicas are invalid, padded brokers dead and move-excluded with
    zero capacity, padded partitions have no members and padded topics zero
    counts; ``meta`` is shared unchanged."""
    R, B, P, T = ct.num_replicas, ct.num_brokers, ct.num_partitions, ct.num_topics
    Rp, Bp, Pp, Tp = (bucket_size(R, min_replicas), bucket_size(B, min_brokers),
                      bucket_size(P, min_partitions), bucket_size(T, min_topics))
    if (Rp, Bp, Pp, Tp) == (R, B, P, T):
        return ct, meta

    def pad(arr, to, fill):
        a = np.asarray(arr)
        if a.shape[0] == to:
            return a
        width = [(0, to - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    padded = ClusterTensor(
        replica_broker=pad(ct.replica_broker, Rp, 0),
        replica_disk=pad(ct.replica_disk, Rp, 0),
        replica_partition=pad(ct.replica_partition, Rp, 0),
        replica_topic=pad(ct.replica_topic, Rp, 0),
        replica_is_leader=pad(ct.replica_is_leader, Rp, False),
        replica_valid=pad(ct.replica_valid, Rp, False),
        replica_offline=pad(ct.replica_offline, Rp, False),
        replica_original_broker=pad(ct.replica_original_broker, Rp, 0),
        leader_load=pad(ct.leader_load, Rp, 0.0),
        follower_load=pad(ct.follower_load, Rp, 0.0),
        broker_capacity=pad(ct.broker_capacity, Bp, 0.0),
        broker_rack=pad(ct.broker_rack, Bp, 0),
        broker_alive=pad(ct.broker_alive, Bp, False),
        broker_new=pad(ct.broker_new, Bp, False),
        broker_demoted=pad(ct.broker_demoted, Bp, False),
        broker_excluded_for_replica_move=pad(
            ct.broker_excluded_for_replica_move, Bp, True),
        broker_excluded_for_leadership=pad(
            ct.broker_excluded_for_leadership, Bp, True),
        broker_disk_capacity=pad(ct.broker_disk_capacity, Bp, 0.0),
        broker_disk_alive=pad(ct.broker_disk_alive, Bp, False),
        topic_excluded=pad(ct.topic_excluded, Tp, False),
        partition_topic=pad(ct.partition_topic, Pp, 0),
    )
    return padded, meta
