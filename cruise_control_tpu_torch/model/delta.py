"""(Counterpart of ``cruise_control_tpu/model/delta.py``, copied with the
port's imports.) Columnar snapshot deltas: what changed between two metadata generations.

The reference keeps ONE in-memory ClusterModel continuously updated by the
metadata listener and only re-runs ``GoalOptimizer.optimizations()`` over it
(GoalOptimizer.java:139-339 precompute thread); rebuilding the model from
scratch per proposal round is the e2e path's dominant cost at the 7k-broker
rung. The TPU-native equivalent (analyzer/session.py) keeps the padded
``ClusterEnv``/``EngineState`` resident on device and applies *deltas*
between rounds. This module computes those deltas on the host from two
columnar :class:`~cruise_control_tpu_torch.backend.interface.ClusterSnapshot`\\ s.

A delta is *slot-compatible* when every replica keeps its CSR position: the
replica axis follows sorted-partition-key order, so in-place changes (broker
reassignment, leadership transfer, logdir move, broker death) never shift
positions, and partitions whose keys sort AFTER every existing key append
their replicas at the axis tail — exactly where the padded tensor keeps its
free slots. Anything that would shift positions (deletion, mid-order
insertion, per-partition RF change, broker-set change) is reported as
incompatible and triggers a full rebuild instead; correctness never depends
on the delta path applying.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.backend.interface import ClusterSnapshot


@dataclasses.dataclass
class SnapshotDelta:
    """Slot-aligned difference between two snapshots of the same cluster.

    ``changed_slots`` are CSR replica positions (valid in BOTH snapshots)
    whose broker / leadership / logdir changed; appended partitions cover
    CSR positions ``[num_replicas_before, num_replicas_after)`` of ``new``.
    """
    compatible: bool
    reason: str = ""
    # -- in-place churn (positions shared by both snapshots) --
    changed_slots: np.ndarray | None = None      # i64[K]
    # -- appended topology (suffix of the NEW snapshot's axes) --
    num_partitions_before: int = 0
    num_partitions_after: int = 0
    num_replicas_before: int = 0
    num_replicas_after: int = 0
    num_topics_before: int = 0
    num_topics_after: int = 0

    @property
    def num_changed(self) -> int:
        return 0 if self.changed_slots is None else int(self.changed_slots.size)

    @property
    def num_appended_replicas(self) -> int:
        return self.num_replicas_after - self.num_replicas_before

    @property
    def churn(self) -> int:
        """Total replica slots this delta touches (budget accounting)."""
        return self.num_changed + self.num_appended_replicas

    @property
    def is_noop(self) -> bool:
        return (self.compatible and self.num_changed == 0
                and self.num_appended_replicas == 0)


def _incompatible(reason: str) -> SnapshotDelta:
    return SnapshotDelta(compatible=False, reason=reason)


def diff_snapshots(prev: ClusterSnapshot, new: ClusterSnapshot) -> SnapshotDelta:
    """Slot-aligned delta ``prev -> new``, or an incompatible marker naming
    the first rebuild trigger found. O(P + R) vectorized host time."""
    if not np.array_equal(prev.broker_ids, new.broker_ids):
        return _incompatible("broker set changed")
    if prev.broker_logdirs != new.broker_logdirs:
        return _incompatible("broker logdir layout changed")
    Pp, Pn = prev.num_partitions, new.num_partitions
    if Pn < Pp:
        return _incompatible("partitions deleted")
    if new.partition_keys[:Pp] != prev.partition_keys:
        return _incompatible("partition key order changed (non-append churn)")
    Tp, Tn = len(prev.topics), len(new.topics)
    if new.topics[:Tp] != prev.topics:
        return _incompatible("topic order changed")
    nrep_new = np.diff(new.rep_ptr)
    if Pp and not np.array_equal(np.diff(prev.rep_ptr), nrep_new[:Pp]):
        return _incompatible("per-partition replication factor changed")
    Rp_, Rn = prev.num_replicas, new.num_replicas
    if Rp_:
        changed = np.flatnonzero(
            (prev.rep_bid != new.rep_bid[:Rp_])
            | (prev.rep_leader != new.rep_leader[:Rp_])
            | (prev.rep_disk != new.rep_disk[:Rp_]))
    else:
        changed = np.zeros(0, np.int64)
    return SnapshotDelta(
        compatible=True,
        changed_slots=changed,
        num_partitions_before=Pp, num_partitions_after=Pn,
        num_replicas_before=Rp_, num_replicas_after=Rn,
        num_topics_before=Tp, num_topics_after=Tn)


def replica_slot_values(snap: ClusterSnapshot, slots: np.ndarray,
                        sorted_broker_ids: np.ndarray,
                        max_disks: int) -> dict:
    """Per-slot scatter payload for ``slots`` (CSR positions of ``snap``):
    broker INDEX (into the sorted broker axis), logdir index (clipped to the
    resident disk-axis width, like the model build), and leadership."""
    bid = snap.rep_bid[slots]
    bidx = np.searchsorted(sorted_broker_ids, bid)
    bidx = np.clip(bidx, 0, len(sorted_broker_ids) - 1)
    if (sorted_broker_ids[bidx] != bid).any():
        raise KeyError("replica assigned to unknown broker id")
    return {
        "broker": bidx.astype(np.int32),
        "disk": np.minimum(snap.rep_disk[slots], max_disks - 1).astype(np.int32),
        "leader": snap.rep_leader[slots].astype(bool),
    }


def dirty_replica_sets(prev: ClusterSnapshot, new: ClusterSnapshot,
                       delta: SnapshotDelta) -> dict:
    """Brokers and topics a compatible delta touches — the incremental
    optimizer's dirty-set seed (analyzer/optimizer.py).

    Returns ``{"brokers": i64[], "topics": i64[]}``: broker INDICES into the
    sorted broker axis (both the OLD and NEW broker of every changed slot —
    a vacated broker's balance changes too) and topic indices (into the NEW
    snapshot's topic list) of every changed or appended replica's partition.
    O(churn) host time."""
    brokers: list = []
    topics: list = []
    if delta.num_changed:
        slots = delta.changed_slots
        old_bid = prev.rep_bid[slots]
        new_bid = new.rep_bid[slots]
        brokers.append(old_bid)
        brokers.append(new_bid)
        part = np.searchsorted(prev.rep_ptr, slots, side="right") - 1
        topics.append(new.partition_topic[part])
    if delta.num_appended_replicas:
        lo = delta.num_replicas_before
        brokers.append(new.rep_bid[lo:])
        part = (np.searchsorted(new.rep_ptr, np.arange(lo, new.num_replicas),
                                side="right") - 1)
        topics.append(new.partition_topic[part])
    if brokers:
        bid = np.unique(np.concatenate(brokers))
        bidx = np.searchsorted(new.broker_ids, bid)
        bidx = np.clip(bidx, 0, len(new.broker_ids) - 1)
        bidx = bidx[new.broker_ids[bidx] == bid]
    else:
        bidx = np.zeros(0, np.int64)
    tidx = (np.unique(np.concatenate(topics)) if topics
            else np.zeros(0, np.int64))
    return {"brokers": bidx.astype(np.int64), "topics": tidx}


def appended_partition_slots(snap: ClusterSnapshot, p_lo: int) -> np.ndarray:
    """i64[P_new - p_lo + 1]: rep_ptr suffix for partitions ``p_lo:`` —
    the CSR ranges the appended partitions occupy."""
    return snap.rep_ptr[p_lo:]
