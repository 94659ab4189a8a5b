"""Proposal diffing: initial vs optimized assignment -> ExecutionProposals
(counterpart of ``cruise_control_tpu/analyzer/proposals.py``).

Reference: analyzer/AnalyzerUtils.getDiff and executor/ExecutionProposal.java.
The diff is pure numpy over the host assignment arrays; ``ProposalSet``
materializes the per-partition ``ExecutionProposal`` objects lazily.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from cruise_control_tpu_torch.model.cluster_tensor import ClusterMeta


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    topic: str
    partition: int
    old_leader: int                 # external broker id
    new_leader: int
    old_replicas: tuple             # tuple[(broker_id, logdir_index), ...]
    new_replicas: tuple

    @property
    def tp(self) -> str:
        return f"{self.topic}-{self.partition}"

    @property
    def replicas_to_add(self) -> tuple:
        old = {b for b, _ in self.old_replicas}
        return tuple(b for b, _ in self.new_replicas if b not in old)

    @property
    def replicas_to_remove(self) -> tuple:
        new = {b for b, _ in self.new_replicas}
        return tuple(b for b, _ in self.old_replicas if b not in new)

    @property
    def has_replica_action(self) -> bool:
        return bool(self.replicas_to_add or self.replicas_to_remove)

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader != self.new_leader

    def data_to_move_mb(self, replica_disk_mb: float) -> float:
        return replica_disk_mb * len(self.replicas_to_add)

    def to_json(self) -> dict:
        return {
            "topicPartition": {"topic": self.topic, "partition": self.partition},
            "oldLeader": self.old_leader,
            "newLeader": self.new_leader,
            "oldReplicas": [b for b, _ in self.old_replicas],
            "newReplicas": [b for b, _ in self.new_replicas],
        }


class ProposalSet(Sequence):
    """Lazy sequence of ExecutionProposals over vectorized diff arrays."""

    def __init__(self, meta: ClusterMeta, part_idx: np.ndarray,
                 members: np.ndarray, valid_m: np.ndarray,
                 old_broker_ext: np.ndarray, new_broker_ext: np.ndarray,
                 old_disk: np.ndarray, new_disk: np.ndarray,
                 old_leader_ext: np.ndarray, new_leader_ext: np.ndarray,
                 num_additions: int):
        self._meta = meta
        self._part_idx = part_idx
        self._members = members
        self._valid = valid_m
        self._old_b = old_broker_ext
        self._new_b = new_broker_ext
        self._old_d = old_disk
        self._new_d = new_disk
        self._old_leader = old_leader_ext
        self._new_leader = new_leader_ext
        self.num_replica_additions = int(num_additions)
        self.num_leadership_changes = int((old_leader_ext != new_leader_ext).sum())

    def __len__(self) -> int:
        return len(self._part_idx)

    def _make(self, i: int) -> ExecutionProposal:
        v = self._valid[i]
        topic, partition = self._meta.partition_ids[int(self._part_idx[i])]
        old_replicas = tuple(zip(self._old_b[i][v].tolist(),
                                 self._old_d[i][v].tolist()))
        new_replicas = tuple(zip(self._new_b[i][v].tolist(),
                                 self._new_d[i][v].tolist()))
        return ExecutionProposal(
            topic=topic, partition=int(partition),
            old_leader=int(self._old_leader[i]),
            new_leader=int(self._new_leader[i]),
            old_replicas=old_replicas, new_replicas=new_replicas)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._make(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._make(i)


def diff_proposals(meta: ClusterMeta, initial_broker, initial_leader, initial_disk,
                   final_broker, final_leader, final_disk, members_table,
                   replica_valid, replica_partition) -> ProposalSet:
    """One proposal per partition whose replicas, leader or logdirs changed.
    All arguments are host arrays: the assignments [R], the [P, F] membership
    table, the validity mask and the partition of each replica."""
    initial_broker = np.asarray(initial_broker)
    initial_leader = np.asarray(initial_leader)
    initial_disk = np.asarray(initial_disk)
    final_broker = np.asarray(final_broker)
    final_leader = np.asarray(final_leader)
    final_disk = np.asarray(final_disk)
    members_table = np.asarray(members_table)
    valid = np.asarray(replica_valid)
    part_of = np.asarray(replica_partition)
    broker_ids = np.asarray(meta.broker_ids)

    changed_r = (final_broker != initial_broker) | (final_leader != initial_leader) \
        | (final_disk != initial_disk)
    changed_parts = np.unique(part_of[changed_r & valid])

    members = members_table[changed_parts]              # [Pc, F], -1 padded
    valid_m = members >= 0
    m = np.where(valid_m, members, 0)
    ib, fb = initial_broker[m], final_broker[m]
    old_b_ext = np.where(valid_m, broker_ids[ib], -1)
    new_b_ext = np.where(valid_m, broker_ids[fb], -1)
    old_d = np.where(valid_m, initial_disk[m], 0).astype(np.int32)
    new_d = np.where(valid_m, final_disk[m], 0).astype(np.int32)

    def leader_ext(leader_flags, brokers_ext):
        flags = np.where(valid_m, leader_flags[m], False)
        has = flags.any(axis=1)
        first = np.argmax(flags, axis=1)
        return np.where(has, brokers_ext[np.arange(len(first)), first], -1)

    old_leader = leader_ext(initial_leader, old_b_ext)
    new_leader = leader_ext(final_leader, new_b_ext)

    # replica additions: members whose new broker hosts no OLD copy
    in_old = (new_b_ext[:, :, None] == old_b_ext[:, None, :]).any(axis=2)
    num_additions = int((valid_m & ~in_old).sum())

    return ProposalSet(meta, changed_parts, members, valid_m,
                       old_b_ext, new_b_ext, old_d, new_d,
                       old_leader, new_leader, num_additions)
