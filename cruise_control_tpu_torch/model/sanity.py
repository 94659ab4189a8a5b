"""Model invariant checks (counterpart of
``cruise_control_tpu/model/sanity.py``).

Reference: ClusterModel.sanityCheck() (model/ClusterModel.java:1140)
verifies load bookkeeping after mutations. The port's ``ClusterTensor`` is a
host model, so the checks are host numpy: replica brokers in range, one
leader per present partition, no two replicas of a partition on one broker,
replicas on dead brokers flagged offline, finite non-negative utilization.
"""
from __future__ import annotations

import numpy as np

from cruise_control_tpu_torch.model.cluster_tensor import ClusterTensor


class SanityCheckError(AssertionError):
    pass


def sanity_check(ct: ClusterTensor, meta=None) -> None:
    broker = np.asarray(ct.replica_broker)
    valid = np.asarray(ct.replica_valid)
    leader = np.asarray(ct.replica_is_leader)
    part = np.asarray(ct.replica_partition)
    alive = np.asarray(ct.broker_alive)
    offline = np.asarray(ct.replica_offline)
    B = ct.num_brokers

    if valid.any():
        if broker[valid].min() < 0 or broker[valid].max() >= B:
            raise SanityCheckError("replica_broker out of range")

    # every partition has exactly one leader among valid replicas
    P = ct.num_partitions
    leader_count = np.zeros(P, np.int64)
    np.add.at(leader_count, part[valid & leader], 1)
    present = np.zeros(P, bool)
    present[part[valid]] = True
    bad = present & (leader_count != 1)
    if bad.any():
        raise SanityCheckError(f"partitions without exactly one leader: {np.flatnonzero(bad)[:10]}")

    # no two replicas of one partition on the same broker
    keys = part[valid].astype(np.int64) * B + broker[valid].astype(np.int64)
    uniq, counts = np.unique(keys, return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        p0, b0 = divmod(int(dup[0]), B)
        raise SanityCheckError(f"partition {p0} has {int(counts[counts > 1][0])} replicas on broker {b0}")

    # replicas on dead brokers must be flagged offline
    on_dead = valid & ~alive[broker]
    if (on_dead & ~offline).any():
        raise SanityCheckError("replica on dead broker not flagged offline")

    # utilization must be finite and non-negative
    load = np.where(leader[:, None], np.asarray(ct.leader_load),
                    np.asarray(ct.follower_load))
    util = np.zeros((B, load.shape[1]), np.float32)
    np.add.at(util, broker[valid], load[valid])
    if not np.isfinite(util).all() or (util < -1e-6).any():
        raise SanityCheckError("broker utilization not finite/non-negative")
