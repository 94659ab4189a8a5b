"""Randomized synthetic cluster generator (counterpart of
``cruise_control_tpu/model/random_cluster.py``).

Analogue of the reference's RandomCluster.java (generate :53, populate
:102), which drives the BASELINE scale ladder (100/10k -> 1k/100k -> 7k/1M).
The draws follow the reference generator call for call, so one spec gives
identical arrays in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
from cruise_control_tpu_torch.model.cluster_tensor import ClusterMeta, ClusterTensor


@dataclasses.dataclass
class RandomClusterSpec:
    """ClusterProperty analogue (common/ClusterProperty in reference tests)."""
    num_brokers: int = 40
    num_racks: int = 10
    num_topics: int = 50
    num_partitions: int = 1000          # total partitions across topics
    min_replication: int = 1
    max_replication: int = 3
    mean_cpu: float = 1.0               # mean per-replica CPU %
    mean_disk: float = 100.0            # MB
    mean_nw_in: float = 100.0           # KB/s
    mean_nw_out: float = 100.0
    distribution: str = "exponential"   # exponential | linear | uniform
    cpu_capacity: float = 100.0
    disk_capacity: float = 500_000.0
    nw_in_capacity: float = 50_000.0
    nw_out_capacity: float = 50_000.0
    num_dead_brokers: int = 0
    num_brokers_with_dead_disk: int = 0
    logdirs_per_broker: int = 1
    leader_to_follower_ratio: float = 2.0   # unused when builder splits loads
    skew: float = 0.0                   # extra placement skew toward low-id brokers
    seed: int = 3140                    # TestConstants.SEED_BASE
    target_cpu_util: float | None = None
    """When set, rescale per-replica CPU loads so cluster-mean CPU
    utilization equals this fraction (keeps large rungs feasible)."""


def _sample(rng: np.random.Generator, dist: str, mean: float, n: int) -> np.ndarray:
    if dist == "exponential":
        return rng.exponential(mean, n)
    if dist == "linear":
        return mean * 2.0 * rng.uniform(0.0, 1.0, n)
    if dist == "uniform":
        return rng.uniform(0.5 * mean, 1.5 * mean, n)
    raise ValueError(f"unknown distribution {dist!r}")


PAIRWISE_BLOCK = 128     # numpy's PW_BLOCKSIZE
REDUCE_BUFFER = 8192     # numpy's reduction buffer (elements per inner call)


def _pairwise_f32(a: np.ndarray) -> np.float32:
    """numpy's float32 pairwise sum of one inner-loop call, step by step:
    below 8 a left-to-right sum from 0; up to 128 eight strided partial
    sums combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) plus the tail;
    above, split at half rounded down to a multiple of 8."""
    f32 = np.float32
    n = a.shape[0]
    if n < 8:
        res = f32(0.0)
        for x in a:
            res = f32(res + x)
        return res
    if n <= PAIRWISE_BLOCK:
        m = n - n % 8
        r = a[:8].copy()
        for i in range(8, m, 8):
            r = r + a[i:i + 8]
        res = f32(f32(f32(r[0] + r[1]) + f32(r[2] + r[3]))
                  + f32(f32(r[4] + r[5]) + f32(r[6] + r[7])))
        for x in a[m:]:
            res = f32(res + x)
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return f32(_pairwise_f32(a[:n2]) + _pairwise_f32(a[n2:]))


def f32_sum(a: np.ndarray) -> np.float32:
    """``np.sum`` of a contiguous float32 vector in the order numpy's classic
    reduction loop takes (buffers of 8,192, each summed pairwise), written
    out so that every machine gets the same bits: a numpy built with wider
    SIMD reductions sums in another order, which moves the calibrated CPU
    loads by an ulp and, with them, the optimizer's outcome."""
    a = np.ascontiguousarray(a, np.float32)
    acc = np.float32(0.0)
    for i in range(0, a.shape[0], REDUCE_BUFFER):
        acc = np.float32(acc + _pairwise_f32(a[i:i + REDUCE_BUFFER]))
    return acc


def _calibrate_cpu(ct: ClusterTensor, target_util: float) -> ClusterTensor:
    """Rescale CPU loads so mean CPU utilization over alive brokers hits
    ``target_util`` (shape and skew preserved; only the scale changes)."""
    lead = np.asarray(ct.leader_load)
    fol = np.asarray(ct.follower_load)
    is_lead = np.asarray(ct.replica_is_leader)
    valid = np.asarray(ct.replica_valid)
    eff = np.where(is_lead, lead[:, Resource.CPU], fol[:, Resource.CPU])
    total = float(f32_sum(eff[valid]))
    cap = np.asarray(ct.broker_capacity)[np.asarray(ct.broker_alive),
                                         Resource.CPU].sum()
    if total <= 0.0 or cap <= 0.0:
        return ct
    scale = target_util * float(cap) / total
    lead = lead.copy()
    fol = fol.copy()
    lead[:, Resource.CPU] *= scale
    fol[:, Resource.CPU] *= scale
    return dataclasses.replace(ct, leader_load=lead, follower_load=fol)


def generate(spec: RandomClusterSpec):
    """Build a (ClusterTensor, ClusterMeta) random cluster per spec."""
    rng = np.random.default_rng(spec.seed)
    b = ClusterModelBuilder()
    capacity = {Resource.CPU: spec.cpu_capacity, Resource.DISK: spec.disk_capacity,
                Resource.NW_IN: spec.nw_in_capacity, Resource.NW_OUT: spec.nw_out_capacity}
    logdirs = [f"/mnt/i{d:02d}" for d in range(spec.logdirs_per_broker)]
    dead_brokers = set(rng.choice(spec.num_brokers, spec.num_dead_brokers, replace=False).tolist()) \
        if spec.num_dead_brokers else set()
    dead_disk_brokers = set()
    if spec.num_brokers_with_dead_disk:
        if spec.logdirs_per_broker < 2:
            raise ValueError("num_brokers_with_dead_disk requires logdirs_per_broker >= 2 "
                             "(a broker's only disk dying is broker death, not disk failure)")
        pool = [x for x in range(spec.num_brokers) if x not in dead_brokers]
        dead_disk_brokers = set(rng.choice(pool, spec.num_brokers_with_dead_disk,
                                           replace=False).tolist())
    for broker in range(spec.num_brokers):
        b.add_broker(broker, rack=f"r{broker % spec.num_racks}", capacity=capacity,
                     alive=broker not in dead_brokers, logdirs=logdirs,
                     dead_disks={logdirs[-1]} if broker in dead_disk_brokers and
                                 spec.logdirs_per_broker > 1 else set())

    popularity = rng.exponential(1.0, spec.num_topics)
    popularity /= popularity.sum()
    parts_per_topic = np.maximum(1, np.round(popularity * spec.num_partitions).astype(int))

    broker_order = np.arange(spec.num_brokers)
    for t in range(spec.num_topics):
        n_parts = int(parts_per_topic[t])
        rf = int(rng.integers(spec.min_replication, spec.max_replication + 1))
        rf = min(rf, spec.num_brokers)
        cpu = _sample(rng, spec.distribution, spec.mean_cpu, n_parts)
        disk = _sample(rng, spec.distribution, spec.mean_disk, n_parts)
        nw_in = _sample(rng, spec.distribution, spec.mean_nw_in, n_parts)
        nw_out = _sample(rng, spec.distribution, spec.mean_nw_out, n_parts)
        for p in range(n_parts):
            if spec.skew > 0:
                w = np.exp(-spec.skew * broker_order / spec.num_brokers)
                w /= w.sum()
                brokers = rng.choice(spec.num_brokers, rf, replace=False, p=w)
            else:
                start = int(rng.integers(spec.num_brokers))
                brokers = [(start + k) % spec.num_brokers for k in range(rf)]
            load = [cpu[p], nw_in[p], nw_out[p], disk[p]]
            for i, broker in enumerate(brokers):
                logdir = logdirs[int(rng.integers(spec.logdirs_per_broker))]
                b.add_replica(f"topic{t}", p, int(broker), is_leader=(i == 0),
                              load=load, logdir=logdir)
    ct, meta = b.build()
    if spec.target_cpu_util is not None:
        ct = _calibrate_cpu(ct, spec.target_cpu_util)
    return ct, meta


def generate_scale(spec: RandomClusterSpec):
    """Vectorized generator for the BASELINE scale ladder (1k/100k, 7k/1M):
    same knobs and semantics as :func:`generate`, arrays built directly with
    numpy. Each partition's rf brokers come from a (optionally skewed)
    categorical draw, with within-partition duplicates re-drawn."""
    rng = np.random.default_rng(spec.seed)
    B = spec.num_brokers

    # ---- topics / partitions ----
    popularity = rng.exponential(1.0, spec.num_topics)
    popularity /= popularity.sum()
    parts_per_topic = np.maximum(1, np.round(popularity * spec.num_partitions).astype(int))
    P = int(parts_per_topic.sum())
    partition_topic = np.repeat(np.arange(spec.num_topics, dtype=np.int32),
                                parts_per_topic)
    rf_per_topic = rng.integers(spec.min_replication, spec.max_replication + 1,
                                spec.num_topics)
    rf_per_topic = np.minimum(rf_per_topic, B)
    rf_per_part = rf_per_topic[partition_topic]                  # [P]
    R = int(rf_per_part.sum())

    # ---- per-replica partition / topic / leadership ----
    replica_partition = np.repeat(np.arange(P, dtype=np.int32), rf_per_part)
    replica_topic = partition_topic[replica_partition]
    first_of_part = np.zeros(R, bool)
    first_of_part[np.concatenate([[0], np.cumsum(rf_per_part)[:-1]])] = True
    replica_is_leader = first_of_part
    pos_in_part = np.arange(R) - np.repeat(
        np.concatenate([[0], np.cumsum(rf_per_part)[:-1]]), rf_per_part)

    # ---- placement: weighted categorical + duplicate redraw ----
    if spec.skew > 0:
        w = np.exp(-spec.skew * np.arange(B) / B)
        w /= w.sum()
    else:
        w = np.full(B, 1.0 / B)
    replica_broker = rng.choice(B, size=R, p=w).astype(np.int32)
    for _ in range(64):
        key = replica_partition.astype(np.int64) * B + replica_broker
        order = np.lexsort((pos_in_part, key))
        sk = key[order]
        dup_sorted = np.zeros(R, bool)
        dup_sorted[1:] = sk[1:] == sk[:-1]
        dup = np.zeros(R, bool)
        dup[order] = dup_sorted
        n_dup = int(dup.sum())
        if n_dup == 0:
            break
        replica_broker[dup] = rng.choice(B, size=n_dup, p=w).astype(np.int32)
    else:
        raise RuntimeError("placement redraw did not converge")

    # ---- loads (per partition, shared by its replicas) ----
    loads = np.stack([
        _sample(rng, spec.distribution, spec.mean_cpu, P),
        _sample(rng, spec.distribution, spec.mean_nw_in, P),
        _sample(rng, spec.distribution, spec.mean_nw_out, P),
        _sample(rng, spec.distribution, spec.mean_disk, P),
    ], axis=1).astype(np.float32)                                 # [P, M]
    leader_load = loads[replica_partition]
    follower_load = leader_load.copy()
    follower_load[:, Resource.NW_OUT] = 0.0
    follower_load[:, Resource.CPU] *= 0.5        # builder FOLLOWER_CPU_FRACTION

    # ---- brokers ----
    dead = np.zeros(B, bool)
    if spec.num_dead_brokers:
        dead[rng.choice(B, spec.num_dead_brokers, replace=False)] = True
    D = spec.logdirs_per_broker
    disk_cap = np.full((B, D), spec.disk_capacity / D, np.float32)
    disk_alive = np.ones((B, D), bool) & ~dead[:, None]
    if spec.num_brokers_with_dead_disk:
        if D < 2:
            raise ValueError("dead disks require logdirs_per_broker >= 2")
        pool = np.flatnonzero(~dead)
        chosen = rng.choice(pool, spec.num_brokers_with_dead_disk, replace=False)
        disk_alive[chosen, D - 1] = False
    replica_disk = rng.integers(0, D, R).astype(np.int32)
    replica_offline = (dead[replica_broker]
                       | ~disk_alive[replica_broker, replica_disk])

    capacity = np.tile(np.array([[spec.cpu_capacity, spec.nw_in_capacity,
                                  spec.nw_out_capacity, spec.disk_capacity]],
                                np.float32), (B, 1))

    ct = ClusterTensor(
        replica_broker=replica_broker,
        replica_disk=replica_disk,
        replica_partition=replica_partition,
        replica_topic=replica_topic,
        replica_is_leader=replica_is_leader,
        replica_valid=np.ones(R, bool),
        replica_offline=replica_offline,
        replica_original_broker=replica_broker.copy(),
        leader_load=leader_load,
        follower_load=follower_load,
        broker_capacity=capacity,
        broker_rack=(np.arange(B) % spec.num_racks).astype(np.int32),
        broker_alive=~dead,
        broker_new=np.zeros(B, bool),
        broker_demoted=np.zeros(B, bool),
        broker_excluded_for_replica_move=np.zeros(B, bool),
        broker_excluded_for_leadership=np.zeros(B, bool),
        broker_disk_capacity=disk_cap,
        broker_disk_alive=disk_alive,
        topic_excluded=np.zeros(spec.num_topics, bool),
        partition_topic=partition_topic,
    )
    part_counter = np.zeros(spec.num_topics, np.int64)
    partition_ids = []
    for t in partition_topic:
        partition_ids.append((f"topic{t}", int(part_counter[t])))
        part_counter[t] += 1
    meta = ClusterMeta(
        topic_names=[f"topic{t}" for t in range(spec.num_topics)],
        partition_ids=partition_ids,
        broker_ids=list(range(B)),
        rack_ids=[f"r{k}" for k in range(spec.num_racks)],
        logdirs=[[f"/mnt/i{d:02d}" for d in range(D)]] * B,
        num_racks=spec.num_racks,
        num_valid_replicas=R,
    )
    if spec.target_cpu_util is not None:
        ct = _calibrate_cpu(ct, spec.target_cpu_util)
    return ct, meta
