"""Response schema renderers (counterpart of
``cruise_control_tpu/api/responses.py``).

Every JSON body carries the reference's ``version`` field
(servlet/response/JsonResponseField.java convention); the ``/load`` body
mirrors ClusterLoad/BrokerStats (response/stats/BrokerStats.java) with
per-broker and per-host rows. Its broker tallies are K4/K5 segment sums in
replica order on the facade's device, the reference's
``ClusterTensor.broker_*`` sums.
"""
from __future__ import annotations

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource

JSON_VERSION = 1


def wrap(body: dict) -> dict:
    out = {"version": JSON_VERSION}
    out.update(body)
    return out


def error_json(message: str, stack_trace: str | None = None) -> dict:
    out = wrap({"errorMessage": message})
    if stack_trace:
        out["stackTrace"] = stack_trace
    return out


def _broker_stats_rows(meta, cap, alive, rack, util, lead_util, pnw_out,
                       nrep, nlead, disk_cap=None, disk_util=None) -> dict:
    """Shared row builder for the BrokerStats schema
    (response/stats/{BrokerStats,SingleBrokerStats,BasicStats}.java):
    one row per broker with leader/follower network split, CPU %, disk MB /
    percentage and capacity columns, plus host-level aggregation (broker ==
    host here: the tensor model carries no separate host axis).
    ``pnw_out`` is the potential-NW-out column f64[B]."""
    rows = []
    for i, bid in enumerate(meta.broker_ids):
        disk_mb = float(util[i, Resource.DISK])
        disk_cap_mb = float(cap[i, Resource.DISK])
        row = {
            "Broker": int(bid),
            "Host": f"host-{bid}",
            "Rack": meta.rack_ids[int(rack[i])],
            "BrokerState": "ALIVE" if bool(alive[i]) else "DEAD",
            "DiskMB": round(disk_mb, 3),
            "DiskPct": round(100.0 * disk_mb / disk_cap_mb, 3)
            if disk_cap_mb else 0.0,
            "CpuPct": round(float(util[i, Resource.CPU]), 3),
            "LeaderNwInRate": round(float(lead_util[i, Resource.NW_IN]), 3),
            "FollowerNwInRate": round(
                float(util[i, Resource.NW_IN] - lead_util[i, Resource.NW_IN]), 3),
            "NwOutRate": round(float(util[i, Resource.NW_OUT]), 3),
            "PnwOutRate": round(float(pnw_out[i]), 3),
            "Leaders": int(nlead[i]),
            "Replicas": int(nrep[i]),
            # capacity columns (BasicStats.java:38-44 field names) make
            # capacity_only responses meaningful
            "DiskCapacityMB": round(disk_cap_mb, 3),
            "NetworkInCapacity": round(float(cap[i, Resource.NW_IN]), 3),
            "NetworkOutCapacity": round(float(cap[i, Resource.NW_OUT]), 3),
            "NumCore": round(float(cap[i, Resource.CPU]) / 100.0, 3),
        }
        if disk_util is not None:
            row["DiskState"] = {
                meta.logdirs[i][d] if d < len(meta.logdirs[i]) else f"disk-{d}": {
                    "DiskMB": round(float(disk_util[i, d]), 3),
                    "DiskPct": round(100.0 * float(disk_util[i, d])
                                     / float(disk_cap[i, d]), 3)
                    if disk_cap[i, d] else 0.0,
                }
                for d in range(disk_cap.shape[1]) if disk_cap[i, d] > 0
            }
        rows.append(row)
    hosts = [dict(r) for r in rows]  # broker==host aggregation
    return wrap({"brokers": rows, "hosts": hosts})


# ---------------------------------------------------------------------------
# ClusterModelStats (model/ClusterModelStats.java getJsonStructure +
# ClusterModelStatsMetaData.java + ClusterModelStatsValueHolder.java:
# {"metadata": {brokers, replicas, topics},
#  "statistics": {AVG|MAX|MIN|STD: {cpu, networkInbound, networkOutbound,
#                 disk, potentialNwOut, replicas, leaderReplicas,
#                 topicReplicas}}})
# ---------------------------------------------------------------------------
_RESOURCE_JSON_NAMES = ("cpu", "networkInbound", "networkOutbound", "disk")
_STAT_KEYS = (("AVG", "avg"), ("MAX", "max"), ("MIN", "min"), ("STD", "std"))


def cluster_model_stats_json(stats: dict) -> dict:
    """Render an optimizer stats dict (analyzer.optimizer.cluster_stats_state)
    in the reference's ClusterModelStats JSON shape."""
    statistics = {}
    for stat_name, key in _STAT_KEYS:
        res_vals = stats.get(key) or [0.0] * 4
        rep = {
            "avg": stats.get("replica_count_avg", 0.0),
            "max": stats.get("replica_count_max", 0),
            "min": stats.get("replica_count_min", 0),
            "std": stats.get("replica_count_std", 0.0),
        }[key]
        statistics[stat_name] = {
            **{n: round(float(res_vals[i]), 4)
               for i, n in enumerate(_RESOURCE_JSON_NAMES)},
            "potentialNwOut": round(
                float(stats.get("potential_nw_out", {}).get(key, 0.0)), 4),
            "replicas": rep,
            "leaderReplicas": round(
                float(stats.get("leader_count", {}).get(key, 0.0)), 4),
            "topicReplicas": round(
                float(stats.get("topic_replica_count", {}).get(key, 0.0)), 4),
        }
    return {
        "metadata": {"brokers": stats.get("num_brokers", 0),
                     "replicas": stats.get("num_replicas", 0),
                     "topics": stats.get("num_topics", 0)},
        "statistics": statistics,
    }


def broker_stats_from_state(env, st, meta) -> dict:
    """BrokerStats rows from an ENGINE state (post-optimization load view:
    OptimizerResult.brokerStatsAfterOptimization role)."""
    def host(t):
        return t.detach().cpu().numpy()

    return _broker_stats_rows(meta, host(env.broker_capacity).astype(np.float64),
                              host(env.broker_alive), host(env.broker_rack),
                              host(st.util).astype(np.float64),
                              host(st.leader_util).astype(np.float64),
                              host(st.potential_nw_out).astype(np.float64),
                              host(st.replica_count), host(st.leader_count))


def optimization_result_json(res, num_windows: int = 1,
                             monitored_partitions_pct: float = 1.0,
                             excluded_topics=(), excluded_brokers_leadership=(),
                             excluded_brokers_move=(),
                             provision_status: str = "RIGHT_SIZED",
                             provision_recommendation: str = "") -> dict:
    """servlet/response/OptimizationResult.java getJsonStructure parity:
    summary (OptimizerResult.java:303-316 field set), goalSummary entries
    {goal, status, clusterModelStats, optimizationTimeMs}, proposals,
    loadBeforeOptimization / loadAfterOptimization (BrokerStats)."""
    out = {
        "summary": {
            "numReplicaMovements": res.num_replica_movements,
            "dataToMoveMB": int(res.data_to_move_mb),
            "numIntraBrokerReplicaMovements": getattr(
                res, "num_intra_broker_replica_movements", 0),
            "intraBrokerDataToMoveMB": int(getattr(
                res, "intra_broker_data_to_move_mb", 0)),
            "numLeaderMovements": res.num_leadership_movements,
            "recentWindows": num_windows,
            "monitoredPartitionsPercentage": round(
                100.0 * monitored_partitions_pct, 3),
            "excludedTopics": list(excluded_topics),
            "excludedBrokersForLeadership": list(excluded_brokers_leadership),
            "excludedBrokersForReplicaMove": list(excluded_brokers_move),
            "onDemandBalancednessScoreBefore": round(res.balancedness_before, 3),
            "onDemandBalancednessScoreAfter": round(res.balancedness_after, 3),
            "provisionStatus": provision_status,
            "provisionRecommendation": provision_recommendation,
        },
        "goalSummary": [
            {"goal": g.name,
             "status": ("VIOLATED" if g.violated_after
                        else "NO-ACTION" if not g.iterations else "FIXED"),
             "clusterModelStats": cluster_model_stats_json(res.stats_after),
             **({"optimizationTimeMs": int(g.duration_s * 1000)}
                if res.durations_measured else {})}
            for g in res.goal_results
        ],
        "proposals": [p.to_json() for p in res.proposals],
    }
    env = getattr(res, "env", None)
    st = getattr(res, "final_state", None)
    meta = getattr(res, "meta", None)
    if env is not None and st is not None and meta is not None:
        out["loadAfterOptimization"] = broker_stats_from_state(env, st, meta)
    return wrap(out)


def broker_tallies(ct, device="cuda") -> dict:
    """Host numpy copies of ``ct``'s per-broker tallies (the reference's
    ``broker_utilization``, ``broker_leader_utilization``,
    ``potential_leader_load``, ``broker_replica_count``,
    ``broker_leader_count`` and ``broker_disk_utilization``), summed on
    ``device`` by K4/K5 in replica order."""
    import torch

    from cruise_control_tpu_torch.analyzer.env import resolve_device
    from cruise_control_tpu_torch.kernels import segment_count, segment_sum
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype).contiguous()

    rb = t(ct.replica_broker, torch.int64)
    valid = t(ct.replica_valid, torch.bool)
    lead = t(ct.replica_is_leader, torch.bool)
    leader_load = t(ct.leader_load, torch.float32)
    follower_load = t(ct.follower_load, torch.float32)
    B, D = ct.num_brokers, ct.broker_disk_capacity.shape[1]
    zero = torch.zeros_like(leader_load)
    eff = torch.where(valid[:, None], torch.where(lead[:, None], leader_load,
                                                  follower_load), zero)
    util = segment_sum(eff.contiguous(), rb, B)
    lead_util = segment_sum(torch.where((lead & valid)[:, None], leader_load,
                                        zero).contiguous(), rb, B)
    pot = segment_sum(torch.where(valid[:, None], leader_load, zero).contiguous(),
                      rb, B)
    nrep = segment_count(rb, B, valid.to(torch.int32))
    nlead = segment_count(rb, B, (valid & lead).to(torch.int32))
    flat = rb * D + t(ct.replica_disk, torch.int64)
    disk = segment_sum(eff[:, Resource.DISK:Resource.DISK + 1].contiguous(), flat,
                       B * D).view(B, D)

    def host(x):
        return x.detach().cpu().numpy()

    return {"util": host(util), "lead_util": host(lead_util), "pot": host(pot),
            "nrep": host(nrep), "nlead": host(nlead), "disk": host(disk)}


def broker_stats_json(ct, meta, populate_disk_info: bool = False,
                      capacity_only: bool = False, device="cuda") -> dict:
    """GET /load body (response/stats/BrokerStats.java role) from a
    ClusterTensor; the tallies are summed on ``device``."""
    cap = np.asarray(ct.broker_capacity, dtype=np.float64)
    alive = np.asarray(ct.broker_alive)
    disk_util = None
    if capacity_only:
        util = np.zeros_like(cap)
        lead_util = util
        pnw = np.zeros(cap.shape[0])
        nrep = np.zeros(cap.shape[0], dtype=np.int64)
        nlead = nrep
    else:
        tal = broker_tallies(ct, device)
        util = tal["util"].astype(np.float64)
        lead_util = tal["lead_util"].astype(np.float64)
        pnw = tal["pot"].astype(np.float64)[:, Resource.NW_OUT]
        nrep, nlead = tal["nrep"], tal["nlead"]
        if populate_disk_info:
            disk_util = tal["disk"].astype(np.float64)
    disk_cap = np.asarray(ct.broker_disk_capacity, dtype=np.float64)
    return _broker_stats_rows(meta, cap, alive, np.asarray(ct.broker_rack),
                              util, lead_util, pnw, nrep, nlead,
                              disk_cap=disk_cap, disk_util=disk_util)


def partition_state_json(topic: str, partition: int, leader: int,
                         replicas: list, in_sync: list, offline: list) -> dict:
    """servlet/response/PartitionState.java field set."""
    return {
        "topic": topic,
        "partition": partition,
        "leader": leader,
        "replicas": replicas,
        "in-sync": in_sync,
        "out-of-sync": [b for b in replicas if b not in in_sync],
        "offline": offline,
    }


def kafka_cluster_state_json(brokers: dict, partitions: dict,
                             min_insync: int = 1,
                             verbose: bool = False) -> dict:
    """servlet/response/KafkaClusterState.java parity:
    KafkaBrokerState = per-broker-id count maps + logdir maps
    (ClusterBrokerState.java field set), KafkaPartitionState = partition
    rows bucketed into offline / with-offline-replicas / urp /
    under-min-isr (+ other when verbose)."""
    leader_count: dict = {}
    replica_count: dict = {}
    offline_count: dict = {}
    out_of_sync_count: dict = {}
    online_logdirs: dict = {}
    offline_logdirs: dict = {}
    for b, node in brokers.items():
        leader_count[str(b)] = 0
        replica_count[str(b)] = 0
        offline_count[str(b)] = 0
        out_of_sync_count[str(b)] = 0
        lds = list(node.logdirs) or ["/logdir0"]
        dead = set(node.dead_logdirs)
        online_logdirs[str(b)] = [ld for ld in lds if ld not in dead]
        offline_logdirs[str(b)] = [ld for ld in lds if ld in dead]

    p_offline, p_with_offline, p_urp, p_under_min_isr, p_other = [], [], [], [], []
    for (t, p), info in partitions.items():
        alive_replicas = [b for b in info.replicas
                          if b in brokers and brokers[b].alive]
        offline_replicas = [b for b in info.replicas
                            if b not in alive_replicas]
        # in-sync set: backend-reported ISR when available, else the alive
        # replicas (the sim backend has no replication lag concept)
        isr = [b for b in getattr(info, "isr", None) or alive_replicas
               if b in alive_replicas]
        out_of_sync = [b for b in info.replicas if b not in isr]
        for b in info.replicas:
            if str(b) in replica_count:
                replica_count[str(b)] += 1
        if info.leader in brokers:
            leader_count[str(info.leader)] += 1
        for b in offline_replicas:
            if str(b) in offline_count:
                offline_count[str(b)] += 1
        for b in out_of_sync:
            if str(b) in out_of_sync_count:
                out_of_sync_count[str(b)] += 1
        row = partition_state_json(t, p, info.leader, list(info.replicas),
                                   isr, offline_replicas)
        if info.leader < 0 or not alive_replicas:
            p_offline.append(row)
        elif offline_replicas:
            p_with_offline.append(row)
        elif len(isr) < len(info.replicas):
            p_urp.append(row)
        elif len(isr) < min_insync:
            p_under_min_isr.append(row)
        elif verbose:
            p_other.append(row)

    partition_state = {
        "offline": p_offline,
        "with-offline-replicas": p_with_offline,
        "urp": p_urp,
        "under-min-isr": p_under_min_isr,
    }
    if verbose:
        partition_state["other"] = p_other
    return wrap({
        "KafkaBrokerState": {
            "LeaderCountByBrokerId": leader_count,
            "ReplicaCountByBrokerId": replica_count,
            "OutOfSyncCountByBrokerId": out_of_sync_count,
            "OfflineReplicaCountByBrokerId": offline_count,
            "OnlineLogDirsByBrokerId": online_logdirs,
            "OfflineLogDirsByBrokerId": offline_logdirs,
            "IsController": {str(b): False for b in brokers},
            "Summary": {
                "Brokers": len(brokers),
                "Topics": len({t for t, _ in partitions}),
                "Replicas": sum(len(i.replicas) for i in partitions.values()),
                "Leaders": sum(1 for i in partitions.values()
                               if i.leader >= 0),
            },
        },
        "KafkaPartitionState": partition_state,
    })


def partition_load_records_json(rows: list) -> dict:
    """servlet/response/PartitionLoadState.java parity: {"records": [...]}
    with per-record fields topic/partition/leader/followers + the four
    Resource JSON names + msg_in."""
    return wrap({"records": [
        {
            "topic": r["topic"], "partition": r["partition"],
            "leader": r["leader"], "followers": r.get("followers", []),
            "cpu": r.get("cpu", 0.0),
            "networkInbound": r.get("networkInbound", 0.0),
            "networkOutbound": r.get("networkOutbound", 0.0),
            "disk": r.get("disk", 0.0),
            "msg_in": r.get("msg_in", 0.0),
        } for r in rows
    ]})
