"""Response schema renderers (counterpart of
``cruise_control_tpu/api/responses.py``): the part the facade's operation
results render, ``optimization_result_json`` with its ``ClusterModelStats``
and post-optimization ``BrokerStats``. The other bodies (``/load``,
``/kafka_cluster_state``, ``/partition_load``) and the REST server are ROADMAP
Queue 1 item 12.

Reference: servlet/response/ (23 classes). Every JSON body carries a
``version`` field (servlet/response/JsonResponseField.java convention).
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
