"""The provision recommendation of an optimization result (counterpart of
``cruise_control_tpu/detector/provisioner.py``, the part the optimizer
reads).

Reference: detector/Provisioner.java and the ProvisionRecommendation /
ProvisionStatus model (UNDER_PROVISIONED / RIGHT_SIZED / OVER_PROVISIONED).
``GoalOptimizer.optimizations`` attaches ``recommendation_from_result`` to
the ``OptimizationFailureError`` of a hard-goal failure, as the reference's
OptimizationFailureException carries one; ``ProvisionFloors.from_config``
reads the floors' ``overprovisioned.*`` keys. The provisioner SPI itself
(``NoopProvisioner``, ``SimulatedProvisioner``) is ROADMAP.md Queue 1 item
12.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource


class ProvisionStatus(enum.Enum):
    UNDER_PROVISIONED = "UNDER_PROVISIONED"
    RIGHT_SIZED = "RIGHT_SIZED"
    OVER_PROVISIONED = "OVER_PROVISIONED"
    UNDECIDED = "UNDECIDED"


@dataclasses.dataclass
class ProvisionRecommendation:
    status: ProvisionStatus
    num_brokers: int = 0
    reason: str = ""

    def to_json(self) -> dict:
        return {"status": self.status.value, "numBrokers": self.num_brokers,
                "reason": self.reason}


@dataclasses.dataclass
class ProvisionFloors:
    """Right-sizing floors an OVER_PROVISIONED recommendation must respect
    (AnomalyDetectorConfig overprovisioned.*): never below ``min_brokers``,
    below ``min_extra_racks`` spare racks beyond the max partition RF, or
    past the point where the average replica count per remaining broker
    exceeds ``max_replicas_per_broker``."""
    min_brokers: int = 3
    min_extra_racks: int = 1
    max_replicas_per_broker: int = 1500

    @classmethod
    def from_config(cls, cfg) -> "ProvisionFloors":
        return cls(
            min_brokers=cfg.get_int("overprovisioned.min.brokers"),
            min_extra_racks=cfg.get_int("overprovisioned.min.extra.racks"),
            max_replicas_per_broker=int(cfg.get_int(
                "overprovisioned.max.replicas.per.broker")))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def recommendation_from_result(res, constraint,
                               floors: ProvisionFloors | None = None,
                               ) -> ProvisionRecommendation:
    """Capacity-math provision recommendation from an ``OptimizerResult``
    (GoalViolationDetector.java:228 -> Provisioner.rightsize, and the
    recommendation the capacity goals attach to OptimizationFailureException):
    per resource, total load against total allowed capacity decides how many
    brokers of average capacity are missing (or spare). Host numpy on the
    result's final tallies, in the reference's own arithmetic."""
    env, st = res.env, res.final_state
    alive = _host(env.broker_alive)
    if not alive.any():
        return ProvisionRecommendation(ProvisionStatus.UNDER_PROVISIONED,
                                       num_brokers=1, reason="no alive brokers")
    util = _host(st.util)[alive]                             # [B, M]
    cap = _host(env.broker_capacity)[alive]
    thresh = np.asarray(constraint.capacity_threshold)
    total_load = util.sum(axis=0)
    avg_cap = cap.mean(axis=0)
    allowed = (cap * thresh[None, :]).sum(axis=0)
    deficit = total_load - allowed                           # [M] > 0: missing
    if (deficit > 0).any():
        r = int(np.argmax(deficit / np.maximum(avg_cap * thresh, 1e-9)))
        need = math.ceil(deficit[r] / max(avg_cap[r] * thresh[r], 1e-9))
        return ProvisionRecommendation(
            ProvisionStatus.UNDER_PROVISIONED, num_brokers=max(1, need),
            reason=f"{Resource(r).name} load {total_load[r]:.1f} exceeds "
                   f"allowed capacity {allowed[r]:.1f}: add >= {max(1, need)} "
                   f"broker(s) of average capacity")
    offline = res.stats_after.get("num_offline_replicas", 0)
    if offline or any(g.violated_after for g in res.goal_results
                      if g.name.endswith("CapacityGoal")):
        return ProvisionRecommendation(
            ProvisionStatus.UNDER_PROVISIONED, num_brokers=1,
            reason="capacity goals unsatisfiable despite aggregate headroom "
                   "(placement infeasibility)")
    low = np.asarray(constraint.low_utilization_threshold)
    n = int(alive.sum())
    active = low > 0
    if active.any() and n > 1:
        avg_util_frac = total_load / np.maximum(cap.sum(axis=0), 1e-9)
        if (avg_util_frac[active] < low[active]).all():
            floors = floors or ProvisionFloors()
            # brokers removable while every resource stays under its allowed
            # aggregate capacity and the overprovisioned.* floors hold
            valid = _host(env.replica_valid)
            n_replicas = int(valid.sum())
            keep_floor = max(
                1, floors.min_brokers,
                math.ceil(n_replicas / max(floors.max_replicas_per_broker, 1)))
            keep = n
            while keep > keep_floor and (
                    total_load <= avg_cap * thresh * (keep - 1) - 1e-9).all():
                keep -= 1
            # min.extra.racks: keep the racks that host the max partition RF
            # plus the extra racks' worth of brokers
            racks_alive = _host(env.broker_rack)[alive]
            num_racks = len(np.unique(racks_alive))
            if num_racks > 0:
                parts = _host(env.replica_partition)[valid]
                max_rf = int(np.bincount(parts).max()) if parts.size else 1
                per_rack = n / num_racks
                min_racks = min(num_racks, max_rf + floors.min_extra_racks)
                keep = max(keep, math.ceil(min_racks * per_rack))
            if keep < n:
                return ProvisionRecommendation(
                    ProvisionStatus.OVER_PROVISIONED, num_brokers=n - keep,
                    reason=f"{n - keep} broker(s) removable under the "
                           f"low-utilization thresholds (floors: "
                           f">={keep_floor} brokers)")
    return ProvisionRecommendation(ProvisionStatus.RIGHT_SIZED)
