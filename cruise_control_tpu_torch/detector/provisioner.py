"""The provision recommendation of an optimization result (counterpart of
``cruise_control_tpu/detector/provisioner.py``, the part the optimizer
reads).

Reference: detector/Provisioner.java and the ProvisionRecommendation /
ProvisionStatus model (UNDER_PROVISIONED / RIGHT_SIZED / OVER_PROVISIONED).
``GoalOptimizer.optimizations`` attaches ``recommendation_from_result`` to
the ``OptimizationFailureError`` of a hard-goal failure, as the reference's
OptimizationFailureException carries one; ``ProvisionFloors.from_config``
reads the floors' ``overprovisioned.*`` keys. The provisioner SPI
(``NoopProvisioner``, and ``SimulatedProvisioner``, which resizes a
simulated backend) is the one the facade's ``provisioner.class`` resolves.
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


class NoopProvisioner:
    def configure(self, config, **extra):
        pass

    def rightsize(self, recommendations: list, context: dict | None = None) -> bool:
        """Returns True if any action was taken (never, for noop)."""
        return False


class SimulatedProvisioner:
    """Actuating Provisioner for simulated backends.

    The reference ships the SPI plus NoopProvisioner and leaves real
    actuation to deployment plugins (a cloud autoscaler behind
    ``Provisioner.rightsize``). Against a SimulatedClusterBackend the loop
    can be closed for real: UNDER_PROVISIONED adds brokers to the backend
    (rack chosen to balance the existing rack layout, capacities cloned from
    an existing broker), OVER_PROVISIONED drains the emptiest high-id brokers
    through the facade and decommissions them. Every actuation lands in
    ``history`` (on the backend clock) so scenario timelines and chaos
    campaigns can assert the detect -> rightsize -> actuate -> re-converge
    chain deterministically.

    Guard rails: a cooldown between actuations (``provision.actuation.
    cooldown.ms`` — a detector re-asserting UNDER before the resize has
    effect must not add again) and a lifetime add cap (``provision.max.
    added.brokers`` — also keeps sim clusters inside their padded engine
    shape bucket). Actuation is skipped while a proposal execution is in
    flight: resizing under a moving cluster is how real autoscalers cause
    outages.
    """

    def __init__(self):
        self._backend = None
        self._cc = None
        self.cooldown_ms = 600_000.0
        self.max_added_brokers = 4
        self.num_added = 0
        self.history: list[dict] = []
        self._last_action_ms = -1e18

    def configure(self, config, backend=None, cruise_control=None, **extra):
        if backend is not None:
            self._backend = backend
        if cruise_control is not None:
            self._cc = cruise_control
        # the app wiring reads the keys once and hands them down; direct
        # construction (tests/tools) may pass a config instead
        if "actuation_cooldown_ms" in extra:
            self.cooldown_ms = float(extra["actuation_cooldown_ms"])
        elif config is not None:
            self.cooldown_ms = float(config.get_int(
                "provision.actuation.cooldown.ms"))
        if "max_added_brokers" in extra:
            self.max_added_brokers = int(extra["max_added_brokers"])
        elif config is not None:
            self.max_added_brokers = config.get_int(
                "provision.max.added.brokers")

    # ------------------------------------------------------------------ SPI
    def rightsize(self, recommendations: list, context: dict | None = None) -> bool:
        be = self._backend
        if be is None or not hasattr(be, "add_broker"):
            return False
        now = float(be.now_ms())
        if now - self._last_action_ms < self.cooldown_ms:
            return False
        cc = self._cc
        if cc is not None and cc.executor.has_ongoing_execution():
            return False
        acted = False
        for rec in recommendations:
            if rec.status is ProvisionStatus.UNDER_PROVISIONED:
                acted = self._add_brokers(rec, now) or acted
            elif rec.status is ProvisionStatus.OVER_PROVISIONED:
                acted = self._remove_brokers(rec, now) or acted
        if acted:
            self._last_action_ms = now
        return acted

    # ------------------------------------------------------------ actuation
    def _add_brokers(self, rec: "ProvisionRecommendation", now: float) -> bool:
        be = self._backend
        brokers = be.brokers()
        n = min(max(rec.num_brokers, 1),
                self.max_added_brokers - self.num_added)
        if n <= 0 or not brokers:
            return False
        # clone the lowest-id alive broker's hardware shape; place each new
        # broker on the currently least-populated rack (ties by rack name) so
        # rack-aware goals stay satisfiable as the cluster grows
        template_id = min(b for b, node in brokers.items() if node.alive)
        template = brokers[template_id]
        rack_counts: dict[str, int] = {}
        for node in brokers.values():
            rack_counts[node.rack] = rack_counts.get(node.rack, 0) + 1
        next_id = max(brokers) + 1
        for i in range(n):
            rack = min(sorted(rack_counts), key=lambda r: rack_counts[r])
            be.add_broker(next_id + i, rack=rack,
                          logdirs=dict(template.logdirs),
                          cpu_capacity=template.cpu_capacity,
                          nw_in_capacity=template.nw_in_capacity,
                          nw_out_capacity=template.nw_out_capacity)
            rack_counts[rack] += 1
            self.history.append({"ms": now, "action": "add_broker",
                                 "broker": next_id + i, "rack": rack,
                                 "reason": rec.reason})
        self.num_added += n
        return True

    def _remove_brokers(self, rec: "ProvisionRecommendation", now: float) -> bool:
        be = self._backend
        brokers = be.brokers()
        counts = {b: 0 for b, node in brokers.items() if node.alive}
        for info in be.partitions().values():
            for b in info.replicas:
                if b in counts:
                    counts[b] += 1
        # emptiest first, highest id breaking ties (scale-down retires the
        # newest hardware first)
        candidates = sorted(counts, key=lambda b: (counts[b], -b))
        n = max(rec.num_brokers, 1)
        acted = False
        for b in candidates[:n]:
            if counts[b] > 0:
                if self._cc is None:
                    continue
                # drain through the same facade path operators use; any
                # failure (unsatisfiable evacuation) simply leaves the broker
                self._cc.remove_brokers(
                    [b], reason=f"provisioner right-size: {rec.reason}")
                if any(b in info.replicas
                       for info in be.partitions().values()):
                    continue
            be.decommission_broker(b)
            self.history.append({"ms": now, "action": "remove_broker",
                                 "broker": b, "reason": rec.reason})
            acted = True
        return acted


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
