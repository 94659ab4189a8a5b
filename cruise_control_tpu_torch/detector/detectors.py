"""(Counterpart of ``cruise_control_tpu/detector/detectors.py``, with the port's imports.)
Core anomaly detectors.

Reference:
- GoalViolationDetector.java:72-254 — re-runs detection goals on a fresh
  cluster model, records fixable/unfixable violations, computes balancedness +
  provision status, triggers Provisioner.rightsize.
- BrokerFailureDetector.java:52-123 — ZooKeeper child watch on /brokers/ids
  with persisted failure times; here a metadata poll against the backend
  (the SPI boundary) with the same persisted-failure-time contract.
- DiskFailureDetector.java (117) — describeLogDirs -> offline logdirs.
- SlowBrokerFinder.java (478) — log-flush-time vs byte-rate percentile
  heuristics; repeated offenders escalate demote -> remove.
"""
from __future__ import annotations

import json
import os

import numpy as np

from cruise_control_tpu_torch.detector.anomalies import (
    AnomalyType, BrokerFailures, DiskFailures, GoalViolations,
    PredictedGoalViolations, SlowBrokers,
)
from cruise_control_tpu_torch.detector.provisioner import (
    ProvisionRecommendation, ProvisionStatus,
)


class GoalViolationDetector:
    def __init__(self, goal_optimizer, load_monitor, detection_goals: list,
                 provisioner=None, provision_floors=None, sensors=None,
                 anomaly_cls=GoalViolations,
                 allow_capacity_estimation: bool = True,
                 session_supplier=None, admission_sink=None):
        self._optimizer = goal_optimizer
        self._monitor = load_monitor
        self._goals = list(detection_goals)
        self._provisioner = provisioner
        self._provision_floors = provision_floors  # overprovisioned.* floors
        # optional (reason, now_ms) -> None: a FIXABLE verdict enqueues a
        # heal-lane request on the fleet admission engine, so the fix's
        # proposal refresh preempts queued hygiene/background work
        self._admission_sink = admission_sink
        # goal.violations.class: pluggable anomaly materialization
        self._anomaly_cls = anomaly_cls
        self._allow_capacity_estimation = allow_capacity_estimation
        # optional () -> ResidentClusterSession | None: with a synced resident
        # session the detection round rides the PR 16 IncrementalCarryover
        # machinery — a zero-churn re-check re-serves the carried verdicts
        # after one compiled violation re-validation instead of re-running
        # the full goal chain (the CHECK-verdict fast path)
        self._session_supplier = session_supplier
        self.last_balancedness: float = 100.0
        self.last_provision: ProvisionRecommendation | None = None
        if sensors is not None:
            # Sensors.md catalog: balancedness-score + under/over-provisioned
            # gauges, goal-violation-detection-timer (GoalViolationDetector.java:93)
            sensors.gauge("balancedness-score", lambda: self.last_balancedness)
            sensors.gauge(
                "provision-status",
                lambda: (self.last_provision.status.value
                         if self.last_provision else "RIGHT_SIZED"))
            self._detection_timer = sensors.timer("goal-violation-detection-timer")
        else:
            from cruise_control_tpu_torch.common.sensors import Timer
            self._detection_timer = Timer()

    def run_once(self, now_ms: float) -> list:
        with self._detection_timer.time():
            return self._run_once(now_ms)

    def _run_once(self, now_ms: float) -> list:
        from cruise_control_tpu_torch.analyzer.env import OptimizationOptions
        from cruise_control_tpu_torch.monitor.load_monitor import NotEnoughValidWindowsError
        # A synced resident session (when wired) both skips the model
        # rebuild AND makes repeated detection rounds memo-eligible: same
        # goal chain + same options = stable chain_key, so a zero-churn
        # re-check returns the PR 16 revalidated carryover after one
        # compiled violation re-validation instead of a full chain run.
        session = None
        ct = meta = None
        try:
            if self._session_supplier is not None:
                session = self._session_supplier()
            if session is None:
                ct, meta = self._monitor.cluster_model(
                    allow_capacity_estimation=self._allow_capacity_estimation)
        except NotEnoughValidWindowsError:
            return []   # not enough data yet — detector skips this round
        # raise_on_failure=False: the detector *assesses* violations — an
        # unsatisfiable hard goal is a detection outcome, not an error
        res = self._optimizer.optimizations(
            ct, meta, goal_names=self._goals,
            options=OptimizationOptions(triggered_by_goal_violation=True),
            skip_hard_goal_check=True, raise_on_failure=False,
            session=session)
        self.last_balancedness = res.balancedness_before
        fixable = [g.name for g in res.goal_results
                   if g.violated_before and not g.violated_after]
        unfixable = [g.name for g in res.goal_results
                     if g.violated_before and g.violated_after]
        if self._provisioner is not None:
            from cruise_control_tpu_torch.detector.provisioner import (
                recommendation_from_result,
            )
            rec = recommendation_from_result(res, self._optimizer.constraint,
                                             floors=self._provision_floors)
            self.last_provision = rec
            if rec.status is not ProvisionStatus.RIGHT_SIZED:
                # GoalViolationDetector.java:228: the verdict flows straight
                # into Provisioner.rightsize — an actuating provisioner
                # resizes the cluster here, mid-detection-round
                self._provisioner.rightsize(
                    [rec], context={"now_ms": now_ms,
                                    "balancedness": res.balancedness_before})
        if not fixable and not unfixable:
            return []
        if fixable and self._admission_sink is not None:
            self._admission_sink(f"goal violation: {','.join(fixable)}",
                                 now_ms)
        return [self._anomaly_cls(
            anomaly_type=AnomalyType.GOAL_VIOLATION, detected_ms=now_ms,
            violated_goals_fixable=fixable, violated_goals_unfixable=unfixable,
            fixable=bool(fixable),
            description=f"violated goals fixable={fixable} unfixable={unfixable}")]


class PredictedGoalViolationDetector:
    """Pre-breach goal-violation detection (docs/DESIGN.md §21).

    Each round: read the forecaster's horizon-ahead projection; when it
    predicts rising load AND the current state is still clean, materialize a
    forecast-horizon model (the current ClusterTensor with per-partition
    load rows scaled by the predicted forecast/current ratios) and run the
    SAME detection goal chain against it. A violation on the projected state
    — none on the current one — emits a PREDICTED verdict carrying the
    optimizer's precomputed heal, which the manager schedules through the
    normal verdict-span -> operation -> pipeline execute path BEFORE the
    breach exists.

    Steady path (no predicted rise, or the forecast generation already
    handled): returns after one memoized forecast read — no model build, no
    optimizer work, zero new compiles."""

    def __init__(self, goal_optimizer, load_monitor, forecaster,
                 detection_goals: list, sensors=None,
                 allow_capacity_estimation: bool = True,
                 admission_sink=None):
        self._optimizer = goal_optimizer
        self._monitor = load_monitor
        self._forecaster = forecaster
        # optional (reason, now_ms) -> None: PREDICTED verdicts pre-position
        # a heal-lane request on the fleet admission engine (see
        # GoalViolationDetector)
        self._admission_sink = admission_sink
        self._goals = list(detection_goals)
        self._allow_capacity_estimation = allow_capacity_estimation
        self.predictions = 0           # PREDICTED verdicts emitted
        self.rounds = 0
        self.last_predicted: list = []
        self._last_emitted_gen = None  # one verdict per forecast generation
        if sensors is not None:
            sensors.gauge("predicted-goal-violations", lambda: self.predictions)
            self._detection_timer = sensors.timer(
                "predicted-goal-violation-detection-timer")
        else:
            from cruise_control_tpu_torch.common.sensors import Timer
            self._detection_timer = Timer()

    def run_once(self, now_ms: float) -> list:
        with self._detection_timer.time():
            return self._run_once(now_ms)

    @staticmethod
    def forecast_scaled(ct, meta, fres):
        """The forecast-horizon model: ``ct`` with every replica's load rows
        scaled by its partition's predicted per-resource ratio. Topology,
        capacities and leadership are untouched — the projection moves load,
        not metadata."""
        import dataclasses as _dc
        P = ct.num_partitions
        scale_p = np.ones((P, ct.leader_load.shape[1]))
        row_of = {e: i for i, e in enumerate(fres.entities)}
        for pi, tp in enumerate(meta.partition_ids):
            r = row_of.get(tp)
            if r is not None:
                scale_p[pi] = fres.scale[r]
        rep_scale = scale_p[np.asarray(ct.replica_partition)].astype(np.float32)
        return _dc.replace(
            ct,
            leader_load=np.asarray(ct.leader_load) * rep_scale,
            follower_load=np.asarray(ct.follower_load) * rep_scale)

    def _run_once(self, now_ms: float) -> list:
        from cruise_control_tpu_torch.analyzer.env import OptimizationOptions
        from cruise_control_tpu_torch.monitor.load_monitor import NotEnoughValidWindowsError
        self.rounds += 1
        fres = self._forecaster.forecast()
        if fres is None or not fres.rising:
            return []    # steady path: memoized forecast read, nothing else
        if fres.generation == self._last_emitted_gen:
            return []    # this forecast generation already produced a verdict
        try:
            ct, meta = self._monitor.cluster_model(
                allow_capacity_estimation=self._allow_capacity_estimation)
        except NotEnoughValidWindowsError:
            return []
        options = OptimizationOptions(triggered_by_goal_violation=True)
        # pre-breach guard: an ALREADY-violated state belongs to the reactive
        # detector — predicting what exists would double-heal
        if self._optimizer.violated_goals(ct, meta, self._goals, options):
            return []
        res = self._optimizer.optimizations(
            self.forecast_scaled(ct, meta, fres), meta,
            goal_names=self._goals, options=options,
            skip_hard_goal_check=True, raise_on_failure=False)
        fixable = [g.name for g in res.goal_results
                   if g.violated_before and not g.violated_after]
        unfixable = [g.name for g in res.goal_results
                     if g.violated_before and g.violated_after]
        self.last_predicted = fixable + unfixable
        if not fixable and not unfixable:
            return []
        self._last_emitted_gen = fres.generation
        self.predictions += 1
        if fixable and self._admission_sink is not None:
            self._admission_sink(
                f"predicted violation: {','.join(fixable)}", now_ms)
        return [PredictedGoalViolations(
            anomaly_type=AnomalyType.PREDICTED_GOAL_VIOLATION,
            detected_ms=now_ms,
            violated_goals_fixable=fixable, violated_goals_unfixable=unfixable,
            optimizer_result=res, forecast_generation=fres.generation,
            horizon_ms=fres.horizon_ms, fixable=bool(fixable),
            description=(f"predicted violation within {fres.horizon_ms} ms: "
                         f"fixable={fixable} unfixable={unfixable}"))]

    def state_json(self) -> dict:
        return {"rounds": self.rounds, "predictions": self.predictions,
                "lastPredicted": list(self.last_predicted)}


class BrokerFailureDetector:
    """Polls broker liveness; persists first-failure times so a restart does
    not reset the self-healing grace clock (BrokerFailureDetector.java:119-123
    persists to a znode; here a JSON file)."""

    def __init__(self, backend, persist_path: str = "",
                 anomaly_cls=BrokerFailures):
        self._backend = backend
        self._persist_path = persist_path
        self._anomaly_cls = anomaly_cls   # broker.failures.class
        self._failure_ms: dict[int, float] = {}
        self._load()

    def _load(self):
        if self._persist_path and os.path.exists(self._persist_path):
            try:
                with open(self._persist_path) as f:
                    self._failure_ms = {int(k): v for k, v in json.load(f).items()}
            except (json.JSONDecodeError, OSError):
                self._failure_ms = {}

    def _save(self):
        if self._persist_path:
            with open(self._persist_path, "w") as f:
                json.dump(self._failure_ms, f)

    def run_once(self, now_ms: float) -> list:
        brokers = self._backend.brokers()
        dead = {b for b, node in brokers.items() if not node.alive}
        # new failures get stamped; revived brokers are cleared
        changed = False
        for b in dead:
            if b not in self._failure_ms:
                self._failure_ms[b] = now_ms
                changed = True
        for b in list(self._failure_ms):
            if b not in dead:
                del self._failure_ms[b]
                changed = True
        if changed:
            self._save()
        if not self._failure_ms:
            return []
        return [self._anomaly_cls(
            anomaly_type=AnomalyType.BROKER_FAILURE, detected_ms=now_ms,
            failed_brokers=dict(self._failure_ms),
            description=f"failed brokers: {sorted(self._failure_ms)}")]


class DiskFailureDetector:
    def __init__(self, backend, anomaly_cls=DiskFailures):
        self._backend = backend
        self._anomaly_cls = anomaly_cls   # disk.failures.class

    def run_once(self, now_ms: float) -> list:
        logdirs = self._backend.describe_logdirs()
        brokers = self._backend.brokers()
        failed: dict[int, list] = {}
        for b, dirs in logdirs.items():
            if not brokers[b].alive:
                continue   # dead broker is a broker failure, not a disk failure
            bad = [ld for ld, ok in dirs.items() if not ok]
            if bad:
                failed[b] = bad
        if not failed:
            return []
        return [self._anomaly_cls(
            anomaly_type=AnomalyType.DISK_FAILURE, detected_ms=now_ms,
            failed_disks=failed,
            description=f"failed disks: {failed}")]


class SlowBrokerFinder:
    """Percentile heuristic: a broker is slow when its log-flush time is far
    above the cluster percentile while its byte rate is not (so it's slow, not
    just busy). Repeated detection escalates: score >= demotion_score ->
    demote; >= decommission_score -> remove (SlowBrokerFinder.java:478)."""

    def __init__(self, flush_time_threshold_ms: float = 1000.0,
                 bytes_rate_threshold: float = 1024.0,
                 demotion_score: int = 5, decommission_score: int = 50,
                 unfixable_ratio: float = 0.1):
        self.flush_time_threshold_ms = flush_time_threshold_ms
        self.bytes_rate_threshold = bytes_rate_threshold
        self.demotion_score = demotion_score
        self.decommission_score = decommission_score
        # slow.broker.self.healing.unfixable.ratio
        # (SlowBrokerFinder.java:105-132): when more than this fraction of
        # the cluster looks slow, the cause is almost surely external —
        # report the anomaly unfixable (alert-only), never demote/remove
        self.unfixable_ratio = unfixable_ratio
        self._scores: dict[int, int] = {}

    def configure(self, config, **extra):
        if config is not None:
            self.flush_time_threshold_ms = config.get_double(
                "slow.broker.log.flush.time.threshold.ms")
            self.bytes_rate_threshold = config.get_double(
                "slow.broker.bytes.rate.detection.threshold")
            self.demotion_score = config.get_int("slow.broker.demotion.score")
            self.decommission_score = config.get_int("slow.broker.decommission.score")
            self.unfixable_ratio = config.get_double(
                "slow.broker.self.healing.unfixable.ratio")

    def run_once(self, broker_metrics: dict, now_ms: float) -> list:
        """broker_metrics: broker -> {metric: value} (latest).

        The slow screen runs over a dense ``[brokers x 2]`` array
        (flush-time 999th, byte-in rate): one densify pass, then the
        percentile and both comparisons in numpy — the only remaining
        python-loop state is the (sparse) escalation-score dict, so the
        per-round cost stays flat at 7k brokers."""
        if not broker_metrics:
            return []
        ids = list(broker_metrics)
        vals = np.empty((len(ids), 2), dtype=np.float64)
        for i, m in enumerate(broker_metrics.values()):
            vals[i, 0] = m.get("BROKER_LOG_FLUSH_TIME_MS_999TH", 0.0)
            vals[i, 1] = m.get("ALL_TOPIC_BYTES_IN", 0.0)
        rate_cut = max(self.bytes_rate_threshold, float(np.median(vals[:, 1])))
        mask = (vals[:, 0] > self.flush_time_threshold_ms) \
            & (vals[:, 1] < rate_cut)
        slow_now = {ids[i] for i in np.flatnonzero(mask)}
        n_reporting = len(ids)
        for b in list(self._scores):
            if b not in slow_now:
                self._scores[b] = max(0, self._scores[b] - 1)
                if self._scores[b] == 0:
                    del self._scores[b]
        for b in slow_now:
            self._scores[b] = self._scores.get(b, 0) + 1
        to_remove = {b: s for b, s in self._scores.items()
                     if s >= self.decommission_score}
        to_demote = {b: s for b, s in self._scores.items()
                     if self.demotion_score <= s < self.decommission_score}
        fixable = (len(to_remove) + len(to_demote)
                   <= self.unfixable_ratio * max(n_reporting, 1))
        out = []
        if to_remove:
            out.append(SlowBrokers(anomaly_type=AnomalyType.METRIC_ANOMALY,
                                   detected_ms=now_ms, slow_brokers=to_remove,
                                   remove=True, fixable=fixable,
                                   description=f"slow brokers to remove: {sorted(to_remove)}"
                                   + ("" if fixable else " (unfixable: ratio exceeded)")))
        if to_demote:
            out.append(SlowBrokers(anomaly_type=AnomalyType.METRIC_ANOMALY,
                                   detected_ms=now_ms, slow_brokers=to_demote,
                                   remove=False, fixable=fixable,
                                   description=f"slow brokers to demote: {sorted(to_demote)}"
                                   + ("" if fixable else " (unfixable: ratio exceeded)")))
        return out
