"""CruiseControl facade: the one object wiring every layer together
(counterpart of ``cruise_control_tpu/app.py``).

The port's facade runs on an explicit device: ``CruiseControl(backend,
config=None, device="cuda")`` hands ``device`` to the ``GoalOptimizer``, the
resident session and the forecaster (``device="cpu"`` runs the kernels'
plain twins, for the tests); "cuda" without a card raises. It resolves the
class-valued config keys to the port's classes (``config.configdef.
resolve_class``). It serves one cluster, alone or as a tenant of a
``fleet.FleetScheduler`` (``cluster_id``; the scheduler sets
``fleet_request_sink``, through which the goal-violation detectors enqueue
heal-lane requests). A ``pipeline.PipelinedServiceLoop`` may drive it
(``service_pipeline``): its threaded mode takes the self-healing FIX
executions (``service.pipeline.route.fixes``). An HA role raises
``NotImplementedError`` naming ROADMAP Queue 1 item 14, as does a configured
sample store (item 11, the rest).

Reference: KafkaCruiseControl.java:73 (866) — constructs AdminClient ->
AnomalyDetectorManager -> Executor -> LoadMonitor -> GoalOptimizer
(:105-119), and every REST/self-healing operation flows through it
(rebalance, add/remove/demote brokers, fix offline replicas, topic RF fix,
pause/resume sampling, state). ``start_up()`` starts the monitor replay,
anomaly detection and (host-side) proposal precompute
(KafkaCruiseControl.java:201-207).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np

from cruise_control_tpu_torch.analyzer.env import OptimizationOptions
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer, OptimizerResult
from cruise_control_tpu_torch.config.defaults import cruise_control_config, effective_default_goals
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector, DiskFailureDetector, GoalViolationDetector,
    PredictedGoalViolationDetector, SlowBrokerFinder,
)
from cruise_control_tpu_torch.detector.maintenance import (
    IdempotenceCache, TopicMaintenanceEventReader,
)
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
from cruise_control_tpu_torch.detector.topic_anomaly import TopicReplicationFactorAnomalyFinder
from cruise_control_tpu_torch.executor import Executor, SimClock
from cruise_control_tpu_torch.forecast import ForecastKnobs, WorkloadForecaster
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor, ModelCompletenessRequirements,
)

SELF_HEALING_GOALS = [
    "RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
    "DiskCapacityGoal", "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal", "ReplicaDistributionGoal",
]


@dataclasses.dataclass
class OperationResult:
    operation: str
    reason: str
    optimizer_result: OptimizerResult | None = None
    executed: bool = False
    error: str | None = None

    def to_json(self) -> dict:
        out = {"operation": self.operation, "reason": self.reason,
               "executed": self.executed}
        if self.optimizer_result is not None:
            out["result"] = self.optimizer_result.to_json()
        if self.error:
            out["error"] = self.error
        return out


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 {item})")


class CruiseControl:
    def __init__(self, backend, config=None, device="cuda", cluster_id=None):
        from cruise_control_tpu_torch.common.sensors import MetricRegistry
        from cruise_control_tpu_torch.common.tracing import (
            EventJournal, FlightRecorder, SpanTracer,
        )
        from cruise_control_tpu_torch.analyzer.env import resolve_device
        self.config = config or cruise_control_config()
        self.backend = backend
        self.device = resolve_device(device)
        # the tenant cluster this facade serves in fleet mode (None: a
        # single-tenant deployment); labels the monitor's aggregators
        self.cluster_id = cluster_id
        # fleet admission engine (PR 18): (lane, reason, now_ms) -> dict,
        # set by FleetScheduler.add_tenant — detector FIX/PREDICTED verdicts
        # and user rebalances enqueue optimization requests through it
        self._fleet_request_sink = None
        # one registry for the whole app — the MetricRegistry -> JMX domain
        # kafka.cruisecontrol role (KafkaCruiseControlApp.java:29,40); exported
        # via /state?substates=SENSORS and GET /metrics (Prometheus text)
        self.sensors = MetricRegistry()
        # HA role handle: None, a single-controller deployment that serves
        # as an implicit leader (the HA roles are ROADMAP Queue 1 item 14)
        self._ha = None
        # one durable event journal + span tracer for the whole app
        # (common/tracing.py): the recorder's round summaries, every causal
        # span (detector verdict -> operation -> optimize round -> executor
        # phases), executor task census transitions, breaker state changes
        # and pipeline stage notes all write through the journal; spans are
        # served as trees at /state?substates=TRACES. Clocked on the
        # backend's canonical time — the sim's journal lives on simulated
        # time and is byte-identical per (scenario, seed).
        self.journal = EventJournal(
            path=self.config.get_string("journal.path") or None,
            max_bytes=self.config.get_int("journal.max.bytes.per.file"),
            max_files=self.config.get_int("journal.max.files"),
            fsync=self.config.get_string("journal.fsync"),
            memory_lines=self.config.get_int("journal.memory.lines"),
            clock_ms=self._now_ms)
        self.tracer = SpanTracer(
            clock_ms=self._now_ms, journal=self.journal,
            capacity=self.config.get_int("journal.trace.capacity"))
        # GET /health SLO targets (health.slo.*), read once at wiring time
        self._health_slo_ms = {
            "detect": float(self.config.get_int("health.slo.detect.p95.ms")),
            "heal": float(self.config.get_int("health.slo.heal.p95.ms")),
            "request": float(self.config.get_int("health.slo.request.p99.ms")),
        }
        # one flight recorder for the whole app: every optimization round
        # leaves a RoundTrace (common/tracing.py), served by
        # /state?substates=ROUND_TRACES; traces carry the backend clock so
        # the sim's records live on simulated time
        self.flight_recorder = FlightRecorder(
            capacity=self.config.get_int("flight.recorder.capacity"),
            clock_ms=self._now_ms, journal=self.journal)
        self.flight_recorder.register_gauges(self.sensors)
        # ONE fault-tolerance layer at the backend boundary
        # (common/retries.py): the executor, monitor and this facade consult
        # the SAME per-operation-class circuit breakers, so a backend outage
        # the executor observes also degrades REST serving (stale-flagged
        # reads, 503 writes) and defers detector fixes. The injected clock is
        # the backend clock — simulated campaigns keep bit-identical
        # timelines with retries/backoff live.
        from cruise_control_tpu_torch.common.retries import BackendFaultTolerance
        self.fault_tolerance = BackendFaultTolerance(
            self.config, clock_ms=self._now_ms, sensors=self.sensors,
            journal=self.journal)
        # the collaborators the reference's LoadMonitor resolves from the
        # config (the port's monitor takes them as arguments); the sample
        # store is not ported, and its default is inert without a path
        if self.config.get_string("sample.store.path"):
            _not_ported("the sample store (sample.store.path)", "item 11, the rest")
        cfg = self.config
        self.load_monitor = LoadMonitor(
            config=cfg, backend=backend, cluster_id=cluster_id,
            sampler=cfg.get_configured_instance("metric.sampler.class",
                                                backend=backend),
            capacity_resolver=cfg.get_configured_instance(
                "broker.capacity.config.resolver.class"),
            assignor=cfg.get_configured_instance(
                "metric.sampler.partition.assignor.class"),
            on_execution_store=cfg.get_configured_instance(
                "sample.partition.metric.store.on.execution.class"),
            sensors=self.sensors, recorder=self.flight_recorder,
            fault_tolerance=self.fault_tolerance, tracer=self.tracer)
        self.goal_optimizer = GoalOptimizer(config=self.config,
                                            sensors=self.sensors,
                                            recorder=self.flight_recorder,
                                            device=self.device)
        self.executor = Executor(backend, config=self.config,
                                 sensors=self.sensors,
                                 fault_tolerance=self.fault_tolerance,
                                 tracer=self.tracer, journal=self.journal)
        oes = self.load_monitor.on_execution_store
        if oes is not None:
            # the on-execution store gates on the live executor
            oes.configure(self.config, executor=self.executor)
        # anomaly.notifier.class: pluggable AnomalyNotifier
        # (AnomalyDetectorConfig.java anomaly.notifier.class ->
        # getConfiguredInstance); default SelfHealingNotifier
        notifier = self.config.get_class("anomaly.notifier.class")()
        # the notifier's broker-count read rides the shared breaker with a
        # last-known fallback: a transient metadata failure must not crash
        # anomaly handling mid-verdict
        self._last_broker_count = 0

        def _num_brokers() -> int:
            try:
                n = len(self.fault_tolerance.call("detector.metadata",
                                                  backend.brokers))
                self._last_broker_count = n
                return n
            except Exception:
                return self._last_broker_count
        notifier.configure(self.config, num_brokers_supplier=_num_brokers)
        clock = SimClock(backend) if hasattr(backend, "advance") else None
        self.anomaly_detector = AnomalyDetectorManager(
            notifier=notifier, cruise_control=self, clock=clock,
            num_cached_recent_states=self.config.get_int(
                "num.cached.recent.anomaly.states"),
            maintenance_stops_ongoing_execution=self.config.get_boolean(
                "maintenance.event.stop.ongoing.execution"))
        # optimization.options.generator.class: seam for deployment-specific
        # per-run option derivation
        self._options_generator = self.config.get_configured_instance(
            "optimization.options.generator.class")
        # analyzer.warmup.on.start: compile the engine programs for the
        # current cluster shape in the background at service startup
        self._warmup_on_start = self.config.get_boolean(
            "analyzer.warmup.on.start")
        # analyzer.resident.session.enabled: ONE device-resident padded
        # env/state per shape bucket, fed monitor/backend deltas between
        # optimize rounds — the steady-state precompute and self-healing FIX
        # rounds skip the snapshot->pad->upload rebuild (the reference's
        # continuously-updated ClusterModel role, GoalOptimizer.java:139-339).
        # A mesh (tpu.mesh.axis.brokers > 1) is ROADMAP Queue 1 item 15: the
        # optimizer raises on it.
        self.resident_session = None
        if self.config.get_boolean("analyzer.resident.session.enabled"):
            from cruise_control_tpu_torch.analyzer.session import ResidentClusterSession
            self.resident_session = ResidentClusterSession(
                self.load_monitor, config=self.config, device=self.device)
            # runtime sensors over the resident session: device footprint,
            # delta-vs-epoch round split and donation counts — the steady
            # path's health at a glance (and in every Prometheus scrape)
            sess = self.resident_session
            self.sensors.gauge("resident-session-state-bytes",
                               lambda: sess.device_bytes()["state_bytes"])
            self.sensors.gauge("resident-session-env-bytes",
                               lambda: sess.device_bytes()["env_bytes"])
            self.sensors.gauge("resident-session-delta-rounds",
                               lambda: sess.delta_rounds)
            self.sensors.gauge("resident-session-rebuild-rounds",
                               lambda: sess.rebuild_rounds)
            self.sensors.gauge("resident-session-donated-rounds",
                               lambda: sess.donated_rounds)
        # optimization observers: callables ``(operation, reason, res,
        # executed)`` invoked after EVERY facade optimization (REST and
        # self-healing alike). The scenario engine hangs its per-heal
        # OptimizationVerifier pass here; observer failures are recorded but
        # never break the operation.
        self.optimization_observers: list = []
        self._wire_detectors()
        self._proposal_cache: OptimizerResult | None = None
        self._proposal_cache_generation = None
        self._proposal_cache_ms: float = -1.0   # computation time (backend clock)
        # speculative precompute accounting (forecast subsystem): a
        # speculative install stamps _spec_generation with the cache
        # generation it rode in on; the first fresh cache hit at that
        # generation counts as a speculative hit, a refresh that replaces
        # it before any hit counts as stale (the prediction didn't hold)
        self._spec_installs = 0
        self._spec_hits = 0
        self._spec_stale = 0
        self._spec_generation = None
        self._cache_lock = threading.Lock()
        # one party refreshes at a time; readers fall back to waiting on it
        self._refresh_lock = threading.Lock()
        self._precompute_threads: list[threading.Thread] = []
        self._precompute_stop = threading.Event()
        self._ops_history: list[dict] = []
        # the continuous pipelined service loop, when one drives this app
        # (main.py service.pipeline.enabled / the sim's lockstep mode);
        # surfaced via /state?substates=PIPELINE
        self.service_pipeline = None
        # service.pipeline.route.fixes: whether self-healing FIX executions
        # ride the THREADED pipeline's execute stage (_route_fixes_async)
        self._route_fixes = self.config.get_boolean(
            "service.pipeline.route.fixes")

    # ------------------------------------ single-tenant, single-controller
    @property
    def fleet_request_sink(self):
        """The fleet admission engine's request sink (None: single tenant)."""
        return self._fleet_request_sink

    @fleet_request_sink.setter
    def fleet_request_sink(self, sink) -> None:
        self._fleet_request_sink = sink

    def _heal_admission_sink(self, reason: str, now_ms: float | None = None) -> None:
        """app.py:669: a FIX/PREDICTED verdict on a fleet tenant enqueues a
        heal-lane optimization request; a no-op without a fleet."""
        sink = self.fleet_request_sink
        if sink is None:
            return
        from cruise_control_tpu_torch.pipeline import LANE_HEAL
        try:
            sink(LANE_HEAL, reason, now_ms)
        except Exception:   # noqa: BLE001 - an enqueue never breaks detection
            logging.getLogger(__name__).exception(
                "fleet heal-lane enqueue failed for %s", self.cluster_id)

    @property
    def ha(self):
        """The HA role handle (None: a single controller, an implicit leader)."""
        return self._ha

    @ha.setter
    def ha(self, role) -> None:
        if role is not None:
            _not_ported("HA (a leader elector or standby controller)", "item 14")

    # ------------------------------------------------------------- wiring
    def _wire_detectors(self):
        from cruise_control_tpu_torch.detector.provisioner import ProvisionFloors
        broker_fd = BrokerFailureDetector(
            self.backend,
            persist_path=self.config.get_string("failed.brokers.storage.path"),
            anomaly_cls=self.config.get_class("broker.failures.class"))
        disk_fd = DiskFailureDetector(
            self.backend,
            anomaly_cls=self.config.get_class("disk.failures.class"))
        # provisioner.class: right-sizing SPI invoked on UNDER/OVER_PROVISIONED
        # verdicts; an actuating implementation (SimulatedProvisioner) gets
        # the backend to resize and the facade to drain through
        provisioner = self.config.get_configured_instance(
            "provisioner.class", backend=self.backend, cruise_control=self,
            actuation_cooldown_ms=float(self.config.get_int(
                "provision.actuation.cooldown.ms")),
            max_added_brokers=self.config.get_int(
                "provision.max.added.brokers"))
        self.provisioner = provisioner
        allow_est = self.config.get_boolean(
            "anomaly.detection.allow.capacity.estimation")
        # detection rounds ride the resident session when one exists: a
        # zero-churn re-check (the CHECK-verdict loop) then re-serves the
        # PR 16 carried verdicts after one compiled violation re-validation
        session_supplier = None
        if self.config.get_boolean("anomaly.detection.use.resident.session"):
            session_supplier = (lambda: self._usable_session(
                None, False, False, allow_capacity_estimation=allow_est))
        goal_vd = GoalViolationDetector(
            self.goal_optimizer, self.load_monitor,
            self.config.get_list("anomaly.detection.goals"),
            provisioner=provisioner,
            provision_floors=ProvisionFloors.from_config(self.config),
            sensors=self.sensors,
            anomaly_cls=self.config.get_class("goal.violations.class"),
            allow_capacity_estimation=allow_est,
            session_supplier=session_supplier,
            admission_sink=self._heal_admission_sink)
        slow = SlowBrokerFinder()
        slow.configure(self.config)
        # metric.anomaly.finder.class (MetricAnomalyFinder SPI): percentile
        # spike detection over a rolling broker-metric history
        metric_finder = self.config.get_configured_instance(
            "metric.anomaly.finder.class")
        metric_history: dict[int, dict[str, list]] = {}

        def run_metric_finder(now_ms: float) -> list:
            current = self.backend.broker_metrics()
            found = metric_finder.anomalies(metric_history, current, now_ms)
            for b, metrics in current.items():
                hist = metric_history.setdefault(b, {})
                for name, v in metrics.items():
                    hist.setdefault(name, []).append(float(v))
                    del hist[name][:-64]   # bounded history window
            return found
        # topic.anomaly.finder.class: LIST of TopicAnomalyFinder plugins
        # (reference TopicAnomalyDetector runs every configured finder)
        topic_finders = self.config.get_configured_instances(
            "topic.anomaly.finder.class")
        # the pluggable reader SPI (maintenance.event.reader.class) plus the
        # topic transport when its path is configured
        maint_readers = [self.config.get_configured_instance(
            "maintenance.event.reader.class")]
        maint_readers[0].configure(self.config)
        if (self.config.get_string("maintenance.event.topic.path")
                and not isinstance(maint_readers[0],
                                   TopicMaintenanceEventReader)):
            topic_reader = TopicMaintenanceEventReader()
            topic_reader.configure(self.config)
            maint_readers.append(topic_reader)
        idem = IdempotenceCache(
            float(self.config.get_int("maintenance.event.idempotence.retention.ms")),
            max_size=self.config.get_int(
                "maintenance.event.max.idempotence.cache.size"),
            enabled=self.config.get_boolean(
                "maintenance.event.enable.idempotence"))
        self.goal_violation_detector = goal_vd

        # per-detector cadence (AnomalyDetectorConfig.java:154-205): each
        # *.detection.interval.ms falls back to anomaly.detection.interval.ms
        # when -1; broker failure uses its own re-detection backoff
        base_ms = float(self.config.get_int("anomaly.detection.interval.ms"))

        def interval(key: str) -> float:
            v = float(self.config.get_int(key))
            return base_ms if v < 0 else v

        register = self.anomaly_detector.register_detector
        register("BrokerFailureDetector", broker_fd.run_once,
                 interval_ms=float(self.config.get_int(
                     "broker.failure.detection.backoff.ms")))
        register("DiskFailureDetector", disk_fd.run_once,
                 interval_ms=interval("disk.failure.detection.interval.ms"))
        register("GoalViolationDetector", goal_vd.run_once,
                 interval_ms=interval("goal.violation.detection.interval.ms"))
        register("SlowBrokerFinder",
                 lambda now: slow.run_once(self.backend.broker_metrics(), now),
                 interval_ms=interval("metric.anomaly.detection.interval.ms"))
        register("MetricAnomalyDetector", run_metric_finder,
                 interval_ms=interval("metric.anomaly.detection.interval.ms"))
        register("TopicAnomalyDetector",
                 lambda now: [a for f in topic_finders
                              for a in f.anomalies(self.backend, now)],
                 interval_ms=interval("topic.anomaly.detection.interval.ms"))
        # maintenance events poll on the base interval (the reference runs a
        # dedicated long-poll consumer thread; the spool-file reader here is
        # cheap enough to poll)
        register("MaintenanceEventDetector",
                 lambda now: [e for r in maint_readers
                              for e in r.read_events(now)
                              if not idem.seen_before(
                                  f"{e.plan_type}:{e.brokers}:{e.topics}", now)],
                 interval_ms=base_ms)

        # predictive control plane (forecast.enabled): vmapped workload
        # forecaster over the monitor's zero-copy window view + the
        # pre-breach goal-violation detector. After each forecast heal the
        # fix path refreshes the /proposals cache speculatively
        # (refresh_speculative_proposals) — the existing generation rules
        # drop it as stale if the prediction does not hold.
        self.forecaster = None
        self.predicted_goal_violation_detector = None
        self.speculative_proposals_enabled = False
        # cached at wiring for the sim runner's per-tick SLO probe — the
        # baseline leg of a prevented-vs-reacted A/B tracks time under
        # violation with forecasting itself OFF
        self.forecast_slo_tracking = self.config.get_boolean(
            "forecast.slo.tracking.enabled")
        if self.config.get_boolean("forecast.enabled"):
            knobs = ForecastKnobs(
                alpha=self.config.get_double("forecast.ewma.alpha"),
                beta=self.config.get_double("forecast.trend.beta"),
                blend=self.config.get_double("forecast.blend"),
                horizon_ms=self.config.get_int("forecast.horizon.ms"),
                max_scale=self.config.get_double("forecast.max.scale"))
            self.forecaster = WorkloadForecaster(self.load_monitor, knobs,
                                                 device=self.device)
            self.speculative_proposals_enabled = self.config.get_boolean(
                "forecast.speculative.proposals")
            pred = PredictedGoalViolationDetector(
                self.goal_optimizer, self.load_monitor, self.forecaster,
                self.config.get_list("anomaly.detection.goals"),
                sensors=self.sensors,
                allow_capacity_estimation=allow_est,
                admission_sink=self._heal_admission_sink)
            self.predicted_goal_violation_detector = pred
            register("PredictedGoalViolationDetector", pred.run_once,
                     interval_ms=interval(
                         "predicted.goal.violation.detection.interval.ms"))

    def start_up(self, proposal_precompute: bool = False) -> None:
        """Monitor replay + (optionally) the background proposal-precompute
        loop (KafkaCruiseControl.java:201-207 starts both; the REST main
        passes ``proposal_precompute=True``, unit tests mostly don't want a
        thread optimizing underneath them)."""
        self.load_monitor.start_up()
        if proposal_precompute:
            self.start_proposal_precompute()
            if self._warmup_on_start:
                # service startup only (precompute path): unit tests calling
                # bare start_up() must not get a compile thread underneath
                threading.Thread(target=self._warmup_quietly,
                                 name="engine-warmup", daemon=True).start()

    def _warmup_quietly(self) -> None:
        try:
            logging.getLogger(__name__).info("engine warmup done: %s",
                                             self.warmup())
        except Exception:
            logging.getLogger(__name__).exception(
                "engine warmup failed (serving continues cold)")

    def warmup(self, goal_names=None) -> dict:
        """Pre-compile the engine programs for the CURRENT cluster's shape
        (GoalOptimizer.warmup) — callable before any samples exist: shapes
        come from backend metadata alone, so a freshly-booted service can pay
        its trace/compile cost while the monitor is still filling windows.
        Wired to startup via analyzer.warmup.on.start."""
        snap_fn = getattr(self.backend, "snapshot", None)
        if snap_fn is not None:
            snap = snap_fn()
        else:
            from cruise_control_tpu_torch.backend.interface import snapshot_from_metadata
            snap = snapshot_from_metadata(self.backend.brokers(),
                                          self.backend.partitions())
        if not snap.num_replicas:
            return {"skipped": "cluster has no replicas"}
        nrep = np.diff(snap.rep_ptr)
        out = self.goal_optimizer.warmup(
            num_brokers=len(snap.broker_ids),
            num_replicas=snap.num_replicas,
            num_partitions=snap.num_partitions,
            num_topics=max(len(snap.topics), 1),
            num_racks=max(len(set(snap.broker_rack)), 1),
            logdirs_per_broker=max((len(l) for l in snap.broker_logdirs),
                                   default=1),
            max_replication=int(nrep.max()),
            goal_names=goal_names)
        out["operation"] = "WARMUP"
        return out

    def start_proposal_precompute(self) -> None:
        """num.proposal.precompute.threads background workers keep the
        proposal cache fresh against model-generation bumps AND
        proposal.expiration.ms staleness (GoalOptimizer.java:139-190
        ProposalCandidateComputer + :219-226 staleness check)."""
        if self._precompute_threads:
            return
        self._precompute_stop.clear()
        expiration_ms = self.config.get_int("proposal.expiration.ms")
        for i in range(self.config.get_int("num.proposal.precompute.threads")):
            t = threading.Thread(target=self._precompute_loop,
                                 args=(expiration_ms,), daemon=True,
                                 name=f"proposal-precompute-{i}")
            t.start()
            self._precompute_threads.append(t)

    def _precompute_loop(self, expiration_ms: float) -> None:
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        while not self._precompute_stop.is_set():
            try:
                if self._proposal_cache_stale(expiration_ms):
                    self.cached_proposals()
            except NotEnoughValidWindowsError:
                pass      # monitor not ready yet — retry next tick
            except Exception:
                logging.getLogger(__name__).exception("proposal precompute failed")
            # poll fast enough to notice generation bumps promptly but far
            # below the expiration budget; the refresh itself is the cost
            wait_s = min(max(expiration_ms / 4000.0, 0.05), 30.0)
            self._precompute_stop.wait(wait_s)

    def _proposal_cache_stale(self, expiration_ms: float) -> bool:
        gen = self.load_monitor.model_generation().as_tuple()
        with self._cache_lock:
            if self._proposal_cache is None:
                return True
            if self._proposal_cache_generation != gen:
                return True
            return (expiration_ms >= 0
                    and self._now_ms() - self._proposal_cache_ms > expiration_ms)

    def shutdown(self) -> None:
        self._precompute_stop.set()
        for t in self._precompute_threads:
            t.join(5.0)
        self._precompute_threads.clear()
        self.anomaly_detector.shutdown()
        self.load_monitor.shutdown()
        self.journal.close()

    # ------------------------------------------------------- degraded mode
    def degraded(self) -> bool:
        """True while any backend circuit breaker is not CLOSED: reads serve
        stale caches, writes 503, the detector defers fixes."""
        return self.fault_tolerance.degraded()

    def degraded_json(self) -> dict:
        return self.fault_tolerance.state_json()

    def _check_writable(self, operation: str) -> None:
        """Gate cluster-mutating operations while degraded: a write against
        an unreachable backend would only start an execution that immediately
        pauses — reject it up front with 503 + Retry-After instead
        (api/server.py maps ServiceUnavailableError)."""
        ft = self.fault_tolerance
        if ft.degraded():
            from cruise_control_tpu_torch.common.retries import (
                ServiceUnavailableError,
            )
            self.sensors.meter("degraded-write-rejections").mark()
            raise ServiceUnavailableError(
                f"{operation} rejected: backend degraded (open circuits: "
                f"{ft.open_circuits()})",
                retry_after_s=ft.retry_after_s())

    # ------------------------------------------------------------ helpers
    @property
    def ops_history(self) -> list:
        """Executed-operation records ({operation, reason, ms, numProposals,
        executed}) — read by /state consumers and the scenario engine."""
        return list(self._ops_history)

    def _now_ms(self) -> float:
        now = getattr(self.backend, "now_ms", None)
        if now is None:   # clockless stub backend: fall back to wall time
            return time.time() * 1000.0
        return float(now())

    def _model(self, requirements=None):
        return self.load_monitor.cluster_model(requirements)

    def _apply_excluded_topics(self, ct, meta, pattern: str | None):
        """Mask topics matching ``pattern`` (or the configured default regex,
        topics.excluded.from.partition.movement) from partition movement —
        the excludedTopics parameter semantics (GoalBasedOperationRunnable /
        OptimizationOptions excludedTopics role)."""
        import re
        pattern = pattern if pattern is not None else \
            self.config.get_string("topics.excluded.from.partition.movement")
        if not pattern:
            return ct
        try:
            rx = re.compile(pattern)
        except re.error as e:
            # backstop only: the server pre-validates request patterns (400)
            # and config load pre-validates the configured pattern
            raise ValueError(
                f"invalid excluded_topics regex {pattern!r}: {e}") from None
        excl = np.asarray(ct.topic_excluded).copy()
        for i, name in enumerate(meta.topic_names):
            if rx.fullmatch(name):
                excl[i] = True
        return dataclasses.replace(ct, topic_excluded=excl)

    def _apply_broker_exclusions(self, ct, meta, exclude_recently_removed: bool,
                                 exclude_recently_demoted: bool):
        """Blocklist recently removed brokers as move destinations and
        recently demoted brokers for leadership (the
        excludeRecentlyRemovedBrokers / excludeRecentlyDemotedBrokers
        parameter semantics; history kept by the executor,
        Executor.java:449-506)."""
        known = set(meta.broker_ids)
        if exclude_recently_removed:
            # skip history entries for brokers the backend no longer reports
            removed = self.executor.recently_removed_brokers() & known
            if removed:
                excl = np.asarray(ct.broker_excluded_for_replica_move).copy()
                for b in removed:
                    excl[meta.broker_index(b)] = True
                ct = dataclasses.replace(
                    ct, broker_excluded_for_replica_move=excl)
        if exclude_recently_demoted:
            demoted = self.executor.recently_demoted_brokers() & known
            if demoted:
                excl = np.asarray(ct.broker_excluded_for_leadership).copy()
                for b in demoted:
                    excl[meta.broker_index(b)] = True
                ct = dataclasses.replace(
                    ct, broker_excluded_for_leadership=excl)
        return ct

    def _usable_session(self, excluded_topics: str | None,
                        exclude_removed: bool, exclude_demoted: bool,
                        allow_capacity_estimation: bool = True):
        """The synced resident session when this operation can run on it, or
        None to take the full model-build path. Custom topic exclusions and
        non-empty broker blocklists need per-request env mutation the
        resident state does not carry, so they fall back; so does any sync
        failure (the session is purely a fast path — never a correctness
        dependency). NotEnoughValidWindowsError propagates like the model
        build's own completeness gate."""
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        sess = self.resident_session
        if sess is None:
            return None
        if excluded_topics is not None:
            return None     # request-specific regex (configured one is baked in)
        if exclude_removed and self.executor.recently_removed_brokers():
            return None
        if exclude_demoted and self.executor.recently_demoted_brokers():
            return None
        try:
            sess.sync(allow_capacity_estimation=allow_capacity_estimation)
        except NotEnoughValidWindowsError:
            raise
        except Exception:
            logging.getLogger(__name__).exception(
                "resident session sync failed; falling back to full rebuild")
            sess.invalidate()
            return None
        return sess

    def _self_healing_goals(self) -> list:
        """Goals self-healing fixes optimize: AnomalyDetectorConfig
        ``self.healing.goals`` when set, else the built-in evacuation chain."""
        return self.config.get_list("self.healing.goals") or SELF_HEALING_GOALS

    def _self_healing_exclusions(self, excl_removed: bool, excl_demoted: bool,
                                 self_healing: bool) -> tuple:
        """Self-healing operations exclude recently removed/demoted brokers
        by default (AnomalyDetectorConfig
        self.healing.exclude.recently.{removed,demoted}.brokers); explicit
        request flags still win when already set."""
        if self_healing:
            excl_removed = excl_removed or self.config.get_boolean(
                "self.healing.exclude.recently.removed.brokers")
            excl_demoted = excl_demoted or self.config.get_boolean(
                "self.healing.exclude.recently.demoted.brokers")
        return excl_removed, excl_demoted

    def _route_fixes_async(self) -> bool:
        """Whether self-healing FIX executions should ride the pipeline's
        execute stage instead of blocking the caller (a
        long heal must not block the detection thread). Only the THREADED
        pipeline routes — the sim's lockstep mode keeps blocking heals so
        (scenario, seed) timelines stay bit-identical."""
        pipe = self.service_pipeline
        return (pipe is not None and self._route_fixes
                and pipe.accepts_fix_routing())

    def _run_optimization(self, operation: str, reason: str, ct, meta,
                          goal_names=None, options=OptimizationOptions(),
                          dry_run: bool = True, skip_hard_goal_check: bool = False,
                          execute_kw: dict | None = None,
                          session=None, parent_span=None,
                          route_async: bool = False) -> OperationResult:
        goals = goal_names or effective_default_goals(self.config)
        # optimization.options.generator.class seam: deployments may rewrite
        # the options of any internally-triggered optimization
        options = self._options_generator.optimization_options(options, operation)
        # tag this thread's next round trace with the operation name
        self.flight_recorder.note_operation(operation)
        # causal span: one "operation" span per facade optimization, parented
        # on whatever handle the caller passed (a detector verdict span, a
        # REST request span) — the optimizer round and the executor phases
        # hang under it, so anomaly->heal is a walkable tree
        op_span = self.tracer.span("operation", operation, parent=parent_span,
                                   reason=reason, dry_run=bool(dry_run))
        try:
            res = self.goal_optimizer.optimizations(
                ct, meta, goal_names=goals, options=options,
                skip_hard_goal_check=skip_hard_goal_check, session=session,
                span=op_span)
        except Exception as e:
            op_span.end(error=type(e).__name__)
            raise
        op = OperationResult(operation=operation, reason=reason,
                             optimizer_result=res)
        routed = False
        if not dry_run and res.proposals:
            kw = dict(execute_kw or {})
            try:
                sizes = {tp: info.size_mb
                         for tp, info in self.backend.partitions().items()}
            except Exception:
                # strategy sort degrades without sizes; the execution itself
                # retries/pauses through the executor's breakers
                sizes = {}
            kw.setdefault("context", {"partition_size_mb": sizes,
                                      "operation": f"{operation}: {reason}"})
            if route_async and self._route_fixes_async():
                # hand the heal to the pipeline's execute stage: the
                # detection thread returns at once, the execution drains on
                # the pipeline's thread, and the operation span rides into
                # the executor as parent_span; the round is STICKY so a
                # metadata-generation bump between submit and drain cannot
                # silently drop a heal
                self.service_pipeline.submit_execution(
                    res.proposals,
                    execute_kw={**kw, "parent_span": op_span}, sticky=True)
                op.executed = True
                routed = True
                self.sensors.meter("pipeline-routed-fixes").mark()
            else:
                try:
                    self.executor.execute_proposals(res.proposals,
                                                    parent_span=op_span, **kw)
                except Exception as e:
                    op_span.end(error=type(e).__name__,
                                proposals=len(res.proposals))
                    raise
                op.executed = True
        op_span.end(executed=op.executed, routed=routed,
                    proposals=len(res.proposals))
        self._ops_history.append({"operation": operation, "reason": reason,
                                  "ms": self._now_ms(),
                                  "numProposals": len(res.proposals),
                                  "executed": op.executed})
        for observer in self.optimization_observers:
            try:
                observer(operation, reason, res, op.executed)
            except Exception:
                logging.getLogger(__name__).exception(
                    "optimization observer failed for %s", operation)
        if op.executed:
            # dedicated operation log channel (OPERATION_LOGGER, Executor.java:1037)
            from cruise_control_tpu_torch.common.sensors import OPERATION_LOGGER
            OPERATION_LOGGER.info(
                "%s (%s): executed %d proposals (%d replica moves, %d "
                "leadership moves)", operation, reason, len(res.proposals),
                res.num_replica_movements, res.num_leadership_movements)
        return op

    def execute_precomputed(self, res, operation: str = "EXECUTE_PRECOMPUTED",
                            reason: str = "precomputed proposals",
                            self_healing: bool = False,
                            parent_span=None) -> dict:
        """Execute an already-computed :class:`OptimizerResult` through the
        normal operation-span -> pipeline/executor path, WITHOUT a fresh
        optimization round.

        The predicted-goal-violation fix rides this: its proposals were
        optimized against the forecast-horizon model, so re-optimizing the
        current (still clean) state would discard them for a no-op. Span
        lineage matches `_run_optimization`'s execute half exactly — the
        operation span parents the executor phases (or rides the pipeline's
        sticky execute stage when fixes route async)."""
        self._check_writable(operation)
        self.flight_recorder.note_operation(operation)
        op_span = self.tracer.span("operation", operation, parent=parent_span,
                                   reason=reason, dry_run=False,
                                   precomputed=True)
        op = OperationResult(operation=operation, reason=reason,
                             optimizer_result=res)
        routed = False
        if res.proposals:
            try:
                sizes = {tp: info.size_mb
                         for tp, info in self.backend.partitions().items()}
            except Exception:
                sizes = {}
            kw = {"context": {"partition_size_mb": sizes,
                              "operation": f"{operation}: {reason}"}}
            if self_healing and self._route_fixes_async():
                # hand the heal to the pipeline's execute stage: the
                # detection thread returns at once, the execution drains on
                # the pipeline's thread, and the operation span rides into
                # the executor as parent_span; the round is STICKY so a
                # metadata-generation bump between submit and drain cannot
                # silently drop a heal
                self.service_pipeline.submit_execution(
                    res.proposals,
                    execute_kw={**kw, "parent_span": op_span}, sticky=True)
                op.executed = True
                routed = True
                self.sensors.meter("pipeline-routed-fixes").mark()
            else:
                try:
                    self.executor.execute_proposals(res.proposals,
                                                    parent_span=op_span, **kw)
                except Exception as e:
                    op_span.end(error=type(e).__name__,
                                proposals=len(res.proposals))
                    raise
                op.executed = True
        op_span.end(executed=op.executed, routed=routed,
                    proposals=len(res.proposals))
        self._ops_history.append({"operation": operation, "reason": reason,
                                  "ms": self._now_ms(),
                                  "numProposals": len(res.proposals),
                                  "executed": op.executed})
        for observer in self.optimization_observers:
            try:
                observer(operation, reason, res, op.executed)
            except Exception:
                logging.getLogger(__name__).exception(
                    "optimization observer failed for %s", operation)
        if op.executed:
            from cruise_control_tpu_torch.common.sensors import OPERATION_LOGGER
            OPERATION_LOGGER.info(
                "%s (%s): executed %d proposals (%d replica moves, %d "
                "leadership moves)", operation, reason, len(res.proposals),
                res.num_replica_movements, res.num_leadership_movements)
        return op.to_json()

    # ---------------------------------------------------------- operations
    def rebalance(self, goal_names=None, dry_run: bool = False,
                  self_healing: bool = False, triggered_by_goal_violation: bool = False,
                  skip_hard_goal_check: bool = False, rebalance_disk: bool = False,
                  kafka_assigner: bool = False, excluded_topics: str | None = None,
                  exclude_recently_removed_brokers: bool = False,
                  exclude_recently_demoted_brokers: bool = False,
                  replica_movement_strategies: list | None = None,
                  reason: str = "rebalance", parent_span=None) -> dict:
        """POST /rebalance (RebalanceRunnable.java:30-115 role).
        ``rebalance_disk=True`` balances load across the logdirs of each
        broker with the intra-broker goal chain instead
        (RebalanceParameters.java rebalance_disk); ``kafka_assigner=True``
        substitutes the kafka-assigner mode goals
        (analyzer/kafkaassigner/ role)."""
        if replica_movement_strategies:
            # fail before optimizing — a typo'd strategy must 400, not burn
            # an optimization then 500 at execute time
            self.executor.validate_strategies(replica_movement_strategies)
        if not dry_run:
            self._check_writable("REBALANCE")
        excl_rm, excl_dm = self._self_healing_exclusions(
            exclude_recently_removed_brokers, exclude_recently_demoted_brokers,
            self_healing)
        # steady-state fast path: plain rebalances (incl. the detector's FIX
        # firings) start from the device-resident session instead of
        # rebuilding the model; mode-specific goal rewrites and per-request
        # exclusions keep the full build
        session = (None if (kafka_assigner or rebalance_disk)
                   else self._usable_session(excluded_topics, excl_rm, excl_dm))
        if session is not None:
            ct = meta = None
        else:
            ct, meta = self._model()
            ct = self._apply_excluded_topics(ct, meta, excluded_topics)
            ct = self._apply_broker_exclusions(ct, meta, excl_rm, excl_dm)
        options = OptimizationOptions(
            triggered_by_goal_violation=triggered_by_goal_violation)
        if kafka_assigner:
            from cruise_control_tpu_torch.analyzer.goals import kafka_assigner_goal_names
            goal_names = kafka_assigner_goal_names(goal_names or [])
            skip_hard_goal_check = True
        if rebalance_disk:
            intra = self.config.get_list("intra.broker.goals")
            if goal_names:
                bad = [g for g in goal_names if g not in intra]
                if bad:
                    raise ValueError(
                        f"rebalance_disk only accepts intra-broker goals; "
                        f"got {bad} (allowed: {intra})")
            else:
                goal_names = intra
            skip_hard_goal_check = True
        goals = goal_names or (self._self_healing_goals() if self_healing else None)
        execute_kw = ({"strategy_names": replica_movement_strategies}
                      if replica_movement_strategies else None)
        op = self._run_optimization("REBALANCE", reason, ct, meta, goals, options,
                                    dry_run=dry_run,
                                    skip_hard_goal_check=skip_hard_goal_check
                                    or self_healing,
                                    execute_kw=execute_kw, session=session,
                                    parent_span=parent_span,
                                    route_async=self_healing)
        return op.to_json()

    def remove_brokers(self, broker_ids: list, dry_run: bool = False,
                       self_healing: bool = False,
                       excluded_topics: str | None = None,
                       exclude_recently_removed_brokers: bool = False,
                       exclude_recently_demoted_brokers: bool = False,
                       reason: str = "remove brokers",
                       parent_span=None) -> dict:
        """POST /remove_broker: drain the brokers, then (really) move load off
        (RemoveBrokersRunnable role). Marks brokers as move-excluded
        destinations and relocates everything they host."""
        if not dry_run:
            self._check_writable("REMOVE_BROKER")
        ct, meta = self._model()
        ct = self._apply_excluded_topics(ct, meta, excluded_topics)
        excl_rm, excl_dm = self._self_healing_exclusions(
            exclude_recently_removed_brokers, exclude_recently_demoted_brokers,
            self_healing)
        ct = self._apply_broker_exclusions(ct, meta, excl_rm, excl_dm)
        idx = [meta.broker_index(b) for b in broker_ids]
        alive = np.asarray(ct.broker_alive).copy()
        excl = np.asarray(ct.broker_excluded_for_replica_move).copy()
        offline = np.asarray(ct.replica_offline).copy()
        rb = np.asarray(ct.replica_broker)
        valid = np.asarray(ct.replica_valid)
        for i in idx:
            excl[i] = True
            # every replica hosted there must relocate (treated like offline)
            offline |= valid & (rb == i)
        ct = dataclasses.replace(
            ct,
            broker_excluded_for_replica_move=excl,
            replica_offline=offline)
        op = self._run_optimization("REMOVE_BROKER", reason, ct, meta,
                                    self._self_healing_goals(),
                                    OptimizationOptions(),
                                    dry_run=dry_run, skip_hard_goal_check=True,
                                    parent_span=parent_span,
                                    route_async=self_healing)
        if op.executed:
            self.executor.note_removed_brokers(broker_ids)
        return op.to_json()

    def add_brokers(self, broker_ids: list, dry_run: bool = False,
                    excluded_topics: str | None = None,
                    exclude_recently_removed_brokers: bool = False,
                    exclude_recently_demoted_brokers: bool = False,
                    skip_hard_goal_check: bool = False,
                    reason: str = "add brokers", parent_span=None) -> dict:
        """POST /add_broker: rebalance load onto the (new) brokers.
        ``skip_hard_goal_check``: self-healing contexts (the ADD_BROKER
        maintenance plan firing mid-fault) balance onto the new hardware
        best-effort instead of aborting on a transiently-unsatisfiable hard
        goal."""
        if not dry_run:
            self._check_writable("ADD_BROKER")
        ct, meta = self._model()
        ct = self._apply_excluded_topics(ct, meta, excluded_topics)
        ct = self._apply_broker_exclusions(ct, meta,
                                           exclude_recently_removed_brokers,
                                           exclude_recently_demoted_brokers)
        new = np.asarray(ct.broker_new).copy()
        for b in broker_ids:
            new[meta.broker_index(b)] = True
        ct = dataclasses.replace(ct, broker_new=new)
        op = self._run_optimization("ADD_BROKER", reason, ct, meta, None,
                                    OptimizationOptions(), dry_run=dry_run,
                                    skip_hard_goal_check=skip_hard_goal_check,
                                    parent_span=parent_span)
        return op.to_json()

    def demote_brokers(self, broker_ids: list, dry_run: bool = False,
                       reason: str = "demote brokers",
                       parent_span=None) -> dict:
        """POST /demote_broker: move leadership away and prevent new leadership
        (DemoteBrokerRunnable + PreferredLeaderElectionGoal role).

        PLE ONLY, like the reference: demotion is a leadership operation.
        The chain used to include LeaderReplicaDistributionGoal, whose
        fallback REPLICA moves run without RackAwareGoal in the chain to
        veto destinations — a chaos campaign caught it parking replicas on
        co-rack brokers, a permanent hard-goal violation that offline-only
        heals can never repair."""
        if not dry_run:
            self._check_writable("DEMOTE_BROKER")
        ct, meta = self._model()
        demoted = np.asarray(ct.broker_demoted).copy()
        for b in broker_ids:
            demoted[meta.broker_index(b)] = True
        ct = dataclasses.replace(ct, broker_demoted=demoted)
        op = self._run_optimization(
            "DEMOTE_BROKER", reason, ct, meta,
            ["PreferredLeaderElectionGoal"],
            OptimizationOptions(), dry_run=dry_run, skip_hard_goal_check=True,
            parent_span=parent_span)
        if op.executed:
            self.executor.note_demoted_brokers(broker_ids)
        return op.to_json()

    def fix_offline_replicas(self, dry_run: bool = False,
                             self_healing: bool = False,
                             excluded_topics: str | None = None,
                             exclude_recently_removed_brokers: bool = False,
                             exclude_recently_demoted_brokers: bool = False,
                             reason: str = "fix offline replicas",
                             parent_span=None) -> dict:
        """POST /fix_offline_replicas (FixOfflineReplicasRunnable role)."""
        if not dry_run:
            self._check_writable("FIX_OFFLINE_REPLICAS")
        excl_rm, excl_dm = self._self_healing_exclusions(
            exclude_recently_removed_brokers, exclude_recently_demoted_brokers,
            self_healing)
        # self-healing FIX firings hit this path: the resident session makes
        # time-to-heal bounded by the warm optimizer, not a model rebuild
        session = self._usable_session(excluded_topics, excl_rm, excl_dm)
        if session is not None:
            ct = meta = None
        else:
            ct, meta = self._model()
            ct = self._apply_excluded_topics(ct, meta, excluded_topics)
            ct = self._apply_broker_exclusions(ct, meta, excl_rm, excl_dm)
        op = self._run_optimization(
            "FIX_OFFLINE_REPLICAS", reason, ct, meta, self._self_healing_goals(),
            OptimizationOptions(fix_offline_replicas_only=True),
            dry_run=dry_run, skip_hard_goal_check=True, session=session,
            parent_span=parent_span, route_async=self_healing)
        return op.to_json()

    def fix_topic_replication_factor(self, bad_topics: dict,
                                     reason: str = "fix topic RF",
                                     parent_span=None) -> dict:
        """Topic RF healing: under-replicated topics get replicas added on
        the least-loaded alive brokers, over-replicated ones shrink to
        target, and the repair PLAN executes through the executor like every
        other fix (UpdateTopicConfigurationRunnable role) — throttled,
        concurrency-capped, task-accounted, visible in state_json instead of
        a raw metadata write behind the executor's back."""
        self._check_writable("TOPIC_REPLICATION_FACTOR")
        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
        default_rf = self.config.get_int("self.healing.target.topic.replication.factor")
        partitions = self.backend.partitions()
        brokers = self.backend.brokers()
        # candidate destinations: alive brokers WITHOUT dead logdirs (adding
        # a replica lands on the broker's first logdir — placing onto dead
        # hardware would mint fresh offline replicas mid-heal); least-loaded
        # first, ties by id
        counts = {b: 0 for b, n in brokers.items()
                  if n.alive and not n.dead_logdirs}
        for info in partitions.values():
            for b in info.replicas:
                if b in counts:
                    counts[b] += 1
        proposals = []
        for (topic, part), info in sorted(partitions.items()):
            if topic not in bad_topics:
                continue
            # per-topic target RF when the caller supplied one (the
            # TOPIC_CONFIGURATION endpoint passes {topic: rf}; the detector
            # passes {topic: {"targetRF": rf, ...}}), else the healing default
            spec = bad_topics[topic]
            if isinstance(spec, int):
                target_rf = spec
            elif isinstance(spec, dict) and "targetRF" in spec:
                target_rf = int(spec["targetRF"])
            else:
                target_rf = default_rf
            replicas = list(info.replicas)
            if len(replicas) < target_rf:
                # rack-aware placement (the PR-8 demote lesson, re-learned by
                # a chaos campaign on THIS path): prefer racks the partition
                # doesn't occupy yet — a co-rack add is a permanent
                # RackAwareGoal violation that wedges every later
                # offline-only heal; fall back to co-rack only when every
                # rack is already used
                racks_used = {brokers[b].rack for b in replicas
                              if b in brokers}
                for _ in range(target_rf - len(replicas)):
                    candidates = sorted(
                        (b for b in counts if b not in replicas),
                        key=lambda b: (brokers[b].rack in racks_used,
                                       counts[b], b))
                    if not candidates:
                        break
                    b = candidates[0]
                    replicas.append(b)
                    racks_used.add(brokers[b].rack)
                    counts[b] += 1
            elif len(replicas) > target_rf:
                keep = [info.leader] + [b for b in replicas if b != info.leader]
                replicas = keep[:target_rf]
            if replicas != info.replicas:
                proposals.append(ExecutionProposal(
                    topic=topic, partition=part,
                    old_leader=info.leader, new_leader=info.leader,
                    old_replicas=tuple((b, 0) for b in info.replicas),
                    new_replicas=tuple((b, 0) for b in replicas)))
        executed = False
        op_span = self.tracer.span("operation", "TOPIC_REPLICATION_FACTOR",
                                   parent=parent_span, reason=reason)
        if proposals:
            sizes = {tp: i.size_mb for tp, i in partitions.items()}
            try:
                self.executor.execute_proposals(
                    proposals,
                    context={"partition_size_mb": sizes,
                             "operation": f"TOPIC_REPLICATION_FACTOR: {reason}"},
                    parent_span=op_span)
            except Exception as e:
                op_span.end(error=type(e).__name__, proposals=len(proposals))
                raise
            executed = True
        op_span.end(executed=executed, proposals=len(proposals))
        self._ops_history.append({
            "operation": "TOPIC_REPLICATION_FACTOR", "reason": reason,
            "ms": self._now_ms(), "numProposals": len(proposals),
            "executed": executed})
        return {"operation": "TOPIC_REPLICATION_FACTOR", "reason": reason,
                "numPartitionsChanged": len(proposals), "executed": executed}

    # ------------------------------------------------------- admin surface
    def pause_sampling(self, reason: str = "operator request") -> dict:
        """POST /pause_sampling."""
        self.load_monitor.pause_sampling(reason)
        return {"operation": "PAUSE_SAMPLING", "reason": reason,
                "monitorState": self.load_monitor.state}

    def resume_sampling(self, reason: str = "operator request") -> dict:
        """POST /resume_sampling."""
        self.load_monitor.resume_sampling(reason)
        return {"operation": "RESUME_SAMPLING", "reason": reason,
                "monitorState": self.load_monitor.state}

    def stop_proposal_execution(self, force: bool = False) -> dict:
        """POST /stop_proposal_execution (Executor stop/force-stop :873-899)."""
        was_ongoing = self.executor.has_ongoing_execution()
        self.executor.stop_execution(force=force)
        return {"operation": "STOP_PROPOSAL_EXECUTION", "forceStop": force,
                "wasOngoingExecution": was_ongoing}

    def bootstrap(self, start_ms=None, end_ms=None, clear_metrics: bool = True) -> dict:
        """GET /bootstrap (BootstrapTask role)."""
        out = self.load_monitor.bootstrap(start_ms, end_ms, clear_metrics)
        out["operation"] = "BOOTSTRAP"
        return out

    def train(self, start_ms=None, end_ms=None) -> dict:
        """GET /train (TrainingTask + LinearRegressionModelParameters role)."""
        out = self.load_monitor.train(start_ms, end_ms)
        out["operation"] = "TRAIN"
        return out

    def admin(self, disable_self_healing_for=None, enable_self_healing_for=None,
              concurrent_partition_movements_per_broker=None,
              concurrent_intra_broker_partition_movements=None,
              concurrent_leader_movements=None,
              execution_progress_check_interval_ms=None,
              drop_recently_removed_brokers=None,
              drop_recently_demoted_brokers=None) -> dict:
        """POST /admin (AdminParameters.java surface): toggle self-healing per
        anomaly type, adjust movement concurrency, un-blocklist brokers."""
        from cruise_control_tpu_torch.detector.anomalies import AnomalyType
        notifier = self.anomaly_detector.notifier
        out: dict = {"operation": "ADMIN"}
        # validate every name BEFORE mutating anything (atomic like
        # set_concurrency): a bad name mid-list must not half-apply toggles
        toggles = [(n.upper(), False) for n in (disable_self_healing_for or [])] \
            + [(n.upper(), True) for n in (enable_self_healing_for or [])]
        for name, _ in toggles:
            if name not in AnomalyType.__members__:
                raise ValueError(
                    f"unknown anomaly type {name!r}; known: "
                    f"{sorted(AnomalyType.__members__)}")
        changed = {}
        for name, enabled in toggles:
            notifier.set_self_healing(AnomalyType[name], enabled)
            changed[name] = enabled
        if changed:
            out["selfHealingEnabledChanged"] = changed
        if any(x is not None for x in (concurrent_partition_movements_per_broker,
                                       concurrent_intra_broker_partition_movements,
                                       concurrent_leader_movements,
                                       execution_progress_check_interval_ms)):
            out["concurrency"] = self.executor.set_concurrency(
                per_broker=concurrent_partition_movements_per_broker,
                intra_broker=concurrent_intra_broker_partition_movements,
                leadership=concurrent_leader_movements,
                progress_check_interval_ms=execution_progress_check_interval_ms)
        if drop_recently_removed_brokers:
            out["droppedRecentlyRemovedBrokers"] = \
                self.executor.drop_recently_removed_brokers(drop_recently_removed_brokers)
        if drop_recently_demoted_brokers:
            out["droppedRecentlyDemotedBrokers"] = \
                self.executor.drop_recently_demoted_brokers(drop_recently_demoted_brokers)
        return out

    def broker_load_json(self, populate_disk_info: bool = False,
                         capacity_only: bool = False) -> dict:
        """GET /load (ClusterLoad/BrokerStats response). The model build's
        metadata reads ride the monitor's shared circuit breaker
        (LoadMonitor._metadata_read): an outage degrades this read to a
        declared 503 + Retry-After, never a raw backend error."""
        from cruise_control_tpu_torch.api.responses import broker_stats_json
        ct, meta = self._model()
        return broker_stats_json(ct, meta, populate_disk_info=populate_disk_info,
                                 capacity_only=capacity_only, device=self.device)

    # ------------------------------------------------------------ proposals
    def cached_proposals(self, force_refresh: bool = False,
                         goal_names=None,
                         excluded_topics: str | None = None) -> OptimizerResult:
        """GET /proposals with generation-checked cache
        (GoalOptimizer precompute/cache role, GoalOptimizer.java:219-339).
        A custom goal list bypasses the cache, like the reference does when
        ProposalsParameters carries non-default goals."""
        return self.cached_proposals_verbose(
            force_refresh=force_refresh, goal_names=goal_names,
            excluded_topics=excluded_topics)[0]

    def cached_proposals_verbose(self, force_refresh: bool = False,
                                 goal_names=None,
                                 excluded_topics: str | None = None):
        """``(result, freshness)`` — the degraded-read contract: a refresh
        that fails because the backend boundary is unhealthy (open breaker,
        completeness gating, transient backend error) serves the CACHED
        proposals flagged ``{"stale": True, "generation": ..., "ageMs": ...}``
        instead of failing the read; with nothing cached the read surfaces
        503 + Retry-After (ServiceUnavailableError). The REST layer emits the
        freshness fields verbatim."""
        from cruise_control_tpu_torch.common.retries import ServiceUnavailableError
        try:
            res = self._cached_proposals_fresh(force_refresh, goal_names,
                                               excluded_topics)
            return res, {"stale": False}
        except Exception as e:
            # ServiceUnavailableError (a degraded metadata read) is
            # deliberately fallback-eligible too: serving the stale cache
            # beats a clean 503 when there is something to serve
            if goal_names or excluded_topics:
                raise    # custom-chain dry runs have no cache to fall back to
            with self._cache_lock:
                cached = self._proposal_cache
                gen = self._proposal_cache_generation
                age_ms = (self._now_ms() - self._proposal_cache_ms
                          if cached is not None else None)
            if cached is None:
                # nothing to serve: a degraded read without a cache is a 503,
                # never a raw 500 (the fuzzer's no-undeclared-500s invariant)
                if isinstance(e, ServiceUnavailableError):
                    raise
                raise ServiceUnavailableError(
                    f"proposals unavailable ({type(e).__name__}: {e}) and "
                    f"no cached result to serve",
                    retry_after_s=self.fault_tolerance.retry_after_s()) from e
            self.sensors.meter("stale-proposals-served").mark()
            logging.getLogger(__name__).warning(
                "serving STALE cached proposals (generation %s, age %.0f ms):"
                " %s: %s", gen, age_ms, type(e).__name__, e)
            return cached, {"stale": True, "generation": list(gen),
                            "ageMs": round(age_ms, 1),
                            "reason": f"{type(e).__name__}: {e}"}

    def install_proposal_cache(self, res: OptimizerResult,
                               generation=None, computed_ms=None) -> None:
        """Install an externally-computed optimizer result as this app's
        proposal cache (the fleet scheduler's batched rounds land here —
        GET /proposals then serves it through the normal generation-checked
        path)."""
        gen = (generation if generation is not None
               else self.load_monitor.model_generation().as_tuple())
        with self._cache_lock:
            self._proposal_cache = res
            self._proposal_cache_generation = gen
            self._proposal_cache_ms = (computed_ms if computed_ms is not None
                                       else self._now_ms())

    def refresh_speculative_proposals(self) -> None:
        """Speculative proposal precompute (forecast subsystem): right after
        a forecast heal lands, recompute proposals ONCE on the just-healed
        state and stamp the install speculative. If the prediction holds —
        no generation bump before the next /proposals read — the cached
        result serves instantly (a speculative hit). If the world moves
        first, the existing generation rules drop it as stale; no
        special-case invalidation is needed."""
        try:
            self._cached_proposals_fresh(force_refresh=True)
        except Exception:
            return   # degraded boundary: no speculation, the read decides
        with self._cache_lock:
            self._spec_installs += 1
            self._spec_generation = self._proposal_cache_generation
        self.sensors.meter("speculative-proposals-installed").mark()

    def speculative_pending(self) -> bool:
        """True while a speculative install awaits its first /proposals
        read — the read that decides hit (generation held) vs stale."""
        with self._cache_lock:
            return self._spec_generation is not None

    def _note_speculative_hit(self) -> None:
        with self._cache_lock:
            if (self._spec_generation is not None
                    and self._proposal_cache_generation
                    == self._spec_generation):
                self._spec_hits += 1
                self._spec_generation = None
                self.sensors.meter("speculative-proposals-hit").mark()

    def _note_speculative_stale(self) -> None:
        with self._cache_lock:
            if self._spec_generation is not None:
                self._spec_stale += 1
                self._spec_generation = None
                self.sensors.meter("speculative-proposals-stale").mark()

    def speculative_state_json(self) -> dict:
        with self._cache_lock:
            installs, hits, stale = (self._spec_installs, self._spec_hits,
                                     self._spec_stale)
        return {"installs": installs, "hits": hits, "stale": stale,
                "hitRate": round(hits / max(installs, 1), 3)}

    def _cached_proposals_fresh(self, force_refresh: bool = False,
                                goal_names=None,
                                excluded_topics: str | None = None) -> OptimizerResult:
        if goal_names or excluded_topics:
            # dry-run-only path: custom goal lists / exclusions bypass the
            # cache (the precompute always runs the full default chain)
            ct, meta = self._model()
            ct = self._apply_excluded_topics(ct, meta, excluded_topics)
            return self.goal_optimizer.optimizations(
                ct, meta, goal_names=goal_names or None,
                raise_on_failure=False, skip_hard_goal_check=True)
        expiration_ms = self.config.get_int("proposal.expiration.ms")

        def fresh() -> OptimizerResult | None:
            gen = self.load_monitor.model_generation().as_tuple()
            with self._cache_lock:
                if (not force_refresh and self._proposal_cache is not None
                        and self._proposal_cache_generation == gen
                        and (expiration_ms == 0
                             or self._now_ms() - self._proposal_cache_ms
                             <= expiration_ms)):
                    return self._proposal_cache
            return None

        hit = fresh()
        if hit is not None:
            self._note_speculative_hit()
            return hit
        with self._refresh_lock:
            # the precompute thread may have refreshed while we waited
            hit = fresh()
            if hit is not None:
                self._note_speculative_hit()
                return hit
            # a pending speculative install that forced a recompute was a
            # missed prediction — the generation moved before it was served
            self._note_speculative_stale()
            computed_ms = self._now_ms()
            # generation is read BEFORE the (multi-second at scale) model
            # build: a concurrent sampling tick bumping it mid-build must
            # only cause an extra refresh, never stamp the cache newer than
            # the data it was computed from
            gen = self.load_monitor.model_generation().as_tuple()
            # allow.capacity.estimation.on.proposal.precompute: whether the
            # precompute path tolerates estimated broker capacities
            allow_est = self.config.get_boolean(
                "allow.capacity.estimation.on.proposal.precompute")
            # steady-state fast path: the resident session ingests this
            # round's metric/topology deltas and the optimizer starts from
            # the device-resident state — the snapshot->pad->upload rebuild
            # only happens on epoch changes (shape growth / churn budget)
            session = self._usable_session(None, False, False,
                                           allow_capacity_estimation=allow_est)
            if session is not None:
                ct = meta = None
            else:
                ct, meta = self.load_monitor.cluster_model(
                    allow_capacity_estimation=allow_est)
                # the configured exclusion regex applies to precomputed
                # proposals (the session bakes it in at rebuild)
                ct = self._apply_excluded_topics(ct, meta, None)
            # the precompute path records violations instead of failing the
            # cache refresh (GoalOptimizer.java precompute thread logs+retries)
            self.flight_recorder.note_operation("PROPOSALS")
            res = self.goal_optimizer.optimizations(ct, meta,
                                                    raise_on_failure=False,
                                                    session=session)
            with self._cache_lock:
                self._proposal_cache = res
                self._proposal_cache_generation = gen
                self._proposal_cache_ms = computed_ms
            return res

    # ---------------------------------------------------------------- state
    def state_json(self, substates=None) -> dict:
        out = {}
        substates = [s.upper() for s in (substates or
                     ["MONITOR", "EXECUTOR", "ANALYZER", "ANOMALY_DETECTOR"])]
        if "MONITOR" in substates:
            out["MonitorState"] = self.load_monitor.state_json()
        if "EXECUTOR" in substates:
            out["ExecutorState"] = self.executor.state_json()
        if "ANALYZER" in substates:
            with self._cache_lock:
                ready = self._proposal_cache is not None
            from cruise_control_tpu_torch.analyzer.goals import GOAL_CLASSES
            out["AnalyzerState"] = {
                "isProposalReady": ready,
                "goals": self.goal_optimizer.default_goal_names,
                # every goal the analyzer can run on request (reference
                # AnalyzerState.java goalReadiness catalog role)
                "supportedGoals": sorted(GOAL_CLASSES),
            }
            if self.resident_session is not None:
                out["AnalyzerState"]["residentSession"] = \
                    self.resident_session.state_json()
        if "ANOMALY_DETECTOR" in substates:
            out["AnomalyDetectorState"] = self.anomaly_detector.state_json()
        if "SENSORS" in substates:
            out["Sensors"] = self.sensors.to_json()
        if "ROUND_TRACES" in substates:
            # flight recorder: the bounded ring of per-round traces
            out["RoundTraces"] = self.flight_recorder.to_json()
        if "TRACES" in substates:
            # causal span journal: recent trace TREES (verdict -> operation
            # -> optimize round -> execution phases), nested by parent
            out["Traces"] = self.tracer.to_json()
            out["Traces"]["journal"] = self.journal.state_json()
        if "PIPELINE" in substates and self.service_pipeline is not None:
            # the continuous pipelined loop's stage/backpressure state
            out["PipelineState"] = self.service_pipeline.state_json()
        if "FORECAST" in substates:
            fstate = {"enabled": self.forecaster is not None}
            if self.forecaster is not None:
                fstate.update(self.forecaster.state_json())
                fstate["detector"] = \
                    self.predicted_goal_violation_detector.state_json()
                fstate["speculative"] = self.speculative_state_json()
            out["ForecastState"] = fstate
        return out

    def health_json(self) -> dict:
        """GET /health: rolling SLO attainment + degradation state, computed
        live from the sensor registry (no new instrumentation — the same
        timers /metrics exports). ``status``: "ok" (every SLO with samples
        attained, nothing degraded), "degraded" (an open breaker, a stalled
        pipeline or a paused execution), "breach" (an SLO with samples over
        its ``health.slo.*`` target). Percentiles are reservoir-rolling over
        the recent observation window, exact buckets ride /metrics."""
        snap = self.sensors.to_json()
        detect_ms = self._health_slo_ms["detect"]
        heal_ms = self._health_slo_ms["heal"]
        req_ms = self._health_slo_ms["request"]

        def row(timer_name: str, q_key: str, target_ms: float) -> dict:
            t = snap.get(timer_name)
            n = t.get("count", 0) if isinstance(t, dict) else 0
            val_s = t.get(q_key) if isinstance(t, dict) else None
            out = {"n": n, q_key: val_s, "targetMs": target_ms}
            out["ok"] = (None if not n
                         else bool(val_s * 1000.0 <= target_ms))
            return out

        detect = row("anomaly-detection-to-fix-timer", "p95Sec", detect_ms)
        heal = {name.rsplit("-self-healing-fix-timer", 1)[0]:
                row(name, "p95Sec", heal_ms)
                for name in snap
                if name.endswith("-self-healing-fix-timer")}
        requests = {name.rsplit("-successful-request-execution-timer", 1)[0]:
                    row(name, "p99Sec", req_ms)
                    for name in snap
                    if name.endswith("-successful-request-execution-timer")}
        rows = [detect, *heal.values(), *requests.values()]
        breached = [r for r in rows if r["ok"] is False]
        ft = self.fault_tolerance.state_json()
        pipeline = (self.service_pipeline.state_json()
                    if self.service_pipeline is not None else None)
        degraded = bool(ft["degraded"] or self.executor.paused
                        or (pipeline or {}).get("stalled"))
        status = ("breach" if breached
                  else "degraded" if degraded else "ok")

        def meter_count(name: str) -> int:
            m = snap.get(name)
            return m.get("count", 0) if isinstance(m, dict) else 0

        return {
            "status": status, "nowMs": self._now_ms(),
            # single-controller deployments are an implicit leader
            "role": "leader",
            "ha": None,
            "slo": {"detect": detect, "heal": heal, "requests": requests,
                    "breached": len(breached)},
            "degraded": ft["degraded"],
            "openCircuits": self.fault_tolerance.open_circuits(),
            "breakers": ft["breakers"],
            "executorPaused": self.executor.paused,
            "pipeline": ({"stalled": pipeline["stalled"],
                          "stallCount": pipeline["stallCount"],
                          "staleRoundsDropped": pipeline["staleRoundsDropped"]}
                         if pipeline is not None else None),
            "selfHealing": {
                "fixes": meter_count("execution-started"),
                "failures": meter_count("self-healing-fix-failures"),
                "deferrals": meter_count("self-healing-fix-deferrals")},
            "journal": self.journal.state_json(),
        }

    def metrics_text(self) -> str:
        """GET /metrics: the whole MetricRegistry — timers as summaries,
        meters as counters+rates, gauges (incl. the flight recorder's
        last-round gauges) — in Prometheus text exposition format. The ingest
        side already speaks Prometheus (monitor/sampling/prometheus.py), so a
        CC instance can scrape itself."""
        from cruise_control_tpu_torch.common.tracing import render_prometheus
        return render_prometheus(self.sensors.to_json())

    def kafka_cluster_state(self, verbose: bool = False) -> dict:
        """GET /kafka_cluster_state
        (servlet/response/KafkaClusterState.java schema).

        The backend reads ride the shared ``facade.read`` circuit breaker:
        during an outage this read degrades to a DECLARED 503 + Retry-After
        (ServiceUnavailableError) like the rest of the read family
        (``/load`` and ``/partition_load`` ride the monitor's model-build
        breaker), never a raw metadata error."""
        from cruise_control_tpu_torch.api.responses import kafka_cluster_state_json
        from cruise_control_tpu_torch.common.retries import ServiceUnavailableError
        ft = self.fault_tolerance
        try:
            brokers = ft.call("facade.read", self.backend.brokers)
            partitions = ft.call("facade.read", self.backend.partitions)
        except ServiceUnavailableError:
            raise
        except Exception as e:
            raise ServiceUnavailableError(
                f"cluster metadata unavailable ({type(e).__name__}: {e})",
                retry_after_s=ft.retry_after_s()) from e
        return kafka_cluster_state_json(brokers, partitions, verbose=verbose)

    def partition_load(self, sort_by: str = "DISK", limit: int = 50,
                       min_valid_partition_ratio: float | None = None) -> list:
        """GET /partition_load: per-partition utilization rows in the
        reference record schema (PartitionLoadState.java: topic, partition,
        leader, followers, the four Resource JSON names, msg_in). The model
        build requires ``min_valid_partition_ratio`` valid partitions,
        defaulting to MonitorConfig min.valid.partition.ratio
        (PartitionLoadRunnable.java)."""
        from cruise_control_tpu_torch.common.resources import Resource
        ratio = (min_valid_partition_ratio if min_valid_partition_ratio
                 is not None
                 else self.config.get_double("min.valid.partition.ratio"))
        ct, meta = self._model(ModelCompletenessRequirements(
            min_monitored_partitions_percentage=ratio))
        loads = np.asarray(ct.leader_load)
        lead = np.asarray(ct.replica_is_leader)
        valid = np.asarray(ct.replica_valid)
        part_of = np.asarray(ct.replica_partition)
        broker_of = np.asarray(ct.replica_broker)
        res = Resource[sort_by.upper()] if sort_by.upper() in Resource.__members__ \
            else Resource.DISK
        # sort + truncate FIRST; followers are gathered only for the emitted
        # rows (at 1M replicas materializing every partition's follower list
        # would cost seconds of host time for discarded data)
        leaders = np.flatnonzero(valid & lead)
        order = np.argsort(-loads[leaders, res])[:limit]
        emit = leaders[order]
        emit_parts = np.unique(part_of[emit])
        followers_by_part: dict[int, list] = {int(p): [] for p in emit_parts}
        fmask = valid & ~lead & np.isin(part_of, emit_parts)
        for j in np.flatnonzero(fmask):
            followers_by_part[int(part_of[j])].append(
                int(meta.broker_ids[int(broker_of[j])]))
        rows = []
        for j in emit:
            pi = int(part_of[j])
            t, p = meta.partition_ids[pi]
            rows.append({"topic": t, "partition": p,
                         "cpu": float(loads[j, Resource.CPU]),
                         "networkInbound": float(loads[j, Resource.NW_IN]),
                         "networkOutbound": float(loads[j, Resource.NW_OUT]),
                         "disk": float(loads[j, Resource.DISK]),
                         "msg_in": 0.0,
                         "leader": int(meta.broker_ids[int(broker_of[j])]),
                         "followers": followers_by_part.get(pi, [])})
        return rows
