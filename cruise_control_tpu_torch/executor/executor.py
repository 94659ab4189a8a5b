"""(Counterpart of ``cruise_control_tpu/executor/executor.py``, with the port's imports.)
Executor: throttled, concurrency-capped proposal execution.

Reference: executor/Executor.java:76 (1,636) — execution lifecycle:
reservation, ``executeProposals`` (:567), the ProposalExecutionRunnable's
three phases (:1079-1130): inter-broker moves -> intra-broker moves ->
leadership; progress polling against cluster metadata; user-initiated stop and
force-stop (:873-899); ReplicationThrottleHelper (:28-46) wraps the moves with
a replication throttle and cleans it up after; ConcurrencyAdjuster
(:335-448) raises/lowers the per-broker cap between checks; history of
recently removed/demoted brokers (:449-506).

Actuation goes through the ClusterBackend SPI (the reference writes ZK
reassignment znodes + calls AdminClient). Time is injected: the SimClock
advances the simulated backend, a WallClock sleeps — same executor code for
tests and a real deployment.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time as _time
from collections import deque

LOG = logging.getLogger(__name__)

from cruise_control_tpu_torch.common.retries import NON_RETRYABLE_ERRORS
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import build_strategy
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskState, TaskType


class ExecutorKilledError(RuntimeError):
    """Raised inside an execution when :meth:`Executor.kill` severed the
    controller mid-batch (HA leader-kill fault). Unlike a stop, NOTHING is
    cleaned up — in-flight reassignments keep running backend-side, throttles
    stay set, the execution span never ends — so the journaled task census
    freezes at exactly the kill point and a promoted standby can adopt the
    execution from it (``Executor.adopt_census``)."""


class WallClock:
    def __init__(self):
        self._t0 = _time.time()

    def now_ms(self) -> float:
        return (_time.time() - self._t0) * 1000.0

    def sleep_ms(self, ms: float) -> None:
        _time.sleep(ms / 1000.0)


class SimClock:
    """Advances the simulated backend instead of sleeping."""

    def __init__(self, backend):
        self._backend = backend

    def now_ms(self) -> float:
        return float(self._backend.now_ms())

    def sleep_ms(self, ms: float) -> None:
        self._backend.advance(ms)


class ExecutorState:
    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT = "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    INTRA_BROKER_REPLICA_MOVEMENT = "INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    LEADER_MOVEMENT = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


@dataclasses.dataclass
class ExecutorConfigView:
    per_broker_cap: int = 5
    cluster_cap: int = 1250
    intra_broker_cap: int = 2
    leadership_cap: int = 1000
    progress_check_interval_ms: float = 10_000.0
    throttle_bytes_per_sec: int | None = None
    adjuster_enabled: bool = False
    adjuster_max_per_broker: int = 12
    adjuster_min_per_broker: int = 1
    adjuster_max_leadership: int = 1125
    adjuster_min_leadership: int = 100
    adjuster_limits: tuple = (
        ("BROKER_LOG_FLUSH_TIME_MS_999TH", 2000.0),
        ("BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH", 500.0),
        ("BROKER_PRODUCE_LOCAL_TIME_MS_999TH", 1000.0),
        ("BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH", 500.0),
        ("BROKER_REQUEST_QUEUE_SIZE", 1000.0),
    )
    adjuster_add_replica: int = 1
    adjuster_add_leadership: int = 100
    adjuster_div_replica: int = 2
    adjuster_div_leadership: int = 2
    # per-movement-type AIMD gates + the min-ISR safety check
    # (ExecutorConfig concurrency.adjuster.{inter.broker.replica,leadership}.
    # enabled and concurrency.adjuster.min.isr.*)
    adjuster_replica_enabled: bool = True
    adjuster_leadership_enabled: bool = True
    min_isr_check_enabled: bool = False
    min_isr_cache_size: int = 5000
    min_isr_retention_ms: float = 720_000.0
    min_isr_num_check: int = 100
    min_progress_check_interval_ms: float = 5_000.0
    slow_task_threshold_ms: float = 90_000.0
    slow_task_backoff_ms: float = 60_000.0
    # max.num.cluster.movements: bound on TOTAL ongoing movements of any
    # kind (ExecutorConfig.java:76-79); caps both the inter-broker in-flight
    # set and a leadership batch
    total_movement_cap: int = 1250
    # leader.movement.timeout.ms (ExecutorConfig.java:139-141)
    leader_movement_timeout_ms: float = 180_000.0
    # concurrency.adjuster.interval.ms (ExecutorConfig.java:213): the AIMD
    # adjuster runs on its own cadence, not every progress tick
    adjuster_interval_ms: float = 360_000.0
    # {demotion,removal}.history.retention.time.ms
    demotion_history_retention_ms: float = 1_209_600_000.0
    removal_history_retention_ms: float = 1_209_600_000.0

    @classmethod
    def from_config(cls, cfg) -> "ExecutorConfigView":
        throttle = cfg.get_int("default.replication.throttle")
        return cls(
            adjuster_replica_enabled=cfg.get_boolean(
                "concurrency.adjuster.inter.broker.replica.enabled"),
            adjuster_leadership_enabled=cfg.get_boolean(
                "concurrency.adjuster.leadership.enabled"),
            min_isr_check_enabled=cfg.get_boolean(
                "concurrency.adjuster.min.isr.check.enabled"),
            min_isr_cache_size=cfg.get_int(
                "concurrency.adjuster.min.isr.cache.size"),
            min_isr_retention_ms=float(cfg.get_int(
                "concurrency.adjuster.min.isr.retention.ms")),
            min_isr_num_check=cfg.get_int(
                "concurrency.adjuster.num.min.isr.check"),
            min_progress_check_interval_ms=float(cfg.get_int(
                "min.execution.progress.check.interval.ms")),
            slow_task_threshold_ms=float(cfg.get_int(
                "task.execution.alerting.threshold.ms")),
            slow_task_backoff_ms=float(cfg.get_int(
                "slow.task.alerting.backoff.ms")),
            per_broker_cap=cfg.get_int("num.concurrent.partition.movements.per.broker"),
            cluster_cap=cfg.get_int("max.num.cluster.partition.movements"),
            intra_broker_cap=cfg.get_int("num.concurrent.intra.broker.partition.movements"),
            leadership_cap=cfg.get_int("num.concurrent.leader.movements"),
            progress_check_interval_ms=cfg.get_int("execution.progress.check.interval.ms"),
            throttle_bytes_per_sec=None if throttle < 0 else throttle,
            adjuster_enabled=cfg.get_boolean("concurrency.adjuster.enabled"),
            adjuster_max_per_broker=cfg.get_int(
                "concurrency.adjuster.max.partition.movements.per.broker"),
            adjuster_min_per_broker=cfg.get_int(
                "concurrency.adjuster.min.partition.movements.per.broker"),
            adjuster_max_leadership=cfg.get_int(
                "concurrency.adjuster.max.leadership.movements"),
            adjuster_min_leadership=cfg.get_int(
                "concurrency.adjuster.min.leadership.movements"),
            adjuster_limits=(
                ("BROKER_LOG_FLUSH_TIME_MS_999TH",
                 cfg.get_double("concurrency.adjuster.limit.log.flush.time.ms")),
                ("BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH",
                 cfg.get_double("concurrency.adjuster.limit.follower.fetch.local.time.ms")),
                ("BROKER_PRODUCE_LOCAL_TIME_MS_999TH",
                 cfg.get_double("concurrency.adjuster.limit.produce.local.time.ms")),
                ("BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH",
                 cfg.get_double("concurrency.adjuster.limit.consumer.fetch.local.time.ms")),
                ("BROKER_REQUEST_QUEUE_SIZE",
                 cfg.get_double("concurrency.adjuster.limit.request.queue.size")),
            ),
            adjuster_add_replica=cfg.get_int(
                "concurrency.adjuster.additive.increase.inter.broker.replica"),
            adjuster_add_leadership=cfg.get_int(
                "concurrency.adjuster.additive.increase.leadership"),
            adjuster_div_replica=cfg.get_int(
                "concurrency.adjuster.multiplicative.decrease.inter.broker.replica"),
            adjuster_div_leadership=cfg.get_int(
                "concurrency.adjuster.multiplicative.decrease.leadership"),
            total_movement_cap=cfg.get_int("max.num.cluster.movements"),
            leader_movement_timeout_ms=float(cfg.get_int(
                "leader.movement.timeout.ms")),
            adjuster_interval_ms=float(cfg.get_int(
                "concurrency.adjuster.interval.ms")),
            demotion_history_retention_ms=float(cfg.get_int(
                "demotion.history.retention.time.ms")),
            removal_history_retention_ms=float(cfg.get_int(
                "removal.history.retention.time.ms")),
        )


class MinIsrCache:
    """Bounded (topic -> min.insync.replicas) cache with entry freshness
    (Executor.java MinIsrCache role; ExecutorConfig concurrency.adjuster.
    min.isr.{cache.size, retention.ms}). Stale/evicted entries are re-fetched
    from the TopicConfigProvider on demand."""

    def __init__(self, provider, max_size: int = 5000,
                 retention_ms: float = 720_000.0):
        self._provider = provider
        self._max = max_size
        self._retention_ms = retention_ms
        self._entries: dict[str, tuple[int, float]] = {}  # topic -> (minIsr, ts)

    def min_isr(self, topic: str, now_ms: float) -> int:
        hit = self._entries.get(topic)
        if hit is not None and now_ms - hit[1] < self._retention_ms:
            return hit[0]
        value = self._provider.min_insync_replicas(topic)
        if len(self._entries) >= self._max:
            # evict the stalest entry
            oldest = min(self._entries, key=lambda t: self._entries[t][1])
            del self._entries[oldest]
        self._entries[topic] = (value, now_ms)
        return value


class ConcurrencyAdjuster:
    """AIMD movement-concurrency control from live broker metrics.

    Reference: Executor.java:335-448 (inner ConcurrencyAdjuster) +
    ExecutionUtils.recommendedConcurrency — if ANY alive broker exceeds a
    configured limit for one of the watched 999th-percentile latency / queue
    metrics, the concurrency is divided (multiplicative decrease, clamped to
    the configured min); if all brokers are healthy it is increased additively
    (clamped to the max). When the min-ISR check is enabled
    (concurrency.adjuster.min.isr.check.enabled), partitions at/under their
    topic's min.insync.replicas count as over-limit too — movement concurrency
    backs off while the cluster is fragile.
    """

    def __init__(self, cfg: ExecutorConfigView, min_isr_cache=None,
                 backend=None, clock=None):
        self._cfg = cfg
        self._min_isr = min_isr_cache
        self._backend = backend
        # the executor's clock (SimClock/WallClock): MinIsrCache freshness
        # must advance with the execution, not with a backend attribute that
        # may not exist (in which case entries would never expire)
        self._clock = clock or WallClock()
        self._min_isr_cursor = 0   # rotating sample window over partitions
        self.history: deque = deque(maxlen=100)

    def _min_isr_violations(self) -> list:
        """A rotating window of num.min.isr.check partitions whose in-sync
        replica count is at/below the topic's min.insync.replicas — the
        cursor advances every tick so the whole cluster is covered over
        successive checks, not just a fixed prefix. The effective ISR is the
        backend's reported one, falling back to replicas on alive brokers."""
        if (not self._cfg.min_isr_check_enabled or self._min_isr is None
                or self._backend is None):
            return []
        brokers = self._backend.brokers()
        now_ms = self._clock.now_ms()
        items = list(self._backend.partitions().items())
        n = self._cfg.min_isr_num_check
        start = self._min_isr_cursor % max(len(items), 1)
        self._min_isr_cursor = start + n
        window = items[start:start + n]
        if len(window) < n:   # wrap
            window += items[:n - len(window)]
        bad = []
        for (topic, part), info in window:
            isr = getattr(info, "isr", None)
            if isr is None:
                isr = [r for r in info.replicas
                       if brokers.get(r) is not None and brokers[r].alive]
            need = self._min_isr.min_isr(topic, now_ms)
            if len(isr) <= need:
                bad.append((topic, part, len(isr), need))
        return bad

    def _over_limit(self, broker_metrics: dict) -> list:
        over = []
        for b, metrics in broker_metrics.items():
            for name, limit in self._cfg.adjuster_limits:
                v = metrics.get(name)
                if v is not None and v > limit:
                    over.append((b, name, v, limit))
        over.extend(("minIsr", f"{t}-{p}", in_sync, need)
                    for t, p, in_sync, need in self._min_isr_violations())
        return over

    def recommend_replica_concurrency(self, current: int, broker_metrics: dict) -> int:
        over = self._over_limit(broker_metrics)
        if over:
            new = max(self._cfg.adjuster_min_per_broker,
                      current // self._cfg.adjuster_div_replica)
        else:
            new = min(self._cfg.adjuster_max_per_broker,
                      current + self._cfg.adjuster_add_replica)
        if new != current:
            self.history.append({"type": "INTER_BROKER_REPLICA", "from": current,
                                 "to": new, "overLimit": over[:3]})
        return new

    def recommend_leadership_concurrency(self, current: int, broker_metrics: dict) -> int:
        over = self._over_limit(broker_metrics)
        if over:
            new = max(self._cfg.adjuster_min_leadership,
                      current // self._cfg.adjuster_div_leadership)
        else:
            new = min(self._cfg.adjuster_max_leadership,
                      current + self._cfg.adjuster_add_leadership)
        if new != current:
            self.history.append({"type": "LEADERSHIP", "from": current,
                                 "to": new, "overLimit": over[:3]})
        return new


class Executor:
    def __init__(self, backend, config=None, clock=None, strategy_names=None,
                 sensors=None, fault_tolerance=None, tracer=None,
                 journal=None):
        from cruise_control_tpu_torch.common.sensors import MetricRegistry
        self._sensors = sensors if sensors is not None else MetricRegistry()
        # causal span journal (common/tracing.py): every execution opens an
        # "execution" span under the caller's explicit parent handle (the
        # facade's operation span), with one "phase" child per executor
        # phase; every task-state transition lands as a {"kind": "task"}
        # journal event tied to the execution span — the durable census.
        self._tracer = tracer
        self._journal = journal
        # Executor sensor catalog (Sensors.md): ongoing-execution gauge +
        # started/stopped execution meters + the proposal-execution-timer
        # (whole 3-phase execution wall, on the injected clock — simulated
        # seconds in the sim, so heal executions feed the same catalog the
        # chaos campaigns aggregate)
        self._sensors.gauge("ongoing-execution",
                            lambda: int(self.has_ongoing_execution()))
        self._execution_meter = self._sensors.meter("execution-started")
        self._execution_stopped_meter = self._sensors.meter("execution-stopped")
        self._execution_timer = self._sensors.timer("proposal-execution-timer")
        self._backend = backend
        self._cfg = (ExecutorConfigView.from_config(config) if config is not None
                     else ExecutorConfigView())
        self._clock = clock or (SimClock(backend) if hasattr(backend, "advance")
                                else WallClock())
        # strategy catalog + default chain from config
        # (ExecutorConfig replica.movement.strategies = available plugin
        # classes; default.replica.movement.strategies = the chain used when
        # a request names none; ExecutionTaskPlanner.java:65-78)
        self._strategy_registry = None
        if config is not None:
            from cruise_control_tpu_torch.executor.strategy import strategy_registry
            self._strategy_registry = strategy_registry(
                config.get_list("replica.movement.strategies"))
            if strategy_names is None:
                strategy_names = config.get_list(
                    "default.replica.movement.strategies")
        self._strategy = build_strategy(
            strategy_names or ["BaseReplicaMovementStrategy"],
            registry=self._strategy_registry)
        self._state = ExecutorState.NO_TASK_IN_PROGRESS
        self._stop_requested = False
        self._force_stop = False
        self._lock = threading.Lock()
        self._current_planner: ExecutionTaskPlanner | None = None
        self._history: list[dict] = []
        self._recently_removed_brokers: dict[int, float] = {}
        self._recently_demoted_brokers: dict[int, float] = {}
        self._execution_thread: threading.Thread | None = None
        self._proposal_generation: int | None = None
        self._reservation = None
        min_isr_cache = None
        self._notifier = None
        if config is not None:
            provider = config.get_configured_instance("topic.config.provider.class")
            if provider is not None:
                attach = getattr(provider, "attach", None)
                if callable(attach):
                    attach(backend)
                min_isr_cache = MinIsrCache(
                    provider, max_size=self._cfg.min_isr_cache_size,
                    retention_ms=self._cfg.min_isr_retention_ms)
            # ExecutorNotifier SPI (executor.notifier.class)
            self._notifier = config.get_configured_instance(
                "executor.notifier.class")
        self._adjuster = ConcurrencyAdjuster(self._cfg, min_isr_cache, backend,
                                             clock=self._clock)
        self._last_adjust_ms = -1e18  # concurrency.adjuster.interval.ms gate
        self._slow_task_alerts: dict[int, float] = {}  # task_id -> last alert ms
        # fault tolerance at the backend boundary (common/retries.py):
        # movement submission and progress verification retry transient
        # failures with jittered backoff ON THE INJECTED CLOCK and sit behind
        # per-class circuit breakers ("executor.submit" / "executor.verify").
        # When a breaker is open the execution PAUSES mid-batch — unsubmitted
        # tasks stay PENDING, in-flight census untouched — and resumes via
        # the breaker's half-open probe instead of wedging or crashing.
        # app.py passes its shared instance so REST serving degrades on the
        # same breaker state the executor observes.
        if fault_tolerance is None:
            from cruise_control_tpu_torch.common.retries import BackendFaultTolerance
            fault_tolerance = BackendFaultTolerance(
                config, clock_ms=self._clock.now_ms, sensors=self._sensors)
        self._ft = fault_tolerance
        self._paused = False
        self._pause_ticks = 0
        self._pause_meter = self._sensors.meter("executor-backend-pauses")
        # HA leader-kill switch: kill() flips it (typically from a backend
        # schedule_at callback firing inside a progress sleep); every phase
        # loop polls it and raises ExecutorKilledError, freezing the census
        self._killed = False
        # failover adoption seed: adopt_census() stages the dead leader's
        # already-submitted inter-broker moves here; _inter_broker_phase
        # enters its loop with them as in-flight
        self._adopted_in_flight: list[ExecutionTask] = []

    @property
    def fault_tolerance(self):
        return self._ft

    @property
    def paused(self) -> bool:
        """True while the current execution is waiting out a backend
        failure/open breaker (mid-batch pause)."""
        return self._paused

    def _pause_tick(self, what: str) -> None:
        """One paused progress tick: record it and sleep the progress
        interval on the injected clock (the breaker's reset timeout runs on
        the same clock, so the next tick may probe HALF_OPEN)."""
        if not self._paused:
            LOG.warning("execution paused: backend %s unavailable "
                        "(breakers: %s)", what, self._ft.open_circuits())
        self._paused = True
        self._pause_ticks += 1
        self._pause_meter.mark()
        self._clock.sleep_ms(self._cfg.progress_check_interval_ms)

    def _resume_if_paused(self) -> None:
        if self._paused:
            self._paused = False
            LOG.info("execution resumed: backend reachable again")

    # -------------------------------------------------------- HA leader-kill
    def kill(self) -> None:
        """Simulate the controller process dying mid-execution. No cleanup
        runs: the next kill-check in any phase loop raises
        ExecutorKilledError and the finish path is skipped entirely, so the
        journal's last word on this execution is the true mid-batch census.
        A killed executor refuses all further executions."""
        self._killed = True

    @property
    def killed(self) -> bool:
        return self._killed

    def _check_killed(self) -> None:
        if self._killed:
            raise ExecutorKilledError(
                "executor killed mid-execution "
                f"(operation={getattr(self, '_operation', None)!r})")

    # ---------------------------------------------------------- reservation
    def reserve(self, owner: str) -> None:
        """setGeneratingProposalsForExecution role (Executor.java:828): only one
        party may generate-and-execute at a time."""
        with self._lock:
            if self._reservation is not None or self._state != ExecutorState.NO_TASK_IN_PROGRESS:
                raise RuntimeError(f"executor busy (state={self._state}, "
                                   f"reserved by {self._reservation})")
            self._reservation = owner

    def release(self, owner: str) -> None:
        with self._lock:
            if self._reservation == owner:
                self._reservation = None

    # ------------------------------------------------------------ lifecycle
    @property
    def state(self) -> str:
        return self._state

    def has_ongoing_execution(self) -> bool:
        return self._state not in (ExecutorState.NO_TASK_IN_PROGRESS,)

    def stop_execution(self, force: bool = False) -> None:
        """Graceful stop: no new tasks; force: cancel in-flight reassignments
        (znode deletion, ExecutionUtils.java:305-307)."""
        with self._lock:
            # count once per stopped execution, not per stop call
            newly_stopped = (self._state != ExecutorState.NO_TASK_IN_PROGRESS
                             and not self._stop_requested)
            self._stop_requested = True
            self._force_stop = force
        if newly_stopped:
            self._execution_stopped_meter.mark()

    def _expire_history(self) -> None:
        """Drop blocklist entries past their retention
        ({removal,demotion}.history.retention.time.ms, Executor.java:449-506)."""
        now = self._clock.now_ms()
        for hist, retention in (
                (self._recently_removed_brokers,
                 self._cfg.removal_history_retention_ms),
                (self._recently_demoted_brokers,
                 self._cfg.demotion_history_retention_ms)):
            # pop(..., None): concurrent REST threads may race this sweep
            for b in [b for b, ts in list(hist.items())
                      if now - ts > retention]:
                hist.pop(b, None)

    def recently_removed_brokers(self) -> set:
        self._expire_history()
        return set(self._recently_removed_brokers)

    def recently_demoted_brokers(self) -> set:
        self._expire_history()
        return set(self._recently_demoted_brokers)

    def drop_recently_removed_brokers(self, brokers) -> list:
        """POST /admin?drop_recently_removed_brokers (Executor.java
        drop*Brokers): un-blocklist brokers so proposals may target them."""
        dropped = [b for b in brokers if b in self._recently_removed_brokers]
        for b in dropped:
            del self._recently_removed_brokers[b]
        return dropped

    def drop_recently_demoted_brokers(self, brokers) -> list:
        dropped = [b for b in brokers if b in self._recently_demoted_brokers]
        for b in dropped:
            del self._recently_demoted_brokers[b]
        return dropped

    def set_concurrency(self, per_broker: int | None = None,
                        intra_broker: int | None = None,
                        leadership: int | None = None,
                        progress_check_interval_ms: float | None = None) -> dict:
        """POST /admin concurrency overrides (Executor.setRequestedMovementConcurrency)."""
        for name, v in (("concurrent_partition_movements_per_broker", per_broker),
                        ("concurrent_intra_broker_partition_movements", intra_broker),
                        ("concurrent_leader_movements", leadership),
                        ("execution_progress_check_interval_ms",
                         progress_check_interval_ms)):
            if v is not None and v <= 0:
                # a 0 cap would stall the execution loop forever
                raise ValueError(f"{name} must be > 0, got {v}")
        if per_broker is not None:
            self._cfg.per_broker_cap = int(per_broker)
        if intra_broker is not None:
            self._cfg.intra_broker_cap = int(intra_broker)
        if leadership is not None:
            self._cfg.leadership_cap = int(leadership)
        if progress_check_interval_ms is not None:
            # floor per ExecutorConfig min.execution.progress.check.interval.ms
            self._cfg.progress_check_interval_ms = max(
                float(progress_check_interval_ms),
                self._cfg.min_progress_check_interval_ms)
        return {"perBroker": self._cfg.per_broker_cap,
                "intraBroker": self._cfg.intra_broker_cap,
                "leadership": self._cfg.leadership_cap,
                "progressCheckIntervalMs": self._cfg.progress_check_interval_ms}

    def validate_strategies(self, strategy_names: list) -> None:
        """Raise ValueError early (before any optimization work) when a
        requested movement-strategy name is not in the configured catalog."""
        build_strategy(strategy_names, registry=self._strategy_registry)

    def note_removed_brokers(self, brokers) -> None:
        for b in brokers:
            self._recently_removed_brokers[b] = self._clock.now_ms()

    def note_demoted_brokers(self, brokers) -> None:
        for b in brokers:
            self._recently_demoted_brokers[b] = self._clock.now_ms()

    # ------------------------------------------------------------ execution
    def _alert_slow_tasks(self, in_flight: dict) -> None:
        """Alert on tasks in flight longer than the alerting threshold
        (ExecutorConfig task.execution.alerting.threshold.ms), re-alerting the
        same task only after slow.task.alerting.backoff.ms."""
        now = self._clock.now_ms()
        for t in in_flight.values():
            if t.start_ms < 0 or now - t.start_ms < self._cfg.slow_task_threshold_ms:
                continue
            last = self._slow_task_alerts.get(t.task_id, -1e18)
            if now - last < self._cfg.slow_task_backoff_ms:
                continue
            self._slow_task_alerts[t.task_id] = now
            self._sensors.meter("slow-task-alerts").mark()
            LOG.warning("slow task %s: %s in flight for %.0f s (threshold %.0f s)",
                        t.task_id, t.tp, (now - t.start_ms) / 1000.0,
                        self._cfg.slow_task_threshold_ms / 1000.0)

    def execute_proposals(self, proposals: list, blocking: bool = True,
                          context: dict | None = None,
                          strategy_names: list | None = None,
                          generation: int | None = None,
                          parent_span=None) -> None:
        """Run the 3-phase execution (Executor.executeProposals :567).
        ``strategy_names`` overrides the configured default movement-strategy
        chain for this execution (the REST replica_movement_strategies
        parameter role). ``generation`` is the metadata generation the
        proposals were computed against (the pipelined loop's staleness tag
        — recorded for observability; the pipeline drops stale sets BEFORE
        they reach here). ``parent_span`` is the caller's explicit causal
        handle: the execution span (and with it the whole task census)
        hangs under the operation that computed the proposals."""
        strategy = (build_strategy(strategy_names, registry=self._strategy_registry)
                    if strategy_names else self._strategy)
        with self._lock:
            if self._killed:
                raise ExecutorKilledError("executor killed; refusing new "
                                          "executions")
            if self._state != ExecutorState.NO_TASK_IN_PROGRESS:
                raise RuntimeError("an execution is already in progress")
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested = False
            self._force_stop = False
            self._proposal_generation = generation
        self._execution_meter.mark()
        # a fresh execution consults the current broker metrics immediately
        # (the reference's adjuster thread runs continuously; ours only runs
        # during executions, so re-arm the cadence gate at start)
        self._last_adjust_ms = -1e18
        planner = ExecutionTaskPlanner(strategy)
        if context is None:
            try:
                partitions = self._ft.call("executor.verify",
                                           self._backend.partitions)
                sizes = {tp: info.size_mb for tp, info in partitions.items()}
            except Exception:
                # strategy sort degrades gracefully without sizes; the
                # execution itself retries/pauses through the same breakers
                sizes = {}
            context = {"partition_size_mb": sizes}
        self._operation = context.get("operation", "proposal execution")
        self._slow_task_alerts.clear()
        planner.add_proposals(proposals, context)
        self._current_planner = planner
        # causal execution span + durable task census: transitions journal
        # through ExecutionTask.on_transition keyed by the task's PLAN INDEX
        # (tp + type + index are deterministic per (scenario, seed); the
        # process-global task_id is not)
        exec_span = None
        if self._tracer is not None:
            exec_span = self._tracer.span(
                "execution", self._operation, parent=parent_span,
                tasks=len(planner.all_tasks))
        if self._journal is not None:
            journal = self._journal
            trace = exec_span.trace_id if exec_span is not None else None
            span_id = exec_span.span_id if exec_span is not None else None
            for i, t in enumerate(planner.all_tasks):
                def on_transition(task, state, now, _i=i):
                    journal.append(
                        "task", i=_i, tp=list(task.tp),
                        ty=task.task_type.value, st=state.name,
                        trace=trace, span=span_id)
                t.on_transition = on_transition
                # initial census row: tasks are born PENDING (never via a
                # transition), carrying enough proposal payload for a
                # standby to rebuild the ExecutionProposal and adopt the
                # execution after a leader kill — all fields deterministic
                p = t.proposal
                journal.append(
                    "task", i=i, tp=list(t.tp), ty=t.task_type.value,
                    st="PENDING", trace=trace, span=span_id,
                    ol=p.old_leader, nl=p.new_leader,
                    orp=[list(r) for r in p.old_replicas],
                    nrp=[list(r) for r in p.new_replicas])
        if blocking:
            self._run_execution(planner, exec_span)
        else:
            self._execution_thread = threading.Thread(
                target=self._run_execution, args=(planner, exec_span),
                daemon=True)
            self._execution_thread.start()

    def wait_for_completion(self, timeout_s: float = 60.0) -> None:
        t = self._execution_thread
        if t is not None:
            t.join(timeout_s)
            if not t.is_alive():
                # drop the finished thread so repeated non-blocking
                # executions can never accumulate handler-thread references
                # (asserted by the REST fuzz thread-leak test)
                self._execution_thread = None

    def adopt_census(self, records: list, context: dict | None = None,
                     parent_span=None, blocking: bool = True) -> dict:
        """Failover adoption (HA takeover): resume a dead leader's execution
        from its journaled task census instead of aborting it.

        ``records`` carries one dict per plan-index task — the LAST
        journaled state plus the proposal payload from the initial PENDING
        row ({"i","tp","ty","st","ol","nl","orp","nrp"}). Terminal tasks
        (COMPLETED/ABORTED/DEAD) are skipped; PENDING tasks re-enter a fresh
        planner in their journaled order (the dead leader's strategy sort is
        baked into the plan indexes, so no re-sort); IN_PROGRESS
        inter-broker moves are adopted as in-flight — the backend still
        holds their reassignments and the normal completion polling finishes
        them, so failover ABORTS NOTHING. IN_PROGRESS leadership moves
        re-arm as PENDING (elections are idempotent; re-submitting one that
        already landed completes on the next progress check). IN_PROGRESS
        intra-broker (log-dir) moves also re-arm as PENDING: a journaled
        IN_PROGRESS row means the dead leader's ``alter_replica_logdirs``
        call had already returned (the transition is only journaled after
        the submit), and the call is declarative by ClusterBackend contract
        — it assigns replicas to target log dirs, so re-submitting a move
        that already landed re-asserts the same assignment (the phase also
        re-validates against current metadata first; asserted in
        tests/test_ha.py)."""
        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
        with self._lock:
            if self._killed:
                raise ExecutorKilledError("executor killed; refusing "
                                          "census adoption")
            if self._state != ExecutorState.NO_TASK_IN_PROGRESS:
                raise RuntimeError("an execution is already in progress")
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested = False
            self._force_stop = False
            self._proposal_generation = None
        self._execution_meter.mark()
        self._last_adjust_ms = -1e18
        self._operation = (context or {}).get("operation", "census adoption")
        self._slow_task_alerts.clear()
        planner = ExecutionTaskPlanner(self._strategy)
        by_type: dict[TaskType, list] = {}
        in_flight_tasks: list[ExecutionTask] = []
        for r in sorted(records, key=lambda r: int(r["i"])):
            st = r["st"]
            if st not in ("PENDING", "IN_PROGRESS"):
                continue
            ty = TaskType(r["ty"])
            p = ExecutionProposal(
                topic=r["tp"][0], partition=int(r["tp"][1]),
                old_leader=int(r["ol"]), new_leader=int(r["nl"]),
                old_replicas=tuple((int(b), int(d)) for b, d in r["orp"]),
                new_replicas=tuple((int(b), int(d)) for b, d in r["nrp"]))
            t = ExecutionTask(p, ty)
            by_type.setdefault(ty, []).append(t)
            if st == "IN_PROGRESS" and ty is TaskType.INTER_BROKER_REPLICA_ACTION:
                in_flight_tasks.append(t)
        planner.adopt_tasks(by_type)
        self._current_planner = planner
        exec_span = None
        if self._tracer is not None:
            exec_span = self._tracer.span(
                "execution", self._operation, parent=parent_span,
                tasks=len(planner.all_tasks), adopted=True)
        if self._journal is not None:
            journal = self._journal
            trace = exec_span.trace_id if exec_span is not None else None
            span_id = exec_span.span_id if exec_span is not None else None
            for i, t in enumerate(planner.all_tasks):
                def on_transition(task, state, now, _i=i):
                    journal.append(
                        "task", i=_i, tp=list(task.tp),
                        ty=task.task_type.value, st=state.name,
                        trace=trace, span=span_id)
                t.on_transition = on_transition
                p = t.proposal
                journal.append(
                    "task", i=i, tp=list(t.tp), ty=t.task_type.value,
                    st="PENDING", trace=trace, span=span_id, adopted=True,
                    ol=p.old_leader, nl=p.new_leader,
                    orp=[list(r) for r in p.old_replicas],
                    nrp=[list(r) for r in p.new_replicas])
        # re-arm adopted in-flight moves before the phase loop: the
        # transition lands in the NEW leader's journal, and the phase entry
        # below treats them as already-submitted
        now = self._clock.now_ms()
        for t in in_flight_tasks:
            t.transition(TaskState.IN_PROGRESS, now)
        self._adopted_in_flight = list(in_flight_tasks)
        if blocking:
            self._run_execution(planner, exec_span)
        else:
            self._execution_thread = threading.Thread(
                target=self._run_execution, args=(planner, exec_span),
                daemon=True)
            self._execution_thread.start()
        n_total = len(planner.all_tasks)
        return {"adopted": n_total, "inFlight": len(in_flight_tasks)}

    # ----------------------------------------------------------- throttling
    def _set_throttles(self, planner: ExecutionTaskPlanner) -> tuple:
        """ReplicationThrottleHelper.java:28-46,159: set the global
        leader/follower replication rate AND per-topic throttled-replica
        lists ("partition:broker" entries — sources on the leader list,
        move destinations on the follower list) covering every inter-broker
        move of this execution."""
        if not self._cfg.throttle_bytes_per_sec:
            return False, []
        try:
            self._ft.call("executor.submit",
                          self._backend.set_replication_throttle,
                          self._cfg.throttle_bytes_per_sec,
                          sleep_ms=self._clock.sleep_ms)
        except Exception:
            # an unreachable throttle config must not kill the execution; it
            # proceeds unthrottled (the reference logs and continues too)
            LOG.exception("failed to set replication throttle; "
                          "executing unthrottled")
            self._sensors.meter("throttle-set-failures").mark()
            return False, []
        set_topic_config = getattr(self._backend, "set_topic_config", None)
        if set_topic_config is None:   # backend without topic-config support
            return True, []
        leader: dict[str, set] = {}
        follower: dict[str, set] = {}
        for t in planner.all_tasks:
            if t.task_type is not TaskType.INTER_BROKER_REPLICA_ACTION:
                continue
            p = t.proposal
            for b, _ in p.old_replicas:
                leader.setdefault(p.topic, set()).add(f"{p.partition}:{b}")
            for b in p.replicas_to_add:
                follower.setdefault(p.topic, set()).add(f"{p.partition}:{b}")
        topics = sorted(set(leader) | set(follower))
        applied = []
        for topic in topics:
            try:
                set_topic_config(topic, "leader.replication.throttled.replicas",
                                 ",".join(sorted(leader.get(topic, ()))))
                set_topic_config(topic,
                                 "follower.replication.throttled.replicas",
                                 ",".join(sorted(follower.get(topic, ()))))
            except Exception:
                LOG.exception("failed to set throttled-replica lists for %s",
                              topic)
                self._sensors.meter("throttle-set-failures").mark()
                continue
            applied.append(topic)
        return True, applied

    def _clear_throttles(self, throttled: bool, topics: list) -> None:
        """ReplicationThrottleHelper cleanup (:200): remove the rate and every
        per-topic list, including on stop/force-stop paths."""
        if not throttled:
            return
        try:
            self._ft.call("executor.submit",
                          self._backend.set_replication_throttle, None,
                          sleep_ms=self._clock.sleep_ms)
        except Exception:
            LOG.exception("failed to clear the replication throttle")
            self._sensors.meter("throttle-clear-failures").mark()
        set_topic_config = getattr(self._backend, "set_topic_config", None)
        if set_topic_config is None:
            return
        for topic in topics:
            try:
                set_topic_config(topic,
                                 "leader.replication.throttled.replicas", None)
                set_topic_config(topic,
                                 "follower.replication.throttled.replicas", None)
            except Exception:
                LOG.exception("failed to clear throttled-replica lists for %s",
                              topic)
                self._sensors.meter("throttle-clear-failures").mark()

    # ------------------------------------------------------------ internals
    def _run_execution(self, planner: ExecutionTaskPlanner,
                       exec_span=None) -> None:
        throttled, throttled_topics = False, []
        self._paused = False
        t0_ms = self._clock.now_ms()

        def _phase(name):
            return (exec_span.child("phase", name)
                    if exec_span is not None else None)
        try:
            throttled, throttled_topics = self._set_throttles(planner)
            ph = _phase("inter_broker")
            self._inter_broker_phase(planner)
            if ph is not None:
                ph.end()
            if not self._stop_requested:
                ph = _phase("intra_broker")
                self._intra_broker_phase(planner)
                if ph is not None:
                    ph.end()
            if not self._stop_requested:
                ph = _phase("leadership")
                self._leadership_phase(planner)
                if ph is not None:
                    ph.end()
        finally:
            if self._killed:
                # leader-kill freeze: no throttle cleanup, no timer/history
                # entry, no execution-span end, state stays mid-execution —
                # the journal ends where the process "died" and the standby
                # adopts exactly that census (ExecutorKilledError is already
                # propagating out of this frame)
                pass
            else:
                self._clear_throttles(throttled, throttled_topics)
                self._execution_timer.record(
                    max(self._clock.now_ms() - t0_ms, 0.0) / 1000.0)
                done = sum(1 for t in planner.all_tasks
                           if t.state is TaskState.COMPLETED)
                if exec_span is not None:
                    by_state: dict[str, int] = {}
                    for t in planner.all_tasks:
                        by_state[t.state.name] = by_state.get(t.state.name, 0) + 1
                    exec_span.end(completed=done, total=len(planner.all_tasks),
                                  stopped=self._stop_requested,
                                  aborted=by_state.get("ABORTED", 0),
                                  dead=by_state.get("DEAD", 0))
                self._history.append({
                    "finishedMs": self._clock.now_ms(),
                    "numTasks": len(planner.all_tasks),
                    "numCompleted": done,
                    "stopped": self._stop_requested,
                })
                with self._lock:
                    self._state = ExecutorState.NO_TASK_IN_PROGRESS
                    self._paused = False
                if self._notifier is not None:
                    # ExecutorNotifier SPI (executor.notifier.class): one
                    # notification per finished execution
                    from cruise_control_tpu_torch.executor.notifier import (
                        ExecutorNotification,
                    )
                    n_lead = sum(1 for t in planner.all_tasks
                                 if t.task_type is TaskType.LEADER_ACTION
                                 and t.state is TaskState.COMPLETED)
                    try:
                        self._notifier.on_execution_finished(ExecutorNotification(
                            operation=self._operation,
                            success=not self._stop_requested
                            and done == len(planner.all_tasks),
                            stopped_by_user=self._stop_requested,
                            num_replica_movements=done - n_lead,
                            num_leadership_movements=n_lead))
                    except Exception:
                        LOG.exception("executor notifier failed")

    def _inter_broker_phase(self, planner: ExecutionTaskPlanner) -> None:
        self._state = ExecutorState.INTER_BROKER_REPLICA_MOVEMENT
        in_flight: dict[tuple, ExecutionTask] = {}
        in_flight_by_broker: dict[int, int] = {}
        # failover adoption: moves the dead leader already submitted enter
        # the loop as in-flight — the backend still holds the reassignments,
        # so the normal completion polling finishes them (never re-submitted,
        # never aborted)
        for t in self._adopted_in_flight:
            in_flight[t.tp] = t
            for b in t.brokers_involved:
                in_flight_by_broker[b] = in_flight_by_broker.get(b, 0) + 1
        self._adopted_in_flight = []
        while True:
            self._check_killed()
            if self._stop_requested:
                self._state = ExecutorState.STOPPING_EXECUTION
                if self._force_stop and in_flight:
                    try:
                        self._ft.call("executor.submit",
                                      self._backend.cancel_reassignments,
                                      list(in_flight),
                                      sleep_ms=self._clock.sleep_ms)
                    except NON_RETRYABLE_ERRORS:
                        raise
                    except Exception:
                        # cancellation unreachable: the reassignments are
                        # still running backend-side — keep polling instead
                        # of faking an ABORTED census
                        self._pause_tick("cancel")
                        continue
                    for t in in_flight.values():
                        t.transition(TaskState.ABORTING, self._clock.now_ms())
                        t.transition(TaskState.ABORTED, self._clock.now_ms())
                    in_flight.clear()
                if not in_flight:
                    return
            # completion check — verification failures skip the tick with the
            # census untouched (a task is only COMPLETED on positive evidence)
            try:
                ongoing = self._ft.call("executor.verify",
                                        self._backend.ongoing_reassignments)
            except NON_RETRYABLE_ERRORS:
                raise
            except Exception:
                self._pause_tick("verification")
                continue
            finished = [tp for tp in in_flight if tp not in ongoing]
            for tp in finished:
                t = in_flight.pop(tp)
                t.transition(TaskState.COMPLETED, self._clock.now_ms())
                for b in t.brokers_involved:
                    in_flight_by_broker[b] = max(0, in_flight_by_broker.get(b, 1) - 1)
            # dynamic concurrency: AIMD on live broker metrics on its own
            # cadence (ConcurrencyAdjuster role, Executor.java:335-448;
            # concurrency.adjuster.interval.ms :213-225); gated per movement
            # type (concurrency.adjuster.inter.broker.replica.enabled)
            if (self._cfg.adjuster_enabled and self._cfg.adjuster_replica_enabled
                    and self._adjuster_due()):
                try:
                    metrics = self._ft.call("executor.verify",
                                            self._backend.broker_metrics)
                    self._cfg.per_broker_cap = \
                        self._adjuster.recommend_replica_concurrency(
                            self._cfg.per_broker_cap, metrics)
                except Exception:
                    pass   # keep the current cap; metrics return next tick
            self._alert_slow_tasks(in_flight)
            if not self._stop_requested:
                batch = planner.next_inter_broker_tasks(
                    in_flight_by_broker, self._cfg.per_broker_cap,
                    min(self._cfg.cluster_cap, self._cfg.total_movement_cap),
                    len(in_flight))
                assignments = {t.tp: [b for b, _ in t.proposal.new_replicas]
                               for t in batch}
                if assignments:
                    # submit BEFORE any state transition: a failed submission
                    # leaves the batch PENDING (the planner re-picks it once
                    # the breaker's half-open probe succeeds) — pause, not
                    # wedge, and never a task marked IN_PROGRESS that the
                    # backend never saw
                    try:
                        self._ft.call("executor.submit",
                                      self._backend.alter_partition_reassignments,
                                      assignments,
                                      sleep_ms=self._clock.sleep_ms)
                    except NON_RETRYABLE_ERRORS:
                        raise
                    except Exception:
                        self._pause_tick("movement submission")
                        continue
                    for t in batch:
                        t.transition(TaskState.IN_PROGRESS, self._clock.now_ms())
                        in_flight[t.tp] = t
                        for b in t.brokers_involved:
                            in_flight_by_broker[b] = in_flight_by_broker.get(b, 0) + 1
            self._resume_if_paused()
            if not in_flight and not planner.remaining_inter_broker:
                return
            self._clock.sleep_ms(self._cfg.progress_check_interval_ms)

    def _intra_broker_phase(self, planner: ExecutionTaskPlanner) -> None:
        self._state = ExecutorState.INTRA_BROKER_REPLICA_MOVEMENT
        tasks = planner.next_intra_broker_tasks({}, self._cfg.intra_broker_cap)
        while tasks:
            self._check_killed()
            # re-validate against CURRENT metadata: a fault mid-execution
            # (RF shrink, reassignment landing) may have moved a replica off
            # the broker since the proposal was computed — submitting would
            # only be rejected backend-side, so the task goes DEAD like an
            # ineligible leadership election, and the rest of the batch
            # proceeds instead of the whole execution aborting
            try:
                partitions = self._ft.call("executor.verify",
                                           self._backend.partitions)
            except NON_RETRYABLE_ERRORS:
                raise
            except Exception:
                self._pause_tick("logdir move verification")
                if self._stop_requested:
                    return
                continue
            moves = {}
            live, dead = [], []
            for t in tasks:
                old = dict(t.proposal.old_replicas)
                info = partitions.get(t.tp)
                t_moves = {}
                for b, d in t.proposal.new_replicas:
                    if old.get(b) is not None and old[b] != d:
                        # logdir index -> name resolution happens backend-side;
                        # the proposal carries the index
                        if info is None or b not in info.replicas:
                            t_moves = None      # replica gone: task is dead
                            break
                        t_moves[(t.proposal.topic, t.proposal.partition, b)] = d
                if t_moves is None:
                    dead.append(t)
                else:
                    live.append(t)
                    moves.update(t_moves)
            if moves:
                # resolve + submit before transitioning: a failed batch stays
                # PENDING and is re-picked once the backend returns
                try:
                    resolved = self._ft.call(
                        "executor.verify", self._resolve_logdirs, moves)
                    self._ft.call("executor.submit",
                                  self._backend.alter_replica_logdirs,
                                  resolved, sleep_ms=self._clock.sleep_ms)
                except NON_RETRYABLE_ERRORS:
                    raise
                except Exception:
                    self._pause_tick("logdir move submission")
                    if self._stop_requested:
                        return
                    tasks = planner.next_intra_broker_tasks(
                        {}, self._cfg.intra_broker_cap)
                    continue
            self._resume_if_paused()
            now = self._clock.now_ms()
            for t in dead:
                t.transition(TaskState.DEAD, now)
            for t in live:
                t.transition(TaskState.IN_PROGRESS, now)
                t.transition(TaskState.COMPLETED, now)
            if self._stop_requested:
                return
            tasks = planner.next_intra_broker_tasks({}, self._cfg.intra_broker_cap)

    def _resolve_logdirs(self, moves: dict) -> dict:
        brokers = self._backend.brokers()
        out = {}
        for (topic, part, b), disk_idx in moves.items():
            logdirs = list(brokers[b].logdirs)
            idx = int(disk_idx)
            out[(topic, part, b)] = logdirs[idx] if idx < len(logdirs) else logdirs[0]
        return out

    def _adjuster_due(self) -> bool:
        now = self._clock.now_ms()
        if now - self._last_adjust_ms >= self._cfg.adjuster_interval_ms:
            self._last_adjust_ms = now
            return True
        return False

    def _leadership_phase(self, planner: ExecutionTaskPlanner) -> None:
        self._state = ExecutorState.LEADER_MOVEMENT
        while True:
            self._check_killed()
            if self._stop_requested:
                return
            if (self._cfg.adjuster_enabled
                    and self._cfg.adjuster_leadership_enabled
                    and self._adjuster_due()):
                try:
                    metrics = self._ft.call("executor.verify",
                                            self._backend.broker_metrics)
                    self._cfg.leadership_cap = \
                        self._adjuster.recommend_leadership_concurrency(
                            self._cfg.leadership_cap, metrics)
                except Exception:
                    pass   # keep the current cap
            batch = planner.next_leadership_tasks(
                min(self._cfg.leadership_cap, self._cfg.total_movement_cap))
            if not batch:
                return
            try:
                partitions = self._ft.call("executor.verify",
                                           self._backend.partitions)
                brokers = self._ft.call("executor.verify",
                                        self._backend.brokers)
            except NON_RETRYABLE_ERRORS:
                raise
            except Exception:
                self._pause_tick("leadership verification")
                continue
            elections = {}
            eligible, dead = [], []
            for t in batch:
                info = partitions.get(t.tp)
                target = t.proposal.new_leader
                # the target may have died since the proposal was computed
                # (fault mid-execution): submitting the election would only
                # fail backend-side — mark the task DEAD like the reference
                # abandoning a leadership task with an ineligible target
                if (info is not None and target in info.replicas
                        and brokers.get(target) is not None
                        and brokers[target].alive):
                    elections[t.tp] = target
                    eligible.append(t)
                else:
                    dead.append(t)
            if elections:
                # submit before transitioning (pause/resume semantics as in
                # the inter-broker phase: a failed election batch stays
                # PENDING, including its DEAD candidates — re-derived from
                # fresh metadata on resume)
                try:
                    self._ft.call("executor.submit",
                                  self._backend.elect_leaders, elections,
                                  sleep_ms=self._clock.sleep_ms)
                except NON_RETRYABLE_ERRORS:
                    raise
                except Exception:
                    self._pause_tick("leadership submission")
                    continue
            self._resume_if_paused()
            now = self._clock.now_ms()
            for t in dead:
                t.transition(TaskState.DEAD, now)
            for t in eligible:
                t.transition(TaskState.IN_PROGRESS, now)
            if elections:
                self._await_leadership(elections, planner, eligible)

    def _await_leadership(self, elections: dict, planner, batch: list) -> None:
        """Wait for submitted elections to take effect, up to
        leader.movement.timeout.ms per batch (ExecutorConfig.java:139-141);
        a task whose election hasn't landed by then is ABANDONED — it was
        submitted and started, so it transitions IN_PROGRESS -> ABORTING ->
        ABORTED (the reference's abandoned-leadership-task accounting;
        ``numAbortedTasks`` in state_json carries the census). DEAD stays
        reserved for elections that were never submittable (ineligible
        target, handled in the phase loop above)."""
        pending = {t.tp: t for t in batch if t.tp in elections}
        deadline = self._clock.now_ms() + self._cfg.leader_movement_timeout_ms
        while pending:
            self._check_killed()
            try:
                partitions = self._ft.call("executor.verify",
                                           self._backend.partitions)
            except NON_RETRYABLE_ERRORS:
                raise
            except Exception:
                # metadata unavailable: no landing evidence this poll; the
                # deadline below still bounds the wait
                if self._clock.now_ms() < deadline and not self._stop_requested:
                    self._pause_tick("leadership progress check")
                    continue
                partitions = {}
            landed = [tp for tp, t in pending.items()
                      if getattr(partitions.get(tp), "leader", None)
                      == t.proposal.new_leader]
            for tp in landed:
                pending.pop(tp).transition(TaskState.COMPLETED,
                                           self._clock.now_ms())
            if not pending:
                return
            if self._clock.now_ms() >= deadline or self._stop_requested:
                now = self._clock.now_ms()
                for t in pending.values():
                    t.transition(TaskState.ABORTING, now)
                    t.transition(TaskState.ABORTED, now)
                    self._sensors.meter("leadership-movement-timeouts").mark()
                    LOG.warning("leadership movement timed out for %s "
                                "(abandoned after %.0f ms)", t.tp,
                                self._cfg.leader_movement_timeout_ms)
                return
            self._clock.sleep_ms(min(
                self._cfg.progress_check_interval_ms,
                max(deadline - self._clock.now_ms(), 1.0)))

    # ---------------------------------------------------------------- state
    def state_json(self) -> dict:
        planner = self._current_planner
        out = {"state": self._state}
        if planner is not None:
            tasks = planner.all_tasks
            out["numTotalTasks"] = len(tasks)
            out["numFinishedTasks"] = sum(1 for t in tasks
                                          if t.state is TaskState.COMPLETED)
            out["numPendingTasks"] = sum(1 for t in tasks
                                         if t.state is TaskState.PENDING)
            out["numAbortedTasks"] = sum(1 for t in tasks
                                         if t.state is TaskState.ABORTED)
            # full per-state census: every task is in exactly one state and
            # the counts must sum to the plan (the scenario engine's
            # executor-accounting invariant reads this)
            by_state: dict[str, int] = {}
            for t in tasks:
                by_state[t.state.name] = by_state.get(t.state.name, 0) + 1
            out["numTasksByState"] = by_state
        out["executionHistory"] = self._history[-5:]
        out["numExecutions"] = len(self._history)
        out["numCompletedTasksTotal"] = sum(h["numCompleted"]
                                            for h in self._history)
        out["numPlannedTasksTotal"] = sum(h["numTasks"] for h in self._history)
        out["paused"] = self._paused
        out["numPauseTicks"] = self._pause_ticks
        out["killed"] = self._killed
        if getattr(self, "_proposal_generation", None) is not None:
            # pipelined loop: the metadata generation this execution's
            # proposals were computed against (staleness-tag observability)
            out["proposalGeneration"] = self._proposal_generation
        out["backendFaultTolerance"] = self._ft.state_json()
        if self._cfg.adjuster_enabled:
            out["concurrencyAdjuster"] = {
                "perBrokerCap": self._cfg.per_broker_cap,
                "leadershipCap": self._cfg.leadership_cap,
                "numAdjustments": len(self._adjuster.history),
                "recentAdjustments": list(self._adjuster.history)[-5:],
            }
        return out
