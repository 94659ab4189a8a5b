"""(Counterpart of ``cruise_control_tpu/detector/manager.py``, with the port's imports.)
AnomalyDetectorManager.

Reference: detector/AnomalyDetectorManager.java:60-132 — a priority queue of
anomalies (:74,:87, ordered by KafkaAnomalyType priority then detection time),
per-detector scheduling at a fixed rate with jitter (:218-226, startDetection
:231-239), and a handler loop that polls the queue, consults the notifier
(FIX / CHECK / IGNORE) and invokes the anomaly's self-healing fix through the
same code path as the REST handlers.

Here detection rounds are explicit (``run_detection_round``) and can also be
driven by a host thread (``start`` / ``stop``); time is injected for the
simulated backend. Each detector carries its own detection interval
(AnomalyDetectorConfig.java:154-205 per-type ``*.detection.interval.ms``
falling back to ``anomaly.detection.interval.ms``), with a deterministic
initial phase jitter standing in for the reference's random init delay
(AnomalyDetectorManager.java:218-226).
"""
from __future__ import annotations

import heapq
import logging
import threading

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType
from cruise_control_tpu_torch.detector.notifier import Action, NoopNotifier

LOG = logging.getLogger("cruise_control_tpu_torch.detector")


class AnomalyDetectorManager:
    def __init__(self, notifier=None, cruise_control=None, clock=None,
                 num_cached_recent_states: int = 10,
                 maintenance_stops_ongoing_execution: bool = False):
        self._notifier = notifier or NoopNotifier()
        self._cc = cruise_control
        self._clock = clock
        self._queue: list[tuple, Anomaly] = []
        self._deferred: list = []        # (due_ms, anomaly) for CHECK verdicts
        self._lock = threading.Lock()
        # name -> [run_once, interval_ms or None, next_due_ms or None]
        self._detectors: dict[str, list] = {}
        self._history: list[dict] = []
        # per-type recent-anomaly ring (AnomalyDetectorConfig
        # num.cached.recent.anomaly.states; served at /state)
        from collections import deque
        self._recent = {t: deque(maxlen=num_cached_recent_states)
                        for t in AnomalyType}
        # AnomalyDetectorConfig maintenance.event.stop.ongoing.execution
        self._maintenance_stops_ongoing = maintenance_stops_ongoing_execution
        self._self_healing_actions = 0
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self.detection_interval_ms = 300_000.0

    # ------------------------------------------------------------- wiring
    def register_detector(self, name: str, run_once,
                          interval_ms: float | None = None) -> None:
        """``interval_ms`` None = run every round (legacy/explicit callers);
        a value gives the detector its own cadence, honored by the scheduled
        path (the background thread / ``run_due``)."""
        self._detectors[name] = [run_once, interval_ms, None]

    @property
    def notifier(self):
        return self._notifier

    # --------------------------------------------------------------- queue
    def add_anomaly(self, anomaly: Anomaly) -> None:
        with self._lock:
            heapq.heappush(self._queue, (anomaly.sort_key(), anomaly))

    def _pop(self):
        with self._lock:
            if not self._queue:
                return None
            return heapq.heappop(self._queue)[1]

    def num_queued(self) -> int:
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------ rounds
    def run_detection_round(self, now_ms: float) -> int:
        """Run every registered detector once (ignoring per-detector
        schedules); queue found anomalies. Explicit-driver entry point."""
        return self._run(now_ms, self._detectors.keys())

    def run_due(self, now_ms: float) -> int:
        """Run only detectors whose interval has elapsed, then reschedule
        them — the scheduleAtFixedRate role. First run lands at
        interval/2 + deterministic jitter like the reference's init delay."""
        due = []
        for name, slot in self._detectors.items():
            _, interval, next_due = slot
            if interval is None:
                due.append(name)
                continue
            if next_due is None:
                # deterministic phase jitter: spread detectors so they don't
                # all fire on the same tick (reference uses RANDOM.nextInt).
                # crc32, not hash(): PYTHONHASHSEED randomizes str hashes
                # between processes, which would break scenario-timeline
                # reproducibility across pytest runs.
                import zlib
                jitter = (zlib.crc32(name.encode()) % 10_000) / 10_000.0 \
                    * interval * 0.1
                slot[2] = now_ms + interval / 2 + jitter
                continue
            if now_ms >= next_due:
                due.append(name)
                slot[2] = now_ms + interval
        return self._run(now_ms, due)

    def _run(self, now_ms: float, names) -> int:
        n = 0
        for name in names:
            run_once = self._detectors[name][0]
            try:
                found = run_once(now_ms)
            except Exception:
                LOG.exception("detector %s failed", name)
                continue
            for a in found:
                self.add_anomaly(a)
                n += 1
        return n

    def _degraded(self) -> bool:
        degraded = getattr(self._cc, "degraded", None)
        return bool(degraded is not None and degraded())

    def _backend_unavailable(self, e: Exception) -> bool:
        """A fix failure that is really backend unavailability: an open/just
        -tripped circuit, declared degradation, or completeness gating."""
        from cruise_control_tpu_torch.common.retries import (
            CircuitOpenError, ServiceUnavailableError,
        )
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        if isinstance(e, (CircuitOpenError, ServiceUnavailableError,
                          NotEnoughValidWindowsError)):
            return True
        return self._degraded()

    def next_due_ms(self) -> float | None:
        """Earliest scheduled detector wake-up (None = nothing scheduled)."""
        dues = [slot[2] for slot in self._detectors.values()
                if slot[1] is not None and slot[2] is not None]
        return min(dues) if dues else None

    def handle_anomalies(self, now_ms: float) -> list:
        """Drain the queue through the notifier; FIX routes to self-healing
        (the handler-thread loop role). Returns handled anomaly summaries."""
        # re-enqueue deferred anomalies that are due
        with self._lock:
            due = [a for t, a in self._deferred if t <= now_ms]
            self._deferred = [(t, a) for t, a in self._deferred if t > now_ms]
        for a in due:
            self.add_anomaly(a)

        handled = []
        tracer = getattr(self._cc, "tracer", None)
        journal = getattr(self._cc, "journal", None)
        while True:
            anomaly = self._pop()
            if anomaly is None:
                break
            verdict = self._notifier.on_anomaly(anomaly, now_ms)
            entry = {"anomaly": anomaly.to_json(), "action": verdict.action.value}
            # causal journal: every non-FIX verdict is a lightweight event;
            # a FIX verdict opens the trace's ROOT span (below) — the
            # anomaly->heal lineage starts here. Deterministic fields only
            # (type/action/detection time — never the process-global id).
            if journal is not None and verdict.action is not Action.FIX:
                journal.append("verdict", type=anomaly.anomaly_type.name,
                               action=verdict.action.value,
                               detected=round(anomaly.detected_ms, 1))
            if (verdict.action is Action.FIX and self._cc is not None
                    and self._degraded()):
                # backend boundary unhealthy (open circuit breaker): firing
                # the fix now would only burn consecutive self-healing
                # failures against a backend that cannot actuate — defer it
                # like a CHECK verdict until the breaker's reset timeout and
                # re-enter the queue then (common/retries.py degradation
                # contract)
                delay_ms = max(
                    self._cc.fault_tolerance.retry_after_s() * 1000.0, 1000.0)
                entry["action"] = Action.CHECK.value
                entry["deferred"] = "backend degraded"
                if journal is not None:
                    journal.append("verdict", type=anomaly.anomaly_type.name,
                                   action="FIX", deferred="backend degraded",
                                   detected=round(anomaly.detected_ms, 1))
                sensors = getattr(self._cc, "sensors", None)
                if sensors is not None:
                    sensors.meter("self-healing-fix-deferrals").mark()
                with self._lock:
                    self._deferred.append((now_ms + delay_ms, anomaly))
            elif verdict.action is Action.FIX and self._cc is not None:
                sensors = getattr(self._cc, "sensors", None)
                # the trace ROOT: one "verdict" span per FIX, covering
                # handling through heal completion (blocking executions
                # advance the injected clock, so [t0, t1] is the full
                # anomaly->heal extent on the backend's time base). The
                # handle propagates EXPLICITLY: fix_with_span ->
                # Anomaly.fix_span -> facade parent_span.
                vspan = None
                if tracer is not None:
                    vspan = tracer.span(
                        "verdict", anomaly.anomaly_type.name, action="FIX",
                        detected_ms=round(anomaly.detected_ms, 1),
                        description=anomaly.description[:160])
                try:
                    if (anomaly.anomaly_type is AnomalyType.MAINTENANCE_EVENT
                            and self._maintenance_stops_ongoing
                            and self._cc.executor.has_ongoing_execution()):
                        # maintenance.event.stop.ongoing.execution: the plan
                        # preempts whatever proposal execution is running
                        self._cc.stop_proposal_execution(force=False)
                    result = anomaly.fix_with_span(self._cc, vspan)
                    entry["fixResult"] = result
                    self._self_healing_actions += 1
                    if vspan is not None:
                        vspan.end(fixed=result is not None,
                                  executed=bool((result or {}).get("executed")))
                    if sensors is not None:
                        # heal-latency timers (sensor catalog): detection ->
                        # FIX-complete per anomaly type, on the injected
                        # clock (simulated seconds in the sim — chaos
                        # campaigns get time-to-heal distributions for free;
                        # a blocking FIX execution advances that clock)
                        end_ms = (self._clock.now_ms()
                                  if self._clock is not None else now_ms)
                        sensors.timer(
                            f"{anomaly.anomaly_type.name.lower()}"
                            "-self-healing-fix-timer").record(
                            max(end_ms - anomaly.detected_ms, 0.0) / 1000.0)
                        sensors.timer("anomaly-detection-to-fix-timer").record(
                            max(now_ms - anomaly.detected_ms, 0.0) / 1000.0)
                except Exception as e:
                    from cruise_control_tpu_torch.executor.executor import (
                        ExecutorKilledError,
                    )
                    if isinstance(e, ExecutorKilledError):
                        # the controller "process" died mid-fix (HA
                        # leader-kill): not a fix failure to record — the
                        # kill propagates so the harness tears this
                        # controller down and the standby takes over
                        raise
                    if self._backend_unavailable(e):
                        # the fix failed BECAUSE the backend boundary is
                        # unhealthy (the failure may itself have tripped the
                        # breaker): defer and retry after the reset window
                        # instead of burning a consecutive-failure count
                        delay_ms = max(self._cc.fault_tolerance.retry_after_s()
                                       * 1000.0, 1000.0)
                        entry.pop("fixResult", None)
                        entry["action"] = Action.CHECK.value
                        entry["deferred"] = "backend degraded"
                        if vspan is not None:
                            vspan.end(deferred="backend degraded",
                                      error=type(e).__name__)
                        if sensors is not None:
                            sensors.meter("self-healing-fix-deferrals").mark()
                        with self._lock:
                            self._deferred.append((now_ms + delay_ms, anomaly))
                    else:
                        LOG.exception("self-healing fix failed for %s", anomaly)
                        entry["fixError"] = str(e)
                        if vspan is not None:
                            vspan.end(error=type(e).__name__)
                        if sensors is not None:
                            sensors.meter("self-healing-fix-failures").mark()
            elif verdict.action is Action.CHECK:
                with self._lock:
                    self._deferred.append((now_ms + verdict.delay_ms, anomaly))
            handled.append(entry)
            self._history.append(entry)
            with self._lock:
                self._recent[anomaly.anomaly_type].append(entry)
        return handled

    # --------------------------------------------------- background thread
    def start_detection(self, interval_ms: float | None = None) -> None:
        """startDetection (AnomalyDetectorManager.java:231): spawn the periodic
        detection + handling loop."""
        if interval_ms:
            self.detection_interval_ms = interval_ms
        if self._thread is not None:
            return
        self._stop_event.clear()

        def loop():
            import time
            while not self._stop_event.is_set():
                now = (self._clock.now_ms() if self._clock is not None
                       else time.time() * 1000.0)
                self.run_due(now)
                self.handle_anomalies(now)
                # wake at the earliest per-detector due time, bounded by the
                # global interval (deferred CHECK anomalies also need draining)
                wait_ms = self.detection_interval_ms
                nxt = self.next_due_ms()
                if nxt is not None:
                    wait_ms = min(wait_ms, max(nxt - now, 100.0))
                self._stop_event.wait(wait_ms / 1000.0)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="anomaly-detector")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    # ---------------------------------------------------------------- state
    def state_json(self) -> dict:
        with self._lock:
            recent = self._history[-10:]
            by_type = {t.name: list(d) for t, d in self._recent.items() if d}
        return {
            "selfHealingEnabled": self._notifier.self_healing_enabled(),
            "recentAnomalies": recent,
            # AnomalyDetectorState recent<Type>s role, capped per type by
            # num.cached.recent.anomaly.states
            "recentAnomaliesByType": by_type,
            "numSelfHealingActions": self._self_healing_actions,
            "numQueuedAnomalies": self.num_queued(),
            "registeredDetectors": list(self._detectors),
            "detectionIntervalsMs": {n: s[1] for n, s in self._detectors.items()
                                     if s[1] is not None},
        }
