"""(Counterpart of ``cruise_control_tpu/common/retries.py``, with the port's imports.)
Fault tolerance at the backend boundary: retries + circuit breakers.

The reference survives flaky admin RPCs because every backend call sits
behind ``AdminClient`` request timeouts with retries and the executor's
progress loop simply re-polls (SURVEY §2.7-2.9); our port terminated the RPC
sidecar permanently on one timeout and had no retry path for a failed
movement submission. This module is the unified layer both gaps wire into:

- :class:`RetryPolicy` — exponential backoff with jitter. Deterministic by
  construction: the jitter comes from an *injected* ``random.Random`` and
  elapsed time from an *injected* clock, so the simulated chaos campaigns
  (sim/campaign.py, sim/api_fuzz.py) keep their bit-identical
  (scenario, seed) timelines with the retry layer live.
- :class:`CircuitBreaker` — the classic CLOSED -> OPEN -> HALF_OPEN state
  machine per *operation class* ("executor.submit", "executor.verify",
  "monitor.sample", ...). ``backend.circuit.failure.threshold`` consecutive
  failures open the circuit; after ``backend.circuit.reset.timeout.ms`` a
  bounded number of HALF_OPEN probes may test the backend, and one success
  closes it again.
- :class:`BackendFaultTolerance` — the facade the executor / monitor / app
  share: ``call(op_class, fn, ...)`` retries transient failures under the
  policy, trips the class' breaker on sustained failure, raises
  :class:`CircuitOpenError` without touching the backend while OPEN, and
  lands every attempt/trip in the sensor registry (``*-backend-retries``,
  ``*-backend-failures`` meters + ``backend-circuit-*-state`` gauges), so
  the PR-6 flight recorder / ``GET /metrics`` surface the layer's health.

Degradation contract (consumed by app.py / api/server.py): while any
breaker is OPEN the service is *degraded* — reads serve the resident
session's cached proposals flagged ``stale: true``, writes surface
:class:`ServiceUnavailableError` (HTTP 503 + Retry-After), and the anomaly
detector defers FIX verdicts instead of burning consecutive failures.
"""
from __future__ import annotations

import dataclasses
import random
import threading


# Deterministic request REJECTIONS (validation errors): retrying cannot
# change the outcome and they say nothing about backend health, so the call
# wrapper re-raises them immediately without touching the breaker — the
# executor aborts the execution like the pre-retry-layer behavior instead of
# pausing forever on an invalid move.
NON_RETRYABLE_ERRORS = (ValueError, KeyError, TypeError)


class CircuitOpenError(Exception):
    """The operation class' circuit is OPEN: the backend was not called."""

    def __init__(self, op_class: str, retry_after_ms: float):
        super().__init__(
            f"circuit for {op_class!r} is open; retry in "
            f"{max(retry_after_ms, 0.0):.0f} ms")
        self.op_class = op_class
        self.retry_after_ms = max(retry_after_ms, 0.0)


class ServiceUnavailableError(Exception):
    """Degraded mode: the operation is rejected, retry later (HTTP 503)."""

    def __init__(self, message: str, retry_after_s: float = 30.0):
        super().__init__(message)
        self.retry_after_s = max(retry_after_s, 1.0)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter (backend.retry.* keys)."""
    max_attempts: int = 4
    base_backoff_ms: float = 100.0
    max_backoff_ms: float = 10_000.0
    jitter: float = 0.2          # symmetric fraction of the backoff

    @classmethod
    def from_config(cls, config) -> "RetryPolicy":
        if config is None:
            return cls()
        return cls(
            max_attempts=config.get_int("backend.retry.max.attempts"),
            base_backoff_ms=float(config.get_int("backend.retry.base.backoff.ms")),
            max_backoff_ms=float(config.get_int("backend.retry.max.backoff.ms")),
            jitter=config.get_double("backend.retry.jitter"))

    def backoff_ms(self, failure_count: int, rng: random.Random) -> float:
        """Backoff before retry number ``failure_count`` (1-based)."""
        base = min(self.base_backoff_ms * (2.0 ** max(failure_count - 1, 0)),
                   self.max_backoff_ms)
        if self.jitter <= 0:
            return base
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN per operation class (backend.circuit.*)."""

    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"

    def __init__(self, op_class: str, failure_threshold: int = 5,
                 reset_timeout_ms: float = 60_000.0, half_open_probes: int = 1,
                 clock_ms=None):
        self.op_class = op_class
        self._threshold = max(failure_threshold, 1)
        self._reset_timeout_ms = reset_timeout_ms
        self._max_probes = max(half_open_probes, 1)
        self._clock_ms = clock_ms or (lambda: 0.0)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_ms = -1.0
        self._probes_in_flight = 0
        self.open_count = 0          # lifetime trips (sensor + test surface)
        # optional observer ``(op_class, old_state, new_state)`` — the
        # fault-tolerance facade journals every transition through it
        # (called OUTSIDE the breaker lock, after the transition landed)
        self.on_transition = None

    def _set_state(self, new: str) -> tuple | None:
        """Caller holds the lock; returns the (old, new) transition to flush
        through ``on_transition`` after release, or None."""
        old = self._state
        if old == new:
            return None
        self._state = new
        return (old, new)

    def _flush(self, *transitions) -> None:
        """Fire the observer for each real transition, lock NOT held."""
        hook = self.on_transition
        if hook is None:
            return
        for t in transitions:
            if t is not None:
                try:
                    hook(self.op_class, t[0], t[1])
                except Exception:  # noqa: BLE001 — observers must never break a call
                    import logging
                    logging.getLogger(__name__).exception(
                        "breaker transition observer failed")

    @property
    def state(self) -> str:
        # surface the time-based OPEN -> HALF_OPEN transition on read
        with self._lock:
            t = self._maybe_half_open()
            out = self._state
        self._flush(t)
        return out

    def _maybe_half_open(self) -> tuple | None:
        """Caller holds the lock."""
        if (self._state == self.OPEN
                and self._clock_ms() - self._opened_ms >= self._reset_timeout_ms):
            self._probes_in_flight = 0
            return self._set_state(self.HALF_OPEN)
        return None

    def allow(self) -> bool:
        """May the caller attempt the backend right now? HALF_OPEN admits at
        most ``backend.circuit.half.open.probes`` concurrent probes."""
        with self._lock:
            t = self._maybe_half_open()
            if self._state == self.CLOSED:
                out = True
            elif self._state == self.HALF_OPEN:
                if self._probes_in_flight < self._max_probes:
                    self._probes_in_flight += 1
                    out = True
                else:
                    out = False
            else:
                out = False
        self._flush(t)
        return out

    def retry_after_ms(self) -> float:
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(self._opened_ms + self._reset_timeout_ms
                       - self._clock_ms(), 0.0)

    def on_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            t = self._set_state(self.CLOSED)
        self._flush(t)

    def on_failure(self) -> None:
        t2 = None
        with self._lock:
            t1 = self._maybe_half_open()
            self._consecutive_failures += 1
            if self._state == self.HALF_OPEN:
                # a failed probe re-opens immediately (and restarts the timer)
                t2 = self._set_state(self.OPEN)
                self._opened_ms = self._clock_ms()
                self.open_count += 1
                self._probes_in_flight = 0
            elif (self._state == self.CLOSED
                    and self._consecutive_failures >= self._threshold):
                t2 = self._set_state(self.OPEN)
                self._opened_ms = self._clock_ms()
                self.open_count += 1
        self._flush(t1, t2)

    def to_json(self) -> dict:
        return {"opClass": self.op_class, "state": self.state,
                "consecutiveFailures": self._consecutive_failures,
                "openCount": self.open_count,
                "retryAfterMs": round(self.retry_after_ms(), 1)}


_STATE_GAUGE = {CircuitBreaker.CLOSED: 0, CircuitBreaker.HALF_OPEN: 1,
                CircuitBreaker.OPEN: 2}


class BackendFaultTolerance:
    """Shared retry + breaker facade for every backend-boundary caller.

    One instance per CruiseControl app: the executor, monitor and facade all
    consult the SAME breakers, so a backend outage observed by the executor
    degrades REST serving too. ``clock_ms`` is the backend clock (simulated
    in sims), ``rng`` seeds deterministically per instance.
    """

    def __init__(self, config=None, clock_ms=None, sensors=None,
                 rng: random.Random | None = None, journal=None):
        # durable event journal (common/tracing.EventJournal): every breaker
        # state transition lands as a {"kind": "breaker"} event — the
        # anomaly->heal lineage can then explain WHY a fix deferred
        self._journal = journal
        self.policy = RetryPolicy.from_config(config)
        self._failure_threshold = (config.get_int(
            "backend.circuit.failure.threshold") if config is not None else 5)
        self._reset_timeout_ms = float(config.get_int(
            "backend.circuit.reset.timeout.ms")) if config is not None \
            else 60_000.0
        self._half_open_probes = (config.get_int(
            "backend.circuit.half.open.probes") if config is not None else 1)
        self._clock_ms = clock_ms or (lambda: 0.0)
        self._sensors = sensors
        # string-seeded: deterministic across processes (PYTHONHASHSEED-free)
        self._rng = rng or random.Random("backend-fault-tolerance")
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def breaker(self, op_class: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(op_class)
            if br is None:
                br = CircuitBreaker(
                    op_class, failure_threshold=self._failure_threshold,
                    reset_timeout_ms=self._reset_timeout_ms,
                    half_open_probes=self._half_open_probes,
                    clock_ms=self._clock_ms)
                self._breakers[op_class] = br
                if self._journal is not None:
                    journal = self._journal

                    def on_transition(op, old, new):
                        journal.append("breaker", op=op, frm=old, to=new)
                    br.on_transition = on_transition
                if self._sensors is not None:
                    self._sensors.gauge(
                        f"backend-circuit-{op_class}-state",
                        lambda b=br: _STATE_GAUGE[b.state])
            return br

    def _meter(self, name: str):
        if self._sensors is not None:
            self._sensors.meter(name).mark()

    def call(self, op_class: str, fn, *args, sleep_ms=None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the class' retry + breaker.

        ``sleep_ms``: callable honoring the backoff between attempts (the
        executor passes its injected clock's ``sleep_ms`` so sim campaigns
        back off in simulated time); ``None`` retries immediately — right
        for periodic callers (sampling) that must not stall their round.

        Raises :class:`CircuitOpenError` without calling when the breaker is
        OPEN, or the last exception once ``backend.retry.max.attempts`` is
        exhausted (the breaker accumulates the failures either way).
        """
        br = self.breaker(op_class)
        if not br.allow():
            self._meter(f"{op_class}-backend-rejections")
            raise CircuitOpenError(op_class, br.retry_after_ms())
        failures = 0
        while True:
            try:
                result = fn(*args, **kwargs)
            except NON_RETRYABLE_ERRORS:
                raise
            except Exception:
                failures += 1
                br.on_failure()
                self._meter(f"{op_class}-backend-failures")
                if failures >= self.policy.max_attempts or not br.allow():
                    raise
                self._meter(f"{op_class}-backend-retries")
                if sleep_ms is not None:
                    sleep_ms(self.policy.backoff_ms(failures, self._rng))
                continue
            br.on_success()
            return result

    # ------------------------------------------------------------ degradation
    def open_circuits(self) -> list[str]:
        """Operation classes whose breaker is OPEN right now. HALF_OPEN is
        deliberately NOT degraded: a half-open breaker admits probe calls,
        and the next write/fix attempt IS that probe — counting it as
        degraded would defer the very call that can close the circuit."""
        with self._lock:
            breakers = list(self._breakers.values())
        return sorted(b.op_class for b in breakers
                      if b.state == CircuitBreaker.OPEN)

    def degraded(self) -> bool:
        """Any breaker OPEN ⇒ the backend boundary is unhealthy."""
        return bool(self.open_circuits())

    def retry_after_s(self) -> float:
        with self._lock:
            breakers = list(self._breakers.values())
        waits = [b.retry_after_ms() for b in breakers
                 if b.state == CircuitBreaker.OPEN]
        return max(waits) / 1000.0 if waits else 1.0

    def state_json(self) -> dict:
        with self._lock:
            breakers = dict(self._breakers)
        return {"degraded": self.degraded(),
                "breakers": {name: br.to_json()
                             for name, br in sorted(breakers.items())}}
