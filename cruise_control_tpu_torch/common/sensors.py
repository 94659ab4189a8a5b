"""(Counterpart of ``cruise_control_tpu/common/sensors.py``, with the port's imports.)
Sensor registry: timers, meters, gauges — the observability spine.

Reference: Dropwizard ``MetricRegistry`` exported to JMX domain
``kafka.cruisecontrol`` (KafkaCruiseControlApp.java:29,40), with the sensor
catalog documented in docs/wiki/User Guide/Sensors.md — e.g.
``proposal-computation-timer`` (GoalOptimizer.java:125),
``cluster-model-creation-timer`` (LoadMonitor.java:173), per-endpoint
``*-successful-request-execution-timer`` (KafkaCruiseControlServlet.java:64),
LoadMonitor gauges valid-windows / monitored-partitions-percentage
(LoadMonitor.java:180-195) and the GoalViolationDetector balancedness-score.

There is no JVM/JMX here: the registry snapshots to JSON (served under
``/state`` with the SENSORS substate) — same catalog, host-native export.

Also hosts the dedicated operation logger (reference: ``OPERATION_LOGGER``,
Executor.java:1037) — a named ``logging`` channel recording every
cluster-mutating operation.
"""
from __future__ import annotations

import logging
import math
import random
import threading
import time

OPERATION_LOGGER = logging.getLogger("operationLogger")


class Timer:
    """Wall-clock timer with a bounded reservoir for percentiles plus exact
    fixed-bucket counters (rendered as a Prometheus histogram twin by
    ``/metrics`` so percentiles aggregate across scrapes/instances — the
    reservoir quantiles cannot)."""

    RESERVOIR = 1028
    # fixed le-boundaries (seconds): sub-10ms request handling up through
    # multi-minute heal executions; +Inf is implicit (= count)
    BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
               10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._max = 0.0
        self._values: list[float] = []
        self._bucket_counts = [0] * len(self.BUCKETS)
        # per-timer seeded RNG for reservoir sampling: the hot path must not
        # touch the GLOBAL random module — perturbing its state from a timer
        # would break the sim's bit-identical (scenario, seed) timelines for
        # anything seeding/consuming the global stream
        self._rng = random.Random(self.RESERVOIR)

    def record(self, seconds: float) -> None:
        import bisect
        with self._lock:
            self._count += 1
            self._total += seconds
            self._max = max(self._max, seconds)
            # exact histogram: one increment in the first bucket whose upper
            # bound admits the observation (values past the last bound land
            # only in the implicit +Inf bucket = count)
            b = bisect.bisect_left(self.BUCKETS, seconds)
            if b < len(self._bucket_counts):
                self._bucket_counts[b] += 1
            if len(self._values) < self.RESERVOIR:
                self._values.append(seconds)
            else:  # vitter's algorithm R: uniform over the full history
                j = self._rng.randrange(self._count)
                if j < self.RESERVOIR:
                    self._values[j] = seconds

    def time(self):
        """Context manager: ``with timer.time(): ...``"""
        return _TimerContext(self)

    def _percentile(self, sorted_vals: list[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        k = max(0, min(len(sorted_vals) - 1,
                       math.ceil(q * len(sorted_vals)) - 1))
        return sorted_vals[k]

    def to_json(self) -> dict:
        with self._lock:
            vals = sorted(self._values)
            count, total, mx = self._count, self._total, self._max
            per_bucket = list(self._bucket_counts)
        cum, cum_buckets = 0, []
        for le, n in zip(self.BUCKETS, per_bucket):
            cum += n
            cum_buckets.append([le, cum])
        return {
            "type": "timer", "count": count,
            "meanSec": round(total / count, 6) if count else 0.0,
            "totalSec": round(total, 6),   # exact _sum for /metrics summaries
            "maxSec": round(mx, 6),
            "p50Sec": round(self._percentile(vals, 0.50), 6),
            "p95Sec": round(self._percentile(vals, 0.95), 6),
            "p99Sec": round(self._percentile(vals, 0.99), 6),
            # cumulative le-bucket counts ([le_seconds, count<=le]); exact,
            # not reservoir-sampled — the /metrics _bucket series
            "bucketsSec": cum_buckets,
        }


class _TimerContext:
    def __init__(self, timer: Timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._timer.record(time.monotonic() - self._t0)
        return False


class Meter:
    """Event rate: count + events/sec over the process lifetime and the
    trailing minute (coarse two-bucket approximation)."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._start = clock()
        self._count = 0
        self._bucket_start = self._start
        self._bucket_count = 0
        self._prev_rate = 0.0

    def _roll(self, now: float) -> None:
        """Caller holds the lock. Close the trailing bucket once it spans a
        minute. Rolling ONLY on mark() was a bug: after events stop, the
        "one-minute" rate kept being computed over an ever-growing window —
        reads must roll (and thereby decay toward zero) too."""
        if now - self._bucket_start >= 60.0:
            self._prev_rate = self._bucket_count / (now - self._bucket_start)
            self._bucket_start = now
            self._bucket_count = 0

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self._roll(self._clock())
            self._count += n
            self._bucket_count += n

    def to_json(self) -> dict:
        with self._lock:
            now = self._clock()
            self._roll(now)
            elapsed = max(now - self._start, 1e-9)
            bucket_elapsed = max(now - self._bucket_start, 1e-9)
            recent = (self._bucket_count / bucket_elapsed
                      if bucket_elapsed >= 1.0 else self._prev_rate)
            return {"type": "meter", "count": self._count,
                    "meanRatePerSec": round(self._count / elapsed, 6),
                    "oneMinuteRatePerSec": round(recent, 6)}


class MetricRegistry:
    """Named sensors; layers register, /state?substates=SENSORS snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._timers: dict[str, Timer] = {}
        self._meters: dict[str, Meter] = {}
        self._gauges: dict[str, callable] = {}

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self._meters.setdefault(name, Meter())

    def gauge(self, name: str, fn) -> None:
        """Register (or replace) a gauge: ``fn() -> number``."""
        with self._lock:
            self._gauges[name] = fn

    def names(self) -> list[str]:
        with self._lock:
            return sorted([*self._timers, *self._meters, *self._gauges])

    def to_json(self) -> dict:
        with self._lock:
            timers = dict(self._timers)
            meters = dict(self._meters)
            gauges = dict(self._gauges)
        out = {}
        for name, t in timers.items():
            out[name] = t.to_json()
        for name, m in meters.items():
            out[name] = m.to_json()
        for name, fn in gauges.items():
            try:
                out[name] = {"type": "gauge", "value": fn()}
            except Exception as e:  # noqa: BLE001 — a dead gauge must not kill /state
                out[name] = {"type": "gauge", "error": f"{type(e).__name__}: {e}"}
        return out
