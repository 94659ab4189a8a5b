"""(Counterpart of ``cruise_control_tpu/monitor/aggregator/sample_aggregator.py``, copied with the
port's imports.) Windowed metric sample aggregation.

Reference: cruise-control-core/.../monitor/sampling/aggregator/
MetricSampleAggregator.java:84 (addSample :141, aggregate :193) with
RawMetricValues.java's per-window validity/extrapolation rules (:290-345):

- count >= max(1, min_samples//2): use the window's own value
  (AVG: sum/count, MAX/LATEST: kept value); mark AVG_AVAILABLE when
  count < min_samples.
- else if the window is interior (not first/last of the buffer) and BOTH
  neighbors have >= min_samples: AVG_ADJACENT — AVG: pooled mean over the 3
  windows; MAX/LATEST: total / (3 if own count > 0 else 2).
- else if count > 0: FORCED_INSUFFICIENT (use what's there).
- else: value 0, NO_VALID_EXTRAPOLATION.

Entity validity (RawMetricValues.isValid :166): no NO_VALID_EXTRAPOLATION
window and at most ``max_allowed_extrapolations`` extrapolated windows.
Completeness ratios (MetricSampleCompleteness role) gate model generation in
the LoadMonitor.

The reference stores per-entity circular buffers of boxed objects; here the
store is three dense float arrays [E, W+1, M] (sum / max / latest) plus a
count matrix [E, W+1], and ``aggregate`` is pure vectorized numpy — the same
layout the model builder feeds to the TPU, so the windows axis reduces without
a per-entity loop.
"""
from __future__ import annotations

import dataclasses
import enum
import threading

import numpy as np

from cruise_control_tpu_torch.monitor.metricdef import AggregationFunction, MetricDef


class Extrapolation(enum.IntEnum):
    NONE = 0
    AVG_AVAILABLE = 1
    AVG_ADJACENT = 2
    FORCED_INSUFFICIENT = 3
    NO_VALID_EXTRAPOLATION = 4


@dataclasses.dataclass
class AggregationResult:
    entities: list                      # row order
    window_starts_ms: list              # [Wq] completed-window start times, oldest first
    values: np.ndarray                  # f64[E, Wq, M]
    extrapolations: np.ndarray          # u8[E, Wq]
    entity_valid: np.ndarray            # bool[E]
    completeness_per_window: np.ndarray # f64[Wq] fraction of valid entities
    completeness: float                 # fraction of entities valid across all windows

    def values_for(self, entity) -> np.ndarray:
        return self.values[self.entities.index(entity)]


class MetricSampleAggregator:
    """Dense windowed aggregator. Thread-safe for concurrent add_sample."""

    def __init__(self, num_windows: int, window_ms: int, min_samples_per_window: int,
                 max_allowed_extrapolations: int, metric_def: MetricDef):
        self._num_windows = num_windows
        self._window_ms = window_ms
        self._min_samples = max(1, min_samples_per_window)
        self._half_min = max(1, min_samples_per_window // 2)
        self._max_extrapolations = max_allowed_extrapolations
        self._metric_def = metric_def
        self._agg_funcs = np.array([m.aggregation.value for m in metric_def.all()])
        self._is_avg = self._agg_funcs == AggregationFunction.AVG.value
        self._lock = threading.Lock()
        self._entities: dict = {}
        self._generation = 0
        M = metric_def.num_metrics
        # slot 0..num_windows-1 = history ring, slot num_windows = current window
        self._sum = np.zeros((0, num_windows + 1, M))
        self._max = np.full((0, num_windows + 1, M), -np.inf)
        self._latest = np.zeros((0, num_windows + 1, M))
        self._counts = np.zeros((0, num_windows + 1), np.int32)
        self._oldest_window: int | None = None   # absolute index of ring slot 0
        self._current_window: int | None = None  # absolute index of the active window
        self._first_window: int | None = None    # first window ever observed
        # aggregate() memo: (num_windows arg) -> result, valid until the next
        # accepted sample (generation-numbered cache invalidation role,
        # common/LongGenerationed.java). Sensors/gauges snapshot aggregate()
        # repeatedly; without this each read is a full O(E x W x M) pass.
        self._dirty = True
        self._agg_cache: dict[int | None, AggregationResult] = {}

    # -- geometry --
    def window_index(self, ts_ms: float) -> int:
        return int(ts_ms // self._window_ms)

    @property
    def num_windows(self) -> int:
        return self._num_windows

    @property
    def window_ms(self) -> int:
        return self._window_ms

    def clear(self) -> None:
        """Drop all samples and windows (MetricSampleAggregator.clear —
        the bootstrap-with-clearmetrics path)."""
        with self._lock:
            M = self._metric_def.num_metrics
            W1 = self._num_windows + 1
            self._entities = {}
            self._sum = np.zeros((0, W1, M))
            self._max = np.full((0, W1, M), -np.inf)
            self._latest = np.zeros((0, W1, M))
            self._counts = np.zeros((0, W1), np.int32)
            self._oldest_window = None
            self._current_window = None
            self._first_window = None
            self._generation += 1
            self._dirty = True

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def num_entities(self) -> int:
        return len(self._entities)

    def _entity_row(self, entity) -> int:
        row = self._entities.get(entity)
        if row is None:
            row = len(self._entities)
            self._entities[entity] = row
            if row >= self._sum.shape[0]:
                # amortized doubling: a concatenate PER new entity is O(E)
                # copy each -> O(E^2) on the first sampling round (minutes at
                # 500k partitions); geometric growth keeps ingestion linear
                grow = max(64, self._sum.shape[0])
                W1 = self._num_windows + 1
                M = self._metric_def.num_metrics
                self._sum = np.concatenate([self._sum, np.zeros((grow, W1, M))])
                self._max = np.concatenate(
                    [self._max, np.full((grow, W1, M), -np.inf)])
                self._latest = np.concatenate(
                    [self._latest, np.zeros((grow, W1, M))])
                self._counts = np.concatenate(
                    [self._counts, np.zeros((grow, W1), np.int32)])
        return row

    def _slot_of(self, window: int) -> int | None:
        """Ring slot for an absolute completed-window index, or None if rolled out."""
        if self._oldest_window is None or window < self._oldest_window:
            return None
        if window >= self._current_window:
            return None
        off = window - self._oldest_window
        if off >= self._num_windows:
            return None
        return off

    def _roll_to(self, window: int) -> None:
        """Advance the active window; completed windows land in the history ring."""
        if self._current_window is None:
            self._current_window = window
            self._oldest_window = window - self._num_windows
            self._first_window = window
            return
        if window <= self._current_window:
            return
        steps = window - self._current_window
        W = self._num_windows
        # finalize current active slot into history ring, shifting left as needed
        shift = min(steps, W + 1)
        self._sum = np.roll(self._sum, -shift, axis=1)
        self._max = np.roll(self._max, -shift, axis=1)
        self._latest = np.roll(self._latest, -shift, axis=1)
        self._counts = np.roll(self._counts, -shift, axis=1)
        # clear the slots that wrapped around (they represent new windows)
        self._sum[:, W + 1 - shift:] = 0.0
        self._max[:, W + 1 - shift:] = -np.inf
        self._latest[:, W + 1 - shift:] = 0.0
        self._counts[:, W + 1 - shift:] = 0
        self._current_window = window
        self._oldest_window = window - W
        self._generation += 1

    # -- ingestion (hot path: O(1) vector ops per sample) --
    def add_sample(self, entity, ts_ms: float, values: dict) -> bool:
        """Record one sample. Stale samples older than the ring are rejected
        (MetricSampleAggregator.addSample returns false)."""
        window = self.window_index(ts_ms)  # the window covering ts
        with self._lock:
            if self._current_window is not None and window < self._oldest_window:
                return False
            self._roll_to(max(window, self._current_window or window))
            row = self._entity_row(entity)
            slot = (window - self._oldest_window
                    if window < self._current_window else self._num_windows)
            if slot < 0:
                return False
            vec = np.zeros(self._metric_def.num_metrics)
            mask = np.zeros(self._metric_def.num_metrics, bool)
            for name, v in values.items():
                mid = self._metric_def.info(name).metric_id
                vec[mid] = v
                mask[mid] = True
            self._sum[row, slot, mask] += vec[mask]
            self._max[row, slot, mask] = np.maximum(self._max[row, slot, mask], vec[mask])
            self._latest[row, slot, mask] = vec[mask]
            self._counts[row, slot] += 1
            self._dirty = True
            return True

    def add_samples(self, entities: list, ts_ms: float, values,
                    metric_names: list) -> int:
        """Bulk ingestion: N samples sharing ONE timestamp and ONE metric-name
        set, ``values`` [N, len(metric_names)]. One vectorized scatter into
        the ring instead of N python calls — the per-sample path costs ~20 us
        each, which is minutes per sampling round at 1M partitions."""
        import numpy as _np
        n = len(entities)
        if n == 0:
            return 0
        window = self.window_index(ts_ms)
        with self._lock:
            if self._current_window is not None and window < self._oldest_window:
                return 0
            self._roll_to(max(window, self._current_window or window))
            try:
                # steady state: every entity is known — C-speed dict gets
                rows = _np.fromiter(map(self._entities.__getitem__, entities),
                                    dtype=_np.int64, count=n)
            except KeyError:
                rows = _np.fromiter((self._entity_row(e) for e in entities),
                                    dtype=_np.int64, count=n)
            slot = (window - self._oldest_window
                    if window < self._current_window else self._num_windows)
            if slot < 0:
                return 0
            cols = _np.asarray([self._metric_def.info(m).metric_id
                                for m in metric_names], dtype=_np.int64)
            values = _np.asarray(values, dtype=float)
            idx = (rows[:, None], cols[None, :])
            if _np.unique(rows).size == n:
                # the common columnar round: ONE sample per entity — plain
                # fancy indexing instead of the (much slower) ufunc.at
                # scatter; both slices are views, writes land in the ring
                ssum = self._sum[:, slot, :]
                smax = self._max[:, slot, :]
                ssum[idx] += values
                smax[idx] = _np.maximum(smax[idx], values)
                self._latest[rows[:, None], slot, cols[None, :]] = values
                self._counts[rows, slot] += 1
            else:
                # np.*.at: duplicate entities within one batch accumulate
                # exactly like repeated add_sample calls would
                _np.add.at(self._sum[:, slot, :], idx, values)
                _np.maximum.at(self._max[:, slot, :], idx, values)
                self._latest[rows[:, None], slot, cols[None, :]] = values
                _np.add.at(self._counts[:, slot], rows, 1)
            self._dirty = True
            return n

    # -- aggregation --
    def aggregate(self, num_windows: int | None = None) -> AggregationResult:
        """Aggregate the most recent ``num_windows`` completed windows.
        Results are memoized until the next accepted sample."""
        with self._lock:
            if self._dirty:
                self._agg_cache.clear()
                self._dirty = False
            cached = self._agg_cache.get(num_windows)
            if cached is not None:
                return cached
            result = self._aggregate_locked(num_windows)
            self._agg_cache[num_windows] = result
            return result

    def window_view(self, num_windows: int | None = None
                    ) -> tuple[AggregationResult, int]:
        """Zero-copy windowed history view: ``(result, generation)``.

        Hands out the memoized :class:`AggregationResult` arrays directly —
        no re-copy — stamped with the generation they were computed under, so
        a consumer (the forecaster) can key its own caches on the stamp and
        skip recompute entirely while no new window has rolled. The pair is
        read under one lock acquisition: the stamp can never describe a
        different ring state than the arrays. Callers must treat the arrays
        as immutable."""
        with self._lock:
            gen = self._generation
            if self._dirty:
                self._agg_cache.clear()
                self._dirty = False
            cached = self._agg_cache.get(num_windows)
            if cached is None:
                cached = self._aggregate_locked(num_windows)
                self._agg_cache[num_windows] = cached
            return cached, gen

    def _aggregate_locked(self, num_windows: int | None = None) -> AggregationResult:
        """Full aggregation pass; caller holds the lock."""
        W = min(num_windows or self._num_windows, self._num_windows)
        E = len(self._entities)
        M = self._metric_def.num_metrics
        if E == 0 or self._current_window is None:
            return AggregationResult([], [], np.zeros((0, W, M)),
                                     np.zeros((0, W), np.uint8), np.zeros(0, bool),
                                     np.zeros(W), 0.0)
        # only windows that have actually existed (>= first observed window)
        n_exist = self._current_window - max(self._first_window, self._oldest_window)
        W = max(min(W, n_exist), 0)
        lo_slot = self._num_windows - W
        # slice off spare capacity rows (see _entity_row's doubling growth)
        counts = self._counts[:E, lo_slot:self._num_windows]         # [E, W]
        sums = self._sum[:E, lo_slot:self._num_windows]              # [E, W, M]
        maxs = self._max[:E, lo_slot:self._num_windows]
        lasts = self._latest[:E, lo_slot:self._num_windows]

        own = np.where(self._is_avg[None, None, :],
                       sums / np.maximum(counts[:, :, None], 1),
                       np.where(self._agg_funcs[None, None, :]
                                == AggregationFunction.MAX.value,
                                np.where(np.isfinite(maxs), maxs, 0.0), lasts))

        c = counts
        c_prev = np.pad(c, ((0, 0), (1, 0)))[:, :-1]                 # count of left neighbor
        c_next = np.pad(c, ((0, 0), (0, 1)))[:, 1:]
        s_prev = np.pad(sums, ((0, 0), (1, 0), (0, 0)))[:, :-1]
        s_next = np.pad(sums, ((0, 0), (0, 1), (0, 0)))[:, 1:]
        interior = np.zeros((E, W), bool)
        if W > 2:
            interior[:, 1:-1] = True

        sufficient = c >= self._half_min
        adjacent_ok = (interior & (c_prev >= self._min_samples)
                       & (c_next >= self._min_samples))
        own_some = c > 0

        # adjacent-pooled values
        pooled_cnt = np.maximum(c_prev + c + c_next, 1)[:, :, None]
        adj_avg = (s_prev + np.where(own_some[:, :, None], sums, 0.0) + s_next) / pooled_cnt
        nonavg_total = (np.pad(own, ((0, 0), (1, 0), (0, 0)))[:, :-1]
                        + np.where(own_some[:, :, None], own, 0.0)
                        + np.pad(own, ((0, 0), (0, 1), (0, 0)))[:, 1:])
        adj_nonavg = nonavg_total / np.where(own_some, 3.0, 2.0)[:, :, None]
        adj = np.where(self._is_avg[None, None, :], adj_avg, adj_nonavg)

        values = np.where(sufficient[:, :, None], own,
                          np.where(adjacent_ok[:, :, None], adj,
                                   np.where(own_some[:, :, None], own, 0.0)))
        extra = np.full((E, W), Extrapolation.NO_VALID_EXTRAPOLATION, np.uint8)
        extra[own_some] = Extrapolation.FORCED_INSUFFICIENT
        extra[adjacent_ok & ~sufficient] = Extrapolation.AVG_ADJACENT
        extra[sufficient & (c < self._min_samples)] = Extrapolation.AVG_AVAILABLE
        extra[c >= self._min_samples] = Extrapolation.NONE

        invalid_any = (extra == Extrapolation.NO_VALID_EXTRAPOLATION).any(axis=1)
        n_extrapolated = (extra != Extrapolation.NONE).sum(axis=1)
        entity_valid = ~invalid_any & (n_extrapolated <= self._max_extrapolations)

        window_ok = extra != Extrapolation.NO_VALID_EXTRAPOLATION
        completeness_per_window = window_ok.mean(axis=0)
        completeness = float(entity_valid.mean())

        start = (self._oldest_window + lo_slot)
        window_starts = [(start + i) * self._window_ms for i in range(W)]
        entities = [e for e, _ in sorted(self._entities.items(), key=lambda kv: kv[1])]
        return AggregationResult(entities, window_starts, values, extra,
                                 entity_valid, completeness_per_window, completeness)
