"""LoadMonitor: metric ingestion -> workload model (counterpart of
``cruise_control_tpu/monitor/load_monitor.py``).

The port's copy differs in what it wires from the config: it never resolves
a class-valued key (their defaults name the reference's classes), so the
sampler, a sample store, a capacity resolver and a partition assignor come
in as arguments (defaults: no store, ``DefaultCapacityResolver``, the
fetcher's own assignor). Its sensors are ``common.sensors.MetricRegistry``
(the facade's, or a private one), and a backend failure behind the fault
tolerance seam raises ``common.retries.ServiceUnavailableError``.

Reference: monitor/LoadMonitor.java:78 — owns the aggregators, metadata
client and capacity resolver; ``clusterModel(from, to, requirements, ...)``
(:539-591) aggregates windows, applies completeness gating
(meetCompletenessRequirements :639), resolves per-broker capacities
(:482-523) and populates the model per partition; pause/resume sampling
(:349-373); the task runner state machine lives in monitor/task/ (SamplingTask
scheduling — here a ``sample_once`` pull the caller or a host thread drives).

The built model is the dense ClusterTensor: windows are reduced at build time
(AVG for CPU/NW, LATEST for DISK — model/ModelUtils.java:154-168 via Load
expectedUtilizationFor), and CPU is attributed leader/follower via the static
weights (monitor/cpu_model.py).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.common.retries import ServiceUnavailableError
from cruise_control_tpu_torch.common.sensors import MetricRegistry
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
from cruise_control_tpu_torch.monitor.aggregator.sample_aggregator import MetricSampleAggregator
from cruise_control_tpu_torch.monitor.capacity import DefaultCapacityResolver
from cruise_control_tpu_torch.monitor.fetcher import MetricFetcherManager
from cruise_control_tpu_torch.monitor.cpu_model import (
    CpuModelParams, LinearRegressionCpuModel, estimate_follower_cpu_util,
)
from cruise_control_tpu_torch.monitor.metricdef import (
    BROKER_METRIC_DEF, PARTITION_METRIC_DEF,
)
from cruise_control_tpu_torch.monitor.sampling.samplers import Samples


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    """monitor/ModelCompletenessRequirements.java."""
    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.0
    include_all_topics: bool = False

    def stronger(self, other: "ModelCompletenessRequirements"):
        return ModelCompletenessRequirements(
            max(self.min_required_num_windows, other.min_required_num_windows),
            max(self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage),
            self.include_all_topics or other.include_all_topics)


class NotEnoughValidWindowsError(Exception):
    """Reference: NotEnoughValidWindowsException."""


@dataclasses.dataclass
class ModelGeneration:
    """monitor/ModelGeneration.java: (metadata generation, load generation)."""
    metadata_generation: int = -1
    load_generation: int = -1

    def as_tuple(self):
        return (self.metadata_generation, self.load_generation)


class LoadMonitorState:
    """Task-runner states (monitor/task/LoadMonitorTaskRunner.java
    LoadMonitorTaskRunnerState): NOT_STARTED/RUNNING/SAMPLING/PAUSED/
    BOOTSTRAPPING/TRAINING/LOADING."""
    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"
    LOADING = "LOADING"


class LoadMonitor:
    def __init__(self, config=None, backend=None, sampler=None, sample_store=None,
                 capacity_resolver=None, sensors=None, recorder=None,
                 fault_tolerance=None, tracer=None, cluster_id=None,
                 assignor=None, on_execution_store=None):
        self._sensors = sensors if sensors is not None else MetricRegistry()
        # fleet mode (PR 13): which tenant cluster this monitor (and its
        # per-tenant aggregators) belongs to — a label for state/logs only
        self.cluster_id = cluster_id
        # backend fault tolerance (common/retries.py): sampling rounds retry
        # transient backend failures and sit behind the shared
        # "monitor.sample" circuit breaker — a flaky metrics endpoint skips
        # rounds (windows age out, completeness gates serving) instead of
        # crashing the sampling loop. app.py passes its shared instance.
        self._ft = fault_tolerance
        self._sampling_failures = self._sensors.meter("sampling-fetch-failures")
        # flight recorder (common/tracing.py): sampling rounds note their
        # seconds so the next optimization's RoundTrace carries sampling_s
        self._recorder = recorder
        # span tracer: each ingested sampling batch is a ROOT span in the
        # causal journal (the "sample-ingest batch" root event) — stamped on
        # the backend clock, deterministic in the sim
        self._tracer = tracer
        # sensor catalog (LoadMonitor.java:180-195 gauges + :173 timer)
        self._model_timer = self._sensors.timer("cluster-model-creation-timer")
        self._sampling_timer = self._sensors.timer("metric-sampling-timer")
        self._sensors.gauge(
            "valid-windows",
            lambda: len(self._partition_agg.aggregate().window_starts_ms))
        self._sensors.gauge(
            "monitored-partitions-percentage",
            lambda: float(self._partition_agg.aggregate().entity_valid.mean())
            if self._partition_agg.aggregate().entity_valid.size else 0.0)
        self._sensors.gauge("total-monitored-windows",
                            lambda: self._partition_agg.num_windows)
        # metadata-factor gauge (LoadMonitor.java:190-192,:735): replicas x
        # brokers-with-replicas^exponent — quantifies metadata scale impact
        self._metadata_factor_exponent = (
            config.get_double("metadata.factor.exponent") if config else 1.0)
        self._sensors.gauge("metadata-factor", self._metadata_factor)
        self._config = config
        self._backend = backend
        self._sampler = sampler
        self._store = sample_store
        self._capacity = capacity_resolver or DefaultCapacityResolver()
        nw = config.get_int("num.metrics.windows") if config else 5
        wms = config.get_int("metrics.window.ms") if config else 300_000
        mspw = config.get_int("min.samples.per.metrics.window") if config else 3
        maxex = config.get_int("max.allowed.extrapolations.per.partition") if config else 5
        self._partition_agg = MetricSampleAggregator(nw, wms, mspw, maxex,
                                                     PARTITION_METRIC_DEF)
        bnw = config.get_int("num.broker.metrics.windows") if config else 20
        bwms = config.get_int("broker.metrics.window.ms") if config else 300_000
        bmspw = config.get_int("min.samples.per.broker.metrics.window") if config else 1
        bmaxex = config.get_int("max.allowed.extrapolations.per.broker") if config else 5
        self._broker_agg = MetricSampleAggregator(bnw, bwms, bmspw, bmaxex,
                                                  BROKER_METRIC_DEF)
        self._cpu_params = (CpuModelParams.from_config(config) if config
                            else CpuModelParams())
        self._state = LoadMonitorState.NOT_STARTED
        self._pause_reason = None
        self._state_update_interval_ms = (
            config.get_int("monitor.state.update.interval.ms")
            if config else 30_000)
        self._state_json_cache = None   # (payload, generation-key, monotonic-ts)
        self._lock = threading.Lock()
        self._model_semaphore = threading.Semaphore(2)  # LoadMonitor.java:92 cluster-model gate
        self.lr_cpu_model = LinearRegressionCpuModel(
            bucket_size_pct=config.get_int(
                "linear.regression.model.cpu.util.bucket.size")
            if config else 5)
        self._bootstrap_progress = 0.0
        num_fetchers = config.get_int("num.metric.fetchers") if config else 1
        self._fetchers = MetricFetcherManager(self._sampler, num_fetchers,
                                              assignor=assignor) \
            if self._sampler is not None else None
        # MonitorConfig skip.loading.samples: bypass sample-store replay
        self._skip_loading = (config.get_boolean("skip.loading.samples")
                              if config else False)
        # metadata.max.age.ms: the sampling path reuses its partition-universe
        # snapshot until it ages out (MetadataClient refresh budget role)
        self._metadata_max_age_ms = (config.get_int("metadata.max.age.ms")
                                     if config else 300_000)
        self._partition_list_cache: list | None = None
        self._partition_list_ts = -1e18
        # monitor.use.columnar.snapshot: consume the backend's columnar
        # ClusterSnapshot in cluster_model (the dict path stays available for
        # equivalence testing / exotic backends)
        self._use_snapshot = (config.get_boolean("monitor.use.columnar.snapshot")
                              if config else True)
        # (partition -> index) map reused across model builds, keyed by the
        # snapshot's metadata generation
        self._pidx_cache: tuple | None = None
        # an extra store recording samples DURING execution
        # (sample.partition.metric.store.on.execution.class); consulted by
        # samplers via on_execution_store
        self.on_execution_store = on_execution_store

    def _metadata_read(self, fn):
        """One model-build metadata read through the shared breaker: raw
        transient errors / open circuits become the DECLARED degraded-read
        signal (ServiceUnavailableError) the REST layer maps to 503."""
        if self._ft is None:
            return fn()
        try:
            return self._ft.call("monitor.sample", fn)
        except Exception as e:
            raise ServiceUnavailableError(
                f"cluster metadata unavailable ({type(e).__name__}: {e})",
                retry_after_s=self._ft.retry_after_s()) from e

    def _snapshot(self):
        """Columnar metadata: the backend's native ``snapshot()`` when it has
        one, else derived from the dict metadata via the protocol shim."""
        snap_fn = getattr(self._backend, "snapshot", None)
        if snap_fn is not None:
            return snap_fn()
        from cruise_control_tpu_torch.backend.interface import snapshot_from_metadata
        return snapshot_from_metadata(self._backend.brokers(),
                                      self._backend.partitions(),
                                      self._backend.metadata_generation())

    def attach_sample_store(self, store) -> None:
        """Late-bind a sample store: subsequent sampling rounds are recorded
        to it (and replayed by a fresh monitor's ``start_up``). The bench's
        restart-recovery measurement uses this to record only its final
        rounds instead of paying store writes inside every timed sampling
        figure; service deployments configure ``sample.store.path`` and get
        the store from construction."""
        self._store = store

    def _metadata_factor(self) -> float:
        if self._backend is None:
            return 0.0
        # computed lazily under the same metadata.max.age.ms budget as the
        # sampling path — a sensor scrape must not trigger a fresh
        # full-partition dump over the backend wire each poll
        now = time.time() * 1000.0
        cached = getattr(self, "_metadata_factor_cache", None)
        if cached is not None and now - cached[0] < self._metadata_max_age_ms:
            return cached[1]
        snap = self._snapshot()
        num_replicas = snap.num_replicas
        brokers_with = np.unique(snap.rep_bid).size
        value = num_replicas * (brokers_with
                                ** self._metadata_factor_exponent)
        self._metadata_factor_cache = (now, value)
        return value

    # ------------------------------------------------------------ lifecycle
    def start_up(self) -> int:
        """Replay persisted samples (SampleLoadingTask role), go RUNNING."""
        n = 0
        if self._store is not None and not self._skip_loading:
            self._state = LoadMonitorState.LOADING
            n = self._store.load_samples(self._ingest)
        self._state = LoadMonitorState.RUNNING
        return n

    # --------------------------------------------------- bootstrap/training
    def bootstrap(self, start_ms: float | None = None, end_ms: float | None = None,
                  clear_metrics: bool = True) -> dict:
        """Backfill metric windows by sampling over [start, end] at window
        granularity (monitor/task/BootstrapTask.java role). With no range
        given, bootstraps the full partition-window history ending now."""
        with self._lock:
            if self._state in (LoadMonitorState.BOOTSTRAPPING,
                               LoadMonitorState.TRAINING):
                raise RuntimeError(f"load monitor is busy ({self._state})")
            prev = self._state
            self._state = LoadMonitorState.BOOTSTRAPPING
        wms = self._partition_agg.window_ms
        if end_ms is None:
            # unified service-mode clock: the backfill range ends at the same
            # clock live sampling stamps from, so a bootstrap can never roll
            # the ring past (or short of) the windows live rounds fill
            end_ms = self.now_ms()
        # samples older than the ring depth are discarded on ingest, so a
        # wider range would only burn sampler calls: clamp to the window span
        horizon = end_ms - self._partition_agg.num_windows * wms
        start_ms = horizon if start_ms is None else max(start_ms, horizon)
        if clear_metrics:
            self._partition_agg.clear()
            self._broker_agg.clear()
        try:
            steps = 0
            t = start_ms
            while t <= end_ms:
                self._bootstrap_progress = (t - start_ms) / max(end_ms - start_ms, 1.0)
                if self._sampler is not None:
                    self._ingest(self._sampler.get_samples(t))
                t += wms
                steps += 1
            self._bootstrap_progress = 1.0
        finally:
            with self._lock:
                # a concurrent pause/resume may have changed the state while
                # bootstrapping; only restore it if it is still ours
                if self._state == LoadMonitorState.BOOTSTRAPPING:
                    self._state = prev if prev != LoadMonitorState.NOT_STARTED \
                        else LoadMonitorState.RUNNING
        return {"numWindowsSampled": steps, "startMs": int(start_ms),
                "endMs": int(end_ms), "clearedMetrics": bool(clear_metrics)}

    def train(self, start_ms: float | None = None, end_ms: float | None = None) -> dict:
        """Fit the linear-regression CPU attribution model from broker samples
        (monitor/task/TrainingTask.java + LinearRegressionModelParameters.java
        role): regress broker CPU on total bytes-in/bytes-out over the sampled
        range, making estimate_leader_cpu_util's static weights replaceable."""
        with self._lock:
            if self._state in (LoadMonitorState.BOOTSTRAPPING,
                               LoadMonitorState.TRAINING):
                raise RuntimeError(f"load monitor is busy ({self._state})")
            prev = self._state
            self._state = LoadMonitorState.TRAINING
        try:
            wms = self._broker_agg.window_ms
            if end_ms is None:
                end_ms = self.now_ms()   # unified service-mode clock
            horizon = end_ms - self._broker_agg.num_windows * wms
            start_ms = horizon if start_ms is None else max(start_ms, horizon)
            cpu, b_in, b_out = [], [], []
            t = start_ms
            while t <= end_ms:
                if self._sampler is not None:
                    for s in self._sampler.get_samples(t).broker_samples:
                        cpu.append(s.values.get("BROKER_CPU_UTIL", 0.0))
                        b_in.append(s.values.get("ALL_TOPIC_BYTES_IN", 0.0)
                                    + s.values.get("ALL_TOPIC_REPLICATION_BYTES_IN", 0.0))
                        b_out.append(s.values.get("ALL_TOPIC_BYTES_OUT", 0.0))
                t += wms
            if cpu:
                self.lr_cpu_model.train(np.asarray(b_in), np.asarray(b_out),
                                        np.asarray(cpu))
        finally:
            with self._lock:
                if self._state == LoadMonitorState.TRAINING:
                    self._state = prev if prev != LoadMonitorState.NOT_STARTED \
                        else LoadMonitorState.RUNNING
        return {"numTrainingSamples": len(cpu),
                "trained": self.lr_cpu_model.trained,
                "trainingCompleteness":
                    self.lr_cpu_model.training_completeness()}

    def shutdown(self):
        if self._store is not None:
            self._store.close()
        if self._fetchers is not None:
            self._fetchers.close()
        if self._sampler is not None:
            self._sampler.close()
        self._state = LoadMonitorState.NOT_STARTED

    def pause_sampling(self, reason: str = "operator request"):
        """LoadMonitor.pauseMetricSampling (:349)."""
        with self._lock:
            self._state = LoadMonitorState.PAUSED
            self._pause_reason = reason

    def resume_sampling(self, reason: str = "operator request"):
        with self._lock:
            self._state = LoadMonitorState.RUNNING
            self._pause_reason = None

    @property
    def state(self) -> str:
        return self._state

    @property
    def pause_reason(self):
        return self._pause_reason

    # ------------------------------------------------------------- sampling
    def now_ms(self) -> float:
        """The monitor's UNIFIED service-mode clock: the backend's canonical
        ``now_ms()`` when it has one (the sim clock in simulated deployments,
        wall time in real ones), wall time otherwise. Sampling, bootstrap and
        training all stamp from THIS clock, so aggregation windows form from
        live sampling alone on the same timeline the detector, executor and
        proposal cache already run on — before this, samples were stamped
        with wall time regardless, so a service whose backend clock advanced
        (sim deployments, tests, the bench) could never fill windows by
        sampling and stayed completeness-gated until a GET /bootstrap
        backfilled them."""
        now = getattr(self._backend, "now_ms", None)
        if now is None:
            return time.time() * 1000.0
        return float(now())

    def fetch_samples(self, now_ms: float | None = None):
        """Fetch one round of samples WITHOUT ingesting them — the pipelined
        loop's ingest stage (the sampling thread pushes the result into the
        ring buffer; the sync stage ingests). Returns ``(samples, now,
        fetch_s)`` or ``None`` when paused / no sampler / the fetch failed
        (a failed round is a SKIPPED round — windows simply don't advance)."""
        if self._state == LoadMonitorState.PAUSED or self._sampler is None:
            return None
        t0 = time.monotonic()
        now = now_ms if now_ms is not None else self.now_ms()

        def fetch():
            # the fetcher pool splits the partition universe across concurrent
            # fetchers (MetricFetcherManager + partition assignor role)
            if self._fetchers is not None and self._backend is not None:
                if (self._partition_list_cache is None
                        or now - self._partition_list_ts
                        >= self._metadata_max_age_ms):
                    # the columnar snapshot carries the sorted key list
                    # already — no need to materialize the PartitionInfo
                    # dict for it
                    self._partition_list_cache = (
                        list(self._snapshot().partition_keys)
                        if self._use_snapshot
                        else list(self._backend.partitions()))
                    self._partition_list_ts = now
                return self._fetchers.fetch_once(now, self._partition_list_cache)
            return self._sampler.get_samples(now)

        try:
            samples = (self._ft.call("monitor.sample", fetch)
                       if self._ft is not None else fetch())
        except Exception:
            # windows simply don't advance (completeness gating degrades
            # serving if this persists past the window budget)
            self._sampling_failures.mark()
            import logging
            logging.getLogger(__name__).warning(
                "sampling round skipped: backend fetch failed", exc_info=True)
            return None
        return samples, now, time.monotonic() - t0

    def ingest_samples(self, samples: Samples, fetch_s: float = 0.0) -> int:
        """Ingest one fetched round into the aggregators + stores — the
        pipelined loop's sync-stage half of ``sample_once``. ``fetch_s``
        (the ingest-stage fetch wall this round already paid) folds into the
        ``metric-sampling-timer`` / flight-recorder sampling note so the
        pipelined and blocking loops report the same per-round figure."""
        t0 = time.monotonic()
        n = self._ingest(samples)
        if self._tracer is not None:
            # one root span per ingested batch (zero-duration on the backend
            # clock; the wall seconds ride the sampling timer, not the
            # journal — journal bytes must stay (scenario, seed)-identical)
            self._tracer.span("sampling", "sample-ingest", samples=n).end()
        if self._store is not None:
            self._store.store_samples(samples)
        if self.on_execution_store is not None:
            # sample.partition.metric.store.on.execution.class: a second
            # store that keeps only mid-execution samples (its own class
            # gates on executor.has_ongoing_execution)
            self.on_execution_store.store_samples(samples)
        if fetch_s:
            dur = fetch_s + (time.monotonic() - t0)
            self._sampling_timer.record(dur)
            if self._recorder is not None:
                self._recorder.note_sampling(dur)
        return n

    def sample_once(self, now_ms: float | None = None) -> int:
        """One BLOCKING sampling round (SamplingTask.run ->
        MetricFetcherManager.fetchMetricSamples path): fetch + ingest in one
        call. Returns #samples ingested. The pipelined service loop runs the
        two halves (``fetch_samples`` / ``ingest_samples``) on separate
        stages instead."""
        t0 = time.monotonic()
        fetched = self.fetch_samples(now_ms)
        if fetched is None:
            return 0
        samples, _now, _fetch_s = fetched
        n = self.ingest_samples(samples)
        dur = time.monotonic() - t0
        self._sampling_timer.record(dur)
        if self._recorder is not None:
            self._recorder.note_sampling(dur)
        return n

    def _ingest(self, samples: Samples) -> int:
        n = 0
        # columnar blocks (one per sampling round on the fast path) feed the
        # aggregator's bulk scatter directly — zero per-partition objects
        for block in getattr(samples, "partition_blocks", ()):
            n += self._partition_agg.add_samples(block.entities, block.ts_ms,
                                                 block.values,
                                                 list(block.metric_names))
        n += self._ingest_bulk(self._partition_agg, samples.partition_samples,
                               lambda s: (s.topic, s.partition))
        n += self._ingest_bulk(self._broker_agg, samples.broker_samples,
                               lambda s: s.broker_id)
        return n

    @staticmethod
    def _ingest_bulk(agg, sample_list, entity_of) -> int:
        """Group samples by (timestamp, metric-name-tuple) and bulk-add each
        group. A normal sampling round is ONE group (the sampler stamps every
        sample with the same collection time), so ingestion is a single
        vectorized scatter; heterogeneous rounds (mixed samplers / stores
        replaying different metric sets) become one scatter PER group instead
        of N python add_sample calls — at 500k partitions the per-sample
        fallback alone cost ~10 s/round."""
        if not sample_list:
            return 0
        groups: dict[tuple, list] = {}
        for s in sample_list:
            groups.setdefault((s.ts_ms, tuple(s.values)), []).append(s)
        n = 0
        for (ts, names), group in groups.items():
            values = np.array([[s.values[m] for m in names] for s in group],
                              dtype=float)
            n += agg.add_samples([entity_of(s) for s in group], ts, values,
                                 list(names))
        return n

    # ---------------------------------------------------------- completeness
    def meet_completeness_requirements(self, req: ModelCompletenessRequirements) -> bool:
        """LoadMonitor.meetCompletenessRequirements (:639)."""
        agg = self._partition_agg.aggregate()
        if len(agg.window_starts_ms) < req.min_required_num_windows:
            return False
        monitored = (agg.entity_valid.mean() if agg.entity_valid.size else 0.0)
        return monitored >= req.min_monitored_partitions_percentage

    def model_generation(self) -> ModelGeneration:
        return ModelGeneration(
            metadata_generation=(self._backend.metadata_generation()
                                 if self._backend else -1),
            load_generation=self._partition_agg.generation)

    def partition_window_view(self):
        """Zero-copy ``(AggregationResult, load_generation)`` over the
        partition aggregator's completed-window history — the forecast
        subsystem's read seam. The arrays are the aggregator's own memoized
        buffers (f64[E, W, M] values + u8[E, W] extrapolations), handed out
        without copying so a per-tick consumer costs nothing while no new
        window has rolled; consumers key their caches on the stamp and must
        not mutate the arrays."""
        return self._partition_agg.window_view()

    @property
    def num_valid_windows(self) -> int:
        return len(self._partition_agg.aggregate().window_starts_ms)

    def _num_partitions(self) -> int:
        if self._backend is None:
            return 0
        if self._use_snapshot:
            return self._snapshot().num_partitions
        return len(self._backend.partitions())

    def monitored_partitions_percentage(self) -> float:
        agg = self._partition_agg.aggregate()
        total = self._num_partitions() if self._backend else len(agg.entities)
        if total == 0:
            return 0.0
        return float(agg.entity_valid.sum()) / total

    # --------------------------------------------------------------- model
    def _entity_rows(self, agg, tps: list, generation: int) -> np.ndarray:
        """i64[P]: aggregator entity row for each partition key (-1 when the
        partition was never sampled). The (partition -> index) dict is cached
        per metadata generation — at 500k partitions rebuilding it every
        model build is the dominant remaining Python cost."""
        cached = self._pidx_cache
        if cached is not None and cached[0] == (generation, len(tps)):
            pidx = cached[1]
        else:
            pidx = {tp: i for i, tp in enumerate(tps)}
            self._pidx_cache = ((generation, len(tps)), pidx)
        rows = np.full(len(tps), -1, np.int64)
        get = pidx.get
        for j, e in enumerate(agg.entities):
            i = get(e)
            if i is not None:
                rows[i] = j
        return rows

    def populate_brokers(self, builder, brokers=None, logdir_state=None,
                         allow_capacity_estimation: bool = True):
        """Register every broker (capacities, logdirs, dead disks) on
        ``builder`` exactly as the model build does; returns
        ``(lds_by_broker, dead_by_broker)``. Shared by ``cluster_model`` and
        the resident session's broker-axis refresh so the two can never
        diverge on capacity/logdir semantics."""
        if brokers is None:
            brokers = self._metadata_read(self._backend.brokers)
        if logdir_state is None:
            logdir_state = self._metadata_read(self._backend.describe_logdirs)
        lds_by_broker: dict = {}     # broker id -> ordered logdir names
        dead_by_broker: dict = {}    # broker id -> set of dead names
        for b, node in brokers.items():
            cap_info = self._capacity.capacity_for(b)
            if cap_info.estimated and not allow_capacity_estimation:
                raise RuntimeError(
                    f"capacity estimation not allowed but required for broker {b}")
            logdirs = list(node.logdirs) or ["/logdir0"]
            if cap_info.disk_capacity_by_logdir:
                # match resolver capacities to broker logdirs BY NAME;
                # unknown dirs fall back to an even share of total DISK
                per = cap_info.capacity[Resource.DISK] / len(logdirs)
                disk_caps = [cap_info.disk_capacity_by_logdir.get(ld, per)
                             for ld in logdirs]
            elif cap_info.estimated:
                # estimation fallback: the backend's reported logdir sizes
                # stand in for unknown real capacities
                per = cap_info.capacity[Resource.DISK] / len(logdirs)
                disk_caps = [node.logdirs.get(ld, per) for ld in logdirs]
            else:
                # a configured resolver entry is authoritative
                # (BrokerCapacityConfigFileResolver precedence)
                per = cap_info.capacity[Resource.DISK] / len(logdirs)
                disk_caps = [per] * len(logdirs)
            dead = set(node.dead_logdirs)
            dead |= {ld for ld, ok in logdir_state.get(b, {}).items() if not ok}
            lds_by_broker[b] = logdirs
            dead_by_broker[b] = dead
            builder.add_broker(
                b, rack=node.rack, alive=node.alive,
                capacity={Resource.CPU: cap_info.capacity[Resource.CPU],
                          Resource.DISK: sum(disk_caps),
                          Resource.NW_IN: cap_info.capacity[Resource.NW_IN],
                          Resource.NW_OUT: cap_info.capacity[Resource.NW_OUT]},
                logdirs=logdirs, disk_capacity=disk_caps, dead_disks=dead)
        return lds_by_broker, dead_by_broker

    def _reduced_entity_loads(self, agg):
        """Window-reduce the aggregator: AVG for CPU/NW, LATEST for DISK over
        VALID windows only (RawMetricValues.isValid :166 role), with the
        optional trained linear-regression CPU substitution. Returns
        per-entity ``(cpu_e, lin_e, lout_e, disk_e)``."""
        use_lr = (self._config is not None
                  and self._config.get_boolean("use.linear.regression.model")
                  and self.lr_cpu_model.trained)
        mdef = PARTITION_METRIC_DEF
        id_cpu = mdef.info("CPU_USAGE").metric_id
        id_din = mdef.info("DISK_USAGE").metric_id
        id_lin = mdef.info("LEADER_BYTES_IN").metric_id
        id_lout = mdef.info("LEADER_BYTES_OUT").metric_id
        from cruise_control_tpu_torch.monitor.aggregator.sample_aggregator import (
            Extrapolation,
        )
        # zero-filled NO_VALID_EXTRAPOLATION windows would dilute the
        # mean (and LATEST could read a hole): reduce over valid windows only
        E = len(agg.entities)
        W = agg.values.shape[1] if E else 0
        wmask = agg.extrapolations != Extrapolation.NO_VALID_EXTRAPOLATION
        any_valid = wmask.any(axis=1) if E else np.zeros(0, bool)
        nvalid = np.maximum(wmask.sum(axis=1), 1) if E else np.zeros(0)
        if not E:
            z = np.zeros(0)
            return z, z, z, z
        mean = ((agg.values * wmask[:, :, None]).sum(axis=1)
                / nvalid[:, None])
        last = W - 1 - np.argmax(wmask[:, ::-1], axis=1)
        disk_e = agg.values[np.arange(E), last, id_din]
        cpu_e = np.where(any_valid, mean[:, id_cpu], 0.0)
        lin_e = np.where(any_valid, mean[:, id_lin], 0.0)
        lout_e = np.where(any_valid, mean[:, id_lout], 0.0)
        disk_e = np.where(any_valid, disk_e, 0.0)
        if use_lr:
            cpu_e = np.where(
                any_valid,
                np.maximum(0.0, self.lr_cpu_model.predict(lin_e, lout_e)),
                0.0)
        return cpu_e, lin_e, lout_e, disk_e

    def partition_load_columns(self, tps: list, generation: int,
                               agg=None, rows: np.ndarray | None = None):
        """Per-partition load columns aligned to ``tps``:
        ``(cpu_p, lin_p, lout_p, disk_p, fcpu_p)``. This is the
        metric-refresh half of ``cluster_model`` on its own — the resident
        session re-reads it every round without touching topology."""
        if agg is None:
            agg = self._partition_agg.aggregate()
        cpu_e, lin_e, lout_e, disk_e = self._reduced_entity_loads(agg)
        E = len(agg.entities)
        P = len(tps)
        if rows is None:
            rows = self._entity_rows(agg, tps, generation)
        has = rows >= 0
        rr = np.clip(rows, 0, None)

        def per_part(x):
            return np.where(has, x[rr], 0.0) if E else np.zeros(P)

        cpu_p, lin_p, lout_p, disk_p = (per_part(x) for x in
                                        (cpu_e, lin_e, lout_e, disk_e))
        fcpu_p = estimate_follower_cpu_util(cpu_p, lin_p, lout_p,
                                            self._cpu_params)
        return cpu_p, lin_p, lout_p, disk_p, fcpu_p

    @staticmethod
    def replica_load_rows(cols, rep_part: np.ndarray):
        """Gather partition load columns to the replica axis: the
        ``(leader_load, follower_load)`` f32[Rv, M] rows the model build and
        the session's metric-window refresh both upload."""
        cpu_p, lin_p, lout_p, disk_p, fcpu_p = cols
        Rv = rep_part.shape[0]
        M = len(Resource)
        leader_load = np.zeros((Rv, M), np.float32)
        leader_load[:, Resource.CPU] = cpu_p[rep_part]
        leader_load[:, Resource.NW_IN] = lin_p[rep_part]
        leader_load[:, Resource.NW_OUT] = lout_p[rep_part]
        leader_load[:, Resource.DISK] = disk_p[rep_part]
        follower_load = leader_load.copy()
        follower_load[:, Resource.CPU] = fcpu_p[rep_part]
        follower_load[:, Resource.NW_OUT] = 0.0
        return leader_load, follower_load

    def cluster_model(self, requirements: ModelCompletenessRequirements | None = None,
                      allow_capacity_estimation: bool = True,
                      use_snapshot: bool | None = None):
        """Build (ClusterTensor, ClusterMeta) from current metadata + windows
        (LoadMonitor.clusterModel :539-591).

        ``use_snapshot`` overrides monitor.use.columnar.snapshot: True builds
        from the backend's columnar ClusterSnapshot (array joins end to end),
        False from the legacy ``partitions()`` dict (per-replica generator
        loops) — both produce bit-identical tensors."""
        if self._backend is None:
            raise RuntimeError("LoadMonitor has no cluster backend")
        req = requirements or ModelCompletenessRequirements()
        use_snap = self._use_snapshot if use_snapshot is None else use_snapshot
        with self._model_timer.time(), self._model_semaphore:
            agg = self._partition_agg.aggregate()
            if len(agg.window_starts_ms) < req.min_required_num_windows:
                raise NotEnoughValidWindowsError(
                    f"{len(agg.window_starts_ms)} valid windows < required "
                    f"{req.min_required_num_windows}")
            snap = None
            partitions = None
            # the build's metadata read shares the sampling breaker: a
            # backend outage surfaces here as a DECLARED degraded read
            # (ServiceUnavailableError -> 503 + Retry-After; the proposals
            # path falls back to its stale cache) instead of a raw metadata
            # error mid-build. NOTE: only this deterministic caller rides
            # the breaker — the wall-clock-cached metadata-factor gauge
            # keeps its direct read so scrape counts can never shift
            # breaker state
            if use_snap:
                snap = self._metadata_read(self._snapshot)
                num_partitions = snap.num_partitions
            else:
                partitions = self._metadata_read(self._backend.partitions)
                num_partitions = len(partitions)
            if num_partitions:
                valid_frac = float(agg.entity_valid.sum()) / num_partitions
                if valid_frac < req.min_monitored_partitions_percentage:
                    raise NotEnoughValidWindowsError(
                        f"monitored partition ratio {valid_frac:.3f} < required "
                        f"{req.min_monitored_partitions_percentage:.3f}")
            brokers = self._metadata_read(self._backend.brokers)
            builder = ClusterModelBuilder()
            lds_by_broker, dead_by_broker = self.populate_brokers(
                builder, brokers,
                allow_capacity_estimation=allow_capacity_estimation)

            # window-reduce AVG for CPU/NW, LATEST for DISK — vectorized over
            # every entity at once: one masked mean over [E, W, M]
            # (LoadMonitor.java:539-591 + cluster-model-creation-timer role),
            # then map entity rows -> the (sorted) partition list
            # (_reduced_entity_loads / partition_load_columns — shared with
            # the resident session's per-round metric refresh)
            if use_snap:
                tps = snap.partition_keys
                infos = None
                P = num_partitions
                rows = self._entity_rows(agg, tps, snap.generation)
            else:
                tps = sorted(partitions)
                infos = [partitions[tp] for tp in tps]
                P = len(tps)
                row_of = {e: i for i, e in enumerate(agg.entities)}
                rows = np.fromiter((row_of.get(tp, -1) for tp in tps),
                                   dtype=np.int64, count=P)
            cols = self.partition_load_columns(tps, -1, agg=agg, rows=rows)

            broker_ids = sorted(brokers)
            sorted_bids = np.asarray(broker_ids, dtype=np.int64)
            alive_b = np.asarray([brokers[b].alive for b in broker_ids])
            # (broker id, logdir name) -> logdir index; dead flagged per
            # index — reusing the names/dead sets the add_broker loop derived
            # so replica offline marking can't diverge from broker_disk_alive
            dixmap: dict = {}
            Dmax = max((len(lds_by_broker[b]) for b in broker_ids), default=1)
            dead_arr = np.zeros((len(broker_ids), Dmax), bool)
            for bi, b in enumerate(broker_ids):
                lds = lds_by_broker[b]
                dead = dead_by_broker[b]
                for d, ld in enumerate(lds):
                    dixmap[(b, ld)] = d
                    dead_arr[bi, d] = ld in dead

            if use_snap:
                # the snapshot already carries the flattened replica axis;
                # its rep_disk indices follow BrokerNode.logdirs order — the
                # same order lds_by_broker/dixmap were built from
                nrep = np.diff(snap.rep_ptr)
                rep_bid = snap.rep_bid
                rep_leader = snap.rep_leader
                rep_disk = np.minimum(snap.rep_disk, Dmax - 1)
            else:
                nrep = np.fromiter((len(i.replicas) for i in infos),
                                   dtype=np.int64, count=P)
                rep_bid = np.fromiter((b for i in infos for b in i.replicas),
                                      dtype=np.int64, count=int(nrep.sum()))
                rep_leader = np.fromiter(
                    (b == i.leader for i in infos for b in i.replicas),
                    dtype=bool, count=int(nrep.sum()))
                # logdir index per replica; unknown/unassigned dirs default to
                # index 0 INCLUDING its deadness (a replica whose logdir we
                # can't resolve on a broker whose first dir is dead must stay
                # self-healing-eligible)
                rep_disk = np.fromiter(
                    (dixmap.get((b, i.logdir_by_broker.get(b)), 0)
                     for i in infos for b in i.replicas),
                    dtype=np.int64, count=int(nrep.sum()))
            rep_part = np.repeat(np.arange(P, dtype=np.int64), nrep)
            rep_bidx = np.searchsorted(sorted_bids, rep_bid)
            # a replica on a broker id absent from brokers() is metadata
            # corruption — fail loudly (the pre-vectorized path's KeyError)
            rep_bidx = np.clip(rep_bidx, 0, len(broker_ids) - 1)
            bad = sorted_bids[rep_bidx] != rep_bid
            if bad.any():
                raise KeyError(
                    f"replica assigned to unknown broker id(s) "
                    f"{sorted(set(rep_bid[bad].tolist()))[:5]}")
            rep_offline = (~alive_b[rep_bidx]) | dead_arr[rep_bidx, rep_disk]

            leader_load, follower_load = self.replica_load_rows(cols, rep_part)

            if use_snap:
                topics = list(snap.topics)
                partition_topic = snap.partition_topic
            else:
                topics = sorted({t for t, _ in tps})
                partition_topic = None
            return builder.build_from_arrays(
                topics=topics, partitions=tps,
                replica_partition=rep_part, replica_broker=rep_bidx,
                replica_disk=rep_disk, replica_is_leader=rep_leader,
                replica_offline=rep_offline,
                leader_load=leader_load, follower_load=follower_load,
                partition_topic=partition_topic)

    # ---------------------------------------------------------------- state
    def state_json(self) -> dict:
        """Monitor state, recomputed at most every
        monitor.state.update.interval.ms (MonitorConfig.java:346-347 — the
        reference refreshes its state sensors on that schedule; aggregation
        over every entity is not free at 1M replicas) and invalidated by any
        load-generation bump."""
        import time as _time
        now = _time.monotonic()
        cached = self._state_json_cache
        gen = (self._partition_agg.generation, self._state, self._pause_reason)
        if (cached is not None and cached[1] == gen
                and now - cached[2] < self._state_update_interval_ms / 1000.0):
            return dict(cached[0])
        out = self._state_json()
        self._state_json_cache = (out, gen, now)
        return dict(out)

    def _state_json(self) -> dict:
        agg = self._partition_agg.aggregate()
        out = {
            "state": self._state,
            "reasonOfPauseOrResume": self._pause_reason,
            "numValidWindows": len(agg.window_starts_ms),
            "numMonitoredWindows": len(agg.window_starts_ms),
            "monitoredPartitionsPercentage":
                float(agg.entity_valid.mean()) if agg.entity_valid.size else 0.0,
            "totalNumPartitions": self._num_partitions(),
            "loadGeneration": self._partition_agg.generation,
        }
        if self.cluster_id is not None:
            out["clusterId"] = self.cluster_id
        if self._state == LoadMonitorState.BOOTSTRAPPING:
            # LoadMonitorState.java reports bootstrap progress while active
            out["bootstrapProgressPct"] = round(100.0 * self._bootstrap_progress, 1)
        return out
