"""(Counterpart of ``cruise_control_tpu/monitor/sampling/samplers.py``, copied with the
port's imports.) MetricSampler SPI + implementations.

Reference: monitor/sampling/MetricSampler.java (SPI), AbstractMetricSampler,
CruiseControlMetricsReporterSampler (default: consumes the in-broker
reporter's __CruiseControlMetrics topic), prometheus/PrometheusMetricSampler
(:1-289), NoopSampler.

Here the default is a SimulatedMetricSampler that pulls per-partition /
per-broker metrics from a ClusterBackend (the simulated cluster stands in for
real Kafka, SURVEY §4.5). A real-cluster sampler would be another plugin.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Protocol


@dataclasses.dataclass(frozen=True)
class PartitionSample:
    topic: str
    partition: int
    ts_ms: float
    values: dict          # partition model metric name -> value


@dataclasses.dataclass(frozen=True)
class BrokerSample:
    broker_id: int
    ts_ms: float
    values: dict          # broker model metric name -> value


@dataclasses.dataclass
class PartitionSampleBlock:
    """One sampling round's partition samples in columnar form: N samples
    sharing a collection timestamp and metric-name set, values ``[N, M]``.
    Feeds MetricSampleAggregator.add_samples directly — no per-partition
    sample objects on the e2e hot path (they cost seconds per round at 500k
    partitions). ``to_samples()`` expands lazily for consumers that need the
    row-object view (durable sample stores)."""
    entities: list        # [(topic, partition)]
    ts_ms: float
    metric_names: list    # column order of ``values``
    values: "object"      # ndarray f64[N, len(metric_names)]

    def __len__(self) -> int:
        return len(self.entities)

    def to_samples(self) -> list:
        names = self.metric_names
        return [PartitionSample(topic=t, partition=p, ts_ms=self.ts_ms,
                                values=dict(zip(names, row.tolist())))
                for (t, p), row in zip(self.entities, self.values)]


@dataclasses.dataclass
class Samples:
    partition_samples: list
    broker_samples: list
    # columnar blocks ride NEXT TO the row-object list (either may be empty);
    # consumers that iterate rows use all_partition_samples()
    partition_blocks: list = dataclasses.field(default_factory=list)

    def num_partition_samples(self) -> int:
        return (len(self.partition_samples)
                + sum(len(b) for b in self.partition_blocks))

    def all_partition_samples(self) -> Iterable:
        """Row-object view over the list AND the columnar blocks (blocks are
        expanded lazily — only consumers that truly need per-row objects,
        e.g. the durable stores, pay for the expansion)."""
        yield from self.partition_samples
        for block in self.partition_blocks:
            yield from block.to_samples()


class MetricSampler(Protocol):
    def configure(self, config, **extra) -> None: ...

    def get_samples(self, now_ms: float, partitions=None,
                    include_broker_samples: bool = True) -> Samples:
        """``partitions`` (optional list of (topic, partition)) restricts the
        fetch to a fetcher's assigned subset (MetricFetcherManager role);
        None = everything. ``include_broker_samples=False`` skips the broker-
        level fetch (only one fetcher per round collects it)."""
        ...

    def close(self) -> None: ...


class NoopSampler:
    """NoopSampler.java analogue."""

    def configure(self, config, **extra):
        pass

    def get_samples(self, now_ms: float, partitions=None,
                    include_broker_samples: bool = True) -> Samples:
        return Samples([], [])

    def close(self):
        pass


class SimulatedMetricSampler:
    """Samples the simulated cluster backend. The backend exposes
    ``partition_metrics()`` / ``broker_metrics()`` snapshots; this sampler
    stamps them with the collection time. When the backend provides the
    columnar ``partition_metrics_columnar()`` view, a full-universe fetch
    returns ONE PartitionSampleBlock instead of N sample objects — the
    aggregator ingests it as a single vectorized scatter."""

    def __init__(self, backend=None, columnar: bool = True):
        self._backend = backend
        self._columnar = columnar

    def configure(self, config, backend=None, **extra):
        if backend is not None:
            self._backend = backend

    def get_samples(self, now_ms: float, partitions=None,
                    include_broker_samples: bool = True) -> Samples:
        if self._backend is None:
            return Samples([], [])
        bsamples = [BrokerSample(broker_id=b, ts_ms=now_ms, values=vals)
                    for b, vals in self._backend.broker_metrics().items()] \
            if include_broker_samples else []
        columnar = (self._columnar and partitions is None
                    and getattr(self._backend, "partition_metrics_columnar",
                                None))
        if columnar:
            entities, names, values = columnar()
            block = PartitionSampleBlock(entities=entities, ts_ms=now_ms,
                                         metric_names=names, values=values)
            return Samples([], bsamples, partition_blocks=[block])
        wanted = set(partitions) if partitions is not None else None
        psamples = [PartitionSample(topic=t, partition=p, ts_ms=now_ms, values=vals)
                    for (t, p), vals in self._backend.partition_metrics().items()
                    if wanted is None or (t, p) in wanted]
        return Samples(psamples, bsamples)

    def close(self):
        pass
