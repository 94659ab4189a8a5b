"""(Counterpart of ``cruise_control_tpu/monitor/fetcher.py``, copied with the
port's imports.) Parallel metric fetching.

Reference: monitor/sampling/MetricFetcherManager.java:37 (thread pool of
SamplingFetcher tasks) + DefaultMetricSamplerPartitionAssignor.java (splits
the partition universe across fetchers). One sampler instance serves all
fetchers; each fetcher asks it for a disjoint partition subset, and broker
samples are fetched by the first fetcher only (brokers are not partitioned in
the reference either — BrokerMetricSample collection is per-sampler-round).
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

from cruise_control_tpu_torch.monitor.sampling.samplers import Samples

LOG = logging.getLogger(__name__)


def assign_partitions(partitions: list, num_fetchers: int) -> list[list]:
    """DefaultMetricSamplerPartitionAssignor: round-robin by index, keeping
    each topic's partitions spread across fetchers."""
    groups: list[list] = [[] for _ in range(max(1, num_fetchers))]
    for i, tp in enumerate(sorted(partitions)):
        groups[i % len(groups)].append(tp)
    return groups


class DefaultPartitionAssignor:
    """MetricSamplerPartitionAssignor SPI (MonitorConfig
    ``metric.sampler.partition.assignor.class``): splits the partition
    universe into per-fetcher groups. Custom assignors subclass and override
    :meth:`assign` (e.g. locality-aware grouping)."""

    def configure(self, config) -> None:
        pass

    def assign(self, partitions: list, num_fetchers: int) -> list[list]:
        return assign_partitions(partitions, num_fetchers)


class MetricFetcherManager:
    """Runs one sampling round across N concurrent fetchers and merges the
    results (MetricFetcherManager.fetchMetricSamples :148 role)."""

    def __init__(self, sampler, num_fetchers: int = 1, assignor=None):
        self._sampler = sampler
        self._assignor = assignor or DefaultPartitionAssignor()
        self._num_fetchers = max(1, num_fetchers)
        self._pool = (ThreadPoolExecutor(max_workers=self._num_fetchers,
                                         thread_name_prefix="metric-fetcher")
                      if self._num_fetchers > 1 else None)

    def fetch_once(self, now_ms: float, partitions: list) -> Samples:
        # samplers that cannot scope a fetch to a partition subset (each call
        # would sweep the whole metric source, multiplying load by N) opt out
        # of fan-out and run one full fetch instead
        if self._pool is None or not getattr(
                self._sampler, "supports_partition_scoped_fetch", True):
            return self._sampler.get_samples(now_ms)
        groups = [g for g in self._assignor.assign(partitions,
                                                   self._num_fetchers) if g]
        if not groups:
            return self._sampler.get_samples(now_ms, partitions=[])
        # broker metrics are fetched by the FIRST fetcher only — the others
        # are partition-scoped, so broker queries aren't repeated N times
        futures = [self._pool.submit(self._sampler.get_samples, now_ms,
                                     partitions=g,
                                     include_broker_samples=(i == 0))
                   for i, g in enumerate(groups)]
        merged = Samples([], [])
        broker_seen = set()
        failures = 0
        for f in futures:
            try:
                s = f.result()
            except Exception as e:  # noqa: BLE001 — per-fetcher isolation
                # one failing fetcher must not discard the other fetchers'
                # samples (reference SamplingFetcher catches per-task errors
                # and proceeds with partial samples)
                failures += 1
                LOG.warning("metric fetcher failed; continuing with partial "
                            "samples: %s", e)
                continue
            merged.partition_samples.extend(s.partition_samples)
            merged.partition_blocks.extend(s.partition_blocks)
            for bs in s.broker_samples:
                key = (bs.broker_id, bs.ts_ms)
                if key not in broker_seen:
                    broker_seen.add(key)
                    merged.broker_samples.append(bs)
        if failures == len(futures):
            raise RuntimeError("all metric fetchers failed this round")
        return merged

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
