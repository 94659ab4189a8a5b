"""(Counterpart of ``cruise_control_tpu/backend/simulated.py``, copied with the
port's imports.) Simulated cluster backend.

Fills the role of the reference's embedded test cluster
(CCKafkaIntegrationTestHarness + CCEmbeddedBroker/CCEmbeddedZookeeper,
cruise-control-metrics-reporter/src/test/.../utils/CCEmbeddedBroker.java:21)
AND of a dev/demo target: a fully in-process cluster with brokers, partitions,
replica placement, leadership, metric emission with configurable noise, and
time-based replica-movement execution with throttling.

Reassignments do not complete instantly: each added replica must "copy"
``size_mb`` at the (throttled) replication rate; ``advance(dt)`` moves
simulated time forward. This is what makes executor tests meaningful
(progress polling, concurrency caps, throttle behavior) without a JVM.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from cruise_control_tpu_torch.backend.interface import (
    BrokerNode, ClusterSnapshot, PartitionInfo,
)


@dataclasses.dataclass
class _InFlight:
    tp: tuple
    adding: list                    # broker ids still copying
    target: list                    # final replica list
    copied_mb: dict = dataclasses.field(default_factory=dict)


DEFAULT_REPLICATION_RATE_KBPS = 100_000.0   # unthrottled copy rate per replica


class SimulatedClusterBackend:
    """In-process cluster. All public methods are thread-safe."""

    def __init__(self, metric_noise: float = 0.0, seed: int = 0):
        self._lock = threading.RLock()
        self._brokers: dict[int, BrokerNode] = {}
        self._partitions: dict[tuple, PartitionInfo] = {}
        self._inflight: dict[tuple, _InFlight] = {}
        self._throttle: int | None = None
        self._meta_gen = 0
        self._now_ms = 0.0
        self._noise = metric_noise
        self._rng = np.random.default_rng(seed)
        self._metric_overrides: dict[int, dict[str, float]] = {}
        self._silenced: set[int] = set()    # brokers with a metric gap
        self._leadership_latency_ms = 0.0   # slow-election fault injection
        # (at_ms, seq, callback) fault events fired at their exact simulated
        # time from advance() — the scenario engine's injection mechanism
        self._scheduled: list[tuple] = []
        self._sched_seq = 0
        self._topic_configs: dict[str, dict] = {}
        # coordination leases (ZK-ephemeral-node role): key -> {holder,
        # expiresMs, epoch}; expiry is judged on the SIMULATED clock, so
        # election/renewal/failover in sim campaigns is bit-reproducible
        self._leases: dict[str, dict] = {}
        self._partitions_snapshot: tuple | None = None   # (meta_gen, dict)
        # --- incremental columnar state (ClusterSnapshot source) ---
        # one row per partition in CREATION order; every partition mutator
        # patches only the touched rows (O(changes)), and ``snapshot()``
        # assembles the sorted CSR view with a few vectorized gathers, cached
        # per metadata generation. ``_c_stride`` is the replica-slot capacity
        # per row (grown when a partition's RF exceeds it).
        self._c_dix: dict[int, dict] = {}       # broker -> {logdir: index}
        self._c_rows: dict[tuple, int] = {}     # tp -> row
        self._c_tps: list[tuple] = []           # row -> tp
        self._c_topic: list[str] = []           # row -> topic name
        self._c_stride = 4
        self._c_nrep = np.zeros(0, np.int64)
        self._c_leader = np.zeros(0, np.int64)
        self._c_rep_bid = np.zeros((0, self._c_stride), np.int64)
        self._c_rep_disk = np.zeros((0, self._c_stride), np.int64)
        self._c_metrics = np.zeros((0, 4), np.float64)  # cpu, size, b_in, b_out
        self._c_order: np.ndarray | None = None  # sorted-row permutation cache
        self._col_snapshot: tuple | None = None  # (meta_gen, ClusterSnapshot)

    def configure(self, config, **extra):
        pass

    # ------------------------------------------- columnar state maintenance
    def _c_logdir_index(self, broker: int, logdir) -> int:
        """Logdir name -> index in the broker's logdir order (0 = unknown,
        the same fallback the dict-consuming model build applies)."""
        lut = self._c_dix.get(broker)
        if lut is None:
            lut = self._c_dix[broker] = {
                ld: d for d, ld in enumerate(self._brokers[broker].logdirs)}
        return lut.get(logdir, 0)

    def _c_update(self, tp: tuple) -> None:
        """Write one partition's columnar row from its PartitionInfo
        (O(RF); called by every mutator that touches the partition)."""
        info = self._partitions[tp]
        row = self._c_rows.get(tp)
        if row is None:
            row = len(self._c_tps)
            self._c_rows[tp] = row
            self._c_tps.append(tp)
            self._c_topic.append(tp[0])
            self._c_order = None            # sorted view must be rebuilt
            if row >= self._c_nrep.shape[0]:
                grow = max(64, self._c_nrep.shape[0])
                S = self._c_stride
                self._c_nrep = np.concatenate(
                    [self._c_nrep, np.zeros(grow, np.int64)])
                self._c_leader = np.concatenate(
                    [self._c_leader, np.full(grow, -1, np.int64)])
                self._c_rep_bid = np.concatenate(
                    [self._c_rep_bid, np.full((grow, S), -1, np.int64)])
                self._c_rep_disk = np.concatenate(
                    [self._c_rep_disk, np.zeros((grow, S), np.int64)])
                self._c_metrics = np.concatenate(
                    [self._c_metrics, np.zeros((grow, 4), np.float64)])
        n = len(info.replicas)
        if n > self._c_stride:
            S = max(n, self._c_stride * 2)
            pad = ((0, 0), (0, S - self._c_stride))
            self._c_rep_bid = np.pad(self._c_rep_bid, pad, constant_values=-1)
            self._c_rep_disk = np.pad(self._c_rep_disk, pad)
            self._c_stride = S
        self._c_nrep[row] = n
        self._c_leader[row] = info.leader
        self._c_rep_bid[row, :n] = info.replicas
        self._c_rep_bid[row, n:] = -1
        ld_of = info.logdir_by_broker
        self._c_rep_disk[row, :n] = [
            self._c_logdir_index(b, ld_of.get(b)) for b in info.replicas]
        self._c_rep_disk[row, n:] = 0
        self._c_metrics[row] = (info.cpu_util, info.size_mb,
                                info.bytes_in_rate, info.bytes_out_rate)

    def snapshot(self) -> ClusterSnapshot:
        """Columnar metadata snapshot (cached per metadata generation).
        Row maintenance is O(changes) in the mutators; assembly here is a
        handful of vectorized gathers over the row store."""
        with self._lock:
            cached = self._col_snapshot
            if cached is not None and cached[0] == self._meta_gen:
                return cached[1]
            n = len(self._c_tps)
            if self._c_order is None:
                self._c_order = np.fromiter(
                    (self._c_rows[tp] for tp in sorted(self._c_rows)),
                    dtype=np.int64, count=n)
            order = self._c_order
            nrep = self._c_nrep[order]
            rep_ptr = np.zeros(n + 1, np.int64)
            np.cumsum(nrep, out=rep_ptr[1:])
            mask = np.arange(self._c_stride)[None, :] < nrep[:, None]
            bid_rows = self._c_rep_bid[order]
            leader = self._c_leader[order]
            topics = sorted(set(self._c_topic))
            tindex = {t: i for i, t in enumerate(topics)}
            topic_rows = [self._c_topic[r] for r in order] if n else []
            broker_ids = np.asarray(sorted(self._brokers), np.int64)
            snap = ClusterSnapshot(
                generation=self._meta_gen,
                topics=topics,
                partition_keys=[self._c_tps[r] for r in order],
                partition_topic=np.fromiter((tindex[t] for t in topic_rows),
                                            dtype=np.int64, count=n),
                partition_leader=leader,
                rep_ptr=rep_ptr,
                rep_bid=bid_rows[mask],
                rep_leader=(bid_rows == leader[:, None])[mask],
                rep_disk=self._c_rep_disk[order][mask],
                broker_ids=broker_ids,
                broker_alive=np.asarray(
                    [self._brokers[b].alive for b in broker_ids], bool),
                broker_rack=[self._brokers[b].rack for b in broker_ids],
                broker_logdirs=[list(self._brokers[b].logdirs) or ["/logdir0"]
                                for b in broker_ids])
            self._col_snapshot = (self._meta_gen, snap)
            return snap

    # -- per-topic config (TopicConfigProvider source; the real cluster's
    #    describeConfigs analogue) --
    def set_topic_config(self, topic: str, key: str, value) -> None:
        """``value=None`` deletes the entry (the alterConfigs DELETE op the
        throttle-helper cleanup uses, ReplicationThrottleHelper.java:200)."""
        with self._lock:
            if value is None:
                cfgs = self._topic_configs.get(topic)
                if cfgs is not None:
                    cfgs.pop(key, None)
                    if not cfgs:
                        del self._topic_configs[topic]
            else:
                self._topic_configs.setdefault(topic, {})[key] = value

    def topic_configs(self) -> dict:
        with self._lock:
            return {t: dict(c) for t, c in self._topic_configs.items()}

    # ------------------------------------------------------------------ setup
    def add_broker(self, broker_id: int, rack: str, logdirs: dict | None = None,
                   cpu_capacity: float = 100.0, nw_in_capacity: float = 50_000.0,
                   nw_out_capacity: float = 50_000.0) -> "SimulatedClusterBackend":
        with self._lock:
            self._brokers[broker_id] = BrokerNode(
                broker_id=broker_id, rack=rack,
                logdirs=dict(logdirs or {"/logdir0": 500_000.0}),
                cpu_capacity=cpu_capacity, nw_in_capacity=nw_in_capacity,
                nw_out_capacity=nw_out_capacity)
            self._c_dix.pop(broker_id, None)   # logdir order may have changed
            self._meta_gen += 1
        return self

    def create_partition(self, topic: str, partition: int, replicas: list,
                         size_mb: float = 0.0, bytes_in_rate: float = 0.0,
                         bytes_out_rate: float = 0.0, cpu_util: float = 0.0,
                         logdir_by_broker: dict | None = None) -> "SimulatedClusterBackend":
        with self._lock:
            for b in replicas:
                if b not in self._brokers:
                    raise ValueError(f"unknown broker {b}")
            logdirs = dict(logdir_by_broker or {})
            for b in replicas:
                logdirs.setdefault(b, next(iter(self._brokers[b].logdirs)))
            self._partitions[(topic, partition)] = PartitionInfo(
                topic=topic, partition=partition, replicas=list(replicas),
                leader=replicas[0], logdir_by_broker=logdirs, size_mb=size_mb,
                bytes_in_rate=bytes_in_rate, bytes_out_rate=bytes_out_rate,
                cpu_util=cpu_util)
            self._c_update((topic, partition))
            self._meta_gen += 1
        return self

    # ------------------------------------------------------- fault injection
    def kill_broker(self, broker_id: int) -> None:
        with self._lock:
            self._brokers[broker_id].alive = False
            for tp, info in self._partitions.items():
                if info.leader == broker_id:
                    survivors = [b for b in info.replicas
                                 if self._brokers[b].alive]
                    info.leader = survivors[0] if survivors else -1
                    self._c_update(tp)
            self._meta_gen += 1

    def restart_broker(self, broker_id: int) -> None:
        with self._lock:
            self._brokers[broker_id].alive = True
            self._meta_gen += 1

    def fail_disk(self, broker_id: int, logdir: str) -> None:
        with self._lock:
            self._brokers[broker_id].dead_logdirs.add(logdir)
            self._meta_gen += 1

    def shrink_replicas(self, topic: str, target_rf: int) -> int:
        """Fault injection: drop tail replicas of every partition of
        ``topic`` down to ``target_rf`` (the under-replicated-topic anomaly a
        TopicReplicationFactorAnomalyFinder must detect and repair). The
        leader survives when it can; partitions with an in-flight
        reassignment are skipped (their replica list is owned by the copy
        machinery). Returns the number of partitions shrunk."""
        with self._lock:
            changed = 0
            for tp, info in self._partitions.items():
                if (tp[0] != topic or tp in self._inflight
                        or len(info.replicas) <= target_rf):
                    continue
                keep = list(info.replicas)
                if info.leader in keep:
                    keep = [info.leader] + [b for b in keep if b != info.leader]
                dropped = keep[max(target_rf, 1):]
                info.replicas = keep[:max(target_rf, 1)]
                for b in dropped:
                    info.logdir_by_broker.pop(b, None)
                if info.leader not in info.replicas:
                    alive = [b for b in info.replicas
                             if self._brokers[b].alive]
                    info.leader = alive[0] if alive else -1
                self._c_update(tp)
                changed += 1
            if changed:
                self._meta_gen += 1
            return changed

    def scale_partition_load(self, factor: float, topics=None) -> None:
        """Fault injection: multiply the cpu/bytes-in/bytes-out rates of every
        partition (optionally restricted to ``topics``) — a traffic surge the
        GoalViolationDetector's provision math must flag UNDER_PROVISIONED.
        Disk size is deliberately untouched: a surge is load, not data."""
        with self._lock:
            for tp, info in self._partitions.items():
                if topics is not None and tp[0] not in topics:
                    continue
                info.cpu_util *= factor
                info.bytes_in_rate *= factor
                info.bytes_out_rate *= factor
                self._c_update(tp)
            self._meta_gen += 1

    def scale_rack_load(self, factor: float, rack: str) -> None:
        """Fault injection: multiply the cpu/bytes rates of every partition
        with a replica on ``rack``'s brokers — a correlated failure-domain
        surge (one rack's tenants get hot together). Like
        :meth:`scale_partition_load`, load only; disk size untouched."""
        with self._lock:
            rack_brokers = {b for b, info in self._brokers.items()
                            if info.rack == rack}
            for tp, info in self._partitions.items():
                if rack_brokers.isdisjoint(info.replicas):
                    continue
                info.cpu_util *= factor
                info.bytes_in_rate *= factor
                info.bytes_out_rate *= factor
                self._c_update(tp)
            self._meta_gen += 1

    def decommission_broker(self, broker_id: int) -> None:
        """Remove an EMPTY broker from the cluster (the provisioner's
        OVER_PROVISIONED actuation; the reference delegates this to a cloud
        autoscaler behind the Provisioner SPI). Refuses while the broker
        still hosts replicas or is a reassignment target — drain first."""
        with self._lock:
            hosting = sum(1 for info in self._partitions.values()
                          if broker_id in info.replicas)
            if hosting:
                raise RuntimeError(
                    f"broker {broker_id} still hosts {hosting} replicas")
            for tp, fl in self._inflight.items():
                if broker_id in fl.target or broker_id in fl.adding:
                    raise RuntimeError(
                        f"broker {broker_id} is a reassignment target for {tp}")
            del self._brokers[broker_id]
            self._c_dix.pop(broker_id, None)
            self._metric_overrides.pop(broker_id, None)
            self._silenced.discard(broker_id)
            self._meta_gen += 1

    def set_metric_silence(self, broker_id: int, silent: bool) -> None:
        """Fault injection: a silenced broker stops emitting broker metrics
        and leader partition metrics (a reporting gap, NOT a failure — the
        broker stays alive in metadata)."""
        with self._lock:
            if silent:
                self._silenced.add(broker_id)
            else:
                self._silenced.discard(broker_id)

    # ---------------------------------------------------------------- leases
    def lease_acquire(self, key: str, holder: str, ttl_ms: float) -> dict:
        """Atomic compare-and-swap lease (ClusterBackend protocol): grant
        when the key is free, the current lease has expired on the backend
        clock, or ``holder`` already owns it (renewal — including
        re-asserting its own EXPIRED lease after e.g. a long blocking heal).
        The epoch is a fencing token: it increments only when OWNERSHIP
        changes, never on a same-holder renewal or re-assert."""
        with self._lock:
            now = self._now_ms
            cur = self._leases.get(key)
            if cur is not None and cur["holder"] != holder \
                    and cur["expiresMs"] > now:
                out = dict(cur, key=key, acquired=False)
                return out
            epoch = (cur["epoch"] if cur is not None
                     and cur["holder"] == holder
                     else (cur["epoch"] + 1 if cur is not None else 1))
            self._leases[key] = {"holder": holder,
                                 "expiresMs": now + float(ttl_ms),
                                 "epoch": epoch}
            return dict(self._leases[key], key=key, acquired=True)

    def lease_release(self, key: str, holder: str) -> bool:
        """Voluntary release; a no-op unless ``holder`` owns the lease."""
        with self._lock:
            cur = self._leases.get(key)
            if cur is None or cur["holder"] != holder:
                return False
            del self._leases[key]
            return True

    def lease_get(self, key: str) -> dict | None:
        with self._lock:
            cur = self._leases.get(key)
            if cur is None:
                return None
            return dict(cur, key=key,
                        expired=cur["expiresMs"] <= self._now_ms)

    # ---------------------------------------------------------------- clock
    def now_ms(self) -> float:
        """Canonical ClusterBackend clock accessor (method, like the RPC
        client and every other backend — see ClusterBackend protocol)."""
        return self._now_ms

    def schedule_at(self, at_ms: float, callback) -> None:
        """Register ``callback(now_ms)`` to fire when simulated time reaches
        ``at_ms`` — from whichever ``advance`` call crosses it, including the
        executor's own progress-poll sleeps. This is what lets the scenario
        engine inject a broker death in the middle of a blocking proposal
        execution at an exact, reproducible simulated time."""
        with self._lock:
            self._scheduled.append((float(at_ms), self._sched_seq, callback))
            self._sched_seq += 1

    def advance(self, dt_ms: float) -> None:
        """Advance simulated time, stopping at every scheduled fault event so
        callbacks observe (and mutate) the cluster at their exact time."""
        remaining = float(dt_ms)
        while True:
            # fire everything due at the CURRENT time first (an event
            # scheduled at exactly now must not slip a whole step)
            with self._lock:
                now = self._now_ms
                due = sorted(e for e in self._scheduled if e[0] <= now)
                self._scheduled = [e for e in self._scheduled if e[0] > now]
            for _, _, cb in due:
                cb(now)
            if remaining <= 0:
                return
            with self._lock:
                pending = [t for t, _, _ in self._scheduled if t > now]
                next_due = min(pending) if pending else None
            step = remaining
            if next_due is not None and next_due < now + remaining:
                step = max(next_due - now, 0.0)
            self._advance_step(step)
            remaining -= step

    def _advance_step(self, dt_ms: float) -> None:
        """Progress in-flight reassignments over an event-free interval."""
        with self._lock:
            self._now_ms += dt_ms
            rate_kbps = (self._throttle / 1024.0 if self._throttle
                         else DEFAULT_REPLICATION_RATE_KBPS)
            done_tps = []
            for tp, fl in self._inflight.items():
                info = self._partitions[tp]
                mb = rate_kbps * (dt_ms / 1000.0) / 1024.0
                still = []
                touched = False
                for b in fl.adding:
                    fl.copied_mb[b] = fl.copied_mb.get(b, 0.0) + mb
                    if fl.copied_mb[b] >= info.size_mb:
                        # replica caught up: joins the replica list
                        if b not in info.replicas:
                            info.replicas.append(b)
                            info.logdir_by_broker.setdefault(
                                b, next(iter(self._brokers[b].logdirs)))
                            touched = True
                    else:
                        still.append(b)
                fl.adding = still
                if not still:
                    # drop replicas not in the target list
                    removed = [b for b in info.replicas if b not in fl.target]
                    info.replicas = [b for b in fl.target]
                    for b in removed:
                        info.logdir_by_broker.pop(b, None)
                    if (info.leader not in info.replicas
                            or not self._brokers[info.leader].alive):
                        # a broker may die mid-reassignment: leadership must
                        # land on an ALIVE member of the new replica list
                        # (ISR election role), never a dead target
                        alive = [b for b in info.replicas
                                 if self._brokers[b].alive]
                        info.leader = alive[0] if alive else -1
                    done_tps.append(tp)
                    touched = True
                if touched:
                    self._c_update(tp)
            for tp in done_tps:
                del self._inflight[tp]
            if done_tps:
                self._meta_gen += 1

    # -------------------------------------------------------------- metadata
    def brokers(self) -> dict:
        with self._lock:
            return {b: dataclasses.replace(n, logdirs=dict(n.logdirs),
                                           dead_logdirs=set(n.dead_logdirs))
                    for b, n in self._brokers.items()}

    def partitions(self) -> dict:
        """Metadata snapshot, cached per metadata generation (every mutator
        bumps ``_meta_gen``): the deep copy costs ~10 us per partition, and
        the monitor/executor/detector layers read this several times per
        round at up to 500k partitions. Callers must treat the returned
        snapshot as immutable."""
        with self._lock:
            cached = self._partitions_snapshot
            if cached is not None and cached[0] == self._meta_gen:
                return cached[1]
            snap = {tp: dataclasses.replace(
                        info, replicas=list(info.replicas),
                        logdir_by_broker=dict(info.logdir_by_broker))
                    for tp, info in self._partitions.items()}
            self._partitions_snapshot = (self._meta_gen, snap)
            return snap

    def metadata_generation(self) -> int:
        with self._lock:
            return self._meta_gen

    # --------------------------------------------------------------- metrics
    def _jitter(self, v: float) -> float:
        if self._noise <= 0 or v == 0:
            return v
        return float(v * (1.0 + self._rng.normal(0, self._noise)))

    def partition_metrics(self) -> dict:
        """Model-metric rows per partition (CruiseControlMetricsProcessor
        output shape: CPU_USAGE / DISK_USAGE / LEADER_BYTES_IN / LEADER_BYTES_OUT)."""
        with self._lock:
            out = {}
            for tp, info in self._partitions.items():
                if (info.leader < 0 or not self._brokers[info.leader].alive
                        or info.leader in self._silenced):
                    continue
                out[tp] = {
                    "CPU_USAGE": self._jitter(info.cpu_util),
                    "DISK_USAGE": self._jitter(info.size_mb),
                    "LEADER_BYTES_IN": self._jitter(info.bytes_in_rate),
                    "LEADER_BYTES_OUT": self._jitter(info.bytes_out_rate),
                }
            return out

    PARTITION_METRIC_COLUMNS = ("CPU_USAGE", "DISK_USAGE",
                                "LEADER_BYTES_IN", "LEADER_BYTES_OUT")

    def partition_metrics_columnar(self):
        """(entities, metric_names, values[N, 4]) — the columnar twin of
        ``partition_metrics()``: one vectorized pass over the row store
        instead of 500k small dicts + 2M jitter calls per sampling round.
        Rows cover partitions with an alive leader, like the dict path."""
        with self._lock:
            n = len(self._c_tps)
            leader = self._c_leader[:n]
            alive_ids = np.asarray(
                sorted(b for b, node in self._brokers.items()
                       if node.alive and b not in self._silenced),
                np.int64)
            mask = (leader >= 0) & np.isin(leader, alive_ids)
            rows = np.flatnonzero(mask)
            values = self._c_metrics[rows].copy()
            if self._noise > 0 and values.size:
                jitter = 1.0 + self._rng.normal(0, self._noise, values.shape)
                values = np.where(values != 0, values * jitter, values)
            entities = [self._c_tps[r] for r in rows]
            return entities, list(self.PARTITION_METRIC_COLUMNS), values

    def broker_metrics(self) -> dict:
        with self._lock:
            # vectorized accumulate-by-leader over the columnar row store
            # (the former per-partition Python loop was ~seconds per
            # sampling round at 500k partitions)
            n = len(self._c_tps)
            leader = self._c_leader[:n]
            ids = np.asarray(sorted(self._brokers), np.int64)
            sums = np.zeros((ids.size, 3))          # cpu, b_in, b_out
            mask = leader >= 0
            if mask.any():
                pos = np.searchsorted(ids, leader[mask])
                np.add.at(sums, pos,
                          self._c_metrics[:n][mask][:, [0, 2, 3]])
            out = {}
            for bi, b in enumerate(ids.tolist()):
                node = self._brokers[b]
                if not node.alive or b in self._silenced:
                    continue
                cpu, lin, lout = sums[bi]
                out[b] = {
                    "BROKER_CPU_UTIL": self._jitter(cpu),
                    "ALL_TOPIC_BYTES_IN": self._jitter(lin),
                    "ALL_TOPIC_BYTES_OUT": self._jitter(lout),
                    "BROKER_LOG_FLUSH_TIME_MS_MEAN": self._jitter(1.0),
                    "BROKER_LOG_FLUSH_TIME_MS_999TH": self._jitter(5.0),
                }
                out[b].update(self._metric_overrides.get(b, {}))
            return out

    def override_broker_metric(self, broker_id: int, metric: str,
                               value: float | None) -> None:
        """Fault injection: pin a broker metric (None clears the override) —
        drives slow-broker / concurrency-adjuster scenarios in tests."""
        with self._lock:
            if value is None:
                self._metric_overrides.get(broker_id, {}).pop(metric, None)
            else:
                self._metric_overrides.setdefault(broker_id, {})[metric] = value

    # -------------------------------------------------------------- actuation
    def alter_partition_reassignments(self, assignments: dict) -> None:
        """Start reassignments: {(topic, part): [target broker ids]}
        (the ZK reassignment-znode write, Executor.java:1272)."""
        with self._lock:
            for tp, target in assignments.items():
                info = self._partitions[tp]
                for b in target:
                    if b not in self._brokers:
                        raise ValueError(f"unknown broker {b} for {tp}")
                adding = [b for b in target if b not in info.replicas]
                if tp in self._inflight:
                    raise RuntimeError(f"reassignment already in flight for {tp}")
                self._inflight[tp] = _InFlight(tp=tp, adding=adding,
                                               target=list(target))
                if not adding:
                    # pure shrink/reorder completes on next advance
                    pass
            self._meta_gen += 1

    def apply_assignment(self, proposals) -> int:
        """Instantly complete an execution-proposal set: the cluster jumps
        to the proposals' target placement (replica sets, leadership,
        logdirs) as if every reassignment had finished — the bench/test
        convergence helper for measuring steady-state rounds against a
        cluster that actually REACHED the optimizer's target, without
        simulating hours of copy throttling. Partitions with an in-flight
        reassignment are skipped (their replica list is owned by the copy
        machinery). Returns the number of partitions touched."""
        with self._lock:
            n = 0
            for p in proposals:
                tp = (p.topic, p.partition)
                info = self._partitions.get(tp)
                if info is None or tp in self._inflight:
                    continue
                new_b = [b for b, _ in p.new_replicas]
                if any(b not in self._brokers for b in new_b):
                    raise ValueError(f"unknown broker in target for {tp}")
                removed = [b for b in info.replicas if b not in new_b]
                info.replicas = new_b
                for b, ld in p.new_replicas:
                    lds = list(self._brokers[b].logdirs)
                    info.logdir_by_broker[b] = (
                        lds[ld] if 0 <= ld < len(lds) else lds[0])
                for b in removed:
                    info.logdir_by_broker.pop(b, None)
                leader = p.new_leader
                if (leader not in info.replicas
                        or not self._brokers[leader].alive):
                    alive = [b for b in info.replicas
                             if self._brokers[b].alive]
                    leader = alive[0] if alive else -1
                info.leader = leader
                self._c_update(tp)
                n += 1
            if n:
                self._meta_gen += 1
            return n

    def ongoing_reassignments(self) -> dict:
        with self._lock:
            return {tp: {"adding": list(fl.adding), "target": list(fl.target)}
                    for tp, fl in self._inflight.items()}

    def cancel_reassignments(self, tps: list) -> None:
        """Force-stop: delete the 'znode' (ExecutionUtils.java:305-307)."""
        with self._lock:
            for tp in tps:
                fl = self._inflight.pop(tp, None)
                if fl is None:
                    continue
                info = self._partitions[tp]
                # adding replicas that finished stay; unfinished are dropped
                info.replicas = [b for b in info.replicas]
            self._meta_gen += 1

    def set_leadership_latency_ms(self, ms: float) -> None:
        """Fault injection: preferred-leader elections stop landing
        instantly — each submitted election takes effect ``ms`` simulated ms
        later (from whichever ``advance`` crosses it). Lets the executor's
        ``leader.movement.timeout.ms`` abandonment path and the campaign's
        slow-progress scenarios run against real (simulated) slowness."""
        with self._lock:
            self._leadership_latency_ms = max(float(ms), 0.0)

    def elect_leaders(self, tps_to_leader: dict) -> None:
        with self._lock:
            for tp, leader in tps_to_leader.items():
                info = self._partitions[tp]
                if leader not in info.replicas:
                    raise ValueError(f"{leader} not a replica of {tp}")
                if not self._brokers[leader].alive:
                    raise ValueError(f"broker {leader} is dead")
            latency = self._leadership_latency_ms
            if latency <= 0:
                for tp, leader in tps_to_leader.items():
                    self._partitions[tp].leader = leader
                    self._c_update(tp)
                self._meta_gen += 1
                return
            # slow-election mode: validation happened above (submission
            # succeeds), but the flip lands later; by then the cluster may
            # have changed, so the apply re-validates and silently drops a
            # now-ineligible election (a lost election, like the real thing)
            for tp, leader in tps_to_leader.items():
                def _apply(now, tp=tp, leader=leader):
                    with self._lock:
                        info = self._partitions.get(tp)
                        if (info is None or leader not in info.replicas
                                or not self._brokers[leader].alive):
                            return
                        info.leader = leader
                        self._c_update(tp)
                        self._meta_gen += 1
                self.schedule_at(self._now_ms + latency, _apply)

    def alter_replica_logdirs(self, moves: dict) -> None:
        """Intra-broker move: {(topic, part, broker): logdir}
        (AdminClient.alterReplicaLogDirs, ExecutorAdminUtils.java:70-88)."""
        with self._lock:
            for (topic, part, broker), logdir in moves.items():
                info = self._partitions[(topic, part)]
                if broker not in info.replicas:
                    raise ValueError(f"{broker} not a replica of {(topic, part)}")
                if logdir not in self._brokers[broker].logdirs:
                    raise ValueError(f"unknown logdir {logdir} on broker {broker}")
                info.logdir_by_broker[broker] = logdir
                self._c_update((topic, part))
            self._meta_gen += 1

    def describe_logdirs(self) -> dict:
        with self._lock:
            return {b: {ld: (ld not in n.dead_logdirs) and n.alive
                        for ld in n.logdirs}
                    for b, n in self._brokers.items()}

    def set_replication_throttle(self, rate_bytes_per_sec: int | None) -> None:
        with self._lock:
            self._throttle = rate_bytes_per_sec

    def replication_throttle(self) -> int | None:
        with self._lock:
            return self._throttle
