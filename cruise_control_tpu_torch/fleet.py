"""Fleet mode: batched multi-tenant optimization, N clusters on one device
(counterpart of ``cruise_control_tpu/fleet.py``).

- :class:`FleetTenant`: one tenant cluster, its own ``CruiseControl`` app
  (backend, monitor, executor, detectors) and the app's resident session;
  a tenant is DUE when its session's ``sync_generation`` advanced past the
  last optimized one.
- :class:`FleetScheduler`: the request-admission engine. Optimization
  requests (tenant syncs going due, detector FIX/PREDICTED verdicts, user
  rebalances) enter per-tenant queues with priority lanes (heal <
  rebalance < refresh); each dispatch groups the queued tenants by shape
  bucket, admits up to ``fleet.admission.max.batch`` of the hottest bucket
  in (lane, seq) order and runs ONE batched launch
  (``GoalOptimizer.optimizations_batched``: the lane stack, with the move
  wave's kernels launched once per wave for every running tenant); NEAR
  buckets under queue pressure pad-to-join (session ``bucket_floors``).
  Results install through the tenant pipeline's execute stage
  (``submit_install``) when a threaded one runs, else inline, parked lanes
  as they land. A device-memory budget LRU-spills cold tenants' resident state
  to host mirrors (``ResidentClusterSession.spill``); a touched tenant
  re-admits bit-identically. ``fleet.admission.enabled`` off runs the static
  round sweep instead.

Per-tenant verdicts, certificates and proposals of a batched launch are
bit-identical to solo runs. ``FleetScheduler(config, optimizer=None,
sensors=None, device="cuda")`` builds each tenant's app on ``device``.
"""
from __future__ import annotations

import dataclasses
import logging
import re
import threading
import time
from collections import deque

from cruise_control_tpu_torch.pipeline import (
    LANE_HEAL, LANE_NAMES, LANE_REBALANCE, LANE_REFRESH,
)

LOG = logging.getLogger(__name__)

# cluster ids ride in URLs and file names: printable, bounded, no separators
CLUSTER_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")


def valid_cluster_id(cluster_id) -> bool:
    return (isinstance(cluster_id, str)
            and CLUSTER_ID_RE.fullmatch(cluster_id) is not None)


class UnknownClusterError(KeyError):
    """A cluster-scoped request named a tenant this fleet does not serve —
    the REST layer maps it to a DECLARED 404 (never a 500, never another
    tenant's data)."""


class FleetTenant:
    """One tenant cluster under the scheduler."""

    def __init__(self, cluster_id: str, cc):
        self.cluster_id = cluster_id
        self.cc = cc
        self.paused = False
        # generation staleness: the session's sync_generation at the
        # last batched optimization this tenant rode
        self.optimized_generation = -1
        self.last_round_seq = 0        # LRU key for the memory-budget spill
        self.last_refresh_ms: float | None = None
        self.refreshes = 0
        self.staleness_ms = deque(maxlen=512)   # cache age sampled per round
        # ragged fleet gating: lifetime per-tenant counters of how
        # this tenant's LANE behaved inside batched launches — the
        # per-tenant half of the launch-level gating stats
        self.passes_dispatched = 0
        self.passes_skipped = 0
        self.early_exit_goals = 0
        self.skipped_goals = 0
        self.parked_rounds = 0         # lane finished before the launch did
        self.compacted_rounds = 0      # lane left the working stack early
        self.early_installs = 0        # results landed before launch unwind
        self.last_install_wall = 0.0   # monotonic stamp of the last landing

    @property
    def session(self):
        return self.cc.resident_session

    def staleness_p95_ms(self) -> float | None:
        if not self.staleness_ms:
            return None
        xs = sorted(self.staleness_ms)
        # nearest-rank p95, the campaign distributions' convention
        return float(xs[max(0, -(-len(xs) * 95 // 100) - 1)])

    def note_gating(self, res) -> None:
        """Accumulate one batched round's per-lane gating counters from
        this tenant's OptimizerResult."""
        self.passes_dispatched += int(getattr(res, "passes_dispatched", 0))
        self.passes_skipped += int(getattr(res, "passes_skipped", 0))
        self.early_exit_goals += int(getattr(res, "early_exit_goals", 0))
        self.skipped_goals += int(getattr(res, "skipped_goals", 0))
        if getattr(res, "parked_early", False):
            self.parked_rounds += 1
        if getattr(res, "compacted_out", False):
            self.compacted_rounds += 1

    def gating_json(self) -> dict:
        return {
            "passesDispatched": self.passes_dispatched,
            "passesSkipped": self.passes_skipped,
            "earlyExitGoals": self.early_exit_goals,
            "skippedGoals": self.skipped_goals,
            "parkedRounds": self.parked_rounds,
            "compactedRounds": self.compacted_rounds,
            "earlyInstalls": self.early_installs,
        }

    def state_json(self) -> dict:
        sess = self.session
        return {
            "clusterId": self.cluster_id,
            "paused": self.paused,
            "optimizedGeneration": self.optimized_generation,
            "syncGeneration": sess.sync_generation if sess else None,
            "spilled": bool(sess is not None and sess.spilled),
            "refreshes": self.refreshes,
            "stalenessP95Ms": self.staleness_p95_ms(),
            "lastRoundSeq": self.last_round_seq,
            "gating": self.gating_json(),
        }


@dataclasses.dataclass
class OptimizationRequest:
    """One queued optimization demand on a fleet tenant.

    ``seq`` is the global enqueue order — admission is deterministic by
    (lane, seq), so identical request streams admit identical launch sets.
    One request is outstanding per (tenant, lane): duplicates coalesce onto
    the queued one (counted). A fresh proposal cache satisfies EVERY queued
    lane of the tenant, so an admitted tenant completes all its requests.
    """
    seq: int
    cluster_id: str
    lane: int
    reason: str = ""
    enqueued_ms: float = 0.0
    # host wall clock at enqueue (time.monotonic, seconds): the sim/round
    # clock above resolves ONCE per launch, so the early-install win (a lane
    # landing mid-launch) is only measurable on this axis
    enqueued_wall: float = 0.0
    retries: int = 0
    coalesced: int = 0

    def state_json(self) -> dict:
        return {"seq": self.seq, "clusterId": self.cluster_id,
                "lane": LANE_NAMES[self.lane], "reason": self.reason,
                "enqueuedMs": self.enqueued_ms, "retries": self.retries,
                "coalesced": self.coalesced}


class FleetScheduler:
    """Multiplex N tenant clusters onto one device: request-admission
    engine (priority lanes, bucket-grouped vmapped launches, pad-to-join
    under pressure), proposal-cache precompute, pause/resume, and a global
    device-memory budget with LRU spill."""

    def __init__(self, config=None, optimizer=None, sensors=None, device="cuda"):
        from cruise_control_tpu_torch.analyzer.env import resolve_device
        from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
        from cruise_control_tpu_torch.common.sensors import MetricRegistry
        from cruise_control_tpu_torch.config.defaults import cruise_control_config
        self.device = resolve_device(device)
        self.config = config or cruise_control_config()
        self.sensors = sensors if sensors is not None else MetricRegistry()
        # ONE optimizer serves every batched launch; its compiled programs
        # are shared with the tenants' own apps anyway (the engine caches
        # are module-level, keyed by goal/bucket, not per optimizer object)
        self.optimizer = optimizer or GoalOptimizer(config=self.config,
                                                    sensors=self.sensors,
                                                    device=self.device)
        self.memory_budget_bytes = self.config.get_int(
            "fleet.device.memory.budget.bytes")
        self.precompute_interval_ms = float(self.config.get_int(
            "fleet.precompute.interval.ms"))
        self._lock = threading.RLock()
        self.tenants: dict[str, FleetTenant] = {}
        self._round_seq = 0
        self.rounds = 0
        self.launches = 0              # batched program launches, lifetime
        self.last_round: dict = {}
        # ---- request-admission engine ----
        self.admission_enabled = self.config.get_boolean(
            "fleet.admission.enabled")
        self.max_batch = max(1, self.config.get_int(
            "fleet.admission.max.batch"))
        self.quantize_batch = self.config.get_boolean(
            "fleet.admission.quantize.batch")
        self.join_pressure = self.config.get_int(
            "fleet.admission.near.join.pressure")
        self.heal_retries = self.config.get_int(
            "fleet.admission.heal.retry.limit")
        self._requests: dict[str, dict[int, OptimizationRequest]] = {}
        self._req_seq = 0
        self.requests_enqueued = 0
        self.requests_coalesced = 0
        self.requests_admitted = 0
        self.requests_requeued = 0
        self.requests_failed = 0
        self.dispatches = 0
        self.joins = 0
        self.splits = 0
        self.last_dispatch: dict = {}
        # heal-admission latency: enqueue -> install, the serving SLO
        self.heal_admission_ms = deque(maxlen=4096)
        self._heal_admission_timer = self.sensors.timer(
            "fleet-heal-admission-timer")
        # ---- ragged fleet gating: early install landing ----
        # results land per lane as they finish; the injected round clock
        # resolves once per launch so the mid-launch win only shows on the
        # host wall axis (time.monotonic) — kept as separate deques
        self.early_install = self.config.get_boolean(
            "fleet.pass.early.install.enabled")
        self.early_installs = 0
        self.heal_admission_wall_ms = deque(maxlen=4096)
        self.install_lag_wall_ms = deque(maxlen=4096)
        self._admit_meter = self.sensors.meter("fleet-requests-admitted")
        self.sensors.gauge("fleet-queue-depth", self.queue_depth)
        # admission trace journal (tools/queue_view.py): in-memory ring by
        # default; ts rides the last injected round/dispatch clock so the
        # event stream is deterministic per (scenario, seed)
        from cruise_control_tpu_torch.common.tracing import EventJournal
        self._clock_ms = 0.0
        self.journal = EventJournal(clock_ms=lambda: self._clock_ms)
        self._work = threading.Event()   # enqueue -> serving-loop wakeup
        self._spill_meter = self.sensors.meter("fleet-spills")
        self._staleness_timer = self.sensors.timer("fleet-staleness-timer")
        self.sensors.gauge("fleet-tenants", lambda: len(self.tenants))
        self.sensors.gauge("fleet-device-bytes", self.device_bytes)
        self.sensors.gauge(
            "fleet-spilled-tenants",
            lambda: sum(1 for t in self.tenants.values()
                        if t.session is not None and t.session.spilled))
        # precompute loop (threaded service mode)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ tenants
    def add_tenant(self, cluster_id: str, backend=None, config=None,
                   cc=None) -> FleetTenant:
        """Register one tenant cluster. Pass a backend (a full
        ``CruiseControl`` app is built over it, resident session on) or a
        pre-built ``cc``. Tenant apps should NOT run their own proposal
        precompute threads — the scheduler's rounds are the precompute."""
        if not valid_cluster_id(cluster_id):
            raise ValueError(f"invalid cluster_id {cluster_id!r} "
                             f"(expected {CLUSTER_ID_RE.pattern})")
        with self._lock:
            if cluster_id in self.tenants:
                raise ValueError(f"cluster_id {cluster_id!r} already "
                                 f"registered")
            if cc is None:
                from cruise_control_tpu_torch.app import CruiseControl
                cc = CruiseControl(backend, config=config or self.config,
                                   device=self.device, cluster_id=cluster_id)
            if cc.resident_session is None:
                raise ValueError(
                    "fleet tenants need a resident session "
                    "(analyzer.resident.session.enabled)")
            tenant = FleetTenant(cluster_id, cc)
            self.tenants[cluster_id] = tenant
            # detector/user request seam: the tenant app's FIX/PREDICTED
            # verdicts and rebalances enqueue on this scheduler's lanes
            cc.fleet_request_sink = (
                lambda lane, reason, now_ms=None, _cid=cluster_id:
                self.enqueue(_cid, lane, reason, now_ms=now_ms))
            return tenant

    def remove_tenant(self, cluster_id: str) -> None:
        with self._lock:
            tenant = self.tenants.pop(cluster_id, None)
            self._requests.pop(cluster_id, None)
        if tenant is not None:
            tenant.cc.shutdown()

    def tenant(self, cluster_id: str) -> FleetTenant:
        t = self.tenants.get(cluster_id)
        if t is None:
            raise UnknownClusterError(cluster_id)
        return t

    def app_for(self, cluster_id: str):
        """The tenant's facade, or None for an unknown id (the REST layer's
        404 signal)."""
        t = self.tenants.get(cluster_id)
        return t.cc if t is not None else None

    @property
    def cluster_ids(self) -> list[str]:
        return list(self.tenants)

    def pause(self, cluster_id: str) -> dict:
        """Per-tenant pause: the tenant stops syncing/optimizing (its REST
        surface keeps serving the cached proposals); a paused tenant is the
        preferred spill victim under memory pressure."""
        t = self.tenant(cluster_id)
        t.paused = True
        return {"clusterId": cluster_id, "paused": True}

    def resume(self, cluster_id: str) -> dict:
        t = self.tenant(cluster_id)
        t.paused = False
        return {"clusterId": cluster_id, "paused": False}

    # ------------------------------------------------------------- buckets
    @staticmethod
    def bucket_key(session) -> tuple | None:
        """The padded shape bucket a synced session occupies — the grouping
        key for stacked launches (same key => stackable pytrees)."""
        env = session.env
        if env is None:
            return None
        return (env.num_replicas, env.num_brokers, env.num_partitions,
                int(env.topic_excluded.shape[0]), env.max_rf,
                int(env.broker_disk_capacity.shape[1]), env.num_racks)

    # ----------------------------------------------------- admission queue
    def _now_for(self, now_ms, tenant=None) -> float:
        """Resolve the operation clock (injected sim/round clock wins) and
        remember it for journal timestamps."""
        if now_ms is not None:
            now = float(now_ms)
        elif tenant is not None:
            now = float(tenant.cc._now_ms())
        else:
            now = time.time() * 1000.0
        self._clock_ms = now
        return now

    def enqueue(self, cluster_id: str, lane: int = LANE_REFRESH,
                reason: str = "", now_ms: float | None = None) -> dict:
        """Queue one optimization request for a tenant. Lanes: heal (0,
        detector FIX/PREDICTED verdicts) preempts rebalance (1, user
        hygiene) preempts refresh (2, background precompute). One request
        is outstanding per (tenant, lane): a duplicate coalesces (counted)
        onto the queued one. Returns the request's state_json."""
        with self._lock:
            t = self.tenant(cluster_id)
            lane = min(max(int(lane), LANE_HEAL), LANE_REFRESH)
            now = self._now_for(now_ms, t)
            per_lane = self._requests.setdefault(cluster_id, {})
            req = per_lane.get(lane)
            if req is not None:
                req.coalesced += 1
                self.requests_coalesced += 1
                self.journal.append("admission", ev="coalesce",
                                    cid=cluster_id, lane=LANE_NAMES[lane],
                                    seq=req.seq)
                return req.state_json()
            self._req_seq += 1
            req = OptimizationRequest(seq=self._req_seq,
                                      cluster_id=cluster_id, lane=lane,
                                      reason=reason, enqueued_ms=now,
                                      enqueued_wall=time.monotonic())
            per_lane[lane] = req
            self.requests_enqueued += 1
            self.journal.append("admission", ev="enqueue", cid=cluster_id,
                                lane=LANE_NAMES[lane], seq=req.seq,
                                reason=reason)
            self._work.set()
            return req.state_json()

    def queue_depth(self) -> int:
        return sum(len(lanes) for lanes in self._requests.values())

    def queue_pressure(self) -> int:
        """Distinct tenants with queued work — the NEAR-bucket join signal."""
        return sum(1 for lanes in self._requests.values() if lanes)

    def _pending(self) -> list[OptimizationRequest]:
        out = [r for lanes in self._requests.values() for r in lanes.values()]
        out.sort(key=lambda r: (r.lane, r.seq))
        return out

    def _fail_tenant_requests(self, cid: str, reason: str,
                              failed: dict) -> None:
        """Per-tenant failure surfacing: heal-lane requests re-enqueue with
        a bounded retry budget (a dropped heal is a stranded anomaly);
        rebalance/refresh requests drop with the reason recorded."""
        lanes = self._requests.get(cid) or {}
        keep: dict[int, OptimizationRequest] = {}
        for lane, r in lanes.items():
            if lane == LANE_HEAL and r.retries < self.heal_retries:
                r.retries += 1
                keep[lane] = r
                self.requests_requeued += 1
                self.journal.append("admission", ev="requeue", cid=cid,
                                    lane="heal", seq=r.seq,
                                    retries=r.retries, reason=reason)
            else:
                self.requests_failed += 1
                self.journal.append("admission", ev="fail", cid=cid,
                                    lane=LANE_NAMES[lane], seq=r.seq,
                                    reason=reason)
        if keep:
            self._requests[cid] = keep
        else:
            self._requests.pop(cid, None)
        failed[cid] = reason

    # ------------------------------------------------------ NEAR buckets
    @staticmethod
    def near_buckets(small: tuple | None, large: tuple | None) -> bool:
        """Pad-to-join candidacy: identical (max_rf, disks, racks) tail —
        padding cannot change those — every padded dim of ``small`` <=
        ``large``, and no dim more than doubles (past 2x the padded compute
        outweighs the saved launch)."""
        if small is None or large is None or small == large:
            return False
        if small[4:] != large[4:]:
            return False
        if not all(x <= y for x, y in zip(small[:4], large[:4])):
            return False
        return all(y <= 2 * max(x, 1) for x, y in zip(small[:4], large[:4]))

    def _join_bucket(self, cands: list, target_key: tuple) -> list:
        """Pad-to-join: rebuild the smaller-bucket tenants with the target
        bucket's dims as pad floors (session.bucket_floors) so they stack
        into the target's launches. Floors are sticky — sustained pressure
        keeps the tenants co-bucketed; the rebuild cost is one-time."""
        moved = []
        for r, t in cands:
            sess = t.session
            try:
                sess.bucket_floors = {
                    "min_replicas": target_key[0],
                    "min_brokers": target_key[1],
                    "min_partitions": target_key[2],
                    "min_topics": target_key[3],
                }
                sess.invalidate()
                sess.sync()
            except Exception:   # noqa: BLE001 — tenant isolation
                LOG.exception("pad-to-join rebuild failed for tenant %s",
                              t.cluster_id)
                sess.bucket_floors = None
                sess.invalidate()
                continue
            if self.bucket_key(sess) == target_key:
                moved.append((r, t))
                self.journal.append("admission", ev="join",
                                    cid=t.cluster_id, bucket=str(target_key))
            else:
                # raw dims outgrew the target mid-join: undo, leave queued
                sess.bucket_floors = None
        return moved

    # ------------------------------------------------------------ dispatch
    def dispatch_once(self, now_ms: float | None = None) -> dict | None:
        """One admission dispatch: sync the queued tenants, pick the bucket
        holding the globally highest-priority request, apply the
        pad-to-join vs split-launch policy against NEAR buckets, admit up
        to ``fleet.admission.max.batch`` tenants in (lane, seq) order, run
        ONE vmapped launch and install/complete their requests. Returns the
        dispatch report, or None when nothing is queued."""
        with self._lock:
            return self._dispatch_locked(now_ms)

    def _dispatch_locked(self, now_ms: float | None) -> dict | None:
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        pending = self._pending()
        if not pending:
            return None
        # one candidate per tenant: its highest-priority queued request
        best: dict[str, OptimizationRequest] = {}
        for r in pending:
            best.setdefault(r.cluster_id, r)
        skipped: dict[str, str] = {}
        failed: dict[str, str] = {}
        ready: list[tuple] = []
        for cid, r in best.items():
            t = self.tenants.get(cid)
            if t is None:                 # tenant removed under its requests
                self._requests.pop(cid, None)
                continue
            if t.paused:
                skipped[cid] = "paused"   # stays queued for resume
                continue
            try:
                t.session.sync()          # memo-hit when the round synced
            except NotEnoughValidWindowsError as e:
                skipped[cid] = f"backpressure: {e}"   # stays queued
                continue
            except Exception as e:   # noqa: BLE001 — tenant isolation
                LOG.exception("fleet sync failed for tenant %s", cid)
                t.session.invalidate()
                skipped[cid] = f"sync failed: {type(e).__name__}"
                self._fail_tenant_requests(
                    cid, f"sync failed: {type(e).__name__}", failed)
                continue
            ready.append((r, t))
        empty = {"bucket": None, "admitted": [], "lanes": {}, "launches": 0,
                 "optimized": [], "skipped": skipped, "failed": failed,
                 "joined": [], "split": False}
        if not ready:
            return empty if (skipped or failed) else None
        groups: dict[tuple, list] = {}
        for r, t in ready:
            key = self.bucket_key(t.session)
            if key is not None:
                groups.setdefault(key, []).append((r, t))
        if not groups:
            return empty

        def head(key):
            r0, _t0 = groups[key][0]
            return (r0.lane, r0.seq)

        target = min(groups, key=head)
        joined: list[str] = []
        split = False
        if len(groups) > 1:
            # NEAR-bucket policy (the fleet residual (b) decision): measured
            # queue pressure decides pad-to-join vs split-launch for the
            # best-headed NEAR neighbour
            for other in sorted((k for k in groups if k != target), key=head):
                pair = ((other, target)
                        if self.near_buckets(other, target)
                        else (target, other))
                small, large = pair
                if not self.near_buckets(small, large):
                    continue
                pressure = len(groups[small]) + len(groups[large])
                if pressure >= self.join_pressure:
                    moved = self._join_bucket(groups[small], large)
                    moved_ids = {t.cluster_id for _r, t in moved}
                    rest = [rt for rt in groups[small]
                            if rt[1].cluster_id not in moved_ids]
                    if rest:
                        groups[small] = rest
                    else:
                        groups.pop(small, None)
                    if moved:
                        groups.setdefault(large, []).extend(moved)
                        groups[large].sort(
                            key=lambda rt: (rt[0].lane, rt[0].seq))
                        target = large
                        joined = sorted(moved_ids)
                        self.joins += 1
                else:
                    split = True
                    self.splits += 1
                    self.journal.append(
                        "admission", ev="split", small=str(small),
                        large=str(large), pressure=pressure,
                        threshold=self.join_pressure)
                break
        if target not in groups:
            return empty
        cands = groups[target]
        k = min(len(cands), self.max_batch)
        if self.quantize_batch and k > 1:
            # power-of-two launch ladder: bounds the compiled K-variants a
            # long-tail arrival mix can create within a bucket
            q = 1
            while q * 2 <= k:
                q *= 2
            k = q
        admitted = cands[:k]
        now = self._now_for(now_ms, admitted[0][1])
        self.dispatches += 1
        lanes_count: dict[str, int] = {}
        for r, _t in admitted:
            name = LANE_NAMES[r.lane]
            lanes_count[name] = lanes_count.get(name, 0) + 1
        self.journal.append(
            "admission", ev="dispatch", bucket=str(target),
            k=len(admitted), cids=[t.cluster_id for _r, t in admitted],
            seqs=[r.seq for r, _t in admitted], lanes=lanes_count)
        sessions = [t.session for _r, t in admitted]
        gens = [t.session.sync_generation for _r, t in admitted]
        report = {"bucket": str(target),
                  "admitted": [t.cluster_id for _r, t in admitted],
                  "lanes": lanes_count, "launches": 0, "optimized": [],
                  "skipped": skipped, "failed": failed, "joined": joined,
                  "split": split}
        landed: set[int] = set()
        launch_wall0 = time.monotonic()

        def land(i: int, res) -> None:
            """Install tenant i's result + complete its queued requests —
            the landing half of a launch. With early install landing on,
            this fires from INSIDE the batched call the moment the lane
            finishes (parked at a goal boundary), so a low-churn tenant's
            proposals install while high-churn lanes are still stepping."""
            if i in landed:
                return
            landed.add(i)
            _r, t = admitted[i]
            self._land_tenant(t, res, gens[i], now,
                              launch_wall0=launch_wall0)
            report["optimized"].append(t.cluster_id)

        try:
            results = self.optimizer.optimizations_batched(
                sessions, on_result=land if self.early_install else None)
        except Exception as e:   # noqa: BLE001 — bucket isolation: surface
            # per-tenant failure and re-enqueue heal-lane requests instead
            # of silently dropping the whole group — tenants whose lanes
            # already LANDED keep their installed results
            LOG.exception("fleet batched launch failed for bucket %s (%s)",
                          target, [t.cluster_id for _r, t in admitted])
            for i, (_r, t) in enumerate(admitted):
                if i in landed:
                    continue
                self._fail_tenant_requests(
                    t.cluster_id, f"launch failed: {type(e).__name__}",
                    failed)
            self.last_dispatch = report
            return report
        self.launches += 1
        report["launches"] = 1
        for i, res in enumerate(results):
            land(i, res)
        self.last_dispatch = report
        return report

    def _land_tenant(self, t: FleetTenant, res, gen: int, now: float,
                     launch_wall0: float | None = None) -> None:
        """Install one tenant's result and complete all its queued requests
        (a fresh proposal cache satisfies every lane), stamping
        heal-admission latency on both clocks: the injected round clock
        (deterministic, resolves once per launch) and the host wall clock
        (the axis where early landing is visible). Requests complete in
        (lane, seq) order. Early landings (result.parked_early) count
        toward the early-install meters."""
        self._install_tenant(t, res, gen, now)
        t.note_gating(res)
        early = bool(getattr(res, "parked_early", False))
        if early:
            self.early_installs += 1
            t.early_installs += 1
        wall_now = time.monotonic()
        t.last_install_wall = wall_now
        if launch_wall0 is not None:
            self.install_lag_wall_ms.append(
                max(wall_now - launch_wall0, 0.0) * 1000.0)
        reqs = sorted((self._requests.pop(t.cluster_id, {}) or {}).values(),
                      key=lambda lr: (lr.lane, lr.seq))
        for lr in reqs:
            self.requests_admitted += 1
            self._admit_meter.mark()
            wait = max(now - lr.enqueued_ms, 0.0)
            if lr.lane == LANE_HEAL:
                self.heal_admission_ms.append(wait)
                self._heal_admission_timer.record(wait / 1000.0)
                if lr.enqueued_wall:
                    self.heal_admission_wall_ms.append(
                        max(wall_now - lr.enqueued_wall, 0.0) * 1000.0)
            extra = {"early": True} if early else {}
            self.journal.append("admission", ev="install",
                                cid=t.cluster_id,
                                lane=LANE_NAMES[lr.lane], seq=lr.seq,
                                waitMs=round(wait, 3), **extra)

    def _install_tenant(self, t: FleetTenant, res, gen: int,
                        now: float) -> None:
        """Install one tenant's batched result. When the tenant runs a
        THREADED pipeline, the install rides its execute stage
        (``submit_install``) so the scheduler's next launch starts while
        results land; lockstep tenants install inline (deterministic)."""
        if t.last_refresh_ms is not None:
            age_ms = max(now - t.last_refresh_ms, 0.0)
            t.staleness_ms.append(age_ms)
            self._staleness_timer.record(age_ms / 1000.0)
        pipe = getattr(t.cc, "service_pipeline", None)
        if pipe is not None and pipe.accepts_fix_routing():
            pipe.submit_install(res, computed_ms=now)
        else:
            t.cc.install_proposal_cache(res, computed_ms=now)
        t.optimized_generation = gen
        t.last_round_seq = self._round_seq
        t.last_refresh_ms = now
        t.refreshes += 1

    # -------------------------------------------------------------- rounds
    def run_round(self, now_ms: float | None = None) -> dict:
        """One fleet optimization round. Admission mode (default): sync
        every unpaused tenant, enqueue a refresh-lane request for each DUE
        one (sync_generation advanced), then dispatch launches until the
        queues drain. At zero queue pressure this is bit-identical to the
        static sweep (one launch per bucket, every due tenant admitted);
        queued heal/rebalance requests ride the same dispatches with
        priority. ``fleet.admission.enabled`` off runs the legacy sweep."""
        if not self.admission_enabled:
            return self._static_round(now_ms)
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        with self._lock:
            self._round_seq += 1
            self.rounds += 1
            skipped: dict[str, str] = {}
            for cid, t in self.tenants.items():
                if t.paused:
                    skipped[cid] = "paused"
                    continue
                try:
                    t.cc.resident_session.sync()
                except NotEnoughValidWindowsError as e:
                    skipped[cid] = f"backpressure: {e}"
                    continue
                except Exception as e:   # noqa: BLE001 — tenant isolation:
                    # one tenant's sync failure must not starve the others
                    LOG.exception("fleet sync failed for tenant %s", cid)
                    t.cc.resident_session.invalidate()
                    skipped[cid] = f"sync failed: {type(e).__name__}"
                    continue
                if t.session.sync_generation > t.optimized_generation:
                    self.enqueue(cid, LANE_REFRESH, reason="due",
                                 now_ms=now_ms)
                elif not self._requests.get(cid):
                    skipped[cid] = "fresh"
            launches = 0
            optimized: list[str] = []
            failed: dict[str, str] = {}
            buckets: dict[str, list[str]] = {}
            admission = {"dispatches": 0, "joined": [], "splits": 0,
                         "lanes": {}}
            # bounded drain: heal retries are finite, so the loop always
            # terminates; the bound is a belt against pathological churn
            for _ in range(4 * (len(self.tenants) + 1)):
                d = self._dispatch_locked(now_ms)
                if d is None:
                    break
                admission["dispatches"] += 1
                launches += d["launches"]
                optimized += d["optimized"]
                failed.update(d["failed"])
                for cid, why in d["skipped"].items():
                    skipped.setdefault(cid, why)
                if d["launches"]:
                    buckets.setdefault(d["bucket"], []).extend(d["admitted"])
                admission["joined"] += d["joined"]
                admission["splits"] += 1 if d["split"] else 0
                for name, c in d["lanes"].items():
                    admission["lanes"][name] = (
                        admission["lanes"].get(name, 0) + c)
                if d["launches"] == 0 and not d["failed"]:
                    break      # only unlaunchable (paused/backpressured) left
            spilled = self.enforce_memory_budget()
            report = {
                "round": self._round_seq,
                "launches": launches,
                "buckets": buckets,
                "optimized": optimized,
                "skipped": skipped,
                "failed": failed,
                "spilled": spilled,
                "deviceBytes": self.device_bytes(),
                "admission": admission,
            }
            self.last_round = report
            return report

    def _static_round(self, now_ms: float | None = None) -> dict:
        """The legacy synchronous sweep (``fleet.admission.enabled`` off):
        sync every unpaused tenant, group the DUE ones by shape bucket, ONE
        batched launch per bucket — the admission engine's zero-pressure
        parity baseline."""
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        with self._lock:
            self._round_seq += 1
            self.rounds += 1
            due: list[FleetTenant] = []
            skipped: dict[str, str] = {}
            failed: dict[str, str] = {}
            for cid, t in self.tenants.items():
                if t.paused:
                    skipped[cid] = "paused"
                    continue
                try:
                    t.cc.resident_session.sync()
                except NotEnoughValidWindowsError as e:
                    skipped[cid] = f"backpressure: {e}"
                    continue
                except Exception as e:   # noqa: BLE001 — tenant isolation:
                    # one tenant's sync failure must not starve the others
                    LOG.exception("fleet sync failed for tenant %s", cid)
                    t.cc.resident_session.invalidate()
                    skipped[cid] = f"sync failed: {type(e).__name__}"
                    continue
                if t.session.sync_generation > t.optimized_generation:
                    due.append(t)
                else:
                    skipped[cid] = "fresh"
            buckets: dict[tuple, list[FleetTenant]] = {}
            for t in due:
                buckets.setdefault(self.bucket_key(t.session), []).append(t)
            launches = 0
            optimized: list[str] = []
            for key, group in buckets.items():
                sessions = [t.session for t in group]
                gens = [t.session.sync_generation for t in group]
                try:
                    results = self.optimizer.optimizations_batched(sessions)
                except Exception as e:   # noqa: BLE001 — bucket isolation
                    LOG.exception(
                        "fleet batched launch failed for bucket %s (%s)",
                        key, [t.cluster_id for t in group])
                    for t in group:
                        skipped[t.cluster_id] = "launch failed"
                        failed[t.cluster_id] = (
                            f"launch failed: {type(e).__name__}")
                    continue
                launches += 1
                for t, res, gen in zip(group, results, gens):
                    now = now_ms if now_ms is not None else t.cc._now_ms()
                    self._install_tenant(t, res, gen, now)
                    t.note_gating(res)
                    optimized.append(t.cluster_id)
            self.launches += launches
            spilled = self.enforce_memory_budget()
            report = {
                "round": self._round_seq,
                "launches": launches,
                "buckets": {str(k): [t.cluster_id for t in g]
                            for k, g in buckets.items()},
                "optimized": optimized,
                "skipped": skipped,
                "failed": failed,
                "spilled": spilled,
                "deviceBytes": self.device_bytes(),
            }
            self.last_round = report
            return report

    # ------------------------------------------------------ memory budget
    def device_bytes(self) -> int:
        total = 0
        for t in self.tenants.values():
            sess = t.session
            if sess is not None:
                b = sess.device_bytes()
                total += b["env_bytes"] + b["state_bytes"]
        return total

    def enforce_memory_budget(self) -> list[str]:
        """LRU spill until the fleet's resident footprint fits the budget:
        paused tenants first, then the least-recently-optimized. A spilled
        tenant's next touch (sync) re-admits it bit-identically through the
        session's own finalize program."""
        budget = self.memory_budget_bytes
        if budget is None or budget < 0:
            return []
        spilled: list[str] = []
        while self.device_bytes() > budget:
            victims = [t for t in self.tenants.values()
                       if t.session is not None and t.session.env is not None]
            if not victims:
                break
            victim = min(victims,
                         key=lambda t: (not t.paused, t.last_round_seq))
            if not victim.session.spill():
                break
            self._spill_meter.mark()
            spilled.append(victim.cluster_id)
            LOG.info("fleet memory budget: spilled tenant %s "
                     "(%d bytes resident > %d budget)",
                     victim.cluster_id, self.device_bytes(), budget)
        return spilled

    # --------------------------------------------------- precompute thread
    def start_precompute(self, interval_ms: float | None = None) -> None:
        """The fleet's serving loop (threaded service mode): full rounds on
        the precompute cadence keep every tenant's cache fresh, and an
        enqueued request (detector heal, user rebalance) WAKES the loop for
        an immediate dispatch instead of waiting out the interval — the
        continuous-batching half of the admission engine."""
        if self._thread is not None:
            return
        if interval_ms is None:
            interval_ms = self.precompute_interval_ms
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                woken = self._work.wait(interval_ms / 1000.0)
                if self._stop.is_set():
                    return
                self._work.clear()
                try:
                    if woken and self.admission_enabled:
                        # drain just the queued requests (low latency);
                        # the next interval expiry still runs a full round
                        for _ in range(len(self.tenants) + 4):
                            d = self.dispatch_once()
                            if d is None or (d["launches"] == 0
                                             and not d["failed"]):
                                break
                    else:
                        self.run_round()
                except Exception:    # noqa: BLE001
                    LOG.exception("fleet precompute round failed")

        self._thread = threading.Thread(target=loop, name="fleet-precompute",
                                        daemon=True)
        self._thread.start()

    def stop_precompute(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None

    def shutdown(self) -> None:
        self.stop_precompute()
        for cid in list(self.tenants):
            self.remove_tenant(cid)

    # ---------------------------------------------------------------- state
    def admission_state_json(self) -> dict:
        """Queue depth / lane occupancy / serving SLOs — served under the
        REST ``/state`` FLEET substate and consumed by tools/queue_view.py."""
        with self._lock:
            now = self._clock_ms
            lanes = {name: {"depth": 0, "oldestSeq": None,
                            "oldestAgeMs": None} for name in LANE_NAMES}
            for per_lane in self._requests.values():
                for lane, r in per_lane.items():
                    d = lanes[LANE_NAMES[lane]]
                    d["depth"] += 1
                    if d["oldestSeq"] is None or r.seq < d["oldestSeq"]:
                        d["oldestSeq"] = r.seq
                        d["oldestAgeMs"] = (max(now - r.enqueued_ms, 0.0)
                                            if now else None)
            heal = sorted(self.heal_admission_ms)

            def _pct(p, xs=None):
                xs = heal if xs is None else xs
                if not xs:
                    return None
                return float(xs[max(0, -(-len(xs) * p // 100) - 1)])

            heal_wall = sorted(self.heal_admission_wall_ms)
            lag_wall = sorted(self.install_lag_wall_ms)
            return {
                "enabled": self.admission_enabled,
                "maxBatch": self.max_batch,
                "quantizeBatch": self.quantize_batch,
                "nearJoinPressure": self.join_pressure,
                "queueDepth": self.queue_depth(),
                "queuePressure": self.queue_pressure(),
                "lanes": lanes,
                "enqueued": self.requests_enqueued,
                "coalesced": self.requests_coalesced,
                "admitted": self.requests_admitted,
                "requeued": self.requests_requeued,
                "failed": self.requests_failed,
                "dispatches": self.dispatches,
                "joins": self.joins,
                "splits": self.splits,
                "healAdmissionP50Ms": _pct(50),
                "healAdmissionP95Ms": _pct(95),
                # ragged fleet gating: wall-clock serving SLOs (the
                # axis where early landing shows) + per-tenant lane counters
                "gating": {
                    "earlyInstallEnabled": self.early_install,
                    "earlyInstalls": self.early_installs,
                    "healAdmissionWallP50Ms": _pct(50, heal_wall),
                    "healAdmissionWallP95Ms": _pct(95, heal_wall),
                    "installLagWallP50Ms": _pct(50, lag_wall),
                    "installLagWallP95Ms": _pct(95, lag_wall),
                    "tenants": {cid: t.gating_json()
                                for cid, t in self.tenants.items()},
                },
                "lastDispatch": dict(self.last_dispatch),
            }

    def state_json(self) -> dict:
        with self._lock:
            return {
                "tenants": {cid: t.state_json()
                            for cid, t in self.tenants.items()},
                "rounds": self.rounds,
                "launches": self.launches,
                "deviceBytes": self.device_bytes(),
                "memoryBudgetBytes": self.memory_budget_bytes,
                "lastRound": dict(self.last_round),
                "admission": self.admission_state_json(),
            }
