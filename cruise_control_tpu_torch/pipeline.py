"""Continuous pipelined service loop: overlap sampling, sync, optimize and
execute (counterpart of ``cruise_control_tpu/pipeline.py``).

The blocking service loop is strictly sample -> sync -> optimize -> execute.
This module is a four-stage pipeline whose steady-state critical path is
the optimizer alone.

Stages (each a thread in the live service, or one deterministic unit of work
per ``step()`` in lockstep mode):

- **ingest** — the sampling driver: fetch one round of samples
  (``LoadMonitor.fetch_samples``) and push the un-ingested batch into a
  host-side per-shape-bucket ring buffer. Never touches the aggregators.
- **sync** — drain the ring into the aggregators (``ingest_samples``), then
  bring the resident session up to date (``ResidentClusterSession.sync``).
  The session's finalize materializes the next round's (env, state) into
  fresh tensors from host mirrors, so this runs safely while the previous
  round still holds the lent state: the shadow slot
  (``session.shadow_syncs`` counts exactly these).
- **optimize** — when the synced generation advanced AND
  ``meetCompletenessRequirements`` holds, refresh the proposal cache from
  the resident state. Completeness is the explicit BACKPRESSURE signal: an
  unmet requirement STALLS this stage (counted, visible in state_json)
  instead of erroring, and the stage releases on its own once live sampling
  fills the windows.
- **execute** — drain submitted proposal rounds so the next round's
  ingest/sync/optimize start while the executor moves replicas. Every
  submission carries a generation tag; a set whose metadata generation is
  stale, or that a newer set has superseded, is DROPPED, not executed
  (``pipeline-stale-rounds-dropped``). The fleet's ``submit_install`` rides
  this stage too.

Determinism: lockstep mode (``step(now_ms)``) runs the stages in a fixed
order per tick, keyed by the tick's clock, so it is bit-reproducible per
(script, seed). The threaded mode is the same stage code free-running.

Threads and the card: every stage thread, the server's handler threads and
the fleet's precompute thread launch on the one current CUDA stream (no
side stream), so the caching allocator hands a freed block only to work
queued behind every kernel that read it. The optimizer's pass loop is host
Python and holds the interpreter lock between launches, so the ingest and
sync stages contend with it for the host.

Overlap proof: stage spans are noted on the app's FlightRecorder
(``note_stage``), which measures, at note time, how much of each span ran
under an in-flight optimize round; every RoundTrace then carries per-stage
lanes + overlap fractions (``trace.stages`` / ``trace.overlap``).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque

from cruise_control_tpu_torch.monitor.load_monitor import (
    ModelCompletenessRequirements, NotEnoughValidWindowsError,
)

LOG = logging.getLogger(__name__)

# Priority lanes shared with the fleet admission engine (fleet.py): lower
# value drains first. Heals (detector FIX/PREDICTED verdicts) preempt
# user-initiated hygiene rebalances, which preempt background refresh.
LANE_HEAL = 0
LANE_REBALANCE = 1
LANE_REFRESH = 2
LANE_NAMES = ("heal", "rebalance", "refresh")


def _bucket(n: int, minimum: int = 64) -> int:
    """Power-of-two shape bucket (the model's bucketing policy, host-side)."""
    b = max(minimum, 1)
    n = max(n, 1)
    while b < n:
        b *= 2
    return b


class SampleRingBuffer:
    """Bounded host-side ring of fetched-but-not-ingested sample batches,
    keyed by shape bucket (bucketed partition/broker sample counts) so
    steady-state batches of one cluster shape reuse one lane. Push never
    blocks: a full bucket drops its OLDEST batch (counted) — sampling
    backpressure is window ageing, never an unbounded queue. Drain returns
    batches in global arrival order regardless of bucket, so ingestion order
    is deterministic."""

    def __init__(self, capacity: int = 8):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._buckets: dict[tuple, deque] = {}
        self._seq = 0
        self.pushed = 0
        self.dropped = 0

    @staticmethod
    def bucket_key(samples) -> tuple:
        np_ = sum(len(b.entities) for b in
                  getattr(samples, "partition_blocks", ())) \
            + len(getattr(samples, "partition_samples", ()) or ())
        nb = len(getattr(samples, "broker_samples", ()) or ())
        return (_bucket(np_), _bucket(nb, 16))

    def push(self, now_ms: float, samples, fetch_s: float = 0.0) -> tuple:
        key = self.bucket_key(samples)
        with self._lock:
            lane = self._buckets.setdefault(key, deque())
            if len(lane) >= self.capacity:
                lane.popleft()
                self.dropped += 1
            lane.append((self._seq, float(now_ms), samples, float(fetch_s)))
            self._seq += 1
            self.pushed += 1
        return key

    def drain(self) -> list:
        """Pop every pending batch, globally ordered by arrival."""
        with self._lock:
            out = [item for lane in self._buckets.values() for item in lane]
            for lane in self._buckets.values():
                lane.clear()
        out.sort(key=lambda item: item[0])
        return out

    def __len__(self) -> int:
        with self._lock:
            return sum(len(lane) for lane in self._buckets.values())

    def state_json(self) -> dict:
        with self._lock:
            return {"capacity": self.capacity, "pushed": self.pushed,
                    "dropped": self.dropped,
                    "depth": sum(len(v) for v in self._buckets.values()),
                    "buckets": {str(k): len(v)
                                for k, v in self._buckets.items()}}


@dataclasses.dataclass
class ProposalRound:
    """One generation-tagged execution submission. ``sticky`` rounds are
    self-healing FIX executions routed through the execute stage:
    they are never dropped as stale/superseded — a heal computed against a
    slightly older metadata generation still beats no heal, and the
    executor's own per-task re-validation DEADs anything that genuinely no
    longer applies."""
    seq: int
    metadata_generation: int
    proposals: list
    execute_kw: dict = dataclasses.field(default_factory=dict)
    submitted_ms: float = 0.0
    sticky: bool = False
    # admission-lane priority (LANE_*): drain order is (lane, seq) so a
    # re-queued refresh round can never jump ahead of a queued heal
    lane: int = LANE_REFRESH
    # launch-in-flight install seam (fleet admission engine): when set to
    # (result, computed_ms), the drain installs the proposal cache instead
    # of executing — exempt from staleness/supersede drops (idempotent
    # cache write, the install itself records its generation)
    install: tuple | None = None


class PipelinedServiceLoop:
    """The four-stage continuous controller over one :class:`CruiseControl`.

    Lockstep mode (sim/bench/tests): call ``step(now_ms)`` per tick — stages
    run once each in a fixed order (execute-drain, ingest, sync, optimize),
    hand-offs keyed by the tick clock. Threaded mode (the live service):
    ``start()``/``stop()`` run the same stage methods on four daemon
    threads. ``pipelined_round`` is the measured unit bench/tests use: one
    optimize round with the NEXT round's ingest+sync overlapped under it.
    """

    def __init__(self, cc, config=None):
        self.cc = cc
        config = config or cc.config
        self.monitor = cc.load_monitor
        self.recorder = cc.flight_recorder
        self.sensors = cc.sensors
        self.ring = SampleRingBuffer(
            capacity=config.get_int("service.pipeline.ring.capacity"))
        self._interval_ms = float(
            config.get_int("metric.sampling.interval.ms"))
        self._req = ModelCompletenessRequirements(
            min_required_num_windows=config.get_int(
                "service.pipeline.min.windows"))
        # backpressure + staleness observability
        self._stall_meter = self.sensors.meter("pipeline-backpressure-stalls")
        self._stale_meter = self.sensors.meter("pipeline-stale-rounds-dropped")
        self._exec_meter = self.sensors.meter("pipeline-executions-drained")
        self.sensors.gauge("pipeline-ring-depth", lambda: len(self.ring))
        self.stalled = False          # optimize stage currently backpressured
        self.stall_count = 0
        self.release_count = 0
        self.optimize_rounds = 0
        self.ingest_rounds = 0
        self.sync_rounds = 0
        self._synced_generation = -1  # session.sync_generation at last sync
        self._optimized_generation = -1
        self._exec_queue: deque[ProposalRound] = deque()
        self._exec_seq = 0
        self._exec_lock = threading.Lock()
        self.stale_rounds_dropped = 0
        self.executions_drained = 0
        self.installs_drained = 0
        self._last_exec_seq = -1
        # threaded mode
        self._stop = threading.Event()
        self._wake_sync = threading.Event()
        self._wake_opt = threading.Event()
        self._wake_exec = threading.Event()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------- stages
    def ingest_once(self, now_ms: float | None = None) -> int:
        """Ingest stage: fetch one sampling round into the ring (no
        aggregator writes). Returns #batches pushed (0 or 1)."""
        t0 = time.monotonic()
        fetched = self.monitor.fetch_samples(now_ms)
        if fetched is None:
            return 0
        samples, now, fetch_s = fetched
        self.ring.push(now, samples, fetch_s)
        self.ingest_rounds += 1
        self.recorder.note_stage("ingest", t0, time.monotonic())
        return 1

    def sync_once(self) -> dict:
        """Sync stage: drain the ring into the aggregators, then bring the
        resident session up to the new windows/metadata (the shadow-slot
        upload when an optimize round is in flight). Returns the sync info
        (``{"mode": ...}`` or ``{"skipped": ...}``)."""
        t0 = time.monotonic()
        drained = self.ring.drain()
        ingested = 0
        for _seq, _now, samples, fetch_s in drained:
            ingested += self.monitor.ingest_samples(samples, fetch_s=fetch_s)
        info: dict = {"ingested": ingested, "batches": len(drained)}
        sess = self.cc.resident_session
        if sess is not None:
            try:
                info.update(sess.sync())
                self._synced_generation = sess.sync_generation
                # the sync -> optimize hand-off: what the next
                # optimize round's incremental eligibility check will see —
                # accumulated churn, dirty-set sizes, load drift
                info["pending_delta"] = sess.pending_delta_json()
            except NotEnoughValidWindowsError as e:
                info["skipped"] = str(e)    # backpressure: windows not filled
        else:
            # no resident session: the optimize stage's model build is the
            # sync; generation bumps track the aggregator
            self._synced_generation += 1 if ingested else 0
        if drained:
            self.sync_rounds += 1
            self.recorder.note_stage("sync", t0, time.monotonic(),
                                     batches=len(drained))
        return info

    def backpressured(self) -> bool:
        """The explicit backpressure signal: meetCompletenessRequirements
        (SURVEY §2.3) gates the optimize stage — unmet requirements STALL the
        stage (no error, no round) until live sampling fills the windows."""
        return not self.monitor.meet_completeness_requirements(self._req)

    def optimize_once(self, force_refresh: bool = False) -> dict:
        """Optimize stage: refresh the proposal cache from the synced
        resident state, unless backpressured or nothing new was synced."""
        if self.backpressured():
            if not self.stalled:
                self.stalled = True
                self.stall_count += 1
                LOG.info("pipeline optimize stage STALLED on completeness "
                         "backpressure (windows not filled)")
            self._stall_meter.mark()
            return {"stalled": True}
        if self.stalled:
            self.stalled = False
            self.release_count += 1
            LOG.info("pipeline optimize stage released (windows filled)")
        if (not force_refresh
                and self._optimized_generation == self._synced_generation
                and self.optimize_rounds > 0):
            return {"skipped": "nothing new synced"}
        gen = self._synced_generation
        try:
            res = self.cc.cached_proposals(force_refresh=force_refresh)
        except NotEnoughValidWindowsError:
            # raced a window roll-out between the check and the build: treat
            # exactly like backpressure (stall, retry next step)
            self._stall_meter.mark()
            return {"stalled": True}
        self._optimized_generation = gen
        self.optimize_rounds += 1
        out = {"optimized": True, "generation": gen}
        mode = getattr(res, "round_mode", None)
        if mode is not None:
            out["round_mode"] = mode      # full | reduced | revalidated
        return out

    # ------------------------------------------------------------ execute
    def accepts_fix_routing(self) -> bool:
        """Whether self-healing FIX executions may be handed to this loop's
        execute stage (app._route_fixes_async): only the THREADED mode — a
        lockstep (sim) pipeline keeps heals blocking so scenario timelines
        stay bit-identical per (scenario, seed)."""
        return bool(self._threads)

    def submit_execution(self, proposals: list, execute_kw: dict | None = None,
                         sticky: bool = False,
                         lane: int | None = None) -> ProposalRound:
        """Queue one generation-tagged proposal set for async execution.
        The tag is the monitor's CURRENT metadata generation; the drain
        drops the set if the metadata generation moved (the cluster the plan
        was computed against no longer exists) or a newer set superseded it.
        ``sticky`` (routed FIX heals) exempts the round from both drops.
        ``lane`` defaults to the heal lane for sticky rounds and the refresh
        lane otherwise; the drain processes (lane, seq) order."""
        gen = self.monitor.model_generation().metadata_generation
        if lane is None:
            lane = LANE_HEAL if sticky else LANE_REFRESH
        with self._exec_lock:
            rnd = ProposalRound(seq=self._exec_seq, metadata_generation=gen,
                                proposals=list(proposals),
                                execute_kw=dict(execute_kw or {}),
                                submitted_ms=self.cc._now_ms(),
                                sticky=sticky, lane=int(lane))
            self._exec_seq += 1
            self._exec_queue.append(rnd)
        self._wake_exec.set()
        return rnd

    def submit_install(self, result, computed_ms: float | None = None,
                       lane: int = LANE_REFRESH) -> ProposalRound:
        """Queue a proposal-cache install to ride the execute stage — the
        fleet admission engine's launch-in-flight seam: the scheduler hands
        a completed tenant's batched result here and starts its next batched
        launch immediately; the install lands on this loop's thread."""
        with self._exec_lock:
            rnd = ProposalRound(seq=self._exec_seq, metadata_generation=-1,
                                proposals=[],
                                submitted_ms=self.cc._now_ms(),
                                lane=int(lane),
                                install=(result, computed_ms))
            self._exec_seq += 1
            self._exec_queue.append(rnd)
        self._wake_exec.set()
        return rnd

    def drain_executions(self, blocking: bool = True) -> dict:
        """Execute stage: run the newest still-fresh proposal round, dropping
        stale ones. ``blocking`` executes synchronously (lockstep mode);
        threaded mode passes False and lets the executor's own thread drain."""
        t0 = time.monotonic()
        with self._exec_lock:
            pending = list(self._exec_queue)
            self._exec_queue.clear()
        if not pending:
            return {"executed": 0, "dropped": 0, "installed": 0}
        # lane-aware drain order: heals before hygiene rebalances before
        # background refresh, seq within a lane — so a round re-queued while
        # an execution owned the executor can never jump ahead of a heal
        # that arrived after it
        pending.sort(key=lambda r: (r.lane, r.seq))
        current_gen = self.monitor.model_generation().metadata_generation
        executed = 0
        dropped = 0
        installed = 0
        # sticky (routed-heal) rounds never supersede or get superseded by
        # the precompute's rebalance rounds — newest-wins applies to the
        # ordinary rounds only; install rounds are cache writes, exempt
        ordinary = [r.seq for r in pending if not r.sticky and r.install is None]
        newest = max(ordinary) if ordinary else -1
        for i, rnd in enumerate(pending):
            if rnd.install is not None:
                res, computed_ms = rnd.install
                self.cc.install_proposal_cache(res, computed_ms=computed_ms)
                installed += 1
                self.installs_drained += 1
                continue
            stale = (not rnd.sticky
                     and (rnd.metadata_generation != current_gen
                          or rnd.seq != newest))
            if stale or not rnd.proposals:
                if rnd.proposals:
                    dropped += 1
                    self.stale_rounds_dropped += 1
                    self._stale_meter.mark()
                    LOG.info(
                        "dropping stale proposal round %d (generation %d != "
                        "%d or superseded by %d)", rnd.seq,
                        rnd.metadata_generation, current_gen, newest)
                continue
            if self.cc.executor.has_ongoing_execution():
                # an in-flight execution owns the executor: re-queue this
                # round AND everything still unprocessed behind it (sticky
                # heals made multi-execute drains possible — dropping the
                # tail here would lose queued heals)
                with self._exec_lock:
                    for r in reversed(pending[i:]):
                        self._exec_queue.appendleft(r)
                break
            self.cc.executor.execute_proposals(
                rnd.proposals, blocking=blocking,
                generation=rnd.metadata_generation, **rnd.execute_kw)
            executed += 1
            self.executions_drained += 1
            self._exec_meter.mark()
            self._last_exec_seq = rnd.seq
        if executed or dropped or installed:
            self.recorder.note_stage("execute", t0, time.monotonic(),
                                     executed=executed, dropped=dropped,
                                     installed=installed)
        return {"executed": executed, "dropped": dropped,
                "installed": installed}

    # ----------------------------------------------------------- lockstep
    def step(self, now_ms: float | None = None, optimize: bool = True) -> dict:
        """One deterministic pipeline step (the sim's per-tick drive): stage
        hand-offs keyed by ``now_ms`` — the tick clock — never wall clock.
        Fixed order: execute-drain, ingest, sync, optimize."""
        out: dict = {}
        out["execute"] = self.drain_executions(blocking=True)
        out["ingested"] = self.ingest_once(now_ms)
        out["sync"] = self.sync_once()
        if optimize:
            out["optimize"] = self.optimize_once()
        return out

    # ------------------------------------------------- the measured round
    def pipelined_round(self, now_ms: float | None = None,
                        join_timeout_s: float = 900.0) -> dict:
        """ONE steady service round with the hand-offs overlapped — the
        bench/test unit: round N's optimize runs on its own thread while
        round N+1's ingest + sync (the shadow-slot upload) run under it.
        Returns {"result", "wall_s", "sync_info", "trace"} where ``trace``
        is the recorded RoundTrace carrying the stage lanes + overlap
        fractions for the NEXT round to consume."""
        box: dict = {}

        def _optimize():
            try:
                box["result"] = self.cc.cached_proposals(force_refresh=True)
            except Exception as e:   # noqa: BLE001 — surfaced to the caller
                box["error"] = e

        t0 = time.monotonic()
        t = threading.Thread(target=_optimize, name="pipeline-optimize")
        t.start()
        # wait for the optimize round to take the session state (its sync
        # memo-hits and the chain dispatches) before bumping the aggregator
        # generation underneath it — otherwise the optimize thread redoes
        # the sync and the overlap is lost
        deadline = time.monotonic() + 10.0
        while (not self.recorder.optimize_in_flight() and t.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.002)
        # round N+1's ingest + sync, overlapped with the in-flight chain
        self.ingest_once(now_ms)
        sync_info = self.sync_once()
        t.join(join_timeout_s)
        if "error" in box:
            raise box["error"]
        self.optimize_rounds += 1
        self._optimized_generation = self._synced_generation
        return {"result": box.get("result"),
                "wall_s": time.monotonic() - t0,
                "sync_info": sync_info,
                "trace": self.recorder.last()}

    # ----------------------------------------------------------- threaded
    def start(self) -> None:
        """Free-running mode: four daemon stage threads. The ingest thread
        owns the sampling cadence (and advances a simulated backend clock by
        the interval, like the legacy SamplingLoop did)."""
        if self._threads:
            return
        self._stop.clear()
        backend = self.cc.backend

        def ingest_loop():
            while not self._stop.wait(self._interval_ms / 1000.0):
                try:
                    if hasattr(backend, "advance"):
                        backend.advance(self._interval_ms)
                    if self.ingest_once():
                        self._wake_sync.set()
                except Exception:    # noqa: BLE001
                    LOG.exception("pipeline ingest round failed")

        def sync_loop():
            while not self._stop.is_set():
                self._wake_sync.wait(self._interval_ms / 1000.0)
                self._wake_sync.clear()
                if self._stop.is_set():
                    return
                try:
                    if len(self.ring):
                        self.sync_once()
                        self._wake_opt.set()
                except Exception:    # noqa: BLE001
                    LOG.exception("pipeline sync round failed")

        def optimize_loop():
            while not self._stop.is_set():
                self._wake_opt.wait(self._interval_ms / 1000.0)
                self._wake_opt.clear()
                if self._stop.is_set():
                    return
                try:
                    self.optimize_once()
                except Exception:    # noqa: BLE001
                    LOG.exception("pipeline optimize round failed")

        def execute_loop():
            while not self._stop.is_set():
                self._wake_exec.wait(1.0)
                self._wake_exec.clear()
                if self._stop.is_set():
                    return
                try:
                    # blocking inside this thread: executions serialize here
                    # while ingest/sync/optimize free-run on their threads
                    self.drain_executions(blocking=True)
                except Exception:    # noqa: BLE001
                    LOG.exception("pipeline execution drain failed")

        for name, fn in (("pipeline-ingest", ingest_loop),
                         ("pipeline-sync", sync_loop),
                         ("pipeline-optimize", optimize_loop),
                         ("pipeline-execute", execute_loop)):
            th = threading.Thread(target=fn, name=name, daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for ev in (self._wake_sync, self._wake_opt, self._wake_exec):
            ev.set()
        for th in self._threads:
            th.join(30.0)
        self._threads.clear()

    # -------------------------------------------------------------- state
    def state_json(self) -> dict:
        return {
            "mode": "threaded" if self._threads else "lockstep",
            "stalled": self.stalled,
            "stallCount": self.stall_count,
            "releaseCount": self.release_count,
            "ingestRounds": self.ingest_rounds,
            "syncRounds": self.sync_rounds,
            "optimizeRounds": self.optimize_rounds,
            "executionsDrained": self.executions_drained,
            "installsDrained": self.installs_drained,
            "staleRoundsDropped": self.stale_rounds_dropped,
            "syncedGeneration": self._synced_generation,
            "optimizedGeneration": self._optimized_generation,
            "ring": self.ring.state_json(),
        }
