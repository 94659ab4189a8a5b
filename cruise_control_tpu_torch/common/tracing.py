"""Flight recorder, causal span journal and Prometheus exposition
(counterpart of ``cruise_control_tpu/common/tracing.py``).

The port's copy keeps every class the facade builds (``EventJournal``,
``SpanTracer``, ``FlightRecorder``) and the exposition verbatim. It leaves
out the reference's XLA compile sensors (``XlaCompileListener``,
``CompileCounter``, ``count_compiles``), which count JAX compiles; the
port's kernels are built once by ``nvcc`` (``kernels/build.py``).
``tree_device_bytes`` sums the bytes of torch tensors. The optimizer
records every round (``FlightRecorder.record_round``), and the pipelined
loop notes its stages on the same recorder.

- :class:`RoundTrace` / :class:`FlightRecorder` — one record per
  optimization round in a bounded thread-safe ring buffer, served by
  ``/state?substates=ROUND_TRACES``.

Causal span journal (PR 12): the per-component sensors above answer "how is
the system doing"; they cannot answer "what happened to THIS anomaly". The
three classes below close that gap in the Dapper style:

- :class:`Span` / :class:`SpanTracer` — lightweight spans with explicit
  lineage (trace_id / span_id / parent_id), stamped from the INJECTED clock
  (simulated time in the sim, wall time in the service). Parents are passed
  as explicit handles down the call chain (detector verdict -> facade
  operation -> optimizer round -> executor phases), never through
  thread-local/context magic — the sim stays deterministic and span ids are
  reproducible per (scenario, seed).
- :class:`EventJournal` — an append-only size-rotated JSONL event log the
  recorder, span tracer, executor task census, breaker state machine and
  pipeline stage notes all write through. Records are serialized with
  sorted keys and carry ONLY deterministic fields (backend-clock timestamps,
  counts, ids — never wall seconds or compile counts), so the same
  (scenario, seed) produces a byte-identical journal in sim mode. A bounded
  in-memory ring of lines backs journal-less (in-memory) deployments and
  the sim's per-episode journal slices; a configured ``journal.path`` makes
  it the durable tail target an HA standby can consume.
- :func:`build_trace_trees` — reconstructs nested trace trees from span
  records (the tracer's ring or a journal file), shared by
  ``/state?substates=TRACES``, ``tools/journal_view.py`` and the
  tree-completeness tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 64


def tree_device_bytes(tree) -> int:
    """Exact bytes of the tensors of a dataclass (an env or a state; None
    reads 0): tensor METADATA only, no transfer, no synchronization."""
    if tree is None:
        return 0
    return sum(v.element_size() * v.numel()
               for v in (getattr(tree, f.name) for f in dataclasses.fields(tree))
               if hasattr(v, "element_size"))


# ---------------------------------------------------------------------------
# durable event journal
# ---------------------------------------------------------------------------
class EventJournal:
    """Append-only size-rotated JSONL event log (``journal.*`` config keys).

    One record per line, serialized with sorted keys and compact separators
    so identical event streams are identical BYTES — the sim's
    (scenario, seed) ⇒ byte-identical-journal contract rests on this plus
    the writers' discipline of journaling only deterministic fields.

    ``path`` empty/None keeps the journal purely in-memory (a bounded ring
    of the most recent ``memory_lines`` lines is always kept either way —
    it is what ``ScenarioResult.journal`` and the tests consume). With a
    path, files rotate at ``max_bytes`` per file into ``path.1``..``path.N``
    (newest suffix = most recently rotated), keeping at most ``max_files``
    rotated files. ``fsync``: "never" (default), "rotate" (fsync when a
    file fills), or "always" (fsync every append — the durable-tail setting
    an HA standby would use).
    """

    def __init__(self, path: str | None = None, max_bytes: int = 16_777_216,
                 max_files: int = 8, fsync: str = "never", clock_ms=None,
                 memory_lines: int = 65_536):
        self.path = path or None
        self.max_bytes = max(int(max_bytes), 4096)
        self.max_files = max(int(max_files), 1)
        self.fsync = fsync if fsync in ("never", "rotate", "always") else "never"
        self.clock_ms = clock_ms or (lambda: time.time() * 1000.0)
        self._lock = threading.Lock()
        self._mem: deque[str] = deque(maxlen=max(int(memory_lines), 16))
        self.events_appended = 0
        self.bytes_appended = 0
        self.dropped_from_memory = 0
        self.rotations = 0
        self._f = None
        self._file_bytes = 0
        if self.path:
            self._f = open(self.path, "a", encoding="utf-8")
            self._file_bytes = self._f.tell()

    # --------------------------------------------------------------- write
    def append(self, kind: str, **fields) -> None:
        """Journal one event. ``ts`` is stamped from the injected clock;
        callers must pass only deterministic fields (no wall seconds, no
        process-dependent ids). Never raises into the caller's path."""
        record = {"kind": kind, "ts": round(float(self.clock_ms()), 3)}
        record.update(fields)
        try:
            line = json.dumps(record, sort_keys=True,
                              separators=(",", ":"), default=str)
        except Exception:  # noqa: BLE001 — journaling must never fail a round
            import logging
            logging.getLogger(__name__).exception("unserializable journal event")
            return
        with self._lock:
            if len(self._mem) == self._mem.maxlen:
                self.dropped_from_memory += 1
            self._mem.append(line)
            self.events_appended += 1
            self.bytes_appended += len(line) + 1
            if self._f is not None:
                try:
                    if self._file_bytes + len(line) + 1 > self.max_bytes:
                        self._rotate_locked()
                    self._f.write(line + "\n")
                    self._file_bytes += len(line) + 1
                    if self.fsync == "always":
                        self._f.flush()
                        os.fsync(self._f.fileno())
                except OSError:
                    import logging
                    logging.getLogger(__name__).exception(
                        "journal write failed; continuing in-memory only")

    def _rotate_locked(self) -> None:
        """Caller holds the lock. path.N-1 -> path.N ... path -> path.1."""
        if self.fsync in ("rotate", "always"):
            self._f.flush()
            os.fsync(self._f.fileno())
        self._f.close()
        oldest = f"{self.path}.{self.max_files}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a", encoding="utf-8")
        self._file_bytes = 0
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    if self.fsync != "never":
                        os.fsync(self._f.fileno())
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    # ---------------------------------------------------------------- read
    def lines(self) -> list[str]:
        """The in-memory ring of recent journal lines (all of them for a
        short sim run) — the slice ``ScenarioResult`` carries."""
        with self._lock:
            return list(self._mem)

    def tail(self, cursor: int = 0) -> tuple[int, list[str], int]:
        """Follow API: events appended at/after absolute event index
        ``cursor``. Returns ``(new_cursor, lines, dropped)`` where
        ``new_cursor`` is the next cursor to pass and ``dropped`` counts
        events the bounded memory ring already evicted (a tailer that keeps
        up sees 0). In-process standbys tail this; file followers tailing
        another process's journal use :class:`JournalTailer` instead."""
        with self._lock:
            first = self.events_appended - len(self._mem)
            start = max(int(cursor), first)
            dropped = start - int(cursor) if cursor < first else 0
            mem = list(self._mem)
            return self.events_appended, mem[start - first:], dropped

    def state_json(self) -> dict:
        with self._lock:
            return {"path": self.path, "events": self.events_appended,
                    "bytes": self.bytes_appended,
                    "rotations": self.rotations,
                    "memoryLines": len(self._mem),
                    "droppedFromMemory": self.dropped_from_memory,
                    "fsync": self.fsync}


class JournalTailer:
    """Seam-safe follower of another process's on-disk journal file.

    Rotation renames ``path`` -> ``path.1`` (shifting older suffixes up) and
    reopens a fresh ``path``; a naive reader holding an open fd at an offset
    would keep reading the renamed file and never see the new one (drop), or
    reopen ``path`` and reread it from 0 (duplicate). The tailer remembers
    the INODE of the file it is reading: on each poll, if ``path`` now names
    a different inode, it (1) drains the previously-open fd to EOF — the
    rename preserved the inode so nothing written before the rotate is lost,
    (2) drains any ``path.K`` rotated files NEWER than the one it was
    reading (several rotations may land between polls; ``path.K-1`` rotated
    after ``path.K``), then (3) switches to the new ``path`` at offset 0.
    Partial (torn) tail lines are retained in a buffer until their newline
    arrives, so a line is never emitted twice nor split."""

    def __init__(self, path: str):
        self.path = path
        self._f = None
        self._ino = None
        self._buf = ""

    def _open(self, path: str):
        f = open(path, "r", encoding="utf-8")
        return f, os.fstat(f.fileno()).st_ino

    def _drain(self, f) -> list[str]:
        chunk = f.read()
        if not chunk:
            return []
        self._buf += chunk
        *complete, self._buf = self._buf.split("\n")
        return [ln for ln in complete if ln]

    def poll(self) -> list[str]:
        """New complete journal lines since the previous poll ([] when
        nothing landed or the file does not exist yet)."""
        out: list[str] = []
        try:
            cur_ino = os.stat(self.path).st_ino
        except OSError:
            return out
        if self._f is None:
            try:
                self._f, self._ino = self._open(self.path)
            except OSError:
                return out
        if self._ino != cur_ino:
            # rotated underneath us: finish the renamed file (same inode),
            # then any newer-rotated siblings, oldest first
            out.extend(self._drain(self._f))
            self._buf = ""       # a torn tail at rotate can't complete: the
            self._f.close()      # writer fsyncs whole lines before rotating
            rotated = []         # path.K newer than the inode we were on
            k = 1
            while True:
                p = f"{self.path}.{k}"
                try:
                    ino = os.stat(p).st_ino
                except OSError:
                    break
                if ino == self._ino:
                    break
                rotated.append(p)
                k += 1
            for p in reversed(rotated):   # oldest rotation first
                try:
                    f, _ = self._open(p)
                except OSError:
                    continue
                out.extend(self._drain(f))
                f.close()
                self._buf = ""
            try:
                self._f, self._ino = self._open(self.path)
            except OSError:
                self._f = None
                return out
        out.extend(self._drain(self._f))
        return out

    def pending_bytes(self) -> int:
        """Unread bytes in the CURRENT file (a lag estimate for gauges)."""
        if self._f is None:
            return 0
        try:
            return max(os.stat(self.path).st_size - self._f.tell(), 0)
        except OSError:
            return 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# causal spans
# ---------------------------------------------------------------------------
def _norm_attrs(attrs: dict) -> dict:
    """JSON-native attr values: numpy scalars -> Python scalars (a stray
    np.int32 in a span attr must not poison /state?substates=TRACES)."""
    out = {}
    for k, v in attrs.items():
        if hasattr(v, "item") and getattr(v, "ndim", None) in (None, 0):
            try:
                v = v.item()
            except Exception:  # noqa: BLE001
                v = str(v)
        out[str(k)] = v
    return out


@dataclasses.dataclass
class Span:
    """One causally-linked unit of work. Lifetime: ``tracer.span(...)`` ->
    (optional ``child(...)`` handles passed down the call chain) ->
    ``end(**attrs)``, which stamps t1 and journals the span."""
    trace_id: str
    span_id: str
    parent_id: str | None
    span_kind: str               # verdict | operation | optimize | execution...
    name: str
    t0_ms: float
    t1_ms: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    _tracer: "SpanTracer | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    def child(self, span_kind: str, name: str, **attrs) -> "Span | None":
        """Explicit-handle propagation: the child carries this span's
        trace_id and points back via parent_id."""
        if self._tracer is None:
            return None
        return self._tracer.span(span_kind, name, parent=self, **attrs)

    def end(self, **attrs) -> "Span":
        if self._tracer is not None and self.t1_ms is None:
            self._tracer._finish(self, attrs)
        return self

    def to_json(self) -> dict:
        return {"trace": self.trace_id, "span": self.span_id,
                "parent": self.parent_id, "span_kind": self.span_kind,
                "name": self.name, "t0": round(self.t0_ms, 3),
                "t1": None if self.t1_ms is None else round(self.t1_ms, 3),
                "attrs": dict(self.attrs)}


class SpanTracer:
    """Span factory + bounded ring of finished spans.

    Ids are a per-tracer counter (``s000042``; a root's trace_id reuses its
    span counter as ``t000042``) — deterministic wherever the call order is
    (the single-threaded sim), merely unique under the service's threads.
    Finished spans are journaled (one line per span, at end time so every
    record carries its full [t0, t1] extent) and retained in a ring of
    ``capacity`` for ``/state?substates=TRACES``.
    """

    def __init__(self, clock_ms=None, journal: EventJournal | None = None,
                 capacity: int = 1024):
        self.clock_ms = clock_ms or (lambda: time.time() * 1000.0)
        self.journal = journal
        self.capacity = max(int(capacity), 16)
        self._lock = threading.Lock()
        self._next = 0
        self._open: dict[str, Span] = {}
        self._done: deque[Span] = deque(maxlen=self.capacity)
        self.started = 0
        self.finished = 0

    def span(self, span_kind: str, name: str, parent: Span | None = None,
             **attrs) -> Span:
        with self._lock:
            sid = f"s{self._next:06d}"
            self._next += 1
            self.started += 1
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = f"t{sid[1:]}", None
        sp = Span(trace_id=trace_id, span_id=sid, parent_id=parent_id,
                  span_kind=span_kind, name=name,
                  t0_ms=float(self.clock_ms()), attrs=_norm_attrs(attrs),
                  _tracer=self)
        with self._lock:
            self._open[sid] = sp
            # leak bound: a span abandoned by an exception path stays open
            # forever; evict the oldest once the open set far exceeds the
            # ring (insertion-ordered dict -> oldest first)
            while len(self._open) > 4 * self.capacity:
                self._open.pop(next(iter(self._open)))
        return sp

    def _finish(self, span: Span, attrs: dict) -> None:
        span.attrs.update(_norm_attrs(attrs))
        span.t1_ms = float(self.clock_ms())
        with self._lock:
            self._open.pop(span.span_id, None)
            self._done.append(span)
            self.finished += 1
        if self.journal is not None:
            j = span.to_json()
            self.journal.append("span", trace=j["trace"], span=j["span"],
                                parent=j["parent"], span_kind=j["span_kind"],
                                name=j["name"], t0=j["t0"], t1=j["t1"],
                                attrs=j["attrs"])

    # ---------------------------------------------------------------- read
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._done) + list(self._open.values())

    def to_json(self) -> dict:
        records = [s.to_json() for s in self.spans()]
        return {"capacity": self.capacity, "started": self.started,
                "finished": self.finished,
                "open": sum(1 for r in records if r["t1"] is None),
                "trees": build_trace_trees(records)}


def build_trace_trees(records: list) -> list:
    """Nest span records (dicts with trace/span/parent keys — the tracer's
    ring or journal ``span`` events) into per-trace trees.

    Returns ``[{"trace": tid, "roots": [span + "children": [...]],
    "orphans": [...]}, ...]`` sorted by trace id; ``orphans`` are spans
    whose parent never appeared (the tree-completeness tests assert none).
    """
    by_trace: dict[str, list] = {}
    for r in records:
        if not isinstance(r, dict) or "span" not in r:
            continue
        by_trace.setdefault(r.get("trace"), []).append(r)
    trees = []
    for tid in sorted(by_trace, key=str):
        spans = by_trace[tid]
        by_id = {r["span"]: dict(r, children=[]) for r in spans}
        roots, orphans = [], []
        for r in spans:
            node = by_id[r["span"]]
            parent = r.get("parent")
            if parent is None:
                roots.append(node)
            elif parent in by_id:
                by_id[parent]["children"].append(node)
            else:
                orphans.append(node)
        for node in by_id.values():
            node["children"].sort(key=lambda n: (n.get("t0") or 0.0, n["span"]))
        roots.sort(key=lambda n: (n.get("t0") or 0.0, n["span"]))
        trees.append({"trace": tid, "roots": roots, "orphans": orphans})
    return trees


# ---------------------------------------------------------------------------
# round traces
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RoundTrace:
    """One optimization round, flight-recorder schema (all host-side data the
    round computed anyway; per-goal seconds are honest only at
    ``analyzer.profile.level=stage`` or ``measure_goal_durations=True`` —
    ``durations_measured`` says which)."""
    round_id: int
    ts_ms: float
    operation: str | None           # REBALANCE / PROPOSALS / FIX_* / None
    wall_s: float                   # whole optimizations() call
    sampling_s: float | None        # last noted monitor sampling round
    sync_mode: str | None           # resident session: "delta" | "rebuild"
    sync_s: float | None
    donated: bool                   # this round took the resident state
    profile_level: str              # off | pass | stage
    durations_measured: bool
    compiles: int                   # XLA backend compiles during the round
    env_bytes: int
    state_bytes: int
    num_proposals: int
    num_replica_movements: int
    num_leadership_movements: int
    goals: list = dataclasses.field(default_factory=list)
    # pipelined-service-loop lanes (PR 11): the ingest/sync/execute stage
    # spans that PREPARED this round (noted by the pipeline before the round
    # ran), each with the seconds it overlapped an in-flight optimize round —
    # the flight-recorder proof that sampling/sync are off the critical path
    stages: list = dataclasses.field(default_factory=list)
    # per-stage summary {stage: {"dur_s", "overlap_s", "overlap_frac"}};
    # empty on the blocking loop (nothing ever overlaps optimize there)
    overlap: dict = dataclasses.field(default_factory=dict)
    # causal lineage (PR 12): the trace this round belongs to, when an
    # explicit span handle reached the optimizer (detector verdict ->
    # operation -> this round); None for unparented rounds
    trace_id: str | None = None
    # incremental re-optimization (PR 16): how the round was produced —
    # "full" | "reduced" (dirty-set-seeded chain) | "revalidated" (the
    # whole-round certificate memo; revalidate_s is the re-check's wall
    # seconds, the round's only device work)
    round_mode: str = "full"
    revalidate_s: float = 0.0
    # convergence-gated pass scheduling (PR 19): chain totals of budgeted
    # passes dispatched vs avoided by the chunked early exit, goals whose
    # chunk loop quiesced, and reduced goals short-circuited to one probe
    passes_dispatched: int = 0
    passes_skipped: int = 0
    early_exit_goals: int = 0
    skipped_goals: int = 0
    # ragged fleet gating (PR 20): one row per tenant lane of a batched
    # launch (tenant index, round_mode, pass/skip counters, parked_early,
    # compacted_out) — empty for solo rounds / ungated fleets
    fleet_lanes: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["wall_s"] = round(out["wall_s"], 4)
        return out


def goal_trace_rows(goal_results) -> list[dict]:
    """Per-goal trace rows from GoalResult records — the engine's pass-level
    profile (passes, per-branch action split, admission waves, finisher
    actions) plus the violation flags and (when measured) seconds."""
    return [{
        "name": g.name,
        "duration_s": round(g.duration_s, 4),
        "violated_before": g.violated_before,
        "violated_after": g.violated_after,
        "iterations": g.iterations,
        "passes": g.passes,
        "moves": g.move_actions,
        "leads": g.lead_actions,
        "swaps": g.swap_actions,
        "disk": g.disk_actions,
        "waves": g.move_waves,
        "finisher": g.finisher_actions,
        # segment-parallel finisher phase (PR 7): segments the applied waves
        # spread destinations over (0 = legacy waves) and admitted
        # cross-segment boundary rows re-validated by the budgeted admission
        "fin_segments": getattr(g, "finisher_segments", 0),
        "fin_boundary": getattr(g, "finisher_boundary", 0),
        # incremental round mode (PR 16): full | reduced | revalidated |
        # skipped — the flamegraph's which-goals-did-the-fast-path-skip
        # signal
        "mode": getattr(g, "mode", "full"),
        # convergence-gated dispatch (PR 19): budgeted passes the chunked
        # early exit avoided and the quiescing chunk index (-1 = ran to the
        # loop's own exit / chunking off)
        "passes_skipped": getattr(g, "passes_skipped", 0),
        "quiesce_chunk": getattr(g, "quiesce_chunk", -1),
    } for g in goal_results]


class FlightRecorder:
    """Bounded thread-safe ring buffer of :class:`RoundTrace` records.

    Always on and deliberately cheap: ``record`` is a lock + deque append.
    ``clock_ms`` is injectable so traces carry the backend's clock (simulated
    time in the sim; wall time in the service). ``note_sampling`` /
    ``note_operation`` let the layers that know those facts (monitor, facade)
    annotate the NEXT recorded round without the optimizer needing to know
    either — the operation note is thread-local so concurrent user-task
    rounds can't cross-tag each other.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock_ms=None,
                 journal: EventJournal | None = None):
        self.capacity = int(capacity)
        self.clock_ms = clock_ms or (lambda: time.time() * 1000.0)
        self.journal = journal
        self._lock = threading.Lock()
        self._traces: deque[RoundTrace] = deque(maxlen=self.capacity)
        self._recorded = 0
        self._next_id = 0
        self._sampling_s: float | None = None
        self._tl = threading.local()
        # pipelined-loop lane bookkeeping: stage spans noted since the last
        # recorded round, KEYED BY OPTIMIZE-ROUND GENERATION (the generation
        # in flight — or last started — when the note landed). A plain list
        # raced the threaded pipeline: once the optimize interval rolled, a
        # stage noted for round G+1 was consumed by round G's record. Each
        # entry is (generation, span-dict); _opt_t0 is the monotonic start
        # of the optimize round currently in flight (None = none in flight).
        self._pending_stages: list[tuple[int, dict]] = []
        self._opt_t0: float | None = None
        self._opt_gen = 0

    # ------------------------------------------------------------ annotate
    def note_sampling(self, seconds: float) -> None:
        with self._lock:
            self._sampling_s = round(float(seconds), 4)

    def note_operation(self, operation: str) -> None:
        self._tl.operation = operation

    def _take_operation(self) -> str | None:
        op = getattr(self._tl, "operation", None)
        self._tl.operation = None
        return op

    # ------------------------------------------------------ pipeline lanes
    def note_optimize_start(self) -> int:
        """The optimizer marks its round's start so concurrently-noted stage
        spans can measure how much of their wall ran UNDER the in-flight
        round (the pipelined loop's overlap proof). Returns the round's
        GENERATION — the optimizer hands it back to ``record_round`` so
        stage notes landing for a LATER round (the optimize interval rolled
        before this round recorded) stay pending for that round."""
        with self._lock:
            self._opt_t0 = time.monotonic()
            self._opt_gen += 1
            return self._opt_gen

    def optimize_in_flight(self) -> bool:
        """True between note_optimize_start and the round's record_round —
        the pipelined loop uses it to sequence its overlapped stages."""
        with self._lock:
            return self._opt_t0 is not None

    def note_stage(self, stage: str, t0: float, t1: float, **extra) -> None:
        """Record one pipeline stage span (monotonic seconds). ``overlap_s``
        is the part of [t0, t1] spent while an optimize round was in flight —
        computed here, at note time, because by the time the round records
        its trace the concurrent span is history. Spans accumulate keyed by
        the optimize generation in flight and attach to THAT round's trace
        (or the next one, when none is in flight)."""
        t0, t1 = float(t0), float(t1)
        with self._lock:
            opt_t0 = self._opt_t0
            now = time.monotonic()
            overlap = 0.0
            if opt_t0 is not None:
                overlap = max(0.0, min(t1, now) - max(t0, opt_t0))
            span = {"stage": stage, "dur_s": round(max(t1 - t0, 0.0), 4),
                    "overlap_s": round(overlap, 4)}
            span.update(extra)
            self._pending_stages.append((self._opt_gen, span))
            del self._pending_stages[:-64]   # bounded like the trace ring
        if self.journal is not None:
            # deterministic fields only: the stage name + its own counters
            # (batches/executed/dropped), never wall seconds
            self.journal.append("stage", stage=stage, **extra)

    def _take_stages(self, upto_gen: int | None = None) -> tuple[list, dict]:
        """Consume pending stage spans noted for generations <= ``upto_gen``
        (None = everything); returns (stages, per-stage overlap summary).
        Later generations stay pending for the round that owns them. Caller
        holds no lock."""
        with self._lock:
            if upto_gen is None:
                upto_gen = self._opt_gen
            stages = [s for g, s in self._pending_stages if g <= upto_gen]
            self._pending_stages = [(g, s) for g, s in self._pending_stages
                                    if g > upto_gen]
            if self._opt_gen <= upto_gen:
                # only clear the in-flight marker when no NEWER round has
                # started — round G's record must not erase round G+1's t0
                self._opt_t0 = None
        summary: dict = {}
        for s in stages:
            agg = summary.setdefault(s["stage"],
                                     {"dur_s": 0.0, "overlap_s": 0.0})
            agg["dur_s"] += s["dur_s"]
            agg["overlap_s"] += s["overlap_s"]
        for agg in summary.values():
            agg["dur_s"] = round(agg["dur_s"], 4)
            agg["overlap_s"] = round(agg["overlap_s"], 4)
            agg["overlap_frac"] = round(
                agg["overlap_s"] / agg["dur_s"], 4) if agg["dur_s"] else 0.0
        return stages, summary

    # -------------------------------------------------------------- record
    def next_round_id(self) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            return rid

    def record(self, trace: RoundTrace) -> None:
        with self._lock:
            self._traces.append(trace)
            self._recorded += 1

    def record_round(self, *, wall_s: float, goal_results, compiles: int,
                     env, state, num_proposals: int,
                     num_replica_movements: int,
                     num_leadership_movements: int,
                     session_info: dict | None = None, donated: bool = False,
                     profile_level: str = "off",
                     durations_measured: bool = False,
                     trace_id: str | None = None,
                     opt_generation: int | None = None,
                     round_mode: str = "full",
                     revalidate_s: float = 0.0,
                     passes_dispatched: int = 0,
                     passes_skipped: int = 0,
                     early_exit_goals: int = 0,
                     skipped_goals: int = 0,
                     fleet_lanes: list | None = None) -> RoundTrace:
        """Assemble + record one round from what the optimizer already holds.
        ``opt_generation`` (from this round's ``note_optimize_start``) keys
        which pending stage notes belong to it. Never raises into the
        optimization path."""
        info = session_info or {}
        with self._lock:
            sampling_s = self._sampling_s
        stages, overlap = self._take_stages(opt_generation)
        try:
            trace = RoundTrace(
                round_id=self.next_round_id(),
                ts_ms=float(self.clock_ms()),
                operation=self._take_operation(),
                wall_s=wall_s,
                sampling_s=sampling_s,
                sync_mode=info.get("mode"),
                sync_s=info.get("sync_s"),
                donated=donated,
                profile_level=profile_level,
                durations_measured=durations_measured,
                compiles=int(compiles),
                env_bytes=tree_device_bytes(env),
                state_bytes=tree_device_bytes(state),
                num_proposals=int(num_proposals),
                num_replica_movements=int(num_replica_movements),
                num_leadership_movements=int(num_leadership_movements),
                goals=goal_trace_rows(goal_results),
                stages=stages,
                overlap=overlap,
                trace_id=trace_id,
                round_mode=round_mode,
                revalidate_s=round(float(revalidate_s), 4),
                passes_dispatched=int(passes_dispatched),
                passes_skipped=int(passes_skipped),
                early_exit_goals=int(early_exit_goals),
                skipped_goals=int(skipped_goals),
                fleet_lanes=list(fleet_lanes or []),
            )
        except Exception:  # noqa: BLE001 — tracing must never fail a round
            import logging
            logging.getLogger(__name__).exception("round trace assembly failed")
            return None
        self.record(trace)
        if self.journal is not None:
            # deterministic slice of the trace only: counts, modes and the
            # lineage tie — never wall seconds or compile counts (the same
            # (scenario, seed) must journal identical bytes even when one
            # run compiled and the other hit warm program caches)
            self.journal.append(
                "round", round=trace.round_id, op=trace.operation,
                trace=trace.trace_id, proposals=trace.num_proposals,
                moves=trace.num_replica_movements,
                leads=trace.num_leadership_movements,
                sync=trace.sync_mode, donated=trace.donated)
        return trace

    # ---------------------------------------------------------------- read
    def last(self) -> RoundTrace | None:
        with self._lock:
            return self._traces[-1] if self._traces else None

    def last_json(self) -> dict | None:
        t = self.last()
        return t.to_json() if t is not None else None

    def traces(self) -> list[RoundTrace]:
        with self._lock:
            return list(self._traces)

    def to_json(self) -> dict:
        with self._lock:
            traces = list(self._traces)
            recorded = self._recorded
        return {"capacity": self.capacity, "recorded": recorded,
                "traces": [t.to_json() for t in traces]}

    def register_gauges(self, sensors) -> None:
        """Last-round gauges on the MetricRegistry, so /metrics carries the
        newest round without parsing the trace substate."""
        def field(name, default=0):
            def read():
                t = self.last()
                v = getattr(t, name, None) if t is not None else None
                return default if v is None else v
            return read

        sensors.gauge("round-traces-recorded",
                      lambda: self.to_json()["recorded"])
        sensors.gauge("last-round-wall-seconds", field("wall_s", 0.0))
        sensors.gauge("last-round-sampling-seconds", field("sampling_s", 0.0))
        sensors.gauge("last-round-sync-seconds", field("sync_s", 0.0))
        sensors.gauge("last-round-compiles", field("compiles"))
        sensors.gauge("last-round-env-bytes", field("env_bytes"))
        sensors.gauge("last-round-state-bytes", field("state_bytes"))
        sensors.gauge("last-round-proposals", field("num_proposals"))


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _prom_name(name: str, suffix: str = "") -> str:
    import re
    base = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if base and base[0].isdigit():
        base = "_" + base
    return f"cc_{base}{suffix}"


def _fmt(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def render_prometheus(registry_json: dict) -> str:
    """Render one MetricRegistry snapshot (``MetricRegistry.to_json()``) in
    Prometheus text exposition format 0.0.4.

    Timers render as summaries (quantiles + _sum/_count) plus a ``_max``
    gauge; meters as a ``_total`` counter plus a one-minute-rate gauge;
    gauges as gauges (non-numeric / errored gauges are skipped — a dead gauge
    must not poison the scrape). The ingest side of this repo already parses
    this family of formats (monitor/sampling/prometheus.py), so a CC instance
    can scrape itself — the round-trip the tests run.
    """
    lines: list[str] = []
    for name in sorted(registry_json):
        snap = registry_json[name]
        kind = snap.get("type")
        if kind == "timer":
            m = _prom_name(name, "_seconds")
            total = snap.get("totalSec",
                             snap.get("meanSec", 0.0) * snap.get("count", 0))
            lines.append(f"# TYPE {m} summary")
            for q, key in (("0.5", "p50Sec"), ("0.95", "p95Sec"),
                           ("0.99", "p99Sec")):
                lines.append(f'{m}{{quantile="{q}"}} {_fmt(snap[key])}')
            lines.append(f"{m}_sum {_fmt(total)}")
            lines.append(f"{m}_count {snap['count']}")
            mx = _prom_name(name, "_seconds_max")
            lines.append(f"# TYPE {mx} gauge")
            lines.append(f"{mx} {_fmt(snap['maxSec'])}")
            # cumulative fixed-bucket histogram twin (its own family — a
            # summary and a histogram cannot share a metric name): exact
            # le-labelled counters Prometheus/Grafana can aggregate into
            # percentiles ACROSS scrapes/instances (histogram_quantile),
            # which the reservoir summary above fundamentally cannot
            buckets = snap.get("bucketsSec")
            if buckets:
                h = _prom_name(name, "_seconds_hist")
                lines.append(f"# TYPE {h} histogram")
                for le, cum in buckets:
                    lines.append(f'{h}_bucket{{le="{_fmt(le)}"}} {cum}')
                lines.append(f'{h}_bucket{{le="+Inf"}} {snap["count"]}')
                lines.append(f"{h}_sum {_fmt(total)}")
                lines.append(f"{h}_count {snap['count']}")
        elif kind == "meter":
            m = _prom_name(name, "_total")
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {snap['count']}")
            r = _prom_name(name, "_one_minute_rate")
            lines.append(f"# TYPE {r} gauge")
            lines.append(f"{r} {_fmt(snap['oneMinuteRatePerSec'])}")
        elif kind == "gauge":
            if "value" not in snap:
                continue        # errored gauge: skip, never poison the scrape
            try:
                val = _fmt(snap["value"])
            except (TypeError, ValueError):
                continue        # non-numeric gauge (strings etc.)
            m = _prom_name(name)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {val}")
    return "\n".join(lines) + "\n"
