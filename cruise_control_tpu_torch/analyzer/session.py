"""ResidentClusterSession: a device-resident cluster model with delta ingest
(counterpart of ``cruise_control_tpu/analyzer/session.py``).

The session owns the padded ``ClusterEnv`` / ``EngineState`` of one shape
bucket on its device. Between optimize rounds the monitor and the backend
feed it deltas:

- metric-window refresh: fresh ``leader_load`` / ``follower_load`` [R, M]
  rows every sync, assembled by the monitor's own
  ``partition_load_columns`` / ``replica_load_rows`` (the code the full
  build runs);
- replica churn: broker, leadership and logdir changes land in the slots
  they already occupy (``model.delta.diff_snapshots``);
- partition and topic creation: appended rows land in the padded axes'
  free tail slots while they last;
- broker flips: liveness, demotion, capacity and dead-disk changes
  re-upload the small broker-axis arrays.

Every sync ends in the finalize: the K5 kernel (``kernels.session_finalize``:
leadership unpacked from its bit-packed upload, offline flags from broker and
logdir liveness, the topic-exclusion hoist, destination candidacy), then the
state's tallies through the same ``refresh`` that ``init_state`` runs, so a
session that ingested a delta stream is bit-identical to a rebuild of the
final cluster. The env writes of a delta (``_scatter_env``) are small index
writes into copies, in plain torch.

Any change the delta path cannot express in place (shape-bucket growth,
broker, rack or logdir set changes, partition deletion or non-append key
churn, RF changes, churn beyond ``analyzer.session.max.delta.fraction`` of
the epoch's replicas) triggers a rebuild, a new epoch.

The lend protocol: ``optimizer_inputs`` hands the resident state over and
sets ``self.state = None`` (torch has no buffer donation, and no copy is
made); the next sync, or ``_ensure_state``, rematerializes the state from the
host mirrors of the observed assignment through the finalize, into fresh
tensors. A round's result, and the carryover that keeps it, therefore never
shares a tensor that a later sync writes.

Fleet mode (``fleet.FleetScheduler``): ``spill`` mirrors the env to the
host and releases both device slots under the fleet's memory budget; the
next touch (``sync``, ``revalidation_view`` or ``readmit``) uploads the
mirror and rematerializes the state through the same finalize every sync
runs, so a readmitted session is bit-identical to a never-spilled one.
``bucket_floors`` (the admission engine's pad-to-join) are pad floors of
the rebuild. When a batched round stacks the session, the stack copies the
lent state, and the next sync rematerializes it as after a solo round.

The pipelined service loop (``pipeline.PipelinedServiceLoop``) syncs while
a round is in flight: the round holds the lent state, so the sync finds
``state`` None and takes the shadow slot (``shadow_syncs`` counts these).
The finalize writes the next round's state into fresh tensors and the env
writes go to copies, so the shadow never aliases what the round reads; every
thread launches on the one current stream, so the caching allocator reuses
a freed block only behind the work that read it.

Not ported yet: the mesh (ROADMAP Queue 1 item 15); it raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import logging
import re
import threading
import time

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import (
    make_env, padded_partition_table, resolve_device,
)
from cruise_control_tpu_torch.analyzer.state import state_from_assignment
from cruise_control_tpu_torch.common.tracing import tree_device_bytes
from cruise_control_tpu_torch.kernels import session_finalize
from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
from cruise_control_tpu_torch.model.delta import (
    SnapshotDelta, diff_snapshots, dirty_replica_sets, replica_slot_values,
)

LOG = logging.getLogger(__name__)

DEFAULT_MAX_DELTA_FRACTION = 0.25


def _rows_drift(rows: tuple, base: tuple | None) -> float:
    """Global relative load-row drift: max |new - base| over both [Rv, M]
    row sets, normalized by the baseline's max magnitude. inf when there is
    no baseline (or the valid-replica count changed). 0.0 iff bit-stable,
    which is what the default revalidate tolerance (0.0) requires."""
    if base is None:
        return float("inf")
    worst = 0.0
    for new, old in zip(rows, base):
        if new.shape != old.shape:
            return float("inf")
        d = float(np.abs(new - old).max()) if new.size else 0.0
        if d:
            scale = max(float(np.abs(old).max()), 1e-9)
            worst = max(worst, d / scale)
    return worst


def finalize_inputs(h: dict, device) -> tuple:
    """(broker i64[R], packed leadership u8[ceil(R / 8)], disk i64[R]) on
    ``device`` from the host mirrors of an assignment (``replica_broker``,
    ``replica_is_leader``, ``replica_disk`` numpy arrays)."""
    dev = torch.device(device)
    return (torch.tensor(np.asarray(h["replica_broker"], np.int64), device=dev),
            torch.tensor(np.packbits(np.asarray(h["replica_is_leader"], bool)),
                         device=dev),
            torch.tensor(np.asarray(h["replica_disk"], np.int64), device=dev))


def sync_finalize(env, broker, lead_packed, disk, leader_rows, follower_rows):
    """``_sync_finalize`` (session.py:102): swap in the new load rows,
    re-derive what depends on mutable inputs and materialize the engine state
    from the observed assignment: K5 for the per-replica flags, then
    ``state_from_assignment`` (``init_state``'s zeroed tallies and
    ``refresh``). Returns fresh (env, state); nothing it is given is
    written."""
    lead, off, rtexcl, dst = session_finalize(
        lead_packed, broker, disk, env.replica_topic, env.replica_valid,
        env.broker_alive, env.broker_disk_alive, env.topic_excluded,
        env.broker_excluded_for_replica_move)
    env = dataclasses.replace(env, leader_load=leader_rows, follower_load=follower_rows,
                              replica_topic_excluded=rtexcl, dst_candidate=dst)
    return env, state_from_assignment(env, broker, lead, off, disk)


def _scatter_env(env, **writes):
    """A copy of ``env`` whose named leaves are copies with ``rows`` set to
    ``values`` (``writes[name] = (rows, values)``, host arrays). Indices at
    or beyond the leaf's length are dropped (``mode="drop"``)."""
    out = {}
    for name, (rows, values) in writes.items():
        leaf = getattr(env, name)
        rows = np.asarray(rows, np.int64)
        keep = (rows >= 0) & (rows < leaf.shape[0])
        new = leaf.clone()
        if keep.any():
            vals = np.asarray(values)[keep] if np.ndim(values) else values
            new[torch.tensor(rows[keep], device=leaf.device)] = torch.as_tensor(
                vals, device=leaf.device).to(leaf.dtype)
        out[name] = new
    return dataclasses.replace(env, **out)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 {item})")


class ResidentClusterSession:
    """Owner of the device-resident (env, state) for one shape bucket.

    Thread-safe: ``sync`` and ``optimizer_inputs`` serialize on ``lock``.
    The resident state always reflects the observed cluster; proposed moves
    come back only via the backend and the next sync's deltas."""

    def __init__(self, monitor, config=None, mesh=None, device="cuda"):
        self._monitor = monitor
        self.device = resolve_device(device)
        if config is not None:
            self._max_delta_fraction = config.get_double(
                "analyzer.session.max.delta.fraction")
            self._excluded_pattern = config.get_string(
                "topics.excluded.from.partition.movement")
            self._min_leader_pattern = config.get_string(
                "topics.with.min.leaders.per.broker")
            self._donation = config.get_boolean("analyzer.session.donation")
            self._track_deltas = config.get_boolean("analyzer.incremental.enabled")
            if (mesh is None and config.get_boolean("tpu.shard.map")
                    and config.get_int("tpu.mesh.axis.brokers") > 1):
                _not_ported("a mesh-resident session", "item 15")
        else:
            self._max_delta_fraction = DEFAULT_MAX_DELTA_FRACTION
            self._excluded_pattern = ""
            self._min_leader_pattern = ""
            self._donation = True
            self._track_deltas = True
        if mesh is not None:
            _not_ported("a mesh-resident session", "item 15")
        self.mesh = None
        self.lock = threading.RLock()
        self.env = None
        self.state = None
        self.meta = None
        self.part_table: np.ndarray | None = None    # host [Pp, F] mirror
        # host mirrors of the observed padded assignment
        self._h: dict[str, np.ndarray] = {}
        self._rep_part: np.ndarray | None = None     # i64[R_valid] CSR links
        self._broker_mirror: dict[str, np.ndarray] = {}
        self._prev_snapshot = None
        self._epoch_replicas = 0
        self._cum_churn = 0
        self.epoch = 0
        self.rebuild_rounds = 0
        self.delta_rounds = 0
        self.donated_rounds = 0        # rounds served the resident state lent
        self.last_sync_info: dict = {}
        self.sync_generation = 0
        # syncs that ran while the state was lent to an in-flight round
        self.shadow_syncs = 0
        self._sync_key: tuple | None = None
        # fleet spill/readmit: the host env mirror while spilled
        self._spilled_env = None
        self.spills = 0
        self.readmits = 0
        # the pad-to-join floors of fleet admission (pad_cluster's min_*)
        self.bucket_floors: dict | None = None
        # incremental carryover (optimizer.IncrementalCarryover) and what
        # changed since the last optimize round consumed it
        self.carryover = None
        self._round_delta = self._fresh_round_delta()
        self._load_baseline = None     # (lead, foll) rows the carryover reflects
        self._last_rows = None         # (lead, foll) rows of the last refresh
        self.revalidated_rounds = 0

    # ------------------------------------------------------------- public
    def sync(self, allow_capacity_estimation: bool = True) -> dict:
        """Bring the resident state up to the monitor's latest windows and
        the backend's latest metadata. Returns {"mode": "delta"|"rebuild",
        ...}; raises NotEnoughValidWindowsError before any window exists."""
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        with self.lock:
            t0 = time.monotonic()
            mon = self._monitor
            agg = mon._partition_agg.aggregate()
            if not agg.window_starts_ms:
                raise NotEnoughValidWindowsError("0 valid windows < required 1")
            snap = mon._snapshot()
            if self.env is None and self._spilled_env is not None:
                # a spilled tenant touched again: readmit, then the delta path
                self._readmit_locked()
            if self.env is None:
                return self._rebuild("cold start", allow_capacity_estimation)
            # sync memo: unchanged (metadata, windows) since the last sync
            key = (snap.generation, mon._partition_agg.generation)
            if key == self._sync_key:
                self._ensure_state()
                return {
                    "mode": "delta",
                    "epoch": self.epoch,
                    "churn": 0,
                    "cum_churn_fraction": round(
                        self._cum_churn / max(self._epoch_replicas, 1), 4),
                    "sync_s": round(time.monotonic() - t0, 4),
                    "memo": True,
                }
            if self.state is None:
                # shadow slot: the resident state is lent to an in-flight
                # round; everything below lands in fresh tensors
                self.shadow_syncs += 1
            delta = None
            if snap.generation != self._prev_snapshot.generation:
                delta = diff_snapshots(self._prev_snapshot, snap)
                reason = self._delta_blocker(snap, delta)
                if reason is None:
                    reason = self._refresh_brokers(allow_capacity_estimation)
                if reason is not None:
                    return self._rebuild(reason, allow_capacity_estimation)
                self._apply_topology_delta(snap, delta)
                if self._track_deltas and not delta.is_noop:
                    dirty = dirty_replica_sets(self._prev_snapshot, snap, delta)
                    rd = self._round_delta
                    rd["churn"] += delta.churn
                    rd["dirty_brokers"].update(int(b) for b in dirty["brokers"])
                    rd["dirty_topics"].update(int(t) for t in dirty["topics"])
                self._cum_churn += delta.churn
                self._prev_snapshot = snap
            self._refresh_metrics(agg, snap)
            if self._track_deltas:
                self._round_delta["syncs"] += 1
            self.delta_rounds += 1
            self._sync_key = key
            self.sync_generation += 1
            info = {
                "mode": "delta",
                "epoch": self.epoch,
                "churn": 0 if delta is None else delta.churn,
                "cum_churn_fraction": round(
                    self._cum_churn / max(self._epoch_replicas, 1), 4),
                "sync_s": round(time.monotonic() - t0, 4),
            }
            self.last_sync_info = info
            return info

    def optimizer_inputs(self) -> tuple:
        """(env, state, meta, part_table, initial_broker, initial_leader,
        initial_disk, host_valid, host_partition) for
        ``GoalOptimizer.optimizations(session=...)``.

        The lend protocol (``analyzer.session.donation``, default on): the
        resident state itself is handed over and the session drops it; the
        next sync rematerializes it. With donation off, a copy is returned
        and the session keeps its own."""
        with self.lock:
            self._ensure_state()
            if self._donation:
                st = self.state
                self.state = None
                self.donated_rounds += 1
            else:
                st = dataclasses.replace(self.state, **{
                    f.name: getattr(self.state, f.name).clone()
                    for f in dataclasses.fields(self.state)})
            # host arrays are copied: a later sync's delta writes must not
            # race a round still diffing proposals
            return (self.env, st, self.meta, self.part_table.copy(),
                    self._h["replica_broker"].copy(),
                    self._h["replica_is_leader"].copy(),
                    self._h["replica_disk"].copy(),
                    self._h["replica_valid"].copy(),
                    self._h["replica_partition"].copy())

    def invalidate(self) -> None:
        """Force the next sync to rebuild (new epoch)."""
        with self.lock:
            self.env = None
            self.state = None
            self._spilled_env = None
            self._sync_key = None
            self.carryover = None
            self._load_baseline = None

    # ------------------------------------------------ incremental carryover
    def _fresh_round_delta(self) -> dict:
        return {"churn": 0, "syncs": 0, "dirty_brokers": set(),
                "dirty_topics": set(), "broker_flips": False,
                "load_drift": 0.0, "rebuilt": False}

    def consume_round_delta(self) -> dict:
        """Everything that changed since the last optimize round consumed
        this accumulator: structural churn, dirty broker / topic index sets,
        broker-axis flips, load-row drift against the carried round's
        baseline (inf: no baseline) and whether an epoch rebuild happened."""
        with self.lock:
            rd = self._round_delta
            self._round_delta = self._fresh_round_delta()
            return rd

    def note_carryover(self, carryover, taken_generation=None) -> None:
        """Persist a full or reduced round's carryover. When a sync landed
        between the round taking its inputs (``taken_generation``) and now,
        the last-refreshed rows are not the rows the round optimized, so the
        drift baseline is dropped."""
        with self.lock:
            self.carryover = carryover
            if (taken_generation is not None
                    and taken_generation != self.sync_generation):
                self._load_baseline = None
            else:
                self._load_baseline = self._last_rows

    def revalidation_view(self) -> tuple:
        """(env, state) for the certificate re-check: the resident state is
        peeked (rematerialized if lent or spilled), never taken."""
        with self.lock:
            if self.env is None and self._spilled_env is not None:
                self._readmit_locked()
            self._ensure_state()
            return self.env, self.state

    def note_revalidated(self) -> None:
        with self.lock:
            self.revalidated_rounds += 1

    def seed_budget_replicas(self, num_replicas: int) -> float:
        """The churn ceiling, in replicas, under which a round's structural
        churn still qualifies for dirty-set seeding and certificate
        carryover."""
        return self._max_delta_fraction * max(num_replicas, 1)

    def dirty_replica_mask(self, dirty_brokers, dirty_topics) -> np.ndarray:
        """bool[R_padded]: replicas on a dirty broker or in a dirty topic,
        the reduced round's candidate seed. Broker values are padded
        broker-axis indices (the sorted broker ids are the padded axis'
        prefix); topics resolve through replica_partition and the latest
        snapshot's partition_topic (the padded partition order keeps the
        snapshot's sorted keys as its prefix). Padding slots are excluded."""
        with self.lock:
            rb = self._h["replica_broker"]
            rp = self._h["replica_partition"]
            valid = self._h["replica_valid"]
            mask = np.zeros(rb.shape[0], bool)
            if dirty_brokers:
                mask |= np.isin(rb, np.fromiter(dirty_brokers, np.int64,
                                                len(dirty_brokers)))
            if dirty_topics and self._prev_snapshot is not None:
                pt = np.asarray(self._prev_snapshot.partition_topic)
                if pt.size:
                    safe = np.clip(rp, 0, pt.size - 1)
                    topic_of = np.where((rp >= 0) & (rp < pt.size), pt[safe], -1)
                    mask |= np.isin(topic_of, np.fromiter(dirty_topics, np.int64,
                                                          len(dirty_topics)))
            return mask & valid

    # ------------------------------------------------- fleet spill/readmit
    @property
    def spilled(self) -> bool:
        return self._spilled_env is not None

    def spill(self) -> bool:
        """session.py:550: reclaim this tenant's device footprint (the
        fleet's memory budget): mirror the env to the host and drop both
        device slots. The observed assignment already lives in the host
        mirrors, so the next readmit's finalize rebuilds the state bit for
        bit. No-op while cold or already spilled; returns whether a spill
        happened."""
        with self.lock:
            if self.env is None:
                return False
            self._ensure_state()     # a lent state is observed first, as a sync would
            self._spilled_env = {
                f.name: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
                for f in dataclasses.fields(self.env)
                for v in (getattr(self.env, f.name),)}
            self.env = None
            self.state = None
            self.spills += 1
            return True

    def readmit(self) -> bool:
        """Re-admit a spilled session: upload the host env mirror and
        rematerialize the state through the finalize (``sync`` does this
        implicitly). Returns whether a readmission happened."""
        with self.lock:
            if self._spilled_env is None:
                return False
            self._readmit_locked()
            return True

    def _readmit_locked(self) -> None:
        host_env = self._spilled_env
        self._spilled_env = None
        from cruise_control_tpu_torch.analyzer.env import ClusterEnv
        self.env = ClusterEnv(**{
            k: (v.to(self.device) if isinstance(v, torch.Tensor) else v)
            for k, v in host_env.items()})
        self._materialize(self.env.leader_load, self.env.follower_load)
        self.readmits += 1

    def pending_delta_json(self) -> dict:
        """session.py:590: what the next optimize round's round delta holds."""
        rd = self._round_delta
        return {"churn": rd["churn"], "syncs": rd["syncs"],
                "dirtyBrokers": len(rd["dirty_brokers"]),
                "dirtyTopics": len(rd["dirty_topics"]),
                "brokerFlips": rd["broker_flips"], "loadDrift": rd["load_drift"],
                "rebuilt": rd["rebuilt"]}

    def state_json(self) -> dict:
        """session.py:605, served under the facade's AnalyzerState."""
        return {"epoch": self.epoch, "rebuildRounds": self.rebuild_rounds,
                "deltaRounds": self.delta_rounds,
                "donatedRounds": self.donated_rounds,
                "shadowSyncs": self.shadow_syncs,
                "syncGeneration": self.sync_generation, "spilled": self.spilled,
                "spills": self.spills, "readmits": self.readmits,
                "revalidatedRounds": self.revalidated_rounds,
                "carryover": self.carryover is not None,
                "pendingDelta": self.pending_delta_json(),
                "lastSync": dict(self.last_sync_info)}

    def device_bytes(self) -> dict:
        """Resident device footprint {env_bytes, state_bytes}: the sums of
        the tensors' ``nbytes``; a lent state reads 0."""
        with self.lock:
            return {"env_bytes": tree_device_bytes(self.env),
                    "state_bytes": tree_device_bytes(self.state)}

    # ------------------------------------------------ state materialization
    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Host -> device upload into a fresh tensor (a copy even on the CPU,
        so no host buffer is ever shared with a resident leaf)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def _ensure_state(self) -> None:
        """Rematerialize the resident state from the host mirrors if the
        last round took it; no-op when resident."""
        if self.state is None and self.env is not None:
            self._materialize(self.env.leader_load, self.env.follower_load)

    def _materialize(self, leader_rows, follower_rows) -> None:
        """The finalize: observed assignment (leadership bit-packed) + load
        rows -> fresh resident (env, state)."""
        broker, lead_packed, disk = finalize_inputs(self._h, self.device)
        self.env, self.state = sync_finalize(self.env, broker, lead_packed, disk,
                                             leader_rows, follower_rows)

    # ----------------------------------------------------------- fallback
    def _delta_blocker(self, snap, delta: SnapshotDelta) -> str | None:
        """Why this delta cannot be applied in place (None = it can)."""
        if not delta.compatible:
            return delta.reason
        env = self.env
        if delta.num_replicas_after > env.num_replicas:
            return "replica pad slots exhausted"
        if delta.num_partitions_after > env.num_partitions:
            return "partition pad slots exhausted"
        if delta.num_topics_after > int(env.topic_excluded.shape[0]):
            return "topic pad slots exhausted"
        if delta.num_partitions_after > delta.num_partitions_before:
            nrep_app = np.diff(snap.rep_ptr[delta.num_partitions_before:])
            if nrep_app.size and int(nrep_app.max()) > env.max_rf:
                return "membership-table width exceeded"
        if (self._cum_churn + delta.churn
                > self._max_delta_fraction * max(self._epoch_replicas, 1)):
            return (f"churn budget exceeded "
                    f"({self._cum_churn + delta.churn} slots "
                    f"> {self._max_delta_fraction:.2f} of "
                    f"{self._epoch_replicas})")
        return None

    # ------------------------------------------------------------ rebuild
    def _rebuild(self, reason: str, allow_capacity_estimation: bool) -> dict:
        t0 = time.monotonic()
        mon = self._monitor
        # the model must correspond to ONE metadata generation: retry if a
        # concurrent mutator bumped it mid-build
        for _ in range(4):
            snap = mon._snapshot()
            ct, meta = mon.cluster_model(
                allow_capacity_estimation=allow_capacity_estimation)
            if mon._snapshot().generation == snap.generation:
                break
        ct = self._apply_excluded_pattern(ct, meta)
        ct, meta = pad_cluster(ct, meta, **(self.bucket_floors or {}))
        part_table = padded_partition_table(ct)
        tml = self._tml_mask(meta, ct.num_topics)
        env = make_env(ct, meta, topic_min_leaders_mask=tml,
                       partition_table=part_table, device=self.device)
        self.env = env
        # session-owned meta: appended partitions/topics extend these lists
        self.meta = dataclasses.replace(
            meta, topic_names=list(meta.topic_names),
            partition_ids=list(meta.partition_ids))
        self.part_table = np.ascontiguousarray(part_table)
        self._h = {
            "replica_broker": np.asarray(ct.replica_broker, np.int32).copy(),
            "replica_is_leader": np.asarray(ct.replica_is_leader, bool).copy(),
            "replica_disk": np.asarray(ct.replica_disk, np.int32).copy(),
            "replica_valid": np.asarray(ct.replica_valid, bool).copy(),
            "replica_partition": np.asarray(ct.replica_partition, np.int32).copy(),
        }
        # the epoch's state comes from the finalize every later sync runs
        self._materialize(env.leader_load, env.follower_load)
        Rv = meta.num_valid_replicas
        self._rep_part = self._h["replica_partition"][:Rv].astype(np.int64)
        self._broker_mirror = {name: np.asarray(getattr(ct, name)).copy()
                               for name, _ in self._BROKER_FIELDS}
        self._prev_snapshot = snap
        self._epoch_replicas = Rv
        self._cum_churn = 0
        # an epoch rebuild invalidates the incremental carryover: the padded
        # shapes, slot order and broker axis may all have changed
        self.carryover = None
        self._load_baseline = None
        self._last_rows = None
        self._round_delta = self._fresh_round_delta()
        self._round_delta["rebuilt"] = True
        self.epoch += 1
        self.rebuild_rounds += 1
        self._sync_key = (snap.generation, mon._partition_agg.generation)
        self.sync_generation += 1
        info = {
            "mode": "rebuild",
            "reason": reason,
            "epoch": self.epoch,
            "shape": {"replicas": env.num_replicas,
                      "brokers": env.num_brokers,
                      "partitions": env.num_partitions,
                      "topics": int(env.topic_excluded.shape[0]),
                      "max_rf": env.max_rf},
            "sync_s": round(time.monotonic() - t0, 4),
        }
        self.last_sync_info = info
        LOG.info("resident session rebuild (epoch %d): %s", self.epoch, reason)
        return info

    def _apply_excluded_pattern(self, ct, meta):
        """topics.excluded.from.partition.movement applies to every
        session-served optimization."""
        if not self._excluded_pattern:
            return ct
        rx = re.compile(self._excluded_pattern)
        excl = np.asarray(ct.topic_excluded).copy()
        for i, name in enumerate(meta.topic_names):
            if rx.fullmatch(name):
                excl[i] = True
        return dataclasses.replace(ct, topic_excluded=excl)

    def _tml_mask(self, meta, padded_T: int):
        if not self._min_leader_pattern:
            return None
        rx = re.compile(self._min_leader_pattern)
        m = np.asarray([bool(rx.fullmatch(t)) for t in meta.topic_names], bool)
        if m.shape[0] < padded_T:
            m = np.pad(m, (0, padded_T - m.shape[0]))
        return m

    def _topic_flags(self, name: str) -> tuple[bool, bool]:
        """(excluded, min_leaders) flags an appended topic gets."""
        excl = bool(self._excluded_pattern
                    and re.fullmatch(self._excluded_pattern, name))
        tml = bool(self._min_leader_pattern
                   and re.fullmatch(self._min_leader_pattern, name))
        return excl, tml

    # ------------------------------------------------------- broker axis
    @staticmethod
    def _pad_b(a: np.ndarray, Bp: int, fill) -> np.ndarray:
        if a.shape[0] == Bp:
            return np.asarray(a)
        width = [(0, Bp - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(np.asarray(a), width, constant_values=fill)

    _BROKER_FIELDS = (
        # (ClusterEnv field, pad fill): pad brokers are dead, excluded and
        # of zero capacity (pad_cluster's fills)
        ("broker_capacity", 0.0), ("broker_rack", 0), ("broker_alive", False),
        ("broker_new", False), ("broker_demoted", False),
        ("broker_excluded_for_replica_move", True),
        ("broker_excluded_for_leadership", True),
        ("broker_disk_capacity", 0.0), ("broker_disk_alive", False),
    )

    def _refresh_brokers(self, allow_capacity_estimation: bool) -> str | None:
        """Recompute the broker-axis arrays exactly as the model build would
        and upload the changed ones; returns a rebuild reason when the change
        is structural (broker, rack or logdir set)."""
        from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
        mon = self._monitor
        brokers = mon._backend.brokers()
        builder = ClusterModelBuilder()
        lds_by_broker, _dead = mon.populate_brokers(
            builder, brokers, allow_capacity_estimation=allow_capacity_estimation)
        broker_ids = sorted(brokers)
        if broker_ids != self.meta.broker_ids:
            return "broker set changed"
        racks = sorted({s.rack for s in builder._brokers.values()})
        if racks != self.meta.rack_ids:
            return "rack set changed"
        if [lds_by_broker[b] for b in broker_ids] != self.meta.logdirs:
            return "logdir layout changed"
        ridx = {r: i for i, r in enumerate(racks)}
        (cap, rack, alive, new, demoted, excl_move, excl_lead,
         disk_cap, disk_alive, _lds) = builder.broker_arrays(broker_ids, ridx)
        Bp = self.env.num_brokers
        D = int(self.env.broker_disk_capacity.shape[1])
        if disk_cap.shape[1] != D:
            return "disk-axis width changed"
        dense = dict(zip((n for n, _ in self._BROKER_FIELDS),
                         (cap, rack, alive, new, demoted, excl_move,
                          excl_lead, disk_cap, disk_alive)))
        changed = {}
        flipped: set = set()
        for name, fill in self._BROKER_FIELDS:
            padded = self._pad_b(dense[name], Bp, fill)
            old = self._broker_mirror[name]
            if not np.array_equal(padded, old):
                changed[name] = padded
                if self._track_deltas:
                    neq = padded != old
                    if neq.ndim > 1:
                        neq = neq.any(axis=tuple(range(1, neq.ndim)))
                    flipped.update(int(b) for b in np.flatnonzero(neq))
        if changed:
            if self._track_deltas:
                # a broker-axis flip changes goal inputs globally: it blocks
                # re-validation and marks the flipped brokers dirty
                rd = self._round_delta
                rd["broker_flips"] = True
                rd["dirty_brokers"].update(flipped)
            self._broker_mirror.update(changed)
            self.env = dataclasses.replace(
                self.env, **{name: self._put(a).to(getattr(self.env, name).dtype)
                             for name, a in changed.items()})
        return None

    # ------------------------------------------------------ replica churn
    def _apply_topology_delta(self, snap, delta: SnapshotDelta) -> None:
        """Apply churn and appends to the env (index writes into copies) and
        to the host assignment mirrors; the state side is rematerialized from
        the mirrors by the finalize."""
        env = self.env
        D = int(env.broker_disk_capacity.shape[1])
        sorted_bids = np.asarray(self.meta.broker_ids, np.int64)
        h = self._h
        if delta.num_changed:
            slots = delta.changed_slots
            vals = replica_slot_values(snap, slots, sorted_bids, D)
            # churned replicas re-anchor their original broker (a rebuild
            # sets original := current)
            env = _scatter_env(env, replica_original_broker=(slots, vals["broker"]))
            h["replica_broker"][slots] = vals["broker"]
            h["replica_disk"][slots] = vals["disk"]
            h["replica_is_leader"][slots] = vals["leader"]
        if delta.num_appended_replicas or (
                delta.num_partitions_after > delta.num_partitions_before):
            p_lo, p_hi = delta.num_partitions_before, delta.num_partitions_after
            r_lo, r_hi = delta.num_replicas_before, delta.num_replicas_after
            slots = np.arange(r_lo, r_hi, dtype=np.int64)
            vals = replica_slot_values(snap, slots, sorted_bids, D)
            nrep_app = np.diff(snap.rep_ptr[p_lo:p_hi + 1])
            rep_part_new = np.repeat(np.arange(p_lo, p_hi, dtype=np.int64), nrep_app)
            topic_of_new = snap.partition_topic[rep_part_new]
            # appended membership-table rows: rank of each new replica within
            # its partition
            starts = snap.rep_ptr[p_lo:p_hi] - r_lo
            rank = np.arange(r_hi - r_lo) - np.repeat(starts, nrep_app)
            prow_vals = np.full((p_hi - p_lo, env.max_rf), -1, np.int32)
            prow_vals[rep_part_new - p_lo, rank] = slots
            # appended topics: exclusion / min-leaders flags from the
            # configured patterns (what a rebuild would compute)
            t_lo, t_hi = delta.num_topics_before, delta.num_topics_after
            new_topics = list(snap.topics[t_lo:t_hi])
            flags = [self._topic_flags(t) for t in new_topics]
            tidx = np.arange(t_lo, t_hi, dtype=np.int64)
            prows = np.arange(p_lo, p_hi, dtype=np.int64)
            env = _scatter_env(
                env,
                replica_partition=(slots, rep_part_new),
                replica_topic=(slots, topic_of_new),
                replica_valid=(slots, np.ones(slots.shape[0], bool)),
                replica_original_broker=(slots, vals["broker"]),
                partition_replicas=(prows, prow_vals),
                partition_topic=(prows, snap.partition_topic[p_lo:p_hi]),
                topic_excluded=(tidx, np.asarray([f[0] for f in flags], bool)),
                topic_min_leaders=(tidx, np.asarray([f[1] for f in flags], bool)))
            h["replica_broker"][slots] = vals["broker"]
            h["replica_disk"][slots] = vals["disk"]
            h["replica_is_leader"][slots] = vals["leader"]
            h["replica_valid"][slots] = True
            h["replica_partition"][slots] = rep_part_new.astype(np.int32)
            self.part_table[p_lo:p_hi] = prow_vals
            self._rep_part = np.concatenate([self._rep_part, rep_part_new])
            self.meta.partition_ids.extend(snap.partition_keys[p_lo:p_hi])
            self.meta.topic_names.extend(new_topics)
            self.meta.num_valid_replicas = r_hi
        self.env = env

    # ------------------------------------------------------ metric refresh
    def _refresh_metrics(self, agg, snap) -> None:
        """Per-sync metric-window refresh: the [R, M] load rows from the
        monitor code the full build runs, uploaded into fresh tensors, then
        the finalize (which also rematerializes a lent state)."""
        mon = self._monitor
        cols = mon.partition_load_columns(snap.partition_keys, snap.generation, agg=agg)
        lead, foll = mon.replica_load_rows(cols, self._rep_part)
        if self._track_deltas:
            # drift against the rows the carried round optimized
            rd = self._round_delta
            rd["load_drift"] = max(rd["load_drift"],
                                   _rows_drift((lead, foll), self._load_baseline))
            self._last_rows = (lead.copy(), foll.copy())
        Rp = self.env.num_replicas
        Rv = lead.shape[0]
        lead_p = np.zeros((Rp, lead.shape[1]), np.float32)
        foll_p = np.zeros((Rp, foll.shape[1]), np.float32)
        lead_p[:Rv] = lead
        foll_p[:Rv] = foll
        self._materialize(self._put(lead_p), self._put(foll_p))
