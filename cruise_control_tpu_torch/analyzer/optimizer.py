"""GoalOptimizer: prioritized sequential multi-goal optimization
(counterpart of ``cruise_control_tpu/analyzer/optimizer.py``).

Reference: analyzer/GoalOptimizer.java:417 ``optimizations(...)``: for each
goal in priority order run the goal with the previously optimized goals'
acceptance in force, then diff the initial vs final assignment into
proposals.

The port serves the reference's three shapes of the chain:

- padded R < ``analyzer.finisher.min.replicas`` (8,192): the unfused
  per-goal chain, finisher compiled out;
- 8,192 <= padded R < ``analyzer.fused.chain.min.replicas`` (65,536): the
  unfused chain, every goal through the chunked dispatch and the finisher;
- padded R >= 65,536: the fused prefix (every goal up to the first
  deep-tail goal, no finisher), then each deep-tail goal through the
  chunked dispatch and the finisher.

A request naming ``PreferredLeaderElectionGoal`` runs the chain of the
other goals (possibly none, as ``/demote_broker`` asks), then the
preferred-leader pass (K12, ``goals/leader_election.py``) in every shape,
and reports it last. After that, certificate-driven escalation re-enters the
finisher of a goal that exited violated and unproven with few actions left
(its moves, transfers and swap window counted). The intra-broker disk goals
run as chain goals with the disk branch (K8). At padded R >= 262,144
"auto" resolves the precision policy to bf16 (``_resolve_compute_dtype``;
the engine's ``_sweep_env``). A hard-goal failure raises
``OptimizationFailureError`` with the result's provision recommendation.

``GoalOptimizer(config=...)`` reads every knob the reference's constructor
reads (``config.cruise_control_config``). ``optimizations(None,
session=...)`` is the resident-session service round (optimizer.py:714-1378):
it consumes the session's round delta, tries the whole-round certificate
memo (``_revalidated_round``: one verdict pass against the carried round's
start verdicts), and otherwise runs the chain from the session's lent state,
with dirty-set seed masks for the goals a reduced round may confine (K1's
seed mask, ``analyzer.incremental.seed.dirty``), the chain short-circuit of
an untouched reduced goal (K13), churn-adaptive budgets, the
certificate-gated finisher skip and the full-R repair sweep after a seeded
chain (``_reseed_fallback``). Every round, solo, revalidated or batched,
records its ``RoundTrace`` on the flight recorder
(``common.tracing.FlightRecorder.record_round``; ``result.round_trace``),
before a hard-goal failure raises. ``measure_goal_durations=True`` runs the
per-goal dispatch (no fused prefix, no chunking, no memo) and synchronizes
the device after each goal so ``duration_s`` is the goal's own wall.
"""
from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.engine import (
    EngineParams, _goal_finish, _goal_loop, _info, check_supported, goal_probe,
    optimize_goal, optimize_goal_chunked, passes_skipped,
)
from cruise_control_tpu_torch.analyzer.env import (
    BalancingConstraint, ClusterEnv, OptimizationOptions, make_env,
    padded_partition_table, resolve_device,
)
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.analyzer.lanes import (
    LaneStack, fleet_goal_loop, probe_lanes, read_values,
)
from cruise_control_tpu_torch.analyzer.goals.leader_election import (
    PreferredLeaderElectionGoal,
)
from cruise_control_tpu_torch.analyzer.proposals import diff_proposals
from cruise_control_tpu_torch.analyzer.state import EngineState, init_state
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.config.defaults import DEFAULT_GOALS, DEFAULT_HARD_GOALS
from cruise_control_tpu_torch.detector.provisioner import (
    ProvisionFloors, recommendation_from_result,
)
from cruise_control_tpu_torch.model.cluster_tensor import (
    ClusterMeta, ClusterTensor, broker_index_dtype, disk_index_dtype, pad_cluster,
)

BALANCEDNESS_PRIORITY_WEIGHT = 1.1
BALANCEDNESS_STRICTNESS_WEIGHT = 1.5
BF16_AUTO_MIN_REPLICAS = 262_144
FUSED_MIN_REPLICAS = 65_536      # analyzer.fused.chain.min.replicas default
FINISHER_MIN_REPLICAS = 8192     # analyzer.finisher.min.replicas default
CHUNK_MIN_REPLICAS = 8192        # analyzer.pass.chunk.min.replicas default

_NO_GOAL_RUN = {"iterations": 0, "passes": 0, "violated_after": False,
                "hit_max_iters": False, "plateau_exit": False,
                "fixpoint_proven": False, "finisher_rounds": 0,
                "moves_remaining": -1, "leads_remaining": -1,
                "swap_window_remaining": -1, "move_actions": 0, "lead_actions": 0,
                "swap_actions": 0, "disk_actions": 0, "move_waves": 0,
                "finisher_actions": 0, "finisher_segments": 0,
                "finisher_boundary": 0, "passes_skipped": 0, "quiesce_chunk": -1,
                "finisher_skipped": False}


def _resolve_compute_dtype(pinned: str, num_replicas: int,
                           config_dtype: str | None = None) -> str:
    """The reference's precision policy: an explicit
    ``EngineParams.compute_dtype`` wins, then an explicit
    ``analyzer.compute.dtype``; "auto" is bf16 at >= 256k replicas."""
    if pinned != "auto":
        return pinned
    if config_dtype in ("float32", "bfloat16"):
        return config_dtype
    return "bfloat16" if num_replicas >= BF16_AUTO_MIN_REPLICAS else "float32"


class OptimizationFailureError(Exception):
    """A hard goal could not be satisfied. ``recommendation`` is the
    ``detector.provisioner.ProvisionRecommendation`` of the result (the
    reference's OptimizationFailureException carries one)."""

    def __init__(self, message: str, recommendation=None, result=None):
        super().__init__(message)
        self.recommendation = recommendation
        self.result = result


@dataclasses.dataclass
class GoalResult:
    name: str
    violated_before: bool
    violated_after: bool
    iterations: int               # actions applied
    duration_s: float
    stat_after: float
    hit_max_iters: bool = False   # budget exhausted, still violated, unproven
    passes: int = 0               # budgeted-loop passes
    stat_before: float = 0.0
    fixpoint_proven: bool = False
    moves_remaining: int = -1     # -1 = finisher did not run
    leads_remaining: int = -1
    swap_window_remaining: int = -1
    finisher_rounds: int = 0
    plateau_exit: bool = False
    move_actions: int = 0
    lead_actions: int = 0
    swap_actions: int = 0
    disk_actions: int = 0
    move_waves: int = 0
    finisher_actions: int = 0
    finisher_segments: int = 0
    finisher_boundary: int = 0
    escalations: int = 0
    passes_skipped: int = 0
    quiesce_chunk: int = -1
    finisher_skipped: bool = False
    mode: str = "full"


@dataclasses.dataclass
class OptimizerResult:
    """Reference: analyzer/OptimizerResult.java."""
    goal_results: list[GoalResult]
    proposals: object
    stats_before: dict
    stats_after: dict
    balancedness_before: float
    balancedness_after: float
    num_replica_movements: int = 0
    num_leadership_movements: int = 0
    data_to_move_mb: float = 0.0
    durations_measured: bool = False
    round_mode: str = "full"
    revalidate_s: float = 0.0
    fallback_goals: int = 0
    passes_dispatched: int = 0
    passes_skipped: int = 0
    early_exit_goals: int = 0
    skipped_goals: int = 0
    parked_early: bool = False
    compacted_out: bool = False
    final_state: EngineState | None = None
    env: ClusterEnv | None = None
    meta: ClusterMeta | None = None
    round_trace: object = None    # common.tracing.RoundTrace of the round

    @property
    def violated_goals_before(self) -> list[str]:
        return [g.name for g in self.goal_results if g.violated_before]

    @property
    def violated_goals_after(self) -> list[str]:
        return [g.name for g in self.goal_results if g.violated_after]

    def to_json(self) -> dict:
        """optimizer.py:192: the reference's OptimizationResult schema
        (``api.responses.optimization_result_json``) with the violated-goal
        lists and the per-goal counters as extension fields."""
        from cruise_control_tpu_torch.api.responses import optimization_result_json
        out = optimization_result_json(
            self,
            num_windows=getattr(self, "num_windows", 1),
            monitored_partitions_pct=getattr(self, "monitored_partitions_pct",
                                             1.0))
        out["summary"]["violatedGoalsBefore"] = self.violated_goals_before
        out["summary"]["violatedGoalsAfter"] = self.violated_goals_after
        if self.passes_dispatched or self.passes_skipped:
            out["summary"]["passesDispatched"] = self.passes_dispatched
            out["summary"]["passesSkipped"] = self.passes_skipped
            out["summary"]["earlyExitGoals"] = self.early_exit_goals
            out["summary"]["skippedGoals"] = self.skipped_goals
        if self.parked_early or self.compacted_out:
            out["summary"]["parkedEarly"] = self.parked_early
            out["summary"]["compactedOut"] = self.compacted_out
        for g, entry in zip(self.goal_results, out["goalSummary"]):
            entry["iterations"] = g.iterations
            entry["budgetExhausted"] = g.hit_max_iters
            if g.escalations:
                entry["escalations"] = g.escalations
            if g.violated_after:
                entry["fixpointProven"] = g.fixpoint_proven
                if g.moves_remaining >= 0:
                    entry["actionsRemaining"] = {
                        "moves": g.moves_remaining,
                        "leaderships": g.leads_remaining,
                        "swapWindow": g.swap_window_remaining}
        return out


@dataclasses.dataclass
class IncrementalCarryover:
    """One completed full or reduced round's verdicts and result, kept on
    the ``ResidentClusterSession`` (optimizer.py:231): the certificate memo
    returns ``result`` re-stamped when nothing relevant changed since, and
    dirty-set seeding keys the next reduced round off ``violated_after``.
    ``result.final_state`` is the one device state it pins. The session
    clears it on every rebuild and invalidate."""
    chain_key: tuple        # (goal-name tuple, options repr)
    violated_before: tuple  # bool per chain goal at round start
    violated_after: dict    # name -> bool at round end
    proven: dict            # name -> fixpoint_proven at round end
    result: object          # the carried OptimizerResult


def _balancedness(goals, results_violated: dict,
                  priority_weight: float = BALANCEDNESS_PRIORITY_WEIGHT,
                  strictness_weight: float = BALANCEDNESS_STRICTNESS_WEIGHT) -> float:
    """Weighted fraction of satisfied goals; hard goals weigh strictness x
    priority more."""
    total = 0.0
    got = 0.0
    weight = 1.0
    for g in reversed(goals):
        w = weight * (strictness_weight if g.is_hard else 1.0)
        total += w
        if not results_violated.get(g.name, False):
            got += w
        weight *= priority_weight
    return 100.0 * got / total if total else 100.0


def _budget_scale(num_replicas: int) -> int:
    """How many times cheaper a pass is than at 512k replicas; floors at 1."""
    return max(1, (512 * 1024) // max(num_replicas, 1024))


def violations(goals, env: ClusterEnv, st: EngineState) -> list[bool]:
    """Every goal's verdict in one device->host read (``_compiled_violations``)."""
    if not goals:
        return []
    return [bool(v) for v in torch.stack([g.violated(env, st) for g in goals]).tolist()]


def _stats_device(env: ClusterEnv, st: EngineState) -> dict:
    """ClusterModelStats reductions over alive brokers (AVG/MAX/MIN/STD)."""
    alive = env.broker_alive
    n = torch.clamp(alive.to(torch.float32).sum(), min=1.0)

    def four_masked(a, mask, nm):
        a = a.to(torch.float32)
        zero = torch.zeros_like(a)
        any_m = mask.any()
        s = torch.where(mask, a, zero).sum() / nm
        mx = torch.where(any_m, torch.where(mask, a, zero - torch.inf).max(), 0.0)
        mn = torch.where(any_m, torch.where(mask, a, zero + torch.inf).min(), 0.0)
        var = torch.where(mask, (a - s) ** 2, zero).sum() / nm
        return dict(avg=s, max=mx, min=mn, std=torch.sqrt(var))

    per_res = [four_masked(st.util[:, r], alive, n) for r in range(4)]
    util = {k: [per_res[r][k] for r in range(4)] for k in ("avg", "max", "min", "std")}
    tbc = torch.where(alive[None, :], st.topic_broker_count, 0)
    real = tbc.sum(dim=1) > 0
    nt = torch.clamp(real.sum().to(torch.float32), min=1.0)
    tmask = real[:, None] & alive[None, :]
    return {
        "util": util,
        "rc": four_masked(st.replica_count, alive, n),
        "lc": four_masked(st.leader_count, alive, n),
        "pot": four_masked(st.potential_nw_out, alive, n),
        "trc": four_masked(tbc.reshape(-1), tmask.reshape(-1), nt * n),
        "num_offline": (st.replica_offline & env.replica_valid).sum(),
        "num_brokers": alive.sum(),
        "num_replicas": env.replica_valid.sum(),
        "num_topics": real.sum(),
    }


def _stats_to_json(d) -> dict:
    def four(x):
        return {k: float(v) for k, v in x.items()}

    return {
        "avg": [float(x) for x in d["util"]["avg"]],
        "max": [float(x) for x in d["util"]["max"]],
        "min": [float(x) for x in d["util"]["min"]],
        "std": [float(x) for x in d["util"]["std"]],
        "replica_count_avg": float(d["rc"]["avg"]),
        "replica_count_max": int(d["rc"]["max"]),
        "replica_count_min": int(d["rc"]["min"]),
        "replica_count_std": float(d["rc"]["std"]),
        "leader_count": four(d["lc"]),
        "topic_replica_count": four(d["trc"]),
        "potential_nw_out": four(d["pot"]),
        "potential_nw_out_max": float(d["pot"]["max"]),
        "num_offline_replicas": int(d["num_offline"]),
        "num_brokers": int(d["num_brokers"]),
        "num_replicas": int(d["num_replicas"]),
        "num_topics": int(d["num_topics"]),
    }


def cluster_stats_state(env: ClusterEnv, st: EngineState) -> dict:
    """Stats over the engine state (ClusterModelStats.java:30-44 field set)."""
    return _stats_to_json(_stats_device(env, st))


def _pack_final(env: ClusterEnv, st: EngineState):
    """Final assignment on the host: compact broker ids, bit-packed
    leadership, compact logdir ids, and the data to move (MB)."""
    b = st.replica_broker.cpu().numpy().astype(broker_index_dtype(env.num_brokers))
    disk = st.replica_disk.cpu().numpy().astype(
        disk_index_dtype(env.broker_disk_capacity.shape[1]))
    lead = np.packbits(st.replica_is_leader.cpu().numpy())
    moved_disk = torch.where(st.moved, env.leader_load[:, Resource.DISK],
                             torch.zeros_like(env.leader_load[:, 0]))
    return b, lead, disk, float(moved_disk.sum())


class GoalOptimizer:
    def __init__(self, config=None, constraint: BalancingConstraint | None = None,
                 engine_params: EngineParams | None = None, device="cuda",
                 sensors=None, recorder=None):
        """optimizer.py:299-506: every knob from ``config`` (a
        ``config.cruise_control_config``), or the reference's defaults when
        it is None. ``analyzer.profile.level`` and the compile cache are
        JAX-side knobs the port reads nothing from. ``sensors`` (the
        facade's ``MetricRegistry``) carries the proposal-computation-timer;
        ``recorder`` (a ``common.tracing.FlightRecorder``; a fresh one when
        None) records every round's trace."""
        from cruise_control_tpu_torch.common.sensors import MetricRegistry
        self.device = resolve_device(device)
        self._config = config
        self._sensors = sensors if sensors is not None else MetricRegistry()
        # GoalOptimizer.java:125 proposal-computation-timer
        self._proposal_timer = self._sensors.timer("proposal-computation-timer")
        if recorder is None:
            from cruise_control_tpu_torch.common.tracing import FlightRecorder
            recorder = FlightRecorder()
        self.recorder = recorder
        if constraint is None:
            constraint = (BalancingConstraint.from_config(config) if config is not None
                          else BalancingConstraint())
        self._constraint = constraint
        if engine_params is None and config is not None:
            engine_params = EngineParams(
                max_iters=config.get_int("analyzer.max.iterations"),
                num_candidates=config.get_int("analyzer.candidate.replicas.per.broker"),
                num_leader_candidates=config.get_int(
                    "analyzer.leader.candidates.per.iteration"),
                num_swap_candidates=config.get_int(
                    "analyzer.swap.candidates.per.iteration"),
                num_dst_choices=config.get_int("analyzer.destination.spread"),
                stall_retries=config.get_int("analyzer.stall.retries"),
                tail_pass_budget=config.get_int("analyzer.tail.pass.budget"),
                pass_waves=config.get_int("analyzer.pass.waves"),
                max_pass_waves=max(config.get_int("analyzer.pass.waves"),
                                   EngineParams.max_pass_waves),
                compact_keying=config.get_boolean("analyzer.compact.keying"),
                chain_cache=config.get_boolean("analyzer.chain.cache"),
                finisher_segments=config.get_int("analyzer.finisher.segments"),
                max_finisher_segments=config.get_int("analyzer.finisher.segments"),
                finisher_overlap=config.get_boolean("analyzer.finisher.overlap"),
                pass_chunk=config.get_int("analyzer.pass.chunk"))
        self._params = engine_params or EngineParams()

        def knob(kind: str, key: str, default):
            return getattr(config, f"get_{kind}")(key) if config is not None else default

        self._fused_min_replicas = knob("int", "analyzer.fused.chain.min.replicas",
                                        FUSED_MIN_REPLICAS)
        self._mesh_axis_brokers = knob("int", "tpu.mesh.axis.brokers", 1)
        if self._mesh_axis_brokers > 1:
            raise NotImplementedError("the sharded engine is not ported yet "
                                      "(ROADMAP.md Queue 1 item 15)")
        self._finisher_min_replicas = knob("int", "analyzer.finisher.min.replicas",
                                           FINISHER_MIN_REPLICAS)
        self._compute_dtype = knob("string", "analyzer.compute.dtype", "auto")
        self._escalation = knob("boolean", "analyzer.finisher.escalation", True)
        self._escalation_max_remaining = knob(
            "int", "analyzer.finisher.escalation.max.remaining", 2048)
        self._escalation_factor = knob("int", "analyzer.finisher.escalation.factor", 4)
        # analyzer.incremental.*: session rounds track deltas and carry over;
        # ``revalidate`` is the whole-round memo, ``seed.dirty`` the opt-in
        # dirty-set seeding (one-sided parity)
        self._incremental = knob("boolean", "analyzer.incremental.enabled", True)
        self._revalidate = knob("boolean", "analyzer.incremental.revalidate", True)
        self._reval_tol = knob("double", "analyzer.incremental.revalidate.tolerance", 0.0)
        self._seed_dirty = knob("boolean", "analyzer.incremental.seed.dirty", False)
        # analyzer.pass.*: convergence-gated pass scheduling
        self._pass_chunk = knob("int", "analyzer.pass.chunk", 8)
        self._chunk_min_replicas = knob("int", "analyzer.pass.chunk.min.replicas",
                                        CHUNK_MIN_REPLICAS)
        self._adaptive_budgets = knob("boolean", "analyzer.pass.adaptive.budgets", True)
        self._adaptive_floor = knob("int", "analyzer.pass.adaptive.floor.passes", 4)
        self._cert_skip = knob("boolean", "analyzer.pass.certificate.skip", True)
        self._shortcircuit = knob("boolean", "analyzer.pass.goal.shortcircuit", True)
        # fleet.pass.*: ragged fleet gating on the batched chunked path
        # (per-lane budgets, short-circuit, certificate skip, parking) and
        # the compaction policy the lane statistics report
        self._fleet_gating = knob("boolean", "fleet.pass.gating.enabled", True)
        self._fleet_compaction = knob("boolean", "fleet.pass.compaction.enabled", True)
        # launch-level statistics of the last batched round (the reference
        # records them on its round trace: optimizer.py:2006-2038)
        self.last_fleet_round: dict = {}
        # (chain_key, num_replicas) whose short-circuit probes have run once
        self._probe_warmed: set = set()
        self._balancedness_priority_weight = knob(
            "double", "goal.balancedness.priority.weight", BALANCEDNESS_PRIORITY_WEIGHT)
        self._balancedness_strictness_weight = knob(
            "double", "goal.balancedness.strictness.weight",
            BALANCEDNESS_STRICTNESS_WEIGHT)
        if config is not None:
            self._default_goal_names = list(config.get_list("goals"))
            self._hard_goal_names = set(config.get_list("hard.goals"))
        else:
            self._default_goal_names = list(DEFAULT_GOALS)
            self._hard_goal_names = set(DEFAULT_HARD_GOALS)

    @property
    def default_goal_names(self) -> list[str]:
        return list(self._default_goal_names)

    @property
    def constraint(self) -> BalancingConstraint:
        return self._constraint

    def scaled_params(self, num_replicas: int, num_brokers: int) -> EngineParams:
        """Per-cluster engine parameters from the PADDED shape bucket
        (the reference's scaling, unchanged)."""
        p = self._params
        small = (self._finisher_min_replicas >= 0
                 and num_replicas < self._finisher_min_replicas)
        return dataclasses.replace(
            p,
            num_candidates=min(1760, max(p.num_candidates, num_brokers // 4,
                                         num_replicas // 64)),
            num_leader_candidates=min(1024, max(p.num_leader_candidates,
                                                num_brokers // 8)),
            num_swap_candidates=max(p.num_swap_candidates, num_brokers // 32),
            num_dst_choices=min(128, max(p.num_dst_choices, num_brokers // 100)),
            tail_pass_budget=min(1024, p.tail_pass_budget
                                 * _budget_scale(num_replicas) ** 2),
            stall_retries=min(32, p.stall_retries * _budget_scale(num_replicas)),
            pass_waves=min(max(1, p.max_pass_waves),
                           max(p.pass_waves, 4 if num_replicas >= 262_144 else 1)),
            finisher_rounds=0 if small else p.finisher_rounds,
            max_finisher_rounds=0 if small else p.max_finisher_rounds,
            compute_dtype=_resolve_compute_dtype(p.compute_dtype, num_replicas,
                                                 self._compute_dtype))

    def _escalate_unproven(self, env: ClusterEnv, st: EngineState, goals,
                           goal_results, params: EngineParams):
        """optimizer.py:1553: a goal whose finisher exited violated, unproven
        and with at most ``analyzer.finisher.escalation.max.remaining``
        actions left re-enters its finisher once at the end of the chain,
        with finisher_rounds x ``analyzer.finisher.escalation.factor``, the
        budgeted loop skipped and every other chain goal's veto in force;
        then every verdict is refreshed. Returns the escalated state, or
        None when nothing escalated."""
        if not self._escalation or params.finisher_rounds <= 0:
            return None
        by_name = {g.name: g for g in goals}
        candidates = []
        for r in goal_results:
            g = by_name.get(r.name)
            if g is None or not r.violated_after or r.fixpoint_proven:
                continue
            if r.moves_remaining < 0 and r.leads_remaining < 0:
                continue
            remaining = (max(r.moves_remaining, 0) + max(r.leads_remaining, 0)
                         + max(r.swap_window_remaining, 0))
            if remaining <= self._escalation_max_remaining:
                candidates.append((r, g))
        if not candidates:
            return None
        factor = self._escalation_factor
        esc = dataclasses.replace(
            params, max_iters=0, stall_retries=0, tail_pass_budget=0,
            tail_total_budget=0, sat_stall_retries=0, sat_tail_passes=0,
            finisher_rounds=params.finisher_rounds * factor,
            finisher_swap_passes=params.finisher_swap_passes * factor)
        for r, g in candidates:
            prev = tuple(x for x in goals if x.name != r.name)
            st, info = optimize_goal(env, st, g, prev, esc)
            r.escalations += 1
            r.violated_after = bool(info["violated_after"])
            r.fixpoint_proven = bool(info["fixpoint_proven"])
            r.hit_max_iters = r.violated_after and not r.fixpoint_proven
            r.moves_remaining = int(info["moves_remaining"])
            r.leads_remaining = int(info["leads_remaining"])
            r.swap_window_remaining = int(info["swap_window_remaining"])
            r.iterations += int(info["iterations"])
            r.finisher_rounds += int(info["finisher_rounds"])
            r.finisher_actions += int(info["finisher_actions"])
            r.stat_after = float(info["stat"])
        fresh = dict(zip((g.name for g in goals), violations(goals, env, st)))
        for r in goal_results:
            if r.name in fresh and r.violated_after and not fresh[r.name]:
                r.violated_after = False
                r.hit_max_iters = False
        return st

    def _min_leader_mask(self, meta, pattern: str | None, num_topics: int):
        """bool[T] of the topics matching the min-leaders regex (the
        ``topics.with.min.leaders.per.broker`` key when no pattern is given),
        padded to ``num_topics``; None without a pattern."""
        if pattern is None and self._config is not None:
            pattern = self._config.get_string("topics.with.min.leaders.per.broker")
        if not pattern:
            return None
        rx = re.compile(pattern)
        tml = np.asarray([bool(rx.fullmatch(t)) for t in meta.topic_names], bool)
        if tml.shape[0] < num_topics:
            tml = np.pad(tml, (0, num_topics - tml.shape[0]))
        return tml

    def warmup(self, num_brokers: int, num_replicas: int,
               num_partitions: int | None = None, num_topics: int = 8,
               num_racks: int = 4, logdirs_per_broker: int = 1,
               max_replication: int | None = None,
               goal_names: list[str] | None = None) -> dict:
        """optimizer.py:516: one run over a synthetic cluster of this shape
        with near-zero budgets, off the critical path. On the card it builds
        every kernel library first (``kernels.build_all``), so the first real
        round loads them instead of waiting for ``nvcc``. Returns
        {"seconds", "shape", "goals"}."""
        from cruise_control_tpu_torch.model.fixtures import synthetic_cluster
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from cruise_control_tpu_torch.kernels import build_all
            build_all()
        ct, meta = synthetic_cluster(
            num_brokers, num_replicas, num_partitions=num_partitions,
            num_topics=num_topics, num_racks=num_racks,
            logdirs_per_broker=logdirs_per_broker,
            max_replication=max_replication)
        saved = self._params
        self._params = dataclasses.replace(
            saved, max_iters=1, stall_retries=0, tail_pass_budget=1,
            tail_total_budget=1, sat_stall_retries=0, sat_tail_passes=1,
            stat_window=1, finisher_rounds=min(saved.finisher_rounds, 1))
        try:
            self.optimizations(ct, meta, goal_names=goal_names,
                               raise_on_failure=False,
                               skip_hard_goal_check=True)
        finally:
            self._params = saved
        return {"seconds": round(time.monotonic() - t0, 3),
                "shape": {"brokers": ct.num_brokers,
                          "replicas": ct.num_replicas,
                          "partitions": ct.num_partitions,
                          "topics": ct.num_topics},
                "goals": list(goal_names or self._default_goal_names)}

    def violated_goals(self, ct: ClusterTensor, meta: ClusterMeta,
                       goal_names: list[str] | None = None,
                       options: OptimizationOptions = OptimizationOptions(),
                       ) -> list[str]:
        """optimizer.py:688: names of the goals violated on ``ct`` as it is
        (no optimization, no proposals): pad, upload and read every verdict
        once. The predicted-violation detector's pre-breach guard."""
        names = goal_names or self._default_goal_names
        known = [n for n in names if n != "PreferredLeaderElectionGoal"]
        goals = make_goals(known, self._constraint, options)
        ct, meta = pad_cluster(ct, meta)
        tml = self._min_leader_mask(meta, None, ct.num_topics)
        env = make_env(ct, meta, topic_min_leaders_mask=tml,
                       partition_table=padded_partition_table(ct),
                       device=self.device)
        st = init_state(env, ct.replica_broker, ct.replica_is_leader,
                        ct.replica_offline, ct.replica_disk)
        return [g.name for g, v in zip(goals, violations(goals, env, st)) if v]

    def optimizations(self, ct: ClusterTensor | None, meta: ClusterMeta | None = None,
                      goal_names: list[str] | None = None,
                      options: OptimizationOptions = OptimizationOptions(),
                      skip_hard_goal_check: bool = False,
                      raise_on_failure: bool = True,
                      measure_goal_durations: bool = False,
                      min_leader_topic_pattern: str | None = None,
                      session=None, span=None) -> OptimizerResult:
        """Run the chain over ``ct`` / ``meta``, or, with ``session`` (a
        synced ``ResidentClusterSession``; ``ct`` and ``meta`` may be None),
        from the session's resident env and lent state: the service round of
        optimizer.py:714-1378, with its memo, seeding and carryover.

        ``span`` (``common.tracing.Span``): the causal parent; the round
        opens an "optimize" child under it, ended with the round's proposal
        and movement counts (host-side only)."""
        round_span = (span.child("optimize", "optimize-round")
                      if span is not None else None)
        with self._proposal_timer.time():
            try:
                res = self._optimizations(
                    ct, meta, goal_names, options, skip_hard_goal_check,
                    raise_on_failure, measure_goal_durations,
                    min_leader_topic_pattern, session,
                    trace_id=round_span.trace_id if round_span is not None else None)
            except OptimizationFailureError as e:
                if round_span is not None and e.result is not None:
                    self._end_round_span(round_span, e.result)
                raise
        if round_span is not None:
            self._end_round_span(round_span, res)
        return res

    @staticmethod
    def _end_round_span(round_span, res) -> None:
        trace = res.round_trace
        round_span.end(proposals=len(res.proposals),
                       moves=res.num_replica_movements,
                       leads=res.num_leadership_movements,
                       round=trace.round_id if trace is not None else None)

    def _optimizations(self, ct, meta, goal_names, options, skip_hard_goal_check,
                       raise_on_failure, measure_goal_durations,
                       min_leader_topic_pattern, session,
                       trace_id=None) -> OptimizerResult:
        t_round = time.monotonic()
        # the pipelined loop's stage notes measure their overlap against
        # [here, record_round]; the generation keys which notes are this
        # round's
        opt_gen = self.recorder.note_optimize_start()
        if session is not None and session.device != self.device:
            raise ValueError(f"the session lives on {session.device}, the optimizer "
                             f"on {self.device}")
        names = goal_names or self._default_goal_names
        if goal_names and not skip_hard_goal_check:
            missing = [h for h in self._hard_goal_names
                       if h in self._default_goal_names and h not in goal_names]
            if missing:
                raise ValueError(
                    f"hard goals {missing} missing from requested goals; "
                    f"pass skip_hard_goal_check=True to override")
        known = [n for n in names if n != "PreferredLeaderElectionGoal"]
        goals = make_goals(known, self._constraint, options)
        run_preferred = "PreferredLeaderElectionGoal" in names

        # -- the round delta is consumed BEFORE optimizer_inputs (which lends
        # the resident state away); then the whole-round memo is tried
        session_info = dict(session.last_sync_info) if session is not None else None
        donated = session is not None and bool(getattr(session, "_donation", False))
        incremental = self._incremental and session is not None
        chain_key = (tuple(names), repr(options))
        rd = session.consume_round_delta() if incremental else None
        co = session.carryover if incremental else None
        if (incremental and self._revalidate and not measure_goal_durations
                and co is not None
                and co.chain_key == chain_key
                and rd["syncs"] >= 1 and rd["churn"] == 0
                and not rd["broker_flips"] and not rd["rebuilt"]
                and rd["load_drift"] <= self._reval_tol):
            memo = self._revalidated_round(session, goals, raise_on_failure,
                                           session_info, opt_gen, t_round, trace_id)
            if memo is not None:
                return memo
        taken_gen = None
        if session is not None:
            (env, st, meta, part_table, initial_broker, initial_leader,
             initial_disk, host_valid, host_part) = session.optimizer_inputs()
            taken_gen = session.sync_generation
        else:
            ct, meta = pad_cluster(ct, meta)
        num_replicas = env.num_replicas if session is not None else ct.num_replicas
        num_brokers = env.num_brokers if session is not None else ct.num_brokers
        params = self.scaled_params(num_replicas, num_brokers)
        check_supported(params)

        # -- dirty-set seed masks (K1's seed mask): None on full rounds (the
        # reference's all-ones mask: the same bits), the dirty replica set
        # for each goal a reduced round may confine
        seed_masks = [None] * len(goals)
        mask_modes = ["full"] * len(goals) if incremental else None
        reduced_names: set = set()
        dirty_count = 0
        if (incremental and self._seed_dirty and co is not None
                and co.chain_key == chain_key and rd["syncs"] >= 1
                and not rd["rebuilt"] and not rd["broker_flips"]
                and 0 < rd["churn"] <= session.seed_budget_replicas(num_replicas)):
            np_dirty = session.dirty_replica_mask(rd["dirty_brokers"], rd["dirty_topics"])
            if np_dirty.any():
                dirty_count = int(np_dirty.sum())
                dirty = torch.tensor(np_dirty, device=self.device)
                # seedable: satisfied at the carried round's end AND on the
                # churned round-start state
                viol_now = violations(goals, env, st)
                for i, g in enumerate(goals):
                    if not co.violated_after.get(g.name, True) and not viol_now[i]:
                        seed_masks[i] = dirty
                        mask_modes[i] = "reduced"
                        reduced_names.add(g.name)

        if session is None:
            tml = self._min_leader_mask(meta, min_leader_topic_pattern, ct.num_topics)
            part_table = padded_partition_table(ct)
            env = make_env(ct, meta, topic_min_leaders_mask=tml,
                           partition_table=part_table, device=self.device)
            st = init_state(env, ct.replica_broker, ct.replica_is_leader,
                            ct.replica_offline, ct.replica_disk)
            initial_broker = np.asarray(ct.replica_broker, np.int32)
            initial_leader = np.asarray(ct.replica_is_leader, bool)
            initial_disk = np.asarray(ct.replica_disk, np.int32)
            host_valid = np.asarray(ct.replica_valid, bool)
            host_part = np.asarray(ct.replica_partition, np.int32)

        use_fused = (not measure_goal_durations and self._fused_min_replicas >= 0
                     and num_replicas >= self._fused_min_replicas)
        use_chunked = (self._pass_chunk > 0 and params.pass_chunk > 0
                       and num_replicas >= self._chunk_min_replicas
                       and not measure_goal_durations)
        adaptive_params = params
        if use_chunked and self._adaptive_budgets and dirty_count > 0 and reduced_names:
            # churn-adaptive budgets for the dirty-seeded goals only: ceil(D /
            # K) + 1 passes drain the dirty pool once and prove quiescence
            need = max(self._adaptive_floor,
                       -(-dirty_count // max(int(params.num_candidates), 1)) + 1)
            adaptive_params = dataclasses.replace(
                params,
                stall_retries=min(int(params.stall_retries), need),
                sat_stall_retries=min(int(params.sat_stall_retries), need),
                tail_pass_budget=min(int(params.tail_pass_budget), 4 * need),
                sat_tail_passes=min(int(params.sat_tail_passes), 4 * need),
                tail_total_budget=min(int(params.tail_total_budget), 8 * need),
                finisher_rounds=min(int(params.finisher_rounds), max(2, need)))
        # certificate-skip eligibility (carryover half): churn within the
        # reduced-round budget since the carried round
        cert_carry_ok = False
        if (use_chunked and self._cert_skip and incremental and co is not None
                and co.chain_key == chain_key and rd["syncs"] >= 1
                and not rd["rebuilt"] and not rd["broker_flips"]):
            cert_carry_ok = 0 <= rd["churn"] <= session.seed_budget_replicas(num_replicas)
        carried_map = ({r.name: r for r in co.result.goal_results}
                       if cert_carry_ok else {})
        if (use_chunked and incremental and self._shortcircuit
                and (chain_key, num_replicas) not in self._probe_warmed):
            # optimizer.py:943-951: the first full chunked round of a chain
            # and shape runs every goal's short-circuit probe once, results
            # discarded; in the reference that compiles the probe programs,
            # here it builds and loads K13's library, so the first reduced
            # round builds nothing
            ones = torch.ones(num_replicas, dtype=torch.bool, device=self.device)
            for g in goals:
                g.seeded_work_probe(env, st, ones)
            self._probe_warmed.add((chain_key, num_replicas))

        stats_before = cluster_stats_state(env, st)
        violated_before = dict(zip((g.name for g in goals), violations(goals, env, st)))
        infos, durations = [], []
        prev: tuple = ()
        actions_so_far = 0
        # fused: the prefix up to the first deep-tail goal runs without the
        # finisher; each later goal (and, unfused, every goal) runs with the
        # finisher at its chain position
        split = (next((i for i, g in enumerate(goals) if g.deep_tail), len(goals))
                 if use_fused else 0)
        for gi, g in enumerate(goals):
            t0 = time.monotonic()
            reduced_goal = mask_modes is not None and mask_modes[gi] == "reduced"
            if gi < split:
                st, info = _goal_loop(env, st, g, prev, params, finisher=False,
                                      seed_mask=seed_masks[gi])
            elif use_chunked and reduced_goal and self._shortcircuit and (
                    pr := goal_probe(g, env, st, seed_masks[gi])) and (
                    not pr["violated"] and not pr["has_work"]):
                # the chain short-circuit: a reduced goal entering satisfied
                # with no seeded work would run a bit-exact no-op program
                info = dict(_NO_GOAL_RUN, stat_before=pr["stat"], stat=pr["stat"])
                mask_modes[gi] = "skipped"
            elif use_chunked:
                allow_skip = (cert_carry_ok and actions_so_far == 0
                              and g.name in carried_map
                              and co.violated_after.get(g.name) is True
                              and co.proven.get(g.name) is True)
                st, info = optimize_goal_chunked(
                    env, st, g, prev, adaptive_params if reduced_goal else params,
                    seed_mask=seed_masks[gi], allow_cert_skip=allow_skip)
                if info["finisher_skipped"]:
                    # the carried certificate stands in for the skipped scans
                    cr = carried_map[g.name]
                    info.update(fixpoint_proven=True,
                                moves_remaining=cr.moves_remaining,
                                leads_remaining=cr.leads_remaining,
                                swap_window_remaining=cr.swap_window_remaining)
            else:
                st, info = optimize_goal(env, st, g, prev, params,
                                         seed_mask=seed_masks[gi])
            actions_so_far += int(info["iterations"])
            if measure_goal_durations:
                self._sync_device()
            durations.append(0.0 if use_fused else time.monotonic() - t0)
            infos.append(info)
            prev = prev + (g,)
        goal_results = [
            GoalResult(
                name=g.name, violated_before=violated_before[g.name],
                violated_after=info["violated_after"],
                iterations=info["iterations"], duration_s=dur,
                stat_after=info["stat"], hit_max_iters=info["hit_max_iters"],
                passes=info["passes"], stat_before=info["stat_before"],
                fixpoint_proven=info["fixpoint_proven"],
                moves_remaining=info["moves_remaining"],
                leads_remaining=info["leads_remaining"],
                swap_window_remaining=info["swap_window_remaining"],
                finisher_rounds=info["finisher_rounds"],
                plateau_exit=info["plateau_exit"],
                move_actions=info["move_actions"],
                lead_actions=info["lead_actions"],
                swap_actions=info["swap_actions"],
                disk_actions=info["disk_actions"],
                move_waves=info["move_waves"],
                finisher_actions=info["finisher_actions"],
                finisher_segments=info["finisher_segments"],
                finisher_boundary=info["finisher_boundary"],
                passes_skipped=info.get("passes_skipped", 0),
                quiesce_chunk=info.get("quiesce_chunk", -1),
                finisher_skipped=info.get("finisher_skipped", False),
                mode=mask_modes[gi] if mask_modes is not None else "full")
            for gi, (g, info, dur) in enumerate(zip(goals, infos, durations))]
        if run_preferred:
            # optimizer.py:1183 (unfused) / :2700 (fused, inside the final
            # program): after the chain, before the final stats and fetch
            ple = PreferredLeaderElectionGoal(constraint=self._constraint,
                                              options=options)
            t0 = time.monotonic()
            was, st, still = ple.run(env, st)
            if measure_goal_durations:
                self._sync_device()
            was, still = (bool(v) for v in torch.stack([was, still]).tolist())
            goal_results.append(GoalResult(
                name=ple.name, violated_before=was, violated_after=still,
                iterations=1 if was else 0,
                duration_s=0.0 if use_fused else time.monotonic() - t0,
                stat_after=0.0))
        # the full-R repair sweep of a dirty-seeded chain, before escalation
        fallbacks = 0
        if reduced_names:
            st_fb, fallbacks = self._reseed_fallback(
                env, st, goals, goal_results, params, co.violated_after, use_chunked)
            if st_fb is not None:
                st = st_fb
        st_esc = self._escalate_unproven(env, st, goals, goal_results, params)
        if st_esc is not None:
            st = st_esc
        stats_after = cluster_stats_state(env, st)
        pb, plead, pdisk, data_mb = _pack_final(env, st)
        R = env.num_replicas
        proposals = diff_proposals(
            meta, initial_broker, initial_leader, initial_disk,
            np.asarray(pb, np.int32), np.unpackbits(plead)[:R].astype(bool),
            np.asarray(pdisk, np.int32), part_table, host_valid, host_part)
        viol_after = {r.name: r.violated_after for r in goal_results}
        result = OptimizerResult(
            goal_results=goal_results, proposals=proposals,
            stats_before=stats_before, stats_after=stats_after,
            balancedness_before=_balancedness(
                goals, violated_before, self._balancedness_priority_weight,
                self._balancedness_strictness_weight),
            balancedness_after=_balancedness(
                goals, viol_after, self._balancedness_priority_weight,
                self._balancedness_strictness_weight),
            num_replica_movements=proposals.num_replica_additions,
            num_leadership_movements=proposals.num_leadership_changes,
            data_to_move_mb=data_mb,
            round_mode="reduced" if reduced_names else "full",
            fallback_goals=fallbacks,
            passes_dispatched=sum(r.passes for r in goal_results),
            passes_skipped=sum(r.passes_skipped for r in goal_results),
            early_exit_goals=sum(1 for r in goal_results if r.quiesce_chunk >= 0),
            skipped_goals=sum(1 for r in goal_results if r.mode == "skipped"),
            durations_measured=measure_goal_durations,
            final_state=st, env=env, meta=meta)
        # one RoundTrace per round, recorded before the hard-goal raise so a
        # failed round leaves a trace too (optimizer.py:1311)
        result.round_trace = self.recorder.record_round(
            wall_s=time.monotonic() - t_round, goal_results=goal_results,
            compiles=0, env=env, state=st, num_proposals=len(proposals),
            num_replica_movements=result.num_replica_movements,
            num_leadership_movements=result.num_leadership_movements,
            session_info=session_info, donated=donated,
            durations_measured=measure_goal_durations, trace_id=trace_id,
            opt_generation=opt_gen, round_mode=result.round_mode,
            passes_dispatched=result.passes_dispatched,
            passes_skipped=result.passes_skipped,
            early_exit_goals=result.early_exit_goals,
            skipped_goals=result.skipped_goals)
        # the carryover is saved BEFORE the hard-goal raise: the consumed
        # round delta is gone either way (optimizer.py:1337-1347)
        if incremental:
            session.note_carryover(
                IncrementalCarryover(
                    chain_key=chain_key,
                    violated_before=tuple(bool(violated_before[g.name]) for g in goals),
                    violated_after={r.name: r.violated_after for r in goal_results},
                    proven={r.name: r.fixpoint_proven for r in goal_results},
                    result=result),
                taken_generation=taken_gen)
        if raise_on_failure:
            failed = [r.name + (" (iteration budget exhausted)" if r.hit_max_iters else "")
                      for r, g in zip(goal_results, goals)
                      if g.is_hard and r.violated_after]
            if failed:
                # optimizer.py:1358-1375: attach how many brokers are missing
                floors = (ProvisionFloors.from_config(self._config)
                          if self._config is not None else ProvisionFloors())
                rec = recommendation_from_result(result, self._constraint, floors=floors)
                raise OptimizationFailureError(
                    f"hard goal(s) not satisfiable: {failed} "
                    f"[{rec.status.value}: {rec.reason}]",
                    recommendation=rec, result=result)
        return result

    # ------------------------------------------------ incremental round modes
    def _sync_device(self) -> None:
        """Wait for the device (a measured goal's duration ends here)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _revalidated_round(self, session, goals, raise_on_failure, session_info,
                           opt_gen, t_round, trace_id):
        """optimizer.py:1390, the certificate re-validation memo: one verdict
        pass over the resident state (peeked, never lent); every verdict
        equal to the carried round's start verdicts proves the deterministic
        chain would replay bit for bit, so the carried result returns
        re-stamped. Any mismatch returns None and the full round runs."""
        co = session.carryover
        t0 = time.monotonic()
        env, st = session.revalidation_view()
        if tuple(violations(goals, env, st)) != co.violated_before:
            return None
        grs = [dataclasses.replace(r, duration_s=0.0, mode="revalidated")
               for r in co.result.goal_results]
        result = dataclasses.replace(
            co.result, goal_results=grs, round_mode="revalidated",
            revalidate_s=time.monotonic() - t0, durations_measured=False,
            fallback_goals=0)
        session.note_revalidated()
        result.round_trace = self.recorder.record_round(
            wall_s=time.monotonic() - t_round,
            goal_results=grs, compiles=0, env=env, state=st,
            num_proposals=len(result.proposals),
            num_replica_movements=result.num_replica_movements,
            num_leadership_movements=result.num_leadership_movements,
            session_info=session_info, donated=False, durations_measured=False,
            trace_id=trace_id, opt_generation=opt_gen, round_mode="revalidated",
            revalidate_s=result.revalidate_s)
        if raise_on_failure:
            failed = [r.name for r, g in zip(grs, goals)
                      if g.is_hard and r.violated_after]
            if failed:
                raise OptimizationFailureError(
                    f"hard goal(s) not satisfiable: {failed} [revalidated round]",
                    result=result)
        return result

    def _reseed_fallback(self, env, st, goals, goal_results, params,
                         carried_violated: dict, use_chunked: bool):
        """optimizer.py:1451: the full-R repair sweep after a dirty-seeded
        chain. In chain order it re-runs, unmasked and with the goal's
        chain-prefix veto and the static budgets, every goal the round left
        violated without a certificate, or violated with one where the
        carried round ended it satisfied; then it re-reads every verdict,
        and repeats once for the goals the first sweep broke. Returns (new
        state, goals re-run), or (None, 0) when no verdict needs repair."""
        order = {g.name: i for i, g in enumerate(goals)}
        exempt = {r.name for r in goal_results
                  if r.violated_after and r.fixpoint_proven
                  and carried_violated.get(r.name) is not False}
        todo = [r for r in goal_results
                if r.name in order and r.violated_after and r.name not in exempt]
        if not todo:
            return None, 0
        swept: set = set()
        for _sweep in range(2):
            todo.sort(key=lambda r: order[r.name])
            for r in todo:
                gi = order[r.name]
                g = goals[gi]
                if use_chunked:
                    st, info = optimize_goal_chunked(env, st, g, tuple(goals[:gi]), params)
                    r.passes_skipped += int(info.get("passes_skipped", 0))
                    if r.quiesce_chunk < 0:
                        r.quiesce_chunk = int(info.get("quiesce_chunk", -1))
                else:
                    st, info = optimize_goal(env, st, g, tuple(goals[:gi]), params)
                r.violated_after = bool(info["violated_after"])
                r.fixpoint_proven = bool(info["fixpoint_proven"])
                r.hit_max_iters = r.violated_after and not r.fixpoint_proven
                r.iterations += int(info["iterations"])
                r.passes += int(info.get("passes", 0))
                r.moves_remaining = int(info["moves_remaining"])
                r.leads_remaining = int(info["leads_remaining"])
                r.swap_window_remaining = int(info["swap_window_remaining"])
                r.finisher_rounds += int(info.get("finisher_rounds", 0))
                r.finisher_actions += int(info.get("finisher_actions", 0))
                r.stat_after = float(info["stat"])
                r.mode = "full"
                swept.add(r.name)
            fresh = dict(zip((g.name for g in goals), violations(goals, env, st)))
            for r in goal_results:
                if r.name not in fresh or r.violated_after == fresh[r.name]:
                    continue
                r.violated_after = fresh[r.name]
                if r.violated_after:
                    r.fixpoint_proven = False
                r.hit_max_iters = r.violated_after and not r.fixpoint_proven
            todo = [r for r in goal_results
                    if r.name in order and r.violated_after
                    and r.name not in swept and r.name not in exempt]
            if not todo:
                break
        return st, len(swept)

    # ----------------------------------------------- fleet batched launch
    def optimizations_batched(self, sessions: list, goal_names=None,
                              options: OptimizationOptions = OptimizationOptions(),
                              raise_on_failure: bool = False,
                              on_result=None) -> list:
        """optimizer.py:1625: one batched launch over K same-bucket resident
        sessions (fleet mode). The tenants' padded env and state stack along
        a lane axis (``analyzer.lanes.LaneStack``) and the goal chain runs
        over the stack: the move, leadership and swap waves' kernels and the
        probe launch once for every running lane, the disk branch and the
        finisher lane by lane. Per-tenant
        verdicts, certificates and proposal sets are bit-identical to K solo
        runs. Sessions must be synced by the caller and share one shape
        bucket; returns one ``OptimizerResult`` per session, in order.
        ``on_result(i, result)`` fires as each lane lands (early landing of
        parked lanes on the gated path)."""
        with self._proposal_timer.time():
            return self._optimizations_batched(sessions, goal_names, options,
                                               raise_on_failure, on_result)

    def _optimizations_batched(self, sessions, goal_names, options,
                               raise_on_failure, on_result=None) -> list:
        t_round = time.monotonic()
        opt_gen = self.recorder.note_optimize_start()
        names = goal_names or self._default_goal_names
        known = [n for n in names if n != "PreferredLeaderElectionGoal"]
        goals = make_goals(known, self._constraint, options)
        run_preferred = "PreferredLeaderElectionGoal" in names
        ple = (PreferredLeaderElectionGoal(constraint=self._constraint, options=options)
               if run_preferred else None)
        for s in sessions:
            if s.device != self.device:
                raise ValueError(f"a session lives on {s.device}, the optimizer on "
                                 f"{self.device}")

        # the round deltas are consumed BEFORE the lending input take, then
        # the whole-fleet certificate memo is tried (all or nothing)
        chain_key = (tuple(names), repr(options))
        rds = ([s.consume_round_delta() for s in sessions]
               if self._incremental else [None] * len(sessions))
        if self._incremental and self._revalidate:
            memo = self._revalidated_fleet(sessions, goals, rds, chain_key, t_round,
                                           opt_gen)
            if memo is not None:
                return memo

        inputs = [s.optimizer_inputs() for s in sessions]
        gens = [s.sync_generation for s in sessions]
        envs = [i[0] for i in inputs]
        stack = LaneStack(envs, [i[1] for i in inputs])
        num_replicas = envs[0].num_replicas
        num_brokers = envs[0].num_brokers
        params = self.scaled_params(num_replicas, num_brokers)
        check_supported(params)

        # per-tenant seed masks: all-ones rows (None) for full tenants, the
        # dirty rows for churn-budgeted tenants with a carryover
        K0 = len(sessions)
        reduced_by_tenant: list[set] = [set() for _ in sessions]
        dirty_counts = [0] * K0
        masks = None
        if self._incremental:
            masks = []
            for k, (s, rd) in enumerate(zip(sessions, rds)):
                co = s.carryover
                masks_k = [None] * len(goals)
                budget = s.seed_budget_replicas(num_replicas)
                if (self._seed_dirty and rd is not None and co is not None
                        and co.chain_key == chain_key
                        and rd["syncs"] >= 1 and not rd["rebuilt"]
                        and not rd["broker_flips"]
                        and 0 < rd["churn"] <= budget):
                    np_dirty = s.dirty_replica_mask(rd["dirty_brokers"],
                                                    rd["dirty_topics"])
                    if np_dirty.any():
                        dirty_counts[k] = int(np_dirty.sum())
                        dirty = torch.tensor(np_dirty, device=self.device)
                        viol_now = violations(goals, stack.envs[k], stack.sts[k])
                        for i, g in enumerate(goals):
                            if not co.violated_after.get(g.name, True) and not viol_now[i]:
                                masks_k[i] = dirty
                                reduced_by_tenant[k].add(g.name)
                masks.append(masks_k)

        use_chunked = (self._pass_chunk > 0 and params.pass_chunk > 0
                       and num_replicas >= self._chunk_min_replicas)
        gating = use_chunked and self._fleet_gating and masks is not None

        lane_need = np.zeros(K0, np.int64)
        reduced_flags = np.zeros((K0, len(goals)), bool)
        cert_goal = np.zeros((K0, len(goals)), bool)
        carried_maps: list[dict] = [{} for _ in sessions]
        if gating:
            for k, (s, rd) in enumerate(zip(sessions, rds)):
                for gi, g in enumerate(goals):
                    reduced_flags[k, gi] = g.name in reduced_by_tenant[k]
                if (self._adaptive_budgets and dirty_counts[k] > 0
                        and reduced_by_tenant[k]):
                    lane_need[k] = max(self._adaptive_floor,
                                       -(-dirty_counts[k]
                                         // max(int(params.num_candidates), 1)) + 1)
                co = s.carryover
                if (self._cert_skip and rd is not None and co is not None
                        and co.chain_key == chain_key
                        and rd["syncs"] >= 1 and not rd["rebuilt"]
                        and not rd["broker_flips"]
                        and 0 <= rd["churn"] <= s.seed_budget_replicas(num_replicas)):
                    carried_maps[k] = {r.name: r for r in co.result.goal_results}
                    for gi, g in enumerate(goals):
                        cert_goal[k, gi] = (co.violated_after.get(g.name) is True
                                            and co.proven.get(g.name) is True)

        results_by_idx: dict[int, OptimizerResult] = {}
        failed_hard: list[tuple] = []

        def finalize_tenant(i, payload):
            """Tenant i's OptimizerResult from its lane's payload (optimizer.py
            :1785-1927): the per-tenant fallback and escalation, proposals,
            carryover and ``on_result``."""
            session = sessions[i]
            (env, _st0, meta, part_table, initial_broker, initial_leader,
             initial_disk, host_valid, host_part) = inputs[i]
            st_i = payload["state"]
            infos = payload["infos"]
            violated_before = {g.name: bool(v)
                               for g, v in zip(goals, payload["viol_before"])}
            goal_results = [
                GoalResult(
                    name=g.name, violated_before=violated_before[g.name],
                    violated_after=bool(info["violated_after"]),
                    iterations=int(info["iterations"]), duration_s=0.0,
                    stat_after=float(info["stat"]),
                    hit_max_iters=bool(info.get("hit_max_iters", False)),
                    passes=int(info.get("passes", 0)),
                    stat_before=float(info.get("stat_before", 0.0)),
                    fixpoint_proven=bool(info.get("fixpoint_proven", False)),
                    moves_remaining=int(info.get("moves_remaining", -1)),
                    leads_remaining=int(info.get("leads_remaining", -1)),
                    swap_window_remaining=int(info.get("swap_window_remaining", -1)),
                    finisher_rounds=int(info.get("finisher_rounds", 0)),
                    plateau_exit=bool(info.get("plateau_exit", False)),
                    move_actions=int(info.get("move_actions", 0)),
                    lead_actions=int(info.get("lead_actions", 0)),
                    swap_actions=int(info.get("swap_actions", 0)),
                    disk_actions=int(info.get("disk_actions", 0)),
                    move_waves=int(info.get("move_waves", 0)),
                    finisher_actions=int(info.get("finisher_actions", 0)),
                    finisher_segments=int(info.get("finisher_segments", 0)),
                    finisher_boundary=int(info.get("finisher_boundary", 0)),
                    passes_skipped=int(info.get("passes_skipped", 0)),
                    quiesce_chunk=int(info.get("quiesce_chunk", -1)),
                    finisher_skipped=bool(info.get("finisher_skipped", False)))
                for g, info in zip(goals, infos)]
            for r in goal_results:
                if r.finisher_skipped and r.name in carried_maps[i]:
                    # the carried certificate stands in for the skipped scans
                    cr = carried_maps[i][r.name]
                    r.fixpoint_proven = True
                    r.moves_remaining = cr.moves_remaining
                    r.leads_remaining = cr.leads_remaining
                    r.swap_window_remaining = cr.swap_window_remaining
            skipped_names = payload.get("skipped_names") or set()
            for r in goal_results:
                if r.name in skipped_names:
                    r.mode = "skipped"
                elif r.name in reduced_by_tenant[i]:
                    r.mode = "reduced"
            if run_preferred:
                goal_results.append(GoalResult(
                    name="PreferredLeaderElectionGoal",
                    violated_before=bool(payload["ple_was"]),
                    violated_after=bool(payload["ple_still"]),
                    iterations=1 if payload["ple_was"] else 0,
                    duration_s=0.0, stat_after=0.0))
            stats_before = payload["stats_before"]
            stats_after = payload["stats_after"]
            pb, plead, pdisk, data_mb = payload["packed"]
            n_fb = 0
            if reduced_by_tenant[i]:
                st_fb, n_fb = self._reseed_fallback(
                    env, st_i, goals, goal_results, params,
                    session.carryover.violated_after, use_chunked)
                if st_fb is not None:
                    st_i = st_fb
                    stats_after = cluster_stats_state(env, st_i)
                    pb, plead, pdisk, data_mb = _pack_final(env, st_i)
            st_esc = self._escalate_unproven(env, st_i, goals, goal_results, params)
            if st_esc is not None:
                st_i = st_esc
                stats_after = cluster_stats_state(env, st_i)
                pb, plead, pdisk, data_mb = _pack_final(env, st_i)
            R = env.num_replicas
            proposals = diff_proposals(
                meta, initial_broker, initial_leader, initial_disk,
                np.asarray(pb, np.int32), np.unpackbits(plead)[:R].astype(bool),
                np.asarray(pdisk, np.int32), part_table, host_valid, host_part)
            viol_after = {g.name: g.violated_after for g in goal_results}
            result = OptimizerResult(
                goal_results=goal_results, proposals=proposals,
                stats_before=stats_before, stats_after=stats_after,
                balancedness_before=_balancedness(
                    goals, violated_before, self._balancedness_priority_weight,
                    self._balancedness_strictness_weight),
                balancedness_after=_balancedness(
                    goals, viol_after, self._balancedness_priority_weight,
                    self._balancedness_strictness_weight),
                num_replica_movements=proposals.num_replica_additions,
                num_leadership_movements=proposals.num_leadership_changes,
                data_to_move_mb=float(data_mb),
                round_mode="reduced" if reduced_by_tenant[i] else "full",
                fallback_goals=n_fb,
                passes_dispatched=sum(r.passes for r in goal_results),
                passes_skipped=sum(r.passes_skipped for r in goal_results),
                early_exit_goals=sum(1 for r in goal_results if r.quiesce_chunk >= 0),
                skipped_goals=sum(1 for r in goal_results if r.mode == "skipped"),
                parked_early=bool(payload.get("parked_early", False)),
                compacted_out=bool(payload.get("compacted_out", False)),
                final_state=st_i, env=env, meta=meta)
            results_by_idx[i] = result
            if self._incremental:
                session.note_carryover(
                    IncrementalCarryover(
                        chain_key=chain_key,
                        violated_before=tuple(bool(violated_before[g.name])
                                              for g in goals),
                        violated_after={r.name: r.violated_after for r in goal_results},
                        proven={r.name: r.fixpoint_proven for r in goal_results},
                        result=result),
                    taken_generation=gens[i])
            if raise_on_failure:
                failed = [r.name for r, g in zip(goal_results, goals)
                          if g.is_hard and r.violated_after]
                if failed:
                    failed_hard.append((i, result, failed))
            if on_result is not None:
                on_result(i, result)
            return result

        fleet_stats = None
        if gating:
            fleet_stats = self._fleet_chain_gated(
                stack, goals, ple, params, masks, lane_need, reduced_flags, cert_goal,
                finalize_tenant)
        else:
            payloads = self._fleet_chain(stack, goals, ple, params, masks,
                                         params.pass_chunk if use_chunked else 0)
            for i, payload in enumerate(payloads):
                finalize_tenant(i, payload)
                if raise_on_failure and failed_hard:
                    break
        if raise_on_failure and failed_hard:
            i, result, failed = min(failed_hard, key=lambda t: t[0])
            raise OptimizationFailureError(
                f"hard goal(s) not satisfiable for tenant {i}: {failed}", result=result)
        results = [results_by_idx[i] for i in range(K0)]
        info = {"mode": "fleet", "tenants": K0}
        if fleet_stats is not None:
            info["gated"] = True
            info.update(fleet_stats)
        info["lanes"] = [{"tenant": i, "round_mode": r.round_mode,
                          "passes_dispatched": r.passes_dispatched,
                          "passes_skipped": r.passes_skipped,
                          "early_exit_goals": r.early_exit_goals,
                          "skipped_goals": r.skipped_goals,
                          "parked_early": r.parked_early,
                          "compacted_out": r.compacted_out}
                         for i, r in enumerate(results)]
        self.last_fleet_round = info
        # ONE RoundTrace for the whole launch (optimizer.py:2019): tenant 0's
        # goal rows, the counts summed, the lanes' gating rows
        session_info = {k: v for k, v in info.items() if k != "lanes"}
        trace = self.recorder.record_round(
            wall_s=time.monotonic() - t_round, goal_results=results[0].goal_results,
            compiles=0, env=stack.env_b, state=stack.st_b,
            num_proposals=sum(len(r.proposals) for r in results),
            num_replica_movements=sum(r.num_replica_movements for r in results),
            num_leadership_movements=sum(r.num_leadership_movements for r in results),
            session_info=session_info,
            donated=all(bool(getattr(s, "_donation", False)) for s in sessions),
            opt_generation=opt_gen,
            round_mode="reduced" if any(reduced_by_tenant) else "full",
            passes_dispatched=sum(r.passes_dispatched for r in results),
            passes_skipped=sum(r.passes_skipped for r in results),
            early_exit_goals=sum(r.early_exit_goals for r in results),
            skipped_goals=sum(r.skipped_goals for r in results),
            fleet_lanes=info["lanes"])
        for r in results:
            r.round_trace = trace
        return results

    @staticmethod
    def _lane_head(stack, goals, lanes: list) -> dict:
        """{lane: (stats before, violated-before flags)} (the fleet head)."""
        return {l: (cluster_stats_state(stack.envs[l], stack.sts[l]),
                    violations(goals, stack.envs[l], stack.sts[l])) for l in lanes}

    @staticmethod
    def _lane_final(stack, ple, lanes: list) -> dict:
        """{lane: payload part} of the closing step (``_compiled_fleet_final``
        :2626): the optional preferred-leader pass, final stats and the
        packed final assignment, lane by lane."""
        out = {}
        for l in lanes:
            part = {}
            if ple is not None:
                was, st, still = ple.run(stack.envs[l], stack.sts[l])
                stack.write_lanes([l], [st])
                part["ple_was"], part["ple_still"] = (
                    bool(v) for v in torch.stack([was, still]).tolist())
            part["stats_after"] = cluster_stats_state(stack.envs[l], stack.sts[l])
            part["packed"] = _pack_final(stack.envs[l], stack.sts[l])
            part["state"] = stack.state_copy(l)
            out[l] = part
        return out

    def _lane_finish(self, stack, g, prev: tuple, lane_params: dict, lanes: list,
                     skip: dict | None = None) -> dict:
        """{lane: (violated, finisher counts, stat)}: the finisher of goal
        ``g`` for ``lanes``, lane by lane (``_compiled_fleet_finish`` :2346),
        gated on the lane's verdict (and off where ``skip`` says so)."""
        viol = read_values([g.violated(stack.envs[l], stack.sts[l]) for l in lanes])
        fins = {}
        for l, v in zip(lanes, viol):
            run = bool(v) and not (skip or {}).get(l, False)
            st2, fins[l] = _goal_finish(stack.envs[l], stack.sts[l], g, prev,
                                        lane_params[l], run)
            stack.write_lanes([l], [st2])
        after = read_values([x for l in lanes
                             for x in (g.violated(stack.envs[l], stack.sts[l]),
                                       g.stat(stack.envs[l], stack.sts[l]))])
        return {l: (bool(after[2 * j]), fins[l], after[2 * j + 1])
                for j, l in enumerate(lanes)}

    def _fleet_chain(self, stack, goals, ple, params, masks, chunk: int) -> list:
        """The ungated fleet launch: the monolithic chain (``chunk`` 0,
        ``_compiled_fleet_chain`` :2563) or the chunked one with per-lane
        quiescence (``_fleet_chain_chunked`` :2045). Returns one payload per
        lane."""
        lanes = list(range(stack.size))
        lane_params = {l: params for l in lanes}
        head = self._lane_head(stack, goals, lanes)
        infos = {l: [] for l in lanes}
        prev: tuple = ()
        for gi, g in enumerate(goals):
            seed = {l: masks[l][gi] for l in lanes} if masks is not None else {}
            carries, quiesce, stat0 = fleet_goal_loop(stack, g, prev, lane_params, lanes,
                                                      chunk, seed)
            fin = self._lane_finish(stack, g, prev, lane_params, lanes)
            for l in lanes:
                viol, f, stat = fin[l]
                info = _info(g, params, carries[l], stat0[l], viol, f, stat)
                if chunk > 0:
                    info.update(passes_skipped=passes_skipped(carries[l], params,
                                                              quiesce[l]),
                                quiesce_chunk=quiesce[l])
                infos[l].append(info)
            prev = prev + (g,)
        final = self._lane_final(stack, ple, lanes)
        return [dict(final[l], viol_before=head[l][1], stats_before=head[l][0],
                     infos=infos[l]) for l in lanes]

    @staticmethod
    def _skipped_info(s0: float) -> dict:
        """A short-circuited goal's host info (optimizer.py:2156)."""
        return dict(_NO_GOAL_RUN, stat_before=s0, stat=s0)

    def _fleet_chain_gated(self, stack, goals, ple, params, masks, lane_need,
                           reduced_flags, cert_goal, finalize) -> dict:
        """optimizer.py:2176, ragged fleet gating: the chunked fleet launch
        with per-lane churn-clamped budgets, the per-lane chain
        short-circuit (the K13 probe of every lane in one launch), the per-lane certificate
        finisher skip, parking of lanes whose every remaining goal probes
        as a no-op (their final step runs and ``finalize`` fires at once:
        early landing) and the pow2 compaction policy. The stack is never
        re-gathered: each stage launches for the running lanes' list, so a
        compaction here only moves the policy's row map and counters,
        which follow the reference's. Returns the launch statistics."""
        K0 = stack.size
        G = len(goals)
        all_lanes = list(range(K0))
        head = self._lane_head(stack, goals, all_lanes)
        static = {f: int(getattr(params, f)) for f in
                  ("stall_retries", "sat_stall_retries", "tail_pass_budget",
                   "sat_tail_passes", "tail_total_budget", "finisher_rounds")}
        need0 = np.asarray(lane_need, np.int64)

        def lane_params(gi, ok):
            """The goal's per-lane params: churn-clamped budgets where the
            goal is dirty-seeded on the lane, the static ones elsewhere."""
            n = int(need0[ok])
            if not (reduced_flags[ok, gi] and n > 0):
                return params
            caps = {"stall_retries": n, "sat_stall_retries": n,
                    "tail_pass_budget": 4 * n, "sat_tail_passes": 4 * n,
                    "tail_total_budget": 8 * n, "finisher_rounds": max(2, n)}
            return dataclasses.replace(params, **{f: min(static[f], caps[f])
                                                  for f in static})

        def probes(g, gi, lanes):
            """{lane: (violated, has_work, stat)} of goal ``g``'s probe: the
            K13 answer of every lane against its mask in one launch
            (``lanes.probe_lanes``), the verdicts and stats per lane, in one
            read."""
            ones = torch.ones(stack.num_replicas, dtype=torch.bool, device=stack.device)
            work = probe_lanes(stack, g, lanes, [ones if masks[l][gi] is None
                                                 else masks[l][gi] for l in lanes])
            vals = read_values([x for j, l in enumerate(lanes) for x in (
                g.violated(stack.envs[l], stack.sts[l]), work[j],
                g.stat(stack.envs[l], stack.sts[l]))])
            return {l: (bool(vals[3 * j]), bool(vals[3 * j + 1]), vals[3 * j + 2])
                    for j, l in enumerate(lanes)}

        orig = np.arange(K0)            # stack row -> original tenant
        pad = np.zeros(K0, bool)        # pow2 pad rows of the policy
        done = np.zeros(K0, bool)       # parked lanes still in the row map
        actions_total = np.zeros(K0, np.int64)
        lane_infos: list[list] = [[] for _ in range(K0)]
        skipped_names: list[set] = [set() for _ in range(K0)]
        parked_flag = np.zeros(K0, bool)
        compacted_flag = np.zeros(K0, bool)
        stats = {"parked": 0, "compactions": 0, "compacted_out": 0}

        def finalize_lanes(oks):
            final = self._lane_final(stack, ple, oks)
            for ok in oks:
                finalize(ok, dict(final[ok], viol_before=head[ok][1],
                                  stats_before=head[ok][0], infos=lane_infos[ok],
                                  skipped_names=skipped_names[ok],
                                  parked_early=bool(parked_flag[ok]),
                                  compacted_out=bool(compacted_flag[ok])))

        prev: tuple = ()
        for gi, g in enumerate(goals):
            alive = ~done & ~pad
            alive_ok = [int(orig[r]) for r in np.flatnonzero(alive)]
            lp = {ok: lane_params(gi, ok) for ok in all_lanes}
            pr0 = probes(g, gi, alive_ok) if alive_ok else {}
            sc_ok = set()
            if self._shortcircuit:
                for ok in alive_ok:
                    viol, work, stat = pr0[ok]
                    if reduced_flags[ok, gi] and not viol and not work:
                        sc_ok.add(ok)
                        lane_infos[ok].append(self._skipped_info(float(stat)))
                        skipped_names[ok].add(g.name)
            run_ok = [ok for ok in alive_ok if ok not in sc_ok]
            if run_ok:
                seed = {ok: masks[ok][gi] for ok in run_ok}
                carries, quiesce, stat0 = fleet_goal_loop(
                    stack, g, prev, lp, run_ok, params.pass_chunk, seed)
                exit_viol = dict(zip(run_ok, read_values(
                    [g.violated(stack.envs[ok], stack.sts[ok]) for ok in run_ok])))
                fs = {}
                for ok in run_ok:
                    fs[ok] = bool(self._cert_skip and cert_goal[ok, gi]
                                  and actions_total[ok] == 0 and quiesce[ok] >= 0
                                  and carries[ok]["n_applied"] == 0)
                need_fin = [ok for ok in run_ok if exit_viol[ok] and not fs[ok]]
                if need_fin:
                    fin = self._lane_finish(stack, g, prev, lp, run_ok, skip=fs)
                else:
                    # no lane needs a real finisher run: the sentinels on the
                    # host, the exit verdicts and stats (zero launches)
                    stat_exit = dict(zip(run_ok, read_values(
                        [g.stat(stack.envs[ok], stack.sts[ok]) for ok in run_ok])))
                    fin = {ok: (bool(exit_viol[ok]), None, stat_exit[ok])
                           for ok in run_ok}
                for ok in run_ok:
                    viol, f, stat = fin[ok]
                    f = f if f is not None else {
                        "fixpoint_proven": False, "moves_remaining": -1,
                        "leads_remaining": -1, "swap_window_remaining": -1,
                        "finisher_rounds": 0, "finisher_actions": 0,
                        "finisher_boundary": 0, "finisher_segments": 0}
                    info = _info(g, lp[ok], carries[ok], stat0[ok], viol, f, stat)
                    info.update(passes_skipped=passes_skipped(carries[ok], lp[ok],
                                                              quiesce[ok]),
                                quiesce_chunk=quiesce[ok], finisher_skipped=fs[ok])
                    lane_infos[ok].append(info)
                    actions_total[ok] += int(info["iterations"])
            prev = prev + (g,)

            # boundary parking + compaction: a lane whose EVERY remaining
            # goal is dirty-seeded and probes as a no-op finishes here
            if gi >= G - 1 or not self._shortcircuit:
                continue
            cand = ~done & ~pad
            for gj in range(gi + 1, G):
                cand &= reduced_flags[orig, gj]
            if not np.any(cand):
                continue
            park = cand.copy()
            probes_rest = []
            for gj in range(gi + 1, G):
                rows = [int(orig[r]) for r in np.flatnonzero(park)]
                pr = probes(goals[gj], gj, rows)
                probes_rest.append(pr)
                for r in np.flatnonzero(park):
                    viol, work, _stat = pr[int(orig[r])]
                    park[r] = not viol and not work
                if not np.any(park):
                    break
            if not np.any(park):
                continue
            for r in np.flatnonzero(park):
                ok = int(orig[r])
                for gj, pr in zip(range(gi + 1, G), probes_rest):
                    lane_infos[ok].append(self._skipped_info(float(pr[ok][2])))
                    skipped_names[ok].add(goals[gj].name)
                parked_flag[ok] = True
            stats["parked"] += int(park.sum())
            will_drop = (done | park) & ~pad
            alive_rows = np.flatnonzero(~done & ~park & ~pad)
            kq = (1 << (int(alive_rows.size) - 1).bit_length()
                  if alive_rows.size else 0)
            compact = (self._fleet_compaction and alive_rows.size > 0
                       and kq < orig.shape[0])
            if compact:
                for ok in orig[will_drop]:
                    compacted_flag[int(ok)] = True
                stats["compactions"] += 1
                stats["compacted_out"] += int(will_drop.sum())
            finalize_lanes([int(orig[r]) for r in np.flatnonzero(park)])
            done = done | park
            if compact:
                rows = list(alive_rows) + [int(alive_rows[0])] * (kq - alive_rows.size)
                orig = orig[np.asarray(rows)]
                pad = np.zeros(kq, bool)
                pad[alive_rows.size:] = True
                done = np.zeros(kq, bool)

        finalize_lanes([int(orig[r]) for r in np.flatnonzero(~done & ~pad)])
        return stats

    def _revalidated_fleet(self, sessions, goals, rds, chain_key, t_round, opt_gen):
        """optimizer.py:2493, the whole-fleet certificate memo: when EVERY
        tenant is eligible and every tenant's verdict re-check matches its
        carried round, the launch is skipped and each carried result returns
        re-stamped; otherwise None (all or nothing)."""
        for s, rd in zip(sessions, rds):
            co = s.carryover
            if (rd is None or co is None or co.chain_key != chain_key
                    or rd["syncs"] < 1 or rd["churn"] != 0
                    or rd["broker_flips"] or rd["rebuilt"]
                    or rd["load_drift"] > self._reval_tol):
                return None
        t0 = time.monotonic()
        checked = []
        for s in sessions:
            env, st = s.revalidation_view()
            if tuple(violations(goals, env, st)) != s.carryover.violated_before:
                return None
            checked.append(s)
        reval_s = time.monotonic() - t0
        results = []
        for s in checked:
            co = s.carryover
            grs = [dataclasses.replace(r, duration_s=0.0, mode="revalidated")
                   for r in co.result.goal_results]
            result = dataclasses.replace(
                co.result, goal_results=grs, round_mode="revalidated",
                revalidate_s=reval_s, durations_measured=False, fallback_goals=0)
            s.note_revalidated()
            results.append(result)
        self.last_fleet_round = {"mode": "fleet", "tenants": len(sessions),
                                 "revalidated": True}
        env0, st0 = checked[0].revalidation_view()
        trace = self.recorder.record_round(
            wall_s=time.monotonic() - t_round,
            goal_results=results[0].goal_results, compiles=0, env=env0, state=st0,
            num_proposals=sum(len(r.proposals) for r in results),
            num_replica_movements=sum(r.num_replica_movements for r in results),
            num_leadership_movements=sum(r.num_leadership_movements for r in results),
            session_info=dict(self.last_fleet_round), donated=False,
            opt_generation=opt_gen, round_mode="revalidated", revalidate_s=reval_s)
        for r in results:
            r.round_trace = trace
        return results
