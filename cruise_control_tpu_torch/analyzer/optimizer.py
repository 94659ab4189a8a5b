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
the engine's ``_sweep_env``). Sessions and the config surface raise
``NotImplementedError`` naming the ROADMAP item that ports them. A hard-goal failure raises ``OptimizationFailureError`` with the
result's provision recommendation.
"""
from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.engine import (
    EngineParams, _goal_loop, check_supported, optimize_goal, optimize_goal_chunked,
)
from cruise_control_tpu_torch.analyzer.env import (
    BalancingConstraint, ClusterEnv, OptimizationOptions, make_env,
    padded_partition_table, resolve_device,
)
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.analyzer.goals.leader_election import (
    PreferredLeaderElectionGoal,
)
from cruise_control_tpu_torch.analyzer.proposals import diff_proposals
from cruise_control_tpu_torch.analyzer.state import EngineState, init_state
from cruise_control_tpu_torch.common.resources import Resource
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
ESCALATION_MAX_REMAINING = 2048  # analyzer.finisher.escalation.max.remaining
ESCALATION_FACTOR = 4            # analyzer.finisher.escalation.factor

# reference config/defaults.py DEFAULT_GOALS / DEFAULT_HARD_GOALS
DEFAULT_GOALS = [
    "RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
    "DiskCapacityGoal", "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
    "PotentialNwOutGoal", "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal", "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
]
DEFAULT_HARD_GOALS = [
    "RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
    "DiskCapacityGoal", "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
]


def _resolve_compute_dtype(pinned: str, num_replicas: int) -> str:
    """The reference's precision policy with no config: an explicit
    ``EngineParams.compute_dtype`` wins, "auto" is bf16 at >= 256k replicas."""
    if pinned != "auto":
        return pinned
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
    round_trace: object = None    # the flight recorder is not ported yet

    @property
    def violated_goals_before(self) -> list[str]:
        return [g.name for g in self.goal_results if g.violated_before]

    @property
    def violated_goals_after(self) -> list[str]:
        return [g.name for g in self.goal_results if g.violated_after]


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
                 engine_params: EngineParams | None = None, device="cuda"):
        if config is not None:
            raise NotImplementedError("the config surface is not ported yet "
                                      "(ROADMAP.md Queue 1 item 7b); pass "
                                      "constraint= / engine_params=")
        self.device = resolve_device(device)
        self._constraint = constraint or BalancingConstraint()
        self._params = engine_params or EngineParams()
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
        small = num_replicas < FINISHER_MIN_REPLICAS
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
            compute_dtype=_resolve_compute_dtype(p.compute_dtype, num_replicas))

    def _escalate_unproven(self, env: ClusterEnv, st: EngineState, goals,
                           goal_results, params: EngineParams):
        """optimizer.py:1553: a goal whose finisher exited violated, unproven
        and with at most ESCALATION_MAX_REMAINING actions left re-enters its
        finisher once at the end of the chain, with finisher_rounds x
        ESCALATION_FACTOR, the budgeted loop skipped and every other chain
        goal's veto in force; then every verdict is refreshed. Returns the
        escalated state, or None when nothing escalated."""
        if params.finisher_rounds <= 0:
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
            if remaining <= ESCALATION_MAX_REMAINING:
                candidates.append((r, g))
        if not candidates:
            return None
        esc = dataclasses.replace(
            params, max_iters=0, stall_retries=0, tail_pass_budget=0,
            tail_total_budget=0, sat_stall_retries=0, sat_tail_passes=0,
            finisher_rounds=params.finisher_rounds * ESCALATION_FACTOR,
            finisher_swap_passes=params.finisher_swap_passes * ESCALATION_FACTOR)
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

    def optimizations(self, ct: ClusterTensor | None, meta: ClusterMeta | None = None,
                      goal_names: list[str] | None = None,
                      options: OptimizationOptions = OptimizationOptions(),
                      skip_hard_goal_check: bool = False,
                      raise_on_failure: bool = True,
                      measure_goal_durations: bool = False,
                      min_leader_topic_pattern: str | None = None,
                      session=None) -> OptimizerResult:
        if session is not None:
            raise NotImplementedError("resident sessions are not ported yet "
                                      "(ROADMAP.md Queue 1 item 9)")
        if measure_goal_durations:
            raise NotImplementedError("measure_goal_durations is not ported yet "
                                      "(ROADMAP.md Queue 1 item 7b)")
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

        ct, meta = pad_cluster(ct, meta)
        num_replicas, num_brokers = ct.num_replicas, ct.num_brokers
        params = self.scaled_params(num_replicas, num_brokers)
        check_supported(params)
        use_fused = num_replicas >= FUSED_MIN_REPLICAS
        use_chunked = params.pass_chunk > 0 and num_replicas >= CHUNK_MIN_REPLICAS

        tml = None
        if min_leader_topic_pattern:
            rx = re.compile(min_leader_topic_pattern)
            tml = np.asarray([bool(rx.fullmatch(t)) for t in meta.topic_names], bool)
            if tml.shape[0] < ct.num_topics:
                tml = np.pad(tml, (0, ct.num_topics - tml.shape[0]))
        part_table = padded_partition_table(ct)
        env = make_env(ct, meta, topic_min_leaders_mask=tml,
                       partition_table=part_table, device=self.device)
        st = init_state(env, ct.replica_broker, ct.replica_is_leader,
                        ct.replica_offline, ct.replica_disk)
        initial_broker = np.asarray(ct.replica_broker, np.int32)
        initial_leader = np.asarray(ct.replica_is_leader, bool)
        initial_disk = np.asarray(ct.replica_disk, np.int32)

        stats_before = cluster_stats_state(env, st)
        violated_before = dict(zip((g.name for g in goals),
                                   violations(goals, env, st)))
        infos, durations = [], []
        prev: tuple = ()
        # fused: the prefix up to the first deep-tail goal runs without the
        # finisher; each later goal (and, unfused, every goal) runs as its
        # own program with the finisher at its chain position
        split = (next((i for i, g in enumerate(goals) if g.deep_tail), len(goals))
                 if use_fused else 0)
        for gi, g in enumerate(goals):
            t0 = time.monotonic()
            if gi < split:
                st, info = _goal_loop(env, st, g, prev, params, finisher=False)
            elif use_chunked:
                st, info = optimize_goal_chunked(env, st, g, prev, params)
            else:
                st, info = optimize_goal(env, st, g, prev, params)
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
                finisher_skipped=info.get("finisher_skipped", False))
            for g, info, dur in zip(goals, infos, durations)]
        if run_preferred:
            # optimizer.py:1183 (unfused) / :2700 (fused, inside the final
            # program): after the chain, before the final stats and fetch
            ple = PreferredLeaderElectionGoal(constraint=self._constraint,
                                              options=options)
            t0 = time.monotonic()
            was, st, still = ple.run(env, st)
            was, still = (bool(v) for v in torch.stack([was, still]).tolist())
            goal_results.append(GoalResult(
                name=ple.name, violated_before=was, violated_after=still,
                iterations=1 if was else 0,
                duration_s=0.0 if use_fused else time.monotonic() - t0,
                stat_after=0.0))
        st_esc = self._escalate_unproven(env, st, goals, goal_results, params)
        if st_esc is not None:
            st = st_esc
        stats_after = cluster_stats_state(env, st)
        pb, plead, pdisk, data_mb = _pack_final(env, st)
        R = env.num_replicas
        final_broker = np.asarray(pb, np.int32)
        final_leader = np.unpackbits(plead)[:R].astype(bool)
        final_disk = np.asarray(pdisk, np.int32)
        proposals = diff_proposals(
            meta, initial_broker, initial_leader, initial_disk,
            final_broker, final_leader, final_disk,
            part_table, np.asarray(ct.replica_valid, bool),
            np.asarray(ct.replica_partition, np.int32))
        viol_after = {r.name: r.violated_after for r in goal_results}
        result = OptimizerResult(
            goal_results=goal_results, proposals=proposals,
            stats_before=stats_before, stats_after=stats_after,
            balancedness_before=_balancedness(goals, violated_before),
            balancedness_after=_balancedness(goals, viol_after),
            num_replica_movements=proposals.num_replica_additions,
            num_leadership_movements=proposals.num_leadership_changes,
            data_to_move_mb=data_mb,
            passes_dispatched=sum(r.passes for r in goal_results),
            passes_skipped=sum(r.passes_skipped for r in goal_results),
            early_exit_goals=sum(1 for r in goal_results if r.quiesce_chunk >= 0),
            final_state=st, env=env, meta=meta)
        if raise_on_failure:
            failed = [r.name + (" (iteration budget exhausted)" if r.hit_max_iters else "")
                      for r, g in zip(goal_results, goals)
                      if g.is_hard and r.violated_after]
            if failed:
                # optimizer.py:1358-1375: attach how many brokers are missing
                # (the floors' config keys are item 7b: their defaults here)
                rec = recommendation_from_result(result, self._constraint,
                                                 floors=ProvisionFloors())
                raise OptimizationFailureError(
                    f"hard goal(s) not satisfiable: {failed} "
                    f"[{rec.status.value}: {rec.reason}]",
                    recommendation=rec, result=result)
        return result
