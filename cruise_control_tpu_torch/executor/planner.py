"""(Counterpart of ``cruise_control_tpu/executor/planner.py``, with the port's imports.)
Execution task planning.

Reference: executor/ExecutionTaskPlanner.java:65-78 — splits proposals into
inter-broker replica moves, intra-broker (logdir) moves and leadership moves;
orders inter-broker moves by the configured strategy chain and serves them
round-robin across brokers so no broker monopolizes the movement budget
(:322-394 getInterBrokerReplicaMovementTasks).
"""
from __future__ import annotations

import collections

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.strategy import (
    ReplicaMovementStrategy, build_strategy, sort_tasks,
)
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskType


class ExecutionTaskPlanner:
    def __init__(self, strategy: ReplicaMovementStrategy | None = None):
        self._strategy = strategy or build_strategy(["BaseReplicaMovementStrategy"])
        self._inter: list[ExecutionTask] = []
        self._intra: list[ExecutionTask] = []
        self._leader: list[ExecutionTask] = []

    def add_proposals(self, proposals: list, context: dict | None = None) -> None:
        context = context or {}
        for p in proposals:
            if p.replicas_to_add or p.replicas_to_remove:
                self._inter.append(ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION))
            elif self._has_logdir_change(p):
                self._intra.append(ExecutionTask(p, TaskType.INTRA_BROKER_REPLICA_ACTION))
            if p.has_leader_action:
                self._leader.append(ExecutionTask(p, TaskType.LEADER_ACTION))
        self._inter = sort_tasks(self._inter, self._strategy, context)

    def adopt_tasks(self, tasks_by_type: dict) -> None:
        """HA failover adoption: file pre-built tasks directly, in the order
        given. The dead leader's strategy sort is already baked into the
        journaled plan indexes the caller sorted by, so re-sorting here
        would only diverge the adopted order from the census."""
        self._inter.extend(tasks_by_type.get(TaskType.INTER_BROKER_REPLICA_ACTION, []))
        self._intra.extend(tasks_by_type.get(TaskType.INTRA_BROKER_REPLICA_ACTION, []))
        self._leader.extend(tasks_by_type.get(TaskType.LEADER_ACTION, []))

    @staticmethod
    def _has_logdir_change(p: ExecutionProposal) -> bool:
        old = dict(p.old_replicas)
        return any(old.get(b) is not None and old.get(b) != d
                   for b, d in p.new_replicas)

    @property
    def remaining_inter_broker(self) -> list:
        return [t for t in self._inter if t.state.value == "PENDING"]

    @property
    def remaining_intra_broker(self) -> list:
        return [t for t in self._intra if t.state.value == "PENDING"]

    @property
    def remaining_leadership(self) -> list:
        return [t for t in self._leader if t.state.value == "PENDING"]

    def next_inter_broker_tasks(self, in_flight_by_broker: dict, per_broker_cap: int,
                                cluster_cap: int, in_flight_total: int) -> list:
        """Pick the next executable batch honoring per-broker + cluster caps,
        round-robin over brokers in strategy order."""
        picked: list[ExecutionTask] = []
        budget = collections.Counter(in_flight_by_broker)
        total = in_flight_total
        for task in self._inter:
            if task.state.value != "PENDING":
                continue
            if total >= cluster_cap:
                break
            involved = task.brokers_involved
            if any(budget[b] >= per_broker_cap for b in involved):
                continue
            for b in involved:
                budget[b] += 1
            total += 1
            picked.append(task)
        return picked

    def next_leadership_tasks(self, cap: int) -> list:
        out = [t for t in self._leader if t.state.value == "PENDING"][:cap]
        return out

    def next_intra_broker_tasks(self, in_flight_by_broker: dict, per_broker_cap: int) -> list:
        picked = []
        budget = collections.Counter(in_flight_by_broker)
        for t in self._intra:
            if t.state.value != "PENDING":
                continue
            b = t.proposal.new_replicas[0][0] if t.proposal.new_replicas else None
            if b is None or budget[b] >= per_broker_cap:
                continue
            budget[b] += 1
            picked.append(t)
        return picked

    @property
    def all_tasks(self) -> list:
        return self._inter + self._intra + self._leader
