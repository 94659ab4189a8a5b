"""(Counterpart of ``cruise_control_tpu/executor/task.py``, with the port's imports.)
Execution tasks + state machine.

Reference: executor/ExecutionTask.java with ExecutionTaskState.java
(PENDING -> IN_PROGRESS -> {COMPLETED, ABORTING -> ABORTED, DEAD}) and
ExecutionTaskManager.java (487: per-broker in-flight accounting).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal


class TaskType(enum.Enum):
    INTER_BROKER_REPLICA_ACTION = "INTER_BROKER_REPLICA_ACTION"
    INTRA_BROKER_REPLICA_ACTION = "INTRA_BROKER_REPLICA_ACTION"
    LEADER_ACTION = "LEADER_ACTION"


class TaskState(enum.Enum):
    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"
    ABORTING = "ABORTING"
    ABORTED = "ABORTED"
    DEAD = "DEAD"
    COMPLETED = "COMPLETED"


_ids = itertools.count()


@dataclasses.dataclass
class ExecutionTask:
    proposal: ExecutionProposal
    task_type: TaskType
    task_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: TaskState = TaskState.PENDING
    start_ms: float = -1.0
    end_ms: float = -1.0

    # optional census observer ``(task, new_state, now_ms)`` — the executor
    # sets it per execution so every transition lands in the durable event
    # journal (class attribute, not a dataclass field: to_json/asdict and
    # the task's equality semantics stay untouched)
    on_transition = None

    @property
    def tp(self) -> tuple:
        return (self.proposal.topic, self.proposal.partition)

    @property
    def brokers_involved(self) -> set:
        """Brokers whose in-flight budget this task consumes (source + dest)."""
        if self.task_type is TaskType.LEADER_ACTION:
            return {self.proposal.new_leader}
        return set(self.proposal.replicas_to_add) | set(self.proposal.replicas_to_remove)

    def transition(self, new_state: TaskState, now_ms: float = 0.0) -> None:
        legal = {
            TaskState.PENDING: {TaskState.IN_PROGRESS, TaskState.DEAD},
            TaskState.IN_PROGRESS: {TaskState.COMPLETED, TaskState.ABORTING,
                                    TaskState.DEAD},
            TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
        }
        if new_state not in legal.get(self.state, set()):
            raise ValueError(f"illegal transition {self.state} -> {new_state}")
        self.state = new_state
        if new_state is TaskState.IN_PROGRESS:
            self.start_ms = now_ms
        if new_state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD):
            self.end_ms = now_ms
        if self.on_transition is not None:
            self.on_transition(self, new_state, now_ms)

    def to_json(self) -> dict:
        return {"taskId": self.task_id, "type": self.task_type.value,
                "state": self.state.value, "proposal": self.proposal.to_json()}
