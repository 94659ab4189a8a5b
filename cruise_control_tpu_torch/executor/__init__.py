"""The executor (counterpart of ``cruise_control_tpu/executor/``)."""
from cruise_control_tpu_torch.executor.executor import (
    Executor, ExecutorState, SimClock, WallClock,
)
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import (
    STRATEGY_CLASSES, build_strategy, sort_tasks,
)
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskState, TaskType

__all__ = [
    "Executor", "ExecutorState", "SimClock", "WallClock",
    "ExecutionTaskPlanner", "ExecutionTask", "TaskState", "TaskType",
    "STRATEGY_CLASSES", "build_strategy", "sort_tasks",
]
