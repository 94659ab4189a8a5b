"""(Counterpart of ``cruise_control_tpu/executor/strategy.py``, with the port's imports.)
Replica-movement ordering strategies.

Reference: executor/strategy/ (423 LoC): composable comparator chain deciding
inter-broker execution order — BaseReplicaMovementStrategy,
PostponeUrpReplicaMovementStrategy, PrioritizeLargeReplicaMovementStrategy,
PrioritizeSmallReplicaMovementStrategy,
PrioritizeMinIsrWithOfflineReplicasStrategy. A strategy maps a task to a sort
key; chained strategies compare lexicographically, with the base strategy
(task id order = deterministic) as the implicit tail.
"""
from __future__ import annotations

from typing import Iterable

from cruise_control_tpu_torch.executor.task import ExecutionTask


class ReplicaMovementStrategy:
    name = "ReplicaMovementStrategy"

    def configure(self, config, **extra):
        pass

    def key(self, task: ExecutionTask, context: dict) -> tuple:
        """Sort key component; lower sorts earlier."""
        return ()

    def chain(self, next_strategy: "ReplicaMovementStrategy") -> "ChainedStrategy":
        return ChainedStrategy([self, next_strategy])


class ChainedStrategy(ReplicaMovementStrategy):
    def __init__(self, strategies: list):
        self._strategies = list(strategies)
        self.name = "+".join(s.name for s in strategies)

    def chain(self, next_strategy):
        return ChainedStrategy(self._strategies + [next_strategy])

    def key(self, task, context):
        return tuple(k for s in self._strategies for k in s.key(task, context))


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """Deterministic task-id order."""
    name = "BaseReplicaMovementStrategy"

    def key(self, task, context):
        return (task.task_id,)


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move partitions WITHOUT under-replicated/offline replicas first."""
    name = "PostponeUrpReplicaMovementStrategy"

    def key(self, task, context):
        urp = context.get("under_replicated", set())
        return (1 if task.tp in urp else 0,)


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    name = "PrioritizeLargeReplicaMovementStrategy"

    def key(self, task, context):
        sizes = context.get("partition_size_mb", {})
        return (-sizes.get(task.tp, 0.0),)


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    name = "PrioritizeSmallReplicaMovementStrategy"

    def key(self, task, context):
        sizes = context.get("partition_size_mb", {})
        return (sizes.get(task.tp, 0.0),)


class PrioritizeMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """(At/Under)-MinISR partitions with offline replicas move first."""
    name = "PrioritizeMinIsrWithOfflineReplicasStrategy"

    def key(self, task, context):
        urgent = context.get("min_isr_with_offline", set())
        return (0 if task.tp in urgent else 1,)


STRATEGY_CLASSES = {c.name: c for c in (
    BaseReplicaMovementStrategy, PostponeUrpReplicaMovementStrategy,
    PrioritizeLargeReplicaMovementStrategy, PrioritizeSmallReplicaMovementStrategy,
    PrioritizeMinIsrWithOfflineReplicasStrategy)}


def strategy_registry(specs: Iterable[str]) -> dict:
    """Resolve ExecutorConfig ``replica.movement.strategies`` — the catalog
    of available strategy classes (built-ins by bare name, plugins by dotted
    path) — into a name -> class map including every built-in."""
    from cruise_control_tpu_torch.config.configdef import resolve_class
    registry = dict(STRATEGY_CLASSES)
    for spec in specs or ():
        if isinstance(spec, str) and spec in registry:
            continue
        cls = resolve_class(spec)
        registry[getattr(cls, "name", cls.__name__)] = cls
    return registry


def build_strategy(names: Iterable[str],
                   registry: dict | None = None) -> ReplicaMovementStrategy:
    """Compose a chain, always terminated by the base strategy for determinism
    (BaseReplicaMovementStrategy is the reference's implicit tie-breaker).
    Unknown names raise — a typo'd strategy silently ignored would reorder an
    entire execution."""
    registry = registry or STRATEGY_CLASSES
    chain = []
    for n in names:
        short = n.rsplit(".", 1)[-1] if isinstance(n, str) else n
        if short not in registry:
            raise ValueError(f"unknown replica movement strategy {n!r}; "
                             f"available: {sorted(registry)}")
        chain.append(registry[short]())
    if not any(isinstance(s, BaseReplicaMovementStrategy) for s in chain):
        chain.append(BaseReplicaMovementStrategy())
    return ChainedStrategy(chain)


def sort_tasks(tasks: list, strategy: ReplicaMovementStrategy, context: dict) -> list:
    return sorted(tasks, key=lambda t: strategy.key(t, context))
