"""Human-readable progress for long-running operations (counterpart of
``cruise_control_tpu/api/progress.py``).

Reference: servlet/../async/progress/OperationProgress.java and its step
classes (Pending, RetrievingMetrics, WaitingForClusterModel,
GeneratingClusterModel, OptimizationForGoal, ...). A progress object is
attached to each async user task; in-flight responses render it.
"""
from __future__ import annotations

import threading
import time


class OperationProgress:
    def __init__(self, operation: str = ""):
        self.operation = operation
        self._lock = threading.Lock()
        self._steps: list[dict] = []

    def add_step(self, description: str) -> None:
        with self._lock:
            now = time.time()
            if self._steps:
                last = self._steps[-1]
                last["timeInMs"] = round((now - last["_start"]) * 1000.0, 1)
                last["completionPercentage"] = 100.0
            self._steps.append({"step": description, "_start": now,
                                "timeInMs": 0.0, "completionPercentage": 0.0})

    def finish(self) -> None:
        with self._lock:
            if self._steps:
                last = self._steps[-1]
                last["timeInMs"] = round((time.time() - last["_start"]) * 1000.0, 1)
                last["completionPercentage"] = 100.0

    def to_json(self) -> list[dict]:
        with self._lock:
            return [{k: v for k, v in s.items() if not k.startswith("_")}
                    for s in self._steps]


# Canonical step names (async/progress/*.java class names).
PENDING = "Pending"
RETRIEVING_METRICS = "RetrievingMetrics"
GENERATING_CLUSTER_MODEL = "GeneratingClusterModel"
OPTIMIZATION_FOR_GOAL = "OptimizationForGoal"
