"""Async user-task tracking with UUID handles (counterpart of
``cruise_control_tpu/api/user_tasks.py``).

Reference: servlet/UserTaskManager.java (836 LoC) — every async request gets a
UUID returned in the ``User-Task-ID`` response header; a repeated identical
request from the same client resumes the same task instead of spawning a new
one; completed tasks are retained per endpoint type for a configurable window
and listed by GET /user_tasks.

Differences from the reference: session affinity is (client_ip, endpoint,
query-params) rather than a servlet HttpSession cookie — same dedup contract,
no cookie jar needed — and expiry runs inline on access instead of on a
5-second scanner thread (deterministic under test clocks).
"""
from __future__ import annotations

import enum
import threading
import time
import uuid as uuid_mod
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

from cruise_control_tpu_torch.api.endpoints import EndPoint
from cruise_control_tpu_torch.api.progress import OperationProgress

USER_TASK_HEADER_NAME = "User-Task-ID"


class UserTaskLimitError(RuntimeError):
    """max.active.user.tasks overflow — the servlet maps this to the
    reference's 429 Too Many Requests (not a generic 500)."""


class TaskState(enum.Enum):
    """UserTaskManager.TaskState (ACTIVE/IN_EXECUTION/COMPLETED/COMPLETED_WITH_ERROR)."""
    ACTIVE = "Active"
    IN_EXECUTION = "InExecution"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"


class UserTaskInfo:
    def __init__(self, task_id: str, endpoint: EndPoint, method: str,
                 params: dict[str, Any], client: str, start_ms: float):
        self.task_id = task_id
        self.endpoint = endpoint
        self.method = method
        self.params = params
        self.client = client
        self.start_ms = start_ms
        self.progress = OperationProgress(endpoint.path)
        self.future: Future | None = None
        self.execution_began_ms: float | None = None
        self.execution_finished_ms: float | None = None
        self.completed_ms: float | None = None
        self.state = TaskState.ACTIVE

    @property
    def done(self) -> bool:
        return self.future is not None and self.future.done()

    def result_json(self) -> dict:
        assert self.future is not None
        return self.future.result()

    def to_json(self) -> dict:
        status = self.state.value
        if self.state is TaskState.ACTIVE and self.done:
            status = (TaskState.COMPLETED_WITH_ERROR.value
                      if self.future.exception() else TaskState.COMPLETED.value)
        return {
            "UserTaskId": self.task_id,
            "RequestURL": f"{self.method} /{self.endpoint.path}",
            "ClientIdentity": self.client,
            "StartMs": int(self.start_ms),
            "Status": status,
        }


class UserTaskManager:
    """UUID-per-async-request tracking (UserTaskManager.java:221-276)."""

    def __init__(self, max_active_tasks: int = 25,
                 completed_task_retention_ms: float = 24 * 3600 * 1000.0,
                 session_expiry_ms: float = 60 * 1000.0,
                 max_workers: int = 8,
                 time_fn: Callable[[], float] | None = None,
                 max_cached_completed: int = 100,
                 max_cached_completed_by_type: dict | None = None):
        self._max_active = max_active_tasks
        self._retention_ms = completed_task_retention_ms
        self._session_expiry_ms = session_expiry_ms
        # completed-task cache caps: global (UserTaskManagerConfig
        # max.cached.completed.user.tasks) + per endpoint type
        # (max.cached.completed.{kafka.admin,kafka.monitor,...}.user.tasks;
        # None entries fall back to the global cap)
        self._max_completed = max_cached_completed
        self._max_completed_by_type = dict(max_cached_completed_by_type or {})
        self._time = time_fn or (lambda: time.time() * 1000.0)
        self._lock = threading.Lock()
        self._executor = ThreadPoolExecutor(max_workers=max_workers,
                                            thread_name_prefix="user-task")
        # session key -> task id (UserTaskManager._sessionKeyToUserTaskIdMap)
        self._session_to_task: dict[tuple, tuple[str, float]] = {}
        self._active: dict[str, UserTaskInfo] = {}
        self._completed: dict[str, UserTaskInfo] = {}

    @staticmethod
    def _session_key(client: str, endpoint: EndPoint, params: dict) -> tuple:
        frozen = tuple(sorted((k, str(v)) for k, v in params.items()))
        return (client, endpoint, frozen)

    def _expire(self) -> None:
        now = self._time()
        for tid, task in list(self._active.items()):
            if task.done:
                task.state = (TaskState.COMPLETED_WITH_ERROR
                              if task.future.exception() else TaskState.COMPLETED)
                task.completed_ms = now
                self._completed[tid] = task
                del self._active[tid]
        for key, (tid, ts) in list(self._session_to_task.items()):
            task = self._active.get(tid) or self._completed.get(tid)
            if task is None:
                if now - ts > self._session_expiry_ms:
                    del self._session_to_task[key]
                continue
            # sessions stay bound while the task runs; the expiry clock starts
            # when the task completes (UserTaskManager.expireOldSessions keeps
            # sessions alive across long-running operations the same way)
            if task.done and now - (task.completed_ms or ts) > self._session_expiry_ms:
                del self._session_to_task[key]
        for tid, task in list(self._completed.items()):
            # retention runs from completion, not start: a long-running task
            # must still be retrievable for the full window after it finishes
            if now - (task.completed_ms or task.start_ms) > self._retention_ms:
                del self._completed[tid]
        # enforce the per-endpoint-type completed caps, oldest evicted first
        by_type: dict = {}
        for tid, task in self._completed.items():
            by_type.setdefault(task.endpoint.endpoint_type, []).append((tid, task))
        for etype, entries in by_type.items():
            cap = self._max_completed_by_type.get(etype)
            cap = self._max_completed if cap is None else cap
            if len(entries) > cap:
                entries.sort(key=lambda e: e[1].completed_ms or e[1].start_ms)
                for tid, _ in entries[:len(entries) - cap]:
                    del self._completed[tid]
        # ... and the GLOBAL completed cap across all types
        if len(self._completed) > self._max_completed:
            ordered = sorted(self._completed.items(),
                             key=lambda e: e[1].completed_ms or e[1].start_ms)
            for tid, _ in ordered[:len(ordered) - self._max_completed]:
                del self._completed[tid]

    def get_or_create_task(self, client: str, endpoint: EndPoint, method: str,
                           params: dict[str, Any],
                           work: Callable[[OperationProgress], dict],
                           task_id: str | None = None,
                           idempotent: bool = True) -> UserTaskInfo:
        """Resume the task named by the User-Task-ID header, or the one bound
        to this (client, endpoint, params) session, or start a new one.

        ``idempotent=False`` (mutating ops: non-dry-run rebalance etc.) only
        resumes session-bound tasks that are still running — a COMPLETED
        mutating op must not be silently replayed from cache for a fresh
        request; the reference avoids this via HttpSession cookies that a new
        client invocation would not carry."""
        with self._lock:
            self._expire()
            if task_id is not None:
                task = self._active.get(task_id) or self._completed.get(task_id)
                if task is None:
                    raise KeyError(f"unknown User-Task-ID {task_id!r}")
                if (task.endpoint, task.params) != (endpoint, params):
                    raise KeyError(
                        f"User-Task-ID {task_id!r} was created by a different "
                        f"request ({task.endpoint.path})")
                # bind the CALLER's session too: a poll from a fresh session
                # that resumes by header must leave that session able to
                # find the task by cookie alone afterwards (the reference
                # re-associates the HttpSession on every request)
                self._session_to_task[self._session_key(client, endpoint,
                                                        params)] = (
                    task.task_id, self._time())
                return task
            skey = self._session_key(client, endpoint, params)
            bound = self._session_to_task.get(skey)
            if bound is not None:
                task = self._active.get(bound[0]) or self._completed.get(bound[0])
                if task is not None and (idempotent or not task.done):
                    return task
            if len(self._active) >= self._max_active:
                raise UserTaskLimitError(
                    f"there are already {len(self._active)} active user tasks, "
                    f"which has reached the limit {self._max_active}")
            tid = str(uuid_mod.uuid4())
            task = UserTaskInfo(tid, endpoint, method, params, client, self._time())
            task.future = self._executor.submit(work, task.progress)
            self._active[tid] = task
            self._session_to_task[skey] = (tid, self._time())
            return task

    def get_task(self, task_id: str) -> UserTaskInfo | None:
        with self._lock:
            self._expire()
            return self._active.get(task_id) or self._completed.get(task_id)

    def mark_execution_began(self, task_id: str) -> None:
        """markTaskExecutionBegan (:400) — proposal execution started."""
        with self._lock:
            task = self._active.get(task_id) or self._completed.get(task_id)
            if task is not None:
                task.state = TaskState.IN_EXECUTION
                task.execution_began_ms = self._time()

    def mark_execution_finished(self, task_id: str, error: bool = False) -> None:
        with self._lock:
            task = self._active.get(task_id) or self._completed.get(task_id)
            if task is not None:
                task.state = (TaskState.COMPLETED_WITH_ERROR if error
                              else TaskState.COMPLETED)
                task.execution_finished_ms = self._time()

    def all_tasks(self) -> list[UserTaskInfo]:
        with self._lock:
            self._expire()
            tasks = list(self._active.values()) + list(self._completed.values())
        return sorted(tasks, key=lambda t: t.start_ms)

    def close(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)
