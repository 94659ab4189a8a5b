"""Two-step verification purgatory (counterpart of
``cruise_control_tpu/api/purgatory.py``).

Reference: servlet/purgatory/Purgatory.java (280 LoC) + ReviewStatus.java.
When ``two.step.verification.enabled`` is on, every POST request (except
/review itself) is parked as PENDING_REVIEW with an integer review id; an
admin approves or discards it via POST /review; the originator then re-issues
the request with ``review_id=<id>`` to actually run it (state APPROVED ->
SUBMITTED). GET /review_board lists the requests.
"""
from __future__ import annotations

import enum
import threading
import time

from cruise_control_tpu_torch.api.endpoints import EndPoint


class ReviewStatus(enum.Enum):
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


# Legal transitions (Purgatory.java ReviewStatus state machine).
_TRANSITIONS = {
    ReviewStatus.PENDING_REVIEW: {ReviewStatus.APPROVED, ReviewStatus.DISCARDED},
    ReviewStatus.APPROVED: {ReviewStatus.SUBMITTED, ReviewStatus.DISCARDED},
    ReviewStatus.SUBMITTED: set(),
    ReviewStatus.DISCARDED: set(),
}


class RequestInfo:
    def __init__(self, review_id: int, endpoint: EndPoint, params: dict,
                 submitter: str, now_ms: float):
        self.review_id = review_id
        self.endpoint = endpoint
        self.params = params
        self.submitter = submitter
        self.submission_ms = now_ms
        self.status = ReviewStatus.PENDING_REVIEW
        self.reason = ""

    def to_json(self) -> dict:
        return {
            "Id": self.review_id,
            "SubmitterAddress": self.submitter,
            "SubmissionTimeMs": int(self.submission_ms),
            "Status": self.status.value,
            "EndPoint": self.endpoint.path.upper(),
            "Reason": self.reason,
        }


class Purgatory:
    def __init__(self, retention_ms: float = 7 * 24 * 3600 * 1000.0,
                 max_requests: int = 25, max_cached_completed: int = 100,
                 time_fn=None):
        """``max_requests`` caps requests awaiting review
        (two.step.purgatory.max.requests); ``max_cached_completed`` caps
        finished (submitted/discarded) requests kept for the review board
        (two.step.purgatory.max.cached.completed.requests)."""
        self._retention_ms = retention_ms
        self._max_requests = max_requests
        self._max_completed = max_cached_completed
        self._time = time_fn or (lambda: time.time() * 1000.0)
        self._lock = threading.Lock()
        self._requests: dict[int, RequestInfo] = {}
        self._next_id = 0

    def add(self, endpoint: EndPoint, params: dict, submitter: str) -> RequestInfo:
        with self._lock:
            self._remove_old()
            pending = sum(1 for i in self._requests.values()
                          if i.status in (ReviewStatus.PENDING_REVIEW,
                                          ReviewStatus.APPROVED))
            if pending >= self._max_requests:
                raise ValueError(
                    f"two-step purgatory is full ({pending} requests awaiting "
                    f"review >= two.step.purgatory.max.requests="
                    f"{self._max_requests})")
            rid = self._next_id
            self._next_id += 1
            info = RequestInfo(rid, endpoint, params, submitter, self._time())
            self._requests[rid] = info
            return info

    def _remove_old(self) -> None:
        now = self._time()
        for rid, info in list(self._requests.items()):
            if now - info.submission_ms > self._retention_ms:
                del self._requests[rid]
        done = [(rid, i) for rid, i in self._requests.items()
                if i.status in (ReviewStatus.SUBMITTED, ReviewStatus.DISCARDED)]
        if len(done) > self._max_completed:
            done.sort(key=lambda e: e[1].submission_ms)
            for rid, _ in done[:len(done) - self._max_completed]:
                del self._requests[rid]

    def _transition(self, rid: int, to: ReviewStatus, reason: str) -> RequestInfo:
        info = self._requests.get(rid)
        if info is None:
            raise KeyError(f"unknown review id {rid}")
        if to not in _TRANSITIONS[info.status]:
            raise ValueError(
                f"review {rid} cannot go {info.status.value} -> {to.value}")
        info.status = to
        info.reason = reason
        return info

    def approve(self, rid: int, reason: str = "approved") -> RequestInfo:
        with self._lock:
            return self._transition(rid, ReviewStatus.APPROVED, reason)

    def discard(self, rid: int, reason: str = "discarded") -> RequestInfo:
        with self._lock:
            return self._transition(rid, ReviewStatus.DISCARDED, reason)

    def ensure_approved(self, rid: int, endpoint: EndPoint) -> RequestInfo:
        """Check a resubmission is legal WITHOUT consuming the approval (the
        APPROVED -> SUBMITTED transition happens only once the operation has
        actually been dispatched, so a failed dispatch can be retried)."""
        with self._lock:
            info = self._requests.get(rid)
            if info is None:
                raise KeyError(f"unknown review id {rid}")
            if info.endpoint is not endpoint:
                raise ValueError(
                    f"review {rid} was parked for {info.endpoint.path}, "
                    f"not {endpoint.path}")
            if info.status is not ReviewStatus.APPROVED:
                raise ValueError(
                    f"review {rid} is {info.status.value}, not APPROVED")
            return info

    def submit(self, rid: int, endpoint: EndPoint) -> RequestInfo:
        """Called when a request arrives carrying review_id: it must match the
        parked endpoint and be APPROVED (Purgatory.submit semantics)."""
        with self._lock:
            info = self._requests.get(rid)
            if info is None:
                raise KeyError(f"unknown review id {rid}")
            if info.endpoint is not endpoint:
                raise ValueError(
                    f"review {rid} was parked for {info.endpoint.path}, "
                    f"not {endpoint.path}")
            return self._transition(rid, ReviewStatus.SUBMITTED, "submitted")

    def request_params(self, rid: int) -> dict:
        with self._lock:
            return dict(self._requests[rid].params)

    def board(self, review_ids: list[int] | None = None) -> list[dict]:
        with self._lock:
            self._remove_old()
            rows = [i.to_json() for i in self._requests.values()
                    if not review_ids or i.review_id in review_ids]
        return sorted(rows, key=lambda r: r["Id"])
