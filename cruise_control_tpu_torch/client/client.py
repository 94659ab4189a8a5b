"""HTTP client with async-task polling (counterpart of
``cruise_control_tpu/client/client.py``).

Reference: cruise-control-client/cruisecontrolclient/client/ — Endpoint.py
(one class per REST endpoint, each declaring its allowed parameters),
Query.py (URL building), Responder.py (the retry/poll loop that follows
202 + User-Task-ID until the final response). Parameter validation reuses the
server's endpoint specs (cruise_control_tpu_torch.api.endpoints) — single source of
truth instead of the reference's duplicated CCParameter classes.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request

from cruise_control_tpu_torch.api.endpoints import (
    COMMON_PARAMS, ENDPOINT_PARAMS, GET_ENDPOINTS, EndPoint,
)
from cruise_control_tpu_torch.api.user_tasks import USER_TASK_HEADER_NAME

URL_PREFIX = "/kafkacruisecontrol"


class CruiseControlClientError(Exception):
    def __init__(self, message: str, status: int = 0, body: dict | None = None):
        super().__init__(message)
        self.status = status
        self.body = body or {}


def _encode_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


class CruiseControlClient:
    """One method per endpoint; async 202 responses are polled to completion
    via the User-Task-ID header (Responder.py retry loop role)."""

    def __init__(self, address: str, timeout_s: float = 300.0,
                 poll_interval_s: float = 1.0, auth: tuple | None = None):
        if "://" not in address:
            address = f"http://{address}"
        self.base_url = address.rstrip("/")
        if not self.base_url.endswith(URL_PREFIX):
            self.base_url += URL_PREFIX
        self.timeout_s = timeout_s
        self.poll_interval_s = poll_interval_s
        # session cookie jar (the reference client rides requests.Session;
        # the server's CCSESSIONID scopes user-task affinity per session)
        self._session_cookie: str | None = None
        self._auth_header = None
        if auth is not None:
            import base64
            user, password = auth
            self._auth_header = "Basic " + base64.b64encode(
                f"{user}:{password}".encode()).decode()

    # ------------------------------------------------------------ plumbing
    def _validate(self, endpoint: EndPoint, params: dict) -> dict:
        spec = {**COMMON_PARAMS, **ENDPOINT_PARAMS[endpoint]}
        clean = {}
        for k, v in params.items():
            if v is None:
                continue
            if k not in spec:
                raise CruiseControlClientError(
                    f"unknown parameter {k!r} for {endpoint.path} "
                    f"(allowed: {sorted(spec)})")
            clean[k] = _encode_value(v)
        return clean

    def _request_once(self, method: str, endpoint: EndPoint, query: dict,
                      task_id: str | None):
        url = f"{self.base_url}/{endpoint.path}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        headers = {}
        if task_id:
            headers[USER_TASK_HEADER_NAME] = task_id
        if self._auth_header:
            headers["Authorization"] = self._auth_header
        if self._session_cookie:
            headers["Cookie"] = self._session_cookie
        req = urllib.request.Request(url, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                set_cookie = resp.headers.get("Set-Cookie")
                if set_cookie:
                    self._session_cookie = set_cookie.split(";", 1)[0]
                return resp.status, json.loads(resp.read().decode()), \
                    resp.headers.get(USER_TASK_HEADER_NAME)
        except urllib.error.HTTPError as e:
            body = {}
            try:
                body = json.loads(e.read().decode() or "{}")
            except json.JSONDecodeError:
                pass
            raise CruiseControlClientError(
                body.get("errorMessage", str(e)), status=e.code,
                body=body) from None

    def request(self, endpoint: EndPoint, **params) -> dict:
        """Issue a request, following the 202-progress protocol to the final
        response. Returns the response body dict."""
        method = "GET" if endpoint in GET_ENDPOINTS else "POST"
        query = self._validate(endpoint, params)
        deadline = time.time() + self.timeout_s
        status, body, task_id = self._request_once(method, endpoint, query, None)
        while status == 202 and "reviewResult" not in body:
            if time.time() > deadline:
                raise CruiseControlClientError(
                    f"{endpoint.path} still in progress after "
                    f"{self.timeout_s}s (task {task_id})", status=202, body=body)
            time.sleep(self.poll_interval_s)
            status, body, task_id = self._request_once(
                method, endpoint, query, task_id)
        return body

    # ---------------------------------------------------------- endpoints
    def state(self, **p) -> dict:
        return self.request(EndPoint.STATE, **p)

    def kafka_cluster_state(self, **p) -> dict:
        return self.request(EndPoint.KAFKA_CLUSTER_STATE, **p)

    def load(self, **p) -> dict:
        return self.request(EndPoint.LOAD, **p)

    def partition_load(self, **p) -> dict:
        return self.request(EndPoint.PARTITION_LOAD, **p)

    def proposals(self, **p) -> dict:
        return self.request(EndPoint.PROPOSALS, **p)

    def rebalance(self, **p) -> dict:
        return self.request(EndPoint.REBALANCE, **p)

    def add_broker(self, brokerid, **p) -> dict:
        return self.request(EndPoint.ADD_BROKER, brokerid=brokerid, **p)

    def remove_broker(self, brokerid, **p) -> dict:
        return self.request(EndPoint.REMOVE_BROKER, brokerid=brokerid, **p)

    def demote_broker(self, brokerid, **p) -> dict:
        return self.request(EndPoint.DEMOTE_BROKER, brokerid=brokerid, **p)

    def fix_offline_replicas(self, **p) -> dict:
        return self.request(EndPoint.FIX_OFFLINE_REPLICAS, **p)

    def stop_proposal_execution(self, **p) -> dict:
        return self.request(EndPoint.STOP_PROPOSAL_EXECUTION, **p)

    def pause_sampling(self, **p) -> dict:
        return self.request(EndPoint.PAUSE_SAMPLING, **p)

    def resume_sampling(self, **p) -> dict:
        return self.request(EndPoint.RESUME_SAMPLING, **p)

    def user_tasks(self, **p) -> dict:
        return self.request(EndPoint.USER_TASKS, **p)

    def bootstrap(self, **p) -> dict:
        return self.request(EndPoint.BOOTSTRAP, **p)

    def train(self, **p) -> dict:
        return self.request(EndPoint.TRAIN, **p)

    def admin(self, **p) -> dict:
        return self.request(EndPoint.ADMIN, **p)

    def review(self, **p) -> dict:
        return self.request(EndPoint.REVIEW, **p)

    def review_board(self, **p) -> dict:
        return self.request(EndPoint.REVIEW_BOARD, **p)

    def topic_configuration(self, topic: str, replication_factor: int, **p) -> dict:
        return self.request(EndPoint.TOPIC_CONFIGURATION, topic=topic,
                            replication_factor=replication_factor, **p)
