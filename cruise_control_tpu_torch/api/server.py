"""HTTP server: endpoint dispatch onto the CruiseControl facade (counterpart of
``cruise_control_tpu/api/server.py``).

Reference: servlet/KafkaCruiseControlServlet.java:40-120 (doGetOrPost
dispatch), KafkaCruiseControlApp.java:36-62 (server bootstrap; Jetty there,
stdlib ThreadingHTTPServer here — the control plane is host-side Python, the
the card only ever runs the optimizer kernels), handler/sync + handler/async
(async ops respond 202 + progress until the future completes, resumable via
the User-Task-ID header), UserTaskManager.java, purgatory/Purgatory.java.

URL shape matches the reference: /kafkacruisecontrol/<endpoint>?... (the
prefix is optional here).
"""
from __future__ import annotations

import http.cookies
import json
import threading
from concurrent import futures
import traceback
import urllib.parse
import uuid as uuid_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# the reference's servlet-container session cookie (JSESSIONID role)
SESSION_COOKIE = "CCSESSIONID"

from cruise_control_tpu_torch.api.endpoints import (
    ASYNC_ENDPOINTS, GET_ENDPOINTS, POST_ENDPOINTS, EndPoint, ParameterError,
    parse_params,
)
from cruise_control_tpu_torch.api.progress import (
    GENERATING_CLUSTER_MODEL, OPTIMIZATION_FOR_GOAL, PENDING,
)
from cruise_control_tpu_torch.api.purgatory import Purgatory
from cruise_control_tpu_torch.api.responses import error_json, wrap
from cruise_control_tpu_torch.api.security import AuthError, NoopSecurityProvider
from cruise_control_tpu_torch.api.user_tasks import (
    USER_TASK_HEADER_NAME, UserTaskLimitError, UserTaskManager,
)
from cruise_control_tpu_torch.common.retries import ServiceUnavailableError

URL_PREFIX = "/kafkacruisecontrol"


class AccessLog:
    """NCSA combined-ish access log (WebServerConfig webserver.accesslog.*:
    Jetty's RequestLogWriter role). Rotates daily — the current file is
    ``path``, finished days move to ``path.YYYY-MM-DD`` — and deletes rotated
    files older than the retention window (checked at startup and on each
    rotation, like Jetty's retainDays sweep)."""

    def __init__(self, path: str, retention_days: int = 14):
        import time as _t
        self._path = path
        self._retention_days = retention_days
        self._lock = threading.Lock()
        self._sweep()
        self._f = open(path, "a", buffering=1)
        self._day = _t.strftime("%Y-%m-%d")

    def _sweep(self) -> None:
        import glob
        import os
        import time as _t
        cutoff = _t.time() - self._retention_days * 86_400
        for old in glob.glob(self._path + ".*"):
            try:
                if os.path.getmtime(old) < cutoff:
                    os.unlink(old)
            except OSError:
                pass

    def _maybe_rotate(self) -> None:
        """Caller holds the lock. On day change, the open file is renamed to
        path.<previous-day> and a fresh one started."""
        import os
        import time as _t
        day = _t.strftime("%Y-%m-%d")
        if day == self._day:
            return
        try:
            self._f.close()
            os.replace(self._path, f"{self._path}.{self._day}")
        except OSError:
            pass
        self._f = open(self._path, "a", buffering=1)
        self._day = day
        self._sweep()

    def log(self, client_ip: str, method: str, path: str, status: int,
            length: int) -> None:
        import time as _t
        ts = _t.strftime("%d/%b/%Y:%H:%M:%S %z")
        with self._lock:
            self._maybe_rotate()
            self._f.write(f'{client_ip} - - [{ts}] "{method} {path} '
                          f'HTTP/1.1" {status} {length}\n')

    def close(self) -> None:
        self._f.close()


class CruiseControlServer:
    """Serves the 20 endpoints over HTTP against a CruiseControl facade."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0,
                 security_provider=None, two_step_verification: bool = False,
                 max_block_ms: float = 10_000.0, max_active_user_tasks: int = 25,
                 completed_user_task_retention_ms: float = 24 * 3600 * 1000.0,
                 ssl_context=None, config=None, fleet=None):
        """``ssl_context``: an ``ssl.SSLContext`` to serve HTTPS
        (KafkaCruiseControlApp.java:100-121 webserver.ssl.* role).
        ``config``: the framework Config — consumed for the webserver.* key
        families (CORS, access log, UI serving, reason requirement, session
        path, per-endpoint parameters/request class overrides, purgatory and
        user-task cache caps).
        ``fleet``: a :class:`~cruise_control_tpu_torch.fleet.FleetScheduler` —
        enables cluster-scoped routing: every endpoint accepts
        ``?cluster_id=<id>`` and dispatches to that tenant's facade with a
        per-tenant user-task quota (fleet.max.active.user.tasks.per.tenant);
        an unknown id is a declared 404, a malformed one a 400, and task ids
        never resolve across tenants (each tenant has its own task manager).
        ``app`` stays the default (un-scoped) facade."""
        self.app = app
        self.fleet = fleet
        self._tenant_user_tasks: dict[str, UserTaskManager] = {}
        self._tenant_tasks_lock = threading.Lock()
        self.security = security_provider or NoopSecurityProvider()
        self.two_step = two_step_verification
        cfg = config if config is not None else getattr(app, "config", None)
        if self.two_step and cfg is not None:
            self.purgatory = Purgatory(
                retention_ms=float(cfg.get_int(
                    "two.step.purgatory.retention.time.ms")),
                max_requests=cfg.get_int("two.step.purgatory.max.requests"),
                max_cached_completed=cfg.get_int(
                    "two.step.purgatory.max.cached.completed.requests"))
        else:
            self.purgatory = Purgatory() if two_step_verification else None
        by_type = {}
        if cfg is not None:
            from cruise_control_tpu_torch.api.endpoints import EndpointType
            for etype, key in (
                    (EndpointType.KAFKA_ADMIN,
                     "max.cached.completed.kafka.admin.user.tasks"),
                    (EndpointType.KAFKA_MONITOR,
                     "max.cached.completed.kafka.monitor.user.tasks"),
                    (EndpointType.CRUISE_CONTROL_ADMIN,
                     "max.cached.completed.cruise.control.admin.user.tasks"),
                    (EndpointType.CRUISE_CONTROL_MONITOR,
                     "max.cached.completed.cruise.control.monitor.user.tasks")):
                by_type[etype] = cfg.get(key)
        self.user_tasks = UserTaskManager(
            max_active_tasks=max_active_user_tasks,
            completed_task_retention_ms=completed_user_task_retention_ms,
            session_expiry_ms=(float(cfg.get_int(
                "webserver.session.maxExpiryTime")) if cfg is not None
                else 60_000.0),
            max_cached_completed=(cfg.get_int(
                "max.cached.completed.user.tasks") if cfg is not None else 100),
            max_cached_completed_by_type=by_type)
        # cluster-scoped requests get a PER-TENANT task manager: quota
        # isolation (one tenant's burst 429s alone) and no cross-tenant
        # task-id resolution (wrong-tenant resumption is a 404)
        self._tenant_task_quota = (
            cfg.get_int("fleet.max.active.user.tasks.per.tenant")
            if cfg is not None else 10)
        self._tenant_task_retention_ms = completed_user_task_retention_ms
        self.max_block_ms = max_block_ms
        # webserver.http.cors.*: headers attached to every response (+ the
        # OPTIONS preflight) when enabled
        self._cors: dict[str, str] | None = None
        if cfg is not None and cfg.get_boolean("webserver.http.cors.enabled"):
            self._cors = {
                "Access-Control-Allow-Origin":
                    cfg.get_string("webserver.http.cors.origin"),
                "Access-Control-Allow-Methods":
                    cfg.get_string("webserver.http.cors.allowmethods"),
                "Access-Control-Expose-Headers":
                    cfg.get_string("webserver.http.cors.exposeheaders"),
            }
            # on EVERY response, not just the preflight: a credentialed
            # fetch (session cookie / Authorization) is discarded by the
            # browser unless the actual response grants credentials too.
            # The Fetch spec forbids credentials with a wildcard origin, so
            # the grant only applies when a concrete origin is configured.
            if cfg.get_string("webserver.http.cors.origin") != "*":
                self._cors["Access-Control-Allow-Credentials"] = "true"
        self._reason_required = bool(
            cfg is not None and cfg.get_boolean("request.reason.required"))
        self._session_path = (cfg.get_string("webserver.session.path")
                              if cfg is not None else "/")
        # webserver.ui.diskpath/urlprefix: static cruise-control-ui serving
        self._ui_dir = (cfg.get_string("webserver.ui.diskpath")
                        if cfg is not None else "")
        self._ui_prefix = ((cfg.get_string("webserver.ui.urlprefix")
                            if cfg is not None else "/*").rstrip("*") or "/")
        # webserver.api.urlprefix (WebServerConfig.java:73-75): the API mount
        # point; "/kafkacruisecontrol/*" by default. The trailing * matches
        # the reference's servlet-spec wildcard
        self._api_prefix = ((cfg.get_string("webserver.api.urlprefix")
                             if cfg is not None else URL_PREFIX + "/*")
                            .rstrip("*").rstrip("/") or URL_PREFIX)
        self._access_log = None
        if cfg is not None and cfg.get_boolean("webserver.accesslog.enabled"):
            self._access_log = AccessLog(
                cfg.get_string("webserver.accesslog.path"),
                retention_days=cfg.get_int("webserver.accesslog.retention.days"))
        # per-endpoint parameter-parser / request-handler overrides
        # (CruiseControlParametersConfig / CruiseControlRequestConfig)
        self._param_overrides: dict[EndPoint, object] = {}
        self._request_overrides: dict[EndPoint, object] = {}
        if cfg is not None:
            from cruise_control_tpu_torch.config.defaults import endpoint_config_stem
            for ep in EndPoint:
                stem = endpoint_config_stem(ep.path)
                pc = cfg.get_class(f"{stem}.parameters.class")
                if pc is not None:
                    self._param_overrides[ep] = cfg.configure_instance(pc)
                rc = cfg.get_class(f"{stem}.request.class")
                if rc is not None:
                    self._request_overrides[ep] = cfg.configure_instance(rc)
        self._ssl = ssl_context
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        if ssl_context is not None:
            self._httpd.socket = ssl_context.wrap_socket(
                self._httpd.socket, server_side=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def base_url(self) -> str:
        host = self._httpd.server_address[0]
        scheme = "https" if self._ssl is not None else "http"
        return f"{scheme}://{host}:{self.port}{URL_PREFIX}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="cc-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self.user_tasks.close()
        with self._tenant_tasks_lock:
            for ut in self._tenant_user_tasks.values():
                ut.close()
            self._tenant_user_tasks.clear()
        if self._access_log is not None:
            self._access_log.close()

    # ------------------------------------------------------- fleet routing
    def tenant_binding(self, cluster_id: str):
        """(facade, task manager) for one tenant, or None when no fleet is
        mounted / the id is unknown (the dispatcher's declared-404 signal).
        Task managers are per tenant, created lazily with the per-tenant
        quota — a task id from tenant A can never resume under tenant B."""
        app = (self.fleet.app_for(cluster_id)
               if self.fleet is not None else None)
        if app is None:
            return None
        with self._tenant_tasks_lock:
            ut = self._tenant_user_tasks.get(cluster_id)
            if ut is None:
                ut = UserTaskManager(
                    max_active_tasks=self._tenant_task_quota,
                    completed_task_retention_ms=self._tenant_task_retention_ms)
                self._tenant_user_tasks[cluster_id] = ut
        return app, ut

    # ----------------------------------------------------------- dispatch
    def handle(self, method: str, endpoint: EndPoint, params: dict,
               client: str, task_id_header: str | None,
               app=None, user_tasks=None):
        """Returns (status_code, body_dict, extra_headers). ``app`` /
        ``user_tasks`` select a fleet tenant's facade + task manager; None
        = the default (un-scoped) instance."""
        import time as _time
        app = app if app is not None else self.app
        user_tasks = user_tasks if user_tasks is not None else self.user_tasks
        t0 = _time.monotonic()
        sensors = getattr(app, "sensors", None)
        # causal journal: one ROOT span per REST request (endpoint + method
        # + final status), on the app's clock — the per-endpoint latency
        # record tools/slo_diff.py gates journal p99s from
        tracer = getattr(app, "tracer", None)
        span = (tracer.span("request", endpoint.path, method=method)
                if tracer is not None else None)
        try:
            status, body, headers = self._handle(method, endpoint, params,
                                                 client, task_id_header,
                                                 app, user_tasks)
        except Exception as e:
            # parameter/validation errors raised mid-handling surface as
            # 4xx/5xx upstream — they are failed executions too
            if span is not None:
                span.end(error=type(e).__name__)
            if sensors is not None:
                sensors.timer(f"{endpoint.path}-failed-request-execution-timer"
                              ).record(_time.monotonic() - t0)
            raise
        if span is not None:
            span.end(status=status)
        # per-endpoint success/failure timers (KafkaCruiseControlServlet
        # .java:64 successfulRequestExecutionTimer + its failed twin); 202
        # progress polls / purgatory parks are NEITHER completed NOR failed
        # executions — recording them would make the timers describe polling
        if sensors is not None and status == 200:
            sensors.timer(f"{endpoint.path}-successful-request-execution-timer"
                          ).record(_time.monotonic() - t0)
        elif sensors is not None and status >= 400:
            sensors.timer(f"{endpoint.path}-failed-request-execution-timer"
                          ).record(_time.monotonic() - t0)
        return status, body, headers

    def _handle(self, method: str, endpoint: EndPoint, params: dict,
                client: str, task_id_header: str | None,
                app=None, user_tasks=None):
        headers: dict[str, str] = {}
        app = app if app is not None else self.app
        user_tasks = user_tasks if user_tasks is not None else self.user_tasks

        # <endpoint>.request.class override: the configured handler replaces
        # the built-in request processing wholesale
        override = self._request_overrides.get(endpoint)
        if override is not None:
            return override.handle(self, method, endpoint, params, client,
                                   task_id_header)

        # two-step verification: POSTs (except /review) must be reviewed
        # first. A request resuming an async task via User-Task-ID already
        # passed review when it was first submitted — re-submitting it to the
        # purgatory would dead-end the poll (SUBMITTED -> SUBMITTED).
        reviewed_rid = None
        if (self.purgatory is not None and method == "POST"
                and endpoint is not EndPoint.REVIEW
                and not (endpoint in ASYNC_ENDPOINTS and task_id_header)):
            rid = params.get("review_id")
            if rid is None:
                info = self.purgatory.add(endpoint, params, client)
                return 202, wrap({"reviewResult": info.to_json()}), headers
            # only consume the approval (APPROVED -> SUBMITTED) once the
            # operation is actually dispatched; a failed dispatch stays
            # APPROVED and can be retried
            self.purgatory.ensure_approved(rid, endpoint)
            params = {**self.purgatory.request_params(rid), "review_id": rid}
            reviewed_rid = rid

        if endpoint in ASYNC_ENDPOINTS:
            result = self._handle_async(method, endpoint, params, client,
                                        task_id_header, headers, app,
                                        user_tasks)
            if reviewed_rid is not None and result[0] in (200, 202):
                self.purgatory.submit(reviewed_rid, endpoint)
            return result
        result = 200, self._run_sync(endpoint, params, app), headers
        if reviewed_rid is not None:
            self.purgatory.submit(reviewed_rid, endpoint)
        return result

    # ------------------------------------------------------------- async
    def _handle_async(self, method, endpoint, params, client, task_id_header,
                      headers, app=None, user_tasks=None):
        app = app if app is not None else self.app
        user_tasks = user_tasks if user_tasks is not None else self.user_tasks
        # parameter problems must 400 before a task slot is consumed
        if params.get("excluded_topics"):
            import re
            try:
                re.compile(params["excluded_topics"])
            except re.error as e:
                raise ParameterError(
                    f"invalid excluded_topics regex "
                    f"{params['excluded_topics']!r}: {e}")
        if endpoint is EndPoint.TOPIC_CONFIGURATION and (
                not params["topic"] or params["replication_factor"] is None):
            raise ParameterError(
                "topic_configuration requires topic and replication_factor")
        if params.get("replica_movement_strategies"):
            try:
                app.executor.validate_strategies(
                    params["replica_movement_strategies"])
            except ValueError as e:
                raise ParameterError(str(e)) from None
        if (endpoint in (EndPoint.REBALANCE, EndPoint.PROPOSALS)
                and params.get("rebalance_disk") and params.get("goals")):
            intra = app.config.get_list("intra.broker.goals")
            bad = [g for g in params["goals"] if g not in intra]
            if bad:
                raise ParameterError(
                    f"rebalance_disk only accepts intra-broker goals; got {bad}"
                    f" (allowed: {intra})")
        # degraded-mode write gate: a mutating request against an unhealthy
        # backend boundary 503s up front (Retry-After = breaker reset)
        # WITHOUT consuming a user-task slot; a resumption poll by header is
        # a read of the existing task and passes through
        if (method == "POST" and params.get("dryrun", True) is not True
                and not task_id_header):
            # HA write gate: only the lease-holding leader mutates the
            # cluster — a standby 503s with Retry-After = its election
            # cadence, without consuming a user-task slot
            ha = getattr(app, "ha", None)
            if ha is not None and ha.role != "leader":
                raise ServiceUnavailableError(
                    f"{endpoint.path} rejected: this instance is a "
                    f"{ha.role}, not the leader",
                    retry_after_s=ha.retry_after_s())
            degraded = getattr(app, "degraded", None)
            if degraded is not None and degraded():
                raise ServiceUnavailableError(
                    f"{endpoint.path} rejected: backend degraded (open "
                    f"circuits: {app.fault_tolerance.open_circuits()})",
                    retry_after_s=app.fault_tolerance.retry_after_s())
        work = self._async_work(endpoint, params, app)
        # non-dry-run ops mutate the cluster: a completed one must not be
        # replayed from the session cache for a fresh request
        idempotent = method == "GET" or params.get("dryrun", True) is True
        try:
            task = user_tasks.get_or_create_task(
                client, endpoint, method, params, work, task_id=task_id_header,
                idempotent=idempotent)
        except KeyError as e:
            # unknown User-Task-ID: the task does not exist IN THIS SCOPE —
            # for cluster-scoped requests that includes another tenant's
            # task id (per-tenant managers never share ids). A declared
            # 404, never a 500 and never cross-tenant data.
            return 404, error_json(str(e)), headers
        except UserTaskLimitError as e:
            # the reference's servlet surfaces user-task overflow as 429 Too
            # Many Requests with a Retry-After, never a generic error — the
            # client backs off and resumes via User-Task-ID like a purgatory
            # park (UserTaskManager.java wrapAndThrowTooManyRequests role)
            headers["Retry-After"] = "1"
            return 429, error_json(str(e)), headers
        headers[USER_TASK_HEADER_NAME] = task.task_id
        try:
            result = task.future.result(timeout=self.max_block_ms / 1000.0)
            return 200, result, headers
        except futures.TimeoutError:
            # NB: concurrent.futures.TimeoutError only became an alias of the
            # builtin TimeoutError in Python 3.11 — catching the builtin alone
            # turns every still-running op into a 500 on 3.10
            return 202, wrap({"progress": task.progress.to_json(),
                              "operation": endpoint.path}), headers
        except TimeoutError:
            return 202, wrap({"progress": task.progress.to_json(),
                              "operation": endpoint.path}), headers
        except ServiceUnavailableError as e:
            # degraded-mode result: 503 + Retry-After, not a 500
            headers["Retry-After"] = str(int(e.retry_after_s))
            return 503, error_json(str(e)), headers
        except Exception as e:  # noqa: BLE001 — rendered as the error body
            if self._is_degraded_read_error(e):
                headers["Retry-After"] = "30"
                return 503, error_json(f"{type(e).__name__}: {e}"), headers
            return 500, error_json(f"{type(e).__name__}: {e}",
                                   traceback.format_exc()), headers

    @staticmethod
    def _is_degraded_read_error(e: Exception) -> bool:
        """Completeness gating / open-breaker failures are DECLARED
        degradation (503 + Retry-After), never undeclared 500s."""
        from cruise_control_tpu_torch.common.retries import CircuitOpenError
        from cruise_control_tpu_torch.monitor.load_monitor import (
            NotEnoughValidWindowsError,
        )
        return isinstance(e, (CircuitOpenError, NotEnoughValidWindowsError))

    def _async_work(self, endpoint: EndPoint, p: dict, app=None):
        """Build the callable for an async endpoint: runs on the user-task
        pool, reports progress, returns the response body dict."""
        app = app if app is not None else self.app

        def run(progress):
            progress.add_step(PENDING)
            try:
                if endpoint is EndPoint.LOAD:
                    progress.add_step(GENERATING_CLUSTER_MODEL)
                    return app.broker_load_json(
                        populate_disk_info=p["populate_disk_info"],
                        capacity_only=p["capacity_only"])
                if endpoint is EndPoint.PARTITION_LOAD:
                    progress.add_step(GENERATING_CLUSTER_MODEL)
                    from cruise_control_tpu_torch.api.responses import (
                        partition_load_records_json,
                    )
                    return partition_load_records_json(app.partition_load(
                        sort_by=p["resource"], limit=p["entries"],
                        min_valid_partition_ratio=p["min_valid_partition_ratio"]))
                if endpoint is EndPoint.PROPOSALS:
                    progress.add_step(OPTIMIZATION_FOR_GOAL)
                    goals = p["goals"] or None
                    # mode flags preview the same goal chain /rebalance runs
                    if p["rebalance_disk"] and not goals:
                        goals = app.config.get_list("intra.broker.goals")
                    if p["kafka_assigner"]:
                        from cruise_control_tpu_torch.analyzer.goals import (
                            kafka_assigner_goal_names,
                        )
                        goals = kafka_assigner_goal_names(goals or [])
                    res, freshness = app.cached_proposals_verbose(
                        force_refresh=p["ignore_proposal_cache"],
                        goal_names=goals,
                        excluded_topics=p["excluded_topics"])
                    body = {"summary": res.to_json(),
                            "stale": freshness["stale"]}
                    if freshness["stale"]:
                        # degraded read: cached proposals with provenance
                        # (model generation + age on the backend clock)
                        body["staleGeneration"] = freshness["generation"]
                        body["staleAgeMs"] = freshness["ageMs"]
                        body["staleReason"] = freshness["reason"]
                    return wrap(body)
                if endpoint is EndPoint.REBALANCE:
                    progress.add_step(OPTIMIZATION_FOR_GOAL)
                    if app.fleet_request_sink is not None:
                        # fleet admission engine: a user rebalance
                        # also queues a rebalance-lane request, so the
                        # tenant's NEXT cache refresh preempts background
                        # precompute (heals still outrank it)
                        from cruise_control_tpu_torch.pipeline import LANE_REBALANCE
                        app.fleet_request_sink(
                            LANE_REBALANCE, p["reason"] or "rebalance request")
                    return wrap(app.rebalance(
                        goal_names=p["goals"] or None, dry_run=p["dryrun"],
                        skip_hard_goal_check=p["skip_hard_goal_check"],
                        rebalance_disk=p["rebalance_disk"],
                        kafka_assigner=p["kafka_assigner"],
                        excluded_topics=p["excluded_topics"],
                        exclude_recently_removed_brokers=
                        p["exclude_recently_removed_brokers"],
                        exclude_recently_demoted_brokers=
                        p["exclude_recently_demoted_brokers"],
                        replica_movement_strategies=
                        p["replica_movement_strategies"] or None,
                        reason=p["reason"] or "rebalance request"))
                if endpoint is EndPoint.ADD_BROKER:
                    progress.add_step(OPTIMIZATION_FOR_GOAL)
                    return wrap(app.add_brokers(
                        p["brokerid"] or [], dry_run=p["dryrun"],
                        excluded_topics=p["excluded_topics"],
                        exclude_recently_removed_brokers=
                        p["exclude_recently_removed_brokers"],
                        exclude_recently_demoted_brokers=
                        p["exclude_recently_demoted_brokers"],
                        reason=p["reason"] or "add brokers"))
                if endpoint is EndPoint.REMOVE_BROKER:
                    progress.add_step(OPTIMIZATION_FOR_GOAL)
                    return wrap(app.remove_brokers(
                        p["brokerid"] or [], dry_run=p["dryrun"],
                        excluded_topics=p["excluded_topics"],
                        exclude_recently_removed_brokers=
                        p["exclude_recently_removed_brokers"],
                        exclude_recently_demoted_brokers=
                        p["exclude_recently_demoted_brokers"],
                        reason=p["reason"] or "remove brokers"))
                if endpoint is EndPoint.DEMOTE_BROKER:
                    progress.add_step(OPTIMIZATION_FOR_GOAL)
                    return wrap(app.demote_brokers(
                        p["brokerid"] or [], dry_run=p["dryrun"],
                        reason=p["reason"] or "demote brokers"))
                if endpoint is EndPoint.FIX_OFFLINE_REPLICAS:
                    progress.add_step(OPTIMIZATION_FOR_GOAL)
                    return wrap(app.fix_offline_replicas(
                        dry_run=p["dryrun"],
                        excluded_topics=p["excluded_topics"],
                        exclude_recently_removed_brokers=
                        p["exclude_recently_removed_brokers"],
                        exclude_recently_demoted_brokers=
                        p["exclude_recently_demoted_brokers"],
                        reason=p["reason"] or "fix offline replicas"))
                if endpoint is EndPoint.TOPIC_CONFIGURATION:
                    return wrap(app.fix_topic_replication_factor(
                        {p["topic"]: p["replication_factor"]},
                        reason=p["reason"] or "topic configuration"))
                raise AssertionError(f"unhandled async endpoint {endpoint}")
            finally:
                progress.finish()

        return run

    # -------------------------------------------------------------- sync
    def _run_sync(self, endpoint: EndPoint, p: dict, app=None) -> dict:
        app = app if app is not None else self.app
        # standby reads serve, but carry an explicit staleness marker: the
        # mirror trails the leader by the journal/sample tail lag
        ha = getattr(app, "ha", None)
        standby = ha is not None and ha.role != "leader"
        if endpoint is EndPoint.STATE:
            out = app.state_json(substates=p["substates"] or None)
            if (self.fleet is not None
                    and "FLEET" in [x.upper() for x in (p["substates"] or [])]):
                out["FleetState"] = self.fleet.state_json()
            if standby:
                out["stale"] = True
                out["staleReason"] = "standby mirror"
            return wrap(out)
        if endpoint is EndPoint.KAFKA_CLUSTER_STATE:
            out = app.kafka_cluster_state(verbose=bool(p["verbose"]))
            if standby:
                out["stale"] = True
                out["staleReason"] = "standby mirror"
            return wrap(out)
        if endpoint is EndPoint.PAUSE_SAMPLING:
            return wrap(app.pause_sampling(p["reason"] or "operator request"))
        if endpoint is EndPoint.RESUME_SAMPLING:
            return wrap(app.resume_sampling(p["reason"] or "operator request"))
        if endpoint is EndPoint.STOP_PROPOSAL_EXECUTION:
            return wrap(app.stop_proposal_execution(force=p["force_stop"]))
        if endpoint is EndPoint.BOOTSTRAP:
            return wrap(app.bootstrap(p["start"], p["end"],
                                      clear_metrics=p["clearmetrics"]))
        if endpoint is EndPoint.TRAIN:
            return wrap(app.train(p["start"], p["end"]))
        if endpoint is EndPoint.ADMIN:
            return wrap(app.admin(
                disable_self_healing_for=p["disable_self_healing_for"],
                enable_self_healing_for=p["enable_self_healing_for"],
                concurrent_partition_movements_per_broker=
                p["concurrent_partition_movements_per_broker"],
                concurrent_intra_broker_partition_movements=
                p["concurrent_intra_broker_partition_movements"],
                concurrent_leader_movements=p["concurrent_leader_movements"],
                execution_progress_check_interval_ms=
                p["execution_progress_check_interval_ms"],
                drop_recently_removed_brokers=p["drop_recently_removed_brokers"],
                drop_recently_demoted_brokers=p["drop_recently_demoted_brokers"]))
        if endpoint is EndPoint.USER_TASKS:
            tasks = self.user_tasks.all_tasks()
            wanted_ids = set(p["user_task_ids"] or [])
            wanted_clients = set(p["client_ids"] or [])
            wanted_eps = {e.lower() for e in (p["endpoints"] or [])}
            wanted_types = {t.lower() for t in (p["types"] or [])}
            rows = []
            for t in tasks:
                row = t.to_json()
                if wanted_ids and t.task_id not in wanted_ids:
                    continue
                if wanted_clients and t.client not in wanted_clients:
                    continue
                if wanted_eps and t.endpoint.path not in wanted_eps:
                    continue
                if wanted_types and row["Status"].lower() not in wanted_types:
                    continue
                if p["fetch_completed_task"] and t.done and not t.future.exception():
                    row["originalResponse"] = t.result_json()
                rows.append(row)
            return wrap({"userTasks": rows[:p["entries"]]})
        if endpoint is EndPoint.REVIEW_BOARD:
            if self.purgatory is None:
                raise ParameterError("two-step verification is not enabled")
            return wrap({"RequestInfo": self.purgatory.board(p["review_ids"])})
        if endpoint is EndPoint.REVIEW:
            if self.purgatory is None:
                raise ParameterError("two-step verification is not enabled")
            rows = []
            for rid in (p["approve"] or []):
                rows.append(self.purgatory.approve(
                    rid, p["reason"] or "approved").to_json())
            for rid in (p["discard"] or []):
                rows.append(self.purgatory.discard(
                    rid, p["reason"] or "discarded").to_json())
            return wrap({"RequestInfo": rows})
        raise AssertionError(f"unhandled sync endpoint {endpoint}")


def _make_handler(server: CruiseControlServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # NCSA access log -> quiet in-process
            pass

        def _send(self, status: int, body: dict, headers: dict[str, str]):
            payload = json.dumps(body, indent=2).encode("utf-8")
            self._send_raw(status, payload, "application/json", headers)

        def _send_raw(self, status: int, payload: bytes, ctype: str,
                      headers: dict[str, str]):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            if server._cors is not None:
                for k, v in server._cors.items():
                    self.send_header(k, v)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)
            if server._access_log is not None:
                server._access_log.log(self.client_address[0],
                                       self.command, self.path, status,
                                       len(payload))

        def _serve_ui(self, path: str) -> bool:
            """Static cruise-control-ui files from webserver.ui.diskpath."""
            import mimetypes
            import os
            if not server._ui_dir or not path.startswith(server._ui_prefix):
                return False
            rel = path[len(server._ui_prefix):].lstrip("/") or "index.html"
            full = os.path.realpath(os.path.join(server._ui_dir, rel))
            root = os.path.realpath(server._ui_dir)
            if not full.startswith(root + os.sep) and full != root:
                return False   # traversal attempts fall through to the API 404
            if not os.path.isfile(full):
                return False
            with open(full, "rb") as f:
                data = f.read()
            ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
            self._send_raw(200, data, ctype, {})
            return True

        def do_OPTIONS(self):
            # CORS preflight (webserver.http.cors.enabled). The reference's
            # handleOptions (KafkaCruiseControlServletUtils.java:258-268) also
            # grants the request headers (reusing the exposeheaders value) and
            # credentials — without them a browser sending Authorization or
            # User-Task-ID fails preflight even with CORS enabled.
            if server._cors is None:
                self._send(405, error_json("OPTIONS unsupported"), {})
                return
            headers = dict(server._cors)
            headers["Access-Control-Allow-Headers"] = server._cors.get(
                "Access-Control-Expose-Headers", "")
            self._send_raw(204, b"", "text/plain", headers)

        def _resolve_cluster(self, cid: str):
            """Resolve one ?cluster_id= value to (facade, task manager).
            Sends the DECLARED error response itself and returns None when
            the id is malformed (400) or unknown / no fleet mounted (404) —
            wrong-tenant access is never a 500 and never another tenant's
            data."""
            from cruise_control_tpu_torch.fleet import valid_cluster_id
            if not valid_cluster_id(cid):
                self._send(400, error_json(
                    f"malformed cluster_id {cid!r}"), {})
                return None
            binding = server.tenant_binding(cid)
            if binding is None:
                self._send(404, error_json(
                    f"unknown cluster_id {cid!r}"), {})
                return None
            return binding

        def _scoped_app(self, parsed):
            """The facade a pre-dispatch text endpoint (/metrics, /health)
            serves: the tenant's when ?cluster_id= rides the query, else the
            default app. None = an error response was already sent."""
            vals = urllib.parse.parse_qs(parsed.query).get("cluster_id")
            if not vals:
                return server.app
            binding = self._resolve_cluster(vals[-1])
            return binding[0] if binding is not None else None

        def _dispatch(self, method: str):
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            prefix = getattr(server, "_api_prefix", URL_PREFIX)
            if path.startswith(prefix):
                path = path[len(prefix):]
            elif path.startswith(URL_PREFIX):
                # the canonical prefix keeps working under a custom mount
                path = path[len(URL_PREFIX):]
            name = path.strip("/").split("/")[0]
            if name == "metrics" and method == "GET":
                # GET /metrics: Prometheus text exposition of the whole
                # MetricRegistry + flight-recorder last-round gauges. Not an
                # EndPoint enum member (the reference's 20-endpoint catalog
                # stays intact); authorized like /state — a monitor-level
                # read — and served as text/plain, not JSON.
                try:
                    _, role = server.security.authenticate(
                        self.headers, client_ip=self.client_address[0])
                    if not server.security.authorize(role, EndPoint.STATE,
                                                     "GET"):
                        raise AuthError(
                            f"role {role} may not access GET /metrics", 403)
                except AuthError as e:
                    self._send(e.status, error_json(str(e)), {})
                    return
                app = self._scoped_app(parsed)
                if app is None:
                    return
                try:
                    text = app.metrics_text()
                except Exception as e:  # noqa: BLE001 — rendered as the error body
                    self._send(500, error_json(f"{type(e).__name__}: {e}",
                                               traceback.format_exc()), {})
                    return
                self._send_raw(
                    200, text.encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8", {})
                return
            if name == "health" and method == "GET":
                # GET /health: live SLO attainment (detect/heal/request
                # targets from health.slo.*) + breaker/pipeline degradation
                # state, computed from the sensor registry. Like /metrics:
                # not an EndPoint enum member, authorized as a STATE-level
                # read, always 200 (the verdict is the body's "status").
                try:
                    _, role = server.security.authenticate(
                        self.headers, client_ip=self.client_address[0])
                    if not server.security.authorize(role, EndPoint.STATE,
                                                     "GET"):
                        raise AuthError(
                            f"role {role} may not access GET /health", 403)
                except AuthError as e:
                    self._send(e.status, error_json(str(e)), {})
                    return
                app = self._scoped_app(parsed)
                if app is None:
                    return
                try:
                    self._send(200, app.health_json(), {})
                except Exception as e:  # noqa: BLE001 — rendered as the error body
                    self._send(500, error_json(f"{type(e).__name__}: {e}",
                                               traceback.format_exc()), {})
                return
            endpoint = EndPoint.from_path(name)
            if endpoint is None:
                if method == "GET" and self._serve_ui(parsed.path):
                    return
                self._send(404, error_json(f"unknown endpoint {name!r}"), {})
                return
            allowed = GET_ENDPOINTS if method == "GET" else POST_ENDPOINTS
            if endpoint not in allowed:
                other = "POST" if method == "GET" else "GET"
                self._send(405, error_json(
                    f"{endpoint.path} only supports {other}"), {})
                return
            # the reference's trusted-proxy contract names the end user in the
            # ?doas= parameter; surface it to providers as the doAs header
            doas_vals = urllib.parse.parse_qs(parsed.query).get("doas")
            if doas_vals and not self.headers.get("X-Do-As"):
                self.headers["X-Do-As"] = doas_vals[0]
            try:
                principal, role = server.security.authenticate(
                    self.headers, client_ip=self.client_address[0])
                if not server.security.authorize(role, endpoint, method):
                    raise AuthError(f"role {role} may not access "
                                    f"{method} /{endpoint.path}", 403)
            except AuthError as e:
                challenge = getattr(server.security, "challenge", "Basic")
                hdrs = ({"WWW-Authenticate":
                         f'{challenge} realm="cruise-control"'
                         if challenge == "Basic" else challenge}
                        if e.status == 401 else {})
                # jwt.authentication.provider.url: browsers are bounced to
                # the login service; the original URL rides along as
                # ?origin=<url> so the login service can send the user back
                # (the reference JwtAuthenticator's {redirect}?origin= shape)
                hdrs.update(getattr(e, "extra_headers", None) or {})
                loc = hdrs.get("Location")
                if loc and "origin=" not in loc:
                    origin = urllib.parse.quote(
                        f"{'https' if server._ssl else 'http'}://"
                        f"{self.headers.get('Host', '')}{self.path}", safe="")
                    hdrs["Location"] = (
                        f"{loc}{'&' if '?' in loc else '?'}origin={origin}")
                self._send(e.status, error_json(str(e)), hdrs)
                return
            # per-session identity for user-task affinity (the reference's
            # HttpSession cookie, UserTaskManager.java): requests without a
            # session cookie get a fresh session — NAT'd clients no longer
            # collide on client-ip; cookie-less clients resume via the
            # explicit User-Task-ID header only
            cookies = http.cookies.SimpleCookie(self.headers.get("Cookie", ""))
            session_id = (cookies[SESSION_COOKIE].value
                          if SESSION_COOKIE in cookies else None)
            new_session = session_id is None
            if new_session:
                session_id = uuid_mod.uuid4().hex
            query = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
            if method == "POST":
                # form-encoded POST bodies fold into the query params
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    if length:
                        body = self.rfile.read(length).decode("utf-8")
                        ctype = self.headers.get("Content-Type", "")
                        if "json" in ctype:
                            parsed_body = json.loads(body or "{}")
                            if not isinstance(parsed_body, dict):
                                raise ValueError(
                                    "JSON body must be an object of parameters")
                            for k, v in parsed_body.items():
                                sval = (",".join(str(x) for x in v)
                                        if isinstance(v, list) else str(v))
                                query.setdefault(k, [sval])
                        else:
                            for k, vs in urllib.parse.parse_qs(
                                    body, keep_blank_values=True).items():
                                query.setdefault(k, vs)
                except (ValueError, UnicodeDecodeError) as e:
                    self._send(400, error_json(f"malformed request body: {e}"), {})
                    return
            scoped_app = scoped_tasks = None
            cid_vals = query.pop("cluster_id", None)
            if cid_vals:
                # cluster-scoped routing (?cluster_id=): select the tenant's
                # facade + per-tenant task manager before parameter parsing
                # (the id is a routing selector, not an endpoint parameter)
                binding = self._resolve_cluster(cid_vals[-1])
                if binding is None:
                    return
                scoped_app, scoped_tasks = binding
            if (server._reason_required and method == "POST"
                    and not query.get("reason", [""])[0]):
                # WebServerConfig request.reason.required
                self._send(400, error_json(
                    "a reason parameter is required on POST requests "
                    "(request.reason.required=true)"), {})
                return
            try:
                override = server._param_overrides.get(endpoint)
                if override is not None:
                    # <endpoint>.parameters.class: configured parser
                    parse = getattr(override, "parse", override)
                    params = parse(endpoint, query)
                else:
                    params = parse_params(endpoint, query)
            except ParameterError as e:
                self._send(400, error_json(str(e)), {})
                return
            client = f"{principal}@{session_id}"
            try:
                status, body, headers = server.handle(
                    method, endpoint, params, client,
                    self.headers.get(USER_TASK_HEADER_NAME),
                    app=scoped_app, user_tasks=scoped_tasks)
                if new_session:
                    headers = dict(headers or {})
                    headers["Set-Cookie"] = (
                        f"{SESSION_COOKIE}={session_id}; "
                        f"Path={server._session_path}; HttpOnly")
            except (ParameterError, KeyError, ValueError) as e:
                self._send(400, error_json(str(e)), {})
                return
            except ServiceUnavailableError as e:
                # degraded mode (writes while a breaker is open, reads with
                # nothing cached): 503 + Retry-After, the declared signal
                self._send(503, error_json(str(e)),
                           {"Retry-After": str(int(e.retry_after_s))})
                return
            except Exception as e:  # noqa: BLE001
                if CruiseControlServer._is_degraded_read_error(e):
                    self._send(503, error_json(f"{type(e).__name__}: {e}"),
                               {"Retry-After": "30"})
                    return
                self._send(500, error_json(f"{type(e).__name__}: {e}",
                                           traceback.format_exc()), {})
                return
            self._send(status, body, headers)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    return Handler
