"""The port's REST API over real HTTP against the simulated backend: every
case of ``tests/test_api.py`` (endpoints, parameter errors, async 202 then
200, the purgatory, Basic and SPNEGO auth, TLS) through the port's facade
on the CPU, each test with a server and tasks of its own; the security
providers of ``tests/test_sensors.py`` and ``tests/test_config_surface.py``
(JWT HS256 and RS256, trusted proxy); the response schemas of
``tests/test_responses.py``; and the 503 completeness gate. The port's
bodies are held against the reference's in ``tests/test_torch_main.py``
(``service_script``, one fresh interpreter).
"""
import json
import time
import urllib.error
import urllib.request

import pytest

from cruise_control_tpu_torch.api import CruiseControlServer
from cruise_control_tpu_torch.api.endpoints import EndPoint, ParameterError, parse_params
from cruise_control_tpu_torch.api.security import BasicSecurityProvider
from cruise_control_tpu_torch.api.user_tasks import USER_TASK_HEADER_NAME
from cruise_control_tpu_torch.app import CruiseControl
from cruise_control_tpu_torch.backend import SimulatedClusterBackend
from cruise_control_tpu_torch.config import cruise_control_config
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _backend(n_brokers=4, rf=2, n_parts=12):
    be = SimulatedClusterBackend()
    for b in range(n_brokers):
        be.add_broker(b, f"r{b % 2}")
    for p in range(n_parts):
        replicas = [(p + i) % n_brokers for i in range(rf)]
        be.create_partition("t", p, replicas, size_mb=100.0 + 40 * (p % 3),
                            bytes_in_rate=50.0, bytes_out_rate=100.0,
                            cpu_util=2.0)
    return be


def _request(method, url, headers=None, body=None):
    req = urllib.request.Request(url, method=method, data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read().decode()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), dict(e.headers)


def _started(be):
    """A started facade on the CPU over ``be`` with 12 sampled windows."""
    cc = CruiseControl(be, cruise_control_config({
        "num.metrics.windows": 5, "min.samples.per.metrics.window": 1}), device="cpu")
    cc.start_up()
    for i in range(12):
        cc.load_monitor.sample_once(now_ms=i * 300_000.0)
    return cc


@pytest.fixture
def server():
    """A server of its own for each test: no task or state crosses tests."""
    be = _backend()
    cc = _started(be)
    srv = CruiseControlServer(cc, port=0, max_block_ms=120_000.0)
    srv.start()
    yield srv
    srv.stop()


def test_state_endpoint(server):
    status, body, _ = _request("GET", f"{server.base_url}/state")
    assert status == 200
    assert body["version"] == 1
    for key in ("MonitorState", "ExecutorState", "AnalyzerState",
                "AnomalyDetectorState"):
        assert key in body
    # substates filter
    status, body, _ = _request("GET", f"{server.base_url}/state?substates=monitor")
    assert status == 200 and "MonitorState" in body and "ExecutorState" not in body


def test_kafka_cluster_state(server):
    status, body, _ = _request("GET", f"{server.base_url}/kafka_cluster_state")
    assert status == 200
    assert body["KafkaBrokerState"]["Summary"]["Topics"] >= 1
    assert len(body["KafkaBrokerState"]["ReplicaCountByBrokerId"]) == 4
    for bucket in ("offline", "with-offline-replicas", "urp", "under-min-isr"):
        assert bucket in body["KafkaPartitionState"]


def test_load_endpoint(server):
    status, body, _ = _request("GET", f"{server.base_url}/load")
    assert status == 200
    assert len(body["brokers"]) == 4
    row = body["brokers"][0]
    for col in ("Broker", "DiskMB", "DiskPct", "CpuPct", "LeaderNwInRate",
                "FollowerNwInRate", "NwOutRate", "Leaders", "Replicas"):
        assert col in row
    assert sum(r["Replicas"] for r in body["brokers"]) == 24  # 12 parts x rf2


def test_partition_load(server):
    status, body, _ = _request(
        "GET", f"{server.base_url}/partition_load?resource=disk&entries=5")
    assert status == 200
    recs = body["records"]
    assert len(recs) == 5
    disks = [r["disk"] for r in recs]
    assert disks == sorted(disks, reverse=True)


def test_proposals(server):
    status, body, _ = _request(
        "GET", f"{server.base_url}/proposals"
               "?goals=DiskUsageDistributionGoal,ReplicaDistributionGoal")
    assert status == 200
    assert "summary" in body


def _poll_until_done(url, first_status, first_body, first_headers,
                     timeout_s=1800):
    # generous: a cold-cache run on the 1-core host compiles the full goal
    # chain while two sibling xdist workers do the same
    """Follow the async contract: re-request with User-Task-ID until 200."""
    status, body, headers = first_status, first_body, first_headers
    tid = headers.get(USER_TASK_HEADER_NAME)
    deadline = time.time() + timeout_s
    while status == 202 and time.time() < deadline:
        time.sleep(0.5)
        status, body, headers = _request(
            "POST", url, headers={USER_TASK_HEADER_NAME: tid})
    return status, body, headers


def test_rebalance_dryrun_and_task_id(server):
    url = f"{server.base_url}/rebalance?dryrun=true"
    status, body, headers = _poll_until_done(url, *_request("POST", url))
    assert status == 200
    assert body["operation"] == "REBALANCE" and body["executed"] is False
    tid = headers.get(USER_TASK_HEADER_NAME)
    assert tid
    # session affinity rides the CCSESSIONID cookie (the reference's
    # HttpSession): same session + same params -> same task resumed
    cookie = headers.get("Set-Cookie", "").split(";", 1)[0]
    assert cookie.startswith("CCSESSIONID=")
    status2, body2, headers2 = _request("POST", url,
                                        headers={"Cookie": cookie})
    assert headers2.get(USER_TASK_HEADER_NAME) == tid
    # a DIFFERENT session (e.g. second operator behind the same NAT) must
    # NOT be handed the first session's task
    status4, _, headers4 = _request("POST", url)
    assert headers4.get(USER_TASK_HEADER_NAME) != tid
    # explicit User-Task-ID fetch resumes regardless of session
    status3, _, headers3 = _request(
        "POST", url, headers={USER_TASK_HEADER_NAME: tid})
    assert status3 == 200 and headers3.get(USER_TASK_HEADER_NAME) == tid


def test_user_tasks_listing(server):
    _request("POST", f"{server.base_url}/rebalance?dryrun=true")
    status, body, _ = _request("GET", f"{server.base_url}/user_tasks")
    assert status == 200
    assert any(t["RequestURL"].endswith("rebalance") for t in body["userTasks"])
    assert all(t["Status"] in ("Active", "InExecution", "Completed",
                               "CompletedWithError") for t in body["userTasks"])


def test_unknown_param_is_400(server):
    status, body, _ = _request("POST", f"{server.base_url}/rebalance?bogus=1")
    assert status == 400 and "bogus" in body["errorMessage"]


def test_bad_value_is_400(server):
    status, body, _ = _request(
        "POST", f"{server.base_url}/rebalance?dryrun=maybe")
    assert status == 400 and "dryrun" in body["errorMessage"]


def test_method_mismatch_is_405(server):
    status, _, _ = _request("GET", f"{server.base_url}/rebalance")
    assert status == 405
    status, _, _ = _request("POST", f"{server.base_url}/state")
    assert status == 405


def test_unknown_endpoint_is_404(server):
    status, _, _ = _request("GET", f"{server.base_url}/nope")
    assert status == 404


def test_pause_resume_sampling(server):
    status, body, _ = _request("POST", f"{server.base_url}/pause_sampling?reason=maint")
    assert status == 200 and body["monitorState"] == "PAUSED"
    _, state, _ = _request("GET", f"{server.base_url}/state?substates=monitor")
    assert state["MonitorState"]["state"] == "PAUSED"
    status, body, _ = _request("POST", f"{server.base_url}/resume_sampling")
    assert status == 200 and body["monitorState"] == "RUNNING"


def test_stop_proposal_execution(server):
    status, body, _ = _request(
        "POST", f"{server.base_url}/stop_proposal_execution?force_stop=true")
    assert status == 200 and body["forceStop"] is True


def test_admin_self_healing_and_concurrency(server):
    status, body, _ = _request(
        "POST", f"{server.base_url}/admin?disable_self_healing_for=broker_failure"
                "&concurrent_leader_movements=77")
    assert status == 200
    assert body["selfHealingEnabledChanged"] == {"BROKER_FAILURE": False}
    assert body["concurrency"]["leadership"] == 77
    _, state, _ = _request("GET",
                           f"{server.base_url}/state?substates=anomaly_detector")
    assert state["AnomalyDetectorState"]["selfHealingEnabled"]["BROKER_FAILURE"] is False
    status, body, _ = _request(
        "POST", f"{server.base_url}/admin?enable_self_healing_for=broker_failure")
    assert body["selfHealingEnabledChanged"] == {"BROKER_FAILURE": True}


def test_bootstrap_and_train(server):
    status, body, _ = _request(
        "GET", f"{server.base_url}/bootstrap?start=0&end=1500000&clearmetrics=false")
    assert status == 200 and body["numWindowsSampled"] >= 5
    status, body, _ = _request("GET", f"{server.base_url}/train?start=0&end=1500000")
    assert status == 200 and body["trained"] is True


def test_async_progress_then_result():
    """A slow op returns 202 + progress, then 200 via User-Task-ID polling
    (UserTaskManager.java contract)."""
    be = _backend()
    cc = _started(be)
    srv = CruiseControlServer(cc, port=0, max_block_ms=1.0)
    srv.start()
    try:
        status, body, headers = _request(
            "POST", f"{srv.base_url}/rebalance?dryrun=true")
        tid = headers.get(USER_TASK_HEADER_NAME)
        assert tid is not None
        if status == 202:
            assert "progress" in body
        deadline = time.time() + 60
        while status == 202 and time.time() < deadline:
            time.sleep(0.2)
            status, body, headers = _request(
                "POST", f"{srv.base_url}/rebalance?dryrun=true",
                headers={USER_TASK_HEADER_NAME: tid})
        assert status == 200 and body["operation"] == "REBALANCE"
    finally:
        srv.stop()


def test_two_step_verification_flow():
    be = _backend()
    cc = _started(be)
    srv = CruiseControlServer(cc, port=0, two_step_verification=True,
                              max_block_ms=120_000.0)
    srv.start()
    try:
        # 1. POST parks the request
        status, body, _ = _request("POST", f"{srv.base_url}/rebalance?dryrun=true")
        assert status == 202
        rid = body["reviewResult"]["Id"]
        assert body["reviewResult"]["Status"] == "PENDING_REVIEW"
        # 2. not approved yet -> re-submission fails
        status, body, _ = _request(
            "POST", f"{srv.base_url}/rebalance?dryrun=true&review_id={rid}")
        assert status == 400
        # 3. approve via /review
        status, body, _ = _request("POST", f"{srv.base_url}/review?approve={rid}")
        assert status == 200
        assert body["RequestInfo"][0]["Status"] == "APPROVED"
        # 4. resubmit with review_id -> executes
        status, body, _ = _request(
            "POST", f"{srv.base_url}/rebalance?dryrun=true&review_id={rid}")
        assert status == 200 and body["operation"] == "REBALANCE"
        # 5. board shows SUBMITTED
        status, body, _ = _request("GET", f"{srv.base_url}/review_board")
        assert body["RequestInfo"][0]["Status"] == "SUBMITTED"
        # 6. discarding a submitted request is an illegal transition
        status, body, _ = _request("POST", f"{srv.base_url}/review?discard={rid}")
        assert status == 400
    finally:
        srv.stop()


def test_basic_auth_roles():
    be = _backend()
    cc = _started(be)
    provider = BasicSecurityProvider({
        "alice": ("s3cret", "ADMIN"), "bob": ("hunter2", "VIEWER")})
    srv = CruiseControlServer(cc, port=0, security_provider=provider,
                              max_block_ms=120_000.0)
    srv.start()
    import base64

    def basic(user, pw):
        return {"Authorization": "Basic "
                + base64.b64encode(f"{user}:{pw}".encode()).decode()}
    try:
        status, _, headers = _request("GET", f"{srv.base_url}/state")
        assert status == 401 and "WWW-Authenticate" in headers
        status, _, _ = _request("GET", f"{srv.base_url}/state",
                                headers=basic("bob", "wrong"))
        assert status == 401
        status, _, _ = _request("GET", f"{srv.base_url}/state",
                                headers=basic("bob", "hunter2"))
        assert status == 200
        status, _, _ = _request("POST", f"{srv.base_url}/rebalance?dryrun=true",
                                headers=basic("bob", "hunter2"))
        assert status == 403
        status, _, _ = _request("POST", f"{srv.base_url}/rebalance?dryrun=true",
                                headers=basic("alice", "s3cret"))
        assert status == 200
    finally:
        srv.stop()


def test_load_capacity_only_carries_capacity(server):
    status, body, _ = _request("GET", f"{server.base_url}/load?capacity_only=true")
    assert status == 200
    row = body["brokers"][0]
    assert row["DiskCapacityMB"] > 0 and row["NetworkInCapacity"] > 0
    assert row["DiskMB"] == 0.0  # utilization suppressed


def test_user_tasks_filters(server):
    _request("POST", f"{server.base_url}/rebalance?dryrun=true")
    status, body, _ = _request(
        "GET", f"{server.base_url}/user_tasks?endpoints=rebalance"
               "&types=completed&fetch_completed_task=true")
    assert status == 200
    assert body["userTasks"], "expected at least the rebalance task"
    for t in body["userTasks"]:
        assert t["RequestURL"].endswith("rebalance")
        assert t["Status"] == "Completed"
        assert t["originalResponse"]["operation"] == "REBALANCE"
    status, body, _ = _request(
        "GET", f"{server.base_url}/user_tasks?endpoints=add_broker")
    assert body["userTasks"] == []


def test_malformed_json_body_is_400(server):
    status, body, _ = _request(
        "POST", f"{server.base_url}/admin",
        headers={"Content-Type": "application/json",
                 "Content-Length": "4"},
        body=b"{bad")
    assert status == 400 and "malformed" in body["errorMessage"]


def test_two_step_async_poll_does_not_repark():
    """Polling an approved async op via User-Task-ID must bypass the
    purgatory (regression: SUBMITTED -> SUBMITTED dead end)."""
    be = _backend()
    cc = _started(be)
    srv = CruiseControlServer(cc, port=0, two_step_verification=True,
                              max_block_ms=1.0)
    srv.start()
    try:
        _, body, _ = _request("POST", f"{srv.base_url}/rebalance?dryrun=true")
        rid = body["reviewResult"]["Id"]
        _request("POST", f"{srv.base_url}/review?approve={rid}")
        status, body, headers = _request(
            "POST", f"{srv.base_url}/rebalance?dryrun=true&review_id={rid}")
        tid = headers.get(USER_TASK_HEADER_NAME)
        assert tid is not None
        deadline = time.time() + 120
        while status == 202 and time.time() < deadline:
            time.sleep(0.2)
            status, body, headers = _request(
                "POST", f"{srv.base_url}/rebalance?dryrun=true&review_id={rid}",
                headers={USER_TASK_HEADER_NAME: tid})
        assert status == 200 and body["operation"] == "REBALANCE"
    finally:
        srv.stop()


def test_parse_params_defaults_and_types():
    p = parse_params(EndPoint.REBALANCE, {})
    assert p["dryrun"] is True and p["json"] is True and p["goals"] is None
    p = parse_params(EndPoint.ADD_BROKER, {"brokerid": ["1,2,3"]})
    assert p["brokerid"] == [1, 2, 3]
    with pytest.raises(ParameterError):
        parse_params(EndPoint.STATE, {"nope": ["1"]})
    with pytest.raises(ParameterError):
        parse_params(EndPoint.ADD_BROKER, {"brokerid": ["x"]})


def test_excluded_topics_regex():
    """excluded_topics masks matching topics from movement end-to-end
    (GoalBasedOptimizationParameters excludedTopics ->
    OptimizationOptions role): on a skewed cluster, excluding every topic
    yields zero proposals while a non-matching regex still rebalances."""
    be = SimulatedClusterBackend()
    for b in range(3):
        be.add_broker(b, "r0")
    for p in range(9):     # all replicas crowd broker 0 -> disk imbalance
        be.create_partition("skewed", p, [0], size_mb=4000.0,
                            bytes_in_rate=50.0, bytes_out_rate=100.0,
                            cpu_util=2.0)
    cc = _started(be)
    srv = CruiseControlServer(cc, port=0, max_block_ms=120_000.0)
    srv.start()
    try:
        url = (f"{srv.base_url}/rebalance?dryrun=true&excluded_topics=skew.*"
               f"&goals=DiskUsageDistributionGoal&skip_hard_goal_check=true")
        status, body, _ = _poll_until_done(url, *_request("POST", url))
        assert status == 200
        assert body["result"]["proposals"] == []
        url2 = (f"{srv.base_url}/rebalance?dryrun=true&excluded_topics=nomatch.*"
                f"&goals=DiskUsageDistributionGoal&skip_hard_goal_check=true")
        status2, body2, _ = _poll_until_done(url2, *_request("POST", url2))
        assert status2 == 200
        assert len(body2["result"]["proposals"]) > 0
    finally:
        srv.stop()


def test_exclude_recently_removed_brokers_facade():
    """Recently removed brokers are blocked as move destinations when the
    exclude flag is set (excludeRecentlyRemovedBrokers semantics; history
    from Executor.java:449-506)."""
    be = SimulatedClusterBackend()
    for b in range(3):
        be.add_broker(b, "r0")
    for p in range(9):
        be.create_partition("skewed", p, [0], size_mb=4000.0,
                            bytes_in_rate=50.0, bytes_out_rate=100.0,
                            cpu_util=2.0)
    cc = _started(be)
    cc.executor.note_removed_brokers([2])
    out = cc.rebalance(goal_names=["DiskUsageDistributionGoal"], dry_run=True,
                       skip_hard_goal_check=True,
                       exclude_recently_removed_brokers=True)
    dests = {b for prop in out["result"]["proposals"]
             for b in set(prop["newReplicas"]) - set(prop["oldReplicas"])}
    assert 2 not in dests
    assert dests   # broker 1 still receives load
    # without the flag the blocklist is ignored
    out2 = cc.rebalance(goal_names=["DiskUsageDistributionGoal"], dry_run=True,
                        skip_hard_goal_check=True)
    dests2 = {b for prop in out2["result"]["proposals"]
              for b in set(prop["newReplicas"]) - set(prop["oldReplicas"])}
    assert 2 in dests2


def test_spnego_negotiate_handshake():
    """servlet/security/spnego/ role: 401 + WWW-Authenticate: Negotiate
    challenge, token validation via the GSS seam, principal normalization."""
    from cruise_control_tpu_torch.api.security import (
        SpnegoSecurityProvider, hmac_token_validator, make_spnego_token,
    )
    be = _backend()
    cc = _started(be)
    provider = SpnegoSecurityProvider(hmac_token_validator("kdc-secret"),
                                      roles={"alice": "ADMIN"})
    srv = CruiseControlServer(cc, port=0, security_provider=provider,
                              max_block_ms=120_000.0)
    srv.start()
    try:
        status, _, headers = _request("GET", f"{srv.base_url}/state")
        assert status == 401
        assert headers.get("WWW-Authenticate") == "Negotiate"
        # garbage token -> rejected
        status, _, _ = _request("GET", f"{srv.base_url}/state", headers={
            "Authorization": "Negotiate bm9wZQ=="})
        assert status == 403
        # valid token, service/realm suffixes stripped for role lookup
        tok = make_spnego_token("kdc-secret", "alice/admin-host@EXAMPLE.COM")
        status, body, _ = _request("GET", f"{srv.base_url}/state", headers={
            "Authorization": f"Negotiate {tok}"})
        assert status == 200 and "MonitorState" in body
        # unknown principal -> no role -> 403
        tok2 = make_spnego_token("kdc-secret", "mallory@EXAMPLE.COM")
        status, _, _ = _request("GET", f"{srv.base_url}/state", headers={
            "Authorization": f"Negotiate {tok2}"})
        assert status == 403
    finally:
        srv.stop()


def test_tls_server(tmp_path):
    """webserver.ssl.* (KafkaCruiseControlApp.java:100-121): HTTPS serving
    with a self-signed certificate."""
    import ssl
    import subprocess

    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
         str(key), "-out", str(cert), "-days", "1", "-nodes", "-subj",
         "/CN=127.0.0.1"], check=True, capture_output=True)
    be = _backend()
    cc = _started(be)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(str(cert), keyfile=str(key))
    srv = CruiseControlServer(cc, port=0, max_block_ms=120_000.0,
                              ssl_context=ctx)
    srv.start()
    try:
        assert srv.base_url.startswith("https://")
        client_ctx = ssl.create_default_context(cafile=str(cert))
        client_ctx.check_hostname = False
        req = urllib.request.Request(f"{srv.base_url}/state")
        with urllib.request.urlopen(req, timeout=120,
                                    context=client_ctx) as resp:
            body = json.loads(resp.read().decode())
        assert body["version"] == 1 and "MonitorState" in body
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Security providers (tests/test_sensors.py, tests/test_config_surface.py)
# ---------------------------------------------------------------------------
SECRET = "sekrit"


def _basic(user, pw):
    import base64
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}


def test_jwt_roundtrip_expiry_signature_and_users_map():
    from cruise_control_tpu_torch.api.security import AuthError, JwtSecurityProvider
    token = JwtSecurityProvider.make_token(SECRET, "alice", role="ADMIN")
    p = JwtSecurityProvider(SECRET)
    assert p.authenticate({"Authorization": f"Bearer {token}"}) == ("alice", "ADMIN")
    expired = JwtSecurityProvider.make_token(SECRET, "bob", role="VIEWER",
                                             expires_in_s=-10)
    with pytest.raises(AuthError, match="expired"):
        p.authenticate({"Authorization": f"Bearer {expired}"})
    forged = JwtSecurityProvider.make_token("wrong-secret", "eve", role="ADMIN")
    with pytest.raises(AuthError, match="signature"):
        p.authenticate({"Authorization": f"Bearer {forged}"})
    with pytest.raises(AuthError, match="bearer token required"):
        p.authenticate({})
    with pytest.raises(AuthError, match="malformed"):
        p.authenticate({"Authorization": "Bearer not.a"})
    mapped = JwtSecurityProvider(SECRET, roles={"alice": "USER"})
    assert mapped.authenticate({"Authorization": f"Bearer {token}"}) == ("alice", "USER")
    stranger = JwtSecurityProvider.make_token(SECRET, "mallory")
    with pytest.raises(AuthError, match="not authorized"):
        mapped.authenticate({"Authorization": f"Bearer {stranger}"})


def test_jwt_cookie_audience_and_provider_url():
    import base64 as b64
    import hashlib
    import hmac as hm

    from cruise_control_tpu_torch.api.security import AuthError, JwtSecurityProvider
    p = JwtSecurityProvider("s3", cookie_name="jwt", expected_audiences=["cruise", "other"])
    tok = JwtSecurityProvider.make_token("s3", "bob", role="USER")
    with pytest.raises(AuthError):
        p.authenticate({"Authorization": f"Bearer {tok}"})

    def enc(o):
        return b64.urlsafe_b64encode(json.dumps(o).encode()).rstrip(b"=").decode()
    hb = f"{enc({'alg': 'HS256'})}.{enc({'sub': 'bob', 'role': 'USER', 'aud': 'cruise'})}"
    sig = hm.new(b"s3", hb.encode(), hashlib.sha256).digest()
    tok2 = f"{hb}.{b64.urlsafe_b64encode(sig).rstrip(b'=').decode()}"
    assert p.authenticate({"Cookie": f"jwt={tok2}"}) == ("bob", "USER")
    redirect = JwtSecurityProvider("s", provider_url="https://login.example/jwt")
    with pytest.raises(AuthError) as ei:
        redirect.authenticate({})
    assert ei.value.status == 302
    assert ei.value.extra_headers["Location"] == "https://login.example/jwt"


def test_rs256_jwt_verification_from_pem(tmp_path):
    """RS256 through the module's own DER / RSA code, no crypto package."""
    import base64
    import subprocess

    from cruise_control_tpu_torch.api.security import (
        AuthError, JwtSecurityProvider, rsa_public_key_from_pem,
    )
    key, pub, cert = tmp_path / "k.pem", tmp_path / "p.pem", tmp_path / "c.pem"
    subprocess.run(["openssl", "genrsa", "-out", str(key), "2048"], check=True,
                   capture_output=True)
    subprocess.run(["openssl", "rsa", "-in", str(key), "-pubout", "-out", str(pub)],
                   check=True, capture_output=True)
    subprocess.run(["openssl", "req", "-new", "-x509", "-key", str(key), "-out", str(cert),
                    "-days", "1", "-subj", "/CN=t"], check=True, capture_output=True)

    def b64u(b):
        return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

    head = b64u(json.dumps({"alg": "RS256"}).encode())
    body = b64u(json.dumps({"sub": "alice", "role": "ADMIN"}).encode())
    si = tmp_path / "si.bin"
    si.write_bytes(f"{head}.{body}".encode())
    sig_f = tmp_path / "sig.bin"
    subprocess.run(["openssl", "dgst", "-sha256", "-sign", str(key), "-out", str(sig_f),
                    str(si)], check=True, capture_output=True)
    tok = f"{head}.{body}.{b64u(sig_f.read_bytes())}"
    n_e = rsa_public_key_from_pem(pub.read_text())
    p = JwtSecurityProvider(rs256_key=n_e)
    assert p.authenticate({"Authorization": f"Bearer {tok}"}) == ("alice", "ADMIN")
    assert rsa_public_key_from_pem(cert.read_text()) == n_e
    bad_body = b64u(json.dumps({"sub": "mallory", "role": "ADMIN"}).encode())
    with pytest.raises(AuthError):
        p.authenticate({"Authorization":
                        f"Bearer {head}.{bad_body}.{b64u(sig_f.read_bytes())}"})


def test_trusted_proxy_delegation_and_ip_regex():
    from cruise_control_tpu_torch.api.security import (
        AuthError, BasicSecurityProvider, TrustedProxySecurityProvider,
    )
    inner = BasicSecurityProvider({"proxysvc": ("pw", "ADMIN"), "rando": ("pw2", "VIEWER")})
    p = TrustedProxySecurityProvider(inner, ["proxysvc"], user_roles={"carol": "ADMIN"})
    assert p.authenticate({**_basic("proxysvc", "pw"), "X-Do-As": "carol"}) == ("carol",
                                                                             "ADMIN")
    with pytest.raises(AuthError, match="not authorized"):
        p.authenticate({**_basic("proxysvc", "pw"), "X-Do-As": "dave"})
    open_p = TrustedProxySecurityProvider(inner, ["proxysvc"])
    assert open_p.authenticate({**_basic("proxysvc", "pw"), "X-Do-As": "dave"}) == (
        "dave", "VIEWER")
    with pytest.raises(AuthError, match="not a trusted proxy"):
        p.authenticate({**_basic("rando", "pw2"), "X-Do-As": "carol"})
    assert p.authenticate(_basic("proxysvc", "pw")) == ("proxysvc", "ADMIN")
    strict = TrustedProxySecurityProvider(inner, ["proxysvc"], fallback_to_delegate=False)
    with pytest.raises(AuthError, match="must carry"):
        strict.authenticate(_basic("proxysvc", "pw"))
    ip = TrustedProxySecurityProvider(
        BasicSecurityProvider({"proxy": ("pw", "ADMIN"), "joe": ("x", "USER")}), ["proxy"],
        user_roles={"joe": "USER"}, ip_regex=r"10\.0\.0\.\d+")
    hdrs = {**_basic("proxy", "pw"), "X-Do-As": "joe"}
    assert ip.authenticate(hdrs, client_ip="10.0.0.7") == ("joe", "USER")
    with pytest.raises(AuthError):
        ip.authenticate(hdrs, client_ip="192.168.1.1")


def test_spnego_service_principal_binding():
    from cruise_control_tpu_torch.api.security import (
        AuthError, SpnegoSecurityProvider, hmac_token_validator, make_spnego_token,
    )
    p = SpnegoSecurityProvider(hmac_token_validator("k"), default_role="ADMIN",
                               service_principal="HTTP/cc@REALM")
    good = make_spnego_token("k", "alice@REALM", service="HTTP/cc@REALM")
    assert p.authenticate({"Authorization": f"Negotiate {good}"})[0] == "alice"
    wrong = make_spnego_token("k", "alice@REALM", service="HTTP/other@REALM")
    with pytest.raises(AuthError):
        p.authenticate({"Authorization": f"Negotiate {wrong}"})


def test_jwt_over_http():
    """A JWT-secured server: no token 401, a VIEWER token reads, may not
    rebalance (403), an ADMIN token may."""
    from cruise_control_tpu_torch.api.security import JwtSecurityProvider
    cc = _started(_backend())
    srv = CruiseControlServer(cc, port=0, security_provider=JwtSecurityProvider(SECRET),
                              max_block_ms=120_000.0)
    srv.start()
    try:
        def bearer(role):
            return {"Authorization": "Bearer "
                    + JwtSecurityProvider.make_token(SECRET, "u", role=role)}
        assert _request("GET", f"{srv.base_url}/state")[0] == 401
        assert _request("GET", f"{srv.base_url}/state", headers=bearer("VIEWER"))[0] == 200
        assert _request("POST", f"{srv.base_url}/rebalance?dryrun=true",
                        headers=bearer("VIEWER"))[0] == 403
        assert _request("POST", f"{srv.base_url}/rebalance?dryrun=true",
                        headers=bearer("ADMIN"))[0] == 200
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The 503 completeness gate and the three reads the facade renders
# ---------------------------------------------------------------------------
def test_unfilled_windows_are_a_declared_503():
    """A fresh service with no window answers a proposal read with 503 and
    Retry-After (the monitor's completeness gate), never a 500."""
    be = _backend()
    cc = CruiseControl(be, cruise_control_config({
        "num.metrics.windows": 5, "min.samples.per.metrics.window": 1}), device="cpu")
    cc.start_up()
    srv = CruiseControlServer(cc, port=0, max_block_ms=120_000.0)
    srv.start()
    try:
        status, body, headers = _request("GET", f"{srv.base_url}/proposals")
        assert status == 503 and "Retry-After" in headers
        assert "NotEnoughValidWindows" in body["errorMessage"]
    finally:
        srv.stop()


def test_facade_reads_render_without_raising():
    """GET /load, /kafka_cluster_state and /partition_load through the
    facade: the broker tallies total the cluster's replicas and leaders."""
    cc = _started(_backend())
    load = cc.broker_load_json(populate_disk_info=True)
    assert sum(r["Replicas"] for r in load["brokers"]) == 24
    assert sum(r["Leaders"] for r in load["brokers"]) == 12
    assert all("DiskMB" in r for r in load["brokers"])
    kcs = cc.kafka_cluster_state(verbose=True)
    assert kcs["KafkaBrokerState"]["Summary"]["Replicas"] == 24
    rows = cc.partition_load(sort_by="DISK", limit=3)
    assert len(rows) == 3 and all(r["followers"] for r in rows)


# ---------------------------------------------------------------------------
# Response schemas (tests/test_responses.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def opt_result():
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model.fixtures import small_cluster_java
    ct, meta = small_cluster_java()
    res = GoalOptimizer(device="cpu").optimizations(
        ct, meta, goal_names=["ReplicaDistributionGoal", "DiskUsageDistributionGoal"],
        skip_hard_goal_check=True, raise_on_failure=False)
    return ct, meta, res


def test_optimization_result_schema(opt_result):
    _ct, _meta, res = opt_result
    out = res.to_json()
    assert out["version"] == 1
    for field in ("numReplicaMovements", "dataToMoveMB", "numIntraBrokerReplicaMovements",
                  "intraBrokerDataToMoveMB", "numLeaderMovements", "recentWindows",
                  "monitoredPartitionsPercentage", "excludedTopics",
                  "excludedBrokersForLeadership", "excludedBrokersForReplicaMove",
                  "onDemandBalancednessScoreBefore", "onDemandBalancednessScoreAfter",
                  "provisionStatus", "provisionRecommendation"):
        assert field in out["summary"], field
    for entry in out["goalSummary"]:
        assert set(entry) >= {"goal", "status", "clusterModelStats"}
        assert entry["status"] in ("VIOLATED", "FIXED", "NO-ACTION")
        stats = entry["clusterModelStats"]
        assert set(stats["metadata"]) == {"brokers", "replicas", "topics"}
        for stat in ("AVG", "MAX", "MIN", "STD"):
            assert set(stats["statistics"][stat]) == {
                "cpu", "networkInbound", "networkOutbound", "disk", "potentialNwOut",
                "replicas", "leaderReplicas", "topicReplicas"}
    for p in out["proposals"]:
        assert set(p) >= {"topicPartition", "oldLeader", "newLeader", "oldReplicas",
                          "newReplicas"}
    assert {"brokers", "hosts"} <= set(out["loadAfterOptimization"])


def test_broker_stats_schema(opt_result):
    from cruise_control_tpu_torch.api import responses
    _ct, meta, res = opt_result
    out = responses.broker_stats_from_state(res.env, res.final_state, meta)
    for field in ("Broker", "Host", "Rack", "BrokerState", "DiskMB", "DiskPct", "CpuPct",
                  "LeaderNwInRate", "FollowerNwInRate", "NwOutRate", "PnwOutRate",
                  "Leaders", "Replicas", "DiskCapacityMB", "NetworkInCapacity",
                  "NetworkOutCapacity", "NumCore"):
        assert field in out["brokers"][0], field
    assert sum(r["Replicas"] for r in out["brokers"]) == 10
    assert sum(r["Leaders"] for r in out["brokers"]) == 5
    assert len({r["Host"] for r in out["hosts"]}) == len(meta.broker_ids)


def test_broker_stats_json_equals_the_state_rows(opt_result):
    """/load's rows from the ClusterTensor (K4/K5 tallies) equal the rows
    of the same assignment read from an engine state."""
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.api import responses
    ct, meta, _res = opt_result
    env = make_env(ct, meta, device="cpu")
    st = init_state(env, ct.replica_broker, ct.replica_is_leader, ct.replica_offline,
                    ct.replica_disk)
    assert (responses.broker_stats_json(ct, meta, device="cpu")
            == responses.broker_stats_from_state(env, st, meta))


def test_kafka_cluster_state_schema():
    from cruise_control_tpu_torch.api import responses
    backend = SimulatedClusterBackend()
    for b in range(4):
        backend.add_broker(b, f"r{b % 2}")
    for p in range(8):
        backend.create_partition("t", p, [(p + i) % 4 for i in range(2)], size_mb=100.0,
                                 bytes_in_rate=50.0, bytes_out_rate=100.0, cpu_util=2.0)
    backend.kill_broker(3)
    out = responses.kafka_cluster_state_json(backend.brokers(), backend.partitions(),
                                             verbose=True)
    bs = out["KafkaBrokerState"]
    for field in ("LeaderCountByBrokerId", "ReplicaCountByBrokerId",
                  "OutOfSyncCountByBrokerId", "OfflineReplicaCountByBrokerId",
                  "OnlineLogDirsByBrokerId", "OfflineLogDirsByBrokerId", "IsController",
                  "Summary"):
        assert field in bs, field
    ps = out["KafkaPartitionState"]
    for bucket in ("offline", "with-offline-replicas", "urp", "under-min-isr", "other"):
        assert bucket in ps, bucket
    abnormal = ps["offline"] + ps["with-offline-replicas"] + ps["urp"]
    assert abnormal
    assert set(abnormal[0]) == {"topic", "partition", "leader", "replicas", "in-sync",
                                "out-of-sync", "offline"}


def test_partition_load_schema():
    from cruise_control_tpu_torch.api import responses
    out = responses.partition_load_records_json([
        {"topic": "t", "partition": 0, "leader": 1, "followers": [2], "cpu": 1.0,
         "networkInbound": 2.0, "networkOutbound": 3.0, "disk": 4.0}])
    assert set(out["records"][0]) == {"topic", "partition", "leader", "followers", "cpu",
                                      "networkInbound", "networkOutbound", "disk",
                                      "msg_in"}
