"""The fleet's REST half through the port (``tests/test_fleet.py:306-405``):
``CruiseControlServer(fleet=...)`` routes every endpoint by
``?cluster_id=``: a valid id reaches its tenant's facade, an unknown one is
a declared 404 on reads, writes and the text endpoints, a malformed one a
400; a task id never resumes under another tenant (404, under a two-thread
race too, nothing executed); each tenant has its own user-task quota (429,
isolated). Each test builds its own three-tenant fleet (fleet_script's
tier-1 chain, on the CPU) and server. The reference's seeded fuzzer
(``sim/api_fuzz.py``) is ROADMAP Queue 1 item 14."""
import http.client
import json
import threading

import pytest

from cruise_control_tpu_torch import fleet_script as fs
from cruise_control_tpu_torch.api.server import CruiseControlServer
from cruise_control_tpu_torch.fleet import valid_cluster_id
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SEEDS = (11, 12, 13)


def _req(port, method, pathq, task_id=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        headers = {"Content-Length": "0"} if method == "POST" else {}
        if task_id:
            headers["User-Task-ID"] = task_id
        conn.request(method, "/kafkacruisecontrol" + pathq, headers=headers)
        r = conn.getresponse()
        raw = r.read()
        tid = r.getheader("User-Task-ID")
        try:
            return r.status, json.loads(raw.decode("utf-8")), tid
        except ValueError:
            return r.status, None, tid
    finally:
        conn.close()


@pytest.fixture
def fleet_server():
    """Three same-bucket tenants past their first batched round, behind a
    server of this test's own."""
    ns = fs.port_fleet_ns("cpu")

    def cfg():
        return fs._cfg(ns, fs.FLEET_GOALS)

    fleet = ns["FleetScheduler"](config=cfg(), device="cpu")
    for s in SEEDS:
        t = fleet.add_tenant(f"tenant-{s}", backend=fs.tenant_backend(ns, s), config=cfg())
        fs._sample(t.cc)
    fleet.run_round(now_ms=fs.T0)
    default_cc = fleet.app_for(f"tenant-{SEEDS[0]}")
    server = CruiseControlServer(default_cc, config=default_cc.config, fleet=fleet,
                                 max_block_ms=120_000.0)
    server.start()
    yield fleet, server
    server.stop()
    fleet.shutdown()


def test_cluster_id_valid_unknown_malformed(fleet_server):
    fleet, server = fleet_server
    port = server.port
    cid = f"tenant-{SEEDS[1]}"
    st, body, _ = _req(port, "GET", f"/state?cluster_id={cid}&substates=ANALYZER,FLEET")
    assert st == 200
    assert body["AnalyzerState"]["isProposalReady"]
    assert "FleetState" in body and cid in body["FleetState"]["tenants"]
    st, body, _ = _req(port, "GET", f"/proposals?cluster_id={cid}")
    assert st == 200
    # the tenant's own batched result, served from its cache
    res = fleet.app_for(cid).cached_proposals()
    assert body["summary"]["summary"]["numReplicaMovements"] == res.num_replica_movements
    for pathq in ("/state?cluster_id=no-such-tenant", "/proposals?cluster_id=ghost",
                  "/user_tasks?cluster_id=ghost", "/metrics?cluster_id=ghost",
                  "/health?cluster_id=ghost"):
        st, _, _ = _req(port, "GET", pathq)
        assert st == 404, pathq
    st, _, _ = _req(port, "POST", "/rebalance?cluster_id=ghost&dryrun=true&reason=x")
    assert st == 404
    assert not valid_cluster_id("../etc")
    for bad in ("..%2F..%2Fetc", "", "a%20b", "x" * 80):
        st, _, _ = _req(port, "GET", f"/state?cluster_id={bad}")
        assert st == 400, bad
    st, _, _ = _req(port, "GET", f"/metrics?cluster_id={cid}")
    assert st == 200


def test_cross_tenant_task_resumption_is_404_and_never_executes(fleet_server):
    fleet, server = fleet_server
    port = server.port
    own, other = f"tenant-{SEEDS[1]}", f"tenant-{SEEDS[2]}"
    q = f"/rebalance?cluster_id={own}&dryrun=true&reason=xt"
    st, _, tid = _req(port, "POST", q)
    assert st == 200 and tid
    wrong_q = q.replace(own, other)
    before = fleet.app_for(own).executor.state_json()["numExecutions"]
    st, body, rtid = _req(port, "POST", wrong_q, task_id=tid)
    assert st == 404, body
    assert rtid != tid
    results = [None, None]

    def poll(slot):
        results[slot] = _req(port, "POST", wrong_q, task_id=tid)

    threads = [threading.Thread(target=poll, args=(s,)) for s in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads)
    assert sorted(r[0] for r in results) == [404, 404]
    assert fleet.app_for(own).executor.state_json()["numExecutions"] == before


def test_per_tenant_user_task_quota_is_429_and_isolated(fleet_server):
    fleet, server = fleet_server
    port = server.port
    own, other = f"tenant-{SEEDS[1]}", f"tenant-{SEEDS[2]}"
    _, own_tasks = server.tenant_binding(own)
    release = threading.Event()
    from cruise_control_tpu_torch.api.endpoints import EndPoint
    for i in range(server._tenant_task_quota):
        own_tasks.get_or_create_task(f"filler-{i}", EndPoint.PROPOSALS, "GET", {"i": i},
                                     lambda progress: release.wait(60) and {})
    try:
        st, body, _ = _req(port, "POST",
                           f"/rebalance?cluster_id={own}&dryrun=true&reason=quota")
        assert st == 429, body
        st, _, _ = _req(port, "POST",
                        f"/rebalance?cluster_id={other}&dryrun=true&reason=quota-ok")
        assert st == 200
    finally:
        release.set()


def test_cluster_scoped_rebalance_enqueues_a_rebalance_lane_request(fleet_server):
    """A user rebalance on a tenant also queues a rebalance-lane request in
    the fleet's admission engine (the facade's ``fleet_request_sink``)."""
    fleet, server = fleet_server
    cid = f"tenant-{SEEDS[0]}"
    st, body, _ = _req(server.port, "POST",
                       f"/rebalance?cluster_id={cid}&dryrun=true&reason=lane")
    assert st == 200 and body["operation"] == "REBALANCE"
    adm = fleet.admission_state_json()
    assert adm["lanes"]["rebalance"]["depth"] >= 1, adm
