"""The port's process bootstrap (``cruise_control_tpu_torch.main``,
``python -m cruise_control_tpu_torch``) on the CPU.

The cases of ``tests/test_main.py`` (properties with environment
references, a booted service answering REST requests, the credentials
check), then: the RPC backend raises naming its ROADMAP item (it is not
ported); the entry points default to the card; the fleet overlays and
``build_fleet``; SSL; a subprocess of ``python -m cruise_control_tpu_torch
props --cluster-spec c.json --device cpu`` that serves ``GET /state``; and
the front door's rows (``service_script``: the single-tenant service with
the pipelined loop and the fleet service, driven over HTTP) against the
reference's, computed in ONE fresh interpreter (``torch_reference.
service_job``) started when the module is imported (under xdist, once per
session, in the background). Those rows compare the JSON bodies as digests after
dropping the fields ``service_script.SCRUBBED`` names (wall-clock times,
task and trace ids, timestamps, stage lanes, error stack traces); the final
state's
``clusterModelStats`` are held to ``service_script.STATS_RTOL``.
"""
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from cruise_control_tpu_torch.client import CruiseControlClient
from cruise_control_tpu_torch.config import cruise_control_config
from cruise_control_tpu_torch.main import (
    build_app, build_fleet, build_server, build_ssl_context, load_properties,
    seed_backend_from_spec, split_fleet_overlays,
)
from cruise_control_tpu_torch import service_script as ss
from torch_reference import (
    background_reference, one_torch_thread, service_job, start_background_reference,
)

ROOT = Path(__file__).resolve().parents[1]
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
_REFERENCE_JOBS = {"service": service_job(ss.SERVICE_TEST, ss.FLEET_SERVICE_TEST)}
start_background_reference("main_service", _REFERENCE_JOBS)
SPEC = {
    "brokers": [{"id": b, "rack": f"r{b % 2}"} for b in range(4)],
    "partitions": [
        {"topic": "t", "partition": p, "replicas": [p % 4, (p + 1) % 4],
         "sizeMb": 100.0 + 10 * p, "bytesInRate": 10.0, "cpuUtil": 1.0}
        for p in range(8)
    ],
}


def test_load_properties(tmp_path):
    p = tmp_path / "cruisecontrol.properties"
    p.write_text("""
# comment
webserver.http.port=0
num.metrics.windows = 7
goals=RackAwareGoal,DiskCapacityGoal
hard.goals=RackAwareGoal,DiskCapacityGoal
default.goals=RackAwareGoal,DiskCapacityGoal
anomaly.detection.goals=RackAwareGoal

self.healing.enabled=true
""")
    props = load_properties(str(p))
    assert props["webserver.http.port"] == "0"
    assert props["num.metrics.windows"] == "7"
    assert props["goals"] == "RackAwareGoal,DiskCapacityGoal"
    cfg = cruise_control_config(props)
    assert cfg.get_int("num.metrics.windows") == 7
    assert cfg.get_list("goals") == ["RackAwareGoal", "DiskCapacityGoal"]
    assert cfg.get_boolean("self.healing.enabled") is True


def test_env_config_provider(tmp_path, monkeypatch):
    monkeypatch.setenv("CC_TEST_PORT", "1234")
    p = tmp_path / "cc.properties"
    p.write_text("webserver.http.port=${env:CC_TEST_PORT}\n")
    assert load_properties(str(p))["webserver.http.port"] == "1234"
    p.write_text("jwt.secret.file=${env:CC_TEST_UNSET_VAR}\n")
    with pytest.raises(ValueError, match="CC_TEST_UNSET_VAR"):
        load_properties(str(p))


def test_bootstrap_end_to_end(tmp_path):
    """properties + cluster spec -> booted service answering REST requests."""
    spec_path = tmp_path / "cluster.json"
    spec_path.write_text(json.dumps(SPEC))
    props = tmp_path / "cc.properties"
    props.write_text("webserver.http.port=0\nmin.samples.per.metrics.window=1\n"
                     "webserver.request.maxBlockTimeMs=120000\n")
    config = cruise_control_config(load_properties(str(props)))
    cc = build_app(config, device="cpu")
    seed_backend_from_spec(cc.backend, json.loads(spec_path.read_text()))
    cc.start_up()
    for i in range(8):
        cc.load_monitor.sample_once(now_ms=i * 300_000.0)
    server = build_server(cc, config)
    server.start()
    try:
        client = CruiseControlClient(f"127.0.0.1:{server.port}", timeout_s=300)
        assert client.state()["MonitorState"]["state"] == "RUNNING"
        ks = client.kafka_cluster_state()
        assert ks["KafkaBrokerState"]["Summary"]["Replicas"] == 16
        assert len(ks["KafkaBrokerState"]["ReplicaCountByBrokerId"]) == 4
        assert len(client.load()["brokers"]) == 4
        assert client.partition_load()["records"]
    finally:
        server.stop()
        cc.shutdown()


def test_security_enable_requires_credentials():
    config = cruise_control_config({"webserver.security.enable": True})
    cc = build_app(config, device="cpu")
    with pytest.raises(ValueError, match="credentials"):
        build_server(cc, config)


def test_rpc_backend_raises_naming_its_item():
    """The RPC backend (backend/rpc.py) is not ported: naming it as the
    backend class raises NotImplementedError naming ROADMAP item 12, not a
    ConfigException about a module that does not exist."""
    for spec in ("cruise_control_tpu.backend.rpc.RpcClusterBackend",
                 "cruise_control_tpu_torch.backend.rpc.RpcClusterBackend"):
        config = cruise_control_config({"executor.backend.class": spec})
        with pytest.raises(NotImplementedError, match=r"item 12, the rest"):
            build_app(config, device="cpu")


def test_entry_points_default_to_the_card():
    """Without a card the default device raises: the port never falls
    back to the CPU on its own."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is served")
    with pytest.raises(RuntimeError, match="cuda"):
        build_app(cruise_control_config({}))


def test_fleet_overlays_and_build_fleet():
    props = {"fleet.cluster.ids": "a,b.c", "fleet.tenant.a.num.metrics.windows": "4",
             "fleet.tenant.b.c.num.metrics.windows": "6", "webserver.http.port": "0",
             "anomaly.detection.interval.ms": "10000000"}
    base, overlays = split_fleet_overlays(props)
    assert overlays == {"a": {"num.metrics.windows": "4"},
                        "b.c": {"num.metrics.windows": "6"}}
    assert not any(k.startswith("fleet.tenant.") for k in base)
    config = cruise_control_config(base)
    cc = build_app(config, device="cpu")
    fleet = build_fleet(cc, config, base, overlays, device="cpu")
    try:
        assert sorted(fleet.cluster_ids) == ["a", "b.c"]
        assert fleet.app_for("a").config.get_int("num.metrics.windows") == 4
        assert fleet.app_for("b.c").config.get_int("num.metrics.windows") == 6
        assert fleet.app_for("a").resident_session is not None
        assert fleet.app_for("a").device.type == "cpu"
    finally:
        fleet.shutdown()
        cc.shutdown()
    with pytest.raises(ValueError, match="matches no declared"):
        split_fleet_overlays({"fleet.cluster.ids": "a", "fleet.tenant.zz.x": "1"})
    assert build_fleet(cc, cruise_control_config({}), {}, {}, device="cpu") is None


def test_ssl_context_from_config(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
                    "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1"],
                   check=True, capture_output=True)
    assert build_ssl_context(cruise_control_config({})) is None
    ctx = build_ssl_context(cruise_control_config({
        "webserver.ssl.enable": True, "webserver.ssl.cert.location": str(cert),
        "webserver.ssl.key.location": str(key)}))
    import ssl
    assert isinstance(ctx, ssl.SSLContext)
    assert ctx.minimum_version == ssl.TLSVersion.TLSv1_2


def test_module_entry_point_serves_state(tmp_path):
    """``python -m cruise_control_tpu_torch props --cluster-spec c.json
    --device cpu``: the pipelined loop fills the windows from live sampling
    and ``GET /state`` answers."""
    (tmp_path / "cluster.json").write_text(json.dumps(SPEC))
    (tmp_path / "cc.properties").write_text(
        "webserver.http.port=0\nmin.samples.per.metrics.window=1\nmetrics.window.ms=1000\n"
        "metric.sampling.interval.ms=200\nnum.metrics.windows=3\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cruise_control_tpu_torch", "cc.properties",
         "--cluster-spec", "cluster.json", "--device", "cpu", "--no-detection"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        url = None
        deadline = time.monotonic() + 120
        lines = []
        while url is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                url = m.group(1)
        assert url, "".join(lines)
        assert "pipelined loop" in lines[-1]
        body = None
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"{url}/state?substates=PIPELINE,MONITOR",
                                        timeout=60) as resp:
                body = json.loads(resp.read().decode())
            if body["PipelineState"]["syncRounds"] > 0:
                break
            time.sleep(0.2)
        assert body["MonitorState"]["state"] == "RUNNING"
        assert body["PipelineState"]["mode"] == "threaded"
        assert body["PipelineState"]["ingestRounds"] > 0
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def test_front_door_rows_match_reference(tmp_path_factory):
    """The single-tenant service (pipelined round, rebalance, proposals,
    load, cluster state, partition load, pipeline state, round traces) and
    the fleet service (a cluster-scoped rebalance per tenant, one dispatch
    of the queued requests as a batched round, the tenants' proposals
    through ?cluster_id=, the declared errors) on fleet_script's tier-1
    chain: the port's rows are the reference's."""
    ref = background_reference(tmp_path_factory, "main_service", _REFERENCE_JOBS)["service"]
    ns = ss.port_service_ns("cpu")
    port = json.loads(json.dumps({"service": ss.service_e2e(ns, ss.SERVICE_TEST),
                                  "fleet": ss.fleet_service_e2e(ns, ss.FLEET_SERVICE_TEST)}))
    ref = json.loads(json.dumps(ref))
    assert ss.same_rows(port["service"], ref["service"]) == []
    assert ss.same_rows(port["fleet"], ref["fleet"]) == []
    # and the rows say what the front door did
    svc = port["service"]
    assert [t["mode"] for t in svc["round_traces"]] == ["full", "full", "revalidated"]
    assert svc["proposals"][0]["digest"] == svc["proposals"][1]["digest"]
    assert svc["pipeline"]["mode"] == "threaded"
    assert port["fleet"]["errors"] == {"no-such-tenant": 404, "../etc": 400}
    assert all(b["status"] == 200 for b in port["fleet"]["bodies"].values())
    fl = port["fleet"]
    assert all(b["status"] == 200 for b in fl["rebalanced"].values())
    # every POST queued one rebalance-lane request; one dispatch ran them all
    # in one batched launch
    assert fl["queued"] == len(fl["rows"]) == ss.FLEET_SERVICE_TEST["tenants"]
    assert fl["report"]["launches"] == 1
    assert fl["report"]["optimized"] == sorted(fl["rows"])
