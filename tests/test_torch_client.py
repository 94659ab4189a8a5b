"""The port's Python client and CLI against its real HTTP server (every
case of ``tests/test_client.py``), the facade on the CPU. Each test builds
its own server and client, so no user task crosses tests (the reference's
module-scoped server lets one test read the task another left behind)."""
import io
import json

import pytest

from cruise_control_tpu_torch.api import CruiseControlServer
from cruise_control_tpu_torch.api.endpoints import EndPoint
from cruise_control_tpu_torch.app import CruiseControl
from cruise_control_tpu_torch.backend import SimulatedClusterBackend
from cruise_control_tpu_torch.client import CruiseControlClient, CruiseControlClientError
from cruise_control_tpu_torch.client.cli import build_parser, main
from cruise_control_tpu_torch.config import cruise_control_config
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture
def server():
    be = SimulatedClusterBackend()
    for b in range(4):
        be.add_broker(b, f"r{b % 2}")
    for p in range(12):
        be.create_partition("t", p, [(p + i) % 4 for i in range(2)],
                            size_mb=100.0 + 40 * (p % 3), bytes_in_rate=50.0,
                            bytes_out_rate=100.0, cpu_util=2.0)
    cc = CruiseControl(be, cruise_control_config({
        "num.metrics.windows": 5, "min.samples.per.metrics.window": 1}), device="cpu")
    cc.start_up()
    for i in range(12):
        cc.load_monitor.sample_once(now_ms=i * 300_000.0)
    srv = CruiseControlServer(cc, port=0, max_block_ms=1.0)  # force 202 polling
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def client(server):
    return CruiseControlClient(f"127.0.0.1:{server.port}", timeout_s=600,
                               poll_interval_s=0.2)


def test_client_state(client):
    body = client.state()
    assert body["version"] == 1 and "MonitorState" in body


def test_client_load_follows_async_protocol(client):
    """max_block_ms=1 on the server forces the 202 + poll path."""
    body = client.load()
    assert len(body["brokers"]) == 4


def test_client_rebalance_with_goals(client):
    body = client.rebalance(dryrun=True, skip_hard_goal_check=True,
                            goals=["DiskUsageDistributionGoal",
                                   "ReplicaDistributionGoal"])
    assert body["operation"] == "REBALANCE" and body["executed"] is False


def test_client_validates_params_locally(client):
    with pytest.raises(CruiseControlClientError, match="unknown parameter"):
        client.rebalance(bogus=1)


def test_client_surfaces_server_errors(client):
    with pytest.raises(CruiseControlClientError) as ei:
        client.topic_configuration(topic="", replication_factor=2)
    assert ei.value.status == 400


def test_client_pause_resume_and_user_tasks(client):
    client.load()                      # this test's own async task
    assert client.pause_sampling(reason="test")["monitorState"] == "PAUSED"
    assert client.resume_sampling()["monitorState"] == "RUNNING"
    tasks = client.user_tasks()
    assert any(t["RequestURL"].endswith("load") for t in tasks["userTasks"])


def test_cli_parser_generates_all_endpoints():
    parser = build_parser()
    subs = next(a for a in parser._actions
                if isinstance(a, type(parser._subparsers._group_actions[0])))
    for ep in EndPoint:
        assert ep.path in subs.choices
    # generated flags exist
    reb = subs.choices["rebalance"]
    opts = {o for a in reb._actions for o in a.option_strings}
    assert "--dryrun" in opts and "--no-dryrun" in opts and "--goals" in opts


def test_cli_state_roundtrip(server):
    out = io.StringIO()
    rc = main(["-a", f"127.0.0.1:{server.port}", "state"], out=out)
    assert rc == 0
    body = json.loads(out.getvalue())
    assert "MonitorState" in body


def test_cli_load_table(server):
    out = io.StringIO()
    rc = main(["-a", f"127.0.0.1:{server.port}", "--timeout", "600", "load"],
              out=out)
    assert rc == 0
    text = out.getvalue()
    assert "Broker" in text and "DiskMB" in text
    assert len(text.strip().splitlines()) == 5  # header + 4 brokers


def test_cli_rebalance_flags(server):
    out = io.StringIO()
    rc = main(["-a", f"127.0.0.1:{server.port}", "--timeout", "600",
               "rebalance", "--dryrun", "--skip-hard-goal-check",
               "--goals", "DiskUsageDistributionGoal,ReplicaDistributionGoal"],
              out=out)
    assert rc == 0
    body = json.loads(out.getvalue())
    assert body["operation"] == "REBALANCE"


def test_cli_error_exit_code(server):
    rc = main(["-a", f"127.0.0.1:{server.port}", "topic_configuration",
               "--topic", ""], out=io.StringIO())
    assert rc == 1
