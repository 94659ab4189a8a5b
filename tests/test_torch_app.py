"""The ``CruiseControl`` facade of the port against the JAX reference.

The reference's facade compiles its goal chains, so each reference run
here happens in a fresh interpreter (``torch_reference.facade_job``), never
inside a test worker: one interpreter for the facade cases and the heal
script, started when the module is imported (under xdist, once per session,
in the background, ``torch_reference.start_background_reference``), so no
worker waits on it. The port runs in process on the CPU (``device="cpu"``),
on one torch intra-op thread (``torch_reference.one_torch_thread``). No test
starts a thread or sleeps on the wall clock: the anomaly manager and the
executor run synchronously on the simulated backend's clock.

- ``facade_case``: tests/test_detector.py's facade cases (a broker failure
  healed end to end, the deferred CHECK re-firing through the fix path, the
  goal-violation detector, the maintenance flow) and the admin and state
  surface; the lend protocol across a FIX on the resident session;
- ``heal_script`` at the tier-1 size (``HEAL_SMALL``): the broker failure,
  the disk failure and the predicted breach, row for row;
- the device contract and the surfaces that wait for later slices.
"""
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer.heal_script import (
    HEAL_SMALL, heal_script, port_heal_ns,
)
from torch_reference import (
    FACADE_CASES, background_reference, facade, facade_backend, facade_case, facade_job,
    one_torch_thread, start_background_reference,
)

PORT = port_heal_ns("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
# the reference's interpreter starts when the module is imported (under
# xdist, once per session, in the background)
_REFERENCE_JOBS = {"facade": facade_job(FACADE_CASES, (HEAL_SMALL,))}
start_background_reference("app_facade", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def ref_facade(tmp_path_factory):
    """The reference's facade cases and heal script rows (one interpreter,
    once for the whole test session)."""
    return background_reference(tmp_path_factory, "app_facade", _REFERENCE_JOBS)["facade"]


@pytest.fixture(scope="module")
def port_heal_rows():
    return heal_script(PORT, HEAL_SMALL)


def test_facade_cases_and_heal_script_match_reference(port_heal_rows, ref_facade,
                                                       tmp_path):
    """One fresh reference interpreter runs every facade case, then the heal
    script (they share its compiled chains); the port's runs equal its
    rows."""
    (tmp_path / "port").mkdir()
    want = ref_facade
    got = {name: facade_case(PORT, name, str(tmp_path / "port")) for name in FACADE_CASES}
    assert [n for n in FACADE_CASES if got[n] != want[n]] == []
    heal = want["heal"][0]
    assert [r["step"] for r in port_heal_rows] == [r["step"] for r in heal]
    for got_row, want_row in zip(port_heal_rows, heal):
        assert got_row == want_row, got_row["step"]


@pytest.mark.parametrize("name", FACADE_CASES)
def test_facade_case_shows_the_reference_tests_outcome(name, tmp_path):
    """What tests/test_detector.py asserts of the reference, on the port's
    run of each facade case."""
    out = facade_case(PORT, name, str(tmp_path))
    if name in ("broker_failure", "deferred_check"):
        assert out["n"] >= 1 and out["evacuated"] and out["actions"] >= 1
        assert any(a == "CHECK" for t, a, _, _ in out["h1"] if t == "BROKER_FAILURE")
        assert [a for t, a, fixed, _ in out["h2"] if t == "BROKER_FAILURE"] == ["FIX"]
        assert out["deferred_after"] == 0
        if name == "deferred_check":
            assert out["queued"] == 0 and out["deferred"] == 1 and out["early"] == []
    elif name == "goal_violation":
        assert out["types"] == ["GOAL_VIOLATION"] and out["fixable"][0]
        assert out["balancedness"] < 100.0
    elif name == "maintenance":
        assert out["n"] >= 1
        assert ("MAINTENANCE_EVENT", "FIX") in [(t, a) for t, a, _, _ in out["handled"]]
    else:
        assert out["admin"]["selfHealingEnabledChanged"] == {"BROKER_FAILURE": False,
                                                             "DISK_FAILURE": True}
        assert "unknown anomaly type" in out["bad_admin"]
        assert out["health"]["role"] == "leader" and out["executor_state"] == \
            "NO_TASK_IN_PROGRESS"
        assert out["pause"]["monitorState"] == "PAUSED"


def test_heal_script_heals(port_heal_rows):
    """What the rows say happened: (a) CHECK inside the grace ladder, then
    a FIX that evacuated the dead broker; (b) a FIX of the offline replicas;
    (c) a PREDICTED verdict before any breach, its heal executed, and one
    speculative install."""
    a, b, c = port_heal_rows
    first, second = a["handled"]
    assert ("BROKER_FAILURE", "CHECK") in [(h["type"], h["action"]) for h in first]
    fix = [h for h in second if h["type"] == "BROKER_FAILURE"]
    assert fix and fix[0]["action"] == "FIX" and fix[0]["fix"]["executed"]
    assert fix[0]["fix"]["operation"] == "REMOVE_BROKER" and fix[0]["fix"]["proposals"] > 0
    assert a["census"]["by_state"] == {"COMPLETED": a["census"]["total"]}
    disk = [h for h in b["handled"][0] if h["type"] == "DISK_FAILURE"]
    assert disk and disk[0]["fix"]["operation"] == "FIX_OFFLINE_REPLICAS"
    pred = [h for h in c["handled"][0] if h["type"] == "PREDICTED_GOAL_VIOLATION"]
    assert pred and pred[0]["action"] == "FIX" and pred[0]["fix"]["executed"]
    assert c["rising"] and c["predicted"] and c["predictions"] == 1
    assert c["speculative"]["installs"] == 1
    assert not any(h["type"] == "GOAL_VIOLATION" and h["action"] == "FIX"
                   for h in c["handled"][0])
    assert c["forecast_shape"] == [HEAL_SMALL["partitions"], 10]


def test_lend_protocol_keeps_the_carried_state(tmp_path):
    """A FIX round on the resident session leaves the final_state the
    session carries from the round before it as it was."""
    out = facade_case(PORT, "lend", str(tmp_path))
    assert out["unchanged"] == {"replica_broker": True, "replica_is_leader": True,
                                "util": True}
    assert any(t == "DISK_FAILURE" and act == "FIX" and fixed
               for t, act, fixed, _ in out["handled"])


def test_cuda_without_a_card_raises(monkeypatch):
    from cruise_control_tpu_torch.app import CruiseControl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        CruiseControl(facade_backend(PORT))
    cc = CruiseControl(facade_backend(PORT), device="cpu")
    assert cc.device == torch.device("cpu") and cc.goal_optimizer.device == cc.device
    assert cc.resident_session.device == cc.device


def test_waiting_surfaces_name_their_items():
    """What a single-tenant deployment does not use raises and names its
    ROADMAP Queue 1 item (an HA role, the sample store); the REST reads, the
    pipelined loop and measured goal durations are ported and serve."""
    from cruise_control_tpu_torch.app import CruiseControl
    from cruise_control_tpu_torch.config import cruise_control_config
    from cruise_control_tpu_torch.pipeline import PipelinedServiceLoop
    cc = facade(PORT, facade_backend(PORT))
    assert cc.broker_load_json()["brokers"]
    assert cc.kafka_cluster_state()["KafkaBrokerState"]["Summary"]["Brokers"] == 4
    assert cc.partition_load()
    with pytest.raises(NotImplementedError, match="item 14"):
        cc.ha = object()
    assert cc.ha is None and cc.service_pipeline is None and cc.fleet_request_sink is None
    pipe = PipelinedServiceLoop(cc)
    cc.service_pipeline = pipe
    assert cc.state_json(substates=["PIPELINE"])["PipelineState"]["mode"] == "lockstep"
    cc.service_pipeline = None
    # fleet mode is ported: the sink takes the detectors' heal-lane requests
    seen = []
    cc.fleet_request_sink = lambda lane, reason, now_ms: seen.append((lane, reason, now_ms))
    cc._heal_admission_sink("goal violation: RackAwareGoal", 5.0)
    assert seen == [(0, "goal violation: RackAwareGoal", 5.0)]
    with pytest.raises(NotImplementedError, match="item 11"):
        CruiseControl(facade_backend(PORT), cruise_control_config(
            {"sample.store.path": "/nonexistent"}), device="cpu")
    res = cc.goal_optimizer.optimizations(None, session=cc._usable_session(None, False, False),
                                          measure_goal_durations=True)
    assert res.durations_measured and res.round_trace is cc.flight_recorder.last()


def test_violated_goals_and_operation_spans():
    """``GoalOptimizer.violated_goals`` reads the verdicts without
    optimizing; a facade operation opens its span tree on the backend clock
    (operation -> optimize round) and journals it."""
    be = facade_backend(PORT)
    cc = facade(PORT, be)
    ct, meta = cc.load_monitor.cluster_model()
    before = np.asarray(ct.replica_broker).copy()
    assert cc.goal_optimizer.violated_goals(ct, meta, ["ReplicaDistributionGoal"]) == []
    assert np.array_equal(np.asarray(ct.replica_broker), before)
    be.kill_broker(1)
    ct, meta = cc.load_monitor.cluster_model()
    goals = cc._self_healing_goals()
    res = cc.goal_optimizer.optimizations(ct, meta, goal_names=goals,
                                          raise_on_failure=False,
                                          skip_hard_goal_check=True)
    viol = cc.goal_optimizer.violated_goals(ct, meta, goals)
    assert viol and viol == res.violated_goals_before
    out = cc.rebalance(dry_run=True)
    assert out["operation"] == "REBALANCE" and not out["executed"]
    trees = cc.tracer.to_json()["trees"]
    ops = [r for t in trees for r in t["roots"] if r["span_kind"] == "operation"]
    assert ops and all(not t["orphans"] for t in trees)
    child = ops[-1]["children"][0]
    assert child["span_kind"] == "optimize" and child["t1"] is not None
    assert child["attrs"]["proposals"] == len(out["result"]["proposals"])
    assert cc.state_json(["TRACES"])["Traces"]["journal"]["events"] > 0
    assert any('"span_kind":"optimize"' in line for line in cc.journal.lines())


def test_warmup_bootstrap_and_train():
    """The facade's warmup runs one budget-starved round over a synthetic
    cluster of the backend's shape; bootstrap and train go to the monitor."""
    cc = facade(PORT, facade_backend(PORT))
    out = cc.warmup(goal_names=["RackAwareGoal", "ReplicaDistributionGoal"])
    assert out["operation"] == "WARMUP"
    assert out["shape"] == {"brokers": 4, "replicas": 16, "partitions": 8, "topics": 1}
    assert cc.bootstrap(0, 300_000)["operation"] == "BOOTSTRAP"
    assert cc.train(0, 300_000)["operation"] == "TRAIN"
