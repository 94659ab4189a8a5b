"""The detectors, the notifier and the anomaly manager through the port
against the JAX reference.

The cases of ``tests/test_detector.py`` that need no facade run as one
script through both packages' classes (host code): the broker-failure detector with its persisted failure times,
the disk-failure detector, the self-healing notifier's grace ladder, the
slow-broker finder, the percentile metric-anomaly finder, the topic
replication-factor finder, the topic maintenance-event reader with its
idempotence cache, and the manager's queue, schedule and deferral; the
port's in process, the reference's in one fresh interpreter per module
(``torch_reference.cases_job``, started in the background when the module
is imported), so the test worker imports nothing of JAX. The facade's cases (a broker failure healed end to end, the deferred re-fire,
the goal-violation detector, the maintenance flow) are in
``tests/test_torch_app.py``, whose reference runs in a fresh interpreter.
"""
import json
from pathlib import Path

import pytest

from torch_reference import (
    background_reference, cases_job, one_torch_thread, start_background_reference,
)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _ns(ref: bool) -> dict:
    if ref:
        from cruise_control_tpu.backend import SimulatedClusterBackend
        from cruise_control_tpu.detector import (
            Action, AnomalyDetectorManager, AnomalyType, BrokerFailureDetector,
            DiskFailureDetector, PercentileMetricAnomalyFinder, SelfHealingNotifier,
            SlowBrokerFinder, TopicReplicationFactorAnomalyFinder,
        )
        from cruise_control_tpu.detector.anomalies import BrokerFailures, DiskFailures
        from cruise_control_tpu.detector.maintenance import (
            IdempotenceCache, TopicMaintenanceEventReader, submit_maintenance_plan,
        )
    else:
        from cruise_control_tpu_torch.backend import SimulatedClusterBackend
        from cruise_control_tpu_torch.detector import (
            Action, AnomalyDetectorManager, AnomalyType, BrokerFailureDetector,
            DiskFailureDetector, PercentileMetricAnomalyFinder, SelfHealingNotifier,
            SlowBrokerFinder, TopicReplicationFactorAnomalyFinder,
        )
        from cruise_control_tpu_torch.detector.anomalies import BrokerFailures, DiskFailures
        from cruise_control_tpu_torch.detector.maintenance import (
            IdempotenceCache, TopicMaintenanceEventReader, submit_maintenance_plan,
        )
    return dict(locals())


def _backend(ns, n_brokers=4, rf=2, n_parts=8):
    be = ns["SimulatedClusterBackend"]()
    for b in range(n_brokers):
        be.add_broker(b, f"r{b % 2}")
    for p in range(n_parts):
        replicas = [(p + i) % n_brokers for i in range(rf)]
        be.create_partition("t", p, replicas, size_mb=100.0, bytes_in_rate=50.0,
                            bytes_out_rate=100.0, cpu_util=2.0)
    return be


def _anomalies(found) -> list:
    """An anomaly list in plain values, without the process-global ids."""
    out = []
    for a in found:
        d = a.to_json()
        d.pop("anomalyId", None)
        for field in ("failed_brokers", "failed_disks"):
            if hasattr(a, field):
                d[field] = getattr(a, field)
        out.append(d)
    return out


CASES = ("broker_failure_persists", "disk_failure", "grace_ladder", "slow_broker",
         "percentile_finder", "topic_rf_finder", "topic_maintenance_reader",
         "manager_schedule")


def detector_case(ns, name: str, tmp) -> dict:
    """tests/test_detector.py's case ``name`` through the classes in ``ns``."""
    if name == "broker_failure_persists":
        be = _backend(ns)
        path = str(tmp / "failed.json")
        fd = ns["BrokerFailureDetector"](be, persist_path=path)
        out = [_anomalies(fd.run_once(1000.0))]
        be.kill_broker(2)
        out.append(_anomalies(fd.run_once(2000.0)))
        fd2 = ns["BrokerFailureDetector"](be, persist_path=path)
        out.append(_anomalies(fd2.run_once(9999.0)))
        be.restart_broker(2)
        out.append(_anomalies(fd2.run_once(10_000.0)))
        with open(path) as f:
            out.append(json.load(f))
        return dict(rounds=out)
    if name == "disk_failure":
        be = ns["SimulatedClusterBackend"]()
        be.add_broker(0, "r0", logdirs={"/d0": 1000.0, "/d1": 1000.0})
        be.add_broker(1, "r1")
        be.create_partition("t", 0, [0, 1])
        fd = ns["DiskFailureDetector"](be)
        out = [_anomalies(fd.run_once(0.0))]
        be.fail_disk(0, "/d1")
        out.append(_anomalies(fd.run_once(1.0)))
        be.kill_broker(0)       # a dead broker is a broker failure, not a disk one
        out.append(_anomalies(fd.run_once(2.0)))
        return dict(rounds=out)
    if name == "grace_ladder":
        n = ns["SelfHealingNotifier"]()
        n.alert_threshold_ms = 100
        n.self_healing_threshold_ms = 200
        n.set_self_healing(ns["AnomalyType"].BROKER_FAILURE, True)
        a = ns["BrokerFailures"](anomaly_type=ns["AnomalyType"].BROKER_FAILURE,
                                 detected_ms=0.0, failed_brokers={1: 0.0})
        verdicts = [(r.action.value, r.delay_ms)
                    for r in (n.on_anomaly(a, t) for t in (50.0, 150.0, 250.0))]
        # mass failure: alert only
        mass = ns["BrokerFailures"](anomaly_type=ns["AnomalyType"].BROKER_FAILURE,
                                    detected_ms=0.0,
                                    failed_brokers={b: 0.0 for b in range(12)})
        verdicts.append(n.on_anomaly(mass, 1000.0).action.value)
        d = ns["DiskFailures"](anomaly_type=ns["AnomalyType"].DISK_FAILURE,
                               detected_ms=0.0, failed_disks={0: ["/d1"]})
        verdicts.append(n.on_anomaly(d, 1.0).action.value)
        n.set_self_healing(ns["AnomalyType"].DISK_FAILURE, True)
        verdicts.append(n.on_anomaly(d, 1.0).action.value)
        return dict(verdicts=verdicts, enabled=n.self_healing_enabled())
    if name == "slow_broker":
        f = ns["SlowBrokerFinder"](flush_time_threshold_ms=100, demotion_score=2,
                                   decommission_score=4)
        metrics = {0: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 500.0, "ALL_TOPIC_BYTES_IN": 10.0},
                   1: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 5.0,
                       "ALL_TOPIC_BYTES_IN": 5000.0}}
        rounds = [[(a.to_json()["type"], sorted(a.slow_brokers.items()), a.remove,
                    a.fixable) for a in f.run_once(metrics, float(t))] for t in range(5)]
        return dict(rounds=rounds)
    if name == "percentile_finder":
        f = ns["PercentileMetricAnomalyFinder"]()
        hist = {0: {"BROKER_LOG_FLUSH_TIME_MS_999TH": [10.0] * 20}}
        hot = f.anomalies(hist, {0: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 100.0}}, 0.0)
        ok = f.anomalies(hist, {0: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 11.0}}, 0.0)
        return dict(hot=[(a.broker_ids, a.fixable) for a in hot], ok=_anomalies(ok))
    if name == "topic_rf_finder":
        be = _backend(ns, rf=2)
        found = ns["TopicReplicationFactorAnomalyFinder"](target_rf=3).anomalies(be, 0.0)
        same = ns["TopicReplicationFactorAnomalyFinder"](target_rf=2).anomalies(be, 0.0)
        return dict(found=[sorted(a.bad_topics) for a in found], same=len(same))
    if name == "topic_maintenance_reader":
        path = str(tmp / "maintenance_topic.log")
        reader = ns["TopicMaintenanceEventReader"]()
        reader.configure(None, path=path)
        out = [_anomalies(reader.read_events(0.0))]
        ns["submit_maintenance_plan"](path, "REMOVE_BROKER", brokers=[3])
        ns["submit_maintenance_plan"](path, "TOPIC_REPLICATION_FACTOR", topics={"t": 3})
        events = reader.read_events(1.0)
        out.append([(e.plan_type, e.brokers, e.topics) for e in events])
        out.append(_anomalies(reader.read_events(2.0)))
        ns["submit_maintenance_plan"](path, "REBALANCE")
        out.append([e.plan_type for e in reader.read_events(3.0)])
        idem = ns["IdempotenceCache"](retention_ms=10_000.0)
        key = f"{events[0].plan_type}:{events[0].brokers}:{events[0].topics}"
        out.append([idem.seen_before(key, 0.0), idem.seen_before(key, 1.0),
                    idem.seen_before(key, 20_000.0)])
        return dict(rounds=out)
    if name == "manager_schedule":
        be = _backend(ns)
        notifier = ns["SelfHealingNotifier"]()
        notifier.alert_threshold_ms = 100
        notifier.self_healing_threshold_ms = 200
        mgr = ns["AnomalyDetectorManager"](notifier=notifier)
        fd = ns["BrokerFailureDetector"](be)
        dd = ns["DiskFailureDetector"](be)
        mgr.register_detector("BrokerFailureDetector", fd.run_once, interval_ms=1000.0)
        mgr.register_detector("DiskFailureDetector", dd.run_once, interval_ms=500.0)
        be.kill_broker(1)
        out = []
        for t in (0.0, 400.0, 600.0, 1000.0, 1500.0, 2000.0):
            out.append((t, mgr.run_due(t), mgr.next_due_ms()))
            out.append([(h["anomaly"]["type"], h["action"])
                        for h in mgr.handle_anomalies(t)])
        st = mgr.state_json()
        return dict(rounds=out, queued=st["numQueuedAnomalies"],
                    intervals=st["detectionIntervalsMs"],
                    detectors=st["registeredDetectors"], deferred=len(mgr._deferred),
                    by_type={k: len(v) for k, v in st["recentAnomaliesByType"].items()})
    raise ValueError(name)


def reference_detector_cases() -> dict:
    """Every case through the reference's classes (run by
    ``torch_reference.cases_job`` in a fresh interpreter), each in its own
    directory under one temporary directory."""
    import tempfile
    ns = _ns(True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="detector_reference_") as tmp:
        for name in CASES:
            case_dir = Path(tmp) / name
            case_dir.mkdir(parents=True)
            out[name] = detector_case(ns, name, case_dir)
    return out


# the reference's interpreter starts when the module is imported (under
# xdist, once per session, in the background)
_REFERENCE_JOBS = {"cases": cases_job("test_torch_detector", "reference_detector_cases")}
start_background_reference("detector", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return background_reference(tmp_path_factory, "detector", _REFERENCE_JOBS)["cases"]


@pytest.mark.parametrize("name", CASES)
def test_detector_case_matches_reference(name, reference, tmp_path):
    assert detector_case(_ns(False), name, tmp_path) == reference[name]


def test_cases_observe_what_the_reference_tests_assert(tmp_path):
    ns = _ns(False)
    run = lambda n: detector_case(ns, n, tmp_path)  # noqa: E731
    bf = run("broker_failure_persists")["rounds"]
    assert bf[0] == [] and bf[1][0]["failed_brokers"] == {2: 2000.0}
    assert bf[2][0]["failed_brokers"] == {2: 2000.0} and bf[3] == []
    df = run("disk_failure")["rounds"]
    assert df[0] == [] and df[1][0]["failed_disks"] == {0: ["/d1"]} and df[2] == []
    assert run("grace_ladder")["verdicts"][:3] == [("CHECK", 50.0), ("CHECK", 50.0),
                                                    ("FIX", 0.0)]
    sb = run("slow_broker")["rounds"]
    assert sb[0] == [] and sb[1] and not sb[1][0][2] and any(r[2] for r in sb[3])
    pf = run("percentile_finder")
    assert pf["hot"][0][0] == [0] and pf["ok"] == []
    assert run("topic_rf_finder")["found"] == [["t"]]
    tm = run("topic_maintenance_reader")["rounds"]
    assert [e[0] for e in tm[1]] == ["REMOVE_BROKER", "TOPIC_REPLICATION_FACTOR"]
    assert tm[2] == [] and tm[3] == ["REBALANCE"] and tm[4][:2] == [False, True]
