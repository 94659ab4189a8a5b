"""The self-healing service script: the heals of the e2e-1000b-50000p cell
(and of its tier-1 size), through the ``CruiseControl`` facade of either
package.

``heal_script(ns, spec)`` builds ``CruiseControl`` over the session cell's
``SimulatedClusterBackend`` (``session_script.session_backend``) for the
classes in ``ns`` (``port_heal_ns()`` gives the port's; the tests hand in the
reference's the same way), samples the windows, then drives the anomaly
manager synchronously on the simulated clock (no thread, no wall clock):

- (a) broker failure: kill one broker; a detection round; handle before the
  grace threshold (CHECK); handle after it (FIX: ``remove_brokers`` on the
  self-healing goals, executed to its end on ``SimClock``); then the broker
  comes back, empty;
- (b) disk failure: fail the broker's only logdir; a detection round; handle
  (FIX: ``fix_offline_replicas`` on the resident session), then handle
  again; then the emptied broker is decommissioned;
- (c) predicted breach: ramp one topic's load window by window until the
  forecast at ``forecast.horizon.ms`` breaches a network capacity goal while
  the current state does not; read the forecast; a detection round gives the
  PREDICTED verdict; handle it (FIX: the pre-breach heal's proposals
  executed, then the speculative proposal install).

It returns one plain-valued row per step, so the two packages' rows compare
with ``==``: the handled anomaly types and actions, the fixes' proposal
counts and sha256, the executor's task census, the simulated clock, the
sha256 of the backend's assignment and, for (c), of the ``f32[E, M]``
forecast. ``chip_smoke.py`` phase 7 runs it on the card against the
reference's rows (``python tests/torch_reference.py heal-e2e``).
"""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np

from cruise_control_tpu_torch.analyzer.session_script import session_backend

# The self-healing chain (app.py SELF_HEALING_GOALS): the service's default
# goals here too, so the speculative proposal round optimizes what the fixes
# optimize
SELF_HEALING_CHAIN = [
    "RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
    "DiskCapacityGoal", "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal", "ReplicaDistributionGoal"]
# The config of every heal cell: self-healing on (but goal-violation and
# metric-anomaly verdicts alert only, so each step heals one anomaly), the
# reference test's grace ladder (tests/test_detector.py), the cluster's RF
# as the healing target, network capacity among the detection goals (the
# ramp of (c) loads the network), forecasting on, three windows ahead.
HEAL_CONFIG = {
    "goals": ",".join(SELF_HEALING_CHAIN),
    "self.healing.enabled": True,
    "goal.violations.self.healing.enabled": False,
    "metric.anomaly.self.healing.enabled": False,
    "broker.failure.alert.threshold.ms": 100,
    "broker.failure.self.healing.threshold.ms": 200,
    "self.healing.target.topic.replication.factor": 2,
    "anomaly.detection.goals": ",".join([
        "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
        "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal"]),
    "forecast.enabled": True,
    "forecast.horizon.ms": 900_000,
}
# e2e-1000b-50000p (the session cell's cluster, PERF.md section 4): kill
# broker 7 (a leader-heavy one), fail broker 11's disk, ramp topic t0 x3.7 a
# window
HEAL_E2E = dict(cluster="e2e", brokers=1000, partitions=50_000, seed=7,
                windows=5, kill=7, disk=11, ramp_topic="t0", ramp=3.7,
                config={"num.metrics.windows": 5,
                        "min.samples.per.metrics.window": 1})
# the tier-1 size (tests/test_session.py's cluster: 10 brokers, 60 RF-2
# partitions, 6 windows)
HEAL_SMALL = dict(cluster="small", brokers=10, partitions=60, seed=0,
                  windows=6, kill=3, disk=5, ramp_topic="t0", ramp=3.0,
                  config={})

WINDOW_MS = 300_000.0


def _sha(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def assignment_sha(be) -> str:
    """The backend's assignment: (topic, partition, replicas, leader,
    logdirs) in key order."""
    return _sha([(tp, list(p.replicas), p.leader, sorted(p.logdir_by_broker.items()))
                 for tp, p in sorted(be.partitions().items())])


def _census(cc) -> dict:
    st = cc.executor.state_json()
    return dict(state=st["state"], total=st.get("numTotalTasks", 0),
                by_state=dict(sorted(st.get("numTasksByState", {}).items())),
                executions=st["numExecutions"],
                completed_total=st["numCompletedTasksTotal"])


def _handled(entries) -> list:
    """(type, action, fix summary) per handled anomaly: the fix's operation,
    proposal count and sha256 of the proposals' JSON, and whether it ran."""
    out = []
    for h in entries:
        fix = h.get("fixResult")
        summary = None
        if isinstance(fix, dict):
            props = (fix.get("result") or {}).get("proposals", [])
            summary = dict(operation=fix.get("operation"),
                           executed=bool(fix.get("executed")),
                           proposals=len(props), proposals_sha=_sha(props))
        out.append(dict(type=h["anomaly"]["type"], action=h["action"], fix=summary,
                        error=h.get("fixError")))
    return out


def heal_script(ns: dict, spec: dict, timer=None) -> list:
    """The three heals of ``spec`` through the classes in ``ns``
    (``ns["kw"]`` goes to ``CruiseControl``, e.g. the port's ``device``).
    ``timer(label)`` is a context manager around each timed phase ("detect
    a", "fix a", ..., "forecast"); the default times nothing."""
    timer = timer or (lambda label: contextlib.nullcontext())
    be = session_backend(ns, spec)
    cfg = ns["cruise_control_config"](dict(spec["config"], **HEAL_CONFIG))
    cc = ns["CruiseControl"](be, cfg, **ns.get("kw", {}))
    cc.start_up()
    ad = cc.anomaly_detector
    t = 0
    for t in range(spec["windows"]):
        cc.load_monitor.sample_once(now_ms=t * WINDOW_MS)
    rows = []

    def step_row(name, n, handles, extra=None):
        row = dict(step=name, detected=n, handled=[_handled(h) for h in handles],
                   census=_census(cc), sim_ms=round(float(be.now_ms()), 3),
                   assignment=assignment_sha(be))
        row.update(extra or {})
        rows.append(row)

    # (a) broker failure: CHECK inside the grace ladder, FIX after it
    be.kill_broker(spec["kill"])
    now = be.now_ms() + 1000.0
    with timer("detect a"):
        n = ad.run_detection_round(now_ms=now)
    h1 = ad.handle_anomalies(now_ms=now)
    with timer("fix a"):
        h2 = ad.handle_anomalies(now_ms=now + 10_000.0)
    step_row("broker_failure", n, [h1, h2])
    be.restart_broker(spec["kill"])

    # (b) disk failure: the broker's only logdir
    broker = be.brokers()[spec["disk"]]
    be.fail_disk(spec["disk"], next(iter(broker.logdirs)))
    t += 1
    cc.load_monitor.sample_once(now_ms=t * WINDOW_MS)
    now = max(be.now_ms(), t * WINDOW_MS) + 1000.0
    with timer("detect b"):
        n = ad.run_detection_round(now_ms=now)
    with timer("fix b"):
        h1 = ad.handle_anomalies(now_ms=now)
    h2 = ad.handle_anomalies(now_ms=now + 10_000.0)
    step_row("disk_failure", n, [h1, h2])
    # the operator retires the healed broker with its dead disk
    be.decommission_broker(spec["disk"])

    # (c) predicted breach: ramp one topic over a full ring of windows
    for _ in range(spec["windows"]):
        be.scale_partition_load(spec["ramp"], topics={spec["ramp_topic"]})
        t += 1
        cc.load_monitor.sample_once(now_ms=t * WINDOW_MS)
    with timer("forecast"):
        fres = cc.forecaster.forecast()
    now = max(be.now_ms(), t * WINDOW_MS) + 1000.0
    with timer("detect c"):
        n = ad.run_detection_round(now_ms=now)
    pred = cc.predicted_goal_violation_detector
    with timer("fix c"):
        h1 = ad.handle_anomalies(now_ms=now)
    cached = cc.cached_proposals()
    spec_state = cc.speculative_state_json()
    step_row("predicted_breach", n, [h1], dict(
        forecast=_digest32(fres.forecast) if fres is not None else None,
        forecast_shape=list(fres.forecast.shape) if fres is not None else None,
        rising=bool(fres.rising) if fres is not None else None,
        predicted=list(pred.last_predicted), predictions=pred.predictions,
        speculative=dict(installs=spec_state["installs"], hits=spec_state["hits"],
                         stale=spec_state["stale"]),
        cached_proposals=len(cached.proposals),
        cached_violated_after=sorted(cached.violated_goals_after)))
    cc.shutdown()
    return rows


def _digest32(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()[:16]


def port_heal_ns(device="cuda") -> dict:
    """The port's classes for ``heal_script``, on ``device``."""
    from cruise_control_tpu_torch.app import CruiseControl
    from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu_torch.config import cruise_control_config
    return dict(CruiseControl=CruiseControl,
                SimulatedClusterBackend=SimulatedClusterBackend,
                cruise_control_config=cruise_control_config,
                kw=dict(device=device))
