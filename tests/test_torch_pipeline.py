"""The port's pipelined service loop (``cruise_control_tpu_torch.pipeline``)
and the flight recorder's round traces, on the CPU.

Every non-simulator case of ``tests/test_pipeline.py``: the ring buffer,
the backpressure stall and its release from live sampling alone, the unified
clock, the shadow-slot sync while a round holds the lent state, the round
trace's stage lanes and overlap fractions, the pipelined round equal to the
blocking round, the sync memo, stale and superseded rounds dropped, the
routed FIX on the threaded execute stage, sticky rounds; each test builds
its own app and loop. Beside them: the lockstep loop bit-identical run to
run, the fleet's ``submit_install`` on a threaded loop, and
``tests/test_tracing.py::test_record_round_assembles_from_engine_data``
with the optimizer's own rounds and ``measure_goal_durations``. The
reference's compile counts (``count_compiles``) have no counterpart: the
port compiles nothing at run time.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.app import CruiseControl
from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend
from cruise_control_tpu_torch.config import cruise_control_config
from cruise_control_tpu_torch.pipeline import PipelinedServiceLoop, SampleRingBuffer
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

WINDOW_MS = 60_000.0


def _backend(brokers=8, partitions=60, seed=0):
    be = SimulatedClusterBackend()
    for b in range(brokers):
        be.add_broker(b, f"r{b % 4}")
    rng = np.random.default_rng(seed)
    for p in range(partitions):
        be.create_partition("t%d" % (p % 6), p,
                            [int(p % brokers), int((p + 1) % brokers)],
                            size_mb=float(rng.exponential(100.0)),
                            bytes_in_rate=5.0, bytes_out_rate=3.0, cpu_util=0.2)
    return be


def _app(be, **props):
    cfg = {"num.metrics.windows": 3, "min.samples.per.metrics.window": 1,
           "metrics.window.ms": int(WINDOW_MS)}
    cfg.update(props)
    cc = CruiseControl(be, cruise_control_config(cfg), device="cpu")
    cc.start_up()
    return cc


@pytest.fixture
def warm_loop():
    """An app + pipeline of this test's own, windows filled and the first
    rounds behind it."""
    be = _backend()
    cc = _app(be)
    pipe = PipelinedServiceLoop(cc)
    cc.service_pipeline = pipe
    for _ in range(4):
        be.advance(WINDOW_MS)
        pipe.step(optimize=True)
    yield be, cc, pipe
    cc.shutdown()


def test_ring_buffer_drops_oldest_and_preserves_order():
    class Batch:
        def __init__(self, n):
            self.partition_samples = [None] * n
            self.broker_samples = [None] * 4
            self.partition_blocks = ()

    ring = SampleRingBuffer(capacity=2)
    keys = {ring.push(float(i), Batch(50)) for i in range(3)}
    assert len(keys) == 1
    assert ring.dropped == 1 and ring.pushed == 3
    assert [now for _seq, now, _s, _f in ring.drain()] == [1.0, 2.0]
    assert len(ring) == 0
    ring.push(9.0, Batch(50))
    ring.push(10.0, Batch(5000))
    assert len(ring.state_json()["buckets"]) == 2
    assert [now for _seq, now, _s, _f in ring.drain()] == [9.0, 10.0]


def test_backpressure_stalls_then_releases_from_live_sampling_alone():
    be = _backend()
    cc = _app(be)
    pipe = PipelinedServiceLoop(cc)
    out = pipe.step(optimize=True)
    assert out["optimize"] == {"stalled": True}
    assert pipe.stalled and pipe.stall_count == 1
    for _ in range(4):
        be.advance(WINDOW_MS)
        out = pipe.step(optimize=True)
    assert out["optimize"].get("optimized") is True
    assert not pipe.stalled and pipe.release_count == 1
    assert cc.cached_proposals() is not None
    cc.shutdown()


def test_unified_clock_sampling_fills_windows_without_bootstrap():
    from cruise_control_tpu_torch.monitor.load_monitor import (
        ModelCompletenessRequirements, NotEnoughValidWindowsError,
    )
    be = _backend()
    cc = _app(be)
    lm = cc.load_monitor
    with pytest.raises(NotEnoughValidWindowsError):
        lm.cluster_model()
    for _ in range(3):
        be.advance(WINDOW_MS)
        lm.sample_once()
    assert lm.meet_completeness_requirements(
        ModelCompletenessRequirements(min_required_num_windows=2))
    ct, _meta = lm.cluster_model()
    assert int(np.asarray(ct.replica_valid).sum()) == 120
    assert cc.bootstrap(clear_metrics=False)["endMs"] == int(be.now_ms())
    cc.shutdown()


def test_shadow_slot_sync_runs_while_state_is_lent(warm_loop):
    be, cc, pipe = warm_loop
    sess = cc.resident_session
    before = sess.shadow_syncs
    be.advance(WINDOW_MS)
    out = pipe.pipelined_round()
    assert out["result"] is not None
    assert sess.shadow_syncs > before
    assert out["sync_info"].get("mode") == "delta"
    assert sess.donated_rounds > 0
    assert cc.state_json(substates=["ANALYZER"])["AnalyzerState"]["residentSession"][
        "shadowSyncs"] == sess.shadow_syncs


def test_round_trace_carries_stage_lanes_and_overlap(warm_loop):
    """The trace of a full pipelined round carries the overlapped ingest
    and sync (a memo round of a few milliseconds may record before those
    stages are noted; their notes then ride the next round's trace)."""
    be, cc, pipe = warm_loop
    be.advance(WINDOW_MS)
    out = pipe.pipelined_round()
    assert out["result"].round_mode == "full"
    trace = out["trace"]
    assert {"ingest", "sync"} <= {s["stage"] for s in trace.stages}
    assert set(trace.overlap) >= {"ingest", "sync"}
    for lane in trace.overlap.values():
        assert 0.0 <= lane["overlap_frac"] <= 1.0
    doc = trace.to_json()
    assert doc["stages"] and doc["overlap"]
    state = cc.state_json(substates=["PIPELINE", "ROUND_TRACES"])
    assert state["PipelineState"]["optimizeRounds"] > 0
    assert state["RoundTraces"]["traces"]


def test_pipelined_round_matches_blocking_round(warm_loop):
    be, cc, pipe = warm_loop

    def sets(res):
        return [(g.name, g.violated_before, g.violated_after, g.fixpoint_proven)
                for g in res.goal_results]

    be.advance(WINDOW_MS)
    cc.load_monitor.sample_once()
    blocking = cc.cached_proposals(force_refresh=True)
    piped = pipe.pipelined_round()["result"]
    assert sets(piped) == sets(blocking)
    assert len(piped.proposals) == len(blocking.proposals)


def test_session_sync_memo_skips_unchanged_inputs(warm_loop):
    be, cc, pipe = warm_loop
    sess = cc.resident_session
    be.advance(WINDOW_MS)
    cc.load_monitor.sample_once()
    first = sess.sync()
    assert "memo" not in first
    again = sess.sync()
    assert again.get("memo") is True and again["mode"] == first["mode"]


def test_stale_generation_round_dropped_not_executed(warm_loop):
    be, cc, pipe = warm_loop
    res = cc.cached_proposals()
    assert res.proposals
    execs_before = cc.executor.state_json()["numExecutions"]
    pipe.submit_execution(res.proposals[:2])
    be.add_broker(90, "r9")
    assert pipe.drain_executions() == {"executed": 0, "dropped": 1, "installed": 0}
    assert pipe.stale_rounds_dropped == 1
    assert cc.executor.state_json()["numExecutions"] == execs_before


def test_superseded_round_dropped_newest_executes(warm_loop):
    be, cc, pipe = warm_loop
    res = cc.cached_proposals(force_refresh=True)
    assert len(res.proposals) >= 2
    pipe.submit_execution(res.proposals[:1])
    rnd = pipe.submit_execution(res.proposals[1:2])
    out = pipe.drain_executions()
    assert out["dropped"] == 1 and out["executed"] == 1
    assert pipe.stale_rounds_dropped == 1
    assert cc.executor.state_json()["proposalGeneration"] == rnd.metadata_generation


def test_fix_routed_through_execute_stage_with_span_lineage():
    import time as _time
    be = SimulatedClusterBackend()
    for b in range(8):
        be.add_broker(b, f"r{b % 4}")
    rng = np.random.default_rng(5)
    for p in range(60):
        be.create_partition("t%d" % (p % 6), p, [p % 3, (p + 1) % 3],
                            size_mb=float(rng.exponential(100.0)),
                            bytes_in_rate=5.0, bytes_out_rate=3.0, cpu_util=0.2)
    cc = _app(be)
    for _ in range(4):
        be.advance(WINDOW_MS)
        cc.load_monitor.sample_once()
    pipe = PipelinedServiceLoop(cc)
    cc.service_pipeline = pipe
    assert not pipe.accepts_fix_routing() and not cc._route_fixes_async()
    pipe.start()
    try:
        assert pipe.accepts_fix_routing() and cc._route_fixes_async()
        out = cc.rebalance(self_healing=True, dry_run=False, reason="routed heal")
        assert out["executed"] is True
        deadline = _time.monotonic() + 120.0
        while _time.monotonic() < deadline:
            st = cc.executor.state_json()
            if (pipe.executions_drained >= 1 and st["numExecutions"] >= 1
                    and not cc.executor.has_ongoing_execution()):
                break
            _time.sleep(0.05)
        assert pipe.executions_drained >= 1
        assert cc.executor.state_json()["numExecutions"] >= 1
        assert cc.sensors.meter("pipeline-routed-fixes").to_json()["count"] == 1
    finally:
        pipe.stop()
    trees = cc.tracer.to_json()["trees"]
    op_nodes = [n for t in trees for n in t["roots"]
                if n["span_kind"] == "operation" and n["name"] == "REBALANCE"]
    assert op_nodes
    assert "execution" in {c["span_kind"] for n in op_nodes for c in n["children"]}
    cc.shutdown()


def test_sticky_round_survives_generation_bump():
    be = _backend(seed=6)
    cc = _app(be)
    for _ in range(4):
        be.advance(WINDOW_MS)
        cc.load_monitor.sample_once()
    pipe = PipelinedServiceLoop(cc)
    cc.service_pipeline = pipe
    res = cc.cached_proposals()
    assert len(res.proposals) >= 2
    pipe.submit_execution(res.proposals[:1])
    pipe.submit_execution(res.proposals[1:2], sticky=True)
    be.add_broker(97, "r9")
    assert pipe.drain_executions() == {"executed": 1, "dropped": 1, "installed": 0}
    cc.shutdown()


def _lockstep_run() -> str:
    """A lockstep drive of its own: six ticks of execute-drain, ingest,
    sync and optimize; every step's report and the last round's outcome."""
    from cruise_control_tpu_torch.analyzer.session_script import round_row
    be = _backend(seed=3)
    cc = _app(be)
    pipe = PipelinedServiceLoop(cc)
    cc.service_pipeline = pipe
    steps = []
    for t in range(6):
        be.advance(WINDOW_MS)
        out = pipe.step(now_ms=(t + 1) * WINDOW_MS)
        out["sync"] = {k: v for k, v in out["sync"].items() if k != "sync_s"}
        steps.append(out)
    row = round_row({"mode": "lockstep"}, cc.cached_proposals())
    state = {k: v for k, v in pipe.state_json().items()}
    cc.shutdown()
    return json.dumps(dict(steps=steps, row=row, state=state), sort_keys=True,
                      default=str)


def test_lockstep_loop_is_bit_identical_run_to_run():
    assert _lockstep_run() == _lockstep_run()


def test_fleet_installs_ride_a_threaded_pipeline():
    """A fleet tenant whose facade runs a THREADED pipeline installs its
    batched result through the execute stage (``submit_install``); a
    lockstep tenant installs inline."""
    from cruise_control_tpu_torch import fleet_script as fs
    ns = fs.port_fleet_ns("cpu")
    fleet = ns["FleetScheduler"](config=fs._cfg(ns, fs.FLEET_GOALS), device="cpu")
    pipes = []
    for k in range(2):
        t = fleet.add_tenant(f"t{k}", backend=fs.tenant_backend(ns, 40 + k),
                             config=fs._cfg(ns, fs.FLEET_GOALS))
        fs._sample(t.cc)
        pipe = PipelinedServiceLoop(t.cc)
        t.cc.service_pipeline = pipe
        pipes.append(pipe)
    pipes[0].start()
    try:
        fleet.run_round(now_ms=fs.T0)
        import time as _time
        deadline = _time.monotonic() + 60.0
        while pipes[0].installs_drained < 1 and _time.monotonic() < deadline:
            _time.sleep(0.02)
    finally:
        pipes[0].stop()
    assert pipes[0].installs_drained == 1 and pipes[1].installs_drained == 0
    for cid in ("t0", "t1"):
        assert fleet.app_for(cid).cached_proposals() is not None
    fleet.shutdown()


# ---------------------------------------------------------------------------
# The flight recorder (tests/test_tracing.py) and the optimizer's rounds
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Tree:
    a: torch.Tensor


def test_record_round_assembles_from_engine_data():
    from cruise_control_tpu_torch.analyzer.optimizer import GoalResult
    from cruise_control_tpu_torch.common.tracing import FlightRecorder
    rec = FlightRecorder(capacity=4, clock_ms=lambda: 1234.0)
    rec.note_sampling(0.25)
    rec.note_operation("PROPOSALS")
    gr = GoalResult(name="RackAwareGoal", violated_before=True, violated_after=False,
                    iterations=3, duration_s=0.5, stat_after=0.0, passes=2,
                    move_actions=3, move_waves=2)
    trace = rec.record_round(
        wall_s=1.5, goal_results=[gr], compiles=2,
        env=_Tree(torch.zeros((4, 4), dtype=torch.float32)),
        state=_Tree(torch.zeros(8, dtype=torch.int32)), num_proposals=7,
        num_replica_movements=5, num_leadership_movements=2,
        session_info={"mode": "delta", "sync_s": 0.04}, donated=True,
        profile_level="pass")
    assert trace is rec.last()
    j = trace.to_json()
    assert j["ts_ms"] == 1234.0 and j["operation"] == "PROPOSALS"
    assert j["sampling_s"] == 0.25 and j["sync_mode"] == "delta"
    assert j["donated"] is True and j["compiles"] == 2
    assert j["env_bytes"] == 64 and j["state_bytes"] == 32
    assert j["goals"][0]["name"] == "RackAwareGoal"
    assert j["goals"][0]["waves"] == 2 and j["goals"][0]["moves"] == 3
    t2 = rec.record_round(wall_s=0.1, goal_results=[], compiles=0, env=None, state=None,
                          num_proposals=0, num_replica_movements=0,
                          num_leadership_movements=0)
    assert t2.operation is None and t2.sampling_s == 0.25


@pytest.mark.parametrize("measure", [False, True])
def test_optimizer_records_its_rounds(measure):
    """``GoalOptimizer.optimizations`` records one trace per round on its
    recorder (the facade's flight recorder); ``measure_goal_durations``
    runs the per-goal dispatch and gives every goal its own wall."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.common.tracing import FlightRecorder
    from cruise_control_tpu_torch.model.fixtures import small_cluster_java
    ct, meta = small_cluster_java()
    rec = FlightRecorder(capacity=4)
    goals = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
    res = GoalOptimizer(device="cpu", recorder=rec).optimizations(
        ct, meta, goal_names=goals, skip_hard_goal_check=True, raise_on_failure=False,
        measure_goal_durations=measure)
    trace = rec.last()
    assert res.round_trace is trace and res.durations_measured is measure
    j = trace.to_json()
    assert [g["name"] for g in j["goals"]] == goals
    assert j["num_proposals"] == len(res.proposals) and j["round_mode"] == "full"
    assert j["env_bytes"] > 0 and j["state_bytes"] > 0
    if measure:
        assert all(r.duration_s > 0 for r in res.goal_results)
        assert j["durations_measured"] is True
