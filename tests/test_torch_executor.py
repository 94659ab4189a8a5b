"""The executor through the port against the JAX reference.

Every case of ``tests/test_executor.py`` runs as one script through both
packages' classes (the executor, planner, strategies and tasks, and the
simulated backend): the port's in process, the reference's in one fresh
interpreter per module (``torch_reference.cases_job``, started in the
background when the module is imported), so the test worker imports
nothing of JAX. The two runs compare with ``==`` on what the
case observes: the task census by state, the throttles and per-topic
throttled-replica lists, the adjuster's caps, the final assignment. No case starts a thread or
sleeps on the wall clock: ``execute_proposals`` runs to its end on the
calling thread, on ``SimClock``, and the force-stop cases stop the
execution from a backend callback that fires inside the executor's own
progress sleep.
"""
import pytest

from torch_reference import (
    background_reference, cases_job, one_torch_thread, start_background_reference,
)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

CASES = ("inter_broker_move", "movement_takes_time", "leadership_phase",
         "per_broker_cap", "cluster_cap", "large_first", "force_stop",
         "throttle_cleared", "task_state_machine", "reservation", "state_json",
         "adjuster_aimd", "adjuster_in_execution", "adjuster_mid_execution",
         "throttled_replica_lists", "throttle_cleanup_after_force_stop",
         "strategy_chain_from_config", "removal_history_retention",
         "leadership_timeout", "leadership_latency_under_timeout")


def _ns(ref: bool) -> dict:
    if ref:
        from cruise_control_tpu.analyzer.proposals import ExecutionProposal
        from cruise_control_tpu.backend import SimulatedClusterBackend
        from cruise_control_tpu.config import cruise_control_config
        from cruise_control_tpu.executor import (
            Executor, ExecutionTaskPlanner, TaskState, TaskType, build_strategy,
        )
        from cruise_control_tpu.executor.executor import (
            ConcurrencyAdjuster, ExecutorConfigView,
        )
        from cruise_control_tpu.executor.task import ExecutionTask
    else:
        from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
        from cruise_control_tpu_torch.backend import SimulatedClusterBackend
        from cruise_control_tpu_torch.config import cruise_control_config
        from cruise_control_tpu_torch.executor import (
            Executor, ExecutionTaskPlanner, TaskState, TaskType, build_strategy,
        )
        from cruise_control_tpu_torch.executor.executor import (
            ConcurrencyAdjuster, ExecutorConfigView,
        )
        from cruise_control_tpu_torch.executor.task import ExecutionTask
    return dict(locals())


def _backend(ns):
    be = ns["SimulatedClusterBackend"]()
    for b, rack in ((0, "r0"), (1, "r0"), (2, "r1"), (3, "r1")):
        be.add_broker(b, rack)
    be.create_partition("t", 0, [0, 1], size_mb=100.0, bytes_in_rate=10)
    be.create_partition("t", 1, [1, 2], size_mb=200.0, bytes_in_rate=10)
    be.create_partition("t", 2, [2, 0], size_mb=50.0, bytes_in_rate=10)
    return be


def _move(ns, topic, part, old, new, old_leader=None, new_leader=None):
    return ns["ExecutionProposal"](
        topic=topic, partition=part,
        old_leader=old_leader if old_leader is not None else old[0],
        new_leader=new_leader if new_leader is not None else new[0],
        old_replicas=tuple((b, 0) for b in old),
        new_replicas=tuple((b, 0) for b in new))


def _assignment(be) -> list:
    return [(tp, sorted(p.replicas), p.leader) for tp, p in sorted(be.partitions().items())]


def _tasks(ex) -> list:
    planner = ex._current_planner
    if planner is None:
        return []
    return [(t.tp, t.task_type.name, t.state.name) for t in planner.all_tasks]


def _census(ex) -> dict:
    st = ex.state_json()
    return {k: st.get(k) for k in ("state", "numTotalTasks", "numFinishedTasks",
                                   "numPendingTasks", "numAbortedTasks",
                                   "numTasksByState", "numExecutions")}


def executor_case(ns, name: str) -> dict:
    """tests/test_executor.py's case ``name`` through the classes in ``ns``;
    returns what it observes, in plain values."""
    mv = lambda *a, **k: _move(ns, *a, **k)  # noqa: E731
    cfg = ns["cruise_control_config"]
    if name == "inter_broker_move":
        be = _backend(ns)
        ex = ns["Executor"](be)
        ex.execute_proposals([mv("t", 0, [0, 1], [3, 1], old_leader=0, new_leader=3)])
        return dict(assignment=_assignment(be), state=ex.state, census=_census(ex),
                    clock=be.now_ms())
    if name == "movement_takes_time":
        be = _backend(ns)
        be.alter_partition_reassignments({("t", 1): [3, 2]})
        be.advance(10.0)
        ongoing = ("t", 1) in be.ongoing_reassignments()
        be.advance(10_000.0)
        return dict(ongoing=ongoing, after=("t", 1) in be.ongoing_reassignments(),
                    assignment=_assignment(be))
    if name == "leadership_phase":
        be = _backend(ns)
        ex = ns["Executor"](be)
        ex.execute_proposals([mv("t", 2, [2, 0], [2, 0], old_leader=2, new_leader=0)])
        return dict(assignment=_assignment(be), tasks=_tasks(ex), clock=be.now_ms())
    if name == "per_broker_cap":
        be = ns["SimulatedClusterBackend"]()
        for b in range(3):
            be.add_broker(b, f"r{b}")
        for p in range(10):
            be.create_partition("u", p, [0], size_mb=10.0)
        planner = ns["ExecutionTaskPlanner"](
            ns["build_strategy"](["BaseReplicaMovementStrategy"]))
        planner.add_proposals([mv("u", p, [0], [1]) for p in range(10)])
        batch = planner.next_inter_broker_tasks({}, per_broker_cap=3, cluster_cap=100,
                                                in_flight_total=0)
        return dict(batch=[t.tp for t in batch])
    if name == "cluster_cap":
        planner = ns["ExecutionTaskPlanner"]()
        planner.add_proposals([mv("u", p, [0], [1]) for p in range(10)])
        batch = planner.next_inter_broker_tasks({}, per_broker_cap=100, cluster_cap=4,
                                                in_flight_total=0)
        return dict(batch=[t.tp for t in batch])
    if name == "large_first":
        be = _backend(ns)
        sizes = {tp: i.size_mb for tp, i in be.partitions().items()}
        planner = ns["ExecutionTaskPlanner"](
            ns["build_strategy"](["PrioritizeLargeReplicaMovementStrategy"]))
        planner.add_proposals([mv("t", 0, [0, 1], [3, 1]), mv("t", 1, [1, 2], [3, 2]),
                               mv("t", 2, [2, 0], [3, 0])],
                              context={"partition_size_mb": sizes})
        return dict(order=[t.tp for t in planner.remaining_inter_broker])
    if name in ("force_stop", "throttle_cleanup_after_force_stop"):
        be = _backend(ns)
        if name == "force_stop":
            # a copy that would take forever: it is in flight when the stop lands
            be.create_partition("big", 0, [0, 1], size_mb=1e12)
            props = [mv("big", 0, [0, 1], [3, 1])]
        else:
            props = [mv("t", 1, [1, 2], [3, 2])]
        ex = ns["Executor"](be)
        if name == "throttle_cleanup_after_force_stop":
            ex._cfg.throttle_bytes_per_sec = 1
        seen = {}
        be.schedule_at(be.now_ms() + 5_000.0, lambda now: (
            seen.update(configs=dict(be.topic_configs()),
                        ongoing=sorted(be.ongoing_reassignments())),
            ex.stop_execution(force=True)))
        ex.execute_proposals(props)
        return dict(seen=seen, state=ex.state, ongoing=sorted(be.ongoing_reassignments()),
                    assignment=_assignment(be), tasks=_tasks(ex),
                    throttle=be.replication_throttle(), configs=be.topic_configs(),
                    census=_census(ex))
    if name == "throttle_cleared":
        be = _backend(ns)
        ex = ns["Executor"](be)
        ex._cfg.throttle_bytes_per_sec = 50_000_000
        ex.execute_proposals([mv("t", 2, [2, 0], [3, 0])])
        return dict(throttle=be.replication_throttle(), assignment=_assignment(be),
                    clock=be.now_ms())
    if name == "task_state_machine":
        t = ns["ExecutionTask"](mv("t", 0, [0], [1]),
                                ns["TaskType"].INTER_BROKER_REPLICA_ACTION)
        states = [t.state.name]
        t.transition(ns["TaskState"].IN_PROGRESS, 1.0)
        t.transition(ns["TaskState"].COMPLETED, 2.0)
        states.append(t.state.name)
        with pytest.raises(ValueError):
            t.transition(ns["TaskState"].IN_PROGRESS)
        return dict(states=states)
    if name == "reservation":
        ex = ns["Executor"](_backend(ns))
        ex.reserve("detector")
        with pytest.raises(RuntimeError):
            ex.reserve("rest-api")
        ex.release("detector")
        ex.reserve("rest-api")
        return dict(ok=True)
    if name == "state_json":
        be = _backend(ns)
        ex = ns["Executor"](be)
        ex.execute_proposals([mv("t", 0, [0, 1], [3, 1])])
        st = ex.state_json()
        return dict(census=_census(ex), history=len(st["executionHistory"]),
                    completed=st["numCompletedTasksTotal"],
                    planned=st["numPlannedTasksTotal"])
    if name == "adjuster_aimd":
        view = ns["ExecutorConfigView"](per_broker_cap=8, adjuster_enabled=True)
        adj = ns["ConcurrencyAdjuster"](view)
        healthy = {0: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 5.0},
                   1: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 8.0}}
        slow = {0: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 5.0},
                1: {"BROKER_LOG_FLUSH_TIME_MS_999TH": 9000.0}}
        caps, c = [], 8
        for _ in range(4):
            c = adj.recommend_replica_concurrency(c, slow)
            caps.append(c)
        for _ in range(3):
            c = adj.recommend_replica_concurrency(c, healthy)
            caps.append(c)
        lead = [adj.recommend_leadership_concurrency(1000, slow),
                adj.recommend_leadership_concurrency(150, slow)]
        lead.append(adj.recommend_leadership_concurrency(lead[-1], healthy))
        return dict(caps=caps, lead=lead, history=list(adj.history))
    if name == "adjuster_in_execution":
        be = _backend(ns)
        ex = ns["Executor"](be, config=cfg({
            "concurrency.adjuster.enabled": True,
            "num.concurrent.partition.movements.per.broker": 8,
            "execution.progress.check.interval.ms": 10}))
        be.override_broker_metric(2, "BROKER_PRODUCE_LOCAL_TIME_MS_999TH", 50_000.0)
        ex.execute_proposals([mv("t", 0, [0, 1], [3, 1], old_leader=0, new_leader=3),
                              mv("t", 1, [1, 2], [3, 2], old_leader=1, new_leader=3)])
        cap1 = ex._cfg.per_broker_cap
        recent = ex.state_json()["concurrencyAdjuster"]["recentAdjustments"]
        be.override_broker_metric(2, "BROKER_PRODUCE_LOCAL_TIME_MS_999TH", None)
        ex.execute_proposals([mv("t", 2, [2, 0], [1, 0], old_leader=2, new_leader=1)])
        return dict(cap1=cap1, recent=recent, cap2=ex._cfg.per_broker_cap,
                    assignment=_assignment(be), clock=be.now_ms())
    if name == "adjuster_mid_execution":
        be = _backend(ns)
        ex_cfg = cfg({"concurrency.adjuster.enabled": True,
                      "num.concurrent.partition.movements.per.broker": 8,
                      "concurrency.adjuster.interval.ms": 5_000,
                      "execution.progress.check.interval.ms": 1_000,
                      "default.replication.throttle": 2 * 1024 * 1024})
        be.schedule_at(10_000.0, lambda now: be.override_broker_metric(
            2, "BROKER_LOG_FLUSH_TIME_MS_999TH", 50_000.0))
        be.schedule_at(60_000.0, lambda now: be.override_broker_metric(
            2, "BROKER_LOG_FLUSH_TIME_MS_999TH", None))
        ex = ns["Executor"](be, config=ex_cfg)
        ex.execute_proposals([mv("t", 0, [0, 1], [3, 1], old_leader=0, new_leader=3),
                              mv("t", 1, [1, 2], [3, 2], old_leader=1, new_leader=3),
                              mv("t", 2, [2, 0], [1, 0], old_leader=2, new_leader=1)])
        adjustments = [a for a in ex._adjuster.history
                       if a["type"] == "INTER_BROKER_REPLICA"]
        return dict(adjustments=adjustments, tasks=_tasks(ex), clock=be.now_ms(),
                    assignment=_assignment(be))
    if name == "throttled_replica_lists":
        be = _backend(ns)
        seen = {}
        orig = be.alter_partition_reassignments

        def spy(assignments):
            seen.update(be.topic_configs())
            orig(assignments)

        be.alter_partition_reassignments = spy
        ex = ns["Executor"](be)
        ex._cfg.throttle_bytes_per_sec = 50_000_000
        ex.execute_proposals([mv("t", 2, [2, 0], [3, 0])])
        return dict(seen=seen, throttle=be.replication_throttle(),
                    configs=be.topic_configs(), assignment=_assignment(be))
    if name == "strategy_chain_from_config":
        ex = ns["Executor"](_backend(ns), config=cfg({
            "default.replica.movement.strategies":
                ["PrioritizeSmallReplicaMovementStrategy"]}))
        with pytest.raises(ValueError):
            ex.validate_strategies(["NoSuchStrategy"])
        ex.validate_strategies(["PrioritizeLargeReplicaMovementStrategy"])
        return dict(strategy=ex._strategy.name)
    if name == "removal_history_retention":
        be = _backend(ns)
        ex = ns["Executor"](be, config=cfg({"removal.history.retention.time.ms": 1000,
                                            "demotion.history.retention.time.ms": 2000}))
        ex.note_removed_brokers([1])
        ex.note_demoted_brokers([2])
        out = [(sorted(ex.recently_removed_brokers()), sorted(ex.recently_demoted_brokers()))]
        be.advance(1500.0)
        out.append((sorted(ex.recently_removed_brokers()),
                    sorted(ex.recently_demoted_brokers())))
        be.advance(1000.0)
        out.append((sorted(ex.recently_removed_brokers()),
                    sorted(ex.recently_demoted_brokers())))
        return dict(history=out)
    if name in ("leadership_timeout", "leadership_latency_under_timeout"):
        timeout = 5000 if name == "leadership_timeout" else 60_000
        latency = 60_000.0 if name == "leadership_timeout" else 3_000.0
        be = _backend(ns)
        be.set_leadership_latency_ms(latency)
        ex = ns["Executor"](be, config=cfg({"leader.movement.timeout.ms": timeout,
                                            "execution.progress.check.interval.ms": 1000}))
        props = [mv("t", 2, [2, 0], [2, 0], old_leader=2, new_leader=0)]
        if name == "leadership_timeout":
            props.append(mv("t", 1, [1, 2], [1, 2], old_leader=1, new_leader=2))
        ex.execute_proposals(props)
        out = dict(tasks=_tasks(ex), census=_census(ex), clock=be.now_ms(),
                   leader_now=be.partitions()[("t", 2)].leader)
        be.advance(120_000.0)
        out["leader_later"] = be.partitions()[("t", 2)].leader
        return out
    raise ValueError(name)


def reference_executor_cases() -> dict:
    """Every case through the reference's classes (run by
    ``torch_reference.cases_job`` in a fresh interpreter)."""
    ns = _ns(True)
    return {name: executor_case(ns, name) for name in CASES}


# the reference's interpreter starts when the module is imported (under
# xdist, once per session, in the background)
_REFERENCE_JOBS = {"cases": cases_job("test_torch_executor", "reference_executor_cases")}
start_background_reference("executor", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return background_reference(tmp_path_factory, "executor", _REFERENCE_JOBS)["cases"]


@pytest.mark.parametrize("name", CASES)
def test_executor_case_matches_reference(name, reference):
    assert executor_case(_ns(False), name) == reference[name]


def test_cases_observe_what_the_reference_tests_assert():
    """The port's runs show what tests/test_executor.py asserts of the
    reference (so an agreement above is not an agreement on nothing)."""
    ns = _ns(False)
    run = lambda n: executor_case(ns, n)  # noqa: E731
    r = run("inter_broker_move")
    assert r["assignment"][0] == (("t", 0), [1, 3], 3) and r["state"] == "NO_TASK_IN_PROGRESS"
    assert run("movement_takes_time")["ongoing"] and not run("movement_takes_time")["after"]
    assert len(run("per_broker_cap")["batch"]) == 3 and len(run("cluster_cap")["batch"]) == 4
    assert run("large_first")["order"] == [("t", 1), ("t", 0), ("t", 2)]
    fs = run("force_stop")
    assert fs["state"] == "NO_TASK_IN_PROGRESS" and not fs["ongoing"]
    assert fs["assignment"][0] == (("big", 0), [0, 1], 0)
    assert any(s == "ABORTED" for _, _, s in fs["tasks"]) and fs["seen"]["ongoing"]
    tc = run("throttle_cleanup_after_force_stop")
    assert tc["throttle"] is None and "t" not in tc["configs"] and tc["seen"]["configs"]["t"]
    assert run("throttle_cleared")["throttle"] is None
    a = run("adjuster_aimd")
    assert a["caps"] == [4, 2, 1, 1, 2, 3, 4] and a["lead"] == [500, 100, 200]
    ai = run("adjuster_in_execution")
    assert ai["cap1"] < 8 and ai["recent"] and ai["cap2"] > ai["cap1"]
    caps = [x["to"] for x in run("adjuster_mid_execution")["adjustments"]]
    assert min(caps) < 8 and caps[-1] > min(caps)
    tl = run("throttled_replica_lists")
    assert tl["seen"]["t"]["leader.replication.throttled.replicas"] == "2:0,2:2"
    assert tl["seen"]["t"]["follower.replication.throttled.replicas"] == "2:3"
    assert "t" not in tl["configs"]
    assert "PrioritizeSmallReplicaMovementStrategy" in run("strategy_chain_from_config")[
        "strategy"]
    assert run("removal_history_retention")["history"] == [([1], [2]), ([], [2]), ([], [])]
    lt = run("leadership_timeout")
    assert lt["census"]["numAbortedTasks"] == 2 and lt["leader_later"] == 0
    lu = run("leadership_latency_under_timeout")
    assert [s for _, k, s in lu["tasks"] if k == "LEADER_ACTION"] == ["COMPLETED"]
