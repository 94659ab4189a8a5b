"""The JAX reference's whole-chain outcome, computed in a fresh interpreter.

The port's chain tests compare ``GoalOptimizer.optimizations`` against the
JAX package on the same cluster. The reference's eleven-goal chain compiles
the largest XLA:CPU programs of the suite, and inside a long-lived
``pytest -n N`` worker that has already compiled hundreds of programs
XLA:CPU aborts or segfaults at random (ROADMAP Queue 3: the same aborts hit
the JAX package's own tests). A fresh interpreter per reference run keeps
those compiles out of the worker; it compiles without the persistent cache,
whose directory every worker shares.

    ref = reference_chain(tmp_path, spec, goals)   # spec None = fixture16

(``spec`` may also name a function of the reference's
``model/fixtures.py``; ``demoted`` lists broker indices to mark demoted,
as ``/demote_broker`` does) returns a dict of plain values: ``counts`` and
``finisher`` (the fields the tests compare), ``swaps`` (swap actions per
goal), ``disk`` (disk actions per goal), ``proposals`` (tuples),
``balancedness_after``, ``stats_after`` and ``final`` (the final
replica_broker / replica_is_leader / replica_disk / util / disk_util).

    refs = reference_chains(tmp_path, [dict(spec=..., goals=...), ...])

runs several chains in ONE fresh interpreter (one JAX import, programs of
one shape compiled once) and returns their dicts in order. A run's
``params`` sets ``EngineParams`` fields; its goals may name
``NoLeaderBudgetGoal`` (LeaderReplicaDistributionGoal without wave budgets,
registered in the child's process only).

    out = shared_reference(tmp_path_factory, name, compute)

computes ``compute(tmp_dir)`` once per test session and hands every
``pytest-xdist`` worker the first one's pickled result.

    start_background_reference(name, {part: cases_job(module, function, part), ...})
    out = background_reference(tmp_path_factory, name, jobs)

start a module's reference interpreters when its module is imported (under
``pytest-xdist``: once per session, in the background, while the earlier
tests run; ``chains_job`` runs ``reference_chains``' runs) and hand each
test the pickled results, computing them there and then without xdist.

    rows = reference_matrix_rows(tmp_path, [0, 1, ...])

runs rows of the Java parity matrix (``tests/test_java_parity_matrix.py``
``MATRIX``) through the reference, each in its own fresh interpreter, and
returns, per row, its outcome as
``tools/gen_parity_table.py`` words it (``optimized (N soft violated)``,
``raises (UNDER_PROVISIONED)`` or ``raises``) and the status of the
recommendation its failure carries (None when it optimizes).

    ref = reference_goal(tmp_path, case)

runs ONE goal program (the reference's ``engine.optimize_goal``, or the
jitted ``_compiled_optimize`` that ``__graft_entry__.entry()`` runs) from a
cluster's initial state and returns its ``info`` (host values) and
``final`` leaves (replica_broker, replica_is_leader, util). ``case`` names
the cluster (``"fixture16"``: ``__graft_entry__._setup()``'s unpadded
fixture; ``"swap_tail"``: ``swap_tail_cluster()``; else a padded
``generate_scale`` spec), the goal, its previous goals, the constraint,
the engine parameters (``scaled``: the optimizer's scaled parameters of
the padded shape, overridden by ``params``) and ``compiled``.

    rows = reference_session(tmp_path, spec)

runs a resident-session service script
(``cruise_control_tpu_torch.analyzer.session_script``) through
the reference's ``SimulatedClusterBackend`` -> ``LoadMonitor`` ->
``ResidentClusterSession`` -> ``GoalOptimizer.optimizations(None,
session=...)`` and returns its rounds' rows; the port's tests run the same
function over the port's classes (``session_script.port_ns``) in-process.
``python tests/torch_reference.py session-e2e`` prints the rows of the
e2e-1000b-50000p cell that ``chip_smoke.py`` phase 6 holds.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_CHILD = r"""
import dataclasses, json, pickle, sys
import numpy as np
from cruise_control_tpu.analyzer.engine import EngineParams
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu.model import fixtures
from cruise_control_tpu.model import random_cluster as rc


def register_no_leader_budget_goal():
    # the reference's twin of the port tests' NoLeaderBudgetGoal: a leader
    # goal without wave budgets, whose chains take the sequential fallbacks;
    # registered in this process only
    from cruise_control_tpu.analyzer.goals import GOAL_CLASSES, GoalKernel
    from cruise_control_tpu.analyzer.goals.distribution import (
        LeaderReplicaDistributionGoal)

    @dataclasses.dataclass(frozen=True)
    class NoLeaderBudgetGoal(LeaderReplicaDistributionGoal):
        wave_budgets = GoalKernel.wave_budgets

        def __post_init__(self):
            super().__post_init__()
            object.__setattr__(self, "name", "NoLeaderBudgetGoal")

    GOAL_CLASSES["NoLeaderBudgetGoal"] = NoLeaderBudgetGoal


register_no_leader_budget_goal()


def run(args):
    if args["spec"] is None:
        from __graft_entry__ import _fixture_cluster
        ct, meta = _fixture_cluster()
    elif isinstance(args["spec"], str):
        ct, meta = getattr(fixtures, args["spec"])()
    else:
        ct, meta = rc.generate_scale(rc.RandomClusterSpec(**args["spec"]))
    if args.get("demoted"):
        demoted = np.zeros(ct.num_brokers, bool)
        demoted[args["demoted"]] = True
        ct = dataclasses.replace(ct, broker_demoted=ct.broker_demoted | demoted)
    kw = dict(args.get("params") or {})
    if args.get("dtype"):
        kw["compute_dtype"] = args["dtype"]
    params = EngineParams(**kw) if kw else None
    res = GoalOptimizer(engine_params=params).optimizations(
        ct, meta, goal_names=args["goals"], skip_hard_goal_check=True,
        raise_on_failure=False)
    g = res.goal_results
    return dict(
        counts=dict(before=res.violated_goals_before, after=res.violated_goals_after,
                    actions=[r.iterations for r in g], passes=[r.passes for r in g],
                    moves=res.num_replica_movements, leads=res.num_leadership_movements),
        finisher=dict(proven=[r.fixpoint_proven for r in g],
                      rounds=[r.finisher_rounds for r in g],
                      quiesce=[r.quiesce_chunk for r in g],
                      swleft=[r.swap_window_remaining for r in g]),
        swaps=[r.swap_actions for r in g],
        disk=[r.disk_actions for r in g],
        proposals=[dataclasses.astuple(p) for p in res.proposals],
        balancedness_after=res.balancedness_after,
        stats_after=res.stats_after,
        final={n: np.asarray(getattr(res.final_state, n))
               for n in ("replica_broker", "replica_is_leader", "replica_disk",
                         "util", "disk_util", "leader_util", "potential_nw_out",
                         "util_residual", "leader_util_residual")})


batch = json.loads(sys.argv[1])
out = [run(args) for args in batch["runs"]]
with open(batch["out"], "wb") as f:
    pickle.dump(out, f)
"""


_MATRIX_CHILD = r"""
import json, pickle, sys
from cruise_control_tpu.analyzer.optimizer import OptimizationFailureError
from test_java_parity_matrix import MATRIX, run_row

HARD = ("RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
        "DiskCapacityGoal", "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
        "CpuCapacityGoal", "KafkaAssignerEvenRackAwareGoal")
args = json.loads(sys.argv[1])
out = []
for i in args["rows"]:
    _row_id, factory, chain, constraint, pattern, _expected = MATRIX[i]
    try:
        _ct, _meta, res = run_row(factory, chain, constraint, pattern)
        hard = [g.name for g in res.goal_results if g.violated_after and g.name in HARD]
        got = (("hard goals violated: " + ",".join(hard)) if hard
               else f"optimized ({len(res.violated_goals_after)} soft violated)")
        status = None
    except OptimizationFailureError as e:
        status = e.recommendation.status.value
        got = "raises (UNDER_PROVISIONED)" if status == "UNDER_PROVISIONED" else "raises"
    out.append(dict(got=got, status=status))
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


_GOAL_CHILD = r"""
import dataclasses, json, pickle, sys
import numpy as np
from cruise_control_tpu.analyzer import engine, init_state, make_env
from cruise_control_tpu.analyzer.env import BalancingConstraint
from cruise_control_tpu.analyzer.goals import make_goal
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu.model import cluster_tensor as ctm
from cruise_control_tpu.model import random_cluster as rc

case = json.loads(sys.argv[1])
if case["cluster"] == "fixture16":
    from __graft_entry__ import _fixture_cluster
    ct, meta = _fixture_cluster()
elif case["cluster"] == "swap_tail":
    from torch_reference import swap_tail_cluster
    ct, meta = swap_tail_cluster()
else:
    ct, meta = ctm.pad_cluster(*rc.generate_scale(rc.RandomClusterSpec(**case["cluster"])))
env = make_env(ct, meta)
st = init_state(env, ct.replica_broker, ct.replica_is_leader, ct.replica_offline,
                ct.replica_disk)
c = BalancingConstraint(**case.get("constraint", {}))
goal = make_goal(case["goal"], c)
prev = tuple(make_goal(n, c) for n in case.get("prev", []))
if case.get("scaled"):
    params = dataclasses.replace(
        GoalOptimizer().scaled_params(env.num_replicas, env.num_brokers), **case["params"])
else:
    params = engine.EngineParams(**case["params"])
if case.get("compiled"):
    st2, info = engine._compiled_optimize(type(goal), goal, prev)(env, st, params)
else:
    st2, info = engine.optimize_goal(env, st, goal, prev, params)
out = dict(info={k: np.asarray(v).item() for k, v in info.items()},
           final={n: np.asarray(getattr(st2, n))
                  for n in ("replica_broker", "replica_is_leader", "util")})
with open(case["out"], "wb") as f:
    pickle.dump(out, f)
"""


def swap_tail_cluster(num_brokers: int = 12, per_broker: int = 6):
    """A cluster where only swaps can balance disk: every broker holds
    ``per_broker`` single-replica partitions (so with
    ``max_replicas_per_broker = per_broker`` ReplicaCapacityGoal vetoes
    every move), a third of the brokers hold heavy replicas (disk about
    900), a third medium (500), a third light (100)."""
    from cruise_control_tpu.model.builder import ClusterModelBuilder
    b = ClusterModelBuilder()
    for i in range(num_brokers):
        b.add_broker(i, rack=f"r{i % 4}")
    p = 0
    for i in range(num_brokers):
        disk = (900.0, 500.0, 100.0)[i * 3 // num_brokers]
        for j in range(per_broker):
            b.add_replica(f"t{p % 3}", p, i, is_leader=True,
                          load=[1.0, 10.0, 10.0, disk + j])
            p += 1
    return b.build()


def _child_env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="false",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    # a child is no test worker: the test modules it imports start nothing
    env.pop("PYTEST_XDIST_TESTRUNUID", None)
    return env


def _run_child(code: str, arg: dict, timeout: int) -> None:
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(arg)], cwd=ROOT,
                          env=_child_env(), capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")


def _run_children(jobs: list, timeout: int) -> None:
    """``_run_child`` of every (code, arg) of ``jobs`` at once: the
    interpreters run side by side and all are waited for (each killed at
    ``timeout``)."""
    import tempfile
    procs = []
    try:
        for code, arg in jobs:
            err = tempfile.TemporaryFile()
            procs.append((subprocess.Popen([sys.executable, "-c", code, json.dumps(arg)],
                                           cwd=ROOT, env=_child_env(),
                                           stdout=subprocess.DEVNULL, stderr=err), err))
        for proc, err in procs:
            rc = proc.wait(timeout=timeout)
            if rc != 0:
                err.seek(0)
                raise RuntimeError(f"reference run failed (rc {rc}):\n"
                                   f"{err.read()[-4000:].decode(errors='replace')}")
    finally:
        for proc, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()


def reference_chains(tmp_path: Path, runs: list[dict], timeout: int = 900) -> list:
    out = tmp_path / "reference.pkl"
    _run_child(_CHILD, dict(runs=runs, out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


def reference_chain(tmp_path: Path, spec: dict | str | None, goals: list[str],
                    timeout: int = 900, demoted: list | None = None,
                    dtype: str | None = None, params: dict | None = None) -> dict:
    """``dtype`` pins ``EngineParams.compute_dtype`` ("float32" or
    "bfloat16"; None keeps the reference's "auto"); ``params`` sets other
    ``EngineParams`` fields."""
    return reference_chains(tmp_path, [dict(spec=spec, goals=goals, demoted=demoted,
                                            dtype=dtype, params=params)], timeout)[0]


def reference_matrix_rows(tmp_path: Path, rows: list[int], timeout: int = 1700) -> list:
    """One fresh interpreter per row: a single XLA:CPU process compiling
    the programs of many rows segfaults (as tests/test_java_parity_matrix.py
    notes for the reference's own run)."""
    out = []
    for i in rows:
        path = tmp_path / f"reference_matrix_{i}.pkl"
        _run_child(_MATRIX_CHILD, dict(rows=[i], out=str(path)), timeout)
        with open(path, "rb") as f:
            out.extend(pickle.load(f))
    return out


def reference_goal(tmp_path: Path, case: dict, timeout: int = 900) -> dict:
    out = tmp_path / "reference_goal.pkl"
    _run_child(_GOAL_CHILD, dict(case, out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# BASELINE.json configs 4 and 5 (bench.py rungs 4 and 5): the clusters and
# chains whose reference rows chip_smoke.py's ORACLE holds
RUNGS = {
    "rung4": dict(spec=dict(num_brokers=7000, num_racks=40, num_topics=2000,
                            num_partitions=500000, max_replication=3, skew=1.0,
                            seed=3142, target_cpu_util=0.45),
                  goals=None),
    "rung5": dict(spec=dict(num_brokers=7000, num_racks=40, num_topics=2000,
                            num_partitions=500000, max_replication=3, skew=1.0,
                            seed=3143, logdirs_per_broker=4, num_dead_brokers=20,
                            num_brokers_with_dead_disk=50, target_cpu_util=0.45),
                  goals=["RackAwareGoal", "MinTopicLeadersPerBrokerGoal",
                         "ReplicaCapacityGoal", "DiskCapacityGoal",
                         "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
                         "CpuCapacityGoal", "ReplicaDistributionGoal",
                         "IntraBrokerDiskCapacityGoal",
                         "IntraBrokerDiskUsageDistributionGoal"]),
}


def oracle_row(ref: dict) -> dict:
    """A reference chain's outcome in the form of chip_smoke.py's ORACLE
    rows, with the digests of its final float32 tallies."""
    import hashlib
    c, f = ref["counts"], ref["finisher"]
    return dict(before=sorted(c["before"]), after=sorted(c["after"]),
                actions=c["actions"], passes=c["passes"], moves=c["moves"],
                leads=c["leads"], proven=f["proven"], rounds=f["rounds"],
                swaps=ref["swaps"], swleft=f["swleft"], disk=ref["disk"],
                proposals=len(ref["proposals"]),
                digests={n: hashlib.sha256(ref["final"][n].tobytes()).hexdigest()[:16]
                         for n in ("disk_util", "util", "leader_util",
                                   "potential_nw_out")})


def reference_session_ns() -> dict:
    """The reference's classes for ``session_script``
    (``cruise_control_tpu_torch/analyzer/session_script.py``)."""
    from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu.analyzer.session import ResidentClusterSession
    from cruise_control_tpu.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu.config import cruise_control_config
    from cruise_control_tpu.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu.monitor.sampling.samplers import SimulatedMetricSampler
    return dict(GoalOptimizer=GoalOptimizer,
                ResidentClusterSession=ResidentClusterSession,
                SimulatedClusterBackend=SimulatedClusterBackend,
                cruise_control_config=cruise_control_config,
                LoadMonitor=LoadMonitor, SimulatedMetricSampler=SimulatedMetricSampler)


_SESSION_CHILD = r"""
import json, pickle, sys
from cruise_control_tpu_torch.analyzer.session_script import session_script
from torch_reference import reference_session_ns
args = json.loads(sys.argv[1])
ns = reference_session_ns()
out = [session_script(ns, args["spec"], seed_dirty=sd) for sd in args["seed_dirty"]]
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_session(tmp_path: Path, spec: dict, seed_dirty=(False,),
                      timeout: int = 900) -> list:
    """The reference's rows of ``session_script`` for each ``seed_dirty``
    value, in one fresh interpreter."""
    out = tmp_path / "reference_session.pkl"
    _run_child(_SESSION_CHILD, dict(spec=spec, seed_dirty=list(seed_dirty),
                                    out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Session cases (tests/test_session.py's scripts, either package)
# ---------------------------------------------------------------------------
def session_test_backend(ns, seed=0, num_brokers=10, num_partitions=60, rf=2,
                         jbod=True):
    """tests/test_session.py ``_backend``: JBOD brokers (1-3 logdirs)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    be = ns["SimulatedClusterBackend"]()
    for b in range(num_brokers):
        logdirs = ({f"/d{j}": 50_000.0 for j in range(1 + b % 3)} if jbod else None)
        be.add_broker(b, f"r{b % 3}", logdirs=logdirs)
    for p in range(num_partitions):
        reps = [int(x) for x in rng.choice(num_brokers, size=rf, replace=False)]
        be.create_partition(f"t{p % 6}", p, reps,
                            size_mb=float(rng.uniform(10, 500)),
                            bytes_in_rate=float(rng.uniform(1, 50)),
                            bytes_out_rate=float(rng.uniform(1, 100)),
                            cpu_util=float(rng.uniform(0.1, 5)))
    return be


def monitored(ns, be, rounds=6, start_round=0, config=None):
    lm = ns["LoadMonitor"](config=config, backend=be,
                           sampler=ns["SimulatedMetricSampler"](be))
    lm.start_up()
    for i in range(start_round, start_round + rounds):
        lm.sample_once(now_ms=i * 300_000.0)
    return lm


def scripted_delta_stream(be, lm):
    """tests/test_session.py ``_scripted_delta_stream``: a leadership flip,
    same-RF replica churn, a broker death, a disk failure, an appended
    (sorts-last) topic and fresh metric windows."""
    info = be.partitions()[("t1", 1)]
    be.elect_leaders({("t1", 1): info.replicas[-1]})
    be.alter_partition_reassignments({("t0", 0): [7, 8]})
    be.advance(10 * 60_000.0)
    be.kill_broker(9)
    be.fail_disk(1, "/d1")
    be.create_partition("zz-late", 0, [0, 2], size_mb=100.0,
                        bytes_in_rate=10.0, bytes_out_rate=20.0, cpu_util=1.0)
    be.create_partition("zz-late", 1, [3, 4], size_mb=50.0,
                        bytes_in_rate=5.0, bytes_out_rate=10.0, cpu_util=0.5)
    for i in range(6, 9):
        lm.sample_once(now_ms=i * 300_000.0)


def _np(x):
    import numpy as np
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _fields(obj) -> dict:
    """{field: numpy array} of a dataclass of arrays (either package); int
    fields (an env's static sizes) as ints."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if hasattr(v, "shape") and tuple(v.shape) == () and _np(v).dtype.kind in "iu":
            out[f.name] = int(_np(v))
        elif hasattr(v, "shape"):
            out[f.name] = _np(v)
        elif isinstance(v, int):
            out[f.name] = int(v)
    return out


def session_snapshot(sess) -> dict:
    """A session's resident env and state leaves, host mirrors and names,
    as numpy arrays and lists."""
    import numpy as np
    return dict(env=_fields(sess.env), state=_fields(sess.state),
                part_table=np.asarray(sess.part_table),
                mirrors={k: np.asarray(v).copy() for k, v in sess._h.items()},
                lead_packed=np.packbits(sess._h["replica_is_leader"]),
                meta=dict(topic_names=list(sess.meta.topic_names),
                          partition_ids=[tuple(p) for p in sess.meta.partition_ids],
                          broker_ids=list(sess.meta.broker_ids),
                          num_valid_replicas=int(sess.meta.num_valid_replicas)))


def session_case(ns, name: str) -> dict:
    """One of tests/test_session.py's scripts through the classes in ``ns``:

    - ``delta``: rebuild, the scripted delta stream, a metric-only round;
      the session's snapshot after each sync;
    - ``fallback``: a broker-set change, an RF change and a zero churn
      budget, each of which must rebuild; then a metric-only delta; the
      sync modes and reasons."""
    kw = ns.get("kw", {})
    if name == "delta":
        be = session_test_backend(ns)
        lm = monitored(ns, be)
        sess = ns["ResidentClusterSession"](lm, **kw)
        out = [(sess.sync()["mode"], session_snapshot(sess))]
        scripted_delta_stream(be, lm)
        info = sess.sync()
        out.append((info["mode"], session_snapshot(sess)))
        lm.sample_once(now_ms=9 * 300_000.0)
        out.append((sess.sync()["mode"], session_snapshot(sess)))
        return dict(syncs=out, churn=info["churn"], epoch=sess.epoch)
    if name == "fallback":
        be = session_test_backend(ns, seed=2)
        lm = monitored(ns, be)
        sess = ns["ResidentClusterSession"](lm, **kw)
        infos = [sess.sync()]
        be.add_broker(99, "r0")
        lm.sample_once(now_ms=6 * 300_000.0)
        infos.append(sess.sync())
        be.alter_partition_reassignments({("t0", 0): [0, 1, 2]})
        be.advance(10 * 60_000.0)
        lm.sample_once(now_ms=7 * 300_000.0)
        infos.append(sess.sync())
        tight = ns["ResidentClusterSession"](lm, config=ns["cruise_control_config"](
            {"analyzer.session.max.delta.fraction": 0.0}), **kw)
        tight.sync()
        be.elect_leaders({("t1", 1): be.partitions()[("t1", 1)].replicas[-1]})
        lm.sample_once(now_ms=8 * 300_000.0)
        infos.append(tight.sync())
        lm.sample_once(now_ms=9 * 300_000.0)
        infos.append(sess.sync())
        return dict(syncs=[(i["mode"], i.get("reason")) for i in infos],
                    epoch=sess.epoch, snapshot=session_snapshot(sess))
    raise ValueError(name)


_SESSION_CASE_CHILD = r"""
import json, pickle, sys
from torch_reference import reference_session_ns, session_case
args = json.loads(sys.argv[1])
out = session_case(reference_session_ns(), args["name"])
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_session_case(tmp_path: Path, name: str, timeout: int = 600) -> dict:
    """``session_case`` through the reference, in a fresh interpreter."""
    out = tmp_path / f"reference_session_{name}.pkl"
    _run_child(_SESSION_CASE_CHILD, dict(name=name, out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Incremental cases (tests/test_incremental.py's scripts, either package)
# ---------------------------------------------------------------------------
INCREMENTAL_GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal",
                     "LeaderReplicaDistributionGoal"]
INCREMENTAL_CASES = ("zero_churn", "forced_rerun", "churn", "epoch", "shadow",
                     "chain_change", "revalidate_off", "seeded", "dirty_mask", "spill")


def incremental_case(ns, name: str) -> dict:
    """One of tests/test_incremental.py's scripts (cases 1-3 and 5-8, the
    one-sided seeding case, the dirty-mask case and the carryover across a
    fleet spill and readmit) through the classes in
    ``ns``. Returns the rows of its rounds (``session_script.round_row``)
    and the session counters the reference's test asserts on."""
    from cruise_control_tpu_torch.analyzer.session_script import round_row
    kw = ns.get("kw", {})
    seeds = dict(zero_churn=0, forced_rerun=5, churn=1, epoch=3, shadow=4,
                 chain_change=6, revalidate_off=7, seeded=8, dirty_mask=10, spill=2)
    goals = INCREMENTAL_GOALS

    def optimizer(extra=None):
        cfg = {"goals": ",".join(goals), "hard.goals": "ReplicaCapacityGoal"}
        cfg.update(extra or {})
        return ns["GoalOptimizer"](config=ns["cruise_control_config"](cfg), **kw)

    def setup(extra=None):
        be = session_test_backend(ns, seed=seeds[name], jbod=False)
        lm = monitored(ns, be)
        return be, lm, ns["ResidentClusterSession"](lm, **kw), optimizer(extra)

    rows = []

    def rnd(opt, sess, info=None, goal_names=goals):
        res = opt.optimizations(None, session=sess, goal_names=goal_names,
                                raise_on_failure=False, skip_hard_goal_check=True)
        rows.append(round_row(info or {"mode": "none"}, res))
        return res

    def steady(opt, sess, lm, t):
        lm.sample_once(now_ms=t * 300_000.0)
        return rnd(opt, sess, sess.sync())

    out = {}
    if name == "seeded":
        for extra in ({}, {"analyzer.incremental.seed.dirty": True}):
            be, lm, sess, opt = setup(extra)
            rnd(opt, sess, sess.sync())
            info = be.partitions()[("t2", 2)]
            be.elect_leaders({("t2", 2): info.replicas[-1]})
            steady(opt, sess, lm, 6)
        return dict(rows=rows)
    if name == "dirty_mask":
        be, lm, sess, _ = setup()
        sess.sync()
        return dict(brokers=sess.dirty_replica_mask({0}, set()),
                    topics=sess.dirty_replica_mask(set(), {0}),
                    both=sess.dirty_replica_mask({1, 3}, {2}),
                    none=sess.dirty_replica_mask(set(), set()))
    be, lm, sess, opt = setup({"analyzer.incremental.revalidate": False}
                              if name == "revalidate_off" else None)
    rnd(opt, sess, sess.sync())
    steady(opt, sess, lm, 6)
    if name == "zero_churn":
        donated = sess.donated_rounds
        steady(opt, sess, lm, 7)
        out["donated_in_memo"] = sess.donated_rounds - donated
        steady(opt, sess, lm, 8)
    elif name == "forced_rerun":
        rnd(opt, sess)
    elif name == "churn":
        info = be.partitions()[("t1", 1)]
        be.elect_leaders({("t1", 1): info.replicas[-1]})
        steady(opt, sess, lm, 7)
        steady(opt, sess, lm, 8)
    elif name == "epoch":
        steady(opt, sess, lm, 7)
        be.add_broker(99, "r0")
        lm.sample_once(now_ms=8 * 300_000.0)
        out["sync"] = sess.sync()["mode"]
        out["carryover_cleared"] = sess.carryover is None
        rnd(opt, sess)
    elif name == "shadow":
        sess.note_carryover(sess.carryover, taken_generation=sess.sync_generation - 1)
        steady(opt, sess, lm, 7)
        steady(opt, sess, lm, 8)
    elif name == "chain_change":
        lm.sample_once(now_ms=7 * 300_000.0)
        rnd(opt, sess, sess.sync(), goal_names=goals[:2])
    elif name == "revalidate_off":
        steady(opt, sess, lm, 7)
    elif name == "spill":
        steady(opt, sess, lm, 7)
        out["spilled"] = sess.spill()
        out["carryover_kept"] = sess.carryover is not None
        steady(opt, sess, lm, 8)          # the sync readmits, then the memo
        out["readmitted"] = sess.readmits >= 1
    out.update(rows=rows, revalidated_rounds=sess.revalidated_rounds)
    return out


_INCREMENTAL_CHILD = r"""
import json, pickle, sys
from torch_reference import incremental_case, reference_session_ns
args = json.loads(sys.argv[1])
ns = reference_session_ns()
out = {name: incremental_case(ns, name) for name in args["names"]}
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_incremental_cases(tmp_path: Path, names=INCREMENTAL_CASES,
                                timeout: int = 900) -> dict:
    """``incremental_case`` for each name through the reference, in one
    fresh interpreter."""
    out = tmp_path / "reference_incremental.pkl"
    _run_child(_INCREMENTAL_CHILD, dict(names=list(names), out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Pass-gating cases (tests/test_pass_gating.py's solo scripts, either package)
# ---------------------------------------------------------------------------
GATING_CONFIGS = {
    "mono": {"analyzer.pass.chunk": 0},
    "oversized": {"analyzer.pass.chunk.min.replicas": 0, "analyzer.pass.chunk": 64},
    "skip": {"max.replicas.per.broker": 5, "analyzer.finisher.min.replicas": 0,
             "analyzer.pass.chunk.min.replicas": 0},
    "noskip": {"max.replicas.per.broker": 5, "analyzer.finisher.min.replicas": 0,
               "analyzer.pass.chunk.min.replicas": 0,
               "analyzer.pass.certificate.skip": False},
}


def gating_case(ns, name: str) -> list:
    """tests/test_pass_gating.py ``_run_two_rounds`` under one of
    ``GATING_CONFIGS``: a full round, then a one-leadership-flip churn round
    (dirty seeding on), on the seed-8 fixture. Returns the two rounds' rows
    with the gating counters per goal."""
    from cruise_control_tpu_torch.analyzer.session_script import round_row
    kw = ns.get("kw", {})
    goals = INCREMENTAL_GOALS
    be = session_test_backend(ns, seed=8, jbod=False)
    lm = monitored(ns, be)
    cfg = {"goals": ",".join(goals), "hard.goals": "ReplicaCapacityGoal",
           "analyzer.incremental.seed.dirty": True}
    cfg.update(GATING_CONFIGS[name])
    sess = ns["ResidentClusterSession"](lm, **kw)
    opt = ns["GoalOptimizer"](config=ns["cruise_control_config"](cfg), **kw)
    rows = []
    for flip in (False, True):
        if flip:
            info = be.partitions()[("t2", 2)]
            be.elect_leaders({("t2", 2): info.replicas[-1]})
            lm.sample_once(now_ms=6 * 300_000.0)
        sync = sess.sync()
        res = opt.optimizations(None, session=sess, goal_names=goals,
                                raise_on_failure=False, skip_hard_goal_check=True)
        row = round_row(sync, res)
        g = res.goal_results
        row.update(
            finisher_skipped=[r.finisher_skipped for r in g],
            quiesce_chunk=[r.quiesce_chunk for r in g],
            passes_skipped=[r.passes_skipped for r in g],
            remaining=[(r.moves_remaining, r.leads_remaining, r.swap_window_remaining)
                       for r in g],
            early_exit_goals=res.early_exit_goals,
            passes_dispatched=res.passes_dispatched)
        rows.append(row)
    return rows


_GATING_CHILD = r"""
import json, pickle, sys
from torch_reference import gating_case, reference_session_ns
args = json.loads(sys.argv[1])
ns = reference_session_ns()
out = {name: gating_case(ns, name) for name in args["names"]}
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_gating_cases(tmp_path: Path, names=tuple(GATING_CONFIGS),
                           timeout: int = 900) -> dict:
    out = tmp_path / "reference_gating.pkl"
    _run_child(_GATING_CHILD, dict(names=list(names), out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The self-healing service (the facade, the detectors, the forecaster)
# ---------------------------------------------------------------------------
def reference_heal_ns() -> dict:
    """The reference's classes for ``heal_script``
    (``cruise_control_tpu_torch/analyzer/heal_script.py``) and the facade
    cases below."""
    from cruise_control_tpu.app import CruiseControl
    from cruise_control_tpu.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu.config import cruise_control_config
    return dict(CruiseControl=CruiseControl,
                SimulatedClusterBackend=SimulatedClusterBackend,
                cruise_control_config=cruise_control_config)


def facade_backend(ns, n_brokers=4, rf=2, n_parts=8):
    """tests/test_detector.py ``_backend``."""
    be = ns["SimulatedClusterBackend"]()
    for b in range(n_brokers):
        be.add_broker(b, f"r{b % 2}")
    for p in range(n_parts):
        replicas = [(p + i) % n_brokers for i in range(rf)]
        be.create_partition("t", p, replicas, size_mb=100.0, bytes_in_rate=50.0,
                            bytes_out_rate=100.0, cpu_util=2.0)
    return be


def facade(ns, be, extra_config=None):
    """tests/test_detector.py ``_cc``: a started facade with 20 sampled
    windows."""
    props = {"self.healing.enabled": True,
             "broker.failure.alert.threshold.ms": 100,
             "broker.failure.self.healing.threshold.ms": 200,
             "self.healing.target.topic.replication.factor": 2}
    props.update(extra_config or {})
    cc = ns["CruiseControl"](be, ns["cruise_control_config"](props), **ns.get("kw", {}))
    cc.start_up()
    for i in range(20):
        cc.load_monitor.sample_once(now_ms=i * 60_000.0)
    return cc


def _handled_rows(entries) -> list:
    return [(h["anomaly"]["type"], h["action"], "fixResult" in h, h.get("fixError"))
            for h in entries]


def _assignment(be) -> list:
    return [(tp, list(p.replicas), p.leader) for tp, p in sorted(be.partitions().items())]


FACADE_CASES = ("broker_failure", "deferred_check", "goal_violation", "maintenance",
                "admin")


def facade_case(ns, name: str, tmp: str) -> dict:
    """One of tests/test_detector.py's facade cases (and the lend protocol
    across a FIX), through either package's ``CruiseControl``; plain values."""
    import os
    if name in ("broker_failure", "deferred_check"):
        be = facade_backend(ns)
        cc = facade(ns, be)
        dead = 3 if name == "broker_failure" else 2
        be.kill_broker(dead)
        ad = cc.anomaly_detector
        t = be.now_ms() + 1000
        n = ad.run_detection_round(now_ms=t)
        h1 = ad.handle_anomalies(now_ms=t)
        queued, deferred = ad.num_queued(), len(ad._deferred)
        early = ad.handle_anomalies(now_ms=t + 50) if name == "deferred_check" else []
        h2 = ad.handle_anomalies(now_ms=t + 10_000)
        st = ad.state_json()
        return dict(n=n, h1=_handled_rows(h1), queued=queued, deferred=deferred,
                    early=_handled_rows(early), h2=_handled_rows(h2),
                    deferred_after=len(ad._deferred),
                    actions=st["numSelfHealingActions"],
                    evacuated=all(dead not in p.replicas
                                  for p in be.partitions().values()),
                    assignment=_assignment(be),
                    census=cc.executor.state_json().get("numTasksByState"))
    if name == "goal_violation":
        be = ns["SimulatedClusterBackend"]()
        for b in range(3):
            be.add_broker(b, f"r{b}")
        for p in range(6):
            be.create_partition("t", p, [0], size_mb=50_000.0, bytes_in_rate=100.0,
                                bytes_out_rate=100.0, cpu_util=5.0)
        cc = facade(ns, be, {"anomaly.detection.goals":
                             "DiskCapacityGoal,ReplicaDistributionGoal"})
        found = cc.goal_violation_detector.run_once(0.0)
        return dict(types=[a.anomaly_type.name for a in found],
                    fixable=[list(a.violated_goals_fixable) for a in found],
                    unfixable=[list(a.violated_goals_unfixable) for a in found],
                    balancedness=float(cc.goal_violation_detector.last_balancedness))
    if name == "maintenance":
        import json
        be = facade_backend(ns)
        with open(os.path.join(tmp, "maintenance_events.jsonl"), "w") as f:
            f.write(json.dumps({"type": "REBALANCE"}) + "\n")
        cc = facade(ns, be, {"maintenance.event.path": tmp,
                             "maintenance.event.self.healing.enabled": True})
        n = cc.anomaly_detector.run_detection_round(now_ms=1e9)
        h = cc.anomaly_detector.handle_anomalies(now_ms=1e9)
        return dict(n=n, handled=_handled_rows(h), assignment=_assignment(be),
                    census=cc.executor.state_json().get("numTasksByState"))
    if name == "lend":
        # a FIX round on the resident session (a dead disk: fix offline
        # replicas): the final_state the session carries from the detection
        # round before it is left as it was (the lend protocol)
        be = facade_backend(ns, n_brokers=6, n_parts=12)
        cc = facade(ns, be)
        sess = cc.resident_session
        be.fail_disk(5, "/logdir0")
        ad = cc.anomaly_detector
        t = be.now_ms() + 1000
        n = ad.run_detection_round(now_ms=t)
        carried = sess.carryover.result.final_state
        before = {k: _np(getattr(carried, k)).copy()
                  for k in ("replica_broker", "replica_is_leader", "util")}
        h = ad.handle_anomalies(now_ms=t)
        after = {k: _np(getattr(carried, k)) for k in before}
        return dict(n=n, handled=_handled_rows(h), rounds=sess.delta_rounds
                    + sess.rebuild_rounds,
                    unchanged={k: bool((before[k] == after[k]).all()) for k in before},
                    digests={k: hashlib_digest(before[k]) for k in before},
                    assignment=_assignment(be))
    if name == "admin":
        # the facade's admin and state surface on a quiet cluster
        be = facade_backend(ns)
        cc = facade(ns, be)
        out = dict(pause=cc.pause_sampling("maintenance window"),
                   resume=cc.resume_sampling("done"),
                   stop=cc.stop_proposal_execution(),
                   admin=cc.admin(disable_self_healing_for=["broker_failure"],
                                  enable_self_healing_for=["disk_failure"],
                                  concurrent_leader_movements=123,
                                  drop_recently_removed_brokers=[1]))
        try:
            cc.admin(disable_self_healing_for=["no_such_type"])
            out["bad_admin"] = None
        except ValueError as e:
            out["bad_admin"] = str(e)
        st = cc.state_json(["MONITOR", "EXECUTOR", "ANALYZER", "ANOMALY_DETECTOR",
                            "FORECAST", "SENSORS"])
        out["state_keys"] = sorted(st)
        out["analyzer"] = {k: v for k, v in st["AnalyzerState"].items()
                           if k != "residentSession"}
        ad_state = st["AnomalyDetectorState"]
        out["detector"] = dict(enabled=ad_state["selfHealingEnabled"],
                               detectors=ad_state["registeredDetectors"],
                               intervals=ad_state["detectionIntervalsMs"])
        out["executor_state"] = st["ExecutorState"]["state"]
        out["forecast"] = st["ForecastState"]
        out["monitor_state"] = st["MonitorState"].get("state")
        health = cc.health_json()
        out["health"] = dict(status=health["status"], role=health["role"],
                             degraded=health["degraded"],
                             breached=health["slo"]["breached"])
        out["sensors"] = sorted(n for n in st["Sensors"] if not n.startswith("xla-"))
        out["metrics_lines"] = sorted(
            line.split("{")[0].split(" ")[0] for line in cc.metrics_text().splitlines()
            if line and not line.startswith("#") and "xla_compile" not in line)
        out["spec"] = cc.speculative_state_json()
        cc.shutdown()
        return out
    raise ValueError(name)


def hashlib_digest(a) -> str:
    import hashlib
    import numpy as np
    a = np.asarray(a)
    a = a.astype(np.float32 if a.dtype.kind == "f" else np.int64)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


_FACADE_CHILD = r"""
import json, os, pickle, sys
from cruise_control_tpu_torch.analyzer.heal_script import heal_script
from torch_reference import facade_case, reference_heal_ns
args = json.loads(sys.argv[1])
tmp = args.get("tmp") or args["out"] + ".d"
os.makedirs(tmp, exist_ok=True)
ns = reference_heal_ns()
out = {"heal": [heal_script(ns, spec) for spec in args["heal"]]}
out.update({name: facade_case(ns, name, tmp) for name in args["cases"]})
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_facade(tmp_path: Path, cases=FACADE_CASES, heal=(),
                     timeout: int = 900) -> dict:
    """The reference's ``facade_case`` results for ``cases`` and its
    ``heal_script`` rows for each spec of ``heal`` (under ``"heal"``), all
    in ONE fresh interpreter: the reference's facade compiles its goal
    chains there, never inside a test worker. (``facade_case("lend")`` is
    the port's check alone; any case runs here.)"""
    out = tmp_path / "reference_facade.pkl"
    case_dir = tmp_path / "reference_facade"
    case_dir.mkdir(exist_ok=True)
    _run_child(_FACADE_CHILD, dict(cases=list(cases), heal=list(heal),
                                   tmp=str(case_dir), out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Reference runs of the host-side cases (executor, detectors, forecaster)
# ---------------------------------------------------------------------------
_CASES_CHILD = r"""
import importlib, json, pickle, sys
from pathlib import Path
args = json.loads(sys.argv[1])
mod = importlib.import_module(args["module"])
out = getattr(mod, args["function"])(*args.get("args", []))
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def shared_reference(tmp_path_factory, name: str, compute):
    """``compute(tmp_dir)``, pickled under ``name`` and computed once per test
    session: under ``pytest-xdist`` every worker reads the first worker's
    result (a file lock in the directory the workers share), so a module's
    reference interpreter runs once however its tests are spread."""
    import fcntl
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                tmp = base / f"{name}.d"
                tmp.mkdir(exist_ok=True)
                out = compute(tmp)
                with open(path.with_suffix(".part"), "wb") as f:
                    pickle.dump(out, f)
                os.replace(path.with_suffix(".part"), path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(path, "rb") as f:
        return pickle.load(f)


def _background_dir() -> Path | None:
    """The directory the xdist workers of this test session share for the
    background reference runs (None outside xdist)."""
    import tempfile
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    return Path(tempfile.gettempdir()) / f"cc_torch_reference_{uid}" if uid else None


def start_background_reference(name: str, jobs: dict) -> None:
    """Under ``pytest-xdist``, start ``jobs`` ({part: (child code, arg)}),
    one fresh interpreter each, in the background, once per test session:
    the first worker to import the test module starts them, so they run
    while the suite's earlier tests do and no worker waits for them later.
    They run at nice 10: the test workers and the processes their tests
    start (a sidecar that must answer within seconds) keep the cores.
    Outside xdist it starts nothing (``background_reference`` computes)."""
    import fcntl
    d = _background_dir()
    if d is None:
        return
    d.mkdir(exist_ok=True)
    with open(d / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (d / f"{name}.started").exists():
            return
        for part, (code, arg) in jobs.items():
            stem = d / f"{name}_{part}"
            with open(f"{stem}.err", "w") as err:
                # the rc file tells the waiting workers a child ended
                subprocess.Popen(["sh", "-c", '"$0" -c "$1" "$2"; echo $? > "$3"',
                                  sys.executable, code,
                                  json.dumps(dict(arg, out=f"{stem}.pkl")), f"{stem}.rc"],
                                 cwd=ROOT, env=_child_env(), stdout=subprocess.DEVNULL,
                                 stderr=err, start_new_session=True,
                                 preexec_fn=lambda: os.nice(10))
        (d / f"{name}.started").touch()


def background_reference(tmp_path_factory, name: str, jobs: dict,
                         timeout: int = 900) -> dict:
    """{part: result} of ``jobs``: waited for when
    ``start_background_reference`` started them, else computed now (every
    job in its own interpreter, side by side) once per test session."""
    import time
    d = _background_dir()
    if d is None or not (d / f"{name}.started").exists():
        def compute(tmp):
            outs = {part: tmp / f"{name}_{part}.pkl" for part in jobs}
            _run_children([(code, dict(arg, out=str(outs[part])))
                           for part, (code, arg) in jobs.items()], timeout)
            return {part: pickle.loads(out.read_bytes()) for part, out in outs.items()}
        return shared_reference(tmp_path_factory, name, compute)
    res = {}
    t_end = time.monotonic() + timeout
    for part in jobs:
        stem = d / f"{name}_{part}"
        rc_file = Path(f"{stem}.rc")
        while not rc_file.exists() or not rc_file.read_text().strip():
            if time.monotonic() > t_end:
                raise RuntimeError(f"reference run {name} {part}: no result in {timeout} s")
            time.sleep(0.5)
        rc = int(rc_file.read_text())
        if rc != 0:
            raise RuntimeError(f"reference run failed (rc {rc}):\n"
                               f"{Path(f'{stem}.err').read_text()[-4000:]}")
        res[part] = pickle.loads(Path(f"{stem}.pkl").read_bytes())
    return res


def reference_cases(tmp_path: Path, module: str, function: str, *args,
                    timeout: int = 600):
    """``tests/<module>.py``'s ``function(*args)`` run in a fresh interpreter
    (the reference's side of a test module's cases, so the test worker
    imports and compiles nothing of JAX); its pickled result."""
    out = tmp_path / f"reference_{module}_{function}.pkl"
    _run_child(_CASES_CHILD, dict(module=module, function=function,
                                  args=list(args), out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


def cases_job(module: str, function: str, *args) -> tuple:
    """A job of ``start_background_reference`` / ``background_reference``:
    ``tests/<module>.py``'s ``function(*args)`` in a fresh interpreter."""
    return _CASES_CHILD, dict(module=module, function=function, args=list(args))


def chains_job(runs: list) -> tuple:
    """A job of ``start_background_reference`` / ``background_reference``:
    ``reference_chains``' runs in one fresh interpreter."""
    return _CHILD, dict(runs=runs)


def facade_job(cases=FACADE_CASES, heal=()) -> tuple:
    """A job of ``start_background_reference`` / ``background_reference``:
    ``reference_facade``'s cases and heal scripts in one fresh interpreter."""
    return _FACADE_CHILD, dict(cases=list(cases), heal=list(heal))


def fleet_job(cases: tuple, spec: dict | None = None) -> tuple:
    """A job of ``start_background_reference`` / ``background_reference``:
    ``reference_fleet_cases``' cases in one fresh interpreter."""
    return _FLEET_CHILD, dict(cases=list(cases), spec=spec)


def one_torch_thread():
    """The body of a test module's autouse module fixture
    (``pytest.fixture(autouse=True, scope="module")(one_torch_thread)``):
    the module's port runs on one torch intra-op thread per test worker
    (under xdist the pool's idle threads spin against the other workers'),
    restored after the module."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Fleet mode (cruise_control_tpu_torch/fleet_script.py, either package)
# ---------------------------------------------------------------------------
def reference_fleet_ns() -> dict:
    """The reference's classes for ``fleet_script``."""
    from cruise_control_tpu.app import CruiseControl
    from cruise_control_tpu.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu.config import cruise_control_config
    from cruise_control_tpu.fleet import FleetScheduler
    from cruise_control_tpu.pipeline import LANE_HEAL, LANE_REBALANCE, LANE_REFRESH
    return dict(CruiseControl=CruiseControl, SimulatedClusterBackend=SimulatedClusterBackend,
                cruise_control_config=cruise_control_config, FleetScheduler=FleetScheduler,
                LANE_HEAL=LANE_HEAL, LANE_REBALANCE=LANE_REBALANCE,
                LANE_REFRESH=LANE_REFRESH)


_FLEET_CHILD = r"""
import json, pickle, sys
from cruise_control_tpu_torch import fleet_script
from torch_reference import reference_fleet_ns
args = json.loads(sys.argv[1])
ns = reference_fleet_ns()
out = {}
for name in args["cases"]:
    if name == "fleet_e2e":
        run = fleet_script.fleet_e2e(ns, args["spec"])
        run.pop("fleet").shutdown()
        out[name] = run
    else:
        out[name] = getattr(fleet_script, name)(ns)
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_fleet_cases(tmp_path: Path, cases: tuple, spec: dict | None = None,
                          timeout: int = 900) -> dict:
    """The reference's results of ``fleet_script``'s functions named in
    ``cases`` ("fleet_cases", "gating_cases", "serving_cases", "fleet_e2e"
    with ``spec``), all in ONE fresh interpreter: its vmapped fleet
    programs compile there, never inside a test worker."""
    out = tmp_path / "reference_fleet.pkl"
    _run_child(_FLEET_CHILD, dict(cases=list(cases), spec=spec, out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# The service's front door (cruise_control_tpu_torch/service_script.py)
# ---------------------------------------------------------------------------
def reference_service_ns() -> dict:
    """The reference's classes for ``service_script``."""
    from cruise_control_tpu import main
    from cruise_control_tpu.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu.client.client import CruiseControlClient
    from cruise_control_tpu.config import cruise_control_config
    from cruise_control_tpu.pipeline import PipelinedServiceLoop
    return dict(main=main, cruise_control_config=cruise_control_config,
                PipelinedServiceLoop=PipelinedServiceLoop,
                CruiseControlClient=CruiseControlClient,
                SimulatedClusterBackend=SimulatedClusterBackend)


_SERVICE_CHILD = r"""
import json, pickle, sys
from cruise_control_tpu_torch import service_script
from torch_reference import reference_service_ns
args = json.loads(sys.argv[1])
ns = reference_service_ns()
out = {}
if args["service"] is not None:
    out["service"] = service_script.service_e2e(ns, args["service"])
if args["fleet"] is not None:
    out["fleet"] = service_script.fleet_service_e2e(ns, args["fleet"])
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def service_job(service: dict | None, fleet: dict | None) -> tuple:
    """A job of ``start_background_reference`` / ``background_reference``:
    ``reference_service``'s rows in one fresh interpreter."""
    return _SERVICE_CHILD, dict(service=service, fleet=fleet)


def reference_service(tmp_path: Path, service: dict | None, fleet: dict | None,
                      timeout: int = 900) -> dict:
    """The reference's rows of ``service_script.service_e2e`` over
    ``service`` and ``fleet_service_e2e`` over ``fleet`` (either None to
    skip), in ONE fresh interpreter: {"service": rows, "fleet": rows}."""
    out = tmp_path / "reference_service.pkl"
    _run_child(_SERVICE_CHILD, dict(service=service, fleet=fleet, out=str(out)), timeout)
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    # python tests/torch_reference.py rung4 [float32|bfloat16]: the JAX
    # reference's outcome row of a rung (default "auto"), as JSON
    import tempfile
    name = sys.argv[1]
    if name == "options":
        # python tests/torch_reference.py options: the reference's rows of
        # chip_smoke.py phase 10 (slice-1000b's sixteen goals with
        # compact_keying and with chain_cache=False; the NoLeaderBudgetGoal
        # chain on spec-32b), one interpreter each
        sys.path.insert(0, str(ROOT))
        from chip_smoke import DEFAULT, NOLB_CHAIN, SLICE_SPEC, SMALL_SPEC
        runs = {"default_slice_compact": dict(spec=SLICE_SPEC, goals=DEFAULT,
                                              params=dict(compact_keying=True)),
                "default_slice_nocache": dict(spec=SLICE_SPEC, goals=DEFAULT,
                                              params=dict(chain_cache=False)),
                "nolb_small": dict(spec=SMALL_SPEC, goals=NOLB_CHAIN)}
        for tag, run in runs.items():
            with tempfile.TemporaryDirectory() as tmp:
                ref = reference_chains(Path(tmp), [run], timeout=7200)[0]
            print(json.dumps(dict(row=tag, **oracle_row(ref))))
        sys.exit(0)
    if name == "fleet-e2e":
        # python tests/torch_reference.py fleet-e2e: the reference's rows of
        # the fleet-16x100b cell's two rounds (chip_smoke.py phase 8)
        with tempfile.TemporaryDirectory() as tmp:
            sys.path.insert(0, str(ROOT))
            from cruise_control_tpu_torch.fleet_script import FLEET_E2E
            run = reference_fleet_cases(Path(tmp), ("fleet_e2e",), spec=FLEET_E2E,
                                        timeout=7200)["fleet_e2e"]
        print(json.dumps(dict(cell="fleet-16x100b", rounds=run["rounds"],
                              reports=run["reports"])))
        sys.exit(0)
    if name == "heal-e2e":
        # python tests/torch_reference.py heal-e2e: the reference's rows of
        # the self-healing script at e2e-1000b-50000p (chip_smoke.py phase 7)
        with tempfile.TemporaryDirectory() as tmp:
            sys.path.insert(0, str(ROOT))
            from cruise_control_tpu_torch.analyzer.heal_script import HEAL_E2E
            rows = reference_facade(Path(tmp), cases=(), heal=(HEAL_E2E,),
                                    timeout=7200)["heal"][0]
        print(json.dumps(dict(cell="e2e-1000b-50000p", heal=rows)))
        sys.exit(0)
    if name == "service-e2e":
        # python tests/torch_reference.py service-e2e [service|fleet]: the
        # reference's rows of the front door at e2e-1000b-50000p and
        # fleet-16x100b (chip_smoke.py phase 9), or of one of the two
        part = sys.argv[2] if len(sys.argv) > 2 else None
        with tempfile.TemporaryDirectory() as tmp:
            sys.path.insert(0, str(ROOT))
            from cruise_control_tpu_torch.service_script import (
                FLEET_SERVICE_E2E, SERVICE_E2E,
            )
            rows = reference_service(Path(tmp),
                                     SERVICE_E2E if part != "fleet" else None,
                                     FLEET_SERVICE_E2E if part != "service" else None,
                                     timeout=7200)
        print(json.dumps(dict(cell="e2e-1000b-50000p, fleet-16x100b", **rows)))
        sys.exit(0)
    if name == "session-e2e":
        # python tests/torch_reference.py session-e2e: the reference's rows of
        # the e2e-1000b-50000p cell, the plain script then the dirty-seeded one
        with tempfile.TemporaryDirectory() as tmp:
            sys.path.insert(0, str(ROOT))
            from cruise_control_tpu_torch.analyzer.session_script import SESSION_E2E
            plain, seeded = reference_session(Path(tmp), SESSION_E2E,
                                              seed_dirty=(False, True), timeout=7200)
        print(json.dumps(dict(cell="e2e-1000b-50000p", plain=plain, seeded=seeded)))
        sys.exit(0)
    dtype = sys.argv[2] if len(sys.argv) > 2 else None
    rung = RUNGS[name]
    with tempfile.TemporaryDirectory() as tmp:
        ref = reference_chain(Path(tmp), rung["spec"], rung["goals"], timeout=7200,
                              dtype=dtype)
    print(json.dumps(dict(rung=name, dtype=dtype or "auto", **oracle_row(ref))))
