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
one shape compiled once) and returns their dicts in order.

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


def _run_child(code: str, arg: dict, timeout: int) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="false",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(arg)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")


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


if __name__ == "__main__":
    # python tests/torch_reference.py rung4 [float32|bfloat16]: the JAX
    # reference's outcome row of a rung (default "auto"), as JSON
    import tempfile
    name = sys.argv[1]
    dtype = sys.argv[2] if len(sys.argv) > 2 else None
    rung = RUNGS[name]
    with tempfile.TemporaryDirectory() as tmp:
        ref = reference_chain(Path(tmp), rung["spec"], rung["goals"], timeout=7200,
                              dtype=dtype)
    print(json.dumps(dict(rung=name, dtype=dtype or "auto", **oracle_row(ref))))
