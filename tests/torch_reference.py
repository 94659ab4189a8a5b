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

returns a dict of plain values: ``counts`` and ``finisher`` (the fields the
tests compare), ``proposals`` (tuples), ``balancedness_after`` and
``final`` (the final replica_broker / replica_is_leader / replica_disk).
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
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu.model import random_cluster as rc

args = json.loads(sys.argv[1])
if args["spec"] is None:
    from __graft_entry__ import _fixture_cluster
    ct, meta = _fixture_cluster()
else:
    ct, meta = rc.generate_scale(rc.RandomClusterSpec(**args["spec"]))
res = GoalOptimizer().optimizations(ct, meta, goal_names=args["goals"],
                                    skip_hard_goal_check=True,
                                    raise_on_failure=False)
g = res.goal_results
out = dict(
    counts=dict(before=res.violated_goals_before, after=res.violated_goals_after,
                actions=[r.iterations for r in g], passes=[r.passes for r in g],
                moves=res.num_replica_movements, leads=res.num_leadership_movements),
    finisher=dict(proven=[r.fixpoint_proven for r in g],
                  rounds=[r.finisher_rounds for r in g],
                  quiesce=[r.quiesce_chunk for r in g]),
    proposals=[dataclasses.astuple(p) for p in res.proposals],
    balancedness_after=res.balancedness_after,
    final={n: np.asarray(getattr(res.final_state, n))
           for n in ("replica_broker", "replica_is_leader", "replica_disk")})
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def reference_chain(tmp_path: Path, spec: dict | None, goals: list[str],
                    timeout: int = 900) -> dict:
    out = tmp_path / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_COMPILATION_CACHE="false",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    arg = json.dumps(dict(spec=spec, goals=goals, out=str(out)))
    proc = subprocess.run([sys.executable, "-c", _CHILD, arg], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)
