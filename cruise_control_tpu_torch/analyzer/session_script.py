"""The resident-session service script: the rounds of the
e2e-1000b-50000p cell (and of its tier-1 size), through the classes of
either package.

``session_script(ns, spec)`` drives ``SimulatedClusterBackend`` ->
``LoadMonitor`` -> ``ResidentClusterSession`` -> ``GoalOptimizer.
optimizations(None, session=...)`` for the classes in ``ns`` (``port_ns()``
gives the port's; the tests hand in the reference's the same way) and
returns one plain-valued row per round, so the two packages' rows compare
with ``==``. ``chip_smoke.py`` phase 6 runs it on the card against the
reference's rows (``python tests/torch_reference.py session-e2e``).

The cluster is made from ``spec["seed"]`` with numpy, so both packages see
the same one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

# The e2e-1000b-50000p cell: bench.py run_e2e_rung's default service cluster
# (1,000 brokers on 20 racks, 50,000 RF-2 partitions over 200 topics, skewed
# leaders on brokers 0-249, exponential sizes with mean 200 MB, rng seed 7),
# a monitor with 5 windows of at least one sample, the sixteen default goals.
SESSION_E2E = dict(cluster="e2e", brokers=1000, partitions=50_000, seed=7,
                   windows=5, flips=8, goals=None,
                   config={"num.metrics.windows": 5,
                           "min.samples.per.metrics.window": 1})
# the tier-1 size (tests/test_session.py, tests/test_incremental.py)
SESSION_SMALL = dict(cluster="small", brokers=10, partitions=60, seed=0,
                     windows=6, flips=8, goals=None, config={})


def session_backend(ns, spec: dict):
    """The script's simulated cluster, made from ``spec["seed"]`` with numpy."""
    rng = np.random.default_rng(spec["seed"])
    be = ns["SimulatedClusterBackend"]()
    nb, npart = spec["brokers"], spec["partitions"]
    if spec["cluster"] == "e2e":
        for b in range(nb):
            be.add_broker(b, f"r{b % 20}")
        leaders = rng.integers(0, nb // 4, npart)
        follows = (leaders + 1 + rng.integers(0, nb - 2, npart)) % nb
        sizes = rng.exponential(200.0, npart)
        for p in range(npart):
            be.create_partition("t%d" % (p % 200), p,
                                [int(leaders[p]), int(follows[p])],
                                size_mb=float(sizes[p]),
                                bytes_in_rate=float(sizes[p] / 10),
                                bytes_out_rate=float(sizes[p] / 5),
                                cpu_util=float(sizes[p] / 300))
    else:
        for b in range(nb):
            be.add_broker(b, f"r{b % 3}")
        for p in range(npart):
            reps = [int(x) for x in rng.choice(nb, size=2, replace=False)]
            be.create_partition(f"t{p % 6}", p, reps,
                                size_mb=float(rng.uniform(10, 500)),
                                bytes_in_rate=float(rng.uniform(1, 50)),
                                bytes_out_rate=float(rng.uniform(1, 100)),
                                cpu_util=float(rng.uniform(0.1, 5)))
    return be


def flip_leaders(be, n_flips: int) -> None:
    """tools/churn_ab.py ``_inject_low_churn``: flip leadership on the first
    ``n_flips`` eligible partitions, in key order."""
    flips = {}
    for tp, pin in sorted(be.partitions().items()):
        if len(flips) >= n_flips:
            break
        if len(pin.replicas) > 1 and pin.leader == pin.replicas[0]:
            flips[tp] = pin.replicas[1]
    be.elect_leaders(flips)


def _digest(a) -> str:
    """The first 16 hex digits of the sha256 of an array's values (f32 or
    i64, so both packages' index dtypes hash alike); numpy, JAX or torch."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    a = a.astype(np.float32 if a.dtype.kind == "f" else np.int64)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


DIGEST_LEAVES = ("replica_broker", "replica_is_leader", "replica_disk", "util",
                 "leader_util", "potential_nw_out", "disk_util", "replica_count",
                 "leader_count", "topic_broker_count")


def round_row(info: dict, res) -> dict:
    """One service round's outcome in plain values: the sync and round
    modes, verdicts, certificates, per-goal actions / passes / modes, the
    movements and proposals (with a digest of their tuples), and digests of
    the final state's leaves."""
    g = res.goal_results
    props = sorted(dataclasses.astuple(p) for p in res.proposals)
    return dict(sync=info["mode"], churn=info.get("churn", 0),
                round=res.round_mode,
                before=sorted(res.violated_goals_before),
                after=sorted(res.violated_goals_after),
                proven=[r.fixpoint_proven for r in g],
                actions=[r.iterations for r in g],
                passes=[r.passes for r in g],
                modes=[r.mode for r in g],
                moves=res.num_replica_movements,
                leads=res.num_leadership_movements,
                proposals=len(res.proposals),
                proposals_sha=hashlib.sha256(repr(props).encode()).hexdigest()[:16],
                fallback=res.fallback_goals, skipped=res.skipped_goals,
                digests={n: _digest(getattr(res.final_state, n))
                         for n in DIGEST_LEAVES})


def session_script(ns: dict, spec: dict, seed_dirty: bool = False,
                   run_round=None, on_sync=None) -> list:
    """The service script of the session cell, through the classes in
    ``ns`` (the reference's or the port's; ``ns["kw"]`` is passed to the
    session and the optimizer, e.g. the port's ``device``):

    - sample ``windows`` rounds; sync (a rebuild); sample and sync (a delta
      with churn 0, which gives the memo its load baseline);
    - R1: a full round;
    - R2: sample and sync (churn 0), then the revalidated memo round;
    - R3: flip leadership on the first ``flips`` eligible partitions,
      sample and sync (a delta with that churn), then a round: full, or
      reduced with ``seed_dirty`` (``analyzer.incremental.seed.dirty``).

    Returns one ``round_row`` per round. ``run_round(i, call, session)``
    runs round i's optimize call (default: ``call()``), ``on_sync(info, wall_s)`` sees
    each sync's info and host wall; both serve timing and profiling."""
    be = session_backend(ns, spec)
    cfg = ns["cruise_control_config"](dict(
        spec["config"], **{"analyzer.incremental.seed.dirty": seed_dirty}))
    lm = ns["LoadMonitor"](config=cfg, backend=be,
                           sampler=ns["SimulatedMetricSampler"](be))
    lm.start_up()
    t = 0
    for t in range(spec["windows"]):
        lm.sample_once(now_ms=t * 300_000.0)
    kw = ns.get("kw", {})
    sess = ns["ResidentClusterSession"](lm, config=cfg, **kw)
    opt = ns["GoalOptimizer"](config=cfg, **kw)
    rows = []

    def sync():
        t0 = time.perf_counter()
        info = sess.sync()
        if on_sync is not None:
            on_sync(info, time.perf_counter() - t0)
        return info

    def sample_and_sync(flips: int = 0):
        nonlocal t
        if flips:
            flip_leaders(be, flips)
        t += 1
        lm.sample_once(now_ms=t * 300_000.0)
        return sync()

    def optimize(info):
        def call():
            return opt.optimizations(None, goal_names=spec["goals"], session=sess,
                                     raise_on_failure=False, skip_hard_goal_check=True)
        res = call() if run_round is None else run_round(len(rows), call, sess)
        rows.append(round_row(info, res))

    info = sync()
    assert info["mode"] == "rebuild", info
    optimize(sample_and_sync())
    optimize(sample_and_sync())
    optimize(sample_and_sync(flips=spec["flips"]))
    return rows


def port_ns(device="cuda") -> dict:
    """The port's classes for ``session_script``, on ``device``."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.session import ResidentClusterSession
    from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu_torch.config import cruise_control_config
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.sampling.samplers import (
        SimulatedMetricSampler,
    )
    return dict(GoalOptimizer=GoalOptimizer,
                ResidentClusterSession=ResidentClusterSession,
                SimulatedClusterBackend=SimulatedClusterBackend,
                cruise_control_config=cruise_control_config,
                LoadMonitor=LoadMonitor, SimulatedMetricSampler=SimulatedMetricSampler,
                kw=dict(device=device))
