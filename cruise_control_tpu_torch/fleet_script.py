"""Scripted fleet drives through the classes of either package.

Each function takes ``ns``, a namespace of one package's classes
(``port_fleet_ns(device)`` gives the port's; the tests hand in the
reference's the same way, from a fresh interpreter), drives
``FleetScheduler`` rounds and dispatches over simulated tenants and returns
plain values (lists, dicts, numpy arrays), so the two packages' results
compare with ``==``:

- ``fleet_cases``: batched parity against solo rounds, a steady second
  round, generation staleness, pause / resume, spill / readmit, the memory
  budget's LRU spill and the fleet state (the reference's
  ``tests/test_fleet.py`` drives that need no REST server, on a five-goal
  chain, ``FLEET_GOALS``);
- ``gating_cases``: the churn-skewed drive of ``tests/test_fleet_gating.py``
  (a hot tenant past the dirty-seed budget beside idle ones; gated and
  ungated fleets; parking, compaction and early landing);
- ``serving_cases``: the admission engine of ``tests/test_serving.py``
  (zero-pressure parity, priority lanes, a mid-launch arrival, pad-to-join
  against split, a launch failure);
- ``fleet_e2e``: the fleet-16x100b cell's rounds (``bench.py``
  ``run_fleet_rung`` at BASELINE config 2's size: 16 tenants of 100 brokers
  and 5,000 RF-2 partitions on 4 racks), which ``chip_smoke.py`` phase 8
  runs on the card against the reference's rows
  (``python tests/torch_reference.py fleet-e2e``).

Every cluster is made with numpy from its seed, so both packages see the
same one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from types import SimpleNamespace

import numpy as np

WINDOW_MS = 300_000.0
T0 = 2_000_000.0
FLEET_SEEDS = (11, 12, 13)
GATING_SEEDS = (21, 22, 23)          # index 0 is the hot tenant
SERVING_SEEDS = (21, 22, 23)
GATING_GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal"]
SERVING_GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]
# the tier-1 fleet drive's chain: a move goal of the rack family, a capacity
# goal, two count goals (the second on the leadership branch) and a usage
# goal (the K1 keying kernel and the swap branch). The default chain runs
# in the fleet-16x100b cell.
FLEET_GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal",
               "LeaderReplicaDistributionGoal", "DiskUsageDistributionGoal"]
# 60 partitions x RF 2 = 120 replicas, a dirty-seed budget of 30: 45 flips put
# the hot tenant past it, one replica move keeps the idle ones under it
HOT_FLIPS, IDLE_FLIPS = 45, 1
# the fleet-16x100b cell (bench.py run_fleet_rung's tenant_backend at
# BASELINE config 2's size) and its tier-1 cut
FLEET_E2E = dict(tenants=16, brokers=100, partitions=5000, rf=2, racks=4,
                 topics=12, seed0=100, windows=6)
FLEET_SMALL = dict(tenants=3, brokers=16, partitions=200, rf=2, racks=4,
                   topics=12, seed0=100, windows=6)


def port_fleet_ns(device="cuda") -> dict:
    """The port's classes for these scripts, on ``device``."""
    from cruise_control_tpu_torch.app import CruiseControl
    from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu_torch.config import cruise_control_config
    from cruise_control_tpu_torch.fleet import FleetScheduler
    from cruise_control_tpu_torch.pipeline import LANE_HEAL, LANE_REBALANCE, LANE_REFRESH
    return dict(CruiseControl=CruiseControl, SimulatedClusterBackend=SimulatedClusterBackend,
                cruise_control_config=cruise_control_config, FleetScheduler=FleetScheduler,
                LANE_HEAL=LANE_HEAL, LANE_REBALANCE=LANE_REBALANCE,
                LANE_REFRESH=LANE_REFRESH, kw={"device": device})


def tenant_backend(ns, seed, num_brokers=10, num_partitions=60, rf=2, racks=3,
                   topics=6):
    return seed_tenant(ns["SimulatedClusterBackend"](), seed, num_brokers,
                       num_partitions, rf, racks, topics)


def seed_tenant(be, seed, num_brokers=10, num_partitions=60, rf=2, racks=3, topics=6):
    """Add a tenant's brokers and partitions, made from ``seed`` with numpy,
    to the simulated backend ``be``; returns ``be``."""
    rng = np.random.default_rng(seed)
    for b in range(num_brokers):
        be.add_broker(b, f"r{b % racks}")
    for p in range(num_partitions):
        reps = [int(x) for x in rng.choice(num_brokers, size=rf, replace=False)]
        be.create_partition(f"t{p % topics}", p, reps,
                            size_mb=float(rng.uniform(10, 500)),
                            bytes_in_rate=float(rng.uniform(1, 50)),
                            bytes_out_rate=float(rng.uniform(1, 100)),
                            cpu_util=float(rng.uniform(0.1, 5)))
    return be


def _cfg(ns, goals=None, **over):
    props = {"anomaly.detection.interval.ms": 10_000_000}
    if goals:
        props.update({"goals": ",".join(goals), "hard.goals": "ReplicaCapacityGoal"})
    props.update(over)
    return ns["cruise_control_config"](props)


def _sample(cc, lo=0, hi=6):
    for i in range(lo, hi):
        cc.load_monitor.sample_once(now_ms=i * WINDOW_MS)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def goal_sets(res) -> tuple:
    """(violated set, certificate rows, proposal rows): the parity unit."""
    return (
        sorted(g.name for g in res.goal_results if g.violated_after),
        sorted((g.name, bool(g.fixpoint_proven), int(g.moves_remaining),
                int(g.leads_remaining), int(g.swap_window_remaining))
               for g in res.goal_results),
        sorted((p.topic, int(p.partition), int(p.new_leader),
                tuple((int(b), int(d)) for b, d in p.new_replicas))
               for p in res.proposals))


def result_row(res) -> dict:
    """A tenant result's parity unit, final assignment arrays and lane
    counters."""
    return dict(sets=goal_sets(res),
                final={n: _np(getattr(res.final_state, n)).astype(np.int64)
                       for n in ("replica_broker", "replica_is_leader", "replica_disk")},
                mode=res.round_mode,
                goals=[(g.name, g.mode, int(g.iterations), int(g.passes),
                        int(g.passes_skipped), int(g.quiesce_chunk),
                        bool(g.finisher_skipped)) for g in res.goal_results],
                lane=(int(res.passes_dispatched), int(res.passes_skipped),
                      int(res.early_exit_goals), int(res.skipped_goals),
                      bool(res.parked_early), bool(res.compacted_out)))


def report_row(report: dict) -> dict:
    """A round or dispatch report without its device byte count (the
    packages store index columns at different widths)."""
    return {k: v for k, v in report.items() if k != "deviceBytes"}


def _build(ns, prefix, seeds, cfg_fn):
    fleet = ns["FleetScheduler"](config=cfg_fn(), **ns.get("kw", {}))
    for s in seeds:
        t = fleet.add_tenant(f"{prefix}-{s}", backend=tenant_backend(ns, s), config=cfg_fn())
        _sample(t.cc)
    return fleet


def _results(fleet) -> dict:
    return {cid: result_row(fleet.app_for(cid).cached_proposals())
            for cid in fleet.cluster_ids}


# ---------------------------------------------------------------------------
# tests/test_fleet.py
# ---------------------------------------------------------------------------
def fleet_cases(ns) -> dict:
    kw = ns.get("kw", {})
    out = {}

    def cfg():
        return _cfg(ns, FLEET_GOALS)

    # batched parity against three solo rounds
    solo = []
    for s in FLEET_SEEDS:
        cc = ns["CruiseControl"](tenant_backend(ns, s), config=cfg(), **kw)
        _sample(cc)
        cc.resident_session.sync()
        solo.append(result_row(cc.goal_optimizer.optimizations(
            None, None, raise_on_failure=False, session=cc.resident_session)))
        cc.shutdown()
    fleet = _build(ns, "tenant", FLEET_SEEDS, cfg)
    report = fleet.run_round(now_ms=T0)
    out["parity"] = dict(solo=solo, fleet=[result_row(fleet.app_for(
        f"tenant-{s}").cached_proposals()) for s in FLEET_SEEDS],
        report=report_row(report))
    fleet.shutdown()

    # the module fixture's fleet, its steady round and staleness
    fleet = _build(ns, "tenant", FLEET_SEEDS, cfg)
    fleet.run_round(now_ms=T0)
    for t in fleet.tenants.values():
        t.cc.load_monitor.sample_once(now_ms=7 * WINDOW_MS)
    donated0 = {cid: t.session.donated_rounds for cid, t in fleet.tenants.items()}
    r2 = fleet.run_round(now_ms=2_400_000.0)
    out["steady"] = dict(
        report=report_row(r2),
        modes={cid: t.session.last_sync_info["mode"] for cid, t in fleet.tenants.items()},
        donated={cid: t.session.donated_rounds - donated0[cid]
                 for cid, t in fleet.tenants.items()},
        results=_results(fleet))
    fleet.run_round(now_ms=2_500_000.0)
    out["fresh"] = report_row(fleet.run_round(now_ms=2_600_000.0))

    # spill / readmit of one tenant, leaf by leaf (compared in-package)
    sess = fleet.tenants[f"tenant-{FLEET_SEEDS[1]}"].session
    sess._ensure_state()
    def fields(obj):
        return [f.name for f in dataclasses.fields(obj)]

    pre_env = {n: _np(getattr(sess.env, n)).copy() for n in fields(sess.env)
               if hasattr(getattr(sess.env, n), "shape")}
    pre_state = {n: _np(getattr(sess.state, n)).copy() for n in fields(sess.state)}
    spilled = sess.spill()
    b = sess.device_bytes()
    readmitted = sess.readmit()
    out["spill"] = dict(
        spilled=spilled, bytes_after_spill=(b["env_bytes"], b["state_bytes"]),
        readmitted=readmitted, residual_leaf="util_residual" in pre_state,
        env_equal={n: bool(a.dtype == _np(getattr(sess.env, n)).dtype
                           and np.array_equal(a, _np(getattr(sess.env, n))))
                   for n, a in pre_env.items()},
        state_equal={n: bool(a.dtype == _np(getattr(sess.state, n)).dtype
                             and np.array_equal(a, _np(getattr(sess.state, n))))
                     for n, a in pre_state.items()})

    # the memory budget's LRU spill, then an implicit readmit by sync
    ids = [f"tenant-{s}" for s in FLEET_SEEDS]
    for t in fleet.tenants.values():
        t.cc.load_monitor.sample_once(now_ms=10 * WINDOW_MS)
    fleet.run_round(now_ms=3_000_000.0)
    for cid in ids[1:]:
        fleet.tenants[cid].cc.load_monitor.sample_once(now_ms=11 * WINDOW_MS)
    fleet.run_round(now_ms=3_100_000.0)
    resident = fleet.device_bytes()
    one_tenant = fleet.tenants[ids[0]].session.device_bytes()
    one = one_tenant["env_bytes"] + one_tenant["state_bytes"]
    fleet.memory_budget_bytes = resident - 1
    spilled_ids = fleet.enforce_memory_budget()
    fits = fleet.device_bytes() <= resident - one
    fleet.memory_budget_bytes = -1
    sess = fleet.tenants[ids[0]].session
    fleet.tenants[ids[0]].cc.load_monitor.sample_once(now_ms=12 * WINDOW_MS)
    info = sess.sync()
    out["lru"] = dict(spilled=spilled_ids, fits=fits, resident_positive=resident > 0,
                      mode=info["mode"], still_spilled=sess.spilled,
                      readmits=sess.readmits >= 1,
                      spills=sess.state_json()["spills"] >= 1)
    state = fleet.state_json()
    out["state"] = dict(rounds=state["rounds"], launches=state["launches"],
                        tenants=sorted(state["tenants"]),
                        staleness=any(r["stalenessP95Ms"] is not None
                                      for r in state["tenants"].values()),
                        device_bytes_positive=state["deviceBytes"] > 0)
    fleet.shutdown()

    # pause / resume on a fleet of its own
    fleet = _build(ns, "pause", FLEET_SEEDS, cfg)
    first = fleet.run_round(now_ms=T0)
    cid = f"pause-{FLEET_SEEDS[0]}"
    fleet.pause(cid)
    for t in fleet.tenants.values():
        t.cc.load_monitor.sample_once(now_ms=8 * WINDOW_MS)
    paused = fleet.run_round(now_ms=2_700_000.0)
    servable = fleet.app_for(cid).cached_proposals() is not None
    fleet.resume(cid)
    fleet.tenants[cid].cc.load_monitor.sample_once(now_ms=9 * WINDOW_MS)
    resumed = fleet.run_round(now_ms=2_800_000.0)
    out["pause"] = dict(first=sorted(first["optimized"]), paused=report_row(paused),
                        servable=servable, resumed=report_row(resumed))
    fleet.shutdown()
    return out


# ---------------------------------------------------------------------------
# tests/test_fleet_gating.py
# ---------------------------------------------------------------------------
def _flip(be, n):
    """Flip the leaders of the first ``n`` partitions (sorted) to the other
    end of their replica list."""
    flips = {}
    for tp in sorted(be.partitions())[:n]:
        info = be.partitions()[tp]
        flips[tp] = (info.replicas[-1] if info.leader == info.replicas[0]
                     else info.replicas[0])
    be.elect_leaders(flips)


def _nudge(be, n):
    """Move a non-leader replica of the first ``n`` partitions one broker
    over: churn that leaves leadership intact."""
    parts = be.partitions()
    brokers = sorted({b for info in parts.values() for b in info.replicas}
                     | {info.leader for info in parts.values()})
    nb = max(brokers) + 1
    props = []
    for tp in sorted(parts)[:n]:
        reps = list(parts[tp].replicas)
        leader = parts[tp].leader
        mv = max(j for j, b in enumerate(reps) if b != leader)
        nxt = (reps[mv] + 1) % nb
        while nxt in reps:
            nxt = (nxt + 1) % nb
        reps[mv] = nxt
        props.append(SimpleNamespace(topic=tp[0], partition=tp[1],
                                     new_replicas=[(b, 0) for b in reps],
                                     new_leader=leader))
    be.apply_assignment(props)


def _churn(backends, hot=HOT_FLIPS, idle=IDLE_FLIPS):
    for i, be in enumerate(backends):
        if i == 0:
            _flip(be, hot)
        else:
            _nudge(be, idle)


def _apply_installed(fleet):
    """Apply each tenant's installed proposals to its backend (the
    executor's role in a serving loop)."""
    for cid in fleet.cluster_ids:
        res = fleet.app_for(cid).cached_proposals()
        fleet.tenants[cid].cc.backend.apply_assignment(res.proposals)


def gating_cases(ns) -> dict:
    kw = ns.get("kw", {})

    def cfg(gating=True):
        return _cfg(ns, GATING_GOALS, **{
            "analyzer.pass.chunk.min.replicas": 0,
            "analyzer.incremental.seed.dirty": True,
            "fleet.pass.gating.enabled": gating})

    out = {}
    solo_r3 = {}
    for s in GATING_SEEDS:
        cc = ns["CruiseControl"](tenant_backend(ns, s), config=cfg(), **kw)
        _sample(cc)
        sess = cc.resident_session
        sess.sync()
        r1 = cc.goal_optimizer.optimizations(None, None, raise_on_failure=False,
                                             session=sess)
        cc.backend.apply_assignment(r1.proposals)
        cc.load_monitor.sample_once(now_ms=6 * WINDOW_MS)
        sess.sync()
        r2 = cc.goal_optimizer.optimizations(None, None, raise_on_failure=False,
                                             session=sess)
        cc.backend.apply_assignment(r2.proposals)
        if s == GATING_SEEDS[0]:
            _flip(cc.backend, HOT_FLIPS)
        else:
            _nudge(cc.backend, IDLE_FLIPS)
        cc.load_monitor.sample_once(now_ms=7 * WINDOW_MS)
        sess.sync()
        solo_r3[f"tenant-{s}"] = result_row(cc.goal_optimizer.optimizations(
            None, None, raise_on_failure=False, session=sess))
        cc.shutdown()
    out["solo_r3"] = solo_r3

    fg = _build(ns, "tenant", GATING_SEEDS, lambda: cfg(True))
    fu = _build(ns, "tenant", GATING_SEEDS, lambda: cfg(False))
    for fleet in (fg, fu):
        fleet.run_round(now_ms=T0)
        _apply_installed(fleet)
        for cid in fleet.cluster_ids:
            fleet.tenants[cid].cc.load_monitor.sample_once(now_ms=6 * WINDOW_MS)
        fleet.run_round(now_ms=2_030_000.0)
        _apply_installed(fleet)
        backends = [fleet.tenants[cid].cc.backend for cid in fleet.cluster_ids]
        if fleet is fg:
            out["gated_counters_pre_r3"] = {cid: fg.tenants[cid].gating_json()
                                            for cid in fg.cluster_ids}
        _churn(backends)
        for cid in fleet.cluster_ids:
            fleet.tenants[cid].cc.load_monitor.sample_once(now_ms=7 * WINDOW_MS)
        fleet.run_round(now_ms=2_060_000.0)
    # the launch-level gating statistics (the port's optimizer keeps the
    # last batched round's; the reference records them on its round trace)
    out["gated_round"] = getattr(fg.optimizer, "last_fleet_round", None)
    out["gated_r3"] = _results(fg)
    out["ungated_r3"] = _results(fu)
    out["gated_counters_r3"] = {cid: fg.tenants[cid].gating_json() for cid in fg.cluster_ids}
    out["ungated_counters_r3"] = {cid: fu.tenants[cid].gating_json()
                                  for cid in fu.cluster_ids}

    # round 4: heal and rebalance lanes through the admission engine
    _apply_installed(fg)
    backends = [fg.tenants[cid].cc.backend for cid in fg.cluster_ids]
    _churn(backends)
    for cid in fg.cluster_ids:
        fg.tenants[cid].cc.load_monitor.sample_once(now_ms=8 * WINDOW_MS)
    mark = len(fg.journal.lines())
    hot = fg.cluster_ids[0]
    for cid in fg.cluster_ids:
        fg.enqueue(cid, ns["LANE_HEAL"], "skew-heal", now_ms=2_090_000.0)
    fg.enqueue(hot, ns["LANE_REBALANCE"], "skew-rebalance", now_ms=2_090_000.0)
    for _ in range(8):
        d = fg.dispatch_once(now_ms=2_091_000.0)
        if d is None or (d["launches"] == 0 and not d["failed"]):
            break
    out["r4_journal"] = [json.loads(x) for x in fg.journal.lines()[mark:]]
    out["r4_results"] = _results(fg)
    out["hot"] = hot

    # budget value toggles (the same classification, new churn sizes)
    def heal_dispatch(hot_n, idle_n, w, now):
        _apply_installed(fg)
        for i, be in enumerate(backends):
            _flip(be, hot_n if i == 0 else idle_n)
        for cid in fg.cluster_ids:
            fg.tenants[cid].cc.load_monitor.sample_once(now_ms=w * WINDOW_MS)
        for cid in fg.cluster_ids:
            fg.enqueue(cid, ns["LANE_HEAL"], "toggle", now_ms=now)
        for _ in range(8):
            d = fg.dispatch_once(now_ms=now + 1_000.0)
            if d is None or (d["launches"] == 0 and not d["failed"]):
                break

    heal_dispatch(HOT_FLIPS - 5, 2, 9, 2_120_000.0)
    heal_dispatch(HOT_FLIPS - 7, 2, 10, 2_150_000.0)
    out["toggle_results"] = _results(fg)

    # uniform churn: every lane hot, nobody parks
    before = {cid: fg.tenants[cid].gating_json() for cid in fg.cluster_ids}
    _apply_installed(fg)
    _churn(backends, hot=HOT_FLIPS, idle=HOT_FLIPS)
    for cid in fg.cluster_ids:
        fg.tenants[cid].cc.load_monitor.sample_once(now_ms=11 * WINDOW_MS)
    fg.run_round(now_ms=2_180_000.0)
    out["uniform_before"] = before
    out["uniform_after"] = {cid: fg.tenants[cid].gating_json() for cid in fg.cluster_ids}
    out["uniform_results"] = _results(fg)
    fg.shutdown()
    fu.shutdown()
    return out


# ---------------------------------------------------------------------------
# tests/test_serving.py (the drives that need no simulator)
# ---------------------------------------------------------------------------
def serving_cases(ns) -> dict:
    kw = ns.get("kw", {})
    out = {}

    def cfg(**over):
        return _cfg(ns, SERVING_GOALS, **over)

    # zero pressure: the admission round is the static round
    fa = _build(ns, "par", SERVING_SEEDS, cfg)
    fb = _build(ns, "par", SERVING_SEEDS, lambda: cfg(**{"fleet.admission.enabled": False}))
    ra, rb = fa.run_round(now_ms=T0), fb.run_round(now_ms=T0)
    out["zero_pressure"] = dict(
        a=report_row(ra), b=report_row(rb), res_a=_results(fa), res_b=_results(fb),
        second=(fa.run_round(now_ms=T0 + 100.0)["skipped"],
                fb.run_round(now_ms=T0 + 100.0)["skipped"]))
    fa.shutdown()
    fb.shutdown()

    # the module fixture: three tenants, the K = 3, 2, 1 launches made once
    fleet = _build(ns, "tenant", SERVING_SEEDS, cfg)
    report = fleet.run_round(now_ms=T0)
    warm = [sorted(report["optimized"])]
    for k in (2, 1):
        for s in SERVING_SEEDS[:k]:
            fleet.enqueue(f"tenant-{s}", ns["LANE_REFRESH"], "prewarm", now_ms=T0 + 1_000.0)
        d = fleet.dispatch_once(now_ms=T0 + 2_000.0)
        warm.append(d["admitted"])
    out["warm"] = warm
    cids = [f"tenant-{s}" for s in SERVING_SEEDS]

    # priority lanes: heal preempts hygiene preempts refresh
    fleet.max_batch = 1
    fleet.enqueue(cids[2], ns["LANE_REFRESH"], "due", now_ms=T0 + 10_000.0)
    fleet.enqueue(cids[1], ns["LANE_REBALANCE"], "hygiene", now_ms=T0 + 11_000.0)
    fleet.enqueue(cids[0], ns["LANE_HEAL"], "verdict", now_ms=T0 + 12_000.0)
    order = []
    for _ in range(3):
        order.extend(fleet.dispatch_once(now_ms=T0 + 13_000.0)["admitted"])
    out["priority"] = dict(order=order, depth=fleet.queue_depth())
    fleet.max_batch = 16

    # a request landing after a batch was admitted rides the next dispatch
    fleet.max_batch = 2
    fleet.enqueue(cids[0], ns["LANE_REFRESH"], "due", now_ms=T0 + 20_000.0)
    fleet.enqueue(cids[1], ns["LANE_REFRESH"], "due", now_ms=T0 + 20_500.0)
    d1 = fleet.dispatch_once(now_ms=T0 + 21_000.0)
    fleet.enqueue(cids[2], ns["LANE_HEAL"], "verdict", now_ms=T0 + 21_500.0)
    depth = fleet.queue_depth()
    d2 = fleet.dispatch_once(now_ms=T0 + 22_000.0)
    out["mid_launch"] = dict(d1=sorted(d1["admitted"]), depth=depth, d2=d2["admitted"],
                             depth_after=fleet.queue_depth())
    fleet.max_batch = 16

    # a launch failure surfaces per tenant; the heal request is requeued
    real = fleet.optimizer.optimizations_batched

    def boom(sessions, **_kw):
        raise RuntimeError("injected launch failure")

    fleet.optimizer.optimizations_batched = boom
    try:
        fleet.enqueue(cids[0], ns["LANE_HEAL"], "verdict", now_ms=T0 + 30_000.0)
        fleet.enqueue(cids[1], ns["LANE_REFRESH"], "due", now_ms=T0 + 30_100.0)
        d = fleet.dispatch_once(now_ms=T0 + 31_000.0)
        failed = dict(launches=d["launches"], failed=d["failed"],
                      depth=fleet.queue_depth(),
                      retries=fleet._requests[cids[0]][ns["LANE_HEAL"]].retries)
    finally:
        fleet.optimizer.optimizations_batched = real
    d = fleet.dispatch_once(now_ms=T0 + 32_000.0)
    failed.update(next_admitted=d["admitted"], next_launches=d["launches"],
                  depth_after=fleet.queue_depth())
    out["failure"] = failed
    out["admission_state"] = {k: v for k, v in fleet.admission_state_json().items()
                              if k not in ("gating", "lastDispatch")}
    out["journal"] = [json.loads(x) for x in fleet.journal.lines()
                      if '"admission"' in x]
    fleet.shutdown()

    # pad-to-join against split on both sides of the pressure threshold
    fleet = ns["FleetScheduler"](config=cfg(**{"fleet.admission.near.join.pressure": 3}),
                                 **kw)
    a, b, c = f"near-{SERVING_SEEDS[0]}", f"near-{SERVING_SEEDS[1]}", "near-wide"
    for cid, seed, brokers in ((a, SERVING_SEEDS[0], 10), (b, SERVING_SEEDS[1], 10),
                               (c, 24, 17)):
        t = fleet.add_tenant(cid, backend=tenant_backend(ns, seed, num_brokers=brokers),
                             config=cfg())
        _sample(t.cc)
    for cid in (a, b, c):
        fleet.tenants[cid].session.sync()
    small = fleet.bucket_key(fleet.tenants[a].session)
    large = fleet.bucket_key(fleet.tenants[c].session)
    fleet.enqueue(a, ns["LANE_REFRESH"], "due", now_ms=T0)
    fleet.enqueue(c, ns["LANE_REFRESH"], "due", now_ms=T0 + 100.0)
    d1 = fleet.dispatch_once(now_ms=T0 + 1_000.0)
    d2 = fleet.dispatch_once(now_ms=T0 + 2_000.0)
    counts1 = (fleet.splits, fleet.joins)
    fleet.enqueue(a, ns["LANE_REFRESH"], "due", now_ms=T0 + 10_000.0)
    fleet.enqueue(b, ns["LANE_REFRESH"], "due", now_ms=T0 + 10_100.0)
    fleet.enqueue(c, ns["LANE_REFRESH"], "due", now_ms=T0 + 10_200.0)
    d3 = fleet.dispatch_once(now_ms=T0 + 11_000.0)
    out["near"] = dict(
        small=small, large=large, near=fleet.near_buckets(small, large),
        d1=report_row(d1), d2=report_row(d2), counts1=counts1, d3=report_row(d3),
        joins=fleet.joins,
        floors={cid: fleet.tenants[cid].session.bucket_floors for cid in (a, b)},
        keys={cid: fleet.bucket_key(fleet.tenants[cid].session) for cid in (a, b)},
        results=_results(fleet))
    fleet.shutdown()
    return out


# ---------------------------------------------------------------------------
# The fleet-16x100b cell
# ---------------------------------------------------------------------------
def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for n in sorted(arrays):
        h.update(np.ascontiguousarray(arrays[n]).tobytes())
    return h.hexdigest()[:16]


def e2e_row(res) -> dict:
    """One tenant's row of the cell: verdicts, per-goal actions and
    passes, certificates, the proposal count and the final assignment's
    digest."""
    row = result_row(res)
    return dict(after=row["sets"][0],
                actions=[int(g.iterations) for g in res.goal_results],
                passes=[int(g.passes) for g in res.goal_results],
                proven=[bool(g.fixpoint_proven) for g in res.goal_results],
                proposals=len(res.proposals), mode=res.round_mode,
                digest=_digest(row["final"]))


def fleet_e2e(ns, spec: dict, rounds: int = 2, fleet=None) -> dict:
    """The cell's rounds: ``spec["tenants"]`` tenants (``tenant_backend``
    with seeds ``seed0 + k``), round 1 on the sampled windows, round 2 after
    one more window (delta syncs). Returns {"rounds": [{tenant: row}],
    "walls": [s], "reports": [...]} and leaves the fleet in ``out["fleet"]``
    (callers shut it down)."""
    kw = ns.get("kw", {})

    def cfg():
        return _cfg(ns)

    if fleet is None:
        fleet = ns["FleetScheduler"](config=cfg(), **kw)
        for k in range(spec["tenants"]):
            be = tenant_backend(ns, spec["seed0"] + k, num_brokers=spec["brokers"],
                                num_partitions=spec["partitions"], rf=spec["rf"],
                                racks=spec["racks"], topics=spec["topics"])
            t = fleet.add_tenant(f"tenant-{k}", backend=be, config=cfg())
            _sample(t.cc, 0, spec["windows"])
    rows, walls, reports = [], [], []
    for r in range(rounds):
        if r > 0:
            for t in fleet.tenants.values():
                t.cc.load_monitor.sample_once(now_ms=(spec["windows"] + r - 1) * WINDOW_MS)
        t0 = time.monotonic()
        rep = fleet.run_round(now_ms=T0 + r * 100_000.0)
        walls.append(time.monotonic() - t0)
        reports.append(dict(launches=rep["launches"], optimized=sorted(rep["optimized"]),
                            failed=rep["failed"]))
        rows.append({cid: e2e_row(fleet.app_for(cid).cached_proposals())
                     for cid in fleet.cluster_ids})
    return dict(rounds=rows, walls=walls, reports=reports, fleet=fleet)


def solo_e2e(ns, spec: dict, tenants=None) -> dict:
    """Round 1 of the cell as solo rounds, one tenant at a time (every
    tenant, or the indices in ``tenants``): {tenant: row}, and the walls of
    the optimizations."""
    kw = ns.get("kw", {})
    rows, walls = {}, []
    for k in (range(spec["tenants"]) if tenants is None else tenants):
        be = tenant_backend(ns, spec["seed0"] + k, num_brokers=spec["brokers"],
                            num_partitions=spec["partitions"], rf=spec["rf"],
                            racks=spec["racks"], topics=spec["topics"])
        cc = ns["CruiseControl"](be, config=_cfg(ns), **kw)
        _sample(cc, 0, spec["windows"])
        cc.resident_session.sync()
        t0 = time.monotonic()
        res = cc.goal_optimizer.optimizations(None, None, raise_on_failure=False,
                                              session=cc.resident_session)
        walls.append(time.monotonic() - t0)
        rows[f"tenant-{k}"] = e2e_row(res)
        cc.shutdown()
    return dict(rows=rows, walls=walls)
