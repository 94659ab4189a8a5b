"""The engine's remaining options against the JAX package: the pooled K1
(``compact_keying``), K2's per-goal veto form (``chain_cache=False``) and the
non-budget fallbacks, on the CPU (the kernels' plain twins).

The mirror of ``tests/test_pass_pipeline.py``: each of its runs (the three
knobs on and off, one knob at a time, multi-wave passes and their exact
fallback, the finisher forced on with the knobs) goes through the port and
through the reference with the same settings on its 24-broker
``_cluster(seed=...)``, and the two must agree bit for bit (assignments,
verdicts, per-goal counts, certificate fields, proposals); the claims the
reference's test makes about its own runs (knobs on equal knobs off) hold
for the port's. Then:

- the pooled selection against the reference's ``_select_candidates`` at R
  4,096 over eligible shares 0.01 to 1.0, stalls 0 and 3 and a seed mask
  (kv and ids bit for bit, pad slots included);
- each interval-form goal's ``accept_move`` against the reference's, and
  the folded rooms and terms against the per-goal masks, on a state with
  planted band-edge rows (``lhs + d`` on the bound and one ulp either side);
  K2's twin in its per-goal form against the reference's masked score;
- the single-action state ops (``apply_move``, ``apply_leadership``,
  ``apply_swap``, ``no_op_move``) against the reference's on fixture16,
  enabled and disabled, every leaf bit for bit.

Every reference value comes from two fresh interpreters that run side by
side once per test session (``reference_side`` below through
``torch_reference.background_reference``; under xdist they start when the
module is imported, while the suite's earlier tests run), so the test
worker imports nothing of JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_reference import (
    background_reference, cases_job, one_torch_thread, start_background_reference,
)

CHAIN = ["RackAwareGoal", "DiskCapacityGoal", "CpuCapacityGoal",
         "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "LeaderReplicaDistributionGoal"]
PARAMS_OFF = dict(max_pass_waves=1, pass_waves=1, compact_keying=False, chain_cache=False)
PARAMS_ON = dict(max_pass_waves=4, pass_waves=1, compact_keying=True, chain_cache=True)
PARAMS_WAVES = dict(max_pass_waves=4, pass_waves=4, compact_keying=True, chain_cache=True)
KNOBS = {"compact_keying": {"compact_keying": True}, "chain_cache": {"chain_cache": True},
         "max_pass_waves": {"max_pass_waves": 4}}
# the chain runs, by the reference interpreter that computes them (the
# runs of one static parameter set share their compiled programs;
# pass_waves is a traced leaf): "a" also computes the selection, mask and
# state-op cases, "b" the forced finisher; the two run side by side, about
# a minute each
_KNOB_RUNS = {f"knob_{n}": (778, dict(PARAMS_OFF, **k)) for n, k in KNOBS.items()}
RUNS = {"a": {"on_777": (777, PARAMS_ON), "waves_777": (777, PARAMS_WAVES),
              "waves1_777": (777, dict(PARAMS_WAVES, pass_waves=1)),
              "off_777": (777, PARAMS_OFF), "off_778": (778, PARAMS_OFF),
              "knob_max_pass_waves": _KNOB_RUNS["knob_max_pass_waves"]},
        "b": {n: _KNOB_RUNS[n] for n in ("knob_compact_keying", "knob_chain_cache")}}
FINISHER = dict(finisher_rounds=2, tail_pass_budget=6, stall_retries=2, tail_total_budget=12)
# the interval-form goals of test_rooms_exactly_reproduce_accept_move_masks
INTERVAL = ["DiskCapacityGoal", "CpuCapacityGoal", "NetworkInboundCapacityGoal",
            "NetworkOutboundCapacityGoal", "ReplicaCapacityGoal", "PotentialNwOutGoal",
            "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
            "DiskUsageDistributionGoal", "CpuUsageDistributionGoal",
            "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal"]
COMBINED = ["DiskCapacityGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal",
            "DiskUsageDistributionGoal", "LeaderReplicaDistributionGoal"]
# K2's per-goal form: an active goal behind every interval goal and a rack goal
SCORE_GOAL = "NetworkOutboundUsageDistributionGoal"
SCORE_PREV = ["RackAwareGoal"] + [g for g in INTERVAL if g != SCORE_GOAL]
SELECT_R = 4096
SELECT_SHARES = (0.01, 0.1, 0.5, 1.0)


# this module's tensors are small: one intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _spec(seed: int) -> dict:
    return dict(num_brokers=24, num_racks=4, num_topics=12, num_partitions=300,
                max_replication=2, skew=2.0, seed=seed)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _ns(ref: bool) -> dict:
    if ref:
        from cruise_control_tpu.analyzer import engine
        from cruise_control_tpu.analyzer.engine import EngineParams
        from cruise_control_tpu.analyzer.env import make_env
        from cruise_control_tpu.analyzer.goals import make_goals
        from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
        from cruise_control_tpu.analyzer.state import init_state
        from cruise_control_tpu.model import random_cluster as rc
        from cruise_control_tpu.model.cluster_tensor import pad_cluster
        kw = {}
    else:
        from cruise_control_tpu_torch.analyzer import engine
        from cruise_control_tpu_torch.analyzer.engine import EngineParams
        from cruise_control_tpu_torch.analyzer.env import make_env
        from cruise_control_tpu_torch.analyzer.goals import make_goals
        from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
        from cruise_control_tpu_torch.analyzer.state import init_state
        from cruise_control_tpu_torch.model import random_cluster as rc
        from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
        kw = {"device": "cpu"}
    return dict(locals())


def outcome(res) -> dict:
    """What the two packages' runs are held to, as plain values."""
    fs = res.final_state
    return dict(
        final={n: _np(getattr(fs, n)).astype(np.int64)
               for n in ("replica_broker", "replica_is_leader", "replica_disk")},
        before=list(res.violated_goals_before), after=list(res.violated_goals_after),
        moves=res.num_replica_movements, leads=res.num_leadership_movements,
        goals=[(g.name, g.iterations, g.passes, g.fixpoint_proven, g.hit_max_iters,
                g.moves_remaining, g.leads_remaining, g.swap_window_remaining,
                g.move_waves, g.swap_actions) for g in res.goal_results],
        proposals=[dataclasses.astuple(p) for p in res.proposals])


def chain_run(ns: dict, seed: int, params: dict) -> dict:
    rc = ns["rc"]
    ct, meta = rc.generate(rc.RandomClusterSpec(**_spec(seed)))
    opt = ns["GoalOptimizer"](engine_params=ns["EngineParams"](**params), **ns["kw"])
    return outcome(opt.optimizations(ct, meta, goal_names=CHAIN, raise_on_failure=False,
                                     skip_hard_goal_check=True))


def finisher_case(ns: dict) -> list:
    """The reference test's forced finisher: DiskUsageDistributionGoal
    behind the chain's first four goals, knobs on and off."""
    rc = ns["rc"]
    ct, meta = ns["pad_cluster"](*rc.generate(rc.RandomClusterSpec(**_spec(782))))
    env = (ns["make_env"](ct, meta, **ns["kw"]))
    st0 = ns["init_state"](env, ct.replica_broker, ct.replica_is_leader,
                           ct.replica_offline, ct.replica_disk)
    goals = ns["make_goals"](CHAIN)
    out = []
    for p in (PARAMS_ON, PARAMS_OFF):
        params = ns["EngineParams"](**dict(p, **FINISHER))
        st, info = ns["engine"].optimize_goal(env, st0, goals[-2], tuple(goals[:-2]), params)
        out.append(dict(rb=_np(st.replica_broker).astype(np.int64),
                        info={k: _np(info[k]).item() for k in (
                            "fixpoint_proven", "moves_remaining", "leads_remaining",
                            "swap_window_remaining", "violated_after", "iterations",
                            "finisher_rounds", "passes")}))
    return out


def selection_keys():
    """(key f32[R], seed mask bool[R] | None, tag) of the selection cases."""
    rng = np.random.default_rng(42)
    base = rng.random(SELECT_R).astype(np.float32)
    out = []
    for frac in SELECT_SHARES:
        elig = rng.random(SELECT_R) < frac
        out.append((np.where(elig, base, -np.inf).astype(np.float32), None, f"{frac}"))
    mask = rng.random(SELECT_R) < 0.2
    key = np.where(rng.random(SELECT_R) < 0.3, base, -np.inf).astype(np.float32)
    out.append((key, mask, "seed mask"))
    return out


# ---------------------------------------------------------------------------
# The reference's side (run in a fresh interpreter)
# ---------------------------------------------------------------------------
def _plant_edges(env, st, goals, bound_of) -> tuple:
    """Loads with band-edge rows for the resource-dim goals: for each goal
    three unused replicas whose load column at its dim puts ``lhs[b] + l``
    on the goal's bound at one broker b (the largest l that passes) and one
    ulp either side; for the usage goals the same on their source side
    (``util[s] - l`` against ``lower[s] - eps``). ``bound_of(goal)`` gives
    (dim, load column, lhs f32[B], bound f32[B], source bound f32[B] | None).
    Returns (leader_load, follower_load, [(replica, broker)]) as numpy."""
    ll = np.array(env.leader_load, np.float32)
    fl = np.array(env.follower_load, np.float32)
    rb = np.asarray(st.replica_broker)
    valid = np.asarray(env.replica_valid)
    B = len(np.asarray(env.broker_alive))
    used: set = set()
    cells = []

    def free_replicas(n, not_on=None, on=None):
        rows = [r for r in range(len(rb)) if valid[r] and r not in used
                and (not_on is None or rb[r] != not_on) and (on is None or rb[r] == on)]
        assert len(rows) >= n, "no replica left to plant"
        used.update(rows[:n])
        return rows[:n]

    def step(x, up):
        return np.nextafter(np.float32(x), np.float32(np.inf if up else -np.inf),
                            dtype=np.float32)

    def edge(ok, l):
        # the largest l >= 0 on the passing side of ``ok``
        l = np.float32(abs(l))
        while not ok(l) and l > 0:
            l = step(l, False)
        while ok(step(l, True)):
            l = step(l, True)
        return l

    def plant(col, rows, l):
        for r, x in zip(rows, (l, step(l, True), step(l, False))):
            ll[r, col] = fl[r, col] = x

    for gi, g in enumerate(goals):
        spec = bound_of(g)
        if spec is None:
            continue
        col, lhs, bound, src_bound = spec
        b = next(x % B for x in range(gi * 5 + 3, gi * 5 + 3 + B) if lhs[x % B] < bound[x % B])
        lb = edge(lambda l: np.float32(lhs[b] + l) <= bound[b], bound[b] - lhs[b])
        rows = free_replicas(3, not_on=b)
        plant(col, rows, lb)
        cells += [(r, b) for r in rows]
        if src_bound is None:
            continue
        s = next(x % B for x in range(gi * 7 + 1, gi * 7 + 1 + B)
                 if src_bound[x % B] < lhs[x % B] and np.sum(valid & (rb == x % B)
                                                             & ~np.isin(np.arange(len(rb)),
                                                                        list(used))) >= 3)
        ls = edge(lambda l: np.float32(lhs[s] - l) >= src_bound[s], lhs[s] - src_bound[s])
        rows = free_replicas(3, on=s)
        plant(col, rows, ls)
        cells += [(r, (s + 1) % B) for r in rows]
    return ll, fl, cells


def _reference_bounds(env, st):
    """``bound_of`` of ``_plant_edges`` for the reference's goals, in their
    own arithmetic."""
    from cruise_control_tpu.analyzer.goals.capacity import RESOURCE_EPS, CapacityGoal
    from cruise_control_tpu.analyzer.goals.distribution import ResourceDistributionGoal
    from cruise_control_tpu.analyzer.goals.network import PotentialNwOutGoal

    def bound_of(g):
        if isinstance(g, PotentialNwOutGoal):
            return (2, np.asarray(st.potential_nw_out),
                    np.asarray(g._limit(env) + RESOURCE_EPS[2]), None)
        if isinstance(g, CapacityGoal):
            r = int(g.resource)
            return (r, np.asarray(st.util[:, r]),
                    np.asarray(g._limit(env) + RESOURCE_EPS[r]), None)
        if isinstance(g, ResourceDistributionGoal):
            r = int(g.resource)
            lower, upper = g._limits(env, st)
            return (r, np.asarray(st.util[:, r]), np.asarray(upper + RESOURCE_EPS[r]),
                    np.asarray(lower - RESOURCE_EPS[r]))
        return None
    return bound_of


def reference_side(part: str) -> dict:
    """The reference's values of one ``part`` of this module: its group of
    ``RUNS`` ("runs") and ("masks") the selection, mask and state-op cases
    (part "a") or the forced finisher (part "b")."""
    ns = _ns(True)
    runs = {n: chain_run(ns, seed, p) for n, (seed, p) in RUNS[part].items()}
    masks = reference_masks(ns) if part == "a" else dict(finisher=finisher_case(ns))
    return dict(runs=runs, masks=masks)


def reference_masks(ns: dict) -> dict:
    """The selection cases, the planted accept_move masks and the masked
    score, and the single-action state ops, through the reference."""
    import jax
    import jax.numpy as jnp

    from cruise_control_tpu.analyzer import engine as E
    from cruise_control_tpu.analyzer import state as S
    from cruise_control_tpu.analyzer.engine import EngineParams
    from cruise_control_tpu.analyzer.goals.base import legit_move_mask
    out = {}
    # the pooled selection
    p_on = EngineParams(compact_keying=True, compact_pool=1024)
    p_off = EngineParams(compact_keying=False)
    # jitted as the engine runs it (one program per setting, not the eager
    # lax.cond's retrace per call); the selection is integer work past the
    # salt, so the values are the eager call's
    select = jax.jit(E._select_candidates, static_argnums=(1, 3, 4))
    sel = []
    for key, mask, _tag in selection_keys():
        k = E._mask_key(jnp.asarray(key), None if mask is None else jnp.asarray(mask))
        for stall in (0, 3):
            row = []
            for exact in (False, True):
                for p in (p_on, p_off):
                    kv, c = select(k, 64, jnp.int32(stall), exact, p)
                    row.append((np.asarray(kv), np.asarray(c).astype(np.int64)))
            sel.append(row)
    out["select"] = sel
    # accept_move with planted band edges
    rc = ns["rc"]
    ct, meta = rc.generate(rc.RandomClusterSpec(**_spec(779)))
    env = ns["make_env"](ct, meta)
    st = ns["init_state"](env, ct.replica_broker, ct.replica_is_leader,
                          ct.replica_offline, ct.replica_disk)
    goals = ns["make_goals"](INTERVAL)
    ll, fl, cells = _plant_edges(env, st, goals, _reference_bounds(env, st))
    env = dataclasses.replace(env, leader_load=jnp.asarray(ll), follower_load=jnp.asarray(fl))
    cand = jnp.arange(env.num_replicas, dtype=jnp.int32)
    d = E._move_delta_rows(env, st, cand)
    src_b = st.replica_broker[cand]
    out["planted"] = dict(env={f.name: np.asarray(getattr(env, f.name))
                               for f in dataclasses.fields(env)},
                          state={f.name: np.asarray(getattr(st, f.name))
                                 for f in dataclasses.fields(st)}, cells=cells)
    out["accept"] = {g.name: np.asarray(g.accept_move(env, st, cand)) for g in goals}
    out["rooms"] = {g.name: np.asarray(E._rooms_move_mask(g.accept_move_rooms(env, st), d,
                                                          src_b)) for g in goals}
    comb = tuple(ns["make_goals"](COMBINED))
    rooms, _custom = E._combined_move_rooms(comb, env, st)
    out["combined_rooms"] = np.asarray(E._rooms_move_mask(rooms, d, src_b))
    goal = ns["make_goals"]([SCORE_GOAL])[0]
    prev = ns["make_goals"](SCORE_PREV)
    mask = legit_move_mask(env, st, cand, goal.options)
    for g in prev:
        mask = mask & g.accept_move(env, st, cand)
    out["score"] = np.asarray(jnp.where(mask, goal.move_score(env, st, cand), -jnp.inf))
    # the single-action state ops on fixture16
    from __graft_entry__ import _fixture_cluster
    ct, meta = _fixture_cluster()
    env = ns["make_env"](ct, meta)
    st = ns["init_state"](env, ct.replica_broker, ct.replica_is_leader,
                          ct.replica_offline, ct.replica_disk)
    acts = state_actions(np.asarray(env.partition_replicas), np.asarray(env.replica_partition),
                         np.asarray(st.replica_broker), np.asarray(st.replica_is_leader),
                         env.num_brokers)
    ops = {"move": jax.jit(S.apply_move), "lead": jax.jit(S.apply_leadership),
           "swap": jax.jit(S.apply_swap)}
    res = {}
    for (op, a, b), en in ((x, e) for x in acts for e in (True, False)):
        s2 = ops[op](env, st, jnp.int32(a), jnp.int32(b), jnp.bool_(en))
        res[(op, a, b, en)] = {f.name: np.asarray(getattr(s2, f.name))
                               for f in dataclasses.fields(s2)}
    out["ops"] = dict(env={f.name: np.asarray(getattr(env, f.name))
                           for f in dataclasses.fields(env)},
                      state={f.name: np.asarray(getattr(st, f.name))
                             for f in dataclasses.fields(st)},
                      noop=S.no_op_move(st) is st, results=res)
    return out


def state_actions(members, rpart, rb, lead, B) -> list:
    """(op, a, b) single actions on fixture16: moves of a leader and a
    follower to a broker without their partition, two leadership
    transfers, two swaps of replicas of different partitions on different
    brokers."""
    acts = []
    for want_lead in (True, False):
        r = int(np.flatnonzero(lead == want_lead)[3])
        held = {int(rb[m]) for m in members[rpart[r]] if m >= 0}
        acts.append(("move", r, next(b for b in range(B) if b not in held)))
    rf2 = [r for r in np.flatnonzero(lead) if (members[rpart[r]] >= 0).sum() > 1]
    for r in (rf2[1], rf2[7]):
        f = next(int(m) for m in members[rpart[r]] if m >= 0 and m != r)
        acts.append(("lead", int(r), f))
    for a in (0, 5):
        b = next(x for x in range(a + 17, len(rb)) if rpart[x] != rpart[a] and rb[x] != rb[a])
        acts.append(("swap", a, int(b)))
    return acts


# the two reference interpreters start when the module is imported (under
# xdist, once per session, in the background)
_REFERENCE_JOBS = {part: cases_job("test_torch_pass_pipeline", "reference_side", part)
                   for part in RUNS}
start_background_reference("pass_pipeline", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """``reference_side`` of both parts, from their two interpreters side by
    side, once for the whole test session: {"runs": ..., "masks": ...}."""
    parts = background_reference(tmp_path_factory, "pass_pipeline", _REFERENCE_JOBS)
    return {k: {n: v for p in parts.values() for n, v in p[k].items()}
            for k in ("runs", "masks")}


_PORT_RUNS: dict = {}


def port_run(name: str) -> dict:
    """The port's run ``name`` of ``RUNS`` (once per worker)."""
    if name not in _PORT_RUNS:
        seed, p = next(g[name] for g in RUNS.values() if name in g)
        _PORT_RUNS[name] = chain_run(_ns(False), seed, p)
    return _PORT_RUNS[name]


def ref_run(ref, name: str) -> dict:
    return ref["runs"][name]


def _same(a: dict, b: dict, label: str) -> None:
    for n in a["final"]:
        np.testing.assert_array_equal(a["final"][n], b["final"][n], err_msg=f"{label} {n}")
    for k in ("before", "after", "moves", "leads", "goals", "proposals"):
        assert a[k] == b[k], (label, k)


def _same_outcome(a: dict, b: dict, label: str) -> None:
    """test_pass_pipeline.py ``_assert_bit_identical``: assignments,
    verdicts, movements and certificate fields."""
    for n in a["final"]:
        np.testing.assert_array_equal(a["final"][n], b["final"][n], err_msg=f"{label} {n}")
    for k in ("before", "after", "moves", "leads"):
        assert a[k] == b[k], (label, k)
    assert [g[3:8] for g in a["goals"]] == [g[3:8] for g in b["goals"]], label


def test_pipeline_knobs_bit_identical_to_legacy(ref):
    """All three knobs on and all off: each the reference's own run of the
    same settings bit for bit, and on equal to off."""
    for n in ("on_777", "off_777"):
        _same(port_run(n), ref_run(ref, n), n)
    _same_outcome(port_run("on_777"), port_run("off_777"), "all-knobs")


@pytest.mark.parametrize("knob", list(KNOBS))
def test_each_knob_falls_back_cleanly(ref, knob):
    """Each knob alone against the all-off run: the reference's runs bit for
    bit, and equal to all-off."""
    for n in ("off_778", f"knob_{knob}"):
        _same(port_run(n), ref_run(ref, n), n)
    _same_outcome(port_run(f"knob_{knob}"), port_run("off_778"), knob)


def test_multi_wave_outcome_parity_and_exact_fallback(ref):
    """pass_waves > 1 and its fallback to one wave: the reference's runs bit
    for bit; outcome parity with the legacy run and the one-wave fallback
    bit-identical to it."""
    for n in ("waves_777", "waves1_777"):
        _same(port_run(n), ref_run(ref, n), n)
    rw, r1 = port_run("waves_777"), port_run("off_777")
    assert (rw["before"], rw["after"]) == (r1["before"], r1["after"])
    assert [g[3:5] for g in rw["goals"]] == [g[3:5] for g in r1["goals"]]
    assert sum(g[8] for g in rw["goals"]) > 0
    _same_outcome(port_run("waves1_777"), r1, "waves-fallback")


def test_finisher_certificate_parity_with_knobs(ref):
    """The finisher forced on (DiskUsageDistributionGoal, knobs on and off):
    the reference's final assignment and certificate fields, and on equal to
    off."""
    port = finisher_case(_ns(False))
    for got, want in zip(port, ref["masks"]["finisher"]):
        np.testing.assert_array_equal(got["rb"], want["rb"])
        assert got["info"] == want["info"]
    assert port[0]["info"] == port[1]["info"]
    np.testing.assert_array_equal(port[0]["rb"], port[1]["rb"])


def test_compacted_selection_matches_full_sweep(ref):
    """The pooled selection (pool 1,024 at R 4,096) against the reference's
    ``_select_candidates`` with compaction on and off, soft and exact:
    kv and ids bit for bit, the pads (kv -inf, id R - 1) included; on the
    live rows the pooled and full selections agree. Shares 0.5 and 1.0
    overflow the pool; 0.01, 0.1 and the seed-mask case take it."""
    from cruise_control_tpu_torch.kernels import (
        pool_branch_counts, reset_pool_branches, select_candidates,
    )
    reset_pool_branches()
    rows = iter(ref["masks"]["select"])
    for key, mask, tag in selection_keys():
        m = None if mask is None else torch.as_tensor(mask)
        for stall in (0, 3):
            row = next(rows)
            got_on = select_candidates(torch.as_tensor(key), 64, stall, seed_mask=m,
                                       compact_pool=1024)
            got_off = select_candidates(torch.as_tensor(key), 64, stall, seed_mask=m)
            for j, got in enumerate((got_on, got_off) * 2):
                np.testing.assert_array_equal(got[0].view(torch.int32).numpy(),
                                              row[j][0].view(np.int32), err_msg=tag)
                np.testing.assert_array_equal(got[1].numpy(), row[j][1], err_msg=tag)
            live = got_off[0] > -torch.inf
            assert torch.equal(got_on[1][live], got_off[1][live])
    assert pool_branch_counts() == {"pooled": 6, "full": 4}


@pytest.fixture(scope="module")
def planted(ref):
    """The port's env and state of the reference's planted 779 cluster."""
    from cruise_control_tpu_torch import convert
    p = ref["masks"]["planted"]
    return convert.env_from_arrays(p["env"], "cpu"), convert.state_from_arrays(p["state"], "cpu")


def test_rooms_exactly_reproduce_accept_move_masks(ref, planted):
    """Each interval-form goal's ``accept_move`` (its per-goal terms and
    source rows) equals the reference's on every valid row, band-edge rows
    included; so do its rooms. The planted edges land on both sides of the
    bound."""
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    env, st = planted
    cand = torch.arange(env.num_replicas)
    d = engine.move_delta_rows(env, st, cand)
    valid = env.replica_valid.numpy()
    for g in make_goals(INTERVAL):
        got = g.accept_move(env, st, cand).numpy()
        np.testing.assert_array_equal(got[valid], ref["masks"]["accept"][g.name][valid],
                                      err_msg=g.name)
        rooms, _c, _t = engine._chain_move_vetoes((g,), env, st)
        m = move_mask(env, st, rooms, d, cand)
        np.testing.assert_array_equal(m[valid], ref["masks"]["rooms"][g.name][valid],
                                      err_msg=g.name)
    cells = ref["masks"]["planted"]["cells"]
    edge = [ref["masks"]["accept"][g][r, b] for g in ref["masks"]["accept"] for r, b in cells]
    assert any(edge) and not all(edge)


def move_mask(env, st, rooms, d, cand) -> np.ndarray:
    """bool[K, B] of folded rooms (the reference's ``_rooms_move_mask``)."""
    src_b = st.replica_broker[cand]
    K, B = cand.shape[0], env.num_brokers
    ok = torch.ones((K, B), dtype=torch.bool)
    for dim, (s, dr) in rooms.items():
        dd = d[:, dim]
        ex = (dd == 0) if dim == 5 else torch.zeros_like(dd, dtype=torch.bool)
        if s is not None:
            ok = ok & ((dd <= s[src_b]) | ex)[:, None]
        if dr is not None:
            ok = ok & ((dd[:, None] <= dr[None, :]) | ex[:, None])
    return ok.numpy()


def test_combined_rooms_match_sequential_masks(ref, planted):
    """The folded rooms of a five-goal chain and the folded terms of the
    same chain (K2's per-goal form) equal the AND of the per-goal masks."""
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    env, st = planted
    cand = torch.arange(env.num_replicas)
    goals = tuple(make_goals(COMBINED))
    d = engine.move_delta_rows(env, st, cand)
    valid = env.replica_valid.numpy()
    rooms, custom, _t = engine._chain_move_vetoes(goals, env, st)
    assert not custom
    np.testing.assert_array_equal(move_mask(env, st, rooms, d, cand)[valid],
                                  ref["masks"]["combined_rooms"][valid])
    want = np.ones_like(ref["masks"]["combined_rooms"])
    for g in goals:
        want &= g.accept_move(env, st, cand).numpy()
    src_goals, dims = engine._fold_move_terms(goals, env, st)
    got = np.ones_like(want)
    for g in src_goals:
        got &= g.accept_move_source(env, st, cand).numpy()[:, None]
    for dim, (lhs, bound) in dims.items():
        dd = d[:, dim:dim + 1]
        ok = (lhs[None, :] + dd) <= bound[None, :]
        got &= (ok | (dd == 0) if dim == 5 else ok).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])


def test_per_goal_k2_twin_matches_reference_masked_score(ref, planted):
    """K2's twin in its per-goal form (T = B: one class per broker) over
    every replica: the reference's ``legit_move_mask`` AND every previous
    goal's ``accept_move``, then the active goal's score, bit for bit, the
    planted band-edge rows included."""
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.kernels import move_score_classes
    env, st = planted
    R, B = env.num_replicas, env.num_brokers
    cand = torch.arange(R)
    goal = make_goals([SCORE_GOAL])[0]
    prev = tuple(make_goals(SCORE_PREV))
    rooms, custom, terms = engine._chain_move_vetoes(prev, env, st, chain_cache=False)
    assert not rooms and [g.name for g in custom] == ["RackAwareGoal"]
    assert len(terms[1]) == 7      # dims 0-6: three fold two or more goals each
    args = engine._score_args(env, st, goal, rooms, custom, cand,
                              torch.zeros(R), engine.move_delta_rows(env, st, cand), B,
                              terms=terms)
    val, q = move_score_classes(*args)
    assert not q.any()
    valid = env.replica_valid.numpy()
    np.testing.assert_array_equal(val.numpy().view(np.int32)[valid],
                                  ref["masks"]["score"].view(np.int32)[valid])
    assert np.isfinite(ref["masks"]["score"][valid]).any()


def test_single_action_state_ops_match_reference(ref):
    """``apply_move``, ``apply_leadership`` and ``apply_swap`` on fixture16,
    enabled and disabled, against the reference's under ``jax.jit``: every
    leaf bit for bit (the residuals in the loop programs' fold); disabled,
    the state is unchanged; ``no_op_move`` returns the state itself."""
    from cruise_control_tpu_torch import convert
    from cruise_control_tpu_torch.analyzer import state as S
    o = ref["masks"]["ops"]
    env = convert.env_from_arrays(o["env"], "cpu")
    st = convert.state_from_arrays(o["state"], "cpu")
    fns = {"move": S.apply_move, "lead": S.apply_leadership, "swap": S.apply_swap}
    assert o["noop"] and S.no_op_move(st) is st
    assert S.state_index_dtypes(env) == (torch.int64, torch.int64, torch.int32)
    for (op, a, b, en), want in o["results"].items():
        got = fns[op](env, st, a, b, torch.tensor(en))
        for f in dataclasses.fields(got):
            g = getattr(got, f.name).numpy()
            w = np.asarray(want[f.name])
            if g.dtype.kind == "f":
                np.testing.assert_array_equal(g.view(np.int32), w.astype(np.float32).view(
                    np.int32), err_msg=f"{op} {a} {b} {en} {f.name}")
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=f"{op} {a} {b} {en} {f.name}")
            if not en:
                assert torch.equal(getattr(got, f.name), getattr(st, f.name)), f.name


# ---------------------------------------------------------------------------
# The fleet: optimizations_batched over four tenants, lane by lane its solo
# ---------------------------------------------------------------------------
BATCH_SEEDS = (11, 12, 13, 14)
BATCH_GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal",
               "LeaderReplicaDistributionGoal", "DiskUsageDistributionGoal"]
# each case: (goals, EngineParams fields); the pooled keying with a pool
# below the tenants' R, so the lanes choose their branches
BATCH_CASES = {
    "compact keying": (BATCH_GOALS, dict(compact_keying=True, compact_pool=16,
                                         num_candidates=8)),
    "chain cache off": (BATCH_GOALS, dict(chain_cache=False)),
    "non-budget goal": (["ReplicaDistributionGoal", "NoLeaderBudgetGoal",
                         "LeaderReplicaDistributionGoal"], None),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batched_lanes_equal_solo_runs(case, monkeypatch):
    """``optimizations_batched`` over four same-bucket tenants with the
    pooled keying, with the per-goal accept masks and with a goal that has
    no wave budgets (the fallbacks lane by lane): every lane's result is
    its solo run's (verdicts, per-goal counts, assignment)."""
    from cruise_control_tpu_torch import fleet_script as fs
    from cruise_control_tpu_torch.analyzer.engine import EngineParams
    from cruise_control_tpu_torch.analyzer.goals import GOAL_CLASSES
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from test_torch_slice import _NoLeaderBudgetGoal
    monkeypatch.setitem(GOAL_CLASSES, "NoLeaderBudgetGoal", _NoLeaderBudgetGoal)
    goals, params = BATCH_CASES[case]
    ns = fs.port_fleet_ns("cpu")

    def sessions():
        out = []
        for s in BATCH_SEEDS:
            cc = ns["CruiseControl"](fs.tenant_backend(ns, s), config=fs._cfg(ns), device="cpu")
            fs._sample(cc)
            cc.resident_session.sync()
            out.append(cc.resident_session)
        return out

    from cruise_control_tpu_torch.analyzer import lanes as lanes_mod
    from cruise_control_tpu_torch.kernels import pool_branch_counts, reset_pool_branches
    terms_launches = []
    k2_lanes = lanes_mod.move_score_classes_lanes

    def spy(lane_args):
        terms_launches.append(lane_args[0][19] is not None)
        return k2_lanes(lane_args)

    monkeypatch.setattr(lanes_mod, "move_score_classes_lanes", spy)
    opt = GoalOptimizer(device="cpu", engine_params=EngineParams(**params) if params else None)
    reset_pool_branches()
    lanes = opt.optimizations_batched(sessions(), goal_names=goals)
    branches = pool_branch_counts()
    solo = [opt.optimizations(None, session=s, goal_names=goals, raise_on_failure=False,
                              skip_hard_goal_check=True) for s in sessions()]
    for a, b in zip(lanes, solo):
        _same(outcome(a), outcome(b), case)
    assert any(g.iterations for r in lanes for g in r.goal_results)
    if params and params.get("compact_keying"):
        assert branches["pooled"] > 0, branches
    # the move waves ran on K2's lane form, per-goal exactly when the cache
    # is off; a chain behind a non-budget goal moves lane by lane
    assert any(terms_launches) == (case == "chain cache off")
    assert all(terms_launches) == (case == "chain cache off") or not terms_launches


def test_config_keys_reach_the_engine():
    """``GoalOptimizer(config=...)`` maps ``analyzer.compact.keying`` and
    ``analyzer.chain.cache`` onto its engine parameters, and the request
    runs (both raised ``NotImplementedError`` before the options were
    ported): the same outcome as the optimizer given those parameters."""
    from __graft_entry__ import _fixture_cluster

    from cruise_control_tpu_torch import convert
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.config import cruise_control_config
    ct, meta = _fixture_cluster()
    ct, meta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    cfg = cruise_control_config({"analyzer.compact.keying": True,
                                 "analyzer.chain.cache": False})
    opt = GoalOptimizer(config=cfg, device="cpu")
    p = opt.scaled_params(ct.num_replicas, ct.num_brokers)
    assert p.compact_keying and not p.chain_cache
    kw = dict(goal_names=CHAIN, raise_on_failure=False, skip_hard_goal_check=True)
    got = outcome(opt.optimizations(ct, meta, **kw))
    same = GoalOptimizer(config=cruise_control_config({}), device="cpu",
                         engine_params=opt._params)
    _same(got, outcome(same.optimizations(ct, meta, **kw)), "config")
