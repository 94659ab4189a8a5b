"""The swap branch (K7) of the port against the JAX package.

On one state of the 32-broker skewed cluster (the slice test's spec, four
topics flagged for MinTopicLeadersPerBrokerGoal so its row vetoes bite,
the largest topic's replicas crowded onto brokers 0-7 so
TopicReplicaDistributionGoal has work), with the sixteen default goals,
every comparison exact (indices, ints and bools equal, floats
bit-identical; tolerance 0):

- each swap goal's keys, candidate pools and ``swap_score``;
- ``legit_swap_mask`` and every goal's ``accept_swap`` as a previous goal;
- ``kernels.swap_rows`` (plain twin) against the reference's ``_swap_rows``
  (engine.py:1129-1141) with the goal's default-chain prefix, and its
  positive counts (the window clause);
- ``kernels.swap_admission`` against the reference's ``.at[].min``
  admission (engine.py:1146-1177) on planted collisions;
- ``apply_swaps_batched`` and one whole ``_swap_branch_batched`` pass.

Whole goal programs run the reference in a fresh interpreter
(torch_reference.py): the forced finisher at DiskUsageDistributionGoal
(its swap window reads 183), the swap tail on a hand-built fixture where
only swaps can move load, and ``__graft_entry__.entry()``'s run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import engine as ref_engine
from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goals as ref_make_goals
from cruise_control_tpu.analyzer.goals.base import legit_swap_mask
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer import state as state_mod
from cruise_control_tpu_torch.analyzer.env import BalancingConstraint, make_env
from cruise_control_tpu_torch.analyzer.goals import make_goal, make_goals
from cruise_control_tpu_torch.analyzer.goals.base import swap_pairs
from cruise_control_tpu_torch.analyzer.optimizer import DEFAULT_GOALS, GoalOptimizer
from cruise_control_tpu_torch.analyzer.state import init_state
from cruise_control_tpu_torch.kernels import swap as swap_k
from cruise_control_tpu_torch.kernels import swap_admission, swap_rows
from torch_reference import one_torch_thread, reference_goal, swap_tail_cluster

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SPEC = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
            max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
SWAP_GOALS = [i for i, n in enumerate(DEFAULT_GOALS) if n in (
    "DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal")]
K = 32          # num_swap_candidates at this size (max(32, 32 // 32))
MIN_GAIN = 1e-9
# CpuCapacityGoal is violated at this state and its net-aware veto rejects
# every swap of the pools; "open" drops it from the previous goals so the
# pair scores and admissions are not all -inf
PREFIXES = ["default", "open"]


def prefix(goals, i, which):
    return tuple(g for g in goals[:i]
                 if which == "default" or g.name != "CpuCapacityGoal")


@pytest.fixture(scope="module")
def ctx():
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    tml = np.zeros(ct.num_topics, bool)
    tml[:4] = True
    renv = ref_env_mod.make_env(ct, meta, topic_min_leaders_mask=tml)
    rb = np.array(ct.replica_broker)
    table = np.asarray(renv.partition_replicas)
    topic = np.asarray(renv.partition_topic)
    for p in np.flatnonzero(topic == np.bincount(topic).argmax()):
        for f, r in enumerate(table[p]):
            if r >= 0:
                rb[r] = (3 * p + f) % 8
    rst = ref_state_mod.init_state(renv, rb, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    return dict(renv=renv, rst=rst,
                penv=convert.env_from_arrays(convert.leaves(renv), "cpu"),
                pst=convert.state_from_arrays(convert.leaves(rst), "cpu"),
                rgoals=ref_make_goals(DEFAULT_GOALS), pgoals=make_goals(DEFAULT_GOALS))


def bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.int32)


def same(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.array_equal(bits(a), bits(b))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def ref_pools(ctx, i, stall=0):
    """The reference's out and in pools (engine.py:1122-1125)."""
    renv, rst, goal = ctx["renv"], ctx["rst"], ctx["rgoals"][i]
    sev = goal.broker_severity(renv, rst)
    p = ref_engine.EngineParams()
    okv, co = ref_engine._select_candidates(goal.swap_out_key(renv, rst, sev), K,
                                            jnp.int32(stall), goal.is_hard, p)
    ikv, ci = ref_engine._select_candidates(goal.swap_in_key(renv, rst, sev), K,
                                            jnp.int32(stall), goal.is_hard, p, salt=101)
    return okv, co, ikv, ci


def port_pools(ctx, i, stall=0):
    goal = ctx["pgoals"][i]
    return engine._swap_pools(ctx["penv"], ctx["pst"], goal, engine.EngineParams(),
                              goal.broker_severity(ctx["penv"], ctx["pst"]), stall)


def random_pairs(ctx, seed, n=96):
    valid = np.flatnonzero(np.asarray(ctx["renv"].replica_valid))
    rng = np.random.default_rng(seed)
    return (rng.choice(valid, n, replace=False).astype(np.int32),
            rng.choice(valid, n, replace=False).astype(np.int32))


@pytest.mark.parametrize("i", SWAP_GOALS, ids=[DEFAULT_GOALS[i] for i in SWAP_GOALS])
@pytest.mark.parametrize("stall", [0, 3])
def test_swap_keys_pools_and_score(ctx, i, stall):
    rg, pg = ctx["rgoals"][i], ctx["pgoals"][i]
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    sev_r, sev_p = rg.broker_severity(renv, rst), pg.broker_severity(penv, pst)
    assert same(sev_r, sev_p)
    assert same(rg.swap_out_key(renv, rst, sev_r), pg.swap_out_key(penv, pst, sev_p))
    assert same(rg.swap_in_key(renv, rst, sev_r), pg.swap_in_key(penv, pst, sev_p))
    okv, co, ikv, ci = ref_pools(ctx, i, stall)
    pokv, pco, pikv, pci = port_pools(ctx, i, stall)
    for a, b in ((okv, pokv), (co, pco), (ikv, pikv), (ci, pci)):
        assert same(a, b)
    ref = rg.swap_score(renv, rst, co, ci)
    assert same(ref, pg.swap_score(penv, pst, pco, pci))
    assert np.isfinite(np.asarray(ref)).any()        # some pair scores


@pytest.mark.parametrize("seed", [0, 1])
def test_legit_swap_mask(ctx, seed):
    co, ci = random_pairs(ctx, seed)
    ref = legit_swap_mask(ctx["renv"], ctx["rst"], jnp.asarray(co), jnp.asarray(ci))
    pairs = swap_pairs(ctx["penv"], ctx["pst"], torch.as_tensor(co).long(),
                       torch.as_tensor(ci).long(), ())
    assert same(ref, swap_k.legit_plain(pairs))
    assert np.asarray(ref).any() and not np.asarray(ref).all()


@pytest.mark.parametrize("i", range(len(DEFAULT_GOALS)), ids=DEFAULT_GOALS)
def test_accept_swap(ctx, i):
    """Every goal's accept_swap as a previous goal, on random pairs and on
    the DiskUsageDistributionGoal pools."""
    rg, pg = ctx["rgoals"][i], ctx["pgoals"][i]
    co, ci = random_pairs(ctx, i)
    _okv, pco, _ikv, pci = ref_pools(ctx, SWAP_GOALS[0])
    for a, b in ((co, ci), (np.array(pco), np.array(pci))):
        ref = rg.accept_swap(ctx["renv"], ctx["rst"], jnp.asarray(a), jnp.asarray(b))
        port = pg.accept_swap(ctx["penv"], ctx["pst"], torch.as_tensor(a).long(),
                              torch.as_tensor(b).long())
        assert same(ref, port)


def ref_swap_rows(ctx, i, which, co, okv, ci, ikv):
    """engine.py:1129-1141 (``_swap_rows``) and the window's counts
    (:1414-1420), exact f32 mode."""
    renv, rst, goals = ctx["renv"], ctx["rst"], ctx["rgoals"]
    m = legit_swap_mask(renv, rst, co, ci)
    for g in prefix(goals, i, which):
        m = m & g.accept_swap(renv, rst, co, ci)
    sc = goals[i].swap_score(renv, rst, co, ci)
    sc = jnp.where(m & (okv > -jnp.inf)[:, None] & (ikv > -jnp.inf)[None, :], sc,
                   -jnp.inf)
    bj = jnp.argmax(sc, axis=1)
    return (np.asarray(sc[jnp.arange(co.shape[0]), bj]), np.asarray(bj),
            np.asarray(jnp.sum(sc > MIN_GAIN, axis=1)))


@pytest.mark.parametrize("i", SWAP_GOALS, ids=[DEFAULT_GOALS[i] for i in SWAP_GOALS])
@pytest.mark.parametrize("stall", [0, 3])
@pytest.mark.parametrize("which", PREFIXES)
def test_swap_rows_twin(ctx, i, stall, which):
    okv, co, ikv, ci = ref_pools(ctx, i, stall)
    ref = ref_swap_rows(ctx, i, which, co, okv, ci, ikv)
    pokv, pco, pikv, pci = port_pools(ctx, i, stall)
    pairs, tables = engine._swap_args(ctx["penv"], ctx["pst"], ctx["pgoals"][i],
                                      prefix(ctx["pgoals"], i, which), pco, pokv, pci,
                                      pikv)
    port = swap_rows(pairs, tables, MIN_GAIN)
    for a, b in zip(ref, port):
        assert same(a, b)
    if which == "open":
        assert int(port[2].sum()) > 0                 # the window has positives


def ref_admission(val, b_out, b_in, j, p_out, p_in, B, K2, P):
    """engine.py:1146-1177 on score-sorted rows."""
    n = val.shape[0]
    posn = jnp.arange(n, dtype=jnp.int32)
    inf = jnp.int32(n + 1)
    wave_ok = val > MIN_GAIN
    guarded = jnp.where(wave_ok, posn, inf)
    first_b = jnp.full(B, inf, jnp.int32).at[b_out].min(guarded).at[b_in].min(guarded)
    ok_b = (first_b[b_out] == posn) & (first_b[b_in] == posn)
    first_in = jnp.full(K2, inf, jnp.int32).at[j].min(guarded)
    ok_in = first_in[j] == posn
    first_p = jnp.full(P, inf, jnp.int32).at[p_out].min(guarded).at[p_in].min(guarded)
    ok_p = (first_p[p_out] == posn) & (first_p[p_in] == posn)
    return np.asarray(wave_ok & ok_b & ok_in & ok_p)


@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swap_admission_planted_collisions(n, seed):
    """Crowded brokers, in-candidates and partitions, tied and -inf values:
    an earlier eligible row blocks a later one even when it lost itself."""
    rng = np.random.default_rng(seed)
    B, K2, P = 40, 24, 60
    val = rng.choice([0.5, 1.0, 2.0, -np.inf, 1e-10], n).astype(np.float32)
    val = -np.sort(-val, kind="stable")
    cols = [rng.integers(0, B // 4, n), rng.integers(B // 4, B, n),
            rng.integers(0, K2, n), rng.integers(0, P, n), rng.integers(0, P, n)]
    ref = ref_admission(jnp.asarray(val), *(jnp.asarray(c, jnp.int32) for c in cols),
                        B, K2, P)
    port = swap_admission(torch.as_tensor(val), *(torch.as_tensor(c) for c in cols),
                          MIN_GAIN)
    assert same(ref, port)
    assert 0 < int(port.sum()) < int((val > MIN_GAIN).sum())


def test_apply_swaps_batched_bitwise(ctx):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rng = np.random.default_rng(7)
    B = renv.num_brokers
    rb = np.asarray(rst.replica_broker)
    part = np.asarray(renv.replica_partition)
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    # disjoint brokers and partitions, as the admission guarantees
    out, inn, used_b, used_p = [], [], set(), set()
    for r in rng.permutation(valid):
        if rb[r] in used_b or part[r] in used_p:
            continue
        if len(out) == len(inn):
            out.append(r)
        else:
            inn.append(r)
        used_b.add(rb[r])
        used_p.add(part[r])
        if len(inn) == B // 4:
            break
    r_out, r_in = np.asarray(out[:len(inn)], np.int32), np.asarray(inn, np.int32)
    mask = rng.random(len(inn)) < 0.75
    ref = ref_state_mod.apply_swaps_batched(renv, rst, jnp.asarray(r_out),
                                            jnp.asarray(r_in), jnp.asarray(mask))
    port = state_mod.apply_swaps_batched(penv, pst, torch.as_tensor(r_out).long(),
                                         torch.as_tensor(r_in).long(),
                                         torch.as_tensor(mask))
    for name, a in convert.leaves(ref).items():
        assert same(a, convert.leaves(port)[name]), name
    assert int(mask.sum()) > 0


@pytest.mark.parametrize("i", [SWAP_GOALS[0], SWAP_GOALS[3], SWAP_GOALS[4]],
                         ids=[DEFAULT_GOALS[SWAP_GOALS[k]] for k in (0, 3, 4)])
def test_swap_branch_pass(ctx, i):
    """One whole _swap_branch_batched pass: pools, rows, sort, admission,
    two-leg apply (the "open" prefix, so the pass lands swaps)."""
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rg, pg = ctx["rgoals"], ctx["pgoals"]
    rparams = ref_engine.EngineParams()
    ref_st, ref_n = ref_engine._swap_branch_batched(
        renv, rst, rg[i], prefix(rg, i, "open"), rparams,
        rg[i].broker_severity(renv, rst), jnp.int32(0))
    port_st, port_n = engine._swap_branch_batched(
        penv, pst, pg[i], prefix(pg, i, "open"), engine.EngineParams(),
        pg[i].broker_severity(penv, pst), 0)
    assert int(ref_n) == int(port_n) > 0
    for name, a in convert.leaves(ref_st).items():
        assert same(a, convert.leaves(port_st)[name]), name


# --- whole goal programs (the reference in a fresh interpreter) -------------
def _port_goal(ct, meta, case):
    pct, pmeta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    env = make_env(pct, pmeta, device="cpu")
    st = init_state(env, pct.replica_broker, pct.replica_is_leader,
                    pct.replica_offline, pct.replica_disk)
    c = BalancingConstraint(**case.get("constraint", {}))
    goal = make_goal(case["goal"], c)
    prev = tuple(make_goal(n, c) for n in case.get("prev", []))
    if case.get("scaled"):
        params = dataclasses.replace(
            GoalOptimizer(device="cpu").scaled_params(env.num_replicas, env.num_brokers),
            **case["params"])
    else:
        params = engine.EngineParams(**case["params"])
    st2, info = engine.optimize_goal(env, st, goal, prev, params)
    return env, st2, goal, prev, params, info


# the goal's stat is a float report (and the plateau exit's input): inside
# the reference's one monolithic XLA program its 32-broker sum may take
# another order than the per-call sum the port reproduces, so the two stat
# fields are held to 1e-6 relative; every other field and the final state
# exactly
STATS = ("stat_before", "stat")


def _same_run(ref, st2, info):
    assert {k: info[k] for k in ref["info"] if k not in STATS} == {
        k: v for k, v in ref["info"].items() if k not in STATS}
    for k in STATS:
        assert info[k] == pytest.approx(ref["info"][k], rel=1e-6), k
    for name, a in ref["final"].items():
        assert same(a, getattr(st2, name)), name


def test_forced_finisher_swap_window(tmp_path):
    """DiskUsageDistributionGoal with the default prefix as previous goals,
    ``max_iters=2`` and the finisher forced on at the 32-broker spec: the
    swap window holds 183 accepted positive swaps at the exit state (the
    move scans are not drained, so the swap tail applies nothing)."""
    case = dict(cluster=SPEC, goal="DiskUsageDistributionGoal",
                prev=DEFAULT_GOALS[:SWAP_GOALS[0]], scaled=True,
                params=dict(max_iters=2, finisher_rounds=12, max_finisher_rounds=12))
    ref = reference_goal(tmp_path, case)
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    env, st2, goal, prev, params, info = _port_goal(ct, meta, case)
    _same_run(ref, st2, info)
    assert (info["iterations"], info["finisher_rounds"],
            info["swap_window_remaining"]) == (68, 2, 183)
    assert engine._swap_window_positives(env, st2, goal, prev, params) == 183


def test_finisher_swap_tail_lands_swaps(tmp_path):
    """``swap_tail_cluster()``: ReplicaCapacityGoal (max 6 replicas per
    broker, every broker full) vetoes every move, so after one budgeted
    pass the finisher's scans read zero moves and its swap tail balances
    disk by swaps alone."""
    case = dict(cluster="swap_tail", goal="DiskUsageDistributionGoal",
                prev=["ReplicaCapacityGoal"], constraint=dict(max_replicas_per_broker=6),
                params=dict(max_iters=1))
    ref = reference_goal(tmp_path, case)
    assert ref["info"]["moves_remaining"] == 0 and ref["info"]["finisher_actions"] > 0
    assert ref["info"]["move_actions"] == 0
    _env, st2, _g, _p, _params, info = _port_goal(*swap_tail_cluster(), case)
    _same_run(ref, st2, info)
    assert not info["violated_after"]


def test_entry_milestone(tmp_path):
    """``__graft_entry__.entry()``: DiskUsageDistributionGoal with
    ``EngineParams(max_iters=64)`` on ``_setup()``'s 16-broker fixture (the
    reference's jitted ``_compiled_optimize``); the port's
    ``optimize_goal`` gives the same util bits and ``violated_after``."""
    from __graft_entry__ import _fixture_cluster
    case = dict(cluster="fixture16", goal="DiskUsageDistributionGoal", compiled=True,
                params=dict(max_iters=64))
    ref = reference_goal(tmp_path, case)
    _env, st2, _g, _p, _params, info = _port_goal(*_fixture_cluster(), case)
    assert same(ref["final"]["util"], st2.util)
    assert info["violated_after"] is ref["info"]["violated_after"] is False
    assert st2.util[:, 3].tolist() == [5630, 5660, 5670, 5660, 5660, 5680, 5660, 5660,
                                       5010, 4950, 4860, 4950, 4920, 4910, 4910, 4940]
    assert float(st2.util.sum()) == 105674.0
