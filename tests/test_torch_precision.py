"""The port's precision policy (bf16 score sweeps) against the JAX package.

At 262,144 replicas or more ``compute_dtype="auto"`` resolves to bf16
(``optimizer._resolve_compute_dtype``): the [R, M] leader / follower load
tables the scoring sweeps read are bf16 (``engine._sweep_env``) and the
broker accumulators they difference are the compensated f32 sums
(``engine._sweep_state``). The reference computes its bf16 expressions in
f32 inside its XLA:CPU program and rounds where it materializes a bf16
array; the port upcasts at the load, computes in f32 and rounds at the same
points. The loads here are not integers (integers up to 256 are exact in
bf16 and would hide every rounding), every comparison is exact (floats as
bits, tolerance 0):

- "auto" resolves to bf16 at 262,144 replicas and to f32 at 262,143, as in
  the reference, and the scaled parameters at rung 4's padded shape are the
  reference's (T 71, which does not divide B 7,168; KL 896; pools clamped
  at 128; four waves a pass);
- both views are identities under f32 and "auto", and equal the reference's
  under bf16;
- every candidate-key function of every goal (the K1 keying kernel's twin
  for the families it computes, plain torch for the others) equals the
  reference's on the bf16 view and on the f32 env, on a state made with
  numpy from a seed: loads from values whose leader - follower differences
  fall halfway between bf16 neighbours, zeros of both signs, ties, offline
  rows, -inf rows, severities of both signs and both zeros;
- the leadership scores round where the reference's program does: a
  candidate's leader - follower delta (bf16 - bf16) is rounded to bf16
  before its broadcast, the members' deltas are not, the capacity score is
  a bf16 array: K6's twin equals the reference's ``leadership_score`` on
  the bf16 view, and the unrounded f32 values give other bits;
- whole chains under ``compute_dtype="bfloat16"`` against the reference
  pinned the same way, from a fresh interpreter (torch_reference.py): the
  sixteen goals on spec-32b and mid-64b, the ten-goal JBOD chain on
  jbod-32b, and (``slow``) on slice-1000b and jbod-1000b (counts,
  certificates, swap and disk actions, final assignment, the compensated
  accumulators' bits);
- the port's bf16 against its own f32 on the reference's seed-777 cluster
  under the reference's contract (tests/test_dtype_policy.py): the same
  violated goals and certificates; the explicit f32 policy bit for bit the
  default;
- the sixteen goals with ``pass_waves=4`` and with ``num_dst_choices=5``
  (not a divisor of B: K2's padded ``Bp`` path) against the reference, the
  small oracle of rung 4's multi-wave and padded paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import engine as ref_engine
from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goals as ref_make_goals
from cruise_control_tpu.analyzer.goals.base import GoalKernel as RefGoalKernel
from cruise_control_tpu.analyzer.goals.base import legit_leadership_mask
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as RefGoalOptimizer
from cruise_control_tpu.analyzer.optimizer import _resolve_compute_dtype as ref_resolve
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer.engine import EngineParams
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.analyzer.optimizer import (
    BF16_AUTO_MIN_REPLICAS, DEFAULT_GOALS, GoalOptimizer, _resolve_compute_dtype,
)
from cruise_control_tpu_torch.kernels import leadership as lead_k
from cruise_control_tpu_torch.model import random_cluster as port_rc
from torch_reference import (
    background_reference, chains_job, one_torch_thread, reference_chain,
    start_background_reference,
)

JBOD_SMALL = dict(num_brokers=32, num_racks=4, num_topics=8, num_partitions=1000,
                  max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
                  target_cpu_util=0.45, num_dead_brokers=1, num_brokers_with_dead_disk=2)
SMALL = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
             max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
MID = dict(num_brokers=64, num_racks=4, num_topics=8, num_partitions=8000,
           max_replication=3, seed=3)
JBOD_CHAIN = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
              "DiskCapacityGoal", "NetworkInboundCapacityGoal",
              "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
              "IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
KEY_GOALS = (["RackAwareGoal", "RackAwareDistributionGoal"] + DEFAULT_GOALS[1:]
             + ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"])
KEY_FNS = ("replica_key", "leader_key", "swap_out_key", "swap_in_key")
# (goal, key function) of every key a goal defines
KEY_CASES = [(g.name, fn) for g in ref_make_goals(KEY_GOALS) for fn in KEY_FNS
             if getattr(type(g), fn) is not getattr(RefGoalKernel, fn)]
LEAD_GOALS = ["CpuCapacityGoal", "NetworkOutboundCapacityGoal",
              "CpuUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
              "LeaderBytesInDistributionGoal", "LeaderReplicaDistributionGoal"]
# load values: leader - follower differences such as 2.015625 - 0.0078125
# fall halfway between bf16 neighbours
LEAD_VALUES = np.array([2.015625, 3.0, 1.0, 0.0, -0.0, 517.25, 0.3], np.float32)
FOLL_VALUES = np.array([0.0078125, 0.00390625, 0.0, -0.0, 2.015625, 0.1], np.float32)
BF16 = EngineParams(compute_dtype="bfloat16")
REF_BF16 = ref_engine.EngineParams(compute_dtype="bfloat16")


_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def bits(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def ctx():
    """One jbod-32b state (a dead broker, two dead disks; the spec's loads
    are not integers) changed with seed 7: a quarter of the rows' loads from
    ``LEAD_VALUES`` / ``FOLL_VALUES``, ties copied between rows, zeros of
    both signs; a tenth of the valid replicas offline; random Kahan
    residuals; severities from {-1, -0.0, 0, 0.5, 2}."""
    rng = np.random.default_rng(7)
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(
        ref_rc.RandomClusterSpec(**JBOD_SMALL)))
    renv = ref_env_mod.make_env(ct, meta)
    R, M = renv.leader_load.shape
    valid = np.asarray(renv.replica_valid)
    lead = np.array(renv.leader_load)
    foll = np.array(renv.follower_load)
    planted = rng.random(R) < 0.25
    lead[planted] = rng.choice(LEAD_VALUES, (int(planted.sum()), M))
    foll[planted] = rng.choice(FOLL_VALUES, (int(planted.sum()), M))
    src, dst = rng.choice(R, 64), rng.choice(R, 64)
    lead[dst], foll[dst] = lead[src], foll[src]          # ties
    for arr in (lead, foll):
        arr[rng.random((R, M)) < 0.02] = 0.0
        arr[rng.random((R, M)) < 0.02] = -0.0
        arr[~valid] = 0.0
    renv = dataclasses.replace(renv, leader_load=jnp.asarray(lead),
                               follower_load=jnp.asarray(foll))
    offline = np.asarray(ct.replica_offline) | (valid & (rng.random(R) < 0.1))
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   offline, ct.replica_disk)
    B = rst.util.shape[0]
    res = (rng.standard_normal((B, M)) * 1e-2).astype(np.float32)
    lres = (rng.standard_normal((B, M)) * 1e-2).astype(np.float32)
    rst = dataclasses.replace(rst, util_residual=jnp.asarray(res),
                              leader_util_residual=jnp.asarray(lres))
    sev = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 2.0], np.float32), B)
    return dict(renv=renv, rst=rst, sev=sev,
                penv=convert.env_from_arrays(convert.leaves(renv), "cpu"),
                pst=convert.state_from_arrays(convert.leaves(rst), "cpu"))


# --- the resolution and the scaled parameters -------------------------------
@pytest.mark.parametrize("n, want", [(262_143, "float32"), (262_144, "bfloat16")])
def test_auto_resolves_at_262144_replicas(n, want):
    assert BF16_AUTO_MIN_REPLICAS == 262_144
    assert _resolve_compute_dtype("auto", n) == ref_resolve("auto", None, n) == want
    assert GoalOptimizer(device="cpu").scaled_params(n, 7168).compute_dtype == want
    for pinned in ("float32", "bfloat16"):
        assert _resolve_compute_dtype(pinned, n) == pinned


def test_scaled_params_at_rung4_shape():
    """Rung 4's padded shape (R 1,048,576, B 7,168: 7,000 brokers pad to
    7,168): every scaled field is the reference's; T = 7,168 // 100 = 71 does
    not divide B, so K2 pads to Bp 7,171."""
    port = GoalOptimizer(device="cpu").scaled_params(1_048_576, 7168)
    ref = RefGoalOptimizer().scaled_params(1_048_576, 7168)
    for f in dataclasses.fields(port):
        if f.name != "mesh":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (port.num_dst_choices, port.num_leader_candidates, port.pass_waves,
            port.compute_dtype) == (71, 896, 4, "bfloat16")
    assert 7168 % port.num_dst_choices != 0
    assert min(port.num_swap_candidates, 1_048_576, 128) == 128


# --- the sweep views ---------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "auto"])
def test_sweep_views_are_identities(ctx, dtype):
    env, st = ctx["penv"], ctx["pst"]
    p = EngineParams(compute_dtype=dtype)
    env_sw = engine._sweep_env(env, p)
    assert env_sw is env and env_sw.sweep_loads is None
    assert engine._sweep_state(st, p) is st
    env_k, st_k = engine._sweep_view(env, st, env_sw)
    assert env_k is env and st_k is st
    env_k, st_k = engine._sweep_view(env, st, None)
    assert env_k is env and st_k is st


def test_sweep_views_match_reference_under_bf16(ctx):
    env_sw = engine._sweep_env(ctx["penv"], BF16)
    st_sw = engine._sweep_state(ctx["pst"], BF16)
    renv_sw = ref_engine._sweep_env(ctx["renv"], REF_BF16)
    rst_sw = ref_engine._sweep_state(ctx["rst"], REF_BF16)
    for i, name in enumerate(("leader_load", "follower_load")):
        want = bits(np.asarray(getattr(renv_sw, name).astype(jnp.float32)))
        assert env_sw.sweep_loads[i].dtype == torch.bfloat16
        assert np.array_equal(bits(env_sw.sweep_loads[i]), want)
        assert np.array_equal(bits(getattr(env_sw, name)), want)
    for name in ("util", "leader_util"):
        assert np.array_equal(bits(getattr(st_sw, name)), bits(getattr(rst_sw, name)))
    # exact mode and the finisher keep the f32 env
    assert engine._sweep_view(ctx["penv"], ctx["pst"], None)[0] is ctx["penv"]


# --- every key function ------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name, fn", KEY_CASES, ids=[f"{n}.{f}" for n, f in KEY_CASES])
def test_keys_match_reference(ctx, name, fn, dtype):
    """The key as the reference's pass loop feeds it to top-k (through
    ``_stall_explore`` at stall 0, traced), bit for bit."""
    rg, pg = ref_make_goals([name])[0], make_goals([name])[0]
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    if dtype == "bfloat16":
        renv, rst = ref_engine._sweep_env(renv, REF_BF16), ref_engine._sweep_state(rst,
                                                                                   REF_BF16)
        penv, pst = engine._sweep_env(penv, BF16), engine._sweep_state(pst, BF16)
    sev = ctx["sev"]
    want = jax.jit(lambda e, s, v, stall: ref_engine._stall_explore(
        getattr(rg, fn)(e, s, v), stall))(renv, rst, jnp.asarray(sev), jnp.int32(0))
    got = getattr(pg, fn)(penv, pst, torch.from_numpy(sev))
    assert got.dtype == torch.float32
    assert np.array_equal(bits(got), bits(np.asarray(want)))


def test_keys_cover_offline_ties_and_zeros(ctx):
    """The state has what the key tests must see: offline rows with finite
    keys (the bump), -inf rows, ties and zeros of both signs in the keys."""
    penv, pst = engine._sweep_env(ctx["penv"], BF16), engine._sweep_state(ctx["pst"], BF16)
    sev = torch.from_numpy(ctx["sev"])
    cap = make_goals(["CpuCapacityGoal"])[0].replica_key(penv, pst, sev)
    assert bool((cap >= 5e11).any()) and bool((cap == -torch.inf).any())
    assert float(cap[cap >= 5e11].max()) == 1000727379968.0       # bf16(1e12)
    fin = cap[torch.isfinite(cap) & (cap < 5e11)]
    assert fin.unique().numel() < fin.numel()                      # ties
    swap_in = make_goals(["DiskUsageDistributionGoal"])[0].swap_in_key(penv, pst, sev)
    zeros = swap_in[swap_in == 0]
    assert bool(torch.signbit(zeros).any()) and bool((~torch.signbit(zeros)).any())


# --- the leadership scores' deltas ------------------------------------------
@pytest.mark.parametrize("name", LEAD_GOALS)
def test_lead_scores_round_where_the_reference_does(ctx, name):
    """K6's twin on the bf16 view equals the reference's per-row best of
    ``leadership_score(env_sw, st_sw)`` masked by ``legit_leadership_mask``
    (engine.py:1003-1013). Inside the reference's program a candidate's
    leader - follower delta is rounded to bf16 (the subtraction is
    materialized before its ``[:, None]``), the members' deltas are not
    (they enter ``util + delta`` unrounded), and the capacity score is a
    bf16 array; the same scores from the unrounded f32 values of the bf16
    loads differ, so this state tells the rounding points apart. Brokers 0-7 carry a
    compensation residual of twice their utilization plus 100 (the sweep
    view reads them far above their limits), and the candidates are their
    leaders, so the usage goals' scores are their deltas."""
    rg, pg = ref_make_goals([name])[0], make_goals([name])[0]
    renv, rst = ctx["renv"], ctx["rst"]
    boost = np.zeros(rst.util.shape, np.float32)
    boost[:8] = 2.0 * np.asarray(rst.util)[:8] + 100.0
    rst = dataclasses.replace(rst, util_residual=rst.util_residual + boost)
    penv, pst = ctx["penv"], convert.state_from_arrays(convert.leaves(rst), "cpu")
    renv_sw = ref_engine._sweep_env(renv, REF_BF16)
    rst_sw = ref_engine._sweep_state(rst, REF_BF16)
    col = getattr(rg, "resource", 1)
    d = (np.asarray(renv_sw.leader_load[:, col].astype(jnp.float32))
         - np.asarray(renv_sw.follower_load[:, col].astype(jnp.float32)))
    inexact = d != np.asarray(jnp.asarray(d).astype(jnp.bfloat16).astype(jnp.float32))
    leaders = (np.asarray(rst.replica_is_leader) & np.asarray(renv.replica_valid)
               & (np.asarray(rst.replica_broker) < 8))
    # leaders whose delta bf16 cannot hold first, then the others
    first = np.flatnonzero(leaders & inexact & (d > 0))[:64]
    rest = np.setdiff1d(np.flatnonzero(leaders), first)
    cand = np.concatenate([first, np.random.default_rng(11).choice(
        rest, 96 - first.shape[0], replace=False)]).astype(np.int64)

    def ref_best(e_sw):
        m = legit_leadership_mask(renv, rst, jnp.asarray(cand))
        sc = rg.leadership_score(e_sw, rst_sw, jnp.asarray(cand))
        return jnp.max(jnp.where(m, sc, -jnp.inf), axis=1).astype(jnp.float32)

    want = np.asarray(jax.jit(ref_best)(renv_sw))
    env_sw = engine._sweep_env(penv, BF16)
    c = torch.from_numpy(cand)
    args = engine._lead_args(penv, pst, pg, (), c, torch.ones(c.shape[0], dtype=torch.bool),
                             env_sw)
    got, _f = lead_k.leadership_rows(*args)
    assert np.array_equal(bits(got), bits(want))
    assert bool(np.isfinite(want).any())
    if name in LEAD_GOALS[:4]:
        shadow = dataclasses.replace(
            renv, leader_load=renv_sw.leader_load.astype(jnp.float32),
            follower_load=renv_sw.follower_load.astype(jnp.float32))
        assert not np.array_equal(bits(np.asarray(jax.jit(ref_best)(shadow))), bits(want))


@pytest.mark.parametrize("name", ["IntraBrokerDiskCapacityGoal",
                                  "IntraBrokerDiskUsageDistributionGoal"])
def test_disk_rows_score_the_sweep_view(ctx, name):
    """K8 ``disk_rows``' twin with the sweep view's DISK loads for its score
    and the f32 loads for its vetoes equals the reference's ``_disk_rows``
    (engine.py:1222-1230: ``disk_move_score(env_sw, st_sw)`` masked by
    ``legit_disk_move_mask`` and the previous goal's ``accept_disk_move``
    on the f32 env); for the usage goal, scoring the f32 loads gives other
    bits."""
    from cruise_control_tpu.analyzer.goals.base import legit_disk_move_mask
    from cruise_control_tpu_torch.analyzer.goals.base import disk_state
    from cruise_control_tpu_torch.kernels import disk as disk_k
    names = ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
    other = [n for n in names if n != name][0]
    rg, rprev = ref_make_goals([name, other])
    pg, pprev = make_goals([name, other])
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    cand = np.random.default_rng(13).choice(valid, 256, replace=False).astype(np.int64)
    renv_sw = ref_engine._sweep_env(renv, REF_BF16)
    rst_sw = ref_engine._sweep_state(rst, REF_BF16)

    def ref_best(e_sw):
        c = jnp.asarray(cand)
        m = legit_disk_move_mask(renv, rst, c) & rprev.accept_disk_move(renv, rst, c)
        sc = rg.disk_move_score(e_sw, rst_sw, c)
        return jnp.max(jnp.where(m, sc, -jnp.inf), axis=1).astype(jnp.float32)

    want = np.asarray(jax.jit(ref_best)(renv_sw))
    env_sw = engine._sweep_env(penv, BF16)
    ds_k = disk_state(env_sw, engine._sweep_state(pst, BF16))
    ds = dataclasses.replace(disk_state(penv, pst), slead_disk=ds_k.lead_disk,
                             sfoll_disk=ds_k.foll_disk)
    c = torch.from_numpy(cand)
    got = disk_k.disk_rows_plain(ds, c, torch.zeros(c.shape[0]), pg.disk_rule(),
                                 [pprev.disk_rule()])
    assert np.array_equal(bits(got), bits(want))
    assert bool(np.isfinite(want).any())
    if name == "IntraBrokerDiskUsageDistributionGoal":
        assert not np.array_equal(bits(np.asarray(jax.jit(ref_best)(renv))), bits(want))


# --- the compensated accumulators --------------------------------------------
@pytest.mark.parametrize("kind", ["moves", "leaderships", "swaps", "two chained waves"])
def test_apply_residuals_match_reference(ctx, kind):
    """The Neumaier residuals the bf16 sweeps read (``util + util_residual``)
    after one batched apply, bit for bit. XLA:CPU folds ``_kahan_scatter2``'s
    scatter of the deltas into zeros into ``res + (acc - new)``, or into
    ``acc - new`` alone when ``res`` is the previous apply's scatter output
    in the same program (a swap's second leg, two waves in a row)."""
    from cruise_control_tpu.analyzer import state as ref_state
    from cruise_control_tpu_torch.analyzer import state as port_state
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rng = np.random.default_rng(5)
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    W = 48
    sel = rng.choice(valid, 2 * W, replace=False)
    a, b = sel[:W], sel[W:]
    dst = rng.integers(0, 31, W)
    dst2 = rng.integers(0, 31, W)
    mask = rng.random(W) < 0.6
    J = lambda x: jnp.asarray(x.astype(np.int32) if x.dtype.kind == "i" else x)
    T = lambda x: torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i" else x)
    if kind == "moves":
        want = jax.jit(ref_state.apply_moves_batched)(renv, rst, J(a), J(dst), J(mask))
        got = port_state.apply_moves_batched(penv, pst, T(a), T(dst), T(mask))
    elif kind == "swaps":
        want = jax.jit(ref_state.apply_swaps_batched)(renv, rst, J(a), J(b), J(mask))
        got = port_state.apply_swaps_batched(penv, pst, T(a), T(b), T(mask))
    elif kind == "leaderships":
        members = np.asarray(renv.partition_replicas)[np.asarray(renv.replica_partition)[a]]
        other = np.where(members[:, 1] == a, members[:, 0], members[:, 1])
        ok = other >= 0
        src, dl, m = a[ok], other[ok], mask[ok]
        want = jax.jit(ref_state.apply_leaderships_batched)(renv, rst, J(src), J(dl), J(m))
        got = port_state.apply_leaderships_batched(penv, pst, T(src), T(dl), T(m))
    else:
        def two(e, s, r1, d1, r2, d2, m):
            return ref_state.apply_moves_batched(
                e, ref_state.apply_moves_batched(e, s, r1, d1, m), r2, d2, m)
        want = jax.jit(two)(renv, rst, J(a), J(dst), J(b), J(dst2), J(mask))
        got = port_state.apply_moves_batched(
            penv, port_state.apply_moves_batched(penv, pst, T(a), T(dst), T(mask)),
            T(b), T(dst2), T(mask), chained=True)
    for name in ("util", "leader_util", "util_residual", "leader_util_residual"):
        assert np.array_equal(bits(np.asarray(getattr(want, name))),
                              bits(getattr(got, name))), name


# --- whole chains under bf16 --------------------------------------------------
def _outcome(res):
    g = res.goal_results
    return dict(before=res.violated_goals_before, after=res.violated_goals_after,
                actions=[r.iterations for r in g], passes=[r.passes for r in g],
                moves=res.num_replica_movements, leads=res.num_leadership_movements,
                proven=[r.fixpoint_proven for r in g],
                rounds=[r.finisher_rounds for r in g],
                swaps=[r.swap_actions for r in g], disk=[r.disk_actions for r in g])


def _ref_outcome(ref):
    c, f = ref["counts"], ref["finisher"]
    return dict(c, proven=f["proven"], rounds=f["rounds"], swaps=ref["swaps"],
                disk=ref["disk"])


def _port_chain(spec, goals, params):
    ct, meta = ref_rc.generate_scale(ref_rc.RandomClusterSpec(**spec))
    pct, pmeta = convert.cluster_from_arrays(convert.leaves(ct), meta)
    return GoalOptimizer(device="cpu", engine_params=params).optimizations(
        pct, pmeta, goal_names=goals, skip_hard_goal_check=True, raise_on_failure=False)


SLICE_1000B = dict(num_brokers=1000, num_racks=20, num_topics=200, num_partitions=50000,
                   max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
JBOD_1000B = dict(SLICE_1000B, skew=1.0, seed=3143, logdirs_per_broker=4,
                  num_dead_brokers=3, num_brokers_with_dead_disk=7)
CHAINS = {"spec-32b sixteen goals": (SMALL, list(DEFAULT_GOALS)),
          "mid-64b sixteen goals": (MID, list(DEFAULT_GOALS)),
          "jbod-32b ten goals": (JBOD_SMALL, JBOD_CHAIN),
          "slice-1000b sixteen goals": (SLICE_1000B, list(DEFAULT_GOALS)),
          "jbod-1000b ten goals": (JBOD_1000B, JBOD_CHAIN)}
SLOW_CHAINS = {"slice-1000b sixteen goals", "jbod-1000b ten goals"}
RUNG4_PARAMS = [dict(pass_waves=4), dict(num_dst_choices=5)]


def _rung4_key(params: dict) -> str:
    return f"rung4 {sorted(params.items())}"


# the reference's tier-1 chains start when the module is imported (under
# xdist, once per session, in the background): one interpreter for mid-64b,
# one for the two 32-broker chains, one for the two rung-4 paths
_REFERENCE_RUNS = {
    "mid": {"mid-64b sixteen goals": dict(spec=MID, goals=list(DEFAULT_GOALS),
                                          dtype="bfloat16")},
    "small": {c: dict(spec=CHAINS[c][0], goals=CHAINS[c][1], dtype="bfloat16")
              for c in ("spec-32b sixteen goals", "jbod-32b ten goals")},
    "rung4": {_rung4_key(p): dict(spec=SMALL, goals=list(DEFAULT_GOALS), params=p)
              for p in RUNG4_PARAMS},
}
_REFERENCE_JOBS = {part: chains_job([{**dict(demoted=None, dtype=None, params=None), **r}
                                     for r in runs.values()])
                   for part, runs in _REFERENCE_RUNS.items()}
start_background_reference("precision", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def ref_chains(tmp_path_factory):
    """{case: the reference's chain} of the tier-1 chains (three
    interpreters side by side, once for the whole test session)."""
    parts = background_reference(tmp_path_factory, "precision", _REFERENCE_JOBS)
    return {name: parts[part][i] for part, runs in _REFERENCE_RUNS.items()
            for i, name in enumerate(runs)}


@pytest.mark.parametrize("case", [pytest.param(c, marks=pytest.mark.slow)
                                  if c in SLOW_CHAINS else c for c in sorted(CHAINS)])
def test_bf16_chain_matches_reference(tmp_path, request, case):
    """Counts, certificates, swap and disk actions, final assignment,
    leadership and logdirs: the reference's, both pinned to bf16."""
    spec, goals = CHAINS[case]
    ref = (reference_chain(tmp_path, spec, goals, dtype="bfloat16") if case in SLOW_CHAINS
           else request.getfixturevalue("ref_chains")[case])
    port = _port_chain(spec, goals, BF16)
    assert _outcome(port) == _ref_outcome(ref)
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(port.final_state, name).numpy()), name
    for name in ("util", "leader_util", "util_residual", "leader_util_residual"):
        assert np.array_equal(bits(ref["final"][name]),
                              bits(getattr(port.final_state, name))), name


SEED777 = dict(num_brokers=24, num_racks=4, num_topics=12, num_partitions=300,
               max_replication=2, skew=2.0)
DTYPE_CHAIN = ["RackAwareGoal", "DiskCapacityGoal", "CpuCapacityGoal",
               "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
               "LeaderReplicaDistributionGoal"]


def _run_seeded(seed, params):
    ct, meta = port_rc.generate(port_rc.RandomClusterSpec(**SEED777, seed=seed))
    return GoalOptimizer(device="cpu", engine_params=params).optimizations(
        ct, meta, goal_names=DTYPE_CHAIN, skip_hard_goal_check=True,
        raise_on_failure=False)


def test_bf16_outcome_parity_with_f32():
    """tests/test_dtype_policy.py:69-88 through the port: bf16 sweeps and
    f32 give the same violated goals and certificate sets."""
    rf = _run_seeded(777, EngineParams(compute_dtype="float32"))
    rb = _run_seeded(777, BF16)
    assert rf.violated_goals_before == rb.violated_goals_before
    assert rf.violated_goals_after == rb.violated_goals_after

    def certs(r):
        return {g.name for g in r.goal_results if g.violated_after and g.fixpoint_proven}
    assert certs(rf) == certs(rb)


def test_f32_policy_bit_identical_to_default():
    ra = _run_seeded(778, EngineParams())
    rb = _run_seeded(778, EngineParams(compute_dtype="float32"))
    assert np.array_equal(ra.final_state.replica_broker.numpy(),
                          rb.final_state.replica_broker.numpy())
    assert _outcome(ra) == _outcome(rb)


@pytest.mark.parametrize("params", RUNG4_PARAMS, ids=["four waves", "T 5 does not divide B"])
def test_rung4_paths_match_reference(ref_chains, params):
    """The sixteen goals on spec-32b with the multi-wave pass and with K2's
    padded Bp path, against the reference with the same parameters."""
    ref = ref_chains[_rung4_key(params)]
    port = _port_chain(SMALL, list(DEFAULT_GOALS), EngineParams(**params))
    assert _outcome(port) == _ref_outcome(ref)
    assert np.array_equal(ref["final"]["replica_broker"],
                          port.final_state.replica_broker.numpy())
