"""Each hand kernel's plain PyTorch twin against the JAX package's function
on the same state (the 32-broker skewed cluster of the slice test, carried
over bit for bit by ``convert``). Every comparison is exact: indices, ints
and bools equal, floats bit-identical (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import engine as ref_engine
from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goals as ref_make_goals
from cruise_control_tpu.analyzer.goals.base import legit_move_mask
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer import state as state_mod
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.kernels import (
    move_score_classes, segment_count, segment_sum, select_candidates, wave_admission,
)
from cruise_control_tpu_torch.kernels.admission import group_cumsum

GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "ReplicaDistributionGoal"]
SPEC = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
            max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
K, T = 64, 16          # the engine's scaled K and T at this size
K_ALL = 4 * K          # K * max_pass_waves


@pytest.fixture(scope="module")
def ctx():
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    penv = convert.env_from_arrays(convert.leaves(renv), "cpu")
    pst = convert.state_from_arrays(convert.leaves(rst), "cpu")
    return dict(renv=renv, rst=rst, penv=penv, pst=pst,
                rgoals=ref_make_goals(GOALS), pgoals=make_goals(GOALS))


def bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.int32)


def ref_key(ctx, i):
    g = ctx["rgoals"][i]
    return np.asarray(g.replica_key(ctx["renv"], ctx["rst"],
                                    g.broker_severity(ctx["renv"], ctx["rst"])))


def ref_candidates(ctx, i, k=K):
    kv, cand = ref_engine._select_candidates(
        jnp.asarray(ref_key(ctx, i)), k, jnp.int32(0), ctx["rgoals"][i].is_hard,
        ref_engine.EngineParams())
    return np.asarray(kv), np.asarray(cand)


# --- K1 select_candidates ---------------------------------------------------
def _key(ctx, kind):
    if kind == "rack":
        return ref_key(ctx, 0)
    if kind == "distribution":
        return ref_key(ctx, 4)
    rng = np.random.default_rng(5)
    R = ctx["penv"].num_replicas
    key = rng.standard_normal(R).astype(np.float32)
    key[::7] = -np.inf
    key[::11] = 0.5            # ties
    key[5::13] = -0.0          # signed zeros
    key[6::13] = 0.0
    key[1::17] = 6e11          # offline-healing rows keep priority when salted
    return key


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("stall", [0, 3])
@pytest.mark.parametrize("kind", ["rack", "distribution", "ties"])
def test_select_candidates_twin(ctx, kind, stall, exact):
    key = _key(ctx, kind)
    kv_r, cand_r = ref_engine._select_candidates(
        jnp.asarray(key), K_ALL, jnp.int32(stall), exact, ref_engine.EngineParams())
    kv_p, cand_p = select_candidates(torch.tensor(key), K_ALL, stall, 0, exact)
    assert np.array_equal(np.asarray(cand_r), cand_p.numpy())
    assert np.array_equal(bits(kv_r), bits(kv_p))


# --- K2 move_score_classes ---------------------------------------------------
def ref_score_class_rows(ctx, i, cand, kv):
    """engine.py:776-792 (``_score_class_rows``, exact f32 mode)."""
    renv, rst, goals = ctx["renv"], ctx["rst"], ctx["rgoals"]
    goal, prev = goals[i], tuple(goals[:i])
    B = renv.num_brokers
    mask = legit_move_mask(renv, rst, cand, goal.options)
    rooms, custom = ref_engine._combined_move_rooms(prev, renv, rst)
    if rooms:
        mask = mask & ref_engine._rooms_move_mask(
            rooms, ref_engine._move_delta_rows(renv, rst, cand), rst.replica_broker[cand])
    for g in custom:
        mask = mask & g.accept_move(renv, rst, cand)
    sc = jnp.where(mask & (kv > -jnp.inf)[:, None], goal.move_score(renv, rst, cand),
                   -jnp.inf)
    Bp = -(-B // T) * T
    if Bp > B:
        sc = jnp.pad(sc, ((0, 0), (0, Bp - B)), constant_values=-jnp.inf)
    sv = sc.reshape(cand.shape[0], Bp // T, T)
    return np.asarray(jnp.max(sv, axis=1)), np.asarray(jnp.argmax(sv, axis=1))


@pytest.mark.parametrize("i", range(len(GOALS)), ids=GOALS)
def test_move_score_classes_twin(ctx, i):
    kv, cand = ref_candidates(ctx, 0 if i == 0 else 4, K_ALL)
    val_r, q_r = ref_score_class_rows(ctx, i, jnp.asarray(cand), jnp.asarray(kv))
    penv, pst = ctx["penv"], ctx["pst"]
    goal, prev = ctx["pgoals"][i], tuple(ctx["pgoals"][:i])
    cand_p, kv_p = torch.tensor(cand).long(), torch.tensor(kv)
    rooms, rack_veto = engine._combined_move_rooms(prev, penv, pst)
    d_rows = engine._move_delta_rows(penv, pst, cand_p)
    val_p, q_p = move_score_classes(*engine._score_args(
        penv, pst, goal, rooms, rack_veto, cand_p, kv_p, d_rows, T))
    assert np.array_equal(bits(val_r), bits(val_p))
    assert np.array_equal(q_r, q_p.numpy())
    assert np.isfinite(val_r).any()      # the rows do score somewhere


# --- K3 wave_admission ----------------------------------------------------
@pytest.mark.parametrize("n", [1, 16, 17, 257, 1760, 4097])
def test_group_cumsum_matches_reference(n):
    rng = np.random.default_rng(n)
    groups = rng.integers(0, max(2, n // 5), n)
    d = (rng.standard_normal((n, 8)) * 10.0 ** rng.integers(-3, 6, (n, 8))).astype(np.float32)
    cum_r, rank_r = jax.jit(ref_engine._group_cumsum)(jnp.asarray(groups, jnp.int32),
                                                      jnp.asarray(d))
    cum_p, rank_p = group_cumsum(torch.as_tensor(groups), torch.as_tensor(d))
    assert np.array_equal(np.asarray(rank_r), rank_p.numpy())
    assert np.array_equal(bits(cum_r), bits(cum_p))


@pytest.mark.parametrize("i", [0, 2, 4], ids=[GOALS[0], GOALS[2], GOALS[4]])
@pytest.mark.parametrize("seed", [0, 1])
def test_wave_admission_twin(ctx, i, seed):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rng = np.random.default_rng(seed)
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    cand = rng.choice(valid, K, replace=False)
    cand[K // 2:K // 2 + 4] = cand[:4]                # repeated partitions
    rb = np.asarray(rst.replica_broker)
    dst = rng.choice(rng.choice(renv.num_brokers, 4, replace=False), K)  # crowded
    wave_ok = rng.random(K) < 0.8
    posn = np.arange(K)
    # the reference wave: partition first-touch (engine.py:848-851) and
    # _wave_admission as _move_wave calls it (:853-861)
    c = jnp.asarray(cand, jnp.int32)
    d = ref_engine._move_delta_rows(renv, rst, c)
    p_s = renv.replica_partition[c]
    ok = jnp.asarray(wave_ok)
    guarded = jnp.where(ok, jnp.asarray(posn, jnp.int32), K + 1)
    first = jnp.full(renv.num_partitions, K + 1, jnp.int32).at[p_s].min(guarded)
    goals = ctx["rgoals"]
    win_r = (first[p_s] == posn) & ref_engine._wave_admission(
        renv, rst, goals[i], tuple(goals[:i]), d, d, jnp.asarray(rb[cand]),
        jnp.asarray(dst, jnp.int32), ok, renv.replica_topic[c],
        jnp.asarray(posn, jnp.int32), d_count=jnp.ones(K, d.dtype),
        d_leader=rst.replica_is_leader[c].astype(d.dtype),
        gain_escape=rst.replica_offline[c])
    pg = ctx["pgoals"]
    ct_ = torch.as_tensor(cand).long()
    win_p = wave_admission(
        engine._move_delta_rows(penv, pst, ct_), pst.replica_broker[ct_],
        torch.as_tensor(dst).long(), torch.as_tensor(wave_ok),
        penv.replica_partition[ct_],
        *engine.chain_slack(penv, pst, (pg[i], *pg[:i])),
        pg[i].wave_gain_budgets(penv, pst), pst.replica_offline[ct_])
    assert np.array_equal(np.asarray(win_r), win_p.numpy())
    assert int(win_p.sum()) < int(wave_ok.sum())      # the budgets did bind


# --- K4/K5 segment_sum / segment_count -------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_twin_bitwise(ctx, seed):
    """refresh (segment_sum + segment_count over R) on a shuffled assignment:
    float tallies bit-identical to the reference's scatter-adds."""
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rng = np.random.default_rng(seed)
    R, B = renv.num_replicas, renv.num_brokers
    rb = rng.integers(0, B, R).astype(np.int32)
    lead = rng.random(R) < 0.4
    rst2 = ref_state_mod.refresh(renv, rst.__class__(**{
        **convert.leaves(rst), "replica_broker": jnp.asarray(rb),
        "replica_is_leader": jnp.asarray(lead)}))
    pst2 = state_mod.refresh(penv, state_mod.EngineState(**{
        **{f: getattr(pst, f) for f in pst.__dataclass_fields__},
        "replica_broker": torch.as_tensor(rb).long(),
        "replica_is_leader": torch.as_tensor(lead)}))
    for name, a in convert.leaves(rst2).items():
        b = convert.leaves(pst2)[name]
        if a.dtype.kind == "f":
            assert np.array_equal(bits(a), bits(b)), name
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


def test_segment_twins_skip_masked_rows_and_keep_row_order():
    vals = torch.tensor([[1e8], [1.0], [-1e8], [1.0], [5.0]], dtype=torch.float32)
    seg = torch.tensor([0, 0, 0, -1, 1])
    out = segment_sum(vals, seg, 3, torch.tensor([[0.5], [0.0], [7.0]]))
    # ((0.5 + 1e8) + 1) - 1e8 in f32 row order is 0.0, not the exact 1.5
    assert out[:, 0].tolist() == [0.0, 5.0, 7.0]
    w = torch.tensor([2, -1, 3, 9, 1], dtype=torch.int32)
    assert segment_count(seg, 3, w).tolist() == [4, 1, 0]
