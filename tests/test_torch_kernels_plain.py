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
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

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
    if kind == "equal":        # every key equal: the ties straddle k
        return np.full(R, 0.5, np.float32)
    if kind == "signed zeros":
        key = np.where(rng.random(R) < 0.5, np.float32(-0.0), np.float32(0.0))
        key[::97], key[1::89] = 1.0, -1.0
        return key.astype(np.float32)
    if kind == "all -inf":
        return np.full(R, -np.inf, np.float32)
    key = rng.standard_normal(R).astype(np.float32)
    key[::7] = -np.inf
    key[::11] = 0.5            # ties
    key[5::13] = -0.0          # signed zeros
    key[6::13] = 0.0
    key[1::17] = 6e11          # offline-healing rows keep priority when salted
    return key


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("stall", [0, 3])
@pytest.mark.parametrize("kind", ["rack", "distribution", "ties", "equal", "signed zeros",
                                  "all -inf"])
def test_select_candidates_twin(ctx, kind, stall, exact):
    key = _key(ctx, kind)
    kv_r, cand_r = ref_engine._select_candidates(
        jnp.asarray(key), K_ALL, jnp.int32(stall), exact, ref_engine.EngineParams())
    kv_p, cand_p = select_candidates(torch.tensor(key), K_ALL, stall, 0)
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
    d_rows = engine.move_delta_rows(penv, pst, cand_p)
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
        engine.move_delta_rows(penv, pst, ct_), pst.replica_broker[ct_],
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


def _seg_case(kind: str):
    """(values f32[N, C], seg i64[N], nseg, init) of the segment-sum edges
    that ``chip_smoke.py`` phase 3 holds the kernel to, at small shapes."""
    rng = np.random.default_rng(14)

    def vals(n, c):
        return (rng.standard_normal((n, c)) * 100).astype(np.float32)

    def init(nseg, c):
        return (rng.standard_normal((nseg, c)) * 1e4).astype(np.float32)

    if kind == "one segment":            # one segment holds every row
        return vals(3000, 3), np.zeros(3000, np.int64), 1, init(1, 3)
    if kind == "empty segments":         # two of every three segments empty
        return vals(600, 4), 3 * rng.integers(0, 22, 600), 64, None
    if kind == "outside":                # rows with seg < 0 and seg >= nseg
        return vals(800, 9), rng.integers(-3, 53, 800), 50, init(50, 9)
    if kind in ("C=1", "C=32"):
        c = int(kind[2:])
        return vals(700, c), rng.integers(-1, 40, 700), 40, init(40, c)
    if kind == "N=0":
        return vals(0, 9), np.zeros(0, np.int64), 16, init(16, 9)
    if kind == "lanes":                  # lane ids at La * B * D
        La, B, D, W = 4, 5, 3, 40
        seg = np.repeat(np.arange(La), W) * B * D + rng.integers(0, B * D, La * W)
        seg[rng.random(La * W) < 0.3] = -1
        return vals(La * W, 1), seg, La * B * D, init(La * B * D, 1)
    # long segments beside short ones, then a padding block in segment 0
    seg = rng.integers(0, 300, 4000)
    skew = rng.random(4000) < 0.5
    seg[skew] = rng.integers(0, 3, int(skew.sum()))
    seg[-500:] = 0
    return vals(4000, 17), seg, 300, init(300, 17)


SEG_CASES = ["planted", "one segment", "empty segments", "outside", "C=1", "C=32", "N=0",
             "lanes", "long and short"]


@pytest.mark.parametrize("kind", SEG_CASES)
def test_segment_twins_skip_masked_rows_and_keep_row_order(kind):
    """The twin adds each segment's rows in row order onto ``init`` and
    skips rows outside [0, nseg): the reference's chained scatter-add
    (``state._kahan_scatter2``'s accumulator, rows outside dropped), bit for
    bit, at every edge the kernel is held to."""
    if kind == "planted":
        vals = torch.tensor([[1e8], [1.0], [-1e8], [1.0], [5.0]], dtype=torch.float32)
        seg = torch.tensor([0, 0, 0, -1, 1])
        out = segment_sum(vals, seg, 3, torch.tensor([[0.5], [0.0], [7.0]]))
        # ((0.5 + 1e8) + 1) - 1e8 in f32 row order is 0.0, not the exact 1.5
        assert out[:, 0].tolist() == [0.0, 5.0, 7.0]
        w = torch.tensor([2, -1, 3, 9, 1], dtype=torch.int32)
        assert segment_count(seg, 3, w).tolist() == [4, 1, 0]
        return
    vals, seg, nseg, init = _seg_case(kind)
    acc = np.zeros((nseg, vals.shape[1]), np.float32) if init is None else init
    idx = np.where((seg >= 0) & (seg < nseg), seg, nseg)     # out of range: dropped
    h = len(idx) // 2
    want, _res = ref_state_mod._kahan_scatter2(
        jnp.asarray(acc), jnp.zeros_like(jnp.asarray(acc)), jnp.asarray(idx[:h]),
        jnp.asarray(vals[:h]), jnp.asarray(idx[h:]), jnp.asarray(vals[h:]))
    got = segment_sum(torch.tensor(vals), torch.tensor(seg), nseg,
                      None if init is None else torch.tensor(init))
    assert np.array_equal(bits(want), bits(got))


# --- the second slice's launch shapes -------------------------------------
CHAIN = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
         "DiskCapacityGoal", "NetworkInboundCapacityGoal",
         "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
         "PotentialNwOutGoal", "LeaderReplicaDistributionGoal",
         "LeaderBytesInDistributionGoal"]


@pytest.fixture(scope="module")
def chain_ctx():
    """The spec's state with four topics flagged for MinTopicLeadersPerBroker
    (its per-(topic, broker) budgets enter every later goal's admission)."""
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    tml = np.zeros(ct.num_topics, bool)
    tml[:4] = True
    renv = ref_env_mod.make_env(ct, meta, topic_min_leaders_mask=tml)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    return dict(renv=renv, rst=rst,
                penv=convert.env_from_arrays(convert.leaves(renv), "cpu"),
                pst=convert.state_from_arrays(convert.leaves(rst), "cpu"),
                rgoals=ref_make_goals(CHAIN), pgoals=make_goals(CHAIN))


@pytest.mark.parametrize("exact, k", [
    pytest.param(True, 10560, id="True"), pytest.param(False, 10560, id="False"),
    pytest.param(True, 16384, id="k=n-True"), pytest.param(False, 16384, id="k=n-False"),
    pytest.param(True, 1, id="k=1-True"), pytest.param(False, 1, id="k=1-False")])
def test_select_candidates_k_above_8192(exact, k):
    """k = 10,560 (the finisher's K * W) with planted ties and signed zeros
    inside the top k: the soft path (approx_max_k) orders them exactly as
    the exact one (total order, lowest index first); and the kernel's edges
    k = n = 16,384 and k = 1 on the same keys."""
    rng = np.random.default_rng(11)
    key = rng.standard_normal(16384).astype(np.float32)
    key[::5] = -np.inf
    key[::7] = 0.25
    key[3::11] = -0.0
    key[4::11] = 0.0
    kv_r, cand_r = ref_engine._select_candidates(
        jnp.asarray(key), k, jnp.int32(0), exact, ref_engine.EngineParams())
    kv_p, cand_p = select_candidates(torch.tensor(key), k, 0, 0)
    assert np.array_equal(np.asarray(cand_r), cand_p.numpy())
    assert np.array_equal(bits(kv_r), bits(kv_p))
    if exact:
        kv_t, cand_t = jax.lax.top_k(jnp.asarray(key), k)
        assert np.array_equal(np.asarray(cand_t), cand_p.numpy())


def test_wave_admission_segment_rows_with_topic_budgets(chain_ctx):
    """N = 14,080 rows (K * S of a segment wave: every candidate 11 times),
    one row per candidate, partition first-touch, the chain's topic budgets,
    crowded brokers; against engine.py:1546-1564."""
    renv, rst, penv, pst = (chain_ctx[k] for k in ("renv", "rst", "penv", "pst"))
    i = CHAIN.index("LeaderReplicaDistributionGoal")
    rg, pg = chain_ctx["rgoals"], chain_ctx["pgoals"]
    R, S = renv.num_replicas, 11
    N = R * S
    assert N == 14080
    rng = np.random.default_rng(5)
    k_s = rng.permutation(np.repeat(np.arange(R), S)).astype(np.int32)
    r_sorted = k_s                               # candidate k is replica k
    dst = rng.integers(0, 6, N).astype(np.int32)   # crowded destinations
    wave_ok = (rng.random(N) < 0.7) & np.asarray(renv.replica_valid)[r_sorted]
    posn = np.arange(N, dtype=np.int32)
    rs = jnp.asarray(r_sorted)
    d = ref_engine._move_delta_rows(renv, rst, rs)
    guarded = jnp.where(jnp.asarray(wave_ok), posn, N + 1)
    first_k = jnp.full(R, N + 1, jnp.int32).at[jnp.asarray(k_s)].min(guarded)
    k_ok = first_k[jnp.asarray(k_s)] == posn
    p_s = renv.replica_partition[rs]
    first_part = (jnp.full(renv.num_partitions, N + 1, jnp.int32)
                  .at[p_s].min(jnp.where(k_ok, guarded, N + 1)))
    src_s = rst.replica_broker[rs].astype(jnp.int32)
    win_r = (first_part[p_s] == posn) & ref_engine._wave_admission(
        renv, rst, rg[i], tuple(rg[:i]), d, d, src_s, jnp.asarray(dst),
        jnp.asarray(wave_ok) & k_ok, renv.replica_topic[rs], jnp.asarray(posn),
        d_count=jnp.ones(N, d.dtype),
        d_leader=rst.replica_is_leader[rs].astype(d.dtype),
        gain_escape=rst.replica_offline[rs])
    rt = torch.as_tensor(r_sorted).long()
    args = engine._admit_moves(
        penv, pst, pg[i], tuple(pg[:i]), rt, pst.replica_broker[rt],
        torch.as_tensor(dst).long(), engine.move_delta_rows(penv, pst, rt),
        torch.as_tensor(wave_ok), kgroup=(torch.as_tensor(k_s).long(), R))
    assert args[11] is not None                   # the topic budgets are in
    win_p = wave_admission(*args)
    assert np.array_equal(np.asarray(win_r), win_p.numpy())
    assert 0 < int(win_p.sum()) < int(np.asarray(k_ok).sum())


@pytest.mark.parametrize("i", [7, 9], ids=[CHAIN[7], CHAIN[9]])
def test_move_score_scan_and_column_order(chain_ctx, i):
    """T = 1 (the exhaustive scan's row argmax) and the room-ordered
    column view of _segment_move_wave (engine.py:1504-1520)."""
    renv, rst, penv, pst = (chain_ctx[k] for k in ("renv", "rst", "penv", "pst"))
    rg, pg = chain_ctx["rgoals"], chain_ctx["pgoals"]
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    cand = np.random.default_rng(i).choice(valid, 512, replace=False).astype(np.int32)
    c = jnp.asarray(cand)
    B, S = renv.num_brokers, 8
    mask = legit_move_mask(renv, rst, c, rg[i].options)
    rooms, custom = ref_engine._combined_move_rooms(tuple(rg[:i]), renv, rst)
    mask = mask & ref_engine._rooms_move_mask(
        rooms, ref_engine._move_delta_rows(renv, rst, c), rst.replica_broker[c])
    for g in custom:
        mask = mask & g.accept_move(renv, rst, c)
    sc = jnp.where(mask, rg[i].move_score(renv, rst, c), -jnp.inf)
    order_b = ref_engine._segment_broker_order(renv, rst, rg[i], tuple(rg[:i]),
                                               ref_engine.EngineParams(), S)
    seg = sc[:, order_b].reshape(512, -1, S)
    ct_ = torch.as_tensor(cand).long()
    prooms, pcustom = engine._combined_move_rooms(tuple(pg[:i]), penv, pst)
    d_rows = engine.move_delta_rows(penv, pst, ct_)
    ones = torch.ones(512, dtype=torch.bool)
    v1, q1 = move_score_classes(*engine._score_args(
        penv, pst, pg[i], prooms, pcustom, ct_, None, d_rows, 1, row_ok=ones))
    assert np.array_equal(bits(jnp.max(sc, axis=1)), bits(v1[:, 0]))
    assert np.array_equal(np.asarray(jnp.argmax(sc, axis=1)), q1[:, 0].numpy())
    ob = engine._segment_broker_order(penv, pst, pg[i], tuple(pg[:i]), S)
    assert np.array_equal(np.asarray(order_b), ob.numpy())
    vs, qs = move_score_classes(*engine._score_args(
        penv, pst, pg[i], prooms, pcustom, ct_, None, d_rows, S, order_b=ob,
        row_ok=ones))
    assert np.array_equal(bits(jnp.max(seg, axis=1)), bits(vs))
    assert np.array_equal(np.asarray(jnp.argmax(seg, axis=1)), qs.numpy())
    assert np.isfinite(np.asarray(sc)).any()


# --- the third slice's K2 families and topic veto ---------------------------
DEFAULT = CHAIN[:9] + ["DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
                       "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
                       "TopicReplicaDistributionGoal"] + CHAIN[9:]
NEW_FAMILIES = list(range(9, 15))      # the four usage goals, TopicReplica, and
                                       # LeaderReplica behind TopicReplica's veto


@pytest.fixture(scope="module", params=[False, True], ids=["online", "offline"])
def default_ctx(request):
    """The spec's state with four topics flagged for MinTopicLeadersPerBroker,
    the largest topic's replicas crowded onto brokers 0-7 (so the
    topic-replica family scores) and, in the ``offline`` case, every 9th
    valid replica offline (the families' healing scores)."""
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
    offline = np.array(ct.replica_offline)
    if request.param:
        offline[np.flatnonzero(np.asarray(ct.replica_valid))[::9]] = True
    rst = ref_state_mod.init_state(renv, rb, ct.replica_is_leader, offline,
                                   ct.replica_disk)
    return dict(renv=renv, rst=rst,
                penv=convert.env_from_arrays(convert.leaves(renv), "cpu"),
                pst=convert.state_from_arrays(convert.leaves(rst), "cpu"),
                rgoals=ref_make_goals(DEFAULT), pgoals=make_goals(DEFAULT))


@pytest.mark.parametrize("i", NEW_FAMILIES, ids=[DEFAULT[i] for i in NEW_FAMILIES])
def test_move_score_default_families(default_ctx, i):
    """K2's resource-distribution and topic-replica families and the topic
    veto against engine.py:776-792 with the default chain's prefix."""
    c = default_ctx
    renv, rst, penv, pst = c["renv"], c["rst"], c["penv"], c["pst"]
    rg, pg = c["rgoals"], c["pgoals"]
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    cand = np.random.default_rng(i).choice(valid, 256, replace=False).astype(np.int32)
    cj = jnp.asarray(cand)
    mask = legit_move_mask(renv, rst, cj, rg[i].options)
    rooms, custom = ref_engine._combined_move_rooms(tuple(rg[:i]), renv, rst)
    mask = mask & ref_engine._rooms_move_mask(
        rooms, ref_engine._move_delta_rows(renv, rst, cj), rst.replica_broker[cj])
    for g in custom:
        mask = mask & g.accept_move(renv, rst, cj)
    sc = jnp.where(mask, rg[i].move_score(renv, rst, cj), -jnp.inf)
    assert renv.num_brokers % T == 0
    sv = sc.reshape(256, -1, T)
    ct_ = torch.as_tensor(cand).long()
    prooms, pcustom = engine._combined_move_rooms(tuple(pg[:i]), penv, pst)
    args = engine._score_args(penv, pst, pg[i], prooms, pcustom, ct_, None,
                              engine.move_delta_rows(penv, pst, ct_), T,
                              row_ok=torch.ones(256, dtype=torch.bool))
    assert (args[18] is not None) == (i > DEFAULT.index("TopicReplicaDistributionGoal"))
    val, q = move_score_classes(*args)
    assert np.array_equal(bits(jnp.max(sv, axis=1)), bits(val))
    assert np.array_equal(np.asarray(jnp.argmax(sv, axis=1)), q.numpy())
    assert np.isfinite(np.asarray(sc)).any()
    assert same_bits(rg[i].move_score(renv, rst, cj), pg[i].move_score(penv, pst, ct_))


def same_bits(a, b) -> bool:
    return np.array_equal(bits(a), bits(b))


def test_topic_replica_accept_move_folds(default_ctx):
    """TopicReplicaDistributionGoal.accept_move (topic.py:120-130) as the
    row veto (source leg) and the (topic, broker) count veto (destination
    leg) the K2 kernel folds."""
    c = default_ctx
    i = DEFAULT.index("TopicReplicaDistributionGoal")
    rg, pg = c["rgoals"][i], c["pgoals"][i]
    valid = np.flatnonzero(np.asarray(c["renv"].replica_valid))
    cand = np.random.default_rng(3).choice(valid, 256, replace=False).astype(np.int32)
    ref = np.asarray(rg.accept_move(c["renv"], c["rst"], jnp.asarray(cand)))
    ct_ = torch.as_tensor(cand).long()
    penv, pst = c["penv"], c["pst"]
    up = pg.move_topic_veto(penv, pst)
    t = penv.replica_topic[ct_]
    dst = (pst.topic_broker_count[t].to(torch.float32) + 1.0) <= up[t][:, None]
    port = pg.move_row_veto(penv, pst, ct_)[:, None] & dst
    assert np.array_equal(ref, port.numpy())
    assert ref.any() and not ref.all()


# --- K8: the intra-broker disk branch ---------------------------------------
JBOD = dict(num_brokers=32, num_racks=4, num_topics=8, num_partitions=1000,
            max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
            target_cpu_util=0.45, num_dead_brokers=1, num_brokers_with_dead_disk=2)
INTRA = ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]


@pytest.fixture(scope="module", params=[0, 1], ids=["state", "crowded"])
def disk_ctx(request):
    """The 32-broker JBOD state (dead broker, dead disks) and, for
    ``crowded``, the same with every logdir's utilization scaled by a random
    factor in [0.5, 6) so that many logdirs sit over their limit; candidates
    are 96 replicas of three brokers (several rows per broker, so the walk's
    order matters), the dead-disk replicas among them."""
    import dataclasses
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**JBOD)))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    rng = np.random.default_rng(request.param)
    if request.param:
        du = np.asarray(rst.disk_util) * rng.uniform(0.5, 6.0, rst.disk_util.shape)
        rst = dataclasses.replace(rst, disk_util=jnp.asarray(du.astype(np.float32)))
    b = np.asarray(ct.replica_broker)
    valid = np.asarray(ct.replica_valid)
    dead_disk_brokers = np.flatnonzero(np.asarray(ct.broker_alive)
                                       & ~np.asarray(ct.broker_disk_alive).all(axis=1))
    brokers = np.concatenate([dead_disk_brokers, [5]])[:3]
    pool = np.flatnonzero(valid & np.isin(b, brokers))
    cand = rng.choice(pool, 96, replace=False).astype(np.int32)
    penv = convert.env_from_arrays(convert.leaves(renv), "cpu")
    pst = convert.state_from_arrays(convert.leaves(rst), "cpu")
    return dict(renv=renv, rst=rst, penv=penv, pst=pst, cand=cand, rng=rng)


def _disk_args(name, prev):
    from cruise_control_tpu.analyzer.goals import make_goal as ref_make_goal
    from cruise_control_tpu_torch.analyzer.goals import make_goal
    rg, pg = ref_make_goal(name), make_goal(name)
    rprev = tuple(ref_make_goal(n) for n in prev)
    vetoes = [r for r in (make_goal(n).disk_rule() for n in prev) if r is not None]
    return rg, rprev, pg.disk_rule(), vetoes


DISK_CASES = [("IntraBrokerDiskCapacityGoal", ()),
              ("IntraBrokerDiskUsageDistributionGoal", ("IntraBrokerDiskCapacityGoal",)),
              ("IntraBrokerDiskCapacityGoal", ("IntraBrokerDiskUsageDistributionGoal",))]


@pytest.mark.parametrize("name,prev", DISK_CASES)
def test_disk_rows_twin(disk_ctx, name, prev):
    """``disk_rows`` against the reference's ``_disk_rows`` composition
    (legit_disk_move_mask & accept_disk_move & kv > -inf & disk_move_score,
    max over the logdirs), with some rows' kv at -inf."""
    from cruise_control_tpu.analyzer.goals.base import legit_disk_move_mask as ref_legit
    from cruise_control_tpu_torch.analyzer.goals.base import disk_state
    from cruise_control_tpu_torch.kernels import disk_rows
    renv, rst, c = disk_ctx["renv"], disk_ctx["rst"], jnp.asarray(disk_ctx["cand"])
    rg, rprev, rule, vetoes = _disk_args(name, prev)
    kv = np.where(disk_ctx["rng"].random(c.shape[0]) < 0.2, -np.inf, 1.0).astype(np.float32)
    m = ref_legit(renv, rst, c)
    for g in rprev:
        m = m & g.accept_disk_move(renv, rst, c)
    sc = rg.disk_move_score(renv, rst, c)
    want = jnp.max(jnp.where(m & (jnp.asarray(kv) > -jnp.inf)[:, None], sc, -jnp.inf),
                   axis=1)
    got = disk_rows(disk_state(disk_ctx["penv"], disk_ctx["pst"]),
                    torch.as_tensor(disk_ctx["cand"]).long(), torch.as_tensor(kv),
                    rule, vetoes)
    assert np.array_equal(bits(want), bits(got))
    assert (np.asarray(want) > 0).sum() > 4


@pytest.mark.parametrize("name,prev", DISK_CASES)
def test_disk_apply_twin(disk_ctx, name, prev):
    """``disk_apply`` against the reference's walk: ``_rescore_disk_move_row``,
    ``argmax``, ``ok`` and ``apply_disk_move`` in ``argsort(-best)`` order,
    with planted ties and non-positive rows among the row maxima."""
    from cruise_control_tpu_torch.analyzer.goals.base import disk_state
    from cruise_control_tpu_torch.kernels import disk_apply
    renv, rst, cand = disk_ctx["renv"], disk_ctx["rst"], disk_ctx["cand"]
    rg, rprev, rule, vetoes = _disk_args(name, prev)
    n = cand.shape[0]
    best = disk_ctx["rng"].choice(np.asarray([2.0, 1.0, 1.0, 0.5, 0.0, 1e-10, -np.inf],
                                             np.float32), n)
    order = np.argsort(-best, kind="stable")
    mg = np.float32(1e-9)
    st, applied = rst, 0
    for k in order[:int((best > mg).sum())]:
        row = ref_engine._rescore_disk_move_row(renv, st, rg, rprev, jnp.int32(cand[k]))
        d = int(jnp.argmax(row))
        ok = bool(best[k] > mg) and bool(row[d] > mg)
        st = ref_state_mod.apply_disk_move(renv, st, jnp.int32(cand[k]), jnp.int32(d),
                                           enabled=ok)
        applied += ok
    du, rd, off, moved, n_app = disk_apply(
        disk_state(disk_ctx["penv"], disk_ctx["pst"]), torch.as_tensor(cand).long(),
        torch.as_tensor(best), torch.as_tensor(order), rule, vetoes, 1e-9)
    assert int(n_app) == applied > 0
    assert np.array_equal(bits(st.disk_util), bits(du))
    for want, got in ((st.replica_disk, rd), (st.replica_offline, off), (st.moved, moved)):
        assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))


# --- K12: the preferred-leader election pass ---------------------------------
@pytest.mark.parametrize("demoted", [(), (3, 7, 11), tuple(range(32))],
                         ids=["steady", "demote", "all-demoted"])
@pytest.mark.parametrize("seed", [0, 1])
def test_preferred_leader_twin(demoted, seed):
    """``preferred_leader`` (count, flips) against the reference goal's
    ``_preferred_leader`` / ``_current_leader`` / ``violated`` / ``apply`` on
    the JBOD state with random leader flags (leaderless and two-leader
    partitions) and random leadership exclusions."""
    import dataclasses
    from cruise_control_tpu.analyzer.goals.leader_election import (
        PreferredLeaderElectionGoal as RefPLE,
    )
    from cruise_control_tpu_torch.kernels import ple
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**JBOD)))
    rng = np.random.default_rng(seed)
    dem = np.zeros(ct.num_brokers, bool)
    dem[list(demoted)] = True
    ct = dataclasses.replace(
        ct, broker_demoted=jnp.asarray(dem),
        broker_excluded_for_leadership=jnp.asarray(
            np.asarray(ct.broker_excluded_for_leadership) | (rng.random(ct.num_brokers) < 0.1)))
    renv = ref_env_mod.make_env(ct, meta)
    lead = np.asarray(ct.replica_is_leader) ^ (rng.random(ct.num_replicas) < 0.1 * (seed + 1))
    rst = ref_state_mod.init_state(renv, ct.replica_broker, jnp.asarray(lead),
                                   ct.replica_offline, ct.replica_disk)
    penv = convert.env_from_arrays(convert.leaves(renv), "cpu")
    pst = convert.state_from_arrays(convert.leaves(rst), "cpu")
    g = RefPLE()
    args = (penv.partition_replicas, pst.replica_broker, pst.replica_is_leader,
            pst.replica_offline, penv.broker_alive, penv.broker_excluded_for_leadership,
            penv.broker_demoted)
    pref, cur = ple.preferred_leader_plain(*args)
    assert np.array_equal(np.asarray(g._preferred_leader(renv, rst)), pref.numpy())
    assert np.array_equal(np.asarray(g._current_leader(renv, rst)), cur.numpy())
    lead2, moved2, n = ple.preferred_leader(*args, pst.leadership_moved, apply=True)
    assert bool(g.violated(renv, rst)) == (int(n) > 0)
    want = g.apply(renv, rst)
    assert np.array_equal(np.asarray(want.replica_is_leader), lead2.numpy())
    assert np.array_equal(np.asarray(want.leadership_moved), moved2.numpy())
    assert int(n) > 0
    _l, _m, n_after = ple.preferred_leader(*args[:2], lead2, *args[3:], moved2,
                                           apply=False)
    assert bool(g.violated(renv, want)) == (int(n_after) > 0)
