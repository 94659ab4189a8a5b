"""The leadership side of the port against the JAX package on one state of
the 32-broker skewed cluster (the slice test's spec), with four topics
flagged for MinTopicLeadersPerBrokerGoal so its tables are not trivial.

- legitimacy, each new goal's leader_key / leadership_score /
  accept_leadership / move_score and its budgets;
- the K6 twin (``kernels.leadership_rows``) against the reference's
  ``_lead_rows`` (engine.py:1003-1013) as the leadership branch calls it;
- ``apply_leaderships_batched`` on the same winners.

Every comparison is exact: indices, ints and bools equal, floats
bit-identical (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goals as ref_make_goals
from cruise_control_tpu.analyzer.goals.base import (
    legit_leadership_mask as ref_legit_leadership_mask,
)
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer import state as state_mod
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.analyzer.goals.base import legit_leadership_mask
from cruise_control_tpu_torch.kernels import leadership_rows
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

CHAIN = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
         "DiskCapacityGoal", "NetworkInboundCapacityGoal",
         "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
         "PotentialNwOutGoal", "LeaderReplicaDistributionGoal",
         "LeaderBytesInDistributionGoal"]
SPEC = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
            max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
LEAD_GOALS = [i for i, n in enumerate(CHAIN) if n in (
    "MinTopicLeadersPerBrokerGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
    "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal")]
NEW_GOALS = [1, 5, 6, 8, 9, 10]
KL = 128


@pytest.fixture(scope="module")
def ctx():
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    tml = np.zeros(ct.num_topics, bool)
    tml[:4] = True
    renv = ref_env_mod.make_env(ct, meta, topic_min_leaders_mask=tml)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    penv = convert.env_from_arrays(convert.leaves(renv), "cpu")
    pst = convert.state_from_arrays(convert.leaves(rst), "cpu")
    leaders = np.flatnonzero(np.asarray(rst.replica_is_leader)
                             & np.asarray(renv.replica_valid))
    cand = np.random.default_rng(3).choice(leaders, KL, replace=False).astype(np.int32)
    return dict(renv=renv, rst=rst, penv=penv, pst=pst, cand=cand,
                rgoals=ref_make_goals(CHAIN), pgoals=make_goals(CHAIN))


def bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.int32)


def same(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.array_equal(bits(a), bits(b))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def test_legit_leadership_mask(ctx):
    c = ctx["cand"]
    ref = ref_legit_leadership_mask(ctx["renv"], ctx["rst"], jnp.asarray(c))
    port = legit_leadership_mask(ctx["penv"], ctx["pst"], torch.as_tensor(c).long())
    assert same(ref, port)
    assert np.asarray(ref).any() and not np.asarray(ref).all()


@pytest.mark.parametrize("i", LEAD_GOALS, ids=[CHAIN[i] for i in LEAD_GOALS])
def test_leader_key_and_leadership_score(ctx, i):
    rg, pg = ctx["rgoals"][i], ctx["pgoals"][i]
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    sev_r = rg.broker_severity(renv, rst)
    sev_p = pg.broker_severity(penv, pst)
    assert same(sev_r, sev_p)
    assert same(rg.leader_key(renv, rst, sev_r), pg.leader_key(penv, pst, sev_p))
    c = ctx["cand"]
    ref = rg.leadership_score(renv, rst, jnp.asarray(c))
    port = pg.leadership_score(penv, pst, torch.as_tensor(c).long())
    assert same(ref, port)


@pytest.mark.parametrize("i", range(len(CHAIN)), ids=CHAIN)
def test_accept_leadership(ctx, i):
    c = ctx["cand"]
    ref = ctx["rgoals"][i].accept_leadership(ctx["renv"], ctx["rst"], jnp.asarray(c))
    port = ctx["pgoals"][i].accept_leadership(ctx["penv"], ctx["pst"],
                                              torch.as_tensor(c).long())
    assert same(ref, port)


@pytest.mark.parametrize("i", [1, 5, 6, 8, 9], ids=[CHAIN[i] for i in (1, 5, 6, 8, 9)])
def test_move_score_and_veto(ctx, i):
    rg, pg = ctx["rgoals"][i], ctx["pgoals"][i]
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    c = np.random.default_rng(i).choice(valid, 96, replace=False).astype(np.int32)
    ct_ = torch.as_tensor(c).long()
    sev_r = rg.broker_severity(renv, rst)
    assert same(rg.replica_key(renv, rst, sev_r),
                pg.replica_key(penv, pst, pg.broker_severity(penv, pst)))
    assert same(rg.move_score(renv, rst, jnp.asarray(c)), pg.move_score(penv, pst, ct_))
    veto = pg.move_row_veto(penv, pst, ct_)
    if veto is not None:
        ref = np.asarray(rg.accept_move(renv, rst, jnp.asarray(c)))
        assert (ref == ref[:, :1]).all()
        assert same(ref[:, 0], veto)


@pytest.mark.parametrize("i", NEW_GOALS, ids=[CHAIN[i] for i in NEW_GOALS])
def test_budgets_rooms_and_room_keys(ctx, i):
    rg, pg = ctx["rgoals"][i], ctx["pgoals"][i]
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    for name in ("wave_budgets", "wave_gain_budgets", "segment_room_key"):
        ref, port = getattr(rg, name)(renv, rst), getattr(pg, name)(penv, pst)
        assert (ref is None) == (port is None), name
        if ref is not None:
            ref = ref if isinstance(ref, tuple) else (ref,)
            port = port if isinstance(port, tuple) else (port,)
            assert all(same(a, b) for a, b in zip(ref, port)), name
    rr, pr = rg.accept_move_rooms(renv, rst), pg.accept_move_rooms(penv, pst)
    assert (rr is None) == (pr is None)
    for dim in (rr or {}):
        for a, b in zip(rr[dim], pr[dim]):
            assert (a is None and b is None) or same(a, b)
    assert same(rg.violated(renv, rst), pg.violated(penv, pst))
    assert same(rg.stat(renv, rst), pg.stat(penv, pst))
    # per-(topic, broker) budgets on a crowded set of rows
    rng = np.random.default_rng(i)
    n = 200
    topics = rng.integers(0, 4, n)
    src, dst = rng.integers(0, 32, n), rng.integers(0, 32, n)
    dc, dl = np.ones(n, np.float32), (rng.random(n) < 0.5).astype(np.float32)
    ref = rg.wave_topic_budgets(renv, rst, jnp.asarray(topics, jnp.int32),
                                jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
                                jnp.asarray(dc), jnp.asarray(dl))
    port = pg.wave_topic_budgets(penv, pst, torch.as_tensor(topics), torch.as_tensor(src),
                                 torch.as_tensor(dst), torch.as_tensor(dc),
                                 torch.as_tensor(dl))
    assert (ref is None) == (port is None)
    if ref is not None:
        assert all(same(a, b) for a, b in zip(ref, port))


def ref_lead_rows(ctx, i, cand, lkv):
    """engine.py:1003-1013 (``_lead_rows``, exact f32 mode)."""
    renv, rst, goals = ctx["renv"], ctx["rst"], ctx["rgoals"]
    goal = goals[i]
    m = ref_legit_leadership_mask(renv, rst, cand)
    for g in goals[:i]:
        m = m & g.accept_leadership(renv, rst, cand)
    sc = goal.leadership_score(renv, rst, cand)
    sc = jnp.where(m & (lkv > -jnp.inf)[:, None], sc, -jnp.inf)
    return np.asarray(jnp.max(sc, axis=1)), np.asarray(jnp.argmax(sc, axis=1))


@pytest.mark.parametrize("i", LEAD_GOALS, ids=[CHAIN[i] for i in LEAD_GOALS])
def test_lead_rows_twin(ctx, i):
    c = ctx["cand"]
    lkv = np.where(np.arange(KL) % 9 == 4, -np.inf, 1.0).astype(np.float32)
    best_r, f_r = ref_lead_rows(ctx, i, jnp.asarray(c), jnp.asarray(lkv))
    ct_ = torch.as_tensor(c).long()
    best_p, f_p = leadership_rows(*engine._lead_args(
        ctx["penv"], ctx["pst"], ctx["pgoals"][i], tuple(ctx["pgoals"][:i]), ct_,
        torch.as_tensor(lkv) > -torch.inf))
    assert same(best_r, best_p)
    assert same(f_r, f_p)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_leaderships_batched_bitwise(ctx, seed):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rng = np.random.default_rng(seed)
    table = np.asarray(renv.partition_replicas)
    src = ctx["cand"][:64]
    members = table[np.asarray(renv.replica_partition)[src]]
    ok = (members >= 0) & (members != src[:, None])
    pick = np.argmax(ok * rng.random(members.shape), axis=1)   # a random follower
    dst = members[np.arange(64), pick].astype(np.int32)
    mask = rng.random(64) < 0.7
    # compiled, as the engine runs it (the residual's folded scatter)
    ref = jax.jit(ref_state_mod.apply_leaderships_batched)(
        renv, rst, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    port = state_mod.apply_leaderships_batched(
        penv, pst, torch.as_tensor(src).long(), torch.as_tensor(dst).long(),
        torch.as_tensor(mask))
    for name, a in convert.leaves(ref).items():
        assert same(a, convert.leaves(port)[name]), name
    assert not np.array_equal(np.asarray(ref.replica_is_leader),
                              np.asarray(rst.replica_is_leader))


# --- the third slice: the usage goals' leadership (K6 capacity family) -------
DEFAULT = CHAIN[:9] + ["DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
                       "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
                       "TopicReplicaDistributionGoal"] + CHAIN[9:]
USAGE = list(range(9, 13))
USAGE_LEAD = [DEFAULT.index("NetworkOutboundUsageDistributionGoal"),
              DEFAULT.index("CpuUsageDistributionGoal")]


@pytest.fixture(scope="module")
def default_ctx(ctx):
    return dict(ctx, rgoals=ref_make_goals(DEFAULT), pgoals=make_goals(DEFAULT))


@pytest.mark.parametrize("i", USAGE, ids=[DEFAULT[i] for i in USAGE])
def test_usage_goal_tables(default_ctx, i):
    """Severity, keys, move score, budgets, rooms and room keys of the four
    resource-distribution goals, and their accept_leadership veto."""
    c = default_ctx
    rg, pg = c["rgoals"][i], c["pgoals"][i]
    renv, rst, penv, pst = c["renv"], c["rst"], c["penv"], c["pst"]
    sev_r = rg.broker_severity(renv, rst)
    assert same(sev_r, pg.broker_severity(penv, pst))
    sev_p = pg.broker_severity(penv, pst)
    assert same(rg.replica_key(renv, rst, sev_r), pg.replica_key(penv, pst, sev_p))
    assert same(rg.leader_key(renv, rst, sev_r), pg.leader_key(penv, pst, sev_p))
    cand = c["cand"]
    assert same(rg.move_score(renv, rst, jnp.asarray(cand)),
                pg.move_score(penv, pst, torch.as_tensor(cand).long()))
    assert same(rg.accept_leadership(renv, rst, jnp.asarray(cand)),
                pg.accept_leadership(penv, pst, torch.as_tensor(cand).long()))
    for name in ("wave_budgets", "wave_gain_budgets", "segment_room_key"):
        ref, port = getattr(rg, name)(renv, rst), getattr(pg, name)(penv, pst)
        ref = ref if isinstance(ref, tuple) else (ref,)
        port = port if isinstance(port, tuple) else (port,)
        assert all(same(a, b) for a, b in zip(ref, port)), name
    rr, pr = rg.accept_move_rooms(renv, rst), pg.accept_move_rooms(penv, pst)
    assert list(rr) == list(pr)
    for dim in rr:
        assert all(same(a, b) for a, b in zip(rr[dim], pr[dim]))
    assert same(rg.violated(renv, rst), pg.violated(penv, pst))
    assert same(rg.stat(renv, rst), pg.stat(penv, pst))


@pytest.mark.parametrize("i", USAGE_LEAD, ids=[DEFAULT[i] for i in USAGE_LEAD])
def test_usage_goal_leadership_score(default_ctx, i):
    """ResourceDistributionGoal.leadership_score (distribution.py:197-214)
    through K6's capacity family: bit-identical, some scores finite."""
    c = default_ctx
    ref = c["rgoals"][i].leadership_score(c["renv"], c["rst"], jnp.asarray(c["cand"]))
    port = c["pgoals"][i].leadership_score(c["penv"], c["pst"],
                                           torch.as_tensor(c["cand"]).long())
    assert same(ref, port)
    assert np.isfinite(np.asarray(ref)).any()


@pytest.mark.parametrize("i", USAGE_LEAD + [DEFAULT.index("LeaderReplicaDistributionGoal")],
                         ids=[DEFAULT[i] for i in USAGE_LEAD] + ["LeaderReplicaDistributionGoal"])
def test_default_lead_rows_twin(default_ctx, i):
    """K6 rows with the default chain's prefix: the usage goals' own
    leadership branch, and LeaderReplicaDistributionGoal behind the four
    usage goals' accept_leadership vetoes."""
    c = default_ctx
    cand = c["cand"]
    lkv = np.where(np.arange(KL) % 9 == 4, -np.inf, 1.0).astype(np.float32)
    best_r, f_r = ref_lead_rows(c, i, jnp.asarray(cand), jnp.asarray(lkv))
    ct_ = torch.as_tensor(cand).long()
    best_p, f_p = leadership_rows(*engine._lead_args(
        c["penv"], c["pst"], c["pgoals"][i], tuple(c["pgoals"][:i]), ct_,
        torch.as_tensor(lkv) > -torch.inf))
    assert same(best_r, best_p)
    assert same(f_r, f_p)
