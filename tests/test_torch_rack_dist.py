"""RackAwareDistributionGoal and the rack-limit veto of the port against the
JAX package.

The goal caps each partition at ceil(RF / racks) replicas per rack. As a
previous goal it and RackAwareGoal (limit 1) veto moves through one per-row
limit that the K2 (``move_score_classes``) and K7 (``swap_rows``) twins
evaluate as ``others + 1 <= limit``. On one state of the 32-broker skewed
cluster at 4 racks (every limit 1) and at 2 racks (RF 3 gives limit 2),
carried over bit for bit by ``convert``, every comparison is exact
(indices, ints and bools equal, floats bit-identical; tolerance 0):

- the goal's limits, ``broker_severity``, ``replica_key``, ``violated``,
  ``stat`` and ``move_score`` (the GOAL_RACK_DIST family);
- the K2 twin with the goal active against the reference's
  ``_score_class_rows``;
- the K2 twin's veto masks against the AND of the reference's
  ``accept_move`` for the previous-goal sets [RackAwareGoal],
  [RackAwareDistributionGoal] and both;
- the K7 twin's legs against the reference's ``accept_swap``.

The chain ``RD_CHAIN`` on spec-32b-2r runs against the reference in a fresh
interpreter (torch_reference.py): counts, swap actions, assignment and
proposals bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import engine as ref_engine
from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goal as ref_make_goal
from cruise_control_tpu.analyzer.goals.base import legit_move_mask
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer.goals import make_goal
from cruise_control_tpu_torch.analyzer.goals.base import GoalKernel, swap_pairs
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.kernels import move_score as move_k
from cruise_control_tpu_torch.kernels import move_score_classes
from cruise_control_tpu_torch.kernels import swap as swap_k
from cruise_control_tpu_torch.model import random_cluster as port_rc
from torch_reference import one_torch_thread, reference_chain

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SMALL = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
             max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
SPECS = {4: SMALL, 2: dict(SMALL, num_racks=2)}          # spec-32b, spec-32b-2r
RD = "RackAwareDistributionGoal"
RD_CHAIN = [RD, "ReplicaCapacityGoal", "ReplicaDistributionGoal",
            "DiskUsageDistributionGoal"]
PREV = {"rack": ["RackAwareGoal"], "rack-dist": [RD], "both": ["RackAwareGoal", RD]}
K_ALL, T = 256, 16


@pytest.fixture(scope="module", params=sorted(SPECS), ids=lambda r: f"{r}racks")
def ctx(request):
    ct, meta = ref_ct_mod.pad_cluster(
        *ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPECS[request.param])))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    rows = np.random.default_rng(request.param).choice(valid, 96, replace=False)
    return dict(racks=request.param, renv=renv, rst=rst,
                penv=convert.env_from_arrays(convert.leaves(renv), "cpu"),
                pst=convert.state_from_arrays(convert.leaves(rst), "cpu"),
                rows=rows.astype(np.int32))


def bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.int32)


def port(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a)).long()


def test_limits_and_verdicts(ctx):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rg, pg = ref_make_goal(RD), make_goal(RD)
    lim_r = np.asarray(rg._max_per_rack(renv))
    lim_p = pg._limit(penv).numpy()
    assert np.array_equal(lim_r, lim_p)
    assert lim_p.max() == (1 if ctx["racks"] == 4 else 2)
    sev_r, sev_p = rg.broker_severity(renv, rst), pg.broker_severity(penv, pst)
    assert np.array_equal(bits(sev_r), bits(sev_p))
    assert np.array_equal(bits(rg.replica_key(renv, rst, sev_r)),
                          bits(pg.replica_key(penv, pst, sev_p)))
    assert bool(rg.violated(renv, rst)) == bool(pg.violated(penv, pst)) is True
    assert np.array_equal(bits(rg.stat(renv, rst)), bits(pg.stat(penv, pst)))


def test_family_twin(ctx):
    """``move_score`` of the GOAL_RACK_DIST family (no legitimacy), on the
    goal's own top candidates and on random rows."""
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    rg, pg = ref_make_goal(RD), make_goal(RD)
    key = rg.replica_key(renv, rst, rg.broker_severity(renv, rst))
    _, top = ref_engine._select_candidates(key, 64, jnp.int32(0), True,
                                           ref_engine.EngineParams())
    for cand in (np.asarray(top), ctx["rows"]):
        want = np.asarray(rg.move_score(renv, rst, jnp.asarray(cand)))
        got = pg.move_score(penv, pst, port(cand))
        assert np.array_equal(bits(want), bits(got))
        assert np.isfinite(want).any()


def ref_score_class_rows(renv, rst, goal, prev, cand, kv, T):
    """engine.py:776-792 (``_score_class_rows``, exact f32 mode)."""
    B = renv.num_brokers
    mask = legit_move_mask(renv, rst, cand, goal.options)
    for g in prev:
        mask = mask & g.accept_move(renv, rst, cand)
    sc = jnp.where(mask & (kv > -jnp.inf)[:, None], goal.move_score(renv, rst, cand),
                   -jnp.inf)
    Bp = -(-B // T) * T
    if Bp > B:
        sc = jnp.pad(sc, ((0, 0), (0, Bp - B)), constant_values=-jnp.inf)
    sv = sc.reshape(cand.shape[0], Bp // T, T)
    return np.asarray(jnp.max(sv, axis=1)), np.asarray(jnp.argmax(sv, axis=1))


@pytest.mark.parametrize("prev", ["none", "rack"])
def test_k2_twin_active(ctx, prev):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    names = PREV.get(prev, [])
    rg = ref_make_goal(RD)
    key = rg.replica_key(renv, rst, rg.broker_severity(renv, rst))
    kv, cand = ref_engine._select_candidates(key, K_ALL, jnp.int32(0), True,
                                             ref_engine.EngineParams())
    val_r, q_r = ref_score_class_rows(renv, rst, rg, [ref_make_goal(n) for n in names],
                                      cand, kv, T)
    cand_p, kv_p = port(cand), torch.tensor(np.asarray(kv))
    rooms, custom = engine._combined_move_rooms(tuple(make_goal(n) for n in names),
                                                penv, pst)
    val_p, q_p = move_score_classes(*engine._score_args(
        penv, pst, make_goal(RD), rooms, custom, cand_p, kv_p,
        engine.move_delta_rows(penv, pst, cand_p), T))
    assert np.array_equal(bits(val_r), bits(val_p))
    assert np.array_equal(q_r, q_p.numpy())
    assert np.isfinite(val_r).any()


@dataclasses.dataclass(frozen=True)
class _ScoresEverywhere(GoalKernel):
    """A probe active goal whose family scores 1 at every destination, so
    the K2 twin's row maxima over single-column classes are its mask."""

    def move_tables(self, env, st, cand):
        K, B = cand.shape[0], env.num_brokers
        return (move_k.GOAL_REPLICA_CAPACITY, torch.zeros((K, 4)), torch.ones((4, B)))


@pytest.mark.parametrize("prev", sorted(PREV))
def test_k2_veto_masks(ctx, prev):
    """The K2 twin's mask (legitimacy and the folded rack-limit veto of the
    previous goals) against ``legit_move_mask`` AND every reference
    ``accept_move``."""
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    cand = ctx["rows"]
    want = np.asarray(legit_move_mask(renv, rst, jnp.asarray(cand),
                                      ref_make_goal(RD).options))
    for n in PREV[prev]:
        want = want & np.asarray(ref_make_goal(n).accept_move(renv, rst, jnp.asarray(cand)))
    rooms, custom = engine._combined_move_rooms(tuple(make_goal(n) for n in PREV[prev]),
                                                penv, pst)
    assert not rooms and len(custom) == len(PREV[prev])
    cand_p = port(cand)
    B = penv.num_brokers
    val, _ = move_score_classes(*engine._score_args(
        penv, pst, _ScoresEverywhere(), rooms, custom, cand_p,
        torch.zeros(cand.shape[0]), engine.move_delta_rows(penv, pst, cand_p), B))
    got = (val > -torch.inf).numpy()
    assert np.array_equal(want, got)
    assert want.any() and not want.all()


@pytest.mark.parametrize("prev", sorted(PREV))
def test_k7_legs(ctx, prev):
    """The K7 twin's folded rack legs (each side's own limit, the chain's
    minimum) against the AND of the reference's ``accept_swap``."""
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    co, ci = ctx["rows"][:48], ctx["rows"][48:]
    want = np.ones((48, 48), bool)
    for n in PREV[prev]:
        want = want & np.asarray(ref_make_goal(n).accept_swap(
            renv, rst, jnp.asarray(co), jnp.asarray(ci)))
    co_p, ci_p = port(co), port(ci)
    accepts = [make_goal(n).swap_accept(penv, pst, co_p, ci_p) for n in PREV[prev]]
    ones = torch.ones(48, dtype=torch.bool)
    pairs = swap_pairs(penv, pst, co_p, ci_p, accepts, ones, ones)
    got = swap_k.vetoes_plain(pairs).numpy()
    assert np.array_equal(want, got)
    assert want.any() and not want.all()


def test_rack_dist_chain_2racks_matches_reference(tmp_path, monkeypatch):
    """spec-32b-2r (limit 2 for RF 3; padded R 1,024, so the finisher is
    compiled out): the limit in K2's move waves as the active family and as
    the later goals' previous-goal veto, and in K7's swap legs (the disk
    goal's swap passes evaluate them and admit none)."""
    spec = SPECS[2]
    ref = reference_chain(tmp_path, spec, RD_CHAIN)
    swap_limits = []

    def spy(p, t, min_gain, what="pass"):
        swap_limits.append(None if p.lim_out is None else int(p.lim_out.max()))
        return swap_k.swap_rows(p, t, min_gain, what)

    monkeypatch.setattr(engine, "swap_rows", spy)
    ct, meta = port_rc.generate_scale(port_rc.RandomClusterSpec(**spec))
    res = GoalOptimizer(device="cpu").optimizations(
        ct, meta, goal_names=RD_CHAIN, skip_hard_goal_check=True, raise_on_failure=False)
    g = res.goal_results
    counts = dict(before=res.violated_goals_before, after=res.violated_goals_after,
                  actions=[r.iterations for r in g], passes=[r.passes for r in g],
                  moves=res.num_replica_movements, leads=res.num_leadership_movements)
    assert counts == ref["counts"]
    assert counts == dict(before=[RD, "ReplicaDistributionGoal",
                                  "DiskUsageDistributionGoal"], after=[],
                          actions=[21, 0, 232, 18], passes=[4, 3, 18, 6], moves=244,
                          leads=197)
    assert [r.swap_actions for r in g] == ref["swaps"]
    assert swap_limits and set(swap_limits) == {2}
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(res.final_state, name).numpy()), name
    assert [dataclasses.astuple(p) for p in res.proposals] == ref["proposals"]
