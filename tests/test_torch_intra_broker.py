"""The intra-broker disk branch of the port against the JAX package.

On one state of the 32-broker JBOD spec (four logdirs per broker, one dead
broker, two brokers with a dead disk: replicas to heal on dead disks):

- both intra-broker goals' severity, replica key, ``disk_move_score``,
  ``accept_disk_move``, ``violated`` and ``stat``, and
  ``legit_disk_move_mask``;
- one ``_disk_move_branch_batched`` pass (K1, the K8 twins ``disk_rows`` and
  ``disk_apply``): ``disk_util``, ``replica_disk``, ``replica_offline``,
  ``moved`` and the applied count;

then the reference's ``tests/test_intra_broker.py`` mirrored through the
port, and ``tests/test_parity_fixtures.py``'s unbalanced4 intra-broker case
against the reference's run (from a fresh interpreter, see
torch_reference.py). Every comparison with the reference is exact: ints and
bools equal, floats bit-identical (tolerance 0)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import engine as ref_engine
from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goal as ref_make_goal
from cruise_control_tpu.analyzer.goals.base import (
    legit_disk_move_mask as ref_legit_disk_move_mask,
)
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as RefOptimizer
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer.engine import EngineParams, optimize_goal
from cruise_control_tpu_torch.analyzer.env import make_env
from cruise_control_tpu_torch.analyzer.goals import make_goal
from cruise_control_tpu_torch.analyzer.goals.base import legit_disk_move_mask
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.state import init_state
from cruise_control_tpu_torch.model import fixtures
from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
from torch_reference import one_torch_thread, reference_chain

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

JBOD32 = dict(num_brokers=32, num_racks=4, num_topics=8, num_partitions=1000,
              max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
              target_cpu_util=0.45, num_dead_brokers=1, num_brokers_with_dead_disk=2)
INTRA = ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
K = 96


@pytest.fixture(scope="module")
def ctx():
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**JBOD32)))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    penv = convert.env_from_arrays(convert.leaves(renv), "cpu")
    pst = convert.state_from_arrays(convert.leaves(rst), "cpu")
    # every replica on a dead disk of an alive broker, then random valid ones
    b = np.asarray(ct.replica_broker)
    d = np.asarray(ct.replica_disk)
    valid = np.asarray(ct.replica_valid)
    dead_disk = valid & np.asarray(ct.broker_alive)[b] & ~np.asarray(ct.broker_disk_alive)[b, d]
    heal = np.flatnonzero(dead_disk)
    rest = np.random.default_rng(5).choice(np.flatnonzero(valid & ~dead_disk),
                                           K - heal.size, replace=False)
    cand = np.concatenate([heal, rest]).astype(np.int32)
    assert heal.size > 4
    return dict(renv=renv, rst=rst, penv=penv, pst=pst, cand=cand, meta=meta)


def bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.int32)


def same(a, b) -> bool:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.array_equal(bits(a), bits(b))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def test_legit_disk_move_mask(ctx):
    c = ctx["cand"]
    ref = ref_legit_disk_move_mask(ctx["renv"], ctx["rst"], jnp.asarray(c))
    port = legit_disk_move_mask(ctx["penv"], ctx["pst"], torch.as_tensor(c).long())
    assert same(ref, port)
    assert np.asarray(ref).any() and not np.asarray(ref).all()


@pytest.mark.parametrize("name", INTRA)
def test_goal_spi_matches_reference(ctx, name):
    rg, pg = ref_make_goal(name), make_goal(name)
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    c = ctx["cand"]
    rsev = rg.broker_severity(renv, rst)
    psev = pg.broker_severity(penv, pst)
    assert same(rsev, psev)
    rkey = rg.replica_key(renv, rst, rsev)
    pkey = pg.replica_key(penv, pst, psev)
    assert same(rkey, pkey)
    assert (np.asarray(rkey) > -np.inf).sum() > 0
    pc = torch.as_tensor(c).long()
    assert same(rg.disk_move_score(renv, rst, jnp.asarray(c)),
                pg.disk_move_score(penv, pst, pc))
    assert same(rg.accept_disk_move(renv, rst, jnp.asarray(c)),
                pg.accept_disk_move(penv, pst, pc))
    assert bool(rg.violated(renv, rst)) == bool(pg.violated(penv, pst)) is True
    assert same(rg.stat(renv, rst), pg.stat(penv, pst))


def test_inter_broker_goal_is_indifferent_to_logdirs(ctx):
    c = torch.as_tensor(ctx["cand"]).long()
    g = make_goal("DiskCapacityGoal")
    assert g.disk_rule() is None
    assert bool(g.accept_disk_move(ctx["penv"], ctx["pst"], c).all())
    assert bool((g.disk_move_score(ctx["penv"], ctx["pst"], c) == -torch.inf).all())


@pytest.mark.parametrize("stall", [0, 3])
@pytest.mark.parametrize("name,prev", [
    ("IntraBrokerDiskCapacityGoal", ()),
    ("IntraBrokerDiskUsageDistributionGoal", ("IntraBrokerDiskCapacityGoal",)),
    ("IntraBrokerDiskCapacityGoal", ("IntraBrokerDiskUsageDistributionGoal",
                                     "DiskCapacityGoal")),
])
def test_disk_move_branch_pass_matches_reference(ctx, name, prev, stall):
    """One pass of the disk branch from the same state, the reference's
    eager ``_disk_move_branch_batched`` against the port's (K1 and the K8
    twins), with the scaled candidate count of the padded shape."""
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    params = RefOptimizer().scaled_params(renv.num_replicas, renv.num_brokers)
    pparams = GoalOptimizer(device="cpu").scaled_params(penv.num_replicas,
                                                        penv.num_brokers)
    assert params.num_candidates == pparams.num_candidates
    rg, pg = ref_make_goal(name), make_goal(name)
    rprev = tuple(ref_make_goal(n) for n in prev)
    pprev = tuple(make_goal(n) for n in prev)
    rst2, rn = ref_engine._disk_move_branch_batched(
        renv, rst, rg, rprev, params, rg.broker_severity(renv, rst), jnp.int32(stall))
    pst2, pn = engine._disk_move_branch_batched(
        penv, pst, pg, pprev, pparams, pg.broker_severity(penv, pst), stall)
    assert int(rn) == int(pn) > 0
    for leaf in ("disk_util", "replica_disk", "replica_offline", "moved",
                 "replica_broker", "util"):
        assert same(getattr(rst2, leaf), getattr(pst2, leaf)), leaf


# --- the reference's tests/test_intra_broker.py, through the port ----------
def _jbod_cluster(dead_disk=False, overfull=False):
    """2 brokers x 3 logdirs. Broker 0's disk0 is crowded; optionally dead or
    over capacity."""
    b = ClusterModelBuilder()
    for i in range(2):
        b.add_broker(i, rack=f"r{i}", logdirs=["/d0", "/d1", "/d2"],
                     disk_capacity=[1000.0, 1000.0, 1000.0], capacity={3: 3000.0},
                     dead_disks={"/d0"} if (dead_disk and i == 0) else set())
    for p in range(6):
        size = 300.0 if overfull else 120.0
        b.add_replica("t", p, 0, is_leader=True, load=[1.0, 10.0, 20.0, size],
                      logdir="/d0", offline=dead_disk)
        b.add_replica("t", p, 1, is_leader=False, load=[1.0, 10.0, 20.0, size],
                      logdir=f"/d{p % 3}")
    return b.build()


def _run(goal_name, ct, meta, prev=()):
    env = make_env(ct, meta, device="cpu")
    st = init_state(env, ct.replica_broker, ct.replica_is_leader,
                    ct.replica_offline, ct.replica_disk)
    st2, info = optimize_goal(env, st, make_goal(goal_name),
                              tuple(make_goal(n) for n in prev),
                              EngineParams(max_iters=64))
    return env, st, st2, info


def test_capacity_goal_moves_replicas_off_overfull_disk():
    ct, meta = _jbod_cluster(overfull=True)   # 6 * 300 = 1800 on a 1000-cap disk
    env, st0, st, info = _run("IntraBrokerDiskCapacityGoal", ct, meta)
    assert not info["violated_after"]
    assert info["disk_actions"] == info["iterations"] > 0
    assert torch.equal(st.replica_broker, st0.replica_broker)
    du = st.disk_util.numpy()
    assert (du[0] <= 0.8 * 1000.0 + 100.0).all()
    np.testing.assert_allclose(du[0].sum(), 1800.0, rtol=1e-5)


def test_capacity_goal_heals_dead_disk():
    ct, meta = _jbod_cluster(dead_disk=True)
    env, st0, st, info = _run("IntraBrokerDiskCapacityGoal", ct, meta)
    assert not info["violated_after"]
    du = st.disk_util.numpy()
    assert du[0, 0] == pytest.approx(0.0, abs=1e-6)   # dead disk drained
    rd, rb = st.replica_disk.numpy(), st.replica_broker.numpy()
    off, valid = st.replica_offline.numpy(), env.replica_valid.numpy()
    b0 = (rb == 0) & valid
    assert bool(st0.replica_offline.numpy()[b0].all())
    assert not off[b0].any()
    assert (rd[b0] != 0).all()


def test_distribution_goal_balances_disks_within_broker():
    ct, meta = _jbod_cluster()                # 720 MB all on broker0:/d0
    env, st0, st, info = _run("IntraBrokerDiskUsageDistributionGoal", ct, meta)
    assert not info["violated_after"]
    assert torch.equal(st.replica_broker, st0.replica_broker)
    pct = st.disk_util.numpy()[0] / 1000.0
    assert pct.max() <= pct.mean() * 1.09 + 1e-3
    assert float(info["stat"]) <= 1e-3


def test_capacity_accept_vetoes_overfilling_disk_move():
    ct, meta = _jbod_cluster(overfull=True)
    env, st0, st, info = _run("IntraBrokerDiskUsageDistributionGoal", ct, meta,
                              prev=("IntraBrokerDiskCapacityGoal",))
    assert (st.disk_util.numpy()[0] <= 0.8 * 1000.0 + 100.0 + 1e-3).all()


def test_optimizer_chain_emits_intra_broker_proposals():
    ct, meta = _jbod_cluster(overfull=True)
    res = GoalOptimizer(device="cpu").optimizations(ct, meta, goal_names=INTRA,
                                                    skip_hard_goal_check=True)
    assert "IntraBrokerDiskCapacityGoal" not in res.violated_goals_after
    assert res.proposals
    for p in res.proposals:
        assert [b for b, _ in p.old_replicas] == [b for b, _ in p.new_replicas]
        assert any(od != nd for (_, od), (_, nd) in zip(p.old_replicas, p.new_replicas))


def test_rebalance_disk_chain_drains_crowded_logdir():
    """The reference's ``/rebalance?rebalance_disk=true`` case (its
    ``test_rebalance_disk_end_to_end``) at the optimizer the request runs:
    the two intra-broker goals over the same layout (broker 0's six
    250 MB replicas on /d0) leave /d0 within its capacity limit and move
    no replica off its broker. The executor's intra-broker phase is not
    ported (ROADMAP Queue 1 item 12)."""
    b = ClusterModelBuilder()
    for i in range(2):
        b.add_broker(i, rack=f"r{i}", logdirs=["/d0", "/d1", "/d2"],
                     disk_capacity=[1000.0] * 3, capacity={3: 3000.0})
    for p in range(6):
        for j, broker in enumerate((0, 1)):
            b.add_replica("t", p, broker, is_leader=j == 0,
                          load=[1.0, 10.0, 20.0, 250.0],
                          logdir="/d0" if broker == 0 else f"/d{p % 3}")
    ct, meta = b.build()
    res = GoalOptimizer(device="cpu").optimizations(ct, meta, goal_names=INTRA,
                                                    skip_hard_goal_check=True)
    st = res.final_state
    assert res.num_replica_movements == 0 and res.proposals
    assert float(st.disk_util[meta.broker_index(0), 0]) <= 0.8 * 1000.0 + 100.0
    assert [r.disk_actions for r in res.goal_results][0] > 0


def test_distribution_goal_fills_underutilized_disk():
    """A below-lower-band logdir fills by draining in-band above-average
    disks (not only above-upper ones)."""
    b = ClusterModelBuilder()
    b.add_broker(0, rack="r0", logdirs=[f"/d{i}" for i in range(4)],
                 disk_capacity=[1000.0] * 4, capacity={3: 4000.0})
    b.add_broker(1, rack="r1", logdirs=["/d0"], disk_capacity=[1000.0])
    p = 0
    for d in range(3):
        for _ in range(11):
            b.add_replica("t", p, 0, is_leader=True, load=[0.1, 1.0, 1.0, 50.0],
                          logdir=f"/d{d}")
            b.add_replica("t", p, 1, is_leader=False, load=[0.1, 1.0, 1.0, 50.0])
            p += 1
    for _ in range(2):
        b.add_replica("t", p, 0, is_leader=True, load=[0.1, 1.0, 1.0, 50.0],
                      logdir="/d3")
        p += 1
    ct, meta = b.build()
    env, st0, st, info = _run("IntraBrokerDiskUsageDistributionGoal", ct, meta)
    du0, du1 = st0.disk_util.numpy()[0], st.disk_util.numpy()[0]
    assert du1.std() < du0.std()
    assert du1[3] > du0[3]
    assert not info["violated_after"]


def test_unbalanced4_intra_broker_disk_distribution(tmp_path):
    """``tests/test_parity_fixtures.py``'s unbalanced4 intra-broker case: the
    goal balances each broker's two logdirs with no inter-broker movement,
    and the port's run is the reference's bit for bit."""
    ref = reference_chain(tmp_path, "unbalanced_two_brokers",
                          ["IntraBrokerDiskUsageDistributionGoal"])
    ct, meta = fixtures.unbalanced_two_brokers()
    res = GoalOptimizer(device="cpu").optimizations(
        ct, meta, goal_names=["IntraBrokerDiskUsageDistributionGoal"],
        skip_hard_goal_check=True)
    R = ct.num_replicas
    assert np.array_equal(res.final_state.replica_broker.numpy()[:R], ct.replica_broker)
    assert "IntraBrokerDiskUsageDistributionGoal" not in res.violated_goals_after
    counts = dict(before=res.violated_goals_before, after=res.violated_goals_after,
                  actions=[g.iterations for g in res.goal_results],
                  passes=[g.passes for g in res.goal_results],
                  moves=res.num_replica_movements, leads=res.num_leadership_movements)
    assert counts == ref["counts"]
    assert [g.disk_actions for g in res.goal_results] == ref["disk"]
    for name in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert np.array_equal(ref["final"][name],
                              getattr(res.final_state, name).numpy()), name
    assert [dataclasses.astuple(p) for p in res.proposals] == ref["proposals"]
