"""The lane axis (K14) of the move wave's kernels on the CPU.

- each lane wrapper's twin (``select_candidates_lanes``,
  ``replica_keys_lanes``, ``move_score_classes_lanes``,
  ``wave_admission_lanes``) against its solo twin, lane by lane, on an
  adversarial stack: keys tied across lanes, a running subset with a frozen
  lane left out, a different stall and seed mask in every lane;
- the fleet's lane-folded move apply (``state.apply_moves_lanes``) against
  one solo ``apply_moves_batched`` per lane, every leaf bit for bit;
- a spy on the four lane wrappers: each is called once per wave whatever
  the number of lanes;
- the lane pass loop (``lanes.fleet_goal_loop``) against the solo
  ``engine._goal_loop`` per lane on lanes whose pass counts differ: the same
  carries and the same final state, bit for bit;
- ``convert.lane_stack_from_arrays`` (stacked leaves to a lane stack).

Exact throughout (tolerance 0)."""
import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch import fleet_script as fs
from cruise_control_tpu_torch.analyzer import engine, lanes
from cruise_control_tpu_torch.analyzer.env import make_env, padded_partition_table
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.state import (
    EngineState, apply_moves_batched, apply_moves_lanes, init_state,
)
from cruise_control_tpu_torch.kernels import (
    move_score_classes, select_candidates, select_candidates_lanes, wave_admission,
)
from cruise_control_tpu_torch.kernels.admission import wave_admission_lanes
from cruise_control_tpu_torch.kernels.move_score import move_score_classes_lanes
from cruise_control_tpu_torch.model import random_cluster as rc
from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SPEC = dict(num_brokers=24, num_partitions=400, num_racks=4, num_topics=6,
            max_replication=3, skew=1.5, target_cpu_util=0.45)
# four logdirs a broker, a dead broker and two dead disks: offline rows
JBOD = dict(SPEC, logdirs_per_broker=4, num_dead_brokers=1, num_brokers_with_dead_disk=2)
SEEDS = (5, 6, 7)
GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
# the 18-goal parity chain's order (the preferred-leader pass aside)
FULL = ["RackAwareGoal", "RackAwareDistributionGoal", "MinTopicLeadersPerBrokerGoal",
        "ReplicaCapacityGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
        "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
        "PotentialNwOutGoal", "DiskUsageDistributionGoal",
        "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
        "CpuUsageDistributionGoal", "TopicReplicaDistributionGoal",
        "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"]
MOVE_GOALS = [g.name for g in make_goals(FULL) if g.uses_replica_moves]
CHAINS = {"five": GOALS,
          "lead-swap": ["ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
                        "DiskUsageDistributionGoal", "TopicReplicaDistributionGoal",
                        "LeaderBytesInDistributionGoal"],
          "jbod": ["DiskCapacityGoal", "IntraBrokerDiskCapacityGoal",
                   "IntraBrokerDiskUsageDistributionGoal"]}


def _lanes(spec):
    raw = [rc.generate_scale(rc.RandomClusterSpec(**spec, seed=s)) for s in SEEDS]
    # one shape bucket: the largest padded dims as pad floors
    padded = [pad_cluster(ct, meta)[0] for ct, meta in raw]
    floors = dict(min_replicas=max(c.num_replicas for c in padded),
                  min_partitions=max(c.num_partitions for c in padded))
    out = []
    for ct, meta in raw:
        ct, meta = pad_cluster(ct, meta, **floors)
        env = make_env(ct, meta, partition_table=padded_partition_table(ct), device="cpu")
        out.append((env, init_state(env, ct.replica_broker, ct.replica_is_leader,
                                    ct.replica_offline, ct.replica_disk)))
    return out


@pytest.fixture(scope="module")
def all_cells():
    out = {}
    for name, spec in (("plain", SPEC), ("jbod", JBOD)):
        cs = _lanes(spec)
        out[name] = (cs, GoalOptimizer(device="cpu").scaled_params(
            cs[0][0].num_replicas, cs[0][0].num_brokers))
    return out


@pytest.fixture(scope="module")
def cells(all_cells):
    return all_cells["plain"]


def _stack(cells):
    return lanes.LaneStack([e for e, _ in cells], [s for _, s in cells])


def _same_state(a: EngineState, b: EngineState):
    for f in dataclasses.fields(EngineState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype.is_floating_point:
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f.name
        else:
            assert torch.equal(x, y), f.name


@pytest.mark.parametrize("k,salt", [(1, 0), (16, 101), (64, 0), (200, 101), (640, 0),
                                    (1000, 101), (2999, 101), (3000, 0)])
def test_select_lanes_twin_ties_stalls_masks(k, salt):
    R = 3000
    rng = np.random.default_rng(3)
    base = torch.as_tensor(np.round(rng.random(R) * 8).astype(np.float32))  # many ties
    key = torch.stack([base, base, -base, torch.zeros(R)])  # lanes 0/1 tied, 3 all-equal
    key[2, ::7] = -torch.inf
    key[0, 5] = -0.0
    key[1, 5] = 0.0
    stalls = [0, 3, 1, 0]
    mask = torch.as_tensor(rng.random((4, R)) < 0.6)
    mask[0] = True
    mask[3] = True
    kv, idx = select_candidates_lanes(key.contiguous(), k, stalls, salt=salt,
                                      seed_mask=mask.contiguous())
    for j in range(4):
        kv1, idx1 = select_candidates(key[j].contiguous(), k, stalls[j], salt=salt,
                                      seed_mask=mask[j].contiguous())
        assert torch.equal(idx[j], idx1)
        assert torch.equal(kv[j].view(torch.int32), kv1.view(torch.int32))
    # the tied lanes select by lowest index within the lane
    assert torch.equal(idx[3], torch.arange(k))


@pytest.mark.parametrize("cell,goal_name",
                         [("plain", g) for g in MOVE_GOALS]
                         + [("jbod", g) for g in ("RackAwareGoal", "DiskCapacityGoal",
                                                  "ReplicaDistributionGoal",
                                                  "DiskUsageDistributionGoal",
                                                  "LeaderReplicaDistributionGoal")])
def test_move_wave_lane_twins(all_cells, cell, goal_name):
    """One move wave of every running lane (a running subset, lane 1
    frozen) through the four lane wrappers against each lane's solo wave:
    its keys (the K1 keying when the goal has one), its top-k with its own
    stall and seed mask, its scores (under the union of the lanes' room
    masks, as the lane loop passes them) and its admission."""
    cs, params = all_cells[cell]
    stack = _stack(cs)
    goals = make_goals(FULL)
    gi = FULL.index(goal_name)
    goal, prev = goals[gi], tuple(goals[:gi])
    running = [2, 0]
    sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in running}
    key = lanes.lane_keys(stack, goal, running, sev, params)
    for j, l in enumerate(running):
        solo = goal.replica_key(stack.envs[l], stack.sts[l], sev[l])
        assert torch.equal(key[j].view(torch.int32), solo.view(torch.int32))
    R = stack.num_replicas
    K = min(params.num_candidates, R)
    rng = np.random.default_rng(gi)
    mask = torch.as_tensor(rng.random((2, R)) < 0.7)
    mask[1] = True
    stalls = [2, 0]
    kv, cand = select_candidates_lanes(key, K, stalls, seed_mask=mask.contiguous())
    preps = []
    for j, l in enumerate(running):
        kv1, cand1 = select_candidates(key[j].contiguous(), K, stalls[j],
                                       seed_mask=mask[j].contiguous())
        assert torch.equal(cand[j], cand1)
        preps.append(engine._score_prep(stack.envs[l], stack.sts[l], goal, prev, params,
                                        cand1, kv1))
    room_mask = 0
    for _d, a in preps:
        room_mask |= a[8]
    cls_val, cls_q = move_score_classes_lanes([a[:8] + (room_mask,) + a[9:]
                                               for _d, a in preps])
    fins = []
    for j, (l, (d_rows, a)) in enumerate(zip(running, preps)):
        v1, q1 = move_score_classes(*a)
        assert torch.equal(cls_val[j].view(torch.int32), v1.view(torch.int32))
        assert torch.equal(cls_q[j], q1)
        fins.append(engine._admission_from_scores(stack.envs[l], stack.sts[l], goal, prev,
                                                  params, cand[j], d_rows, v1, q1))
    win = wave_admission_lanes([f[2] for f in fins])
    for j, f in enumerate(fins):
        assert torch.equal(win[j], wave_admission(*f[2]))


@pytest.mark.parametrize("cell,seed", [("plain", 11), ("plain", 12), ("jbod", 11)])
def test_apply_moves_lanes_matches_solo(all_cells, cell, seed):
    cs, params = all_cells[cell]
    rng = np.random.default_rng(seed)
    envs = [e for e, _ in cs]
    sts = [s for _, s in cs]
    W = 40
    reps, dsts, masks = [], [], []
    for env in envs:
        valid = np.flatnonzero(env.replica_valid.numpy())
        reps.append(torch.as_tensor(rng.choice(valid, W, replace=False)))
        dsts.append(torch.as_tensor(rng.integers(0, env.num_brokers, W)))
        masks.append(torch.as_tensor(rng.random(W) < 0.7))
    out = apply_moves_lanes(envs, sts, torch.stack(reps), torch.stack(dsts),
                            torch.stack(masks))
    stack = _stack(cs)
    running = [2, 0]                     # lane 1 frozen: its rows untouched
    apply_moves_lanes([stack.envs[l] for l in running], [stack.sts[l] for l in running],
                      torch.stack([reps[l] for l in running]),
                      torch.stack([dsts[l] for l in running]),
                      torch.stack([masks[l] for l in running]), into=(stack.st_b, running))
    for l in range(3):
        solo = apply_moves_batched(envs[l], sts[l], reps[l], dsts[l], masks[l])
        _same_state(out[l], solo)
        _same_state(stack.sts[l], solo if l in running else sts[l])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_lane_wrappers_called_once_per_wave(cells, monkeypatch, n):
    """One pass of n lanes calls each lane wrapper once per wave: the same
    counts at every n."""
    cs, params = cells
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(lanes, name, wrapped)

    for name in ("replica_keys_lanes", "select_candidates_lanes",
                 "move_score_classes_lanes", "wave_admission_lanes"):
        spy(name, getattr(lanes, name))
    goal = make_goals(["DiskUsageDistributionGoal"])[0]
    one_pass = dataclasses.replace(params, max_iters=1, pass_waves=2)
    stack = _stack(cs[:n])
    carries, _q, _s = lanes.fleet_goal_loop(stack, goal, (), {l: one_pass for l in range(n)},
                                            list(range(n)), 0, {})
    waves = max(c["b_waves"] for c in carries.values())
    assert all(c["it"] == 1 for c in carries.values())
    assert waves in (1, 2)
    assert calls == {"replica_keys_lanes": 1, "select_candidates_lanes": 1,
                     "move_score_classes_lanes": waves, "wave_admission_lanes": waves}


@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("chain", list(CHAINS))
def test_lane_loop_matches_solo_loops(all_cells, chain, chunk):
    """Lanes whose pass counts differ (the move wave on the lane kernels,
    the disk, leadership and swap branches lane by lane): every lane's
    carries and final state are its solo loop's."""
    cs, params = all_cells["jbod" if chain == "jbod" else "plain"]
    goals = make_goals(CHAINS[chain])
    stack = _stack(cs)
    lp = {l: params for l in range(3)}
    prev: tuple = ()
    passes = set()
    for g in goals:
        solo = [engine._goal_loop(stack.envs[l], stack.state_copy(l), g, prev, params,
                                  finisher=False, chunk=chunk) for l in range(3)]
        carries, quiesce, stat0 = lanes.fleet_goal_loop(stack, g, prev, lp, [0, 1, 2],
                                                        chunk, {})
        for l, (st1, info) in enumerate(solo):
            _same_state(stack.sts[l], st1)
            assert carries[l]["it"] == info["passes"]
            assert carries[l]["n_applied"] == info["iterations"]
            assert np.float32(stat0[l]) == np.float32(info["stat_before"])
            if chunk:
                assert quiesce[l] == info["quiesce_chunk"]
            passes.add(info["passes"])
        prev = prev + (g,)
    assert len(passes) > 1


def test_lane_stack_from_stacked_arrays(cells):
    cs, _params = cells
    envs = [convert.leaves(e) for e, _ in cs]
    sts = [convert.leaves(s) for _, s in cs]
    env_b = {n: (np.stack([e[n] for e in envs]) if hasattr(envs[0][n], "shape")
                 and n not in ("num_racks", "max_rf") else envs[0][n]) for n in envs[0]}
    env_b["num_real_racks"] = np.asarray([e["num_real_racks"] for e in envs])
    st_b = {n: np.stack([s[n] for s in sts]) for n in sts[0]}
    stack = convert.lane_stack_from_arrays(env_b, st_b, "cpu")
    assert stack.size == 3
    for l, (env, st) in enumerate(cs):
        _same_state(stack.sts[l], st)
        assert torch.equal(stack.envs[l].leader_load, env.leader_load)
        assert stack.envs[l].num_real_racks == env.num_real_racks


@pytest.mark.parametrize("rounds", [2])
def test_fleet_e2e_small_lanes_equal_solo_rounds(rounds):
    """The fleet-16x100b script at its tier-1 cut (3 tenants of 16 brokers,
    the sixteen default goals, the gated chunked fleet path) on the CPU:
    each tenant's round-1 row is its solo round's, and round 2 (delta
    syncs) runs one launch for every tenant."""
    ns = fs.port_fleet_ns("cpu")
    solo = fs.solo_e2e(ns, fs.FLEET_SMALL)
    run = fs.fleet_e2e(ns, fs.FLEET_SMALL, rounds=rounds)
    run.pop("fleet").shutdown()
    assert run["rounds"][0] == solo["rows"]
    assert all(r["launches"] == 1 and len(r["optimized"]) == fs.FLEET_SMALL["tenants"]
               for r in run["reports"])


# ---------------------------------------------------------------------------
# K14's second part: the leadership and swap branches and the probe
# ---------------------------------------------------------------------------
LEAD_GOALS = [g for g in FULL if make_goals([g])[0].uses_leadership_moves]
SWAP_GOALS = [g for g in FULL if make_goals([g])[0].uses_swaps]


@pytest.mark.parametrize("cell,goal_name", [("plain", g) for g in LEAD_GOALS]
                         + [("jbod", "LeaderReplicaDistributionGoal")])
def test_leadership_lane_twins(all_cells, cell, goal_name):
    """One leadership wave of every running lane (lane 1 frozen) through
    the lane wrappers against each lane's solo wave: the leader keys, K1 at
    KL with each lane's stall, K6 (``leadership_rows_lanes``), K3 and the
    folded apply (``apply_leaderships_lanes``), every leaf bit for bit."""
    from cruise_control_tpu_torch.analyzer.state import (
        apply_leaderships_batched, apply_leaderships_lanes,
    )
    from cruise_control_tpu_torch.kernels import leadership_rows, leadership_rows_lanes
    cs, params = all_cells[cell]
    stack = _stack(cs)
    goals = make_goals(FULL)
    gi = FULL.index(goal_name)
    goal, prev = goals[gi], tuple(goals[:gi])
    running = [2, 0]
    sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in running}
    key = lanes.lane_keys(stack, goal, running, sev, params, "leader_key")
    kl = min(params.num_leader_candidates, stack.num_replicas)
    stalls = [1, 0]
    lkv, lcand = select_candidates_lanes(key, kl, stalls)
    args = []
    for j, l in enumerate(running):
        solo_key = goal.leader_key(stack.envs[l], stack.sts[l], sev[l])
        assert torch.equal(key[j].view(torch.int32), solo_key.view(torch.int32))
        kv1, c1 = select_candidates(solo_key.contiguous(), kl, stalls[j])
        assert torch.equal(lcand[j], c1)
        args.append(engine._lead_args(stack.envs[l], stack.sts[l], goal, prev, c1,
                                      kv1 > -torch.inf))
    best, f_all = leadership_rows_lanes(
        args, (running, stack.st_b.replica_broker, stack.st_b.replica_offline))
    adm = []
    for j, l in enumerate(running):
        b1, f1 = leadership_rows(*args[j])
        assert torch.equal(best[j].view(torch.int32), b1.view(torch.int32))
        assert torch.equal(f_all[j], f1)
        adm.append(engine._lead_admission_from_scores(stack.envs[l], stack.sts[l], goal,
                                                      prev, params, lcand[j], b1, f1))
    win = wave_admission_lanes([a[2] for a in adm])
    for j, a in enumerate(adm):
        assert torch.equal(win[j], wave_admission(*a[2]))
    envs = [stack.envs[l] for l in running]
    sts = [stack.sts[l] for l in running]
    new = apply_leaderships_lanes(envs, sts, torch.stack([a[0] for a in adm]),
                                  torch.stack([a[1] for a in adm]), win)
    for j in range(len(running)):
        _same_state(new[j], apply_leaderships_batched(envs[j], sts[j], adm[j][0],
                                                      adm[j][1], win[j]))


def test_lane_wrappers_refuse_rows_of_other_lanes(cells):
    """K6's and K7's lane wrappers read each lane's assignment (racks and
    topic counts) from its stack row at the lane index list: a list that
    names other rows than the lanes' own is refused, on any device."""
    from cruise_control_tpu_torch.kernels import leadership_rows_lanes, swap_rows_lanes
    cs, params = cells
    stack = _stack(cs)
    goals = make_goals(FULL)
    lead = goals[FULL.index("LeaderReplicaDistributionGoal")]
    swap_goal = goals[FULL.index(SWAP_GOALS[0])]
    running = [2, 0]
    k = min(params.num_swap_candidates, stack.num_replicas, 128)
    largs, pairs, tables = [], [], []
    for l in running:
        env, st = stack.envs[l], stack.sts[l]
        kv, cand = select_candidates(lead.leader_key(env, st, lead.broker_severity(env, st))
                                     .contiguous(), 8, 0)
        largs.append(engine._lead_args(env, st, lead, (), cand, kv > -torch.inf))
        okv, co, ikv, ci = engine._swap_pools(env, st, swap_goal, params,
                                              swap_goal.broker_severity(env, st), 0)
        pr, tb = engine._swap_args(env, st, swap_goal, (), co[:k], okv[:k], ci[:k],
                                   ikv[:k])
        pairs.append(pr)
        tables.append(tb)
    for lanes_ in ([0, 2], [2]):
        with pytest.raises(ValueError, match="stack row"):
            leadership_rows_lanes(largs, (lanes_, stack.st_b.replica_broker,
                                          stack.st_b.replica_offline))
        with pytest.raises(ValueError, match="stack row"):
            swap_rows_lanes(pairs, tables, params.min_gain,
                            (lanes_, stack.env_b.broker_rack, stack.st_b.topic_broker_count))


@pytest.mark.parametrize("fold_legs", [False, True])
@pytest.mark.parametrize("goal_name", SWAP_GOALS)
def test_swap_lane_twins(cells, goal_name, fold_legs):
    """One swap wave of every running lane through the lane wrappers
    against each lane's solo wave: both pools, K7 ``swap_rows_lanes`` and
    ``swap_admission_lanes``, and the two-leg apply
    (``apply_swaps_lanes``, each lane's residual fold in its solo order)."""
    from cruise_control_tpu_torch.analyzer.state import apply_swaps_batched, apply_swaps_lanes
    from cruise_control_tpu_torch.kernels import (
        swap_admission, swap_admission_lanes, swap_rows, swap_rows_lanes,
    )
    cs, params = cells
    stack = _stack(cs)
    goals = make_goals(FULL)
    gi = FULL.index(goal_name)
    goal, prev = goals[gi], tuple(goals[:gi])
    running = [2, 0, 1]
    sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in running}
    k = min(params.num_swap_candidates, stack.num_replicas, 128)
    stalls = [0, 2, 1]
    okv, co = select_candidates_lanes(
        lanes.lane_keys(stack, goal, running, sev, params, "swap_out_key"), k, stalls)
    ikv, ci = select_candidates_lanes(
        lanes.lane_keys(stack, goal, running, sev, params, "swap_in_key"), k, stalls,
        salt=101)
    pairs, tables = [], []
    for j, l in enumerate(running):
        okv1, co1, ikv1, ci1 = engine._swap_pools(stack.envs[l], stack.sts[l], goal, params,
                                                  sev[l], stalls[j])
        assert torch.equal(co[j], co1) and torch.equal(ci[j], ci1)
        p, t = engine._swap_args(stack.envs[l], stack.sts[l], goal, prev, co1, okv1, ci1,
                                 ikv1)
        pairs.append(p)
        tables.append(t)
    best, bj, cnt = swap_rows_lanes(
        pairs, tables, params.min_gain,
        (running, stack.env_b.broker_rack, stack.st_b.topic_broker_count))
    adm = []
    for j, l in enumerate(running):
        b1, j1, c1 = swap_rows(pairs[j], tables[j], params.min_gain)
        assert torch.equal(best[j].view(torch.int32), b1.view(torch.int32))
        assert torch.equal(bj[j], j1) and torch.equal(cnt[j], c1)
        adm.append(engine._swap_admission_inputs(stack.envs[l], pairs[j], co[j], ci[j], b1,
                                                 j1))
    win = swap_admission_lanes(*(torch.stack([a[2][i] for a in adm]) for i in range(6)),
                               params.min_gain)
    for j, a in enumerate(adm):
        assert torch.equal(win[j], swap_admission(*a[2], params.min_gain))
    envs = [stack.envs[l] for l in running]
    sts = [stack.sts[l] for l in running]
    new = apply_swaps_lanes(envs, sts, torch.stack([a[0] for a in adm]),
                            torch.stack([a[1] for a in adm]), win, fold_legs)
    for j in range(len(running)):
        _same_state(new[j], apply_swaps_batched(envs[j], sts[j], adm[j][0], adm[j][1],
                                                win[j], fold_legs))


def test_swap_admission_lane_twin_adversarial():
    """Tied values, shared brokers and partitions across rows, a lane of
    no eligible row: each lane's winners are its solo admission's."""
    from cruise_control_tpu_torch.kernels import swap_admission, swap_admission_lanes
    rng = np.random.default_rng(9)
    La, n = 4, 48
    val = torch.as_tensor(rng.integers(-2, 3, (La, n)).astype(np.float32))
    val[3] = -1.0
    rows = [torch.as_tensor(rng.integers(0, 6, (La, n))) for _ in range(5)]
    win = swap_admission_lanes(val, *rows, 0.0)
    for j in range(La):
        assert torch.equal(win[j], swap_admission(val[j], *(r[j] for r in rows), 0.0))
    assert not win[3].any()


@pytest.mark.parametrize("goal_name", ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
                                       "LeaderReplicaDistributionGoal",
                                       "LeaderBytesInDistributionGoal",
                                       "IntraBrokerDiskUsageDistributionGoal"])
def test_probe_lanes_match_solo_probes(all_cells, goal_name):
    """The gated chain's probe of every lane in one K13 launch
    (``lanes.probe_lanes``) equals each lane's ``seeded_work_probe``, on
    all-true, all-false and sparse masks."""
    from cruise_control_tpu_torch.kernels import seeded_probe, seeded_probe_lanes
    cs, _params = all_cells["jbod" if goal_name.startswith("Intra") else "plain"]
    stack = _stack(cs)
    goal = make_goals([goal_name])[0]
    R = stack.num_replicas
    rng = np.random.default_rng(4)
    masks = [torch.ones(R, dtype=torch.bool), torch.zeros(R, dtype=torch.bool),
             torch.as_tensor(rng.random(R) < 0.02)]
    got = lanes.probe_lanes(stack, goal, [0, 1, 2], masks)
    want = [bool(goal.seeded_work_probe(stack.envs[l], stack.sts[l], masks[l]))
            for l in range(3)]
    assert got.tolist() == want
    assert want[1] is False
    keys = torch.stack([torch.full((R,), -torch.inf), torch.full((R,), float("nan")),
                        torch.where(torch.arange(R) == 7, 1.0, -torch.inf)])
    m = torch.stack(masks).contiguous()
    m[2, 7] = True
    assert seeded_probe_lanes(m, [keys]).tolist() == [
        bool(seeded_probe(m[j], [keys[j]])) for j in range(3)] == [False, False, True]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_branch_lane_wrappers_called_once_per_pass(cells, monkeypatch, n):
    """One pass of n lanes: the leadership branch (LeaderReplicaDistributionGoal,
    leadership-primary) and the swap branch (DiskUsageDistributionGoal,
    its moves off) call each lane wrapper the same number of times at
    every n, and the probe launches once for all lanes."""
    cs, params = cells
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(lanes, name, wrapped)

    for name in ("replica_keys_lanes", "select_candidates_lanes", "leadership_rows_lanes",
                 "wave_admission_lanes", "swap_rows_lanes", "swap_admission_lanes",
                 "seeded_probe_lanes"):
        spy(name, getattr(lanes, name))
    stack = _stack(cs[:n])
    lanes_ = list(range(n))
    goals = make_goals(FULL)
    lead = goals[FULL.index("LeaderReplicaDistributionGoal")]
    sev = {l: lead.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes_}
    lanes.lead_branch_lanes(stack, lead, (), params, sev, {l: 0 for l in lanes_}, lanes_, {})
    assert calls == {"select_candidates_lanes": 1, "leadership_rows_lanes": 1,
                     "wave_admission_lanes": 1}
    calls.clear()
    swap = goals[FULL.index("DiskUsageDistributionGoal")]
    sev = {l: swap.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes_}
    lanes.swap_branch_lanes(stack, swap, (), params, sev, {l: 0 for l in lanes_}, lanes_, {},
                            True)
    assert calls == {"replica_keys_lanes": 2, "select_candidates_lanes": 2,
                     "swap_rows_lanes": 1, "swap_admission_lanes": 1}
    calls.clear()
    lanes.probe_lanes(stack, swap, lanes_, [torch.ones(stack.num_replicas,
                                                       dtype=torch.bool)] * n)
    assert calls == {"replica_keys_lanes": 2, "seeded_probe_lanes": 1}


SPEC32 = dict(num_brokers=32, num_partitions=300, num_racks=4, num_topics=8,
              max_replication=3, skew=1.5, target_cpu_util=0.45)
DEFAULT16 = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
             "DiskCapacityGoal", "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
             "CpuCapacityGoal", "ReplicaDistributionGoal", "PotentialNwOutGoal",
             "DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
             "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
             "TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
             "LeaderBytesInDistributionGoal"]


def test_sixteen_goal_lane_loop_matches_solo_loops():
    """The sixteen default goals (leadership-primary and swap goals among
    them) at 3 lanes x 32 brokers, chunked: every lane's carries and final
    state are its solo loop's, bit for bit; the leadership and swap
    branches ran on the lane kernels."""
    cs = _lanes(SPEC32)
    params = GoalOptimizer(device="cpu").scaled_params(cs[0][0].num_replicas,
                                                       cs[0][0].num_brokers)
    stack = _stack(cs)
    lp = {l: params for l in range(3)}
    prev: tuple = ()
    branch_actions = {"leads": 0, "swaps": 0}
    for g in make_goals(DEFAULT16):
        solo = [engine._goal_loop(stack.envs[l], stack.state_copy(l), g, prev, params,
                                  finisher=False, chunk=3) for l in range(3)]
        carries, _q, _s = lanes.fleet_goal_loop(stack, g, prev, lp, [0, 1, 2], 3, {})
        for l, (st1, info) in enumerate(solo):
            _same_state(stack.sts[l], st1)
            assert carries[l]["it"] == info["passes"]
            assert carries[l]["n_applied"] == info["iterations"]
            assert carries[l]["b_leads"] == info["lead_actions"]
            assert carries[l]["b_swaps"] == info["swap_actions"]
            branch_actions["leads"] += info["lead_actions"]
            branch_actions["swaps"] += info["swap_actions"]
        prev = prev + (g,)
    assert branch_actions["leads"] > 0 and branch_actions["swaps"] > 0
