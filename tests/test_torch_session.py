"""The port's ResidentClusterSession (``analyzer/session.py``) against the
reference's, mirroring ``tests/test_session.py``:

- delta ingest is bit-exact: after a scripted delta stream (a leadership
  flip, replica churn, a broker death, a disk failure, an appended topic,
  fresh windows) every env and state leaf equals the port's own
  from-scratch build of the final cluster AND the reference session's
  values;
- the deltas the session cannot express in place rebuild, as in the
  reference;
- ``optimizations(None, session=...)`` equals the model path, and the lend
  protocol leaves the carried result untouched by later rounds;
- K5's plain twin (``kernels.finalize``) against the reference's
  ``_sync_finalize`` on the reference's exact inputs (``convert``), and
  against numpy's big-endian ``unpackbits`` at R not a multiple of 8.

The reference's sessions run in a fresh interpreter
(``tests/torch_reference.py`` ``reference_session_case``). Tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer.env import make_env, padded_partition_table
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.session import (
    ResidentClusterSession, _rows_drift, sync_finalize,
)
from cruise_control_tpu_torch.analyzer.session_script import port_ns
from cruise_control_tpu_torch.analyzer.state import init_state
from cruise_control_tpu_torch.kernels.finalize import session_finalize_plain
from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
from torch_reference import (
    _fields, monitored, one_torch_thread, reference_session_case, scripted_delta_stream, session_case, session_test_backend,
)

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

NS = port_ns("cpu")


@pytest.fixture(scope="module")
def delta_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("session_delta")
    return session_case(NS, "delta"), reference_session_case(tmp, "delta")


def _rebuild(lm):
    """The port's from-scratch build of the monitor's current cluster,
    padded as the session's rebuild pads it."""
    ct, meta = pad_cluster(*lm.cluster_model())
    table = padded_partition_table(ct)
    env = make_env(ct, meta, partition_table=table, device="cpu")
    st = init_state(env, ct.replica_broker, ct.replica_is_leader,
                    ct.replica_offline, ct.replica_disk)
    return env, st, meta, table


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal values and shapes; floats compared as bits (the reference's
    compact int16 / int8 tables are int64 in the port)."""
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.array_equal(a.astype(np.float32).view(np.int32),
                              b.astype(np.float32).view(np.int32))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _assert_snapshots_equal(port: dict, ref: dict):
    for part in ("env", "state"):
        assert set(port[part]) == set(ref[part]), part
        for name, want in ref[part].items():
            if isinstance(want, int):
                assert port[part][name] == want, f"{part}.{name}"
            else:
                assert _same(port[part][name], want), f"{part}.{name}"
    assert _same(port["part_table"], ref["part_table"])
    for name, want in ref["mirrors"].items():
        assert _same(port["mirrors"][name], want), name
    assert port["meta"] == ref["meta"]


def test_delta_ingest_matches_the_reference_session(delta_case):
    port, ref = delta_case
    assert [m for m, _ in port["syncs"]] == [m for m, _ in ref["syncs"]] == [
        "rebuild", "delta", "delta"]
    assert port["churn"] == ref["churn"] > 0
    assert port["epoch"] == ref["epoch"] == 1
    for (_, p), (_, r) in zip(port["syncs"], ref["syncs"]):
        _assert_snapshots_equal(p, r)


def test_delta_ingest_bit_exact_vs_own_rebuild():
    """The tentpole certificate on the port alone: after the delta stream
    the resident env and state equal a from-scratch build, pad slots
    included."""
    be = session_test_backend(NS)
    lm = monitored(NS, be)
    sess = ResidentClusterSession(lm, device="cpu")
    assert sess.sync()["mode"] == "rebuild"
    scripted_delta_stream(be, lm)
    assert sess.sync()["mode"] == "delta"
    for _ in range(2):
        env, st, meta, table = _rebuild(lm)
        for obj, mine in ((env, sess.env), (st, sess.state)):
            for f in dataclasses.fields(obj):
                a, b = getattr(mine, f.name), getattr(obj, f.name)
                if isinstance(b, torch.Tensor):
                    assert a.dtype == b.dtype and torch.equal(a, b), f.name
                else:
                    assert a == b, f.name
        assert np.array_equal(sess.part_table, table)
        assert sess.meta.partition_ids == meta.partition_ids
        assert sess.meta.topic_names == meta.topic_names
        lm.sample_once(now_ms=9 * 300_000.0)
        assert sess.sync()["mode"] == "delta"


def test_fallback_triggers_rebuild_as_the_reference(tmp_path):
    port = session_case(NS, "fallback")
    ref = reference_session_case(tmp_path, "fallback")
    assert port["syncs"] == ref["syncs"]
    assert [m for m, _ in port["syncs"]] == ["rebuild"] * 4 + ["delta"]
    assert "broker set" in port["syncs"][1][1]
    assert "replication factor" in port["syncs"][2][1]
    assert "churn budget" in port["syncs"][3][1]
    assert port["epoch"] == ref["epoch"]
    _assert_snapshots_equal(port["snapshot"], ref["snapshot"])


def test_finalize_twin_matches_the_reference_on_its_inputs(delta_case):
    """K5's plain twin and the refresh behind it, started from the
    reference session's exact env and host mirrors (``convert``): the
    reference's ``_sync_finalize`` output, leaf for leaf."""
    _port, ref = delta_case
    for _mode, snap in ref["syncs"]:
        port_env = _port_env(snap)
        inputs = convert.finalize_inputs_from_arrays(dict(
            snap["mirrors"], lead_packed=snap["lead_packed"],
            leader_load=snap["env"]["leader_load"],
            follower_load=snap["env"]["follower_load"]), device="cpu")
        env, st = sync_finalize(port_env, *inputs)
        for name, want in snap["env"].items():
            if isinstance(want, int):
                assert getattr(env, name) == want, name
            else:
                assert _same(getattr(env, name).numpy(), want), f"env.{name}"
        for name, want in snap["state"].items():
            assert _same(getattr(st, name).numpy(), want), f"state.{name}"


def _port_env(snap: dict):
    """The port env of the reference session's env leaves, with the two
    leaves the finalize re-derives set wrong first."""
    e = dict(snap["env"])
    e["dst_candidate"] = ~e["dst_candidate"]
    e["replica_topic_excluded"] = ~e["replica_topic_excluded"]
    return convert.env_from_arrays(e, device="cpu")


@pytest.mark.parametrize("R", [1, 7, 8, 1003, 1024])
def test_finalize_twin_unpacks_big_endian_and_flags_offline(R):
    rng = np.random.default_rng(R)
    B, D, T = 13, 3, 5
    lead = rng.random(R) < 0.4
    packed = np.packbits(lead)
    broker = rng.integers(0, B, R)
    disk = rng.integers(0, D, R)
    topic = rng.integers(0, T, R)
    valid = rng.random(R) < 0.9
    alive = rng.random(B) < 0.8
    disk_alive = rng.random((B, D)) < 0.8
    texcl = rng.random(T) < 0.3
    excl = rng.random(B) < 0.2
    t = torch.from_numpy
    got = session_finalize_plain(t(packed), t(broker), t(disk), t(topic), t(valid),
                                 t(alive), t(disk_alive), t(texcl), t(excl))
    want = (np.unpackbits(packed)[:R].astype(bool),
            (~alive[broker] | ~disk_alive[broker, disk]) & valid,
            texcl[topic], alive & ~excl)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_session_round_matches_model_path_and_lends_its_state():
    """optimizations(None, session=...) == optimizations(ct, meta); the
    resident state is lent to the round (no copy) and rematerialized by the
    next sync; a later round never writes into the carried final_state."""
    be = session_test_backend(NS, seed=1, jbod=False)
    lm = monitored(NS, be)
    goals = ["ReplicaCapacityGoal", "ReplicaDistributionGoal",
             "LeaderReplicaDistributionGoal"]
    opt = GoalOptimizer(device="cpu")
    ct, meta = lm.cluster_model()
    res_a = opt.optimizations(ct, meta, goal_names=goals, raise_on_failure=False,
                              skip_hard_goal_check=True)
    sess = ResidentClusterSession(lm, device="cpu")
    sess.sync()
    lent = sess.state
    res_b = opt.optimizations(None, session=sess, goal_names=goals,
                              raise_on_failure=False, skip_hard_goal_check=True)
    assert sess.state is None and sess.donated_rounds == 1
    for key in ("violated_goals_before", "violated_goals_after",
                "num_replica_movements", "num_leadership_movements"):
        assert getattr(res_a, key) == getattr(res_b, key), key
    assert ([dataclasses.astuple(p) for p in res_a.proposals]
            == [dataclasses.astuple(p) for p in res_b.proposals])
    assert torch.equal(res_a.final_state.replica_broker, res_b.final_state.replica_broker)
    # the lent state's tensors are not the round's result, and the observed
    # assignment they hold was not written
    assert lent.replica_broker is not res_b.final_state.replica_broker
    assert torch.equal(lent.replica_broker, torch.from_numpy(
        sess._h["replica_broker"].astype(np.int64)))

    carried = _fields(res_b.final_state)
    carried_env = _fields(res_b.env)
    for t in (6, 7):
        lm.sample_once(now_ms=t * 300_000.0)
        assert sess.sync()["mode"] == "delta"
        be.elect_leaders({("t1", 1): be.partitions()[("t1", 1)].replicas[-1]})
        res_c = opt.optimizations(None, session=sess, goal_names=goals,
                                  raise_on_failure=False, skip_hard_goal_check=True)
        assert res_c.final_state is not res_b.final_state
    for name, want in carried.items():
        assert np.array_equal(_fields(res_b.final_state)[name], want), name
    for name, want in carried_env.items():
        assert np.array_equal(_fields(res_b.env)[name], want), name


def test_session_surface():
    be = session_test_backend(NS, seed=5)
    lm = monitored(NS, be)
    sess = ResidentClusterSession(lm, device="cpu")
    sess.sync()
    sizes = sess.device_bytes()
    assert sizes["env_bytes"] > 0 and sizes["state_bytes"] > 0
    assert sizes["state_bytes"] == sum(
        getattr(sess.state, f.name).nbytes for f in dataclasses.fields(sess.state))
    assert sess.epoch == 1 and sess.rebuild_rounds == 1
    # fleet spill and readmit: the device slots drop, the readmit is bit for bit
    before = {f.name: getattr(sess.state, f.name).clone()
              for f in dataclasses.fields(sess.state)}
    assert not sess.readmit() and sess.spill() and sess.spilled
    assert sess.device_bytes() == {"env_bytes": 0, "state_bytes": 0}
    assert sess.readmit() and not sess.spilled
    assert all(torch.equal(getattr(sess.state, n), v) for n, v in before.items())
    assert sess.state_json()["spills"] == sess.state_json()["readmits"] == 1
    # the pad-to-join floors pad the rebuild
    sess.bucket_floors = {"min_replicas": 4096}
    sess.invalidate()
    assert sess.sync()["mode"] == "rebuild" and sess.env.num_replicas == 4096
    with pytest.raises(NotImplementedError, match="item 15"):
        ResidentClusterSession(lm, device="cpu", mesh=object())
    with pytest.raises(RuntimeError, match="cuda"):
        import unittest.mock as mock
        with mock.patch.object(torch.cuda, "is_available", lambda: False):
            ResidentClusterSession(lm)


def test_rows_drift_is_exactly_zero_on_bit_stable_rows():
    rows = (np.arange(12, dtype=np.float32).reshape(3, 4), np.ones((3, 4), np.float32))
    assert _rows_drift(rows, tuple(r.copy() for r in rows)) == 0.0
    assert _rows_drift(rows, None) == float("inf")
    assert _rows_drift(rows, (rows[0][:2], rows[1])) == float("inf")
    moved = (rows[0] + np.float32(0.5), rows[1])
    assert _rows_drift(moved, rows) == pytest.approx(0.5 / 11.0)
