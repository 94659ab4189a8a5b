"""The port's workload tensor, env and state against the JAX package on the
same inputs: builder, random generators and padding give equal arrays;
make_env / init_state give equal leaves; a random wave of
apply_moves_batched matches the reference and refresh()."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.model import builder as ref_builder
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import env as env_mod
from cruise_control_tpu_torch.analyzer import state as state_mod
from cruise_control_tpu_torch.model import builder as port_builder
from cruise_control_tpu_torch.model import cluster_tensor as port_ct_mod
from cruise_control_tpu_torch.model import random_cluster as port_rc
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SPECS = {
    "plain-12b": dict(num_brokers=12, num_racks=3, num_topics=5, num_partitions=60,
                      seed=7),
    "dead-jbod-20b": dict(num_brokers=20, num_racks=4, num_topics=6,
                          num_partitions=150, num_dead_brokers=2,
                          num_brokers_with_dead_disk=1, logdirs_per_broker=2,
                          distribution="uniform", seed=11),
    "skewed-32b": dict(num_brokers=32, num_partitions=1000, num_racks=4,
                       num_topics=8, max_replication=3, skew=1.5, seed=3141,
                       target_cpu_util=0.45),
}


def _fixture(builder_cls):
    """The engine's 16-broker integer-load fixture, built by either package."""
    b = builder_cls()
    for i in range(16):
        b.add_broker(i, rack=f"r{i % 4}")
    p = 0
    for i in range(8):
        for j in range(16):
            load = [1.0, 50.0, 100.0, 500.0 + 10 * (p % 7)]
            b.add_replica("load", p, i, is_leader=True, load=load)
            if j % 4 == 0:
                b.add_replica("load", p, (i + 1) % 8, is_leader=False, load=load)
            p += 1
    b.add_broker(16, rack="r0", alive=False)
    b.add_replica("dead", 0, 16, is_leader=True, load=[2.0, 3.0, 4.0, 5.0])
    b.exclude_topics("dead")
    return b.build()


def _assert_same_arrays(ref_obj, port_obj):
    ref, port = convert.leaves(ref_obj), convert.leaves(port_obj)
    assert set(ref) == set(port)
    for name, a in ref.items():
        b = port[name]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, name
            if a.dtype.kind == "f":
                assert np.array_equal(a.astype(np.float32).view(np.int32),
                                      b.astype(np.float32).view(np.int32)), name
            else:
                assert np.array_equal(a, b), name
        else:
            assert a == b, name


def _assert_same_meta(ref_meta, port_meta):
    for f in dataclasses.fields(port_meta):
        assert getattr(ref_meta, f.name) == getattr(port_meta, f.name), f.name


def test_builder_matches_reference():
    ref_ct, ref_meta = _fixture(ref_builder.ClusterModelBuilder)
    ct, meta = _fixture(port_builder.ClusterModelBuilder)
    _assert_same_arrays(ref_ct, ct)
    _assert_same_meta(ref_meta, meta)


@pytest.mark.parametrize("gen", ["generate", "generate_scale"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_random_cluster_and_padding_match_reference(spec, gen):
    ref_ct, ref_meta = getattr(ref_rc, gen)(ref_rc.RandomClusterSpec(**SPECS[spec]))
    ct, meta = getattr(port_rc, gen)(port_rc.RandomClusterSpec(**SPECS[spec]))
    _assert_same_arrays(ref_ct, ct)
    _assert_same_meta(ref_meta, meta)
    ref_p, ref_pm = ref_ct_mod.pad_cluster(ref_ct, ref_meta)
    p, pm = port_ct_mod.pad_cluster(ct, meta)
    _assert_same_arrays(ref_p, p)
    _assert_same_meta(ref_pm, pm)


def _both(spec):
    """(reference env, reference state, port env, port state) of one padded
    cluster; the port side is built by its own make_env / init_state."""
    ref_ct, ref_meta = ref_ct_mod.pad_cluster(
        *ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPECS[spec])))
    ct, meta = port_ct_mod.pad_cluster(
        *port_rc.generate_scale(port_rc.RandomClusterSpec(**SPECS[spec])))
    renv = ref_env_mod.make_env(ref_ct, ref_meta)
    rst = ref_state_mod.init_state(renv, ref_ct.replica_broker,
                                   ref_ct.replica_is_leader, ref_ct.replica_offline,
                                   ref_ct.replica_disk)
    penv = env_mod.make_env(ct, meta, device="cpu")
    pst = state_mod.init_state(penv, ct.replica_broker, ct.replica_is_leader,
                               ct.replica_offline, ct.replica_disk)
    return renv, rst, penv, pst


@pytest.mark.parametrize("spec", ["dead-jbod-20b", "skewed-32b"])
def test_make_env_and_init_state_match_reference(spec):
    renv, rst, penv, pst = _both(spec)
    _assert_same_arrays(renv, penv)
    _assert_same_arrays(rst, pst)
    # the leaves carried over by convert rebuild the same env and state
    _assert_same_arrays(renv, convert.env_from_arrays(convert.leaves(renv), "cpu"))
    _assert_same_arrays(rst, convert.state_from_arrays(convert.leaves(rst), "cpu"))


def _random_wave(penv, pst, n, seed):
    """A wave of ``n`` distinct replicas to random destinations that hold no
    replica of their partition, with a random mask."""
    rng = np.random.default_rng(seed)
    valid = np.flatnonzero(penv.replica_valid.numpy())
    rep = rng.choice(valid, size=n, replace=False)
    rb = pst.replica_broker.numpy()
    members = penv.partition_replicas.numpy()[penv.replica_partition.numpy()[rep]]
    dst = []
    for r, mem in zip(rep, members):
        taken = {rb[m] for m in mem if m >= 0}
        free = [b for b in np.flatnonzero(penv.dst_candidate.numpy()) if b not in taken]
        dst.append(rng.choice(free))
    # one partition moves at most once per wave (the engine's first-touch rule)
    part = penv.replica_partition.numpy()[rep]
    first = np.unique(part, return_index=True)[1]
    mask = np.zeros(n, bool)
    mask[first] = rng.random(first.size) < 0.8
    return rep, np.asarray(dst), mask


@pytest.mark.parametrize("spec", ["dead-jbod-20b", "skewed-32b"])
def test_apply_moves_batched_matches_reference_and_refresh(spec):
    renv, rst, penv, pst = _both(spec)
    for wave in range(3):
        rep, dst, mask = _random_wave(penv, pst, 24, seed=wave)
        # compiled, as the engine runs it: XLA folds _kahan_scatter2's scatter
        # into zeros into the residual's add (state.residual_inputs)
        rst = jax.jit(ref_state_mod.apply_moves_batched)(
            renv, rst, jnp.asarray(rep, jnp.int32), jnp.asarray(dst, jnp.int32),
            jnp.asarray(mask))
        pst = state_mod.apply_moves_batched(
            penv, pst, torch.as_tensor(rep), torch.as_tensor(dst),
            torch.as_tensor(mask))
        # the incremental tallies, residuals included, are bit-identical
        _assert_same_arrays(rst, pst)
    fresh = state_mod.refresh(penv, pst)
    for name in ("replica_count", "leader_count", "part_rack_count",
                 "topic_broker_count", "topic_leader_count"):
        assert torch.equal(getattr(fresh, name), getattr(pst, name)), name
    for name in ("util", "leader_util", "potential_nw_out", "disk_util"):
        torch.testing.assert_close(getattr(pst, name), getattr(fresh, name),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("triggered", [False, True])
def test_env_threshold_helpers_match_reference(triggered):
    renv, _rst, penv, _pst = _both("dead-jbod-20b")
    assert np.array_equal(bits32(ref_env_mod.capacity_stripe_key(renv)),
                          bits32(env_mod.capacity_stripe_key(penv)))
    ref_c = ref_env_mod.BalancingConstraint(
        low_utilization_threshold=(0.0, 0.2, 0.0, 0.3),
        goal_violation_distribution_threshold_multiplier=1.5)
    port_c = env_mod.BalancingConstraint(
        low_utilization_threshold=(0.0, 0.2, 0.0, 0.3),
        goal_violation_distribution_threshold_multiplier=1.5)
    avg = np.asarray([0.05, 0.19, 0.2, 0.31, 0.75], np.float32)
    for r in range(4):
        lo_r, up_r = ref_env_mod.resource_balance_limits(jnp.asarray(avg), ref_c, r,
                                                         triggered)
        lo_p, up_p = env_mod.resource_balance_limits(torch.tensor(avg), port_c, r,
                                                     triggered)
        assert np.array_equal(bits32(lo_r), bits32(lo_p))
        assert np.array_equal(bits32(up_r), bits32(up_p))


def bits32(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


@pytest.mark.parametrize("n", [5, 100, 129, 8193, 98326])
def test_f32_sum_follows_numpys_reduction_order(n):
    """The generator's CPU calibration sums in numpy's classic float32
    order, written out (buffers of 8,192, pairwise inside), so the
    generated loads do not depend on how a numpy build vectorizes sums."""
    a = np.random.default_rng(n).exponential(0.5, n).astype(np.float32)
    assert port_rc.f32_sum(a) == np.sum(a)
    assert port_rc.f32_sum(a).dtype == np.float32


FIXTURES = ["small_cluster", "unbalanced_two_brokers", "leaders_skewed", "rack_violated",
            "dead_broker_cluster", "capacity_violated", "unbalanced", "unbalanced2",
            "unbalanced_with_a_follower", "preferred_leader_skewed",
            "rack_aware_satisfiable", "rack_aware_unsatisfiable", "jbod_cluster",
            "small_cluster_java", "medium_cluster_java", "min_leader_satisfiable",
            "min_leader_satisfiable2", "min_leader_satisfiable3",
            "min_leader_satisfiable4", "min_leader_unsatisfiable"]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixtures_match_reference(name):
    """The port's model/fixtures.py builds the reference's arrays and meta."""
    from cruise_control_tpu.model import fixtures as ref_fx
    from cruise_control_tpu_torch.model import fixtures as port_fx
    ref_ct, ref_meta = getattr(ref_fx, name)()
    ct, meta = getattr(port_fx, name)()
    _assert_same_arrays(ref_ct, ct)
    _assert_same_meta(ref_meta, meta)


def test_synthetic_cluster_matches_reference():
    from cruise_control_tpu.model import fixtures as ref_fx
    from cruise_control_tpu_torch.model import fixtures as port_fx
    kw = dict(num_brokers=12, num_replicas=300, num_partitions=110, num_topics=12,
              num_racks=3, logdirs_per_broker=2, max_replication=3)
    ref_ct, ref_meta = ref_fx.synthetic_cluster(**kw)
    ct, meta = port_fx.synthetic_cluster(**kw)
    _assert_same_arrays(ref_ct, ct)
    _assert_same_meta(ref_meta, meta)


@pytest.mark.parametrize("alive", [False, True])
def test_set_broker_alive_matches_reference(alive):
    """Broker death (and revival after it) gives the reference's offline
    flags and disk aliveness, on a JBOD cluster with a dead disk."""
    ref_ct, ref_meta = ref_rc.generate(ref_rc.RandomClusterSpec(**SPECS["dead-jbod-20b"]))
    ct, meta = port_rc.generate(port_rc.RandomClusterSpec(**SPECS["dead-jbod-20b"]))
    for b in (3, int(np.flatnonzero(~np.asarray(ct.broker_disk_alive).all(axis=1))[0])):
        ref_ct = ref_ct.set_broker_alive(b, False)
        ct = ct.set_broker_alive(b, False)
        if alive:
            ref_ct = ref_ct.set_broker_alive(b, True)
            ct = ct.set_broker_alive(b, True)
        _assert_same_arrays(ref_ct, ct)
    assert meta.broker_index(meta.broker_ids[5]) == ref_meta.broker_index(
        ref_meta.broker_ids[5]) == 5
