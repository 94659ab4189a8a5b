"""The port's config surface (``cruise_control_tpu_torch.config``) against
the reference's: every key, type, default, alias and doc equal; the cases of
``tests/test_config.py`` and ``tests/test_config_surface.py`` that touch
``configdef`` / ``defaults``, run against the port's copy; and
``GoalOptimizer(config=...)`` reading every knob the reference's
constructor reads (optimizer.py:299-506).

The reference's config is numpy-free Python, so the two packages are
compared in-process.
"""
import dataclasses

import pytest

from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as RefOptimizer
from cruise_control_tpu.config import CRUISE_CONTROL_CONFIG_DEF as REF_DEF
from cruise_control_tpu.config import cruise_control_config as ref_config
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.config import (
    CRUISE_CONTROL_CONFIG_DEF, DEFAULT_GOALS, DEFAULT_HARD_GOALS, Config, ConfigDef,
    ConfigException, Type, cruise_control_config,
)
from cruise_control_tpu_torch.config.defaults import ENDPOINT_PATHS, endpoint_config_stem
from torch_reference import one_torch_thread

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def test_every_key_type_default_alias_and_doc_equal_the_reference():
    ref, port = REF_DEF.keys(), CRUISE_CONTROL_CONFIG_DEF.keys()
    assert list(port) == list(ref)
    for name, rk in ref.items():
        pk = port[name]
        assert (pk.type.value, pk.default, pk.doc, pk.alias_of, pk.importance.value) == (
            rk.type.value, rk.default, rk.doc, rk.alias_of, rk.importance.value), name


def test_parsed_defaults_equal_the_reference():
    assert (cruise_control_config().values(redact=False)
            == ref_config().values(redact=False))


@pytest.mark.parametrize("props", [
    {"cpu.balance.threshold": "1.3", "max.replicas.per.broker": "500",
     "self.healing.enabled": "true"},
    {"num.partition.metrics.windows": 7},
    {"analyzer.incremental.seed.dirty": True, "analyzer.pass.chunk": 4},
    {"goals": "RackAwareGoal,DiskCapacityGoal", "hard.goals": "RackAwareGoal"},
])
def test_overrides_parse_as_the_reference(props):
    assert (cruise_control_config(props).values(redact=False)
            == ref_config(props).values(redact=False))


@pytest.mark.parametrize("props", [
    {"not.a.key": 1},
    {"cpu.balance.threshold": 0.5},
    {"goals": "RackAwareGoal", "hard.goals": "RackAwareGoal,DiskCapacityGoal"},
    {"analyzer.pass.chunk": -1},
    {"analyzer.pass.adaptive.floor.passes": 0},
    {"fleet.pass.gating.enabled": "sometimes"},
    {"num.metrics.windows": 5, "num.partition.metrics.windows": 7},
    {"zookeeper.security.enabled": True},
    {"webserver.ssl.keystore.type": "JKS"},
    {"webserver.ssl.include.protocols": "SSLv3"},
    {"trusted.proxy.services.ip.regex": "("},
    {"analyzer.incremental.revalidate.tolerance": "loose"},
])
def test_rejected_as_the_reference_rejects(props):
    """test_config.py's unknown-key, validator and hard-goal cases and
    test_config_surface.py's guardrail, alias-conflict and JVM-value cases."""
    with pytest.raises(Exception) as ref_err:
        ref_config(props)
    with pytest.raises(ConfigException) as port_err:
        cruise_control_config(props)
    assert str(port_err.value) == str(ref_err.value)


def test_defaults_parse():
    cfg = cruise_control_config()
    assert cfg.get_double("cpu.balance.threshold") == 1.10
    assert cfg.get_double("cpu.capacity.threshold") == 0.7
    assert cfg.get_double("disk.capacity.threshold") == 0.8
    assert cfg.get_int("max.replicas.per.broker") == 10000
    assert cfg.get_list("goals") == DEFAULT_GOALS
    assert set(cfg.get_list("hard.goals")) == set(DEFAULT_HARD_GOALS)
    for name, want in (("analyzer.resident.session.enabled", True),
                       ("analyzer.incremental.enabled", True),
                       ("analyzer.incremental.revalidate", True),
                       ("anomaly.detection.use.resident.session", True),
                       ("analyzer.incremental.seed.dirty", False)):
        assert cfg.get_boolean(name) is want, name


def test_alias_read_and_write():
    cfg = cruise_control_config({"num.partition.metrics.windows": 7})
    assert cfg.get_int("num.metrics.windows") == 7
    assert cfg.get_int("num.partition.metrics.windows") == 7
    cfg = cruise_control_config({"webserver.ssl.keystore.location": "/c.pem"})
    assert cfg.get_string("webserver.ssl.cert.location") == "/c.pem"


def test_pluggable_instance_loading_and_list_parsing():
    d = ConfigDef().define(name="x.class", type=Type.CLASS,
                           default="collections.OrderedDict")
    from collections import OrderedDict
    assert isinstance(Config(d).get_configured_instance("x.class"), OrderedDict)
    d = ConfigDef().define(name="l", type=Type.LIST, default="a, b,c")
    assert Config(d)["l"] == ["a", "b", "c"]


def test_endpoint_parameter_and_request_class_keys_exist():
    from cruise_control_tpu.api.endpoints import EndPoint
    assert list(ENDPOINT_PATHS) == [ep.path for ep in EndPoint]
    keys = CRUISE_CONTROL_CONFIG_DEF.keys()
    for path in ENDPOINT_PATHS:
        stem = endpoint_config_stem(path)
        assert f"{stem}.parameters.class" in keys
        assert f"{stem}.request.class" in keys
    assert "stop.proposal.parameters.class" in keys


# the attributes both constructors set from the config
KNOBS = ("_fused_min_replicas", "_finisher_min_replicas", "_compute_dtype",
         "_escalation", "_escalation_max_remaining", "_escalation_factor",
         "_incremental", "_revalidate", "_reval_tol", "_seed_dirty", "_pass_chunk",
         "_chunk_min_replicas", "_adaptive_budgets", "_adaptive_floor", "_cert_skip",
         "_shortcircuit", "_balancedness_priority_weight",
         "_balancedness_strictness_weight", "_default_goal_names", "_hard_goal_names")


@pytest.mark.parametrize("props", [None, {}, {
    "analyzer.max.iterations": 100, "analyzer.pass.waves": 6, "analyzer.pass.chunk": 3,
    "analyzer.fused.chain.min.replicas": -1, "analyzer.finisher.min.replicas": 0,
    "analyzer.incremental.revalidate": False, "analyzer.incremental.seed.dirty": True,
    "analyzer.incremental.revalidate.tolerance": 0.01,
    "analyzer.pass.certificate.skip": False, "analyzer.finisher.escalation.factor": 2,
    "cpu.balance.threshold": 1.2, "max.replicas.per.broker": 300,
    "goal.balancedness.priority.weight": 1.3, "analyzer.compute.dtype": "bfloat16",
    "goals": "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal",
    "hard.goals": "RackAwareGoal"}])
def test_goal_optimizer_reads_every_knob_the_reference_reads(props):
    ref = RefOptimizer(config=None if props is None else ref_config(props))
    port = GoalOptimizer(config=None if props is None else cruise_control_config(props),
                         device="cpu")
    for name in KNOBS:
        assert getattr(port, name) == getattr(ref, name), name
    assert dataclasses.asdict(port.constraint) == dataclasses.asdict(ref.constraint)
    rp = dataclasses.asdict(ref._params)
    assert {k: v for k, v in dataclasses.asdict(port._params).items()
            if k in rp} == {k: v for k, v in rp.items() if k != "mesh"} | {"mesh": None}
    for R, B in ((1024, 16), (12_288, 64), (114_688, 1024), (1_048_576, 7168)):
        got = dataclasses.asdict(port.scaled_params(R, B))
        want = dataclasses.asdict(ref.scaled_params(R, B))
        assert {k: got[k] for k in want} == want, (R, B)


def test_goal_optimizer_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="item 15"):
        GoalOptimizer(config=cruise_control_config({"tpu.mesh.axis.brokers": 2}),
                      device="cpu")
    # measured goal durations are ported: a request for them runs
    from cruise_control_tpu_torch.model.random_cluster import RandomClusterSpec, generate
    ct, meta = generate(RandomClusterSpec(num_brokers=6, num_racks=2, num_topics=2,
                                          num_partitions=24, seed=1))
    opt = GoalOptimizer(config=cruise_control_config(), device="cpu")
    res = opt.optimizations(ct, meta, goal_names=["ReplicaDistributionGoal"],
                            skip_hard_goal_check=True, raise_on_failure=False,
                            measure_goal_durations=True)
    assert res.durations_measured and res.goal_results[0].duration_s > 0
