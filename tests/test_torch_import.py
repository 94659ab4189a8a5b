"""The PyTorch port stands alone: it imports with JAX blocked, no source of
it imports JAX or the JAX package, and it never falls back to the CPU on its
own."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cruise_control_tpu_torch import kernels as K
from cruise_control_tpu_torch.analyzer.env import make_env, resolve_device
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.model.random_cluster import RandomClusterSpec, generate

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cruise_control_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + [
    "chip_smoke.py"]
MODULES = sorted(
    ".".join(Path(s).with_suffix("").parts).removesuffix(".__init__")
    for s in SOURCES if s.startswith("cruise_control_tpu_torch/"))
# `import jax`, `from jax...`, or any import of the JAX package (the port's
# own name, cruise_control_tpu_torch, must not match)
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+cruise_control_tpu(?!_torch)\b"
    r"|from\s+cruise_control_tpu(?!_torch)\b)", re.MULTILINE)


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = [m for m in sys.modules if m == 'cruise_control_tpu' "
        "or m.startswith('cruise_control_tpu.')]\n"
        "assert not leaked, leaked\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_nothing_of_jax(source):
    text = (ROOT / source).read_text()
    assert not FORBIDDEN.findall(text), f"{source} imports JAX or the JAX package"


def test_verification_and_goal_modules_are_scanned():
    """The rack-distribution and kafka-assigner goals, the verifier, the
    stats, the sanity check and the provisioner are among the modules
    imported with JAX blocked and scanned above."""
    assert {"cruise_control_tpu_torch.analyzer.goals.rack",
            "cruise_control_tpu_torch.analyzer.goals.kafka_assigner",
            "cruise_control_tpu_torch.analyzer.verifier",
            "cruise_control_tpu_torch.model.stats",
            "cruise_control_tpu_torch.model.sanity",
            "cruise_control_tpu_torch.detector",
            "cruise_control_tpu_torch.detector.provisioner"} <= set(MODULES)


def test_session_slice_modules_are_scanned():
    """The resident-session slice's modules (config, backend, monitor,
    snapshot deltas, the session, its script and the K5 / K13 kernels) are
    among the modules imported with JAX blocked and scanned above."""
    assert {"cruise_control_tpu_torch.config", "cruise_control_tpu_torch.config.configdef",
            "cruise_control_tpu_torch.config.defaults",
            "cruise_control_tpu_torch.backend", "cruise_control_tpu_torch.backend.interface",
            "cruise_control_tpu_torch.backend.simulated",
            "cruise_control_tpu_torch.backend.topic_config",
            "cruise_control_tpu_torch.monitor", "cruise_control_tpu_torch.monitor.metricdef",
            "cruise_control_tpu_torch.monitor.capacity",
            "cruise_control_tpu_torch.monitor.cpu_model",
            "cruise_control_tpu_torch.monitor.fetcher",
            "cruise_control_tpu_torch.monitor.load_monitor",
            "cruise_control_tpu_torch.monitor.aggregator.sample_aggregator",
            "cruise_control_tpu_torch.monitor.sampling.samplers",
            "cruise_control_tpu_torch.model.delta",
            "cruise_control_tpu_torch.analyzer.session",
            "cruise_control_tpu_torch.analyzer.session_script",
            "cruise_control_tpu_torch.kernels.finalize",
            "cruise_control_tpu_torch.kernels.probe"} <= set(MODULES)


def test_self_healing_slice_modules_are_scanned():
    """The self-healing slice's modules (sensors, retries, tracing, the
    executor, the detectors and their manager, the forecaster and K15, the
    facade, its result renderers and the heal script) are among the modules
    imported with JAX blocked and scanned above."""
    assert {"cruise_control_tpu_torch.common.sensors",
            "cruise_control_tpu_torch.common.retries",
            "cruise_control_tpu_torch.common.tracing",
            "cruise_control_tpu_torch.executor", "cruise_control_tpu_torch.executor.task",
            "cruise_control_tpu_torch.executor.strategy",
            "cruise_control_tpu_torch.executor.planner",
            "cruise_control_tpu_torch.executor.notifier",
            "cruise_control_tpu_torch.executor.executor",
            "cruise_control_tpu_torch.detector.anomalies",
            "cruise_control_tpu_torch.detector.notifier",
            "cruise_control_tpu_torch.detector.metric_anomaly",
            "cruise_control_tpu_torch.detector.topic_anomaly",
            "cruise_control_tpu_torch.detector.maintenance",
            "cruise_control_tpu_torch.detector.detectors",
            "cruise_control_tpu_torch.detector.manager",
            "cruise_control_tpu_torch.reporter.topic",
            "cruise_control_tpu_torch.forecast",
            "cruise_control_tpu_torch.forecast.forecaster",
            "cruise_control_tpu_torch.kernels.forecast",
            "cruise_control_tpu_torch.api.responses",
            "cruise_control_tpu_torch.app",
            "cruise_control_tpu_torch.analyzer.heal_script"} <= set(MODULES)


def test_reference_class_names_resolve_to_the_port():
    """Every class-valued default names a reference class; the port's
    resolver reads it as the port's class of the same module path, so the
    facade's wiring imports nothing of the JAX package."""
    from cruise_control_tpu_torch.config import cruise_control_config, resolve_class
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
    cfg = cruise_control_config()
    assert cfg.get_class("anomaly.notifier.class") is SelfHealingNotifier
    for key in ("provisioner.class", "metric.anomaly.finder.class",
                "maintenance.event.reader.class", "optimization.options.generator.class",
                "metric.sampler.class", "broker.capacity.config.resolver.class",
                "executor.notifier.class", "topic.config.provider.class",
                "broker.failures.class", "goal.violations.class", "disk.failures.class"):
        assert cfg.get_class(key).__module__.startswith("cruise_control_tpu_torch."), key
    assert resolve_class("collections.OrderedDict").__name__ == "OrderedDict"


def test_forbidden_pattern_tells_the_packages_apart():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from cruise_control_tpu.analyzer import engine")
    assert FORBIDDEN.search("    import cruise_control_tpu")
    assert not FORBIDDEN.search("from cruise_control_tpu_torch.analyzer import engine")
    assert not FORBIDDEN.search("import cruise_control_tpu_torch")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GoalOptimizer()
    from cruise_control_tpu_torch.analyzer.session import ResidentClusterSession
    from cruise_control_tpu_torch.config import cruise_control_config
    with pytest.raises(RuntimeError, match="cuda"):
        GoalOptimizer(config=cruise_control_config())
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentClusterSession(monitor=None)
    ct, meta = generate(RandomClusterSpec(num_brokers=4, num_racks=2, num_topics=2,
                                          num_partitions=8, seed=1))
    with pytest.raises(RuntimeError, match="cuda"):
        make_env(ct, meta)
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert GoalOptimizer(device="cpu").device == torch.device("cpu")


def test_wrappers_on_cpu_tensors_run_the_twin_and_count_no_launch():
    K.reset_launches()
    key = torch.arange(64, dtype=torch.float32)
    kv, idx = K.select_candidates(key, 8, 0)
    assert idx.tolist() == list(range(63, 55, -1))
    seg = torch.tensor([0, 1, 1, -1, 2])
    out = K.segment_sum(torch.ones((5, 2)), seg, 3)
    assert out[:, 0].tolist() == [1.0, 2.0, 1.0]
    assert K.segment_count(seg, 3).tolist() == [1, 2, 1]
    assert all(n == 0 for n in K.launches().values())
    order, n = K.compact_eligible(torch.tensor([False, True, True, False]), 6)
    assert order.tolist() == [1, 2, 4, 4, 4, 4] and int(n) == 2
    win = K.swap_admission(torch.tensor([2.0, 1.0, 1.0]), torch.tensor([0, 0, 1]),
                           torch.tensor([2, 3, 4]), torch.tensor([0, 1, 2]),
                           torch.tensor([0, 1, 2]), torch.tensor([3, 4, 5]), 1e-9)
    assert win.tolist() == [True, False, True]
    assert all(n == 0 for n in K.launches().values())
    assert set(K.launches()) == {"select_candidates", "compact_eligible",
                                 "move_score_classes", "wave_admission",
                                 "leadership_rows", "segment_sum", "segment_count",
                                 "swap_rows", "swap_admission", "disk_rows",
                                 "disk_apply", "preferred_leader", "replica_keys",
                                 "session_finalize", "select_candidates_masked",
                                 "seeded_probe", "forecast", "select_candidates_lanes",
                                 "replica_keys_lanes", "move_score_classes_lanes",
                                 "wave_admission_lanes", "leadership_rows_lanes",
                                 "swap_rows_lanes", "swap_admission_lanes",
                                 "seeded_probe_lanes", "select_pooled",
                                 "select_pooled_lanes", "move_score_terms",
                                 "move_score_terms_lanes"}


def test_new_wrappers_on_cpu_tensors_run_the_twin_and_count_no_launch():
    """The K8 and K12 wrappers dispatch on the tensors' device too."""
    from cruise_control_tpu_torch.kernels.disk import DISK_CAPACITY, DiskRule, DiskState
    K.reset_launches()
    ds = DiskState(
        rb=torch.tensor([0, 0, 1]), rlead=torch.tensor([True, True, True]),
        lead_disk=torch.tensor([300.0, 500.0, 10.0]),
        foll_disk=torch.tensor([300.0, 500.0, 10.0]),
        rvalid=torch.ones(3, dtype=torch.bool), rtexcl=torch.zeros(3, dtype=torch.bool),
        balive=torch.tensor([True, True]),
        dalive=torch.tensor([[True, True], [True, False]]),
        dcap=torch.full((2, 2), 1000.0), rdisk=torch.tensor([0, 0, 1]),
        roff=torch.tensor([False, False, True]), moved=torch.zeros(3, dtype=torch.bool),
        dutil=torch.tensor([[1000.0, 0.0], [0.0, 10.0]]))
    rule = DiskRule(DISK_CAPACITY, 0.8)
    cand = torch.tensor([0, 1, 2])
    best = K.disk_rows(ds, cand, torch.zeros(3), rule, [])
    # the overfull logdir's rows score their load, the dead disk's row heals
    assert best[1] > best[0] > best[2] > 1.0
    du, rd, off, moved, n = K.disk_apply(ds, cand, best, torch.tensor([1, 0, 2]), rule,
                                         [], 1e-9)
    assert int(n) == 2 and rd.tolist() == [0, 1, 0] and off.tolist() == [False] * 3
    assert du.tolist() == [[500.0, 500.0], [10.0, 0.0]] and moved.tolist() == [False, True, True]
    lead, mv, nv = K.preferred_leader(
        torch.tensor([[1, 0]]), torch.tensor([0, 1]), torch.tensor([True, False]),
        torch.tensor([False, False]), torch.tensor([True, True]),
        torch.tensor([False, False]), torch.tensor([False, False]),
        torch.tensor([False, False]), apply=True)
    assert int(nv) == 1 and lead.tolist() == [False, True] and mv.tolist() == [True, True]
    assert all(n == 0 for n in K.launches().values())


def test_session_wrappers_on_cpu_tensors_run_the_twin_and_count_no_launch():
    """K5 finalize, K1's seed mask and K13 dispatch on the tensors' device
    too."""
    K.reset_launches()
    lead, off, rtexcl, dst = K.session_finalize(
        torch.tensor([0b10100000], dtype=torch.uint8), torch.tensor([0, 1, 1]),
        torch.tensor([0, 0, 1]), torch.tensor([1, 0, 1]),
        torch.tensor([True, True, False]), torch.tensor([True, False]),
        torch.tensor([[True, False], [True, True]]), torch.tensor([False, True]),
        torch.tensor([False, True]))
    assert lead.tolist() == [True, False, True]
    assert off.tolist() == [False, True, False]
    assert rtexcl.tolist() == [True, False, True] and dst.tolist() == [True, False]
    key = torch.arange(8, dtype=torch.float32)
    mask = torch.tensor([True, False] * 4)
    kv, idx = K.select_candidates(key, 3, 0, seed_mask=mask)
    assert idx.tolist() == [6, 4, 2]
    assert bool(K.seeded_probe(mask, [key]))
    assert not bool(K.seeded_probe(mask, [torch.where(mask, -torch.inf, key)]))
    assert all(n == 0 for n in K.launches().values())


def test_fleet_slice_modules_are_scanned():
    """The fleet slice's modules (the scheduler, the lane constants, the lane
    stack and its pass loop, the fleet scripts) are among the modules
    imported with JAX blocked and scanned above."""
    assert {"cruise_control_tpu_torch.fleet", "cruise_control_tpu_torch.pipeline",
            "cruise_control_tpu_torch.analyzer.lanes",
            "cruise_control_tpu_torch.fleet_script"} <= set(MODULES)


def test_fleet_cuda_by_default_and_lane_wrappers_count_no_launch_on_cpu(monkeypatch):
    from cruise_control_tpu_torch.fleet import FleetScheduler
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        FleetScheduler()
    K.reset_launches()
    key = torch.stack([torch.arange(8, dtype=torch.float32)] * 2)
    kv, idx = K.select_candidates_lanes(key, 3, [0, 0])
    assert idx.tolist() == [[7, 6, 5], [7, 6, 5]]
    assert all(n == 0 for n in K.launches().values())


FRONT_DOOR = {"cruise_control_tpu_torch.api", "cruise_control_tpu_torch.api.endpoints",
              "cruise_control_tpu_torch.api.progress", "cruise_control_tpu_torch.api.purgatory",
              "cruise_control_tpu_torch.api.user_tasks", "cruise_control_tpu_torch.api.security",
              "cruise_control_tpu_torch.api.responses", "cruise_control_tpu_torch.api.server",
              "cruise_control_tpu_torch.client", "cruise_control_tpu_torch.client.client",
              "cruise_control_tpu_torch.client.cli", "cruise_control_tpu_torch.main",
              "cruise_control_tpu_torch.__main__", "cruise_control_tpu_torch.pipeline",
              "cruise_control_tpu_torch.service_script"}


def test_front_door_modules_are_scanned_and_name_no_reference_module():
    """The front door's modules (the REST server and its parts, the client
    and CLI, the entry point, the pipelined loop, the service script) are
    among the modules imported with JAX blocked and scanned above, and none
    reaches the JAX package by a dynamic import either."""
    assert FRONT_DOOR <= set(MODULES)
    dynamic = re.compile(r"import_module\(\s*f?[\"']cruise_control_tpu(?!_torch)\b")
    for mod in FRONT_DOOR:
        path = ROOT / Path(*mod.split("."))
        src = path.with_suffix(".py") if path.with_suffix(".py").exists() else path / "__init__.py"
        text = src.read_text()
        assert not FORBIDDEN.findall(text) and not dynamic.search(text), mod


def test_branch_lane_wrappers_on_cpu_tensors_count_no_launch():
    """The lane forms of K6, K7 and K13 dispatch on the tensors' device:
    on the CPU they run their twins and count nothing."""
    K.reset_launches()
    masks = torch.tensor([[True, False, True], [False, False, False]])
    keys = torch.tensor([[-torch.inf, 1.0, 2.0], [3.0, 3.0, 3.0]])
    assert K.seeded_probe_lanes(masks, [keys]).tolist() == [True, False]
    win = K.swap_admission_lanes(torch.tensor([[2.0, 1.0, 1.0]] * 2),
                                 torch.tensor([[0, 0, 1]] * 2), torch.tensor([[2, 3, 4]] * 2),
                                 torch.tensor([[0, 1, 2]] * 2), torch.tensor([[0, 1, 2]] * 2),
                                 torch.tensor([[3, 4, 5]] * 2), 1e-9)
    assert win.tolist() == [[True, False, True]] * 2
    assert all(n == 0 for n in K.launches().values())


def test_option_wrappers_on_cpu_tensors_count_no_launch():
    """The pooled K1 (solo and lanes, and through K1's ``compact_pool``)
    dispatches on the tensors' device: on the CPU its twin takes the pool
    when the eligible rows fit it (pads: -inf, id R - 1), else the full
    sweep, and counts no launch; only the branch tally moves. The engine module keeps the mesh as its one
    unported option."""
    from cruise_control_tpu_torch.analyzer.engine import EngineParams, check_supported
    K.reset_launches()
    key = torch.full((64,), -torch.inf)
    key[[3, 9, 40]] = torch.tensor([1.0, 3.0, 2.0])
    kv, idx = K.select_pooled(key, 4, 0, pool=16)
    assert idx.tolist() == [9, 40, 3, 63] and kv[3] == -torch.inf
    kv, idx = K.select_pooled_lanes(torch.stack([key, torch.ones(64)]), 4, [0, 0], pool=16)
    assert idx.tolist() == [[9, 40, 3, 63], [0, 1, 2, 3]]
    assert K.pool_branch_counts() == {"pooled": 2, "full": 1}
    # K1's ``compact_pool`` takes the pooled keying only below R
    assert K.select_candidates(key, 4, 0, compact_pool=16)[1].tolist() == [9, 40, 3, 63]
    assert K.select_candidates(key, 4, 0, compact_pool=64)[1].tolist() == [9, 40, 3, 0]
    assert K.select_candidates_lanes(key[None], 4, [0], compact_pool=16)[1].tolist() == [
        [9, 40, 3, 63]]
    assert K.pool_branch_counts() == {"pooled": 4, "full": 1}
    assert all(n == 0 for n in K.launches().values())
    K.reset_launches()
    assert K.pool_branch_counts() == {"pooled": 0, "full": 0}
    check_supported(EngineParams(compact_keying=True, chain_cache=False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(EngineParams(mesh=object()))
