"""Fleet mode of the port against the JAX package: ``FleetScheduler``,
``GoalOptimizer.optimizations_batched`` and the session's spill and readmit
(the drives of ``tests/test_fleet.py`` that need no REST server and of
``tests/test_serving.py`` that need no simulator, scripted once in
``cruise_control_tpu_torch/fleet_script.py``).

The reference's side runs in ONE fresh interpreter for this module
(``torch_reference.fleet_job``), started when the module is imported (under
xdist, once per session, in the background): its vmapped fleet programs
never compile inside a test worker. The port's side runs here on the CPU,
on one torch intra-op thread.
Every comparison is exact: verdict sets, certificates, proposals, final
assignment arrays, lane counters, round and dispatch reports.

The reference's assertions that count XLA compiles (a steady fleet round,
a readmit and lane / K toggles compile nothing) have no counterpart in the
port, which compiles nothing at run time: its kernels build once, from
source, on first use on the card, and ``chip_smoke.py`` phase 8 runs the
steady round after the first."""
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import fleet_script as fs
from cruise_control_tpu_torch.fleet import FleetScheduler, valid_cluster_id
from torch_reference import (
    background_reference, fleet_job, one_torch_thread, start_background_reference,
)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
_REFERENCE_JOBS = {"fleet": fleet_job(("fleet_cases", "serving_cases"))}
start_background_reference("fleet", _REFERENCE_JOBS)


def same(a, b) -> bool:
    """Deep equality of plain values with numpy arrays compared exactly."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return background_reference(tmp_path_factory, "fleet", _REFERENCE_JOBS)["fleet"]


@pytest.fixture(scope="module")
def port():
    ns = fs.port_fleet_ns("cpu")
    return dict(fleet_cases=fs.fleet_cases(ns), serving_cases=fs.serving_cases(ns))


# ------------------------------------------------------------- test_fleet.py
def test_batched_parity_bit_identical_to_solo(port, ref):
    got = port["fleet_cases"]["parity"]
    assert got["report"]["launches"] == 1
    assert len(got["report"]["buckets"]) == 1
    assert sorted(got["report"]["optimized"]) == sorted(f"tenant-{s}"
                                                        for s in fs.FLEET_SEEDS)
    for solo, lane in zip(got["solo"], got["fleet"]):
        assert same(lane["sets"], solo["sets"])
        assert same(lane["final"], solo["final"])
    assert same(got, ref["fleet_cases"]["parity"])


def test_steady_round_delta_donated(port, ref):
    got = port["fleet_cases"]["steady"]
    assert got["report"]["launches"] == 1
    assert set(got["modes"].values()) == {"delta"}
    assert set(got["donated"].values()) == {1}
    assert same(got, ref["fleet_cases"]["steady"])


def test_fresh_tenant_not_reoptimized(port, ref):
    got = port["fleet_cases"]["fresh"]
    assert got["launches"] == 0 and got["optimized"] == []
    assert all(v == "fresh" for v in got["skipped"].values())
    assert same(got, ref["fleet_cases"]["fresh"])


def test_pause_resume(port, ref):
    got = port["fleet_cases"]["pause"]
    cid = f"pause-{fs.FLEET_SEEDS[0]}"
    assert got["paused"]["skipped"][cid] == "paused"
    assert cid not in got["paused"]["optimized"]
    assert got["servable"]
    assert cid in got["resumed"]["optimized"]
    assert same(got, ref["fleet_cases"]["pause"])


def test_spill_readmit_bit_identical(port, ref):
    got = port["fleet_cases"]["spill"]
    assert got["spilled"] and got["readmitted"] and got["residual_leaf"]
    assert got["bytes_after_spill"] == (0, 0)
    assert all(got["env_equal"].values()) and all(got["state_equal"].values())
    want = ref["fleet_cases"]["spill"]
    assert (got["spilled"], got["readmitted"], got["bytes_after_spill"]) == (
        want["spilled"], want["readmitted"], want["bytes_after_spill"])
    assert all(want["env_equal"].values()) and all(want["state_equal"].values())


def test_memory_budget_lru_spills_coldest_and_sync_readmits(port, ref):
    got = port["fleet_cases"]["lru"]
    assert got["spilled"] == [f"tenant-{fs.FLEET_SEEDS[0]}"]
    assert got["fits"] and got["resident_positive"]
    assert got["mode"] == "delta" and not got["still_spilled"]
    assert got["readmits"] and got["spills"]
    assert same(got, ref["fleet_cases"]["lru"])


def test_fleet_state_and_staleness(port, ref):
    got = port["fleet_cases"]["state"]
    assert got["rounds"] >= 2 and got["launches"] >= 1
    assert got["tenants"] == sorted(f"tenant-{s}" for s in fs.FLEET_SEEDS)
    assert got["staleness"] and got["device_bytes_positive"]
    assert same(got, ref["fleet_cases"]["state"])


def test_cluster_ids_and_cuda_by_default():
    assert valid_cluster_id("tenant-1") and not valid_cluster_id("../x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FleetScheduler()


# ----------------------------------------------------------- test_serving.py
def test_zero_pressure_bit_parity_vs_static_round(port, ref):
    got = port["serving_cases"]["zero_pressure"]
    assert got["a"]["launches"] == got["b"]["launches"] == 1
    assert sorted(got["a"]["buckets"]) == sorted(got["b"]["buckets"])
    assert sorted(got["a"]["optimized"]) == sorted(got["b"]["optimized"])
    assert got["a"]["skipped"] == got["b"]["skipped"] == {}
    assert same(got["res_a"], got["res_b"])
    assert got["second"][0] == got["second"][1]
    assert same(got, ref["serving_cases"]["zero_pressure"])


def test_heal_preempts_hygiene_preempts_refresh(port, ref):
    got = port["serving_cases"]["priority"]
    assert got["order"] == [f"tenant-{s}" for s in fs.SERVING_SEEDS]
    assert got["depth"] == 0
    assert same(port["serving_cases"]["warm"], ref["serving_cases"]["warm"])
    assert same(got, ref["serving_cases"]["priority"])


def test_mid_launch_arrival_rides_next_dispatch(port, ref):
    got = port["serving_cases"]["mid_launch"]
    cids = [f"tenant-{s}" for s in fs.SERVING_SEEDS]
    assert got["d1"] == sorted(cids[:2]) and got["depth"] == 1
    assert got["d2"] == [cids[2]] and got["depth_after"] == 0
    assert same(got, ref["serving_cases"]["mid_launch"])


def test_near_join_vs_split_both_sides_of_threshold(port, ref):
    assert FleetScheduler.near_buckets(
        (1024, 16, 256, 16, 2, 1, 3), (1024, 20, 256, 16, 2, 1, 3))
    assert not FleetScheduler.near_buckets(
        (1024, 16, 256, 16, 2, 1, 3), (1024, 20, 256, 16, 2, 1, 4))
    assert not FleetScheduler.near_buckets(
        (1024, 16, 256, 16, 2, 1, 3), (1024, 40, 256, 16, 2, 1, 3))
    got = port["serving_cases"]["near"]
    assert got["small"][1] == 16 and got["large"][1] == 20 and got["near"]
    assert got["d1"]["split"] is True and got["d1"]["joined"] == []
    assert got["counts1"] == (1, 0)
    assert got["d3"]["launches"] == 1 and got["joins"] == 1
    assert all(k == got["large"] for k in got["keys"].values())
    assert same(got, ref["serving_cases"]["near"])


def test_launch_failure_surfaced_and_heal_requeued(port, ref):
    got = port["serving_cases"]["failure"]
    cid = f"tenant-{fs.SERVING_SEEDS[0]}"
    assert got["launches"] == 0
    assert got["failed"].get(cid) == "launch failed: RuntimeError"
    assert got["depth"] == 1 and got["retries"] == 1
    assert got["next_admitted"] == [cid] and got["next_launches"] == 1
    assert got["depth_after"] == 0
    assert same(got, ref["serving_cases"]["failure"])


def test_admission_journal_and_counters(port, ref):
    got, want = port["serving_cases"], ref["serving_cases"]
    assert same(got["admission_state"], want["admission_state"])
    assert same(got["journal"], want["journal"])
