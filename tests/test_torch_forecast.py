"""K15, the forecaster, through the port against the JAX reference.

- The plain twin of ``kernels/forecast.py`` against the reference's jitted
  ``forecast_batch`` bit for bit, on random histories with holes in the
  mask (leading, trailing, interior, all-holes series), at window counts
  1..8. The reference's outputs come from one fresh interpreter per module
  (``torch_reference.cases_job``, started in the background when the
  module is imported), so the test worker compiles nothing of JAX.
- ``WorkloadForecaster`` of both packages over the same monitored backend:
  the same forecast bits, scales, rising flag and generation; the memo per
  generation and knob set; the device contract.
- The goal-violation detector's CHECK path rides the revalidation memo.
"""
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.forecast import (
    ForecastKnobs, WorkloadForecaster, forecast_reference,
)
from cruise_control_tpu_torch.kernels import forecast as K15
from torch_reference import (
    background_reference, cases_job, one_torch_thread, start_background_reference,
)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _history(seed=0, E=7, W=5, M=4, holes=True, scale=100.0, signed=False):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-scale if signed else 0.0, scale, size=(E, W, M)).astype(np.float32)
    mask = rng.random((E, W)) > 0.25
    if holes and E >= 4:
        mask[0, 0] = False
        mask[1, -1] = False
        mask[2, W // 2] = False
        mask[3, :] = False
    return vals, mask


def _reference(vals, mask, knobs):
    import jax.numpy as jnp

    from cruise_control_tpu.forecast import forecast_batch
    return np.asarray(forecast_batch(vals, mask, *[jnp.float32(k) for k in knobs]))


CASES = [dict(seed=s, E=E, W=W, scale=scale, signed=signed)
         for s, (E, W, scale, signed) in enumerate([
             (7, 5, 100.0, False), (64, 5, 100.0, False), (237, 6, 1e3, False),
             (33, 2, 1.0, False), (50, 3, 50.0, True), (19, 8, 1e-3, False),
             (5, 1, 10.0, False), (128, 4, 1e5, False), (3, 7, 100.0, True)])]
KNOBS = [(0.45, 0.25, 0.5, 3.0), (0.9, 0.1, 0.2, 2.0), (0.2, 0.5, 0.8, 20.0),
         (0.7252333, 0.9459341, 0.5998188, 1.5724896)]


HORIZONS = (300_000, 600_000, 900_000)


def reference_forecasts() -> dict:
    """The reference's side of this module, run by
    ``torch_reference.cases_job`` in a fresh interpreter: its
    ``forecast_batch`` on every (case, knobs) and its ``WorkloadForecaster``
    at every horizon."""
    from cruise_control_tpu.forecast import ForecastKnobs as RefKnobs
    from cruise_control_tpu.forecast import WorkloadForecaster as RefForecaster
    out = {"batch": {}, "forecaster": {}}
    for i, case in enumerate(CASES):
        vals, mask = _history(case["seed"], E=case["E"], W=case["W"],
                              scale=case["scale"], signed=case["signed"])
        for j, knobs in enumerate(KNOBS):
            out["batch"][i, j] = _reference(vals, mask, knobs)
    for horizon_ms in HORIZONS:
        _, lm = _monitored(_ns(True))
        r = RefForecaster(lm, RefKnobs(horizon_ms=horizon_ms)).forecast()
        out["forecaster"][horizon_ms] = dict(
            entities=r.entities, forecast=r.forecast, last=r.last, scale=r.scale,
            rising=r.rising, generation=r.generation, horizon_ms=r.horizon_ms)
    return out


# the reference's interpreter starts when the module is imported (under
# xdist, once per session, in the background)
_REFERENCE_JOBS = {"cases": cases_job("test_torch_forecast", "reference_forecasts")}
start_background_reference("forecast", _REFERENCE_JOBS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return background_reference(tmp_path_factory, "forecast", _REFERENCE_JOBS)["cases"]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=lambda i: f"E{CASES[i]['E']}-W{CASES[i]['W']}")
def test_twin_matches_reference_bit_for_bit(i, reference):
    """Every knob set on one history, each bit for bit."""
    case = CASES[i]
    vals, mask = _history(case["seed"], E=case["E"], W=case["W"], scale=case["scale"],
                          signed=case["signed"])
    for j, knobs in enumerate(KNOBS):
        want = reference["batch"][i, j]
        got = K15.forecast_batch(torch.from_numpy(vals), torch.from_numpy(mask), *knobs)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert got.numpy().tobytes() == want.tobytes(), knobs


def test_twin_holes_and_python_loop():
    """A series with no valid window forecasts 0; the twin agrees with the
    per-series Python loop (which contracts no FMA) to f32 rounding."""
    vals, mask = _history(seed=3)
    got = K15.forecast_batch(torch.from_numpy(vals), torch.from_numpy(mask),
                             0.45, 0.25, 0.5, 5.0).numpy()
    assert (got[3] == 0.0).all()
    np.testing.assert_allclose(got, forecast_reference(vals, mask, 0.45, 0.25, 0.5, 5.0),
                               rtol=1e-5, atol=1e-5)


def _correct_fma(x, y, z) -> np.float32:
    """The f32 nearest to x * y + z (ties to even), by exact rationals."""
    from fractions import Fraction
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    mid = np.float32(float(exact))
    cands = [np.nextafter(mid, np.float32(-np.inf)), mid,
             np.nextafter(mid, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))


@pytest.mark.parametrize("seed", range(3))
def test_fma_f32_rounds_once(seed):
    """``fma_f32`` is a correctly rounded f32 fused multiply-add, against
    exact rationals: on random operands, and where rounding the f64 sum
    again to f32 would land on the wrong side of a midpoint
    (8(1 + 2^-23) * 8(1 - 2^-23) + (2^30 + 128) = 2^30 + 192 - 2^-40)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-4, 4, 300).astype(np.float32)
    b = rng.uniform(-4, 4, 300).astype(np.float32)
    c = rng.uniform(-16, 16, 300).astype(np.float32)
    a[0], b[0], c[0] = np.float32(8 * (1 + 2.0 ** -23)), np.float32(8 * (1 - 2.0 ** -23)), \
        np.float32(2.0 ** 30 + 128)
    a[1], b[1], c[1] = -a[0], b[0], -c[0]
    got = K15.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert got[0] == np.float32(2.0 ** 30 + 128)
    assert np.float32(float(np.float64(a[0]) * b[0] + np.float64(c[0]))) != got[0]
    for x, y, z, g in zip(a, b, c, got):
        assert g == _correct_fma(x, y, z), (x, y, z, g)


def _monitored(ns, seed=0, rounds=6):
    """tests/test_forecast.py ``_monitored_backend``."""
    rng = np.random.default_rng(seed)
    be = ns["SimulatedClusterBackend"]()
    for b in range(6):
        be.add_broker(b, f"r{b % 3}")
    for p in range(30):
        reps = [int(x) for x in rng.choice(6, size=2, replace=False)]
        be.create_partition(f"t{p % 3}", p, reps,
                            size_mb=float(rng.uniform(10, 500)),
                            bytes_in_rate=float(rng.uniform(1, 50)),
                            bytes_out_rate=float(rng.uniform(1, 100)),
                            cpu_util=float(rng.uniform(0.1, 5)))
    lm = ns["LoadMonitor"](backend=be, sampler=ns["SimulatedMetricSampler"](be))
    lm.start_up()
    for i in range(rounds):
        lm.sample_once(now_ms=i * 300_000.0)
    for i in range(rounds, rounds + 4):
        be.scale_partition_load(1.3, topics={"t0"})
        lm.sample_once(now_ms=i * 300_000.0)
    return be, lm


def _ns(ref: bool) -> dict:
    if ref:
        from cruise_control_tpu.backend.simulated import SimulatedClusterBackend
        from cruise_control_tpu.monitor.load_monitor import LoadMonitor
        from cruise_control_tpu.monitor.sampling.samplers import SimulatedMetricSampler
    else:
        from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend
        from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
        from cruise_control_tpu_torch.monitor.sampling.samplers import (
            SimulatedMetricSampler,
        )
    return dict(SimulatedClusterBackend=SimulatedClusterBackend, LoadMonitor=LoadMonitor,
                SimulatedMetricSampler=SimulatedMetricSampler)


@pytest.mark.parametrize("horizon_ms", HORIZONS)
def test_forecaster_matches_reference(horizon_ms, reference):
    want = reference["forecaster"][horizon_ms]
    _, port_lm = _monitored(_ns(False))
    got = WorkloadForecaster(port_lm, ForecastKnobs(horizon_ms=horizon_ms),
                             device="cpu").forecast()
    assert got.entities == want["entities"]
    assert got.forecast.dtype == np.float32
    assert got.forecast.tobytes() == want["forecast"].tobytes()
    assert np.array_equal(got.last, want["last"])
    assert got.scale.tobytes() == want["scale"].tobytes()
    assert (got.rising, got.generation, got.horizon_ms) == (
        want["rising"], want["generation"], want["horizon_ms"])
    assert got.rising


def test_forecaster_memoizes_per_generation_and_knobs():
    _, lm = _monitored(_ns(False))
    fc = WorkloadForecaster(lm, ForecastKnobs(horizon_ms=600_000), device="cpu")
    r1 = fc.forecast()
    r2 = fc.forecast()
    assert r1 is r2 and fc.cache_hits == 1 and fc.forecasts_computed == 1
    assert float(r1.max_scale_per_resource().max()) > 1.02
    fc.set_knobs(ForecastKnobs(horizon_ms=60_000))
    r3 = fc.forecast()
    assert r3 is not r1 and fc.forecasts_computed == 2
    st = fc.state_json()
    assert st["forecastsComputed"] == 2 and st["rising"] is r3.rising
    # a new window moves the generation: a fresh forecast
    lm.sample_once(now_ms=11 * 300_000.0)
    assert fc.forecast() is not r3 and fc.forecasts_computed == 3


def test_forecaster_device_is_explicit(monkeypatch):
    """The forecaster runs on ``cuda`` unless asked for the CPU; without a
    card ``cuda`` raises. A CPU tensor runs the twin and launches nothing."""
    _, lm = _monitored(_ns(False))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        WorkloadForecaster(lm)
    K15.KERNEL.launches = 0
    WorkloadForecaster(lm, device="cpu").forecast()
    assert K15.KERNEL.launches == 0


def test_goal_violation_check_rides_revalidation_memo():
    """tests/test_forecast.py's memo case through the port: zero-churn
    detection rounds on a synced resident session re-serve the carried
    verdicts (``revalidated_rounds`` advances)."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.session import ResidentClusterSession
    from cruise_control_tpu_torch.config import cruise_control_config
    from cruise_control_tpu_torch.detector.detectors import GoalViolationDetector
    ns = _ns(False)
    rng = np.random.default_rng(0)
    be = ns["SimulatedClusterBackend"]()
    for b in range(6):
        be.add_broker(b, f"r{b % 3}")
    for p in range(30):
        reps = [int(x) for x in rng.choice(6, size=2, replace=False)]
        be.create_partition(f"t{p % 3}", p, reps, size_mb=float(rng.uniform(10, 500)),
                            bytes_in_rate=float(rng.uniform(1, 50)),
                            bytes_out_rate=float(rng.uniform(1, 100)),
                            cpu_util=float(rng.uniform(0.1, 5)))
    lm = ns["LoadMonitor"](backend=be, sampler=ns["SimulatedMetricSampler"](be))
    lm.start_up()
    for i in range(6):
        lm.sample_once(now_ms=i * 300_000.0)
    goals = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]
    sess = ResidentClusterSession(lm, device="cpu")
    opt = GoalOptimizer(config=cruise_control_config(
        {"goals": ",".join(goals), "hard.goals": "ReplicaCapacityGoal"}), device="cpu")
    det = GoalViolationDetector(opt, lm, goals, session_supplier=lambda: sess)
    assert sess.sync()["mode"] == "rebuild"
    det.run_once(0.0)
    lm.sample_once(now_ms=6 * 300_000.0)
    sess.sync()
    det.run_once(1.0)
    assert sess.revalidated_rounds == 0
    lm.sample_once(now_ms=7 * 300_000.0)
    sess.sync()
    det.run_once(2.0)
    assert sess.revalidated_rounds == 1
