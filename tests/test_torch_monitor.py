"""The port's backend and monitor stack (``backend/``, ``monitor/``,
``model/delta.py``) against the reference's: the same backend script
through both packages gives

- ``LoadMonitor.cluster_model()``: every ``ClusterTensor`` leaf and the
  meta's names equal;
- ``partition_load_columns`` / ``replica_load_rows``: equal, bit for bit;
- ``diff_snapshots``, ``replica_slot_values``, ``dirty_replica_sets`` and
  ``appended_partition_slots`` under leadership flips, a broker kill,
  replica churn and partition creation: equal.

The monitor stack is numpy code in both packages, so both run in-process.
"""
import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.model import delta as ref_delta
from cruise_control_tpu_torch.analyzer.session_script import (
    SESSION_SMALL, port_ns, session_backend,
)
from cruise_control_tpu_torch.model import delta as port_delta
from cruise_control_tpu_torch.common.retries import (
    ServiceUnavailableError as RetriesServiceUnavailableError,
)
from cruise_control_tpu_torch.common.sensors import MetricRegistry
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor, ServiceUnavailableError,
)
from torch_reference import (
    monitored, one_torch_thread, reference_session_ns, scripted_delta_stream, session_test_backend,
)

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

PORT, REF = port_ns("cpu"), reference_session_ns()


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return a.shape == b.shape and np.array_equal(a, b)


def _both(build):
    return build(PORT), build(REF)


def _jbod(ns):
    be = session_test_backend(ns)
    return be, monitored(ns, be)


def _e2e_like(ns):
    be = session_backend(ns, SESSION_SMALL)
    return be, monitored(ns, be, config=ns["cruise_control_config"](
        {"num.metrics.windows": 5, "min.samples.per.metrics.window": 1}))


@pytest.mark.parametrize("build, stream", [(_jbod, False), (_jbod, True),
                                           (_e2e_like, False)],
                         ids=["jbod", "jbod after deltas", "small"])
def test_cluster_model_leaves_equal(build, stream):
    (pbe, plm), (rbe, rlm) = _both(build)
    if stream:
        scripted_delta_stream(pbe, plm)
        scripted_delta_stream(rbe, rlm)
    pct, pmeta = plm.cluster_model()
    rct, rmeta = rlm.cluster_model()
    for f in dataclasses.fields(rct):
        assert _same(getattr(pct, f.name), getattr(rct, f.name)), f.name
    for name in ("topic_names", "partition_ids", "broker_ids", "rack_ids", "logdirs",
                 "num_racks", "num_valid_replicas"):
        assert getattr(pmeta, name) == getattr(rmeta, name), name


def test_load_columns_and_rows_bit_for_bit():
    (pbe, plm), (rbe, rlm) = _both(_jbod)
    scripted_delta_stream(pbe, plm)
    scripted_delta_stream(rbe, rlm)
    psnap, rsnap = plm._snapshot(), rlm._snapshot()
    pcols = plm.partition_load_columns(psnap.partition_keys, psnap.generation)
    rcols = rlm.partition_load_columns(rsnap.partition_keys, rsnap.generation)
    for a, b in zip(pcols, rcols):
        assert _same(a, b)
    rep_part = np.repeat(np.arange(psnap.num_partitions), np.diff(psnap.rep_ptr))
    for a, b in zip(LoadMonitor.replica_load_rows(pcols, rep_part),
                    type(rlm).replica_load_rows(rcols, rep_part)):
        assert a.dtype == np.float32 and _same(a, b)


def _mutations():
    def flips(be):
        for tp in [("t1", 1), ("t3", 3), ("t4", 10)]:
            be.elect_leaders({tp: be.partitions()[tp].replicas[-1]})

    def kill(be):
        be.kill_broker(4)

    def churn(be):
        be.alter_partition_reassignments({("t0", 0): [7, 8]})
        be.advance(10 * 60_000.0)

    def append(be):
        be.create_partition("zz-late", 0, [0, 2], size_mb=100.0, bytes_in_rate=10.0,
                            bytes_out_rate=20.0, cpu_util=1.0)
        be.create_partition("zz-late", 1, [3, 4], size_mb=50.0, bytes_in_rate=5.0,
                            bytes_out_rate=10.0, cpu_util=0.5)

    def insert(be):
        be.create_partition("t2", 100, [1, 5], size_mb=10.0, bytes_in_rate=1.0,
                            bytes_out_rate=2.0, cpu_util=0.5)

    def rf_change(be):
        be.alter_partition_reassignments({("t0", 0): [0, 1, 2]})
        be.advance(10 * 60_000.0)

    return dict(flips=flips, kill=kill, churn=churn, append=append, insert=insert,
                rf_change=rf_change)


@pytest.mark.parametrize("mutation", list(_mutations()))
def test_diff_snapshots_and_dirty_sets_equal(mutation):
    fn = _mutations()[mutation]
    out = {}
    for tag, ns, mod in (("port", PORT, port_delta), ("ref", REF, ref_delta)):
        be = session_test_backend(ns, jbod=False)
        prev = be.snapshot()
        fn(be)
        new = be.snapshot()
        d = mod.diff_snapshots(prev, new)
        res = dict(fields={f.name: getattr(d, f.name) for f in dataclasses.fields(d)},
                   churn=d.churn, noop=d.is_noop)
        if d.compatible:
            res["dirty"] = mod.dirty_replica_sets(prev, new, d)
            if d.num_changed:
                res["slot_values"] = mod.replica_slot_values(
                    new, d.changed_slots, np.asarray(sorted(be.brokers()), np.int64), 1)
            res["appended"] = mod.appended_partition_slots(new, d.num_partitions_before)
        out[tag] = res
    p, r = out["port"], out["ref"]
    assert set(p) == set(r)
    for key in p:
        pv, rv = p[key], r[key]
        if isinstance(rv, dict):
            assert set(pv) == set(rv), key
            for k in rv:
                assert _same(pv[k], rv[k]) if isinstance(rv[k], np.ndarray) else (
                    pv[k] == rv[k]), (key, k)
        elif isinstance(rv, np.ndarray):
            assert _same(pv, rv), key
        else:
            assert pv == rv, key
    if mutation in ("rf_change", "insert"):
        # an RF change and a key inserted before the last one rebuild
        assert not p["fields"]["compatible"]
    else:
        assert p["fields"]["compatible"] and p["churn"] > 0


def test_monitor_runs_without_the_reference_classes():
    """The port's monitor resolves no class-valued config key (their
    defaults name the reference's classes); its sensors are the port's
    ``MetricRegistry`` and its degraded-read error the port's
    ``common.retries.ServiceUnavailableError``."""
    be = session_test_backend(PORT)
    lm = monitored(PORT, be, config=PORT["cruise_control_config"]())
    assert lm._store is None and lm.on_execution_store is None
    assert isinstance(lm._sensors, MetricRegistry)
    assert ServiceUnavailableError is RetriesServiceUnavailableError
    assert lm.num_valid_windows >= 1

    class Breaker:
        def call(self, _what, _fn):
            raise OSError("down")

        def retry_after_s(self):
            return 2.5

    lm._ft = Breaker()
    with pytest.raises(ServiceUnavailableError) as err:
        lm.cluster_model()
    assert err.value.retry_after_s == 2.5
