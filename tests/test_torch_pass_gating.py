"""The port's convergence-gated dispatch against the reference's, mirroring
the solo cases of ``tests/test_pass_gating.py``:

- ``test_oversized_chunk_runs_to_budget_floor``: a chunk wider than the
  exit budgets never quiesces, and the per-goal passes equal the
  monolithic loop's;
- ``test_certificate_finisher_skip_fires_and_is_inert``: with an
  unsatisfiable capacity bound the carried violated+proven certificates let
  the next low-churn round skip quiesced zero-action goals' finishers
  (``allow_cert_skip``), without moving a verdict, certificate, proposal or
  assignment bit.

Every round's row (modes, verdicts, certificates, per-goal actions, passes,
gating counters, movements, proposals, final-state digests) equals the
reference's, which runs in one fresh interpreter
(``tests/torch_reference.py`` ``reference_gating_cases``). The batched
(fleet) case waits for ROADMAP Queue 1 item 13.
"""
import pytest

from cruise_control_tpu_torch.analyzer.session_script import port_ns
from torch_reference import (
    GATING_CONFIGS, gating_case, one_torch_thread, reference_gating_cases,
)

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

NS = port_ns("cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_gating_cases(tmp_path_factory.mktemp("gating"))


@pytest.fixture(scope="module")
def port():
    return {name: gating_case(NS, name) for name in GATING_CONFIGS}


def _parity(row):
    return {k: row[k] for k in ("after", "proven", "remaining", "proposals_sha")} | {
        "assignment": {k: row["digests"][k] for k in
                       ("replica_broker", "replica_is_leader", "replica_disk")}}


@pytest.mark.parametrize("name", list(GATING_CONFIGS))
def test_rounds_match_the_reference(reference, port, name):
    for i, (p, r) in enumerate(zip(port[name], reference[name])):
        assert p == r, (name, i, {k: (p[k], r[k]) for k in p if p[k] != r[k]})


def test_oversized_chunk_runs_to_budget_floor(port):
    (m1, _), (b1, _) = port["mono"], port["oversized"]
    assert _parity(b1) == _parity(m1)
    assert b1["early_exit_goals"] == 0 and sum(b1["passes_skipped"]) == 0
    assert b1["quiesce_chunk"] == [-1] * len(b1["quiesce_chunk"])
    assert b1["passes"] == m1["passes"]
    assert b1["passes_dispatched"] == m1["passes_dispatched"]


def test_certificate_finisher_skip_fires_and_is_inert(port):
    (s1, s2), (o1, o2) = port["skip"], port["noskip"]
    assert any(v and c for v, c in zip(
        [n in s1["after"] for n in ("ReplicaCapacityGoal", "ReplicaDistributionGoal",
                                    "LeaderReplicaDistributionGoal")], s1["proven"]))
    fired = [i for i, f in enumerate(s2["finisher_skipped"]) if f]
    assert fired
    assert not any(o2["finisher_skipped"])
    for i in fired:
        assert s2["proven"][i] and s2["actions"][i] == 0 and s2["quiesce_chunk"][i] >= 0
    assert _parity(s1) == _parity(o1)
    assert _parity(s2) == _parity(o2)
