"""The port's incremental service rounds against the reference's,
mirroring ``tests/test_incremental.py`` cases 1-3 and 5-8 (the
revalidation memo, a forced re-run, churn and the memo's return, epoch
fallback, a dropped drift baseline, a chain change, ``revalidate`` off),
``test_seed_dirty_reduced_round_one_sided_parity`` and
``test_dirty_replica_mask_targets_touched_sets``: every round's mode,
violated and certificate sets, per-goal actions, passes and modes,
movements, proposals and final-state digests equal the reference's; the
seeded round equals the reference's seeded round (and keeps the one-sided
contract against the full round here).

K1's seed mask and K13 are held against the reference's ``_mask_key`` +
``_select_candidates`` and ``seeded_work_probe`` on its own inputs,
tolerance 0. The reference runs in one fresh interpreter
(``tests/torch_reference.py`` ``reference_incremental_cases``).

The spill / readmit case (``test_carryover_survives_spill_readmit``) runs
as the ``spill`` case; the pipelined loop's shadow sync is held in
``tests/test_torch_pipeline.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import engine as ref_engine
from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.analyzer.goals import make_goals as ref_make_goals
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import engine
from cruise_control_tpu_torch.analyzer.goals import make_goals
from cruise_control_tpu_torch.analyzer.optimizer import DEFAULT_GOALS
from cruise_control_tpu_torch.analyzer.session_script import port_ns
from cruise_control_tpu_torch.kernels import probe, select
from torch_reference import (
    INCREMENTAL_CASES, INCREMENTAL_GOALS, incremental_case, one_torch_thread, reference_incremental_cases,
)

# the port's small tensors: one torch intra-op thread per test worker
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

NS = port_ns("cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_incremental_cases(tmp_path_factory.mktemp("incremental"))


@pytest.mark.parametrize("name", [n for n in INCREMENTAL_CASES if n != "dirty_mask"])
def test_rounds_match_the_reference(reference, name):
    port, ref = incremental_case(NS, name), reference[name]
    assert len(port["rows"]) == len(ref["rows"])
    for i, (p, r) in enumerate(zip(port["rows"], ref["rows"])):
        assert p == r, (name, i, {k: (p[k], r[k]) for k in p if p[k] != r[k]})
    assert {k: v for k, v in port.items() if k != "rows"} == {
        k: v for k, v in ref.items() if k != "rows"}


def test_round_modes_are_the_reference_tests_modes(reference):
    """The modes tests/test_incremental.py asserts, read off the reference's
    rows (the port's equal them above)."""
    modes = {n: [r["round"] for r in reference[n]["rows"]]
             for n in INCREMENTAL_CASES if n != "dirty_mask"}
    assert modes["zero_churn"] == ["full", "full", "revalidated", "revalidated"]
    assert reference["zero_churn"]["donated_in_memo"] == 0
    assert modes["forced_rerun"] == ["full", "full", "full"]
    assert modes["churn"] == ["full", "full", "full", "revalidated"]
    assert modes["epoch"] == ["full", "full", "revalidated", "full"]
    assert reference["epoch"]["sync"] == "rebuild"
    assert reference["epoch"]["carryover_cleared"]
    assert modes["shadow"] == ["full", "full", "full", "revalidated"]
    assert modes["chain_change"] == ["full", "full", "full"]
    assert modes["revalidate_off"] == ["full", "full", "full"]
    assert modes["seeded"] == ["full", "full", "full", "reduced"]
    assert modes["spill"] == ["full", "full", "revalidated", "revalidated"]
    assert reference["spill"]["spilled"] and reference["spill"]["carryover_kept"]
    assert reference["spill"]["readmitted"]
    rz = reference["zero_churn"]["rows"]
    assert all(m == "revalidated" for m in rz[2]["modes"])
    assert {k: v for k, v in rz[2].items() if k not in ("round", "modes")} == {
        k: v for k, v in rz[1].items() if k not in ("round", "modes")}


def test_seed_dirty_reduced_round_one_sided_parity(reference):
    """Violations only shrink, certificates only appear, against the full
    round on the same churn (the reference's contract, held here by both)."""
    _, full, _, red = incremental_case(NS, "seeded")["rows"]
    assert full["round"] == "full" and red["round"] == "reduced"
    assert "reduced" in red["modes"]
    assert set(red["after"]) <= set(full["after"])
    def certs(row):
        return {n for n, c in zip(INCREMENTAL_GOALS, row["proven"]) if c}

    assert certs(full) <= certs(red)
    assert reference["seeded"]["rows"][3] == red


def test_dirty_replica_mask_targets_touched_sets(reference):
    port = incremental_case(NS, "dirty_mask")
    for key in ("brokers", "topics", "both", "none"):
        assert np.array_equal(port[key], reference["dirty_mask"][key]), key
    assert not port["none"].any() and port["brokers"].any() and port["topics"].any()


# --- K1's seed mask and K13 on the reference's inputs -------------------------
SPEC = dict(num_brokers=24, num_racks=4, num_topics=6, num_partitions=300,
            max_replication=3, skew=1.5, seed=11, target_cpu_util=0.45)


@pytest.fixture(scope="module")
def ctx():
    ct, meta = ref_ct_mod.pad_cluster(*ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    penv = convert.env_from_arrays(convert.leaves(renv), device="cpu")
    pst = convert.state_from_arrays(convert.leaves(rst), device="cpu")
    R = penv.num_replicas
    rng = np.random.default_rng(3)
    valid = np.asarray(ct.replica_valid)
    masks = {"dirty": (rng.random(R) < 0.05) & valid, "none": np.zeros(R, bool),
             "all": np.ones(R, bool), "padding only": ~valid}
    return dict(renv=renv, rst=rst, penv=penv, pst=pst, masks=masks)


@pytest.mark.parametrize("mask_name", ["dirty", "none", "all", "padding only"])
@pytest.mark.parametrize("stall", [0, 3])
def test_masked_selection_matches_mask_key_and_top_k(ctx, mask_name, stall):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    mask = ctx["masks"][mask_name]
    params = ref_engine.EngineParams()
    for rg, pg in zip(ref_make_goals(DEFAULT_GOALS), make_goals(DEFAULT_GOALS)):
        if not pg.uses_replica_moves:
            continue
        sev = rg.broker_severity(renv, rst)
        rkey = rg.replica_key(renv, rst, sev)
        pkey = pg.replica_key(penv, pst, pg.broker_severity(penv, pst))
        assert np.array_equal(np.asarray(rkey), pkey.numpy()), pg.name
        k = 64
        kv_r, cand_r = ref_engine._select_candidates(
            ref_engine._mask_key(rkey, jnp.asarray(mask)), k, jnp.int32(stall),
            pg.is_hard, params)
        kv_p, cand_p = select.select_candidates_plain(pkey.contiguous(), k, stall,
                                                      seed_mask=torch.from_numpy(mask))
        assert np.array_equal(np.asarray(cand_r), cand_p.numpy()), pg.name
        assert np.array_equal(np.asarray(kv_r).view(np.int32),
                              kv_p.numpy().view(np.int32)), pg.name


@pytest.mark.parametrize("mask_name", ["dirty", "none", "all", "padding only"])
def test_seeded_work_probe_matches_the_reference(ctx, mask_name):
    renv, rst, penv, pst = ctx["renv"], ctx["rst"], ctx["penv"], ctx["pst"]
    mask = ctx["masks"][mask_name]
    got_any = []
    for rg, pg in zip(ref_make_goals(DEFAULT_GOALS), make_goals(DEFAULT_GOALS)):
        want = bool(rg.seeded_work_probe(renv, rst, jnp.asarray(mask)))
        got = pg.seeded_work_probe(penv, pst, torch.from_numpy(mask))
        assert got.dtype == torch.bool and bool(got) == want, pg.name
        pr = engine.goal_probe(pg, penv, pst, torch.from_numpy(mask))
        assert pr["has_work"] == want and pr["violated"] == bool(rg.violated(renv, rst))
        assert np.float32(pr["stat"]) == np.float32(rg.stat(renv, rst)), pg.name
        got_any.append(want)
    if mask_name in ("none", "padding only"):
        assert not any(got_any)
    else:
        assert any(got_any)


def test_probe_twin_reduces_any_key_above_neg_inf():
    mask = torch.tensor([True, False, True, True])
    inf = -torch.inf
    k0 = torch.tensor([inf, 5.0, inf, inf])
    k1 = torch.tensor([inf, inf, inf, 0.0])
    assert not bool(probe.seeded_probe_plain(mask, [k0]))
    assert bool(probe.seeded_probe_plain(mask, [k0, k1]))
    assert not bool(probe.seeded_probe_plain(mask, [torch.full((4,), torch.nan)]))
