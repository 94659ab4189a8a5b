"""K4/K5 ``segment_count`` and its grouped form ``segment_counts``, and the
host-side plans of the redesigned ``segment_count`` and K2 launches.

The grouped form's twin against single ``segment_count`` twins and an
independent numpy tally at the edges ``chip_smoke.py`` phase 3 holds the
kernel to; refresh's and the batched applies' integer tallies (one grouped
call each) against the JAX package's ``refresh`` / ``apply_*_batched`` on
fixture16 and the 32-broker cluster (the reference runs in this process,
as in ``test_torch_kernels_plain.py``); and the plans' invariants that the
CUDA entry points refuse to launch without. Every comparison is exact."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import env as ref_env_mod
from cruise_control_tpu.analyzer import state as ref_state_mod
from cruise_control_tpu.model import cluster_tensor as ref_ct_mod
from cruise_control_tpu.model import random_cluster as ref_rc
from cruise_control_tpu_torch import convert
from cruise_control_tpu_torch.analyzer import state as state_mod
from cruise_control_tpu_torch.kernels import (
    admission, build, disk, finalize, forecast, keys, leadership, move_score, ple, probe,
    segment, select, swap,
)
from torch_reference import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

SPEC = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
            max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
COUNT_FIELDS = ("replica_count", "leader_count", "part_rack_count", "topic_broker_count",
                "topic_leader_count")


def _tally(rng, n, nseg, weights="signed", init=True, lo=0):
    seg = torch.as_tensor(rng.integers(lo, nseg, n), dtype=torch.int64)
    w = {"signed": lambda: torch.as_tensor(rng.integers(-2, 3, n), dtype=torch.int32),
         "zero": lambda: torch.zeros(n, dtype=torch.int32),
         "ones": lambda: None}[weights]()
    ini = torch.as_tensor(rng.integers(-9, 99, nseg), dtype=torch.int32) if init else None
    return seg, nseg, w, ini


def _edge(kind: str):
    """(seg, nseg, weights, init) of the edges the kernel is held to, at
    small shapes."""
    rng = np.random.default_rng(15)
    if kind == "zero and negative weights":
        return _tally(rng, 700, 64)
    if kind == "every weight zero":
        return _tally(rng, 500, 32, "zero")
    if kind == "one segment":          # the padding rows: all in one segment
        n = 7102
        return (torch.zeros(n, dtype=torch.int64), 7, torch.ones(n, dtype=torch.int32), None)
    if kind == "nseg beyond shared memory":
        return _tally(rng, 3000, segment.SMEM_BINS + 1)
    if kind == "N=0 init given":
        return _tally(rng, 0, 16)
    if kind == "N=0 no init":
        return _tally(rng, 0, 16, init=False)
    if kind == "outside [0, nseg), no weights":
        return _tally(rng, 900, 50, "ones", lo=-5)
    return _tally(rng, 600, 40, init=False)


EDGES = ["zero and negative weights", "every weight zero", "one segment",
         "nseg beyond shared memory", "N=0 init given", "N=0 no init",
         "outside [0, nseg), no weights", "no init"]


def _numpy_tally(seg, nseg, w, init):
    out = np.zeros(nseg, np.int64) if init is None else init.numpy().astype(np.int64)
    s = seg.numpy()
    wt = np.ones(len(s), np.int64) if w is None else w.numpy().astype(np.int64)
    keep = (s >= 0) & (s < nseg)
    np.add.at(out, s[keep], wt[keep])
    return out


@pytest.mark.parametrize("kind", EDGES)
def test_count_twin_matches_numpy_at_the_edges(kind):
    """``segment_count``'s twin: init (or zeros) plus the weights (or ones)
    of the rows in [0, nseg), exactly as numpy's unbuffered add."""
    t = _edge(kind)
    got = segment.segment_count_plain(*t)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), _numpy_tally(*t))


@pytest.mark.parametrize("start", [0, 3])
def test_grouped_twin_is_the_single_calls(start):
    """``segment_counts`` of five tallies (on the CPU its twin) equals five
    single ``segment_count`` calls, in order, whatever the tallies."""
    tallies = [_edge(k) for k in EDGES[start:start + 5]]
    got = segment.segment_counts(tallies)
    want = [segment.segment_count(*t) for t in tallies]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _clusters(name):
    if name == "fixture16":
        from __graft_entry__ import _fixture_cluster
        ct, meta = _fixture_cluster()
    else:
        ct, meta = ref_ct_mod.pad_cluster(
            *ref_rc.generate_scale(ref_rc.RandomClusterSpec(**SPEC)))
    renv = ref_env_mod.make_env(ct, meta)
    rst = ref_state_mod.init_state(renv, ct.replica_broker, ct.replica_is_leader,
                                   ct.replica_offline, ct.replica_disk)
    return (renv, rst, convert.env_from_arrays(convert.leaves(renv), "cpu"),
            convert.state_from_arrays(convert.leaves(rst), "cpu"))


def _same_counts(rst, pst):
    ref, port = convert.leaves(rst), convert.leaves(pst)
    for f in COUNT_FIELDS:
        assert np.array_equal(np.asarray(ref[f]).astype(np.int64),
                              np.asarray(port[f]).astype(np.int64)), f


def _wave(renv, rst, rng, W):
    """W replicas of distinct partitions, each to a broker other than its
    own; about half the rows enabled."""
    rpart = np.asarray(renv.replica_partition)
    valid = np.flatnonzero(np.asarray(renv.replica_valid))
    _parts, first = np.unique(rpart[valid], return_index=True)
    reps = rng.permutation(valid[first])[:W]
    rb = np.asarray(rst.replica_broker)[reps]
    dsts = (rb + rng.integers(1, renv.num_brokers, len(reps))) % renv.num_brokers
    return reps, dsts, rng.random(len(reps)) < 0.5


@pytest.mark.parametrize("cluster", ["fixture16", "spec-32b"])
def test_refresh_and_apply_tallies_match_the_reference(cluster):
    """refresh's five integer tallies (one grouped call) and a batched move,
    swap and leadership wave's (one grouped call each, a swap one a leg)
    equal the JAX package's ``refresh`` / ``apply_moves_batched`` /
    ``apply_swaps_batched`` / ``apply_leaderships_batched`` tallies."""
    renv, rst, penv, pst = _clusters(cluster)
    rng = np.random.default_rng(7)
    R, B = renv.num_replicas, renv.num_brokers
    rb = rng.integers(0, B, R).astype(np.int32)
    lead = rng.random(R) < 0.4
    rst2 = ref_state_mod.refresh(renv, rst.__class__(**{
        **convert.leaves(rst), "replica_broker": jnp.asarray(rb),
        "replica_is_leader": jnp.asarray(lead)}))
    pst2 = state_mod.refresh(penv, state_mod.EngineState(**{
        **{f: getattr(pst, f) for f in pst.__dataclass_fields__},
        "replica_broker": torch.as_tensor(rb).long(),
        "replica_is_leader": torch.as_tensor(lead)}))
    _same_counts(rst2, pst2)
    reps, dsts, mask = _wave(renv, rst, rng, 24)
    _same_counts(
        ref_state_mod.apply_moves_batched(renv, rst, jnp.asarray(reps, jnp.int32),
                                          jnp.asarray(dsts, jnp.int32), jnp.asarray(mask)),
        state_mod.apply_moves_batched(penv, pst, torch.as_tensor(reps).long(),
                                      torch.as_tensor(dsts).long(), torch.as_tensor(mask)))
    # swaps: out and in replicas on different brokers and partitions
    half = len(reps) // 2
    r_out, r_in, smask = reps[:half], reps[half:2 * half], mask[:half]
    _same_counts(
        ref_state_mod.apply_swaps_batched(renv, rst, jnp.asarray(r_out, jnp.int32),
                                          jnp.asarray(r_in, jnp.int32), jnp.asarray(smask)),
        state_mod.apply_swaps_batched(penv, pst, torch.as_tensor(r_out).long(),
                                      torch.as_tensor(r_in).long(), torch.as_tensor(smask)))
    # leadership: from each partition's leader to another of its replicas
    members = np.asarray(renv.partition_replicas)
    is_lead = np.asarray(rst.replica_is_leader)
    src, dst = [], []
    for p in range(members.shape[0]):
        row = [m for m in members[p] if m >= 0]
        leaders = [m for m in row if is_lead[m]]
        others = [m for m in row if not is_lead[m]]
        if leaders and others:
            src.append(leaders[0])
            dst.append(others[0])
        if len(src) == 16:
            break
    lmask = rng.random(len(src)) < 0.6
    _same_counts(
        ref_state_mod.apply_leaderships_batched(renv, rst, jnp.asarray(src, jnp.int32),
                                                jnp.asarray(dst, jnp.int32),
                                                jnp.asarray(lmask)),
        state_mod.apply_leaderships_batched(penv, pst, torch.as_tensor(src).long(),
                                            torch.as_tensor(dst).long(),
                                            torch.as_tensor(lmask)))


@pytest.mark.parametrize("n, nseg, form, want", [
    (114_688, 1024, segment.GRID, 4096),    # refresh's broker tallies: histograms
    (3520, 1024, segment.GRID, 0),          # an apply: too few rows for a chunk
    (1_048_576, 7168, segment.GRID, 0),     # a chunk of 28,672 rows: global atomics
    (1_048_576, 229_376, segment.GRID, 0),  # beyond shared memory
    (100, 1024, segment.SMEM, 4096),        # forced: a chunk even for a few rows
    (114_688, 1024, segment.GLOBAL, 0),
    (114_688, 1024, segment.OWNED, 0),
])
def test_count_chunk_plan(n, nseg, form, want):
    assert segment.count_chunk(n, nseg, form) == want


def test_count_chunk_refuses_a_histogram_beyond_shared_memory():
    with pytest.raises(ValueError):
        segment.count_chunk(10, segment.SMEM_BINS + 1, segment.SMEM)


@pytest.mark.parametrize("rows, nseg, want", [
    ((3520, 3520, 3520), 8, segment.OWNED),
    ((64, 64), 8, segment.OWNED),
    ((segment.OWNED_ROWS, 5), 8, segment.OWNED),
    ((segment.OWNED_ROWS + 1, 5), 8, segment.GRID),       # refresh
    ((114_688,), 8, segment.GRID),
    # the slice's apply: 1,024 brokers, 1,000,000 partition x rack and
    # 204,800 topic x broker segments, 3,520 rows: the blocks read 2.4M rows
    ((3520,) * 5, (1024, 1024, 1_000_000, 204_800, 204_800), segment.OWNED),
    # rung 4's apply: 20M partition x rack and 14.7M topic x broker segments
    ((3520,) * 5, (7168, 7168, 20_971_520, 14_680_064, 14_680_064), segment.GRID),
])
def test_count_plan_picks_the_owned_form_for_small_tallies(rows, nseg, want):
    nsegs = nseg if isinstance(nseg, tuple) else (nseg,) * len(rows)
    tallies = [(torch.zeros(n, dtype=torch.int64), m, None, None) for n, m in zip(rows, nsegs)]
    assert segment.count_plan(tallies) == want


def test_pack_tallies_mirrors_the_entry_points_layout():
    """Seven 8-byte fields a tally (``csrc/segment_sum.cu`` Tally); absent
    weights and init are NULL; the chunk follows ``count_chunk``."""
    assert ctypes.sizeof(segment._Tally) == 56
    seg = torch.arange(5000, dtype=torch.int64) % 7
    w = torch.ones(5000, dtype=torch.int32)
    init = torch.zeros(7, dtype=torch.int32)
    outs = [torch.empty(7, dtype=torch.int32), torch.empty(7, dtype=torch.int32)]
    arr = segment.pack_tallies([(seg, 7, w, init), (seg, 7, None, None)], outs, segment.GRID)
    assert arr[0].seg == seg.data_ptr() and arr[0].w == w.data_ptr()
    assert arr[0].init == init.data_ptr() and arr[0].out == outs[0].data_ptr()
    assert arr[1].w is None and arr[1].init is None
    assert (arr[0].n, arr[0].nseg, arr[0].chunk) == (5000, 7, 28)
    assert segment.pack_tallies([(seg, 7, w, init)], outs[:1], segment.OWNED)[0].chunk == 0


def test_segment_counts_takes_one_to_five_tallies_on_the_card_only():
    """The CPU runs the twin whatever the count; a CUDA launch refuses six
    tallies before it reaches the card (checked on the host)."""
    t = _edge("no init")
    assert len(segment.segment_counts([t] * 6)) == 6
    with pytest.raises(ValueError):
        segment._counts([t] * 6, segment.KERNEL_COUNTS, "", None)


@pytest.mark.parametrize("K, L, T, Bq, want", [
    (1760, 1, 71, 101, (8, 7, 8, 512)),     # rung 4: K 1,760, B 7,168, T 71
    (1760, 1, 16, 64, (4, 16, 16, 256)),    # the slice: B 1,024, T 16
    (1024, 1, 1, 1024, (2, 256, 32, 256)),  # the exhaustive scan, T 1
    (64, 1, 1, 7168, (1, 512, 32, 512)),
    (160, 16, 16, 7, (1, 2, 2, 32)),        # the fleet's lanes, B 100
    (50, 1, 300, 4, (1, 1, 1, 320)),        # more classes than threads
    (50, 1, 700, 4, (1, 1, 1, 512)),
])
def test_k2_launch_plan(K, L, T, Bq, want):
    """(tile, S, G, threads): the largest row tile that keeps MIN_THREADS
    threads on the card, S sub-streams a class, G reduction lanes, the
    CTA's threads; within what ``cc_move_score_classes_lanes`` takes."""
    tile, S, G, threads = plan = move_score.launch_plan(K, L, T, Bq)
    assert plan == want
    assert 1 <= tile <= move_score.TILES[0] and tile * threads * 8 <= 32 * 1024
    assert 1 <= S <= Bq and 32 <= threads <= 512 and threads % 32 == 0
    assert G & (G - 1) == 0 and G <= 32 and threads % G == 0
    assert S == 1 or T * S <= threads


def test_k2_launch_plan_tile_override():
    """A tile override within the bests' shared memory (8 bytes a row and
    thread, 32 KB) is taken; a larger one is refused."""
    assert move_score.launch_plan(1760, 1, 71, 101, tile=2)[0] == 2
    assert move_score.launch_plan(1760, 1, 16, 64, tile=16)[0] == 16
    with pytest.raises(ValueError):
        move_score.launch_plan(1760, 1, 71, 101, tile=9)


def test_k2_twin_tie_rule():
    """The contract the kernel's reduction keeps: the lowest q of the best
    value (-0.0 ties +0.0), q 0 for a class of -inf, and the value NaN with
    q = Bq when a NaN scores (no q compares equal to it)."""
    B, T = 6, 2
    args = dict(cur_b=torch.tensor([0]), orig_b=torch.tensor([0]),
                sib_b=torch.full((1, 1), -1), row_ok=torch.tensor([True]),
                d_rows=torch.zeros((1, 8)), dst_room=torch.zeros((8, B)), room_mask=0,
                prow=None, rack_lim=None, row_f=torch.zeros((1, 4)),
                dst_ok=torch.ones(B, dtype=torch.bool), new_ok=torch.ones(B, dtype=torch.bool),
                broker_rack=torch.zeros(B, dtype=torch.int64))

    def best(c1):
        col_f = torch.stack([torch.ones(B), torch.tensor(c1, dtype=torch.float32),
                             torch.zeros(B), torch.zeros(B)])
        val, q = move_score.move_score_classes_plain(
            move_score.GOAL_REPLICA_CAPACITY, T, args["cur_b"], args["orig_b"],
            args["sib_b"], args["row_ok"], args["d_rows"], args["dst_room"],
            args["room_mask"], args["prow"], args["rack_lim"], args["row_f"], col_f,
            args["dst_ok"], args["new_ok"], args["broker_rack"])
        return val[0].tolist(), q[0].tolist()

    # column 0 is the row's own broker (-inf); class 1 ties at q 1 and 2
    v, q = best([9.0, 2.0, 5.0, 7.0, 1.0, 7.0])
    assert v == [5.0, 7.0] and q == [1, 1]
    v, q = best([9.0, 0.0, 0.0, -0.0, 0.0, 0.0])
    assert q == [1, 0]
    v, q = best([9.0, 2.0, float("nan"), 7.0, 1.0, 3.0])
    assert np.isnan(v[0]) and q == [3, 1]


def _entry_points():
    """(module, C entry point) of every kernel library the port loads."""
    mods = (admission, disk, finalize, forecast, keys, leadership, move_score, ple, probe,
            segment, select, swap)
    return [(m, name) for m in mods for name in m._SIGNATURES]


@pytest.mark.parametrize("mod, name", _entry_points(),
                         ids=[name for _m, name in _entry_points()])
def test_every_entry_point_reports_its_launches(mod, name):
    """Each ``cc_*`` entry point takes ``int* launches`` just before the
    stream and writes the CUDA launches it made there; its ctypes signature
    passes a host int pointer in that place, so the wrapper counts what the
    entry point measured."""
    assert mod._SIGNATURES[name][-2:] == [build.IP, build.P]
    src = "".join((build.CSRC / f"{lib}.cu").read_text() for lib in build.SOURCES)
    head = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert head is not None, name
    params = [" ".join(a.split()) for a in head.group(1).split(",")]
    assert params[-2:] == ["int* launches", "void* stream_ptr"]
    body = src[head.end():src.index("\n}\n", head.end())]
    assert "launches" in body.replace("int* launches", "")
