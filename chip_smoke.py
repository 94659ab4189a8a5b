#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``cruise_control_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing its own lines; any failure exits non-zero:

1. device: requires CUDA, prints ``nvidia-smi`` name and power limit;
2. build: compiles every hand-written kernel from
   ``cruise_control_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, all
   started together) and prints the build seconds;
3. kernel checks: every kernel against its plain PyTorch twin on the card,
   at the slice's shapes, on inputs taken from the slice cluster's state and
   on adversarial inputs made from ``--seed`` (planted ties, -inf rows,
   signed zeros). Ints, indices and bools must match exactly; floats must
   match bit for bit (stated tolerance 0 for every kernel). Each kernel,
   its twin and the nearest single PyTorch call are timed with CUDA events
   (median of 20);
4. small parity: the 32-broker spec of the tier-1 parity test runs on the
   card and on the CPU (plain twins) and must give the same bits and the
   JAX reference's outcome counts;
5. slice: the move-branch chain on the 1,000-broker / 98,326-replica
   ``generate_scale`` cluster, run twice through ``GoalOptimizer``. The
   kernel launch counts are zeroed just before the first run and read just
   after it; every kernel must have launched. The runs must be bit
   identical, violate {RackAwareGoal, ReplicaDistributionGoal} before and
   nothing after, keep refresh-consistent tallies, and leave no partition
   with two replicas on one broker. ``--profile`` adds a third run under
   ``torch.profiler`` and prints device time by kernel.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "ReplicaDistributionGoal"]
SLICE_SPEC = dict(num_brokers=1000, num_racks=20, num_topics=200,
                  num_partitions=50000, max_replication=3, skew=1.5, seed=3141,
                  target_cpu_util=0.45)
SMALL_SPEC = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
                  max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
# Outcomes of the JAX reference (JAX_PLATFORMS=cpu) on these specs; the
# tier-1 test tests/test_torch_slice.py holds the port to the live reference.
ORACLE = {
    "slice": dict(before={"RackAwareGoal", "ReplicaDistributionGoal"},
                  actions=[3051, 0, 0, 0, 18965], passes=[7, 3, 3, 3, 79],
                  moves=18656, leads=8081),
    "small": dict(before={"RackAwareGoal", "ReplicaDistributionGoal"},
                  actions=[60, 0, 0, 0, 207], passes=[6, 3, 3, 3, 15],
                  moves=245, leads=170),
}
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels do f32 and integer arithmetic only)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
REPS = 20


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median over REPS of the CUDA-event time around one call (warm)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for work moving ``nbytes`` and doing
    ``nops`` f32 / integer operations on one H100."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(torch, got, want) -> float:
    """Max abs error of the float outputs; raises unless every output is
    bit-identical (floats compared as bits, so -0.0 != +0.0)."""
    err = 0.0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.dtype.is_floating_point:
            diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
            if diff.numel():
                err = max(err, float(torch.nan_to_num(diff, nan=float("inf")).max()))
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        require(same, f"output differs from the plain twin (max abs err {err})")
    return err


class Entry:
    def __init__(self, name):
        self.name = name
        self.checks = 0
        self.max_abs_err = 0.0
        self.timing = None


def check(torch, entry: Entry, kernel_fn, plain_fn, what: str) -> None:
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = compare(torch, got, want)
    entry.checks += 1
    entry.max_abs_err = max(entry.max_abs_err, err)
    log(f"  {entry.name} {what}: bit-identical")


def timing(torch, entry: Entry, kernel_fn, plain_fn, library_fn, nb, nops,
           shape: str) -> None:
    ms = time_ms(torch, kernel_fn)
    plain_ms = time_ms(torch, plain_fn)
    lib_ms = time_ms(torch, library_fn) if library_fn is not None else None
    b_ms, by = bound(nb, nops)
    entry.timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=by)
    log(f"  {entry.name} time at {shape}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
        f"library {'-' if lib_ms is None else f'{lib_ms:.6f} ms'}, "
        f"bound {b_ms:.6f} ms ({by})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------
def kernel_checks(torch, ctx, seed: int) -> dict:
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.state import (
        apply_sum_inputs, refresh_sum_inputs,
    )
    from cruise_control_tpu_torch.kernels import admission, move_score, segment, select

    env, st, goals, params = ctx["env"], ctx["st"], ctx["goals"], ctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed)
    R, B = env.num_replicas, env.num_brokers
    Kc = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(Kc, 1)))
    k_all = min(Kc * W, R)
    T = min(params.num_dst_choices, B)
    entries = {n: Entry(n) for n in K.KERNELS}
    log(f"kernel checks: R={R} B={B} K={Kc} K*W={k_all} T={T} seed={seed}")

    # --- K1 select_candidates -------------------------------------------
    e = entries["select_candidates"]
    keys = {}
    for goal in (goals[0], goals[4]):
        sev = goal.broker_severity(env, st)
        keys[goal.name] = goal.replica_key(env, st, sev).contiguous()
    adv = torch.randn(R, generator=g)
    adv[::7] = -torch.inf
    adv[::11] = 0.5
    adv[5::13] = -0.0
    adv[6::13] = 0.0
    adv[1::17] = 6e11
    keys["adversarial"] = adv.to(dev)
    for name, key in keys.items():
        for stall in (0, 3):
            for exact in (True, False):
                check(torch, e,
                      lambda: K.select_candidates(key, k_all, stall, 0, exact),
                      lambda: select.select_candidates_plain(key, k_all, stall, 0, exact),
                      f"{name} stall={stall} exact={exact}")
    key = keys["ReplicaDistributionGoal"]
    timing(torch, e, lambda: K.select_candidates(key, k_all, 0, 0, False),
           lambda: select.select_candidates_plain(key, k_all, 0, 0, False),
           lambda: torch.topk(key, k_all),
           nbytes(key) + k_all * (4 + 8), 4 * R, f"R={R} k={k_all}")

    # candidates of the two goals with work, as the first wave sees them
    cands = {}
    for goal in (goals[0], goals[4]):
        kv, cand = K.select_candidates(keys[goal.name], k_all, 0, 0, goal.is_hard)
        cands[goal.name] = (cand[:Kc].contiguous(), kv[:Kc].contiguous())

    # --- K2 move_score_classes --------------------------------------------
    e = entries["move_score_classes"]
    score_args = {}
    for i, goal in enumerate(goals):
        prev = tuple(goals[:i])
        cand, kv = cands["RackAwareGoal" if i == 0 else "ReplicaDistributionGoal"]
        rooms, rack_veto = engine._combined_move_rooms(prev, env, st)
        d_rows = engine._move_delta_rows(env, st, cand)
        args = engine._score_args(env, st, goal, rooms, rack_veto, cand, kv, d_rows, T)
        score_args[goal.name] = args
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"{goal.name} active, {len(prev)} previous goals")
    # adversarial: random rows, planted score ties, -inf rows, every family
    F = 4
    Kr = env.num_racks
    base = dict(
        cur_b=torch.randint(0, B, (Kc,), generator=g),
        orig_b=torch.randint(0, B, (Kc,), generator=g),
        sib_b=torch.randint(-1, B, (Kc, F), generator=g),
        row_ok=torch.rand(Kc, generator=g) > 0.1,
        d_rows=torch.randint(0, 3, (Kc, 8), generator=g).float(),
        dst_room=torch.randint(-1, 4, (8, B), generator=g).float(),
        prow=torch.randint(0, 2, (Kc, Kr), generator=g),
        row_f=torch.randint(0, 3, (Kc, 4), generator=g).float(),
        col_f=torch.rand((4, B), generator=g),
        dst_ok=torch.rand(B, generator=g) > 0.05,
        new_ok=torch.ones(B, dtype=torch.bool),
        broker_rack=torch.arange(B) % Kr,
    )
    base["col_f"][0] = torch.randint(80, 120, (B,), generator=g).float()
    for kind in range(4):
        a = {n: t.clone() for n, t in base.items()}
        if kind == move_score.GOAL_REPLICA_CAPACITY:
            a["col_f"][1] = 1.0                      # every destination ties
        if kind == move_score.GOAL_REPLICA_DIST:
            a["row_f"] = torch.stack([
                torch.randint(90, 110, (Kc,), generator=g).float(),
                torch.full((Kc,), 95.0), torch.full((Kc,), 105.0),
                (torch.rand(Kc, generator=g) > 0.95).float()], 1)
            a["col_f"] = torch.stack([
                torch.randint(90, 110, (B,), generator=g).float(),
                torch.full((B,), 95.0), torch.full((B,), 105.0),
                torch.rand(B, generator=g) + 1], 0)
        a = {n: t.to(dev).contiguous() for n, t in a.items()}
        args = (kind, T, a["cur_b"], a["orig_b"], a["sib_b"], a["row_ok"],
                a["d_rows"], a["dst_room"], 0b10010, a["prow"], True, a["row_f"],
                a["col_f"], a["dst_ok"], a["new_ok"], a["broker_rack"])
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"adversarial family {kind}")
    args = score_args["ReplicaDistributionGoal"]
    rooms_used = bin(args[8]).count("1")
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(t for t in args if isinstance(t, torch.Tensor)))
           + Kc * T * (4 + 8),
           Kc * B * (2 * rooms_used + 12), f"K={Kc} B={B} T={T}")

    # --- K3 wave_admission ------------------------------------------------
    e = entries["wave_admission"]
    adm = {}
    for i, goal in ((0, goals[0]), (4, goals[4])):
        cand, kv = cands[goal.name]
        r_sorted, dst_s, args = engine._admission_args(
            env, st, goal, tuple(goals[:i]), params, cand, kv)
        adm[goal.name] = (r_sorted, dst_s, args)
        check(torch, e, lambda: K.wave_admission(*args),
              lambda: admission.wave_admission_plain(*args),
              f"{goal.name} first wave")
    d = torch.rand((Kc, 8), generator=g) * 100
    d[::9] = 0.0
    src_b = torch.randint(0, max(2, B // 16), (Kc,), generator=g)   # crowded groups
    dst_b = torch.randint(0, max(2, B // 4), (Kc,), generator=g)
    wave_ok = torch.rand(Kc, generator=g) > 0.2
    part = torch.randint(0, 1500, (Kc,), generator=g)
    ss = torch.rand((B, 8), generator=g) * 2000
    ds = torch.rand((B, 8), generator=g) * 2000
    ss[:, 5] = torch.inf
    sg = (torch.rand(B, generator=g) * 500).to(dev)
    dg = (torch.rand(B, generator=g) * 500).to(dev)
    esc = (torch.rand(Kc, generator=g) > 0.97).to(dev)
    base = [t.to(dev) for t in (d, src_b, dst_b, wave_ok, part, ss, ds)]
    for gain in (None, (sg, dg, 2)):
        args = (*base, gain, esc)
        check(torch, e, lambda: K.wave_admission(*args),
              lambda: admission.wave_admission_plain(*args),
              f"adversarial gain={'none' if gain is None else 'dim 2'}")
    args = adm["ReplicaDistributionGoal"][2]
    timing(torch, e, lambda: K.wave_admission(*args),
           lambda: admission.wave_admission_plain(*args), None,
           nbytes(*args[:7], *args[7][:2], args[8]) + Kc,
           Kc * 8 * 6, f"K={Kc}")

    # --- K4/K5 segment_sum ------------------------------------------------
    e = entries["segment_sum"]
    vals_r, seg_r = refresh_sum_inputs(env, st)
    check(torch, e, lambda: K.segment_sum(vals_r, seg_r, B),
          lambda: segment.segment_sum_plain(vals_r, seg_r, B), f"refresh R={R}")
    r_sorted, dst_s, args = adm["ReplicaDistributionGoal"]
    win = K.wave_admission(*args)
    vals_a, seg_a, init_a = apply_sum_inputs(env, st, r_sorted, dst_s, win)
    check(torch, e, lambda: K.segment_sum(vals_a, seg_a, B, init_a),
          lambda: segment.segment_sum_plain(vals_a, seg_a, B, init_a),
          f"apply wave of {int(win.sum())} moves")
    av = (torch.randn((3 * Kc, 17), generator=g) * 1000).to(dev)
    aseg = torch.randint(-1, 8, (3 * Kc,), generator=g).to(dev)  # long segments
    ainit = (torch.randn((B, 17), generator=g) * 1e5).to(dev)
    check(torch, e, lambda: K.segment_sum(av, aseg, B, ainit),
          lambda: segment.segment_sum_plain(av, aseg, B, ainit),
          "adversarial long segments")
    lib_seg = torch.where(seg_a >= 0, seg_a, torch.full_like(seg_a, B))
    lib_init = torch.cat([init_a, torch.zeros_like(init_a[:1])])
    timing(torch, e, lambda: K.segment_sum(vals_a, seg_a, B, init_a),
           lambda: segment.segment_sum_plain(vals_a, seg_a, B, init_a),
           lambda: torch.index_add(lib_init, 0, lib_seg, vals_a),
           nbytes(vals_a, seg_a, init_a) + B * vals_a.shape[1] * 4,
           vals_a.numel(), f"apply N={vals_a.shape[0]} C={vals_a.shape[1]} nseg={B}")
    e.refresh_ms = time_ms(torch, lambda: K.segment_sum(vals_r, seg_r, B))
    log(f"  segment_sum time at refresh N={R} C={vals_r.shape[1]} nseg={B}: "
        f"kernel {e.refresh_ms:.6f} ms")

    # --- K4/K5 segment_count ----------------------------------------------
    e = entries["segment_count"]
    rack = goals[0]
    viol = (rack._violating(env, st) | (st.replica_offline & env.replica_valid)).to(torch.int32)
    rb = st.replica_broker
    check(torch, e, lambda: K.segment_count(rb, B, viol),
          lambda: segment.segment_count_plain(rb, B, viol), f"rack severity R={R}")
    flat = env.replica_partition * env.num_racks + env.broker_rack[rb]
    vw = env.replica_valid.to(torch.int32)
    nseg = env.num_partitions * env.num_racks
    check(torch, e, lambda: K.segment_count(flat, nseg, vw),
          lambda: segment.segment_count_plain(flat, nseg, vw), "refresh partition x rack")
    zeros_b = torch.zeros(B, dtype=torch.int32, device=dev)
    timing(torch, e, lambda: K.segment_count(rb, B, viol),
           lambda: segment.segment_count_plain(rb, B, viol),
           lambda: torch.index_add(zeros_b, 0, rb, viol),
           nbytes(rb, viol) + B * 4, R, f"N={R} nseg={B}")
    for en in entries.values():
        require(en.checks > 0 and en.timing is not None, f"{en.name} was not checked")
    return entries


# ---------------------------------------------------------------------------
# phases 4 and 5: the optimizer
# ---------------------------------------------------------------------------
def run_chain(opt, ct, meta):
    return opt.optimizations(ct, meta, goal_names=GOALS, skip_hard_goal_check=True,
                             raise_on_failure=False)


def outcome(res) -> dict:
    return dict(before=set(res.violated_goals_before),
                after=set(res.violated_goals_after),
                actions=[g.iterations for g in res.goal_results],
                passes=[g.passes for g in res.goal_results],
                moves=res.num_replica_movements,
                leads=res.num_leadership_movements)


def print_outcome(tag: str, out: dict, oracle: dict) -> None:
    log(f"{tag}: violated before {sorted(out['before'])} after {sorted(out['after'])}")
    log(f"{tag}: per-goal actions {out['actions']} (JAX reference {oracle['actions']})")
    log(f"{tag}: per-goal passes  {out['passes']} (JAX reference {oracle['passes']})")
    log(f"{tag}: replica movements {out['moves']} (JAX reference {oracle['moves']}), "
        f"leadership movements {out['leads']} (JAX reference {oracle['leads']})")


def same_bits(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in (
        (a.replica_broker, b.replica_broker), (a.replica_is_leader, b.replica_is_leader),
        (a.util.view(torch.int32), b.util.view(torch.int32)),
        (a.replica_count, b.replica_count)))


def small_parity(torch) -> None:
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    ct, meta = generate_scale(RandomClusterSpec(**SMALL_SPEC))
    on_card = run_chain(GoalOptimizer(device="cuda"), ct, meta)
    on_cpu = run_chain(GoalOptimizer(device="cpu"), ct, meta)
    out = outcome(on_card)
    print_outcome("small (32 brokers)", out, ORACLE["small"])
    require(outcome(on_cpu) == out, "small spec: card and CPU outcomes differ")
    a, b = on_card.final_state, on_cpu.final_state
    require(torch.equal(a.replica_broker.cpu(), b.replica_broker)
            and torch.equal(a.replica_is_leader.cpu(), b.replica_is_leader)
            and torch.equal(a.util.cpu().view(torch.int32), b.util.view(torch.int32)),
            "small spec: card and CPU final states differ")
    for key in ("before", "actions", "passes", "moves", "leads"):
        require(out[key] == ORACLE["small"][key],
                f"small spec: {key} {out[key]} != JAX reference {ORACLE['small'][key]}")
    require(not out["after"], "small spec: goals still violated")
    log("small (32 brokers): card == CPU bit for bit, == JAX reference counts")


def slice_checks(torch, res) -> None:
    from cruise_control_tpu_torch.analyzer.state import refresh
    env, st = res.env, res.final_state
    ref = refresh(env, st)
    for name in ("replica_count", "leader_count", "part_rack_count",
                 "topic_broker_count", "topic_leader_count"):
        require(torch.equal(getattr(st, name), getattr(ref, name)),
                f"refresh(final).{name} != incremental")
    worst = 0.0
    for name in ("util", "leader_util", "potential_nw_out", "disk_util"):
        got, want = getattr(st, name), getattr(ref, name)
        rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        worst = max(worst, rel)
        require(rel <= 1e-3, f"refresh(final).{name} off by {rel} relative")
    members = env.partition_replicas
    brokers = torch.where(members >= 0, st.replica_broker[members.clamp(min=0)],
                          -1 - torch.arange(members.shape[1], device=members.device))
    srt = brokers.sort(dim=1).values
    require(not bool((srt[:, 1:] == srt[:, :-1]).any()),
            "a partition has two replicas on one broker")
    log(f"slice: refresh(final) tallies == incremental; util max rel err {worst:.3e}; "
        f"no partition has two replicas on one broker")


def profile_run(torch, opt, ct, meta) -> None:
    """One more slice run under torch.profiler: device busy share of the
    wall and device time by kernel (device-side events only, so an op's
    kernels are not counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chain(opt, ct, meta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    ours = [r for r in rows if any(n in r[2] for n in
                                   ("select_candidates", "salt_pack", "radix_",
                                    "gather_top", "bitonic_top", "init_state",
                                    "move_score_kernel", "wave_admission_kernel",
                                    "segment_sum_kernel", "segment_count_kernel"))]
    own = sum(r[0] for r in ours) / 1e6
    launches = sum(r[1] for r in rows)
    log(f"profile: wall {wall:.6f} s under the profiler, device busy {busy:.6f} s "
        f"({100 * busy / wall:.2f}% of wall), {launches} device events; "
        f"hand kernels {own:.6f} s ({100 * own / max(busy, 1e-12):.2f}% of busy)")
    for dev_us, count, key in rows[:25]:
        log(f"profile:   {dev_us / 1e3:12.3f} ms  {count:7d}x  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the adversarial kernel-check inputs")
    ap.add_argument("--profile", action="store_true",
                    help="add a third slice run under torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the cruise_control_tpu_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build
    from cruise_control_tpu_torch import kernels as K
    info = K.build_all()
    log(f"build: {info['seconds']:.3f} s for {len(info['built'])} libraries "
        f"({', '.join(info['built']) or 'already built'})")
    for name, text in info["log"].items():
        for line in text.splitlines():
            if "Compiling entry function" in line or "Used" in line:
                log(f"  {name}: {line.strip()}")

    # the slice cluster (host) and its state on the card
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    t0 = time.perf_counter()
    ct, meta = generate_scale(RandomClusterSpec(**SLICE_SPEC))
    log(f"slice cluster: {meta.num_valid_replicas} replicas generated in "
        f"{time.perf_counter() - t0:.3f} s")
    opt = GoalOptimizer(device="cuda")
    pct, pmeta = pad_cluster(ct, meta)
    params = opt.scaled_params(pct.num_replicas, pct.num_brokers)
    env = make_env(pct, pmeta, device="cuda")
    st = init_state(env, pct.replica_broker, pct.replica_is_leader,
                    pct.replica_offline, pct.replica_disk)
    ctx = dict(env=env, st=st, goals=make_goals(GOALS), params=params)

    # 3. kernels against their twins
    entries = kernel_checks(torch, ctx, args.seed)

    # 4. small parity against the CPU run and the JAX reference's counts
    small_parity(torch)

    # 5. the slice: main path, counted
    K.reset_launches()
    t0 = time.perf_counter()
    res1 = run_chain(opt, ct, meta)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = K.launches()
    t0 = time.perf_counter()
    res2 = run_chain(opt, ct, meta)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    log(f"slice: R={pct.num_replicas} B={pct.num_brokers} K={params.num_candidates} "
        f"T={params.num_dst_choices} pass_waves={params.pass_waves} "
        f"compute_dtype={params.compute_dtype}")
    log(f"slice: run 1 wall {wall1:.6f} s, run 2 wall {wall2:.6f} s")
    log(f"slice: kernel launches in run 1 {launches}")
    out = outcome(res1)
    print_outcome("slice", out, ORACLE["slice"])
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(out["before"] == ORACLE["slice"]["before"],
            f"violated before {out['before']}")
    require(not out["after"], f"violated after {out['after']}")
    require(same_bits(torch, res1.final_state, res2.final_state)
            and outcome(res2) == out, "the two slice runs differ")
    log("slice: run 1 and run 2 bit-identical (assignment, leadership, util, counts)")
    slice_checks(torch, res1)
    if args.profile:
        profile_run(torch, opt, ct, meta)

    kernels = []
    for name, k in K.KERNELS.items():
        e = entries[name]
        kernels.append(dict(name=name, route="cuda", source=k.source,
                            replaces=k.replaces, launches=launches[name],
                            max_abs_err=e.max_abs_err, **e.timing))
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
