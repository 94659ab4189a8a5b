"""Two trees' K4/K5 ``segment_sum`` and K1 selections timed against each other.

    python3 cruise_control_tpu_torch/kernel_ab.py PARENT_TREE CHANGE_TREE \
        [--order ABBA] [--out kernel_ab.json]

Each run is a fresh interpreter that imports ``cruise_control_tpu_torch``
from its tree (``A`` the first tree, ``B`` the second, in ``--order``, by
default parent, change, change, parent), builds that tree's two libraries
(not timed) and calls its wrappers on the card at the main path's shapes,
on inputs made from one numpy seed: ``segment_sum`` at the move, residual,
leadership, swap-leg, logdir and lane applies and at refresh's shapes
(114,688 and 1,048,576 rows, the padding rows in segment 0 as the padded
cluster puts them), and every form of K1 (solo at R 114,688 and 1,048,576
over k 32 to 16,384, with a seed mask, in lanes at L 16, pooled solo and in
lanes). For each shape it prints the CUDA-event window of one call (median
of 20, warm), one call's device time (20 calls queued behind a sleep kernel
run back to back, the window over 20), its CUDA launches where the tree's
wrappers report them, ``torch.topk`` / ``index_add`` beside it, and a digest
of the outputs: the two trees must give the same bits. The card's ``name,
power.limit`` leads the output; ``--out`` keeps every line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

_CHILD = r"""
import hashlib, json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from cruise_control_tpu_torch import kernels as K
from cruise_control_tpu_torch.kernels.build import build_all
assert torch.cuda.is_available(), "no card"
build_all(("segment_sum", "select_candidates"))
rng = np.random.default_rng(14)


def event_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device(fn, reps=20):
    # reps calls queued behind a sleep kernel run back to back: the window
    # over reps is one call's device time, no host gap in it
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s.elapsed_time(a) > host_ms or cycles >= 1 << 30:
            return a.elapsed_time(b) / reps
        cycles *= 4


def cuda_launches(fn):
    # the CUDA launches of one call, where the tree's wrappers report them
    K.reset_launches()
    fn()
    n = max(getattr(k, "cuda_launches", 0) for k in K.KERNELS.values())
    return n or None


def digest(out):
    out = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def seg_case(N, C, nseg, pad=0, masked=0.0, init=False):
    # skewed segments (a few large), masked rows at -1, the padding rows
    # (zero values) in segment 0 at the end
    seg = (nseg * rng.random(N) ** 1.5).astype(np.int64)
    seg[rng.random(N) < masked] = -1
    vals = (rng.standard_normal((N, C)) * 100).astype(np.float32)
    if pad:
        seg[N - pad:] = 0
        vals[N - pad:] = 0.0
    ini = cuda((rng.standard_normal((nseg, C)) * 1e4).astype(np.float32)) if init else None
    v, s = cuda(vals), cuda(seg)
    lib_s = torch.where(s >= 0, s, torch.full_like(s, nseg))
    lib_i = torch.zeros((nseg + 1, C), device="cuda") if ini is None else torch.cat(
        [ini, torch.zeros_like(ini[:1])])
    return (lambda: K.segment_sum(v, s, nseg, ini),
            lambda: torch.index_add(lib_i, 0, lib_s, v))


def keys(R, L=None, ninf=1 / 7):
    k = rng.standard_normal(R if L is None else (L, R)).astype(np.float32)
    k[rng.random(k.shape) < ninf] = -np.inf
    return cuda(k)


def pooled_keys(R, share):
    k = rng.random(R).astype(np.float32)
    k[rng.random(R) >= share] = -np.inf
    return cuda(k)


cases = [
    ("segment_sum move apply 3,520 x 9 -> 1,024", *seg_case(3520, 9, 1024, masked=0.5, init=True)),
    ("segment_sum residual 3,520 x 8 -> 1,024", *seg_case(3520, 8, 1024, masked=0.5, init=True)),
    ("segment_sum leadership 256 x 16 -> 1,024", *seg_case(256, 16, 1024, masked=0.5, init=True)),
    ("segment_sum swap leg 64 x 17 -> 1,024", *seg_case(64, 17, 1024, masked=0.5, init=True)),
    ("segment_sum logdir update 3,520 x 1 -> 4,096", *seg_case(3520, 1, 4096, masked=0.5, init=True)),
    ("segment_sum lane apply 5,120 x 9 -> 1,600", *seg_case(5120, 9, 1600, masked=0.5, init=True)),
    ("segment_sum refresh 114,688 x 9 -> 1,024", *seg_case(114688, 9, 1024, pad=16362)),
    ("segment_sum disk tallies 114,688 x 1 -> 4,096", *seg_case(114688, 1, 4096, pad=16362)),
    ("segment_sum refresh 1,048,576 x 9 -> 7,168", *seg_case(1048576, 9, 7168, pad=41947)),
    ("segment_sum logdir 1,048,576 x 1 -> 28,672", *seg_case(1048576, 1, 28672, pad=71023)),
]
R = 114688
key = keys(R)
for k in (7040, 128, 32, 1760, 10560, 16384):
    cases.append((f"select_candidates R 114,688 k {k}",
                  lambda k=k: K.select_candidates(key, k, 0, 0), lambda k=k: torch.topk(key, k)))
cases.append(("select_candidates R 114,688 k 7,040 stall 3",
              lambda: K.select_candidates(key, 7040, 3, 0), lambda: torch.topk(key, 7040)))
mask = cuda(rng.random(R) < 0.3)
mkey = torch.where(mask, key, -torch.inf)
cases.append(("select_candidates seed mask R 114,688 k 7,040",
              lambda: K.select_candidates(key, 7040, 0, 0, seed_mask=mask),
              lambda: torch.topk(mkey, 7040)))
key1m = keys(1048576)
cases.append(("select_candidates R 1,048,576 k 7,040",
              lambda: K.select_candidates(key1m, 7040, 0, 0), lambda: torch.topk(key1m, 7040)))
lkey = keys(10240, L=16)
stalls = [j % 3 for j in range(16)]
for k in (640, 32):
    cases.append((f"select_candidates_lanes L 16 R 10,240 k {k}",
                  lambda k=k: K.select_candidates_lanes(lkey, k, stalls),
                  lambda k=k: torch.topk(lkey, k, dim=1)))
for k, pool in ((7040, 14080), (128, 8192), (32, 8192)):
    pk = pooled_keys(R, 0.01)
    idx = torch.nonzero(pk > -torch.inf).flatten()
    gathered = torch.full((pool,), -torch.inf, device="cuda")
    gathered[:idx.shape[0]] = pk[idx]
    cases.append((f"select_pooled R 114,688 k {k} pool {pool} (1% eligible)",
                  lambda k=k, pool=pool, pk=pk: K.select_pooled(pk, k, 0, 0, pool=pool),
                  lambda k=k, g=gathered: torch.topk(g, k)))
plk = torch.stack([pooled_keys(R, (0.01, 0.10, 0.50)[j % 3]) for j in range(16)]).contiguous()
cases.append(("select_pooled_lanes L 16 R 114,688 k 32 pool 8,192 (shares 1/10/50%)",
              lambda: K.select_pooled_lanes(plk, 32, stalls, 0, None, 8192),
              lambda: torch.topk(plk, 32, dim=1)))
for name, fn, lib in cases:
    print(json.dumps(dict(case=name, ms=event_ms(fn), device_ms=device(fn),
                          cuda_launches=cuda_launches(fn), library_ms=event_ms(lib),
                          library_device_ms=device(lib), digest=digest(fn()))), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree_a", help="the first tree (the parent)")
    ap.add_argument("tree_b", help="the second tree (the change)")
    ap.add_argument("--order", default="ABBA", help="the runs, A or B each")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = [smi.stdout.strip()]
    print(lines[0], flush=True)
    digests: dict = {}
    for tag in args.order:
        tree = args.tree_a if tag == "A" else args.tree_b
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        for line in proc.stdout.strip().splitlines():
            row = json.loads(line)
            row.update(run=tag, tree=tree)
            digests.setdefault(row["case"], set()).add(row["digest"])
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
        print(f"run {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    differ = sorted(c for c, d in digests.items() if len(d) > 1)
    if differ:
        print(f"the trees' outputs differ at: {differ}", file=sys.stderr)
        return 1
    print("every case: the same bits from both trees", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
