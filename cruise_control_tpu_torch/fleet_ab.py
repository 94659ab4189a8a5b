"""Two trees of the port timed against each other on the fleet-16x100b cell.

    python3 cruise_control_tpu_torch/fleet_ab.py PARENT_TREE CHANGE_TREE \
        [--order ABBA] [--out chiprun_out/fleet_ab.json]

Each run is a fresh interpreter that imports ``cruise_control_tpu_torch``
from its tree (``A`` the first tree, ``B`` the second, in ``--order``, by
default parent, change, change, parent), builds that tree's kernels (not
timed), then runs the cell on the card as ``chip_smoke.py`` phase 8 does:
``fleet_script.fleet_e2e`` (round 1, then round 2 after one more window)
and ``solo_e2e`` (the 16 tenants' round 1 one at a time). It prints one JSON
line per run: the host walls of both fleet rounds and of the solo rounds,
their ratio, the launches of every kernel over the two fleet rounds and a
digest of the tenants' rows (the two trees must give the same rows). The
card's ``name, power.limit`` leads the output; ``--out`` keeps every line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

_CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from cruise_control_tpu_torch import kernels as K
from cruise_control_tpu_torch.kernels.build import build_all
from cruise_control_tpu_torch.fleet_script import (
    FLEET_E2E, fleet_e2e, port_fleet_ns, solo_e2e,
)
assert torch.cuda.is_available(), "no card"
build_all()
ns = port_fleet_ns("cuda")
K.reset_launches()
t0 = time.perf_counter()
run = fleet_e2e(ns, FLEET_E2E, rounds=2)
torch.cuda.synchronize()
total = time.perf_counter() - t0
launches = {n: c for n, c in K.launches().items() if c}
run["fleet"].shutdown()
solo = solo_e2e(ns, FLEET_E2E)
rows = json.dumps(run["rounds"], sort_keys=True)
print(json.dumps(dict(
    tree=sys.argv[1], fleet_walls=run["walls"], fleet_total=total,
    solo_sum=sum(solo["walls"]), ratio_round1=run["walls"][0] / sum(solo["walls"]),
    solo_equal=solo["rows"] == run["rounds"][0],
    rows_digest=hashlib.sha256(rows.encode()).hexdigest()[:16], launches=launches)))
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
    digests = set()
    for tag in args.order:
        tree = args.tree_a if tag == "A" else args.tree_b
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _CHILD, tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row.update(run=tag, process_s=time.perf_counter() - t0)
        digests.add(row["rows_digest"])
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    if len(digests) != 1:
        print(f"the trees' rows differ: {sorted(digests)}", file=sys.stderr)
        return 1
    print(json.dumps({"same_rows": True,
                      "digest": hashlib.sha256("".join(digests).encode()).hexdigest()[:16]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
