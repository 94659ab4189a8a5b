"""Library-level optimization validity checks (counterpart of
``cruise_control_tpu/analyzer/verifier.py``, the OptimizationVerifier role).

Reference: analyzer/OptimizationVerifier.java:53. Each check REPORTS: it
returns violation strings (empty = pass) so a caller can fold verdicts into
its own log instead of dying on the first bad proposal.

- ``verify_no_regression``: each goal's own statistic must not worsen during
  its own run (verifyRegression :94-117), and the offline-replica count may
  never grow;
- ``verify_no_dead_placement``: no valid replica ends on a dead broker;
- ``verify_proposals``: per-proposal structure — non-empty replica list, no
  duplicate target brokers, the new leader among the new replicas, every
  added replica on an alive broker, no silent replication-factor change.
"""
from __future__ import annotations

import numpy as np

# operations allowed to change a partition's replication factor on purpose
RF_CHANGING_OPERATIONS = {"TOPIC_REPLICATION_FACTOR"}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def verify_no_regression(res) -> list:
    out = []
    for g in res.goal_results:
        if g.stat_after > g.stat_before * 1.0001 + 1e-6:
            out.append(f"{g.name} regressed its own stat during its run: "
                       f"{g.stat_before:.4f} -> {g.stat_after:.4f}")
    before = res.stats_before.get("num_offline_replicas", 0)
    after = res.stats_after.get("num_offline_replicas", 0)
    if after > before:
        out.append(f"offline replicas increased: {before} -> {after}")
    return out


def verify_no_dead_placement(res) -> list:
    env, st = res.env, res.final_state
    alive = _host(env.broker_alive)
    rb = _host(st.replica_broker)
    valid = _host(env.replica_valid)
    on_dead = valid & ~alive[np.clip(rb, 0, alive.shape[0] - 1)]
    out = []
    if on_dead.any():
        out.append(f"{int(on_dead.sum())} replicas placed on dead brokers")
    return out


def verify_proposals(res, operation: str = "", max_proposals: int = 10_000) -> list:
    """Structural validity of every emitted proposal (the first
    ``max_proposals`` of them)."""
    meta = getattr(res, "meta", None)
    alive_ids = None
    if meta is not None:
        alive = _host(res.env.broker_alive)
        alive_ids = {int(meta.broker_ids[i]) for i in np.flatnonzero(alive)}
    out = []
    for i, p in enumerate(res.proposals):
        if i >= max_proposals:
            out.append(f"verification truncated at {max_proposals} proposals")
            break
        new_b = [b for b, _ in p.new_replicas]
        if not new_b:
            out.append(f"{p.tp}: proposal empties the partition")
            continue
        if len(set(new_b)) != len(new_b):
            out.append(f"{p.tp}: duplicate brokers in new replicas {new_b}")
        if p.new_leader >= 0 and p.new_leader not in new_b:
            # -1 = leaderless (the sole replica sat on a dead broker): the
            # backend elects an alive member when the copy completes
            out.append(f"{p.tp}: new leader {p.new_leader} not in "
                       f"new replicas {new_b}")
        if alive_ids is not None:
            bad = [b for b in p.replicas_to_add if b not in alive_ids]
            if bad:
                out.append(f"{p.tp}: replicas added on dead/unknown "
                           f"brokers {bad}")
        if (len(new_b) != len(p.old_replicas)
                and operation not in RF_CHANGING_OPERATIONS):
            out.append(f"{p.tp}: replication factor changed "
                       f"{len(p.old_replicas)} -> {len(new_b)} by "
                       f"non-RF operation {operation or 'OPTIMIZE'}")
    return out


def verify_operation_result(operation: str, res) -> list:
    """The per-optimization validity pass of a heal: no regression and
    valid proposals (relative, not absolute: a broker inside its failure
    grace period may legitimately keep its replicas, so the absolute
    ``verify_no_dead_placement`` is not part of it)."""
    if res is None:
        return []
    out = []
    out.extend(verify_no_regression(res))
    out.extend(verify_proposals(res, operation))
    return out
