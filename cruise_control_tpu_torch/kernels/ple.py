"""K12 ``preferred_leader``: the preferred-leader election pass.

Replaces ``cruise_control_tpu/analyzer/goals/leader_election.py``
``PreferredLeaderElectionGoal._preferred_leader`` (:36), ``_current_leader``
(:69), ``violated`` (:27) and ``apply`` (:77) (``optimizer.py``
``_compiled_ple`` :287). Per partition, over its F members (-1 padded):

- eligible: the member exists, its broker is alive and not excluded for
  leadership, and the replica is online; demoted: its broker is demoted;
- the preferred leader: with no demoted broker in the cluster, the
  position-0 member when it is eligible and not demoted; while a demotion is
  in progress, the first eligible member after the demoted ones are sorted
  last (``argmin`` of ``f + F * demoted``, 2F + 1 where not eligible), only
  for partitions that host a demoted member; -1 for no change;
- the current leader: the first member flagged leader, -1 when none;
- violated: the partition has a member and a preferred leader other than
  its current one; ``apply`` flips the partitions whose current leader
  exists and differs from the preferred one (``replica_is_leader`` and
  ``leadership_moved`` at both rows).

``preferred_leader`` counts the violating partitions and, with
``apply=True``, flips them (on copies of ``replica_is_leader`` and
``leadership_moved``); the caller then runs ``state.refresh`` (K5).

CUDA kernel (``csrc/preferred_leader.cu``): one thread per partition; a
partition's members are distinct replicas, so no two threads write one row
and no atomics touch the flags; the violation count is one integer atomic
per block. ``demotion_in_progress`` is reduced over B by each block into
shared memory first. Bound: bytes (F gathers per partition).
"""
from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch.kernels.build import (
    IP, I, P, check, library, ptr, register, stream_ptr,
)

KERNEL = register("preferred_leader",
                  "cruise_control_tpu_torch/kernels/csrc/preferred_leader.cu",
                  "cruise_control_tpu/analyzer/goals/leader_election.py:36")
MAX_F = 32


def preferred_leader_plain(members, rb, rlead, roff, alive, excl, demoted):
    """(pref i64[P], cur i64[P]): the reference's ``_preferred_leader`` and
    ``_current_leader``."""
    Pn, F = members.shape
    m = torch.clamp(members, min=0)
    b = rb[m]
    valid = members >= 0
    eligible = valid & alive[b] & ~excl[b] & ~roff[m]
    dem = valid & demoted[b]
    pos = torch.arange(F, device=members.device)[None, :].expand(Pn, F)
    order = torch.where(eligible, pos + torch.where(dem, F, 0), 2 * F + 1)
    first = torch.argmin(order, dim=1)
    rows = torch.arange(Pn, device=members.device)
    none = torch.full((Pn,), -1, dtype=m.dtype, device=m.device)
    pref_demo = torch.where(eligible.any(dim=1) & dem.any(dim=1), m[rows, first], none)
    pref_pos0 = torch.where(eligible[:, 0] & ~dem[:, 0], m[:, 0], none)
    pref = torch.where(demoted.any(), pref_demo, pref_pos0)
    is_lead = valid & rlead[m]
    pos_l = torch.argmax(is_lead.to(torch.int8), dim=1)
    cur = torch.where(is_lead.any(dim=1), members[rows, pos_l], none)
    return pref, cur


def preferred_leader_apply_plain(members, rb, rlead, roff, alive, excl, demoted,
                                 moved, apply: bool):
    pref, cur = preferred_leader_plain(members, rb, rlead, roff, alive, excl, demoted)
    has = (members >= 0).any(dim=1)
    n = (has & (pref >= 0) & (pref != cur)).sum().to(torch.int32)
    if not apply:
        return rlead, moved, n
    do = (pref >= 0) & (cur >= 0) & (pref != cur)
    R = rlead.shape[0]
    cur_idx = torch.where(do, cur, R)
    pref_idx = torch.where(do, pref, R)
    lead = torch.cat([rlead, rlead[:1]])
    mv = torch.cat([moved, moved[:1]])
    lead[cur_idx] = False
    lead[pref_idx] = True
    mv[cur_idx] = True
    mv[pref_idx] = True
    return lead[:R], mv[:R], n


_SIGNATURES = {"cc_preferred_leader": [I] * 5 + [P] * 10 + [IP, P]}


def preferred_leader(members, rb, rlead, roff, alive, excl, demoted, moved,
                     apply: bool):
    """(replica_is_leader, leadership_moved, n_violated i32 scalar): the
    count of partitions violating the preferred-leader rule and, with
    ``apply``, the flags after the flips (copies; the inputs are not
    modified). ``members`` i64[P, F], ``rb`` i64[R], ``rlead`` / ``roff`` /
    ``moved`` bool[R], ``alive`` / ``excl`` / ``demoted`` bool[B]."""
    if not members.is_cuda:
        return preferred_leader_apply_plain(members, rb, rlead, roff, alive, excl,
                                            demoted, moved, apply)
    Pn, F = members.shape
    B, R = alive.shape[0], rb.shape[0]
    if not (0 < Pn and 0 < F <= MAX_F):
        raise ValueError(f"preferred_leader: unsupported P={Pn} F={F}")
    tensors = [members, rb, rlead, roff, alive, excl, demoted, moved]
    dts = [torch.int64, torch.int64] + [torch.bool] * 6
    for t, dt in zip(tensors, dts):
        if t.dtype != dt or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("preferred_leader: wrong dtype, layout or device")
    lead, mv = (rlead.clone(), moved.clone()) if apply else (rlead, moved)
    n = torch.zeros((), dtype=torch.int32, device=members.device)
    launches = ctypes.c_int(0)
    err = library("preferred_leader", _SIGNATURES).cc_preferred_leader(
        Pn, F, B, R, int(apply), ptr(members), ptr(rb), ptr(roff), ptr(alive),
        ptr(excl), ptr(demoted), ptr(rlead), ptr(lead), ptr(mv), ptr(n),
        ctypes.byref(launches), stream_ptr())
    check(err, "preferred_leader")
    KERNEL.count(f"P={Pn} F={F} {'apply' if apply else 'check'}", launches.value)
    return lead, mv, n
