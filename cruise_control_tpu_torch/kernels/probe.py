"""K13 ``seeded_probe``: would any seed-mask row rank eligible?

Replaces the reduction of ``cruise_control_tpu/analyzer/goals/base.py``
``seeded_work_probe`` (:268), which ``engine.py`` ``_compiled_goal_probe``
(:2298) runs for the chain short-circuit of a reduced round: any over r of
``mask[r] & (key_j[r] > -inf)`` for the one to three key arrays the goal
ranks with (replica, leader, swap-out).

CUDA kernel (``csrc/seeded_probe.cu``): a grid-stride loop, a warp vote and
one integer ``atomicOr`` per block into a zeroed i32 flag (OR is
order-free: deterministic). Bound: bytes.
"""
from __future__ import annotations

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stream_ptr,
)

KERNEL = register("seeded_probe",
                  "cruise_control_tpu_torch/kernels/csrc/seeded_probe.cu",
                  "cruise_control_tpu/analyzer/goals/base.py:268")

_SIGNATURES = {"cc_seeded_probe": [P, P, P, P, I, P, P]}


def seeded_probe_plain(mask: torch.Tensor, keys) -> torch.Tensor:
    out = torch.zeros((), dtype=torch.bool, device=mask.device)
    for k in keys:
        out = out | (torch.where(mask, k, torch.full_like(k, -torch.inf)) > -torch.inf).any()
    return out


def seeded_probe(mask: torch.Tensor, keys) -> torch.Tensor:
    """bool 0-d: does any row of ``mask`` bool[R] hold a key above -inf in
    any of ``keys`` (one to three f32[R])?"""
    keys = list(keys)
    if not mask.is_cuda:
        return seeded_probe_plain(mask, keys)
    R = mask.shape[0]
    if not 1 <= len(keys) <= 3:
        raise ValueError("seeded_probe takes one to three key arrays")
    for t, dt in [(mask, torch.bool)] + [(k, torch.float32) for k in keys]:
        if (t.dtype != dt or tuple(t.shape) != (R,) or not t.is_contiguous()
                or not t.is_cuda):
            raise ValueError("seeded_probe: wrong dtype, shape, layout or device")
    flag = torch.zeros(1, dtype=torch.int32, device=mask.device)
    k0, k1, k2 = keys + [None] * (3 - len(keys))
    err = library("seeded_probe", _SIGNATURES).cc_seeded_probe(
        ptr(mask), ptr(k0), ptr(k1), ptr(k2), R, ptr(flag), stream_ptr())
    check(err, "seeded_probe")
    KERNEL.count(f"R={R} keys={len(keys)}")
    return flag[0] != 0
