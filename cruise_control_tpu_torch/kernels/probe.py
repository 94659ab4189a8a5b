"""K13 ``seeded_probe``: would any seed-mask row rank eligible?

Replaces the reduction of ``cruise_control_tpu/analyzer/goals/base.py``
``seeded_work_probe`` (:268), which ``engine.py`` ``_compiled_goal_probe``
(:2298) runs for the chain short-circuit of a reduced round: any over r of
``mask[r] & (key_j[r] > -inf)`` for the one to three key arrays the goal
ranks with (replica, leader, swap-out).

``seeded_probe_lanes`` is the fleet's lane form (K14, ``engine.py``
``_compiled_fleet_probe`` :2377): La lanes' masks and keys stacked [La, R],
every lane answered in ONE launch (grid dimension y = lane). Its twin loops
the solo twin over the lanes. ``seeded_probe`` is the same launch with one
lane.

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
KERNEL_LANES = register("seeded_probe_lanes",
                        "cruise_control_tpu_torch/kernels/csrc/seeded_probe.cu",
                        "cruise_control_tpu/analyzer/engine.py:2377")

_SIGNATURES = {"cc_seeded_probe_lanes": [I, P, P, P, P, I, P, P]}


def seeded_probe_plain(mask: torch.Tensor, keys) -> torch.Tensor:
    out = torch.zeros((), dtype=torch.bool, device=mask.device)
    for k in keys:
        out = out | (torch.where(mask, k, torch.full_like(k, -torch.inf)) > -torch.inf).any()
    return out


def _launch(masks: torch.Tensor, keys: list, what: str) -> torch.Tensor:
    """The one launch behind both wrappers: ``masks`` bool[R] (one lane) or
    [La, R], each key of the same shape. Returns i32 flags, one per lane."""
    La, R = (1, masks.shape[0]) if masks.dim() == 1 else masks.shape
    if not 1 <= len(keys) <= 3:
        raise ValueError(f"{what} takes one to three key arrays")
    for t, dt in [(masks, torch.bool)] + [(k, torch.float32) for k in keys]:
        if (t.dtype != dt or t.shape != masks.shape or not t.is_contiguous()
                or not t.is_cuda):
            raise ValueError(f"{what}: wrong dtype, shape, layout or device")
    flag = torch.zeros(La, dtype=torch.int32, device=masks.device)
    k0, k1, k2 = keys + [None] * (3 - len(keys))
    err = library("seeded_probe", _SIGNATURES).cc_seeded_probe_lanes(
        La, ptr(masks), ptr(k0), ptr(k1), ptr(k2), R, ptr(flag), stream_ptr())
    check(err, what)
    return flag


def seeded_probe(mask: torch.Tensor, keys) -> torch.Tensor:
    """bool 0-d: does any row of ``mask`` bool[R] hold a key above -inf in
    any of ``keys`` (one to three f32[R])? The one-lane launch of
    ``seeded_probe_lanes``' kernel."""
    keys = list(keys)
    if not mask.is_cuda:
        return seeded_probe_plain(mask, keys)
    flag = _launch(mask, keys, "seeded_probe")
    KERNEL.count(f"R={mask.shape[0]} keys={len(keys)}")
    return flag[0] != 0


def seeded_probe_lanes_plain(masks: torch.Tensor, keys) -> torch.Tensor:
    return torch.stack([seeded_probe_plain(masks[i], [k[i] for k in keys])
                        for i in range(masks.shape[0])])


def seeded_probe_lanes(masks: torch.Tensor, keys) -> torch.Tensor:
    """bool[La]: ``seeded_probe`` of each lane's mask (``masks`` bool[La, R])
    against its keys (``keys``: one to three f32[La, R]) in one launch."""
    keys = list(keys)
    if not masks.is_cuda:
        return seeded_probe_lanes_plain(masks, keys)
    if masks.dim() != 2:
        raise ValueError("seeded_probe_lanes: the masks are [La, R]")
    flag = _launch(masks, keys, "seeded_probe_lanes")
    La, R = masks.shape
    KERNEL_LANES.count(f"L={La} R={R} keys={len(keys)}")
    return flag != 0
