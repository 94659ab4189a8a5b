"""ClusterModelStats analogue (counterpart of
``cruise_control_tpu/model/stats.py``).

Reference: model/ClusterModelStats.java:30-44 computes per-resource
AVG/MAX/MIN/ST_DEV over alive brokers, replica-count stats, leader-count
stats and potential-NW-out stats; goals use them to assert no regression
after an optimization (AbstractGoal.java:110-119). Here one function over
the host ``ClusterTensor`` uploads it to ``device`` and reduces it there:
the broker tallies are the K4/K5 segment sums (row order, the reference's
scatter order), the reductions over brokers plain torch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import segment_count, segment_sum
from cruise_control_tpu_torch.model.cluster_tensor import ClusterTensor


@dataclasses.dataclass(frozen=True)
class ClusterStats:
    avg: torch.Tensor   # f32[M] mean broker utilization over alive brokers
    max: torch.Tensor   # f32[M]
    min: torch.Tensor   # f32[M]
    std: torch.Tensor   # f32[M]
    replica_count_avg: torch.Tensor
    replica_count_max: torch.Tensor
    replica_count_min: torch.Tensor
    replica_count_std: torch.Tensor
    leader_count_avg: torch.Tensor
    leader_count_max: torch.Tensor
    potential_nw_out_avg: torch.Tensor
    potential_nw_out_max: torch.Tensor
    potential_nw_out_std: torch.Tensor
    num_alive_brokers: torch.Tensor
    num_replicas: torch.Tensor
    num_offline_replicas: torch.Tensor


def cluster_stats(ct: ClusterTensor, device="cuda") -> ClusterStats:
    """The stats of ``ct`` computed on ``device`` (``"cuda"`` unless the
    caller asks for the CPU)."""
    from cruise_control_tpu_torch.analyzer.env import resolve_device
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype).contiguous()

    rb = t(ct.replica_broker, torch.int64)
    valid = t(ct.replica_valid, torch.bool)
    lead = t(ct.replica_is_leader, torch.bool)
    leader_load = t(ct.leader_load, torch.float32)
    follower_load = t(ct.follower_load, torch.float32)
    alive = t(ct.broker_alive, torch.bool)
    B = ct.num_brokers
    zero = torch.zeros_like(leader_load)
    eff = torch.where(valid[:, None], torch.where(lead[:, None], leader_load,
                                                  follower_load), zero)
    util = segment_sum(eff.contiguous(), rb, B)                       # [B, M]
    n_alive = torch.clamp(alive.sum(), min=1)
    alive_f = alive.to(torch.float32)

    def stats(x):
        a = alive[:, None] if x.dim() == 2 else alive
        af = alive_f[:, None] if x.dim() == 2 else alive_f
        mean = (x * af).sum(dim=0) / n_alive
        mx = torch.where(a, x, torch.full_like(x, -torch.inf)).max(dim=0).values
        mn = torch.where(a, x, torch.full_like(x, torch.inf)).min(dim=0).values
        var = (((x - mean) ** 2) * af).sum(dim=0) / n_alive
        return mean, mx, mn, torch.sqrt(var)

    mean, mx, mn, std = stats(util)
    counts = segment_count(rb, B, valid.to(torch.int32)).to(torch.float32)
    cmean, cmax, cmin, cstd = stats(counts)
    lcounts = segment_count(rb, B, (valid & lead).to(torch.int32)).to(torch.float32)
    lmean, lmax, _, _ = stats(lcounts)
    pot = segment_sum(torch.where(valid[:, None], leader_load, zero).contiguous(),
                      rb, B)[:, Resource.NW_OUT]
    pmean, pmax, _, pstd = stats(pot)
    return ClusterStats(
        avg=mean, max=mx, min=mn, std=std,
        replica_count_avg=cmean, replica_count_max=cmax, replica_count_min=cmin,
        replica_count_std=cstd, leader_count_avg=lmean, leader_count_max=lmax,
        potential_nw_out_avg=pmean, potential_nw_out_max=pmax, potential_nw_out_std=pstd,
        num_alive_brokers=alive.sum(), num_replicas=valid.sum(),
        num_offline_replicas=(t(ct.replica_offline, torch.bool) & valid).sum())
