"""Intra-broker (JBOD) disk goals (counterpart of
``cruise_control_tpu/analyzer/goals/intra_broker.py``).

Reference: analyzer/goals/IntraBrokerDiskCapacityGoal.java (hard: every
alive logdir under ``capacity * disk-capacity-threshold``; replicas on dead
disks relocate to healthy disks of the same broker) and
IntraBrokerDiskUsageDistributionGoal.java (soft: each logdir's utilization
percentage within the balance band around its broker's average disk
utilization, band = avg +/- (balance% - 1) * BALANCE_MARGIN).

Actions are intra-broker replica movements only: destinations are the D
logdirs of the candidate's own broker, scored by the K8 kernels
(``kernels.disk``) over ``st.disk_util``; broker-level tallies are
untouched, so these goals are transparent to every inter-broker goal.
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import BALANCE_MARGIN, ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import GoalKernel, disk_state, sweep_keys
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.kernels import disk as disk_k
from cruise_control_tpu_torch.kernels.disk import DISK_EPS, PCT_EPS, DiskRule
from cruise_control_tpu_torch.kernels.keys import KEY_INTRA_CAPACITY, KEY_INTRA_USAGE


@dataclasses.dataclass(frozen=True)
class IntraBrokerDiskCapacityGoal(GoalKernel):
    """Hard: no alive logdir above threshold * capacity; nothing on dead
    disks (IntraBrokerDiskCapacityGoal.java)."""

    def __post_init__(self):
        object.__setattr__(self, "name", "IntraBrokerDiskCapacityGoal")
        object.__setattr__(self, "is_hard", True)
        object.__setattr__(self, "uses_replica_moves", False)
        object.__setattr__(self, "uses_disk_moves", True)

    def disk_rule(self) -> DiskRule:
        return DiskRule(disk_k.DISK_CAPACITY,
                        self.constraint.capacity_threshold[Resource.DISK])

    def _limit(self, ds) -> torch.Tensor:
        """f32[B, D]: allowed utilization per logdir; 0 for dead disks."""
        return disk_k.disk_limit(ds, self.disk_rule().a)

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        ds = disk_state(env, st)
        excess = torch.clamp(st.disk_util - self._limit(ds), min=0.0)
        # anything sitting on a dead disk counts fully
        sev = disk_k.row_sum(torch.where(disk_k.disk_valid(ds), excess, st.disk_util))
        return torch.where(env.broker_alive, sev - DISK_EPS, torch.zeros_like(sev))

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        """Replicas on over-limit or dead logdirs of alive brokers by DISK
        load, dead disks first (K1 keying over the logdir rows: the
        utilization, the limit + eps, and 1 where the logdir is dead or
        unconfigured)."""
        ds = disk_state(env, st)
        bad = ~(ds.dalive & (ds.dcap > 0))
        rows = torch.stack([st.disk_util, self._limit(ds) + DISK_EPS,
                            bad.to(torch.float32)])
        return sweep_keys(KEY_INTRA_CAPACITY, env, st, Resource.DISK, [env.broker_alive],
                          disk=(st.replica_disk, rows))


@dataclasses.dataclass(frozen=True)
class IntraBrokerDiskUsageDistributionGoal(GoalKernel):
    """Soft: every logdir's utilization percentage within the balance band
    around its broker's average disk utilization
    (IntraBrokerDiskUsageDistributionGoal.java)."""

    def __post_init__(self):
        object.__setattr__(self, "name", "IntraBrokerDiskUsageDistributionGoal")
        object.__setattr__(self, "uses_replica_moves", False)
        object.__setattr__(self, "uses_disk_moves", True)

    def disk_rule(self) -> DiskRule:
        dev = ((self.constraint.resource_balance_percentage[Resource.DISK] - 1.0)
               * BALANCE_MARGIN)
        return DiskRule(disk_k.DISK_BAND, 1.0 + dev, 1.0 - dev)

    def _band(self, env: ClusterEnv, st: EngineState):
        """(pct[B, D], lower[B], upper[B], valid[B, D])."""
        rule = self.disk_rule()
        return disk_k.disk_band(disk_state(env, st), rule.a, rule.b)

    def _violation(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """f32[B, D] distance outside the band (0 inside)."""
        pct, lower, upper, valid = self._band(env, st)
        out = disk_k.band_violation(pct, upper[:, None], lower[:, None])
        return torch.where(valid, out, torch.zeros_like(out))

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        return disk_k.row_sum(self._violation(env, st)) - PCT_EPS

    def replica_key(self, env: ClusterEnv, st: EngineState, severity):
        pct, lower, upper, _valid = self._band(env, st)
        avg = (lower + upper) / 2.0
        # any replica on an above-AVERAGE disk of a violating broker (a
        # below-lower disk fills by draining in-band disks above the mean);
        # the score rejects moves with no band-violation gain (K1 keying:
        # pct[b, d] > avg[b] + PCT_EPS, severity[b] > 0, load > 0)
        return sweep_keys(KEY_INTRA_USAGE, env, st, Resource.DISK,
                          [severity, avg + PCT_EPS], disk=(st.replica_disk, pct[None]))

    def violated(self, env: ClusterEnv, st: EngineState):
        return (self._violation(env, st) > PCT_EPS).any()
