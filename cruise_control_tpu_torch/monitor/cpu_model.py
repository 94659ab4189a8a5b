"""(Counterpart of ``cruise_control_tpu/monitor/cpu_model.py``, copied with the
port's imports.) CPU attribution model.

Reference: model/ModelUtils.java:61-141 — static-weight attribution of a
broker's CPU utilization to its partitions by their share of weighted network
throughput (leader.network.inbound.weight.for.cpu.util = 0.6,
follower.network.inbound.weight = 0.3, leader.network.outbound.weight = 0.1 —
MonitorConfig defaults), plus the experimental linear-regression model
(ModelParameters.java / LinearRegressionModelParameters.java:379) which is
config-gated off by default (use.linear.regression.model).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CpuModelParams:
    leader_nw_in_weight: float = 0.6
    follower_nw_in_weight: float = 0.3
    leader_nw_out_weight: float = 0.1

    @classmethod
    def from_config(cls, cfg) -> "CpuModelParams":
        return cls(
            leader_nw_in_weight=cfg.get_double("leader.network.inbound.weight.for.cpu.util"),
            follower_nw_in_weight=cfg.get_double("follower.network.inbound.weight.for.cpu.util"),
            leader_nw_out_weight=cfg.get_double("leader.network.outbound.weight.for.cpu.util"),
        )


def estimate_leader_cpu_util(broker_cpu_util, broker_leader_bytes_in,
                             broker_leader_bytes_out, broker_follower_bytes_in,
                             partition_bytes_in, partition_bytes_out,
                             params: CpuModelParams = CpuModelParams()):
    """CPU share of a leader partition (ModelUtils.estimateLeaderCpuUtil :92-124).

    All args may be scalars or aligned numpy arrays (vectorized attribution for
    a whole broker's partitions at once).
    """
    total_weighted = (params.leader_nw_in_weight * broker_leader_bytes_in
                      + params.leader_nw_out_weight * broker_leader_bytes_out
                      + params.follower_nw_in_weight * broker_follower_bytes_in)
    share = np.where(np.asarray(total_weighted) > 0,
                     (params.leader_nw_in_weight * partition_bytes_in
                      + params.leader_nw_out_weight * partition_bytes_out)
                     / np.maximum(total_weighted, 1e-12),
                     0.0)
    return broker_cpu_util * share


def estimate_follower_cpu_util(leader_cpu_util, leader_bytes_in, leader_bytes_out,
                               params: CpuModelParams = CpuModelParams()):
    """Follower CPU from the leader's (ModelUtils.estimateFollowerCpuUtil):
    followers do replication-in work only."""
    denom = (params.leader_nw_in_weight * leader_bytes_in
             + params.leader_nw_out_weight * leader_bytes_out)
    ratio = np.where(np.asarray(denom) > 0,
                     params.follower_nw_in_weight * leader_bytes_in
                     / np.maximum(denom, 1e-12), 0.0)
    return leader_cpu_util * ratio


class LinearRegressionCpuModel:
    """Experimental CPU model (LinearRegressionModelParameters role): fits
    cpu ~ a*bytes_in + b*bytes_out from training samples.

    ``bucket_size_pct`` (MonitorConfig linear.regression.model.cpu.util.
    bucket.size): training coverage is tracked per CPU-utilization bucket —
    the model reports itself trainable only once samples span enough distinct
    buckets to pin the regression down (the reference's
    LinearRegressionModelParameters.modelCoefficientTrainingCompleteness)."""

    MIN_BUCKETS = 2   # below this the fit rests on one utilization regime

    def __init__(self, bucket_size_pct: int = 5):
        self._coef = None
        self._bucket_pct = max(1, bucket_size_pct)
        self._buckets_seen: set[int] = set()

    def train(self, bytes_in: np.ndarray, bytes_out: np.ndarray, cpu: np.ndarray) -> None:
        X = np.stack([np.asarray(bytes_in), np.asarray(bytes_out)], axis=1)
        y = np.asarray(cpu)
        self._buckets_seen.update(int(v // self._bucket_pct) for v in y)
        self._coef, *_ = np.linalg.lstsq(X, y, rcond=None)

    def training_completeness(self) -> dict:
        """Coverage report (LinearRegressionModelParameters
        .modelCoefficientTrainingCompleteness role): distinct
        CPU-utilization buckets the training data spanned."""
        return {"bucketSizePct": self._bucket_pct,
                "bucketsSeen": sorted(self._buckets_seen),
                "sufficient": len(self._buckets_seen) >= self.MIN_BUCKETS}

    @property
    def trained(self) -> bool:
        return self._coef is not None

    def predict(self, bytes_in, bytes_out):
        if self._coef is None:
            raise RuntimeError("model not trained")
        return self._coef[0] * np.asarray(bytes_in) + self._coef[1] * np.asarray(bytes_out)
