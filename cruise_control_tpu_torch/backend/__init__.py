"""(Counterpart of ``cruise_control_tpu/backend/__init__.py``, copied with the
port's imports.)"""
from cruise_control_tpu_torch.backend.interface import (
    BrokerNode, ClusterBackend, ClusterSnapshot, PartitionInfo,
    snapshot_from_metadata,
)
from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend

__all__ = ["BrokerNode", "ClusterBackend", "ClusterSnapshot", "PartitionInfo",
           "SimulatedClusterBackend", "snapshot_from_metadata"]
