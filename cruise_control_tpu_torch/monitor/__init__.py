"""The monitor stack (counterpart of ``cruise_control_tpu/monitor``):
metric definitions, the sample aggregator, the simulated sampler and the
``LoadMonitor``."""
from cruise_control_tpu_torch.monitor.aggregator.sample_aggregator import (
    AggregationResult, Extrapolation, MetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor, LoadMonitorState, ModelCompletenessRequirements, ModelGeneration,
    NotEnoughValidWindowsError,
)
from cruise_control_tpu_torch.monitor.metricdef import (
    BROKER_METRIC_DEF, PARTITION_METRIC_DEF, RAW_METRIC_TYPES,
)

__all__ = [
    "AggregationResult", "Extrapolation", "MetricSampleAggregator",
    "LoadMonitor", "LoadMonitorState", "ModelCompletenessRequirements",
    "ModelGeneration", "NotEnoughValidWindowsError",
    "BROKER_METRIC_DEF", "PARTITION_METRIC_DEF", "RAW_METRIC_TYPES",
]
