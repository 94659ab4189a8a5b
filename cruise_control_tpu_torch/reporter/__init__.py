"""The metrics transport (counterpart of ``cruise_control_tpu/reporter/``):
only ``topic.py``'s file-backed topic is ported, the log the maintenance
event reader consumes. The reporter and its metrics are not."""
from cruise_control_tpu_torch.reporter.topic import FileMetricsTopic

__all__ = ["FileMetricsTopic"]
