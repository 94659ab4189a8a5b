from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly, AnomalyType, BrokerFailures, DiskFailures, GoalViolations,
    MaintenanceEvent, MetricAnomaly, SlowBrokers, TopicAnomaly,
)
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector, DiskFailureDetector, GoalViolationDetector,
    PredictedGoalViolationDetector,
    SlowBrokerFinder,
)
from cruise_control_tpu_torch.detector.maintenance import (
    FileMaintenanceEventReader, IdempotenceCache,
)
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
from cruise_control_tpu_torch.detector.metric_anomaly import PercentileMetricAnomalyFinder
from cruise_control_tpu_torch.detector.notifier import (
    Action, AlertaSelfHealingNotifier, AlertFileNotifier, NoopNotifier,
    SelfHealingNotifier, SlackSelfHealingNotifier,
)
from cruise_control_tpu_torch.detector.provisioner import (
    NoopProvisioner, ProvisionFloors, ProvisionRecommendation, ProvisionStatus,
    SimulatedProvisioner, recommendation_from_result,
)
from cruise_control_tpu_torch.detector.topic_anomaly import (
    PartitionSizeAnomalyFinder, TopicReplicationFactorAnomalyFinder,
)

__all__ = [
    "Anomaly", "AnomalyType", "BrokerFailures", "DiskFailures", "GoalViolations",
    "MaintenanceEvent", "MetricAnomaly", "SlowBrokers", "TopicAnomaly",
    "BrokerFailureDetector", "DiskFailureDetector", "GoalViolationDetector",
    "PredictedGoalViolationDetector", "SlowBrokerFinder",
    "FileMaintenanceEventReader", "IdempotenceCache",
    "AnomalyDetectorManager", "PercentileMetricAnomalyFinder",
    "Action", "AlertaSelfHealingNotifier", "AlertFileNotifier", "NoopNotifier",
    "SelfHealingNotifier", "SlackSelfHealingNotifier",
    "NoopProvisioner", "ProvisionFloors", "ProvisionRecommendation", "ProvisionStatus",
    "SimulatedProvisioner", "recommendation_from_result",
    "PartitionSizeAnomalyFinder", "TopicReplicationFactorAnomalyFinder",
]
