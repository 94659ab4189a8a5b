from cruise_control_tpu_torch.detector.provisioner import (
    ProvisionFloors, ProvisionRecommendation, ProvisionStatus, recommendation_from_result,
)

__all__ = ["ProvisionFloors", "ProvisionRecommendation", "ProvisionStatus",
           "recommendation_from_result"]
