from cruise_control_tpu_torch.common.resources import (
    EPSILON_ABS, NUM_RESOURCES, RESOURCES, Resource,
)

__all__ = ["EPSILON_ABS", "NUM_RESOURCES", "RESOURCES", "Resource"]
