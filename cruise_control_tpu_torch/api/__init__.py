"""The REST surface (counterpart of ``cruise_control_tpu/api/``): the
endpoint registry, user tasks, the purgatory, security, the response
renderers and ``CruiseControlServer``."""
from cruise_control_tpu_torch.api.endpoints import EndPoint, EndpointType
from cruise_control_tpu_torch.api.server import CruiseControlServer
from cruise_control_tpu_torch.api.user_tasks import TaskState, UserTaskManager

__all__ = ["CruiseControlServer", "EndPoint", "EndpointType", "TaskState",
           "UserTaskManager"]
