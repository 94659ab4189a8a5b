"""Python client + CLI for the Cruise Control REST API (counterpart of
``cruise_control_tpu/client/``).

Reference: cruise-control-client/ (cruisecontrolclient.client — cccli.py,
Endpoint.py, CCParameter/, Query.py, Responder.py, Display.py; 1,991 LoC).
"""
from cruise_control_tpu_torch.client.client import (
    CruiseControlClient, CruiseControlClientError,
)

__all__ = ["CruiseControlClient", "CruiseControlClientError"]
