"""Endpoint registry + typed per-endpoint query parameters (counterpart of
``cruise_control_tpu/api/endpoints.py``).

Reference: servlet/CruiseControlEndPoint.java:16-36 (the 20-endpoint enum and
its GET/POST split), servlet/parameters/ (30 classes of typed query-param
parsing) and servlet/KafkaCruiseControlServletUtils.java. The reference
instantiates one Parameters class per endpoint; here each endpoint declares a
flat spec of typed parameters, parsed/validated in one pass — unknown or
ill-typed parameters are a 400, like ParameterUtils does.

``GET /metrics`` (Prometheus text exposition of the sensor registry) is
deliberately NOT an EndPoint member: it keeps the reference's 20-endpoint
catalog intact, takes no parameters, and serves text/plain — the server
routes it before endpoint dispatch (api/server.py), authorized like STATE.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any


class EndpointType(enum.Enum):
    KAFKA_MONITOR = "KAFKA_MONITOR"
    KAFKA_ADMIN = "KAFKA_ADMIN"
    CRUISE_CONTROL_MONITOR = "CRUISE_CONTROL_MONITOR"
    CRUISE_CONTROL_ADMIN = "CRUISE_CONTROL_ADMIN"


class EndPoint(enum.Enum):
    """CruiseControlEndPoint.java:17-36, same names lower-cased in URLs."""
    BOOTSTRAP = ("bootstrap", EndpointType.CRUISE_CONTROL_ADMIN)
    TRAIN = ("train", EndpointType.CRUISE_CONTROL_ADMIN)
    LOAD = ("load", EndpointType.KAFKA_MONITOR)
    PARTITION_LOAD = ("partition_load", EndpointType.KAFKA_MONITOR)
    PROPOSALS = ("proposals", EndpointType.KAFKA_MONITOR)
    STATE = ("state", EndpointType.CRUISE_CONTROL_MONITOR)
    ADD_BROKER = ("add_broker", EndpointType.KAFKA_ADMIN)
    REMOVE_BROKER = ("remove_broker", EndpointType.KAFKA_ADMIN)
    FIX_OFFLINE_REPLICAS = ("fix_offline_replicas", EndpointType.KAFKA_ADMIN)
    REBALANCE = ("rebalance", EndpointType.KAFKA_ADMIN)
    STOP_PROPOSAL_EXECUTION = ("stop_proposal_execution", EndpointType.KAFKA_ADMIN)
    PAUSE_SAMPLING = ("pause_sampling", EndpointType.CRUISE_CONTROL_ADMIN)
    RESUME_SAMPLING = ("resume_sampling", EndpointType.CRUISE_CONTROL_ADMIN)
    KAFKA_CLUSTER_STATE = ("kafka_cluster_state", EndpointType.KAFKA_MONITOR)
    DEMOTE_BROKER = ("demote_broker", EndpointType.KAFKA_ADMIN)
    USER_TASKS = ("user_tasks", EndpointType.CRUISE_CONTROL_MONITOR)
    REVIEW_BOARD = ("review_board", EndpointType.CRUISE_CONTROL_MONITOR)
    ADMIN = ("admin", EndpointType.CRUISE_CONTROL_ADMIN)
    REVIEW = ("review", EndpointType.CRUISE_CONTROL_ADMIN)
    TOPIC_CONFIGURATION = ("topic_configuration", EndpointType.KAFKA_ADMIN)

    def __init__(self, path: str, endpoint_type: EndpointType):
        self.path = path
        self.endpoint_type = endpoint_type

    @classmethod
    def from_path(cls, path: str) -> "EndPoint | None":
        return _BY_PATH.get(path.lower())


_BY_PATH = {e.path: e for e in EndPoint}

# CruiseControlEndPoint.java:50-76 (GET vs POST split)
GET_ENDPOINTS = frozenset({
    EndPoint.BOOTSTRAP, EndPoint.TRAIN, EndPoint.LOAD, EndPoint.PARTITION_LOAD,
    EndPoint.PROPOSALS, EndPoint.STATE, EndPoint.KAFKA_CLUSTER_STATE,
    EndPoint.USER_TASKS, EndPoint.REVIEW_BOARD,
})
POST_ENDPOINTS = frozenset(EndPoint) - GET_ENDPOINTS

# Endpoints whose work is long-running: tracked as async user tasks with
# progress responses until the future completes (servlet/handler/async/).
ASYNC_ENDPOINTS = frozenset({
    EndPoint.LOAD, EndPoint.PARTITION_LOAD, EndPoint.PROPOSALS,
    EndPoint.ADD_BROKER, EndPoint.REMOVE_BROKER, EndPoint.FIX_OFFLINE_REPLICAS,
    EndPoint.REBALANCE, EndPoint.DEMOTE_BROKER, EndPoint.TOPIC_CONFIGURATION,
})


class ParamType(enum.Enum):
    BOOL = "bool"
    INT = "int"
    DOUBLE = "double"
    STRING = "string"
    INT_LIST = "int_list"        # csv of ints
    STRING_LIST = "string_list"  # csv of strings


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    type: ParamType
    default: Any = None


class ParameterError(ValueError):
    """400-level query parameter problem (ParameterUtils semantics)."""


def _parse_value(spec: ParamSpec, raw: str, name: str) -> Any:
    try:
        if spec.type is ParamType.BOOL:
            low = raw.strip().lower()
            if low in ("true", "1", ""):
                return True
            if low in ("false", "0"):
                return False
            raise ValueError(raw)
        if spec.type is ParamType.INT:
            return int(raw)
        if spec.type is ParamType.DOUBLE:
            return float(raw)
        if spec.type is ParamType.INT_LIST:
            return [int(x) for x in raw.split(",") if x.strip() != ""]
        if spec.type is ParamType.STRING_LIST:
            return [x.strip() for x in raw.split(",") if x.strip() != ""]
        return raw
    except ValueError:
        raise ParameterError(
            f"invalid value {raw!r} for parameter {name!r} "
            f"(expected {spec.type.value})") from None


_B = ParamSpec(ParamType.BOOL, False)
_S = ParamSpec(ParamType.STRING)
_SL = ParamSpec(ParamType.STRING_LIST)
_IL = ParamSpec(ParamType.INT_LIST)
_I = ParamSpec(ParamType.INT)

# Parameters accepted by every endpoint (ParameterUtils.java common set).
COMMON_PARAMS: dict[str, ParamSpec] = {
    "json": ParamSpec(ParamType.BOOL, True),
    "verbose": _B,
    "get_response_schema": _B,
    "doas": _S,
    "reason": _S,
    "review_id": _I,
}

# Shared by the goal-based operations (GoalBasedOptimizationParameters.java).
_GOAL_BASED: dict[str, ParamSpec] = {
    "goals": _SL,
    "allow_capacity_estimation": ParamSpec(ParamType.BOOL, True),
    "exclude_recently_demoted_brokers": _B,
    "exclude_recently_removed_brokers": _B,
    "use_ready_default_goals": _B,
    "excluded_topics": _S,
    "kafka_assigner": _B,
    "fast_mode": ParamSpec(ParamType.BOOL, True),
    "stop_ongoing_execution": _B,
}

_EXECUTION: dict[str, ParamSpec] = {
    "dryrun": ParamSpec(ParamType.BOOL, True),
    "concurrent_partition_movements_per_broker": _I,
    "concurrent_intra_broker_partition_movements": _I,
    "concurrent_leader_movements": _I,
    "execution_progress_check_interval_ms": _I,
    "skip_hard_goal_check": _B,
    "replica_movement_strategies": _SL,
    "replication_throttle": _I,
}

# Per-endpoint accepted parameters (servlet/parameters/*Parameters.java).
ENDPOINT_PARAMS: dict[EndPoint, dict[str, ParamSpec]] = {
    EndPoint.BOOTSTRAP: {"start": _I, "end": _I, "clearmetrics": ParamSpec(ParamType.BOOL, True)},
    EndPoint.TRAIN: {"start": _I, "end": _I},
    EndPoint.LOAD: {"time": _I, "start": _I, "end": _I,
                    "allow_capacity_estimation": ParamSpec(ParamType.BOOL, True),
                    "populate_disk_info": _B, "capacity_only": _B},
    EndPoint.PARTITION_LOAD: {"resource": ParamSpec(ParamType.STRING, "DISK"),
                              "start": _I, "end": _I, "entries": ParamSpec(ParamType.INT, 50),
                              "topic": _S, "partition": _S,
                              "min_valid_partition_ratio": ParamSpec(ParamType.DOUBLE),
                              "allow_capacity_estimation": ParamSpec(ParamType.BOOL, True),
                              "max_load": _B, "avg_load": _B, "brokerid": _IL},
    EndPoint.PROPOSALS: {**_GOAL_BASED, "ignore_proposal_cache": _B,
                         "destination_broker_ids": _IL, "rebalance_disk": _B},
    EndPoint.STATE: {"substates": _SL, "super_verbose": _B},
    EndPoint.ADD_BROKER: {**_GOAL_BASED, **_EXECUTION, "brokerid": _IL,
                          "throttle_added_broker": _B},
    EndPoint.REMOVE_BROKER: {**_GOAL_BASED, **_EXECUTION, "brokerid": _IL,
                             "throttle_removed_broker": _B,
                             "destination_broker_ids": _IL},
    EndPoint.FIX_OFFLINE_REPLICAS: {**_GOAL_BASED, **_EXECUTION},
    EndPoint.REBALANCE: {**_GOAL_BASED, **_EXECUTION, "ignore_proposal_cache": _B,
                         "destination_broker_ids": _IL, "rebalance_disk": _B},
    EndPoint.STOP_PROPOSAL_EXECUTION: {"force_stop": _B},
    EndPoint.PAUSE_SAMPLING: {},
    EndPoint.RESUME_SAMPLING: {},
    EndPoint.KAFKA_CLUSTER_STATE: {"topic": _S, "verbose": _B},
    EndPoint.DEMOTE_BROKER: {**_EXECUTION, "brokerid": _IL,
                             "exclude_follower_demotion": _B,
                             "exclude_recently_demoted_brokers": _B},
    EndPoint.USER_TASKS: {"user_task_ids": _SL, "client_ids": _SL,
                          "endpoints": _SL, "types": _SL,
                          "entries": ParamSpec(ParamType.INT, 100),
                          "fetch_completed_task": _B},
    EndPoint.REVIEW_BOARD: {"review_ids": _IL},
    EndPoint.ADMIN: {"disable_self_healing_for": _SL, "enable_self_healing_for": _SL,
                     "concurrent_partition_movements_per_broker": _I,
                     "concurrent_intra_broker_partition_movements": _I,
                     "concurrent_leader_movements": _I,
                     "drop_recently_removed_brokers": _IL,
                     "drop_recently_demoted_brokers": _IL,
                     "execution_progress_check_interval_ms": _I},
    EndPoint.REVIEW: {"approve": _IL, "discard": _IL},
    EndPoint.TOPIC_CONFIGURATION: {**_GOAL_BASED, **_EXECUTION, "topic": _S,
                                   "replication_factor": _I},
}


def parse_params(endpoint: EndPoint, query: dict[str, list[str]]) -> dict[str, Any]:
    """Parse+validate one request's query params against the endpoint spec.

    Returns a flat dict with defaults filled in. Unknown parameter names raise
    ParameterError (ParameterUtils rejects them the same way).
    """
    spec = {**COMMON_PARAMS, **ENDPOINT_PARAMS[endpoint]}
    out: dict[str, Any] = {}
    for name, values in query.items():
        key = name.lower()
        if key not in spec:
            raise ParameterError(
                f"unrecognized parameter {name!r} for endpoint {endpoint.path!r} "
                f"(accepted: {sorted(spec)})")
        out[key] = _parse_value(spec[key], values[-1], key)
    for name, ps in spec.items():
        out.setdefault(name, ps.default)
    return out
