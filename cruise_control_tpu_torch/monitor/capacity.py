"""(Counterpart of ``cruise_control_tpu/monitor/capacity.py``, copied with the
port's imports.) Broker capacity resolution.

Reference: config/BrokerCapacityConfigResolver.java SPI with
BrokerCapacityConfigFileResolver (reads config/capacity.json /
capacityJBOD.json: per-broker CPU/DISK/NW_IN/NW_OUT, JBOD per-logdir DISK,
broker -1 as the default entry) — SURVEY §2.3.

JSON format (capacityJBOD.json-compatible shape):
{
  "brokerCapacities": [
    {"brokerId": "-1", "capacity": {"CPU": "100", "NW_IN": "50000",
       "NW_OUT": "50000", "DISK": {"/logdir0": "250000", "/logdir1": "250000"}}},
    {"brokerId": "0", "capacity": {...}}
  ]
}
DISK may be a plain number (single logdir) or a {logdir: MB} map (JBOD).
"""
from __future__ import annotations

import dataclasses
import json

from cruise_control_tpu_torch.common.resources import Resource


@dataclasses.dataclass
class BrokerCapacityInfo:
    capacity: dict                       # Resource -> float (DISK = total)
    disk_capacity_by_logdir: dict | None = None
    estimated: bool = False
    estimation_info: str = ""


class BrokerCapacityResolver:
    def configure(self, config, **extra) -> None: ...

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo: ...


class DefaultCapacityResolver:
    """Uniform defaults from config keys (estimation fallback role)."""

    def __init__(self, cpu=100.0, disk=500_000.0, nw_in=50_000.0, nw_out=50_000.0):
        self._info = BrokerCapacityInfo(capacity={
            Resource.CPU: cpu, Resource.DISK: disk,
            Resource.NW_IN: nw_in, Resource.NW_OUT: nw_out}, estimated=True,
            estimation_info="uniform default capacity")

    def configure(self, config, **extra):
        if config is not None:
            self._info = BrokerCapacityInfo(capacity={
                Resource.CPU: config.get_double("default.broker.capacity.cpu"),
                Resource.DISK: config.get_double("default.broker.capacity.disk"),
                Resource.NW_IN: config.get_double("default.broker.capacity.nw.in"),
                Resource.NW_OUT: config.get_double("default.broker.capacity.nw.out")},
                estimated=True, estimation_info="uniform default capacity")

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        return self._info


class FileCapacityResolver:
    """BrokerCapacityConfigFileResolver analogue."""

    def __init__(self, path: str | None = None,
                 allow_cpu_estimation: bool = True):
        self._by_broker: dict[int, BrokerCapacityInfo] = {}
        self._default: BrokerCapacityInfo | None = None
        self._fallback = DefaultCapacityResolver()
        # MonitorConfig sampling.allow.cpu.capacity.estimation: whether a
        # broker entry without an explicit CPU capacity may fall back to the
        # estimated default (False = loud failure at resolution time)
        self._allow_cpu_estimation = allow_cpu_estimation
        if path:
            self._load(path)

    def configure(self, config, **extra):
        self._fallback.configure(config)
        path = extra.get("path") or (config.get_string("capacity.config.file")
                                     if config is not None else "")
        if config is not None:
            self._allow_cpu_estimation = config.get_boolean(
                "sampling.allow.cpu.capacity.estimation")
        if path:
            self._load(path)

    def _load(self, path: str) -> None:
        with open(path) as f:
            doc = json.load(f)
        for entry in doc.get("brokerCapacities", []):
            broker_id = int(entry["brokerId"])
            cap_raw = entry["capacity"]
            disk_raw = cap_raw.get("DISK", 0)
            if isinstance(disk_raw, dict):
                by_logdir = {k: float(v) for k, v in disk_raw.items()}
                disk_total = sum(by_logdir.values())
            else:
                by_logdir = None
                disk_total = float(disk_raw)
            cpu_estimated = "CPU" not in cap_raw
            if cpu_estimated and not self._allow_cpu_estimation:
                raise ValueError(
                    f"broker {broker_id} capacity entry has no CPU and "
                    f"sampling.allow.cpu.capacity.estimation=false")
            info = BrokerCapacityInfo(
                capacity={
                    Resource.CPU: float(cap_raw.get("CPU", 100)),
                    Resource.NW_IN: float(cap_raw.get("NW_IN", 0)),
                    Resource.NW_OUT: float(cap_raw.get("NW_OUT", 0)),
                    Resource.DISK: disk_total,
                },
                disk_capacity_by_logdir=by_logdir,
                estimated=cpu_estimated,
                estimation_info="CPU capacity estimated" if cpu_estimated else "")
            if broker_id == -1:
                self._default = info
            else:
                self._by_broker[broker_id] = info

    def capacity_for(self, broker_id: int) -> BrokerCapacityInfo:
        if broker_id in self._by_broker:
            return self._by_broker[broker_id]
        if self._default is not None:
            return self._default
        return self._fallback.capacity_for(broker_id)
