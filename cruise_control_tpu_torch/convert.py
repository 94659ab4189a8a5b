"""Carry cluster, env and engine state over from the JAX package.

The reference's ``ClusterTensor`` / ``ClusterEnv`` / ``EngineState`` are
dataclasses whose leaves convert to numpy arrays; these functions take such
leaves as ``{field name: numpy array}`` (and a ClusterMeta-like object for
the names) and build the port's counterparts, so a test can start both
packages from the same bits and compare them leaf by leaf; a resident
session's host mirrors convert into the port's finalize inputs. Nothing here
imports the reference: its objects are read by field name only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv, resolve_device
from cruise_control_tpu_torch.analyzer.lanes import LaneStack
from cruise_control_tpu_torch.analyzer.state import EngineState
from cruise_control_tpu_torch.model.cluster_tensor import ClusterMeta, ClusterTensor

_INDEX_FIELDS = {"broker_rack", "replica_partition", "replica_topic",
                 "replica_original_broker", "partition_replicas", "partition_topic",
                 "replica_broker", "replica_disk"}
_COUNT_FIELDS = {"replica_count", "leader_count", "part_rack_count",
                 "topic_broker_count", "topic_leader_count"}


def leaves(obj) -> dict:
    """{field: numpy array} of a dataclass of arrays (either package)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def meta_from(meta) -> ClusterMeta:
    """A port ClusterMeta with the same names as a ClusterMeta-like object."""
    return ClusterMeta(topic_names=list(meta.topic_names),
                       partition_ids=[tuple(p) for p in meta.partition_ids],
                       broker_ids=list(meta.broker_ids),
                       rack_ids=list(meta.rack_ids),
                       logdirs=[list(x) for x in meta.logdirs],
                       num_racks=int(meta.num_racks),
                       num_valid_replicas=int(meta.num_valid_replicas))


def cluster_from_arrays(arrays: dict, meta) -> tuple[ClusterTensor, ClusterMeta]:
    kw = {f.name: np.asarray(arrays[f.name]) for f in dataclasses.fields(ClusterTensor)}
    return ClusterTensor(**kw), meta_from(meta)


def _tensor(name, a, dev):
    a = np.array(a)  # a writable copy: the reference's buffers are read-only
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=dev)
    if name in _INDEX_FIELDS:
        return torch.as_tensor(a.astype(np.int64), device=dev)
    if name in _COUNT_FIELDS:
        return torch.as_tensor(a.astype(np.int32), device=dev)
    return torch.as_tensor(a.astype(np.float32), device=dev)


def env_from_arrays(arrays: dict, device="cuda") -> ClusterEnv:
    """Port env from reference env leaves (``num_real_racks`` may be a
    0-d array; ``num_racks``/``max_rf`` are the static sizes)."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(ClusterEnv):
        v = arrays[f.name]
        if f.name in ("num_real_racks", "num_racks", "max_rf"):
            kw[f.name] = int(np.asarray(v))
        else:
            kw[f.name] = _tensor(f.name, v, dev)
    return ClusterEnv(**kw)


def state_from_arrays(arrays: dict, device="cuda") -> EngineState:
    dev = resolve_device(device)
    return EngineState(**{f.name: _tensor(f.name, arrays[f.name], dev)
                          for f in dataclasses.fields(EngineState)})


def lane_stack_from_arrays(env_arrays: dict, state_arrays: dict, device="cuda"):
    """The port's lane stack (``analyzer.lanes.LaneStack``) from the
    reference's stacked [K, ...] env and state leaves (``_compiled_stack``'s
    output as numpy: ``num_real_racks`` one value per lane or one for all,
    ``num_racks`` / ``max_rf`` the static sizes)."""
    K = int(np.asarray(state_arrays["replica_broker"]).shape[0])
    real = np.broadcast_to(np.asarray(env_arrays["num_real_racks"]), (K,))
    envs, sts = [], []
    for k in range(K):
        lane = {n: (np.asarray(v)[k] if n not in ("num_racks", "max_rf",
                                                 "num_real_racks") else v)
                for n, v in env_arrays.items()}
        lane["num_real_racks"] = real[k]
        envs.append(env_from_arrays(lane, device))
        sts.append(state_from_arrays({n: np.asarray(v)[k] for n, v in state_arrays.items()},
                                     device))
    return LaneStack(envs, sts)


def finalize_inputs_from_arrays(arrays: dict, device="cuda") -> tuple:
    """The port's finalize inputs (``analyzer.session.sync_finalize``) from a
    session's host mirrors as numpy arrays: ``lead_packed`` (u8, big-endian
    bit-packed leadership), ``replica_broker`` and ``replica_disk`` (any
    integer dtype), ``leader_load`` and ``follower_load`` (f32 [R, M]).
    Returns (broker i64, lead_packed u8, disk i64, leader_rows, follower_rows)
    on ``device``, the same bits the reference's ``_sync_finalize`` reads."""
    dev = resolve_device(device)
    return (_tensor("replica_broker", arrays["replica_broker"], dev),
            torch.as_tensor(np.array(arrays["lead_packed"], np.uint8), device=dev),
            _tensor("replica_disk", arrays["replica_disk"], dev),
            _tensor("leader_load", arrays["leader_load"], dev),
            _tensor("follower_load", arrays["follower_load"], dev))
