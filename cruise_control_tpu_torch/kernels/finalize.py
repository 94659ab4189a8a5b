"""K5 ``session_finalize``: the per-replica half of a resident session's
sync.

Replaces ``cruise_control_tpu/analyzer/session.py`` ``_sync_finalize``
(:102) up to its ``refresh``: unpack the bit-packed leadership upload
(big-endian, as ``jnp.unpackbits``: replica r is bit ``7 - r % 8`` of byte
``r // 8``), recompute the offline flags from broker and logdir liveness,
re-derive the topic-exclusion hoist and destination candidacy. The session
then builds the state from these and runs the existing ``refresh``, as
``init_state`` does, so a sync is bit-exact with a rebuild.

CUDA kernel (``csrc/session_finalize.cu``): one thread per replica slot,
the first B threads also write ``dst_candidate``. Bound: bytes.
"""
from __future__ import annotations

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stream_ptr,
)

KERNEL = register("session_finalize",
                  "cruise_control_tpu_torch/kernels/csrc/session_finalize.cu",
                  "cruise_control_tpu/analyzer/session.py:102")

_SIGNATURES = {"cc_session_finalize": [P, P, P, P, P, P, P, P, P, I, I, I, I,
                                       P, P, P, P, P]}


def unpack_leaders(lead_packed: torch.Tensor, R: int) -> torch.Tensor:
    """bool[R] of a big-endian bit-packed u8 vector."""
    r = torch.arange(R, device=lead_packed.device)
    return ((lead_packed[r // 8].to(torch.int64) >> (7 - r % 8)) & 1).bool()


def session_finalize_plain(lead_packed, broker, disk, topic, valid, alive,
                           disk_alive, topic_excluded, excl_move):
    R = broker.shape[0]
    B, D = disk_alive.shape
    T = topic_excluded.shape[0]
    b = broker.clamp(0, B - 1)
    d = disk.clamp(0, D - 1)
    offline = (~alive[b] | ~disk_alive[b, d]) & valid
    return (unpack_leaders(lead_packed, R), offline,
            topic_excluded[topic.clamp(0, T - 1)], alive & ~excl_move)


def session_finalize(lead_packed: torch.Tensor, broker: torch.Tensor,
                     disk: torch.Tensor, topic: torch.Tensor, valid: torch.Tensor,
                     alive: torch.Tensor, disk_alive: torch.Tensor,
                     topic_excluded: torch.Tensor, excl_move: torch.Tensor):
    """(is_leader bool[R], offline bool[R], replica_topic_excluded bool[R],
    dst_candidate bool[B]) of u8[ceil(R / 8)] packed leadership, the i64[R]
    broker / logdir / topic columns, bool[R] validity, bool[B] liveness,
    bool[B, D] logdir liveness, bool[T] topic exclusion and bool[B]
    destination exclusion."""
    if not broker.is_cuda:
        return session_finalize_plain(lead_packed, broker, disk, topic, valid, alive,
                                      disk_alive, topic_excluded, excl_move)
    R = broker.shape[0]
    B, D = disk_alive.shape
    T = topic_excluded.shape[0]
    want = ((lead_packed, torch.uint8, ((R + 7) // 8,)), (broker, torch.int64, (R,)),
            (disk, torch.int64, (R,)), (topic, torch.int64, (R,)),
            (valid, torch.bool, (R,)), (alive, torch.bool, (B,)),
            (disk_alive, torch.bool, (B, D)), (topic_excluded, torch.bool, (T,)),
            (excl_move, torch.bool, (B,)))
    for t, dt, shape in want:
        if (t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or not t.is_cuda):
            raise ValueError("session_finalize: wrong dtype, shape, layout or device")
    dev = broker.device
    is_leader = torch.empty(R, dtype=torch.bool, device=dev)
    offline = torch.empty(R, dtype=torch.bool, device=dev)
    rtexcl = torch.empty(R, dtype=torch.bool, device=dev)
    dst = torch.empty(B, dtype=torch.bool, device=dev)
    err = library("session_finalize", _SIGNATURES).cc_session_finalize(
        ptr(lead_packed), ptr(broker), ptr(disk), ptr(topic), ptr(valid), ptr(alive),
        ptr(disk_alive), ptr(topic_excluded), ptr(excl_move), R, B, D, T,
        ptr(is_leader), ptr(offline), ptr(rtexcl), ptr(dst), stream_ptr())
    check(err, "session_finalize")
    KERNEL.count(f"R={R} B={B}")
    return is_leader, offline, rtexcl, dst
