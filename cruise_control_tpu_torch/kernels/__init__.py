"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

Every wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain twin.
There is no fallback from one to the other. ``KERNELS`` holds each
kernel's source, the reference function it replaces and its launch count.
"""
from cruise_control_tpu_torch.kernels.admission import wave_admission, wave_admission_lanes
from cruise_control_tpu_torch.kernels.build import KERNELS, build_all
from cruise_control_tpu_torch.kernels.disk import disk_apply, disk_rows
from cruise_control_tpu_torch.kernels.finalize import session_finalize
from cruise_control_tpu_torch.kernels.forecast import forecast_batch
from cruise_control_tpu_torch.kernels.keys import (
    KEY_FAMILY_LAUNCHES, replica_keys, replica_keys_lanes,
)
from cruise_control_tpu_torch.kernels.leadership import leadership_rows, leadership_rows_lanes
from cruise_control_tpu_torch.kernels.move_score import (
    FAMILY_LAUNCHES, move_score_classes, move_score_classes_lanes,
)
from cruise_control_tpu_torch.kernels.ple import preferred_leader
from cruise_control_tpu_torch.kernels.probe import seeded_probe, seeded_probe_lanes
from cruise_control_tpu_torch.kernels.segment import segment_count, segment_counts, segment_sum
from cruise_control_tpu_torch.kernels.select import (
    compact_eligible, pool_branch_counts, reset_pool_branches, select_candidates,
    select_candidates_lanes, select_pooled, select_pooled_lanes,
)
from cruise_control_tpu_torch.kernels.swap import (
    swap_admission, swap_admission_lanes, swap_rows, swap_rows_lanes,
)


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.cuda_launches = 0
        k.shapes = {}
    FAMILY_LAUNCHES.clear()
    KEY_FAMILY_LAUNCHES.clear()
    reset_pool_branches()


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def launch_shapes() -> dict:
    """{kernel: {launch shape: launches}} since the last reset."""
    return {name: dict(k.shapes) for name, k in KERNELS.items()}


__all__ = [
    "FAMILY_LAUNCHES", "KEY_FAMILY_LAUNCHES", "KERNELS", "build_all", "compact_eligible",
    "disk_apply", "disk_rows", "forecast_batch", "launch_shapes", "launches", "leadership_rows",
    "leadership_rows_lanes", "move_score_classes", "move_score_classes_lanes",
    "pool_branch_counts", "preferred_leader", "replica_keys", "replica_keys_lanes",
    "reset_launches", "reset_pool_branches", "seeded_probe", "seeded_probe_lanes",
    "segment_count", "segment_counts", "segment_sum", "select_candidates",
    "select_candidates_lanes", "select_pooled", "select_pooled_lanes", "session_finalize",
    "swap_admission",
    "swap_admission_lanes", "swap_rows", "swap_rows_lanes", "wave_admission",
    "wave_admission_lanes",
]
