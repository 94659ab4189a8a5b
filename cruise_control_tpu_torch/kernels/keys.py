"""K1 keying ``replica_keys``: the [R]-sized candidate-key sweeps of the
goals that read the load tables.

Replaces the goals' key functions as the reference's pass loop calls them
on its precision policy's sweep view (``cruise_control_tpu/analyzer/engine.py``
``_sweep_env`` :85, ``_sweep_state`` :98; call sites :929-933, :984-995,
:1106, :1205-1208):

- ``KEY_CAPACITY``: ``CapacityGoal.replica_key`` (goals/capacity.py:48);
- ``KEY_POT_NW_OUT``: ``PotentialNwOutGoal.replica_key`` (goals/network.py:40);
- ``KEY_LEAD_DELTA``: ``CapacityGoal.leader_key`` (capacity.py:101) and
  ``ResourceDistributionGoal.leader_key`` (goals/distribution.py:183);
- ``KEY_LEAD_LOAD``: ``LeaderBytesInDistributionGoal.leader_key`` (network.py:115);
- ``KEY_DIST``: ``ResourceDistributionGoal.replica_key`` (distribution.py:86);
- ``KEY_SWAP_OUT`` / ``KEY_SWAP_IN``: its ``swap_out_key`` / ``swap_in_key``
  (distribution.py:232, :240);
- ``KEY_INTRA_CAPACITY`` / ``KEY_INTRA_USAGE``: the intra-broker goals'
  ``replica_key`` (goals/intra_broker.py:77, :147).

Each row r reads the load column ``col`` of both tables in their own dtype
(f32, or bf16 under the bf16 policy) and upcasts at the load, its broker
``rb[r]``, leader / offline / valid flags, and per-broker rows ``bt`` (and
per-logdir rows ``dt``, indexed ``rb * D + max(rdisk, 0)``) and scalars
``sc`` that plain torch computes first: severities, utilizations and limits,
``any_deficit``, ``max(headroom) + eps``. It computes in f32, in the
reference's order of operations, and writes the f32 key K1 salts and sorts.

Precision (measured against the reference on XLA:CPU, tests/
test_torch_precision.py): XLA keeps bf16 arithmetic in f32 inside a
program and rounds only where a bf16 array is materialized. Every family
but ``KEY_DIST`` returns a bf16 array under the bf16 policy (its ``where``
materializes it), so its f32 key is rounded once to bf16 (round to nearest
even) at the end; ``KEY_DIST`` divides by an f32 utilization and stays f32.
The offline bump ``key + 1e12`` adds f32(1e12) = 999999995904 to an f32 key
and bf16(1e12) = 233 * 2**32 to a bf16 one (a Python constant in a bf16
expression is a bf16 constant); K1's ``v >= 5e11`` test covers both.

``replica_keys_lanes`` is the fleet's lane form (K14): the keys of La
running lanes of a lane stack in ONE launch (grid dimension y = lane). The
[R]-sized tables are the stack's [L, R, ...] tensors read at the lane's
index; the per-broker rows, scalars and logdir rows have one row per
running lane. Its twin loops the solo twin over the lanes.

CUDA kernel (``csrc/replica_keys.cu``): one thread per replica, templated
on the load dtype (``float``, ``__nv_bfloat16``); no atomics, no shared
memory. Bound: bytes, about 19 bytes a replica under bf16 (two 2-byte load
values, the 8-byte broker index, three flag bytes, the 4-byte key; the
intra families add the 8-byte logdir index), plus the small [B] rows.
"""
from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, lane_index, library, ptr, register, stream_ptr,
)

KERNEL = register("replica_keys", "cruise_control_tpu_torch/kernels/csrc/replica_keys.cu",
                  "cruise_control_tpu/analyzer/engine.py:929")

KERNEL_LANES = register("replica_keys_lanes",
                        "cruise_control_tpu_torch/kernels/csrc/replica_keys.cu",
                        "cruise_control_tpu/analyzer/optimizer.py:2563")

KEY_CAPACITY = 0
KEY_POT_NW_OUT = 1
KEY_LEAD_DELTA = 2
KEY_LEAD_LOAD = 3
KEY_DIST = 4
KEY_SWAP_OUT = 5
KEY_SWAP_IN = 6
KEY_INTRA_CAPACITY = 7
KEY_INTRA_USAGE = 8
FAMILY_NAMES = ("capacity", "pot_nw_out", "lead_delta", "lead_load", "dist",
                "swap_out", "swap_in", "intra_capacity", "intra_usage")
# families whose reference key is a bf16 array under the bf16 policy
BF16_RESULT = frozenset(range(9)) - {KEY_DIST}
OFFLINE_BUMP_F32 = 1e12                  # f32(1e12) = 999999995904
OFFLINE_BUMP_BF16 = 1000727379968.0      # bf16(1e12) = 233 * 2**32
# launches by family and table dtype since the last reset
KEY_FAMILY_LAUNCHES: dict[str, int] = {}


def env_loads(env) -> tuple:
    """(leader, follower) [R, M] load tables the keying reads: the bf16
    tables of a sweep view, else the f32 ones."""
    return env.sweep_loads if env.sweep_loads is not None else (env.leader_load,
                                                                 env.follower_load)


def _round_out(family: int, loads) -> bool:
    return loads[0].dtype == torch.bfloat16 and family in BF16_RESULT


def replica_keys_plain(family: int, loads, col: int, rb, lead, off, valid, bt, sc,
                       rdisk=None, dt=None) -> torch.Tensor:
    """The twin: the goals' own torch arithmetic on the upcast columns."""
    lc = loads[0][:, col].float()
    fc = loads[1][:, col].float()
    neg = torch.full_like(lc, -torch.inf)
    offl = off & valid
    eff = torch.where(valid, torch.where(lead, lc, fc), torch.zeros_like(lc))
    round_out = _round_out(family, loads)
    bump = OFFLINE_BUMP_BF16 if round_out else OFFLINE_BUMP_F32
    sev = bt[0][rb]
    if family in (KEY_CAPACITY, KEY_POT_NW_OUT):
        load = eff if family == KEY_CAPACITY else lc
        movable = valid & (sev > 0) & ((load > 0) | offl)
        key = torch.where(movable, load, neg)
        key = torch.where(offl, key + bump, key)
    elif family in (KEY_LEAD_DELTA, KEY_LEAD_LOAD):
        val = lc - fc if family == KEY_LEAD_DELTA else lc
        ok = valid & lead & (sev > sc[0]) & (val > 0) & ~off
        key = torch.where(ok, val, neg)
    elif family == KEY_DIST:
        util = bt[1][rb]
        excess = sev > sc[0]
        donor = (util - eff) >= bt[2][rb]
        fits = eff <= sc[2]
        movable = valid & (eff > 0) & fits & (excess | ((sc[1] != 0) & donor))
        frac = eff / torch.clamp(util, min=1e-9)
        key = torch.where(movable | offl, frac, neg)
        key = torch.where(offl, key + bump, key)
    elif family == KEY_SWAP_OUT:
        key = torch.where(valid & (sev > 0) & ~off, eff, neg)
    elif family == KEY_SWAP_IN:
        key = torch.where(valid & (sev <= 0) & ~off, -eff, neg)
    elif family in (KEY_INTRA_CAPACITY, KEY_INTRA_USAGE):
        D = dt.shape[2]
        i = rb * D + torch.clamp(rdisk, min=0)
        flat = dt.reshape(dt.shape[0], -1)
        load = torch.where(lead, lc, fc)
        if family == KEY_INTRA_CAPACITY:
            balive = sev != 0
            over = flat[0][i] > flat[1][i]
            dead = valid & balive & (flat[2][i] != 0)
            key = torch.where(valid & balive & (over | dead), load, neg)
            key = torch.where(dead, key + bump, key)
        else:
            donor = flat[0][i] > bt[1][rb]
            key = torch.where(valid & (sev > 0) & donor & (load > 0), load, neg)
    else:
        raise ValueError(f"replica_keys: unknown family {family}")
    return key.to(torch.bfloat16).float() if round_out else key


_SIGNATURES = {"cc_replica_keys": [I] * 8 + [ctypes.c_float] + [P] * 12,
               "cc_replica_keys_lanes": [I, P] + [I] * 11 + [ctypes.c_float] + [P] * 12}


def replica_keys(family: int, loads, col: int, rb, lead, off, valid, bt, sc,
                 rdisk=None, dt=None) -> torch.Tensor:
    """f32[R] candidate keys of one family (see the module doc).
    ``loads`` = (leader, follower) [R, M], both f32 or both bf16; ``rb``
    i64[R]; ``lead`` / ``off`` / ``valid`` bool[R]; ``bt`` f32[n, B] (row 0
    the severity or the excess the family tests); ``sc`` f32[3]; the intra
    families also ``rdisk`` i64[R] and ``dt`` f32[3, B, D]."""
    if not rb.is_cuda:
        return replica_keys_plain(family, loads, col, rb, lead, off, valid, bt, sc,
                                  rdisk, dt)
    L, F = loads
    R, M = L.shape
    B = bt.shape[1]
    intra = family in (KEY_INTRA_CAPACITY, KEY_INTRA_USAGE)
    if not (0 <= family < len(FAMILY_NAMES) and 0 < R and 0 <= col < M
            and L.dtype in (torch.float32, torch.bfloat16)):
        raise ValueError(f"replica_keys: unsupported family={family} R={R} "
                         f"col={col} dtype={L.dtype}")
    tensors = [L, F, rb, lead, off, valid, bt, sc] + ([rdisk, dt] if intra else [])
    dts = ([L.dtype, L.dtype, torch.int64] + [torch.bool] * 3
           + [torch.float32] * 2 + ([torch.int64, torch.float32] if intra else []))
    for t, dt_ in zip(tensors, dts):
        if t.dtype != dt_ or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("replica_keys: wrong dtype, layout or device")
    if F.shape != L.shape or rb.shape[0] != R or sc.shape[0] < 3:
        raise ValueError("replica_keys: mismatched shapes")
    D = dt.shape[2] if intra else 0
    round_out = _round_out(family, loads)
    out = torch.empty(R, dtype=torch.float32, device=rb.device)
    err = library("replica_keys", _SIGNATURES).cc_replica_keys(
        R, M, col, family, int(L.dtype == torch.bfloat16), int(round_out), B, D,
        OFFLINE_BUMP_BF16 if round_out else OFFLINE_BUMP_F32,
        ptr(L), ptr(F), ptr(rb), ptr(lead), ptr(off), ptr(valid), ptr(bt), ptr(sc),
        ptr(rdisk if intra else None), ptr(dt if intra else None), ptr(out),
        stream_ptr())
    check(err, "replica_keys")
    dtype = "bf16" if L.dtype == torch.bfloat16 else "f32"
    KERNEL.count(f"R={R} {dtype}")
    fam = f"{FAMILY_NAMES[family]} {dtype}"
    KEY_FAMILY_LAUNCHES[fam] = KEY_FAMILY_LAUNCHES.get(fam, 0) + 1
    return out


def replica_keys_lanes_plain(family, loads, col, rb, lead, off, valid, lanes, bt, sc,
                             rdisk=None, dt=None) -> torch.Tensor:
    return torch.stack([
        replica_keys_plain(family, (loads[0][l], loads[1][l]), col, rb[l], lead[l],
                           off[l], valid[l], bt[j], sc[j],
                           None if rdisk is None else rdisk[l],
                           None if dt is None else dt[j])
        for j, l in enumerate(lanes)])


def replica_keys_lanes(family: int, loads, col: int, rb, lead, off, valid, lanes: list,
                       bt, sc, rdisk=None, dt=None) -> torch.Tensor:
    """f32[La, R]: ``replica_keys`` of the lanes ``lanes`` of a lane stack.
    ``loads`` = (leader, follower) [L, R, M]; ``rb`` / ``lead`` / ``off`` /
    ``valid`` (and ``rdisk``) [L, R]; ``bt`` f32[La, n, B], ``sc`` f32[La, 3]
    (and ``dt`` f32[La, n, B, D]) one row per entry of ``lanes``."""
    if not rb.is_cuda:
        return replica_keys_lanes_plain(family, loads, col, rb, lead, off, valid, lanes,
                                        bt, sc, rdisk, dt)
    Lt, Ft = loads
    _L, R, M = Lt.shape
    La, nbt, B = bt.shape
    intra = family in (KEY_INTRA_CAPACITY, KEY_INTRA_USAGE)
    if not (0 <= family < len(FAMILY_NAMES) and 0 < R and 0 <= col < M
            and Lt.dtype in (torch.float32, torch.bfloat16) and La == len(lanes)
            and sc.shape[0] == La and sc.shape[1] >= 3):
        raise ValueError(f"replica_keys_lanes: unsupported family={family} R={R} "
                         f"col={col} dtype={Lt.dtype} lanes={len(lanes)}")
    tensors = [Lt, Ft, rb, lead, off, valid, bt, sc] + ([rdisk, dt] if intra else [])
    dts = ([Lt.dtype, Lt.dtype, torch.int64] + [torch.bool] * 3
           + [torch.float32] * 2 + ([torch.int64, torch.float32] if intra else []))
    for t, dt_ in zip(tensors, dts):
        if t.dtype != dt_ or not t.is_contiguous() or not t.is_cuda:
            raise ValueError("replica_keys_lanes: wrong dtype, layout or device")
    if Ft.shape != Lt.shape or tuple(rb.shape) != (_L, R):
        raise ValueError("replica_keys_lanes: mismatched shapes")
    D = dt.shape[3] if intra else 0
    ndt = dt.shape[1] if intra else 0
    round_out = _round_out(family, loads)
    lanes_t = lane_index(lanes, rb.device)
    out = torch.empty((La, R), dtype=torch.float32, device=rb.device)
    err = library("replica_keys", _SIGNATURES).cc_replica_keys_lanes(
        La, ptr(lanes_t), R, M, col, family, int(Lt.dtype == torch.bfloat16),
        int(round_out), B, D, nbt, sc.shape[1], ndt,
        OFFLINE_BUMP_BF16 if round_out else OFFLINE_BUMP_F32,
        ptr(Lt), ptr(Ft), ptr(rb), ptr(lead), ptr(off), ptr(valid), ptr(bt), ptr(sc),
        ptr(rdisk if intra else None), ptr(dt if intra else None), ptr(out),
        stream_ptr())
    check(err, "replica_keys_lanes")
    dtype = "bf16" if Lt.dtype == torch.bfloat16 else "f32"
    KERNEL_LANES.count(f"L={La} R={R} {dtype}")
    return out
