"""K1 ``select_candidates``: stall-salted exact top-k candidate selection.

Replaces ``cruise_control_tpu/analyzer/engine.py`` ``_stall_explore`` (:123),
``_top_candidates`` (:166) and ``_select_candidates`` (:179) on the full-R
path (``compact_keying`` off). Order: descending key, lowest replica index
first among ties — ``lax.top_k``'s order on the CPU oracle, which compares
in total order (-0.0 < +0.0). Soft goals use ``approx_max_k`` in the
reference; on the CPU oracle it falls back to the same exact order (total
order included, checked with planted signed-zero ties at k > 8,192), so
hard and soft goals select alike.

CUDA kernel (``csrc/select_candidates.cu``), at most 7 CUDA launches a call
(the pooled form adds its 4 compaction launches): a memset of the lane's
counters; three histogram passes over the 32 sortable bits of the salted key
(12, 12 and 8 bits; the first salts each key, the uint32 hash of
engine.py:143-149, and keeps its bits; the last block of each pass to finish
chooses the digit, so no launch of its own), which find the k-th largest
value T; a gather of every row above T and of the first rows equal to T in
index order (each tile's count of them from the last pass); and a sort of the
k composites ``(sortable(key) << 32) | ~idx`` across many CTAs (chunks of 512
sorted in shared memory, then each composite placed by binary searches of
the other chunks). Bound: bytes (it reads the f32[R] keys once, its 4-byte
bits twice, and writes k results).

The plain twin sorts the same order-preserving integers with a stable
``torch.sort``; the hash runs in int64 masked to 32 bits.

A ``seed_mask`` (bool[R]: ``engine.py`` ``_mask_key`` :153, the K1 seed
mask of a reduced round's dirty-set seeding) sends the rows outside it to
-inf before salting; its launches also count on ``select_candidates_masked``.

``select_candidates_lanes`` is the fleet's lane form (K14: ``vmap`` of
``_select_candidates`` over the tenant axis, optimizer.py
``_compiled_fleet_chain`` :2563): L keys [L, R], one stall per lane, one
seed-mask row per lane, in ONE launch sequence (grid dimension y = lane);
each lane's output is its solo launch's, bit for bit. Its twin is a loop of
the solo twin over the lanes.

``select_pooled`` is the pooled keying (``compact_keying``: engine.py
``_select_candidates`` :179-225); ``select_candidates`` and its lane form
take it when given ``compact_pool`` and the pool is below R, the one place
that decides. With ``pool = min(R, max(compact_pool, 2k)) < R`` the same
library compacts the eligible rows (key > -inf after
the seed mask) and counts them on the device, and the selection chooses
its branch there from the count, as the reference's ``lax.cond`` does: the
pool when the count fits it (the salt hashes each row's original id, so
every live row comes out as the full sweep orders it; pad slots come out
as kv -inf and id R - 1, the reference's ``min(order, R - 1)``), else the
full sweep. No host read: each lane of ``select_pooled_lanes`` chooses for
itself. A device counter per branch (``pool_branch_counts``) records what
each selection chose; read it once, at the end of a run. The twin is the
reference's pooled body in plain torch, its branch chosen on the host.

``compact_eligible`` (engine.py ``_compact_eligible`` :1257) compacts the
true entries of a bool[R] into index order for the exhaustive scans, in
the same library (``csrc/select_candidates.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from cruise_control_tpu_torch.kernels.build import (
    IP, LL, I, P, check, host_ints, library, ptr, register, stream_ptr,
)

KERNEL = register("select_candidates",
                  "cruise_control_tpu_torch/kernels/csrc/select_candidates.cu",
                  "cruise_control_tpu/analyzer/engine.py:179")
KERNEL_MASKED = register("select_candidates_masked",
                         "cruise_control_tpu_torch/kernels/csrc/select_candidates.cu",
                         "cruise_control_tpu/analyzer/engine.py:153")
KERNEL_LANES = register("select_candidates_lanes",
                        "cruise_control_tpu_torch/kernels/csrc/select_candidates.cu",
                        "cruise_control_tpu/analyzer/optimizer.py:2563")
KERNEL_POOLED = register("select_pooled",
                         "cruise_control_tpu_torch/kernels/csrc/select_candidates.cu",
                         "cruise_control_tpu/analyzer/engine.py:179")
KERNEL_POOLED_LANES = register("select_pooled_lanes",
                               "cruise_control_tpu_torch/kernels/csrc/select_candidates.cu",
                               "cruise_control_tpu/analyzer/optimizer.py:2563")
KERNEL_COMPACT = register("compact_eligible",
                          "cruise_control_tpu_torch/kernels/csrc/select_candidates.cu",
                          "cruise_control_tpu/analyzer/engine.py:1257")
MAX_K = 16384
_M32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def stall_salt_plain(key: torch.Tensor, stall: int, salt: int = 0,
                     idx: torch.Tensor | None = None) -> torch.Tensor:
    """``_stall_explore``: on a stalled pass (``stall > 0``) re-key eligible
    rows by a (replica, stall, salt) hash in [0, 1), +2.0 for offline-healing
    keys (>= 5e11); ineligible rows stay -inf. ``idx``: the rows' original
    replica ids (a compacted pool's), None: their positions."""
    if stall <= 0:
        return key
    if idx is None:
        idx = torch.arange(key.shape[0], dtype=torch.int64, device=key.device)
    h = (mul32(idx, 2246822519)
         + ((((stall + salt) & _M32) * 3266489917) & _M32)) & _M32
    h = mul32(h ^ (h >> 15), 2654435761)
    r01 = (h >> 8).to(torch.float32) / 16777216.0
    bump = torch.where(key >= 5e11, 2.0, 0.0)
    return torch.where(key > -torch.inf, r01 + bump,
                       torch.full_like(key, -torch.inf))


def sortable_key(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) ordered like the f32 values in total order."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where(u >= 0x80000000, (~u) & _M32, u | 0x80000000)


def mask_key_plain(key: torch.Tensor, seed_mask: torch.Tensor | None) -> torch.Tensor:
    """``_mask_key``: rows outside ``seed_mask`` read -inf (None: all rows)."""
    if seed_mask is None:
        return key
    return torch.where(seed_mask, key, torch.full_like(key, -torch.inf))


def select_candidates_plain(key, k, stall, salt=0, seed_mask=None):
    salted = stall_salt_plain(mask_key_plain(key, seed_mask), stall, salt)
    order = torch.sort(sortable_key(salted), descending=True, stable=True)[1][:k]
    return salted[order], order


_SIGNATURES = {"cc_select_candidates": [P, P, I, I, I, I, P, LL, P, P, IP, P],
               "cc_select_candidates_lanes": [P, P, I, I, I, P, I, P, LL, P, P, IP, P],
               "cc_select_pooled": [P, P, I, I, I, I, I, P, I, P, P, P, P, LL, P, P, P, IP,
                                    P],
               "cc_compact_eligible": [P, I, I, P, P, P, P]}


def ws_words(L: int, n: int, k: int) -> int:
    """int32 words of a selection's workspace (``csrc/select_candidates.cu``
    ``ws_words``, which refuses a smaller one): per lane the three
    histograms and the counters, the salted bits of every row, the last
    pass's 256-bin histogram of each 2,048-row tile, and the k selected and
    k sorted 64-bit composites."""
    return (L * (2 * 4096 + 256 + 8) + ((L * n + 1) & ~1) + L * -(-n // 2048) * 256
            + 4 * L * k)


def _selection(L: int, n: int, k: int, dev):
    """(workspace, kv f32[L, k], idx i64[L, k], the CUDA launch count the
    entry point writes) of one launch."""
    return (torch.empty(ws_words(L, n, k), dtype=torch.int32, device=dev),
            torch.empty((L, k), dtype=torch.float32, device=dev),
            torch.empty((L, k), dtype=torch.int64, device=dev), ctypes.c_int(0))


def select_candidates(key: torch.Tensor, k: int, stall: int, salt: int = 0,
                      seed_mask: torch.Tensor | None = None,
                      compact_pool: int | None = None):
    """(kv f32[k], cand i64[k]) of the stall-salted key, k = min(k, R); rows
    outside ``seed_mask`` (bool[R], None: every row) read -inf.
    ``compact_pool``: the pooled keying's pool floor (``compact_keying``
    on): ``select_pooled`` when its pool is below R; None: the full sweep."""
    k = min(int(k), key.shape[0])
    pool = _pool_below(key.shape[0], k, compact_pool)
    if pool is not None:
        return select_pooled(key, k, stall, salt, seed_mask, pool)
    if not key.is_cuda:
        return select_candidates_plain(key, k, stall, salt, seed_mask)
    if key.dtype != torch.float32 or not key.is_contiguous() or key.dim() != 1:
        raise ValueError("select_candidates takes a contiguous f32[R] key")
    if seed_mask is not None and (seed_mask.dtype != torch.bool
                                  or tuple(seed_mask.shape) != tuple(key.shape)
                                  or not seed_mask.is_contiguous()
                                  or seed_mask.device != key.device):
        raise ValueError("select_candidates takes a contiguous bool[R] seed mask")
    if not 0 < k <= MAX_K:
        raise ValueError(f"select_candidates supports 0 < k <= {MAX_K}, got {k}")
    n = key.shape[0]
    ws, kv, idx, launches = _selection(1, n, k, key.device)
    err = library("select_candidates", _SIGNATURES).cc_select_candidates(
        ptr(key), ptr(seed_mask), n, k, int(stall), int(salt), ptr(ws), ws.numel(),
        ptr(kv), ptr(idx), ctypes.byref(launches), stream_ptr())
    check(err, "select_candidates")
    KERNEL.count(f"k={k}", launches.value)
    if seed_mask is not None:
        KERNEL_MASKED.count(f"k={k}", launches.value)
    return kv[0], idx[0]


def select_candidates_lanes_plain(key, k, stalls, salt=0, seed_mask=None):
    outs = [select_candidates_plain(key[j], k, int(stalls[j]), salt,
                                    None if seed_mask is None else seed_mask[j])
            for j in range(key.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def select_candidates_lanes(key: torch.Tensor, k: int, stalls, salt: int = 0,
                            seed_mask: torch.Tensor | None = None,
                            compact_pool: int | None = None):
    """(kv f32[L, k], cand i64[L, k]): ``select_candidates`` of every row of
    ``key`` f32[L, R] with lane j's stall ``stalls[j]`` and seed-mask row j
    (``seed_mask`` bool[L, R], None: every row of every lane); with
    ``compact_pool``, ``select_pooled_lanes`` when its pool is below R."""
    L, n = key.shape
    k = min(int(k), n)
    pool = _pool_below(n, k, compact_pool)
    if pool is not None:
        return select_pooled_lanes(key, k, stalls, salt, seed_mask, pool)
    if len(stalls) != L:
        raise ValueError("select_candidates_lanes takes one stall per lane")
    if not key.is_cuda:
        return select_candidates_lanes_plain(key, k, stalls, salt, seed_mask)
    if key.dtype != torch.float32 or not key.is_contiguous():
        raise ValueError("select_candidates_lanes takes a contiguous f32[L, R] key")
    if seed_mask is not None and (seed_mask.dtype != torch.bool
                                  or tuple(seed_mask.shape) != (L, n)
                                  or not seed_mask.is_contiguous()
                                  or seed_mask.device != key.device):
        raise ValueError("select_candidates_lanes takes a contiguous bool[L, R] "
                         "seed mask")
    if not 0 < k <= MAX_K:
        raise ValueError(f"select_candidates_lanes supports 0 < k <= {MAX_K}, got {k}")
    st = host_ints(stalls, key.device, torch.int32)
    ws, kv, idx, launches = _selection(L, n, k, key.device)
    err = library("select_candidates", _SIGNATURES).cc_select_candidates_lanes(
        ptr(key), ptr(seed_mask), L, n, k, ptr(st), int(salt), ptr(ws), ws.numel(),
        ptr(kv), ptr(idx), ctypes.byref(launches), stream_ptr())
    check(err, "select_candidates_lanes")
    KERNEL_LANES.count(f"L={L} k={k}", launches.value)
    return kv, idx


# selections per branch (pooled, full) since the last reset: a device
# counter per CUDA device, a host tally for the plain twin on the CPU
_BRANCH: dict = {}
_HOST_BRANCH = [0, 0]


def _branch_counter(dev) -> torch.Tensor:
    t = _BRANCH.get(dev)
    if t is None:
        t = _BRANCH[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return t


def reset_pool_branches() -> None:
    """Zero the branch counters (no host read)."""
    for t in _BRANCH.values():
        t.zero_()
    _HOST_BRANCH[0] = _HOST_BRANCH[1] = 0


def pool_branch_counts() -> dict:
    """{"pooled": n, "full": n}: the pooled selections since the last
    reset, by the branch each took (one device read per CUDA device)."""
    pooled, full = _HOST_BRANCH
    for t in _BRANCH.values():
        p, f = t.tolist()
        pooled, full = pooled + p, full + f
    return {"pooled": pooled, "full": full}


def pool_size(R: int, k: int, compact_pool: int) -> int:
    """engine.py:199: the pooled keying's pool, ``min(R, max(compact_pool,
    2k))`` with ``k = min(k, R)``; the pool is used only below R."""
    return min(R, max(int(compact_pool), 2 * min(int(k), R)))


def _pool_below(R: int, k: int, compact_pool: int | None) -> int | None:
    """The pooled keying's pool when ``compact_pool`` is set and the pool is
    below R (engine.py:199-200), else None (the full sweep)."""
    if compact_pool is None:
        return None
    pool = pool_size(R, k, compact_pool)
    return pool if pool < R else None


def _tally_plain(key, seed_mask, pool) -> None:
    """The host tally of the branch a selection on the CPU takes."""
    n = int((mask_key_plain(key, seed_mask) > -torch.inf).sum())
    _HOST_BRANCH[0 if n <= pool else 1] += 1


def select_pooled_plain(key, k, stall, salt=0, seed_mask=None, pool=8192):
    """The reference's pooled branch (engine.py:205-214) when the eligible
    count fits ``pool``, else its full sweep."""
    R = key.shape[0]
    key = mask_key_plain(key, seed_mask)
    elig = key > -torch.inf
    n = int(elig.sum())
    if n > pool:
        return select_candidates_plain(key, k, stall, salt)
    order = torch.full((pool,), R, dtype=torch.int64, device=key.device)
    order[:n] = torch.nonzero(elig).flatten()
    idx = torch.clamp(order, max=R - 1)
    kcol = torch.where(order < R, key[idx], torch.full_like(key[idx], -torch.inf))
    salted = stall_salt_plain(kcol, stall, salt, idx)
    pos = torch.sort(sortable_key(salted), descending=True, stable=True)[1][:k]
    return salted[pos], idx[pos]


def _pooled_launch(key, mask, L, n, k, pool, stall0, stalls, salt, what):
    dev = key.device
    if not 0 < 2 * k <= pool < n or k > MAX_K:
        raise ValueError(f"{what}: needs 0 < 2k <= pool < R and k <= {MAX_K}, got "
                         f"k={k} pool={pool} R={n}")
    nb = -(-n // 1024)
    counts = torch.empty((L, nb), dtype=torch.int32, device=dev)
    order = torch.empty((L, n), dtype=torch.int64, device=dev)
    elig_n = torch.empty(L, dtype=torch.int64, device=dev)
    ws, kv, idx, launches = _selection(L, n, k, dev)
    err = library("select_candidates", _SIGNATURES).cc_select_pooled(
        ptr(key), ptr(mask), L, n, k, int(pool), int(stall0), ptr(stalls), int(salt),
        ptr(counts), ptr(order), ptr(elig_n), ptr(ws), ws.numel(), ptr(kv), ptr(idx),
        ptr(_branch_counter(dev)), ctypes.byref(launches), stream_ptr())
    check(err, what)
    return kv, idx, launches.value


def select_pooled(key: torch.Tensor, k: int, stall: int, salt: int = 0,
                  seed_mask: torch.Tensor | None = None, pool: int = 8192):
    """(kv f32[k], cand i64[k]): the pooled keying of the stall-salted key
    (``pool`` < R, ``2k <= pool``): bit for bit ``select_candidates`` on
    every live row, pad slots (-inf, R - 1) when the pool was taken."""
    k = min(int(k), key.shape[0])
    if not key.is_cuda:
        _tally_plain(key, seed_mask, pool)
        return select_pooled_plain(key, k, stall, salt, seed_mask, pool)
    if key.dtype != torch.float32 or not key.is_contiguous() or key.dim() != 1:
        raise ValueError("select_pooled takes a contiguous f32[R] key")
    if seed_mask is not None and (seed_mask.dtype != torch.bool
                                  or tuple(seed_mask.shape) != tuple(key.shape)
                                  or not seed_mask.is_contiguous()
                                  or seed_mask.device != key.device):
        raise ValueError("select_pooled takes a contiguous bool[R] seed mask")
    kv, idx, launches = _pooled_launch(key, seed_mask, 1, key.shape[0], k, pool, stall,
                                       None, salt, "select_pooled")
    KERNEL_POOLED.count(f"k={k} pool={pool}", launches)
    return kv[0], idx[0]


def select_pooled_lanes_plain(key, k, stalls, salt=0, seed_mask=None, pool=8192):
    outs = [select_pooled_plain(key[j], k, int(stalls[j]), salt,
                                None if seed_mask is None else seed_mask[j], pool)
            for j in range(key.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def select_pooled_lanes(key: torch.Tensor, k: int, stalls, salt: int = 0,
                        seed_mask: torch.Tensor | None = None, pool: int = 8192):
    """(kv f32[L, k], cand i64[L, k]): ``select_pooled`` of every row of
    ``key`` f32[L, R], lane j with stall ``stalls[j]`` and seed-mask row j;
    each lane takes its own branch on the device."""
    L, n = key.shape
    k = min(int(k), n)
    if len(stalls) != L:
        raise ValueError("select_pooled_lanes takes one stall per lane")
    if not key.is_cuda:
        for j in range(L):
            _tally_plain(key[j], None if seed_mask is None else seed_mask[j], pool)
        return select_pooled_lanes_plain(key, k, stalls, salt, seed_mask, pool)
    if key.dtype != torch.float32 or not key.is_contiguous():
        raise ValueError("select_pooled_lanes takes a contiguous f32[L, R] key")
    if seed_mask is not None and (seed_mask.dtype != torch.bool
                                  or tuple(seed_mask.shape) != (L, n)
                                  or not seed_mask.is_contiguous()
                                  or seed_mask.device != key.device):
        raise ValueError("select_pooled_lanes takes a contiguous bool[L, R] seed mask")
    st = host_ints(stalls, key.device, torch.int32)
    kv, idx, launches = _pooled_launch(key, seed_mask, L, n, k, pool, 0, st, salt,
                                       "select_pooled_lanes")
    KERNEL_POOLED_LANES.count(f"L={L} k={k} pool={pool}", launches)
    return kv, idx


def compact_eligible_plain(eligible: torch.Tensor, pad_len: int):
    n = eligible.shape[0]
    idx = torch.nonzero(eligible).flatten()
    order = torch.full((pad_len,), n, dtype=torch.int64, device=eligible.device)
    order[:idx.shape[0]] = idx
    return order, eligible.sum()


def compact_eligible(eligible: torch.Tensor, pad_len: int):
    """(order i64[pad_len], count i64 0-d): indices of the true entries of
    ``eligible`` bool[n] in index order, padded with the sentinel n."""
    if not eligible.is_cuda:
        return compact_eligible_plain(eligible, pad_len)
    n = eligible.shape[0]
    if (eligible.dtype != torch.bool or not eligible.is_contiguous()
            or not 0 < n <= pad_len):
        raise ValueError("compact_eligible takes a contiguous bool[n], n <= pad_len")
    dev = eligible.device
    counts = torch.empty(-(-n // 1024), dtype=torch.int32, device=dev)
    order = torch.empty(pad_len, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    err = library("select_candidates", _SIGNATURES).cc_compact_eligible(
        ptr(eligible), n, int(pad_len), ptr(counts), ptr(order), ptr(total),
        stream_ptr())
    check(err, "compact_eligible")
    KERNEL_COMPACT.count(f"n={n}")
    return order, total
