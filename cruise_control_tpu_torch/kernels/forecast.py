"""K15 ``forecast``: the forecaster's masked Holt / EWMA scan.

Replaces ``cruise_control_tpu/forecast/forecaster.py`` ``forecast_batch``
(:87), the vmap of ``_holt_ewma_series`` (:59) over entities and metrics:
``f32[E, W, M]`` window values and a ``bool[E, W]`` valid-window mask ->
``f32[E, M]``, the blended forecast ``horizon_w`` windows ahead, clamped at
0 (0 for a series with no valid window).

CUDA kernel (``csrc/forecast.cu``): one thread per (entity, metric) series,
looping over W with the carry in registers. The plain twin loops over W with
torch ops on ``[E, M]``, in the same order of operations; the knobs are f32
scalars, as the reference traces them. Bound: bytes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from cruise_control_tpu_torch.kernels.build import (
    I, P, check, library, ptr, register, stream_ptr,
)

KERNEL = register("forecast", "cruise_control_tpu_torch/kernels/csrc/forecast.cu",
                  "cruise_control_tpu/forecast/forecaster.py:59")

F = ctypes.c_float
_SIGNATURES = {"cc_forecast": [P, P, I, I, I, F, F, F, F, P, P]}


def _knob(v) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the exact
    product in f64, the sum's rounding error by TwoSum, and the f64 -> f32
    rounding corrected where the f64 sum landed on a midpoint of two f32s."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()                 # exact: 24 + 24 bits
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)           # p + c == s + err exactly
    r = s.float()
    r64 = r.double()
    toward = torch.where(s > r64, torch.full_like(r, torch.inf),
                         torch.full_like(r, -torch.inf))
    n = torch.nextafter(r, toward)
    mid = (r64 != s) & ((r64 + n.double()) * 0.5 == s) & (err != 0)
    # on a midpoint the exact value lies on err's side of s
    pick_n = mid & ((err > 0) == (n.double() > s))
    return torch.where(pick_n, n, r)


def forecast_plain(values: torch.Tensor, wmask: torch.Tensor, alpha, beta, blend,
                   horizon_w) -> torch.Tensor:
    """The reference's XLA:CPU program contracts five multiply-adds into
    FMAs (found by experiment against its compiled program): the level's
    and the EWMA's ``alpha * x``, the trend's ``(1 - beta) * trend``,
    ``horizon_w * trend`` and the blend's ``blend * (...)`` (at W = 1 its
    ``(1 - blend) * ewma``). The CUDA kernel places ``__fmaf_rn`` at the
    same five points."""
    dev = values.device
    a, b, bl, hw = (_knob(v).to(dev) for v in (alpha, beta, blend, horizon_w))
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    oa, ob, obl = one - a, one - b, one - bl
    E, W, M = values.shape
    level = torch.zeros((E, M), dtype=torch.float32, device=dev)
    trend = torch.zeros_like(level)
    ewma = torch.zeros_like(level)
    seen = torch.zeros((E, M), dtype=torch.bool, device=dev)
    for w in range(W):
        x = values[:, w, :]
        m = wmask[:, w, None].expand(E, M)
        lvl_s = fma_f32(a, x, oa * (level + trend))
        trd_s = fma_f32(ob, trend, b * (lvl_s - level))
        ew_s = fma_f32(a, x, oa * ewma)
        new_level = torch.where(seen, lvl_s, x)
        new_trend = torch.where(seen, trd_s, zero)
        new_ewma = torch.where(seen, ew_s, x)
        level = torch.where(m, new_level, level)
        trend = torch.where(m, new_trend, trend)
        ewma = torch.where(m, new_ewma, ewma)
        seen = seen | m
    inner = fma_f32(hw, trend, level)
    if W == 1:
        # a one-window program (its scan unrolled) contracts the blend's
        # other product instead; the forecaster itself never asks W < 2
        fc = fma_f32(obl, ewma, bl * inner)
    else:
        fc = fma_f32(bl, inner, obl * ewma)
    return torch.where(seen, torch.maximum(fc, zero), zero)


def forecast_batch(values: torch.Tensor, wmask: torch.Tensor, alpha, beta, blend,
                   horizon_w) -> torch.Tensor:
    """f32[E, M] forecast of ``values`` f32[E, W, M] under ``wmask``
    bool[E, W]; the four knobs are Python or numpy scalars, used as f32."""
    if not values.is_cuda:
        return forecast_plain(values, wmask, alpha, beta, blend, horizon_w)
    E, W, M = values.shape
    if (values.dtype != torch.float32 or not values.is_contiguous()
            or wmask.dtype != torch.bool or tuple(wmask.shape) != (E, W)
            or not wmask.is_contiguous() or not wmask.is_cuda):
        raise ValueError("forecast: wrong dtype, shape, layout or device")
    out = torch.empty((E, M), dtype=torch.float32, device=values.device)
    err = library("forecast", _SIGNATURES).cc_forecast(
        ptr(values), ptr(wmask), E, W, M, F(np.float32(alpha)), F(np.float32(beta)),
        F(np.float32(blend)), F(np.float32(horizon_w)), ptr(out), stream_ptr())
    check(err, "forecast")
    KERNEL.count(f"E={E} W={W} M={M}")
    return out
