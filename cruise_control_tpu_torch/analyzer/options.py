"""Pluggable OptimizationOptions generation (counterpart of
``cruise_control_tpu/analyzer/options.py``; reference
analyzer/OptimizationOptionsGenerator.java)."""
from __future__ import annotations

from cruise_control_tpu_torch.analyzer.env import OptimizationOptions


class DefaultOptimizationOptionsGenerator:
    """Passes through the options the caller built."""

    def configure(self, config) -> None:
        self._config = config

    def optimization_options(self, base: OptimizationOptions,
                             operation: str = "") -> OptimizationOptions:
        del operation
        return base
