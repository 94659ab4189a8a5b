from cruise_control_tpu_torch.analyzer.engine import EngineParams, optimize_goal
from cruise_control_tpu_torch.analyzer.env import (
    BalancingConstraint, ClusterEnv, OptimizationOptions, make_env,
)
from cruise_control_tpu_torch.analyzer.optimizer import (
    GoalOptimizer, OptimizationFailureError, OptimizerResult,
)
from cruise_control_tpu_torch.analyzer.state import EngineState, init_state, refresh

__all__ = [
    "BalancingConstraint", "ClusterEnv", "OptimizationOptions", "make_env",
    "EngineParams", "optimize_goal", "EngineState", "init_state", "refresh",
    "GoalOptimizer", "OptimizationFailureError", "OptimizerResult",
]
