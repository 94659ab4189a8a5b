"""cruise_control_tpu_torch — the PyTorch / CUDA port of ``cruise_control_tpu``.

The JAX package beside this one is the reference: every module here keeps
its counterpart's path and names, and the tests hold each one against it.
This package imports ``torch`` and numpy, never ``jax``, and nothing of the
JAX package.

Layout (the slice ported so far):

- ``common``    — Resource taxonomy (own copy)
- ``model``     — ClusterTensor / ClusterMeta as host numpy, the builder,
                  the random-cluster generators, shape bucketing
- ``analyzer``  — env, engine state, the sixteen default goal kernels, the
                  budgeted pass loop (move, leadership and swap branches,
                  the finisher) and ``GoalOptimizer.optimizations``
- ``kernels``   — the hand-written CUDA kernels (``csrc/``) with their
                  plain PyTorch twins and launch counters
- ``convert``   — carries a reference env/state (as numpy leaves) over

Every entry point takes an explicit ``device``. The default is ``"cuda"``;
asking for it without a card raises instead of falling back to the CPU.
"""

__version__ = "0.1.0"
