"""PreferredLeaderElectionGoal (counterpart of
``cruise_control_tpu/analyzer/goals/leader_election.py``).

Reference: analyzer/goals/PreferredLeaderElectionGoal.java:216. Not a search
goal: it transfers the leadership of every partition to its preferred
replica when that replica is eligible, in one pass (the K12 kernel
``kernels.ple.preferred_leader``, then ``state.refresh``). With no demoted
broker only the position-0 replica is considered; while a demotion is in
progress, demoted replicas sort last and the first eligible replica wins
(PreferredLeaderElectionGoal.java:108-152).
"""
from __future__ import annotations

import dataclasses

import torch

from cruise_control_tpu_torch.analyzer.env import ClusterEnv
from cruise_control_tpu_torch.analyzer.goals.base import GoalKernel
from cruise_control_tpu_torch.analyzer.state import EngineState, refresh
from cruise_control_tpu_torch.kernels import ple as ple_k


def _ple_args(env: ClusterEnv, st: EngineState) -> tuple:
    return (env.partition_replicas, st.replica_broker, st.replica_is_leader,
            st.replica_offline, env.broker_alive, env.broker_excluded_for_leadership,
            env.broker_demoted, st.leadership_moved)


@dataclasses.dataclass(frozen=True)
class PreferredLeaderElectionGoal(GoalKernel):
    def __post_init__(self):
        object.__setattr__(self, "name", "PreferredLeaderElectionGoal")
        object.__setattr__(self, "uses_replica_moves", False)

    def broker_severity(self, env: ClusterEnv, st: EngineState):
        return torch.zeros(env.num_brokers, dtype=torch.float32, device=env.device)

    def _preferred_leader(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """i64[P]: the replica leadership should land on, -1 for no change."""
        return ple_k.preferred_leader_plain(*_ple_args(env, st)[:7])[0]

    def _current_leader(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        """i64[P]: the first replica flagged leader, -1 for none."""
        return ple_k.preferred_leader_plain(*_ple_args(env, st)[:7])[1]

    def violated(self, env: ClusterEnv, st: EngineState) -> torch.Tensor:
        # topic exclusion is intentionally ignored: this goal moves no
        # partitions (PreferredLeaderElectionGoal.java:109)
        return ple_k.preferred_leader(*_ple_args(env, st), apply=False)[2] > 0

    def run(self, env: ClusterEnv, st: EngineState):
        """``optimizer._compiled_ple``: (violated before, the state after the
        flips and a refresh, violated after), the verdicts as device bools."""
        lead, moved, n_before = ple_k.preferred_leader(*_ple_args(env, st), apply=True)
        st = refresh(env, dataclasses.replace(st, replica_is_leader=lead,
                                              leadership_moved=moved))
        return n_before > 0, st, self.violated(env, st)

    def apply(self, env: ClusterEnv, st: EngineState) -> EngineState:
        """One shot: flip leadership to the preferred replica everywhere legal."""
        return self.run(env, st)[1]
