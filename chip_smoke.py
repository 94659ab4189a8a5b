#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``cruise_control_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile [PATH ...]]

Phases, each printing its own lines; any failure exits non-zero:

1. device: requires CUDA, prints ``nvidia-smi`` name and power limit;
2. build: compiles every hand-written kernel from
   ``cruise_control_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, all
   started together) and prints the build seconds;
3. kernel checks: every kernel against its plain PyTorch twin on the card,
   at the slices' shapes (the move-branch passes, the leadership branch
   with its selection, admission and transfer apply, the exhaustive scans
   and the segment-parallel finisher waves, the swap passes of the five
   swap goals with their admission and two-leg apply, the usage and
   topic-replica score families and vetoes, the rack-distribution family
   and the rack-limit veto of K2 and K7 on the slice state, on the slice
   cluster remapped to 2 racks (limit 2) and on adversarial limits 0-3),
   on inputs taken from the slice cluster's state and on adversarial
   inputs made from ``--seed`` (planted ties, -inf rows, signed zeros). Ints, indices and
   bools must match exactly; floats must match bit for bit (stated
   tolerance 0 for every kernel). Each kernel, its twin and the nearest
   single PyTorch call are timed with CUDA events (median of 20);
4. small parity: the five-goal chain on the 32-broker spec, the
   eleven-goal chain (the default goals minus the swap goals) and the
   sixteen default goals on the 32-broker spec and the 64-broker,
   padded-R 12,288 spec (chunked dispatch and finisher; the sixteen
   goals' swap windows) run on the card and on the CPU (plain twins) and
   must give the same bits and the JAX reference's outcome counts; the
   JBOD specs (four logdirs per broker, a dead broker, two dead disks) at
   32 brokers (unfused) and 64 brokers (chunked) with the intra-broker
   chain and the ten-goal self-healing chain likewise; the 18-goal chain of
   the Java parity matrix (``FULL_CHAIN``) on the 16-broker fixture, the
   rack-distribution chain on the 32-broker spec remapped to 2 racks
   (spec-32b-2r, limit 2) and the kafka-assigner chain on the 32-broker
   spec likewise; and
   ``__graft_entry__.entry()``'s run (DiskUsageDistributionGoal,
   ``EngineParams(max_iters=64)``, the 16-broker fixture) on the card;
5. slices on the 1,000-broker / 98,326-replica ``generate_scale`` cluster,
   each run through ``GoalOptimizer`` with the kernel launch counts zeroed
   just before its first run and read just after it:
   a. the five move-branch goals (every kernel of that path must launch;
      the first slice's outcome), once;
   b. the eleven-goal chain: the fused prefix of nine goals, then the two
      leader goals chunked with the finisher (the JAX reference's outcome
      row, both leader goals proven fixpoints, the finisher's shapes), once;
   c. the sixteen default goals (the main path): the fused prefix of nine
      goals, then seven goals chunked with the finisher, the five swap
      goals with the swap branch (every kernel must launch, K7 at
      [32, 32]; the JAX reference's outcome row).
   c. runs once (phase 10's compact-keying run must give its final
   state bit for bit, the determinism check); every run must
   keep refresh-consistent tallies and leave no partition with two
   replicas on one broker;
   c2. the 18-goal chain of the Java parity matrix (the sixteen goals,
      RackAwareDistributionGoal after RackAwareGoal, TopicReplica last,
      then the preferred-leader pass), once, and the kafka-assigner chain
      (``kafka_assigner_goal_names([])``: the even rack-aware goal, then
      the swap-only disk goal), twice and bit identical, each the JAX
      reference's outcome row;
   d. the JBOD self-healing path on the 1,000-broker x 4-logdir cluster
      with 3 dead brokers and 7 dead-disk brokers (101,862 replicas, 492
      offline): the intra-broker chain (``rebalance_disk``), the ten-goal
      self-healing chain and the ``/demote_broker`` request
      (PreferredLeaderElectionGoal alone, five brokers demoted), each twice
      and bit identical, each the JAX reference's outcome row (the K8 and
      K12 kernels must launch), and the pass alone with nothing demoted
      once. ``--profile`` adds
   one more run of every path of this phase (or of the named ones: five,
   eleven, sixteen, eighteen, kafka, jbod_intra, jbod_chain, jbod_demote,
   jbod_ple, rung4, rung5, session, heal) under ``torch.profiler`` and
   prints device time by kernel;
   e. BASELINE configs 4 and 5 at full size (7,000 brokers, 500,000
      partitions: ``bench.py`` rungs 4 and 5) through ``GoalOptimizer()``'s
      defaults, where "auto" resolves to bf16: the sixteen default goals
      (rung 4) and the ten-goal JBOD self-heal with 20 dead brokers and 50
      dead-disk brokers (rung 5), rung 4 once and rung 5 twice and bit
      identical, and rung 4 once more pinned to f32. Each must give the JAX
      reference's row exactly, with its final float tallies' digests (the
      18-goal chain and rung 4 bf16 run once since fleet mode joined the
      smoke: phase 4 holds the card's bits against the CPU's).

6. the resident-session service rounds of the e2e-1000b-50000p cell
   (``bench.py`` ``run_e2e_rung``'s service cluster: 1,000 brokers on 20
   racks, 50,000 RF-2 partitions over 200 topics; the sixteen default
   goals) through ``SimulatedClusterBackend`` -> ``LoadMonitor`` ->
   ``ResidentClusterSession`` -> ``GoalOptimizer(config=...)
   .optimizations(None, session=...)``
   (``cruise_control_tpu_torch.analyzer.session_script``): a rebuild sync and
   a delta sync, R1 full, R2 the revalidation memo, R3 full after 8
   leadership flips; then the same script on a fresh session with
   ``analyzer.incremental.seed.dirty``, whose R3 is a reduced round (K1's
   seed mask). The launch counts are zeroed just before the two scripts and
   read just after. Every round must give the JAX reference's row (modes,
   verdicts, certificates, per-goal actions and passes, movements, proposals
   and their digest, final-state digests); the second script's R1 and R2
   must repeat the first's bit for bit; the reduced R3's one-sided verdict
   against the full R3 must be the reference's. Then K5 (``session_finalize``),
   K1's seed mask and K13 (``seeded_probe``) are held against their twins at
   the cell's padded R on the reduced round's inputs and timed. Sync walls
   (rebuild and delta) and round walls are printed; ``--profile session``
   profiles the plain script's R3.

7. the self-healing service at the same cell
   (``cruise_control_tpu_torch.analyzer.heal_script``): ``CruiseControl(
   device="cuda")`` over the cell's ``SimulatedClusterBackend`` with
   self-healing and forecasting on, its anomaly manager and executor driven
   synchronously on the simulated clock: (a) a broker failure, CHECK inside
   the grace ladder, then the FIX (``remove_brokers`` on the self-healing
   goals, executed to its end); (b) a dead disk, the FIX of its offline
   replicas on the resident session; (c) one topic's load ramped over the
   windows, K15's forecast, the PREDICTED verdict before any breach, the
   pre-breach heal and the speculative proposal install. The script runs
   once (twice before phase 9 joined); the launch counts are zeroed just
   before and read just after.
   Every step must give the JAX reference's row (``python
   tests/torch_reference.py heal-e2e``: handled anomalies and actions, the
   fixes' proposal counts and sha256, the executor's task census, the
   simulated clock, the backend assignment's sha256, the forecast's
   sha256). Detection, FIX and forecast walls
   and each executor run's simulated ms are printed.

8. fleet mode at the fleet-16x100b cell (``bench.py`` ``run_fleet_rung``'s
   tenants at BASELINE config 2's size: 16 tenants of 100 brokers on 4 racks
   with 5,000 RF-2 partitions, the sixteen default goals) through
   ``FleetScheduler(device="cuda").run_round``
   (``cruise_control_tpu_torch.fleet_script.fleet_e2e``): round 1 and round 2
   (one more window, delta syncs), the launch counts zeroed just before and
   read just after, every tenant's row the JAX reference's (``python
   tests/torch_reference.py fleet-e2e``); the solo rounds of tenants 0, 5,
   10 and 15 on the card (a cut of depth for phase 10), equal to their lanes; the
   engine's options on the lane path (one ``optimizations_batched`` round
   of the fleet's tenants with ``compact_keying`` and ``chain_cache=False``:
   the pooled K1's and K2's per-goal lane forms, each lane of tenants 0, 4,
   8 and 12 equal to its solo run; the pooled K1's lane form held against
   its twin at every L 16 shape that round launched, on the fleet's own
   move, leader and swap keys with a stall per lane and a seed mask; the
   two lane kernels timed at the shapes that round launched most); a memory budget below the footprint: the LRU spill of
   the coldest tenant and its readmit, every env and state leaf
   bit-identical; the kernel launches of one move-wave pass, one
   leadership-branch pass and one swap-branch pass at L = 1 and L = 16,
   equal; the round walls, the solo walls and ``nvidia-smi``'s
   utilization.gpu sampled during the rounds; the eight lane kernels timed
   at the shapes the cell launched most. (Round 1 on a fresh fleet runs in
   phase 9's fleet service, held against the same rows bit for bit.)

9. the front door (``cruise_control_tpu_torch.service_script``): the
   single-tenant service at e2e-1000b-50000p built by ``main.build_app`` /
   ``build_server`` with the pipelined loop (lockstep ingest-and-sync steps,
   a ``pipelined_round`` with the next window's ingest and sync overlapped
   under it, then threaded), driven over HTTP through the port's client:
   ``POST /rebalance?dryrun=true`` (202 / ``User-Task-ID``), ``GET
   /proposals`` twice, ``/load``, ``/kafka_cluster_state``,
   ``/partition_load``, ``/state?substates=PIPELINE,ROUND_TRACES``; then the
   fleet service at fleet-16x100b (``fleet.cluster.ids``,
   ``main.build_fleet``): ``POST /rebalance?cluster_id=<id>&dryrun=true`` for
   every tenant (each queues a rebalance-lane request), one dispatch of the
   queued requests (one batched launch of 16 lanes), every tenant's
   proposals through ``?cluster_id=``, an unknown id 404 and a malformed one
   400. The launch
   counts are zeroed just before each service and read just after; every
   row must be the reference's (``python tests/torch_reference.py
   service-e2e``, pasted as ``SERVICE_ORACLE``; the tenants' rows
   ``FLEET_ORACLE``'s round 1); the round traces' overlap fractions and
   the request walls are printed.

10. the engine's options at full width (slice-1000b, the sixteen goals,
   each run's launch counts zeroed just before and read just after):
   ``EngineParams(compact_keying=True)`` (the pooled K1 at the move,
   leadership and swap sites; the JAX reference's row of that setting, its
   final state bit-identical to phase 5's sixteen-goal run; the pooled and
   full branch counts, both above zero) and ``chain_cache=False`` (K2's
   per-goal veto form only; the reference's row of that setting); then
   ``NOLB_CHAIN`` on spec-32b (a goal without wave budgets: the
   one-move-per-broker wave and the sequential leadership walk; the
   reference's row). Phase 3 holds the pooled K1 against its twin at R
   114,688 and 1,048,576, k 7,040, eligible shares 1%, 10% (the pool) and
   50% (the full sweep), stalls 0 and 3, with a seed mask and in the lane
   form at L 16; at the leader and swap pools' k 128 and 32 (pool 8,192) on
   shares with and without pad slots; and K2's per-goal form at K 1,760,
   B 1,024, T 16 with six term dims and planted band-edge cells (``lhs +
   d`` on the bound and one ulp either side) and in the lane form at L 16.
   Phase 3's rung 5 checks its per-goal kernels and logdir sums (its
   finisher top-k and refresh sums are rung 4's shapes).

Phase 3 also holds the four lane kernels of the fleet's move wave (K14:
``replica_keys_lanes``, ``select_candidates_lanes``,
``move_score_classes_lanes``, ``wave_admission_lanes``) against their lane
twins on a 16-lane stack at the fleet cell's shape (all 16 lanes and every
other lane, a stall and a seed mask per lane, keys tied across lanes), and
times each at L = 16 beside 16 solo launches and its bound; likewise the
lane kernels of the leadership branch, the swap branch and the probe
(``leadership_rows_lanes``, ``swap_rows_lanes``, ``swap_admission_lanes``,
``seeded_probe_lanes``) on the lanes' states and adversarially (vetoed
rows, tied admission values on shared brokers and partitions, -inf, NaN and
+inf probe keys). It also holds the K1 keying kernel (``replica_keys``) against its twin
for every key function it computes, with f32 tables and with the bf16 sweep
view, on the slice, jbod-1000b, rung-4 and rung-5 states and on adversarial
inputs (halfway-rounding loads, signed zeros, ties, offline rows), and K15
(``forecast``) against its twin at the heal cell's shape (E 50,000
partitions, W 4 and 5 windows, M 10 metrics) and on adversarial histories
(holes, all-holes rows, signed and tiny values, one window, four knob sets).

The line before the last is the ``kernels`` JSON object: each kernel's
launches are those of the counted runs of the sixteen goals, the 18 goals,
the kafka-assigner chain, the three JBOD requests, the two rungs, the
session scripts, the heal scripts, the fleet rounds, the front door's
two services and the options' runs together (each path's under
``launches_by_path``), and its times those of the shape it launched
most often there (the session kernels: on the session path; K15: on the heal
path; the lane kernels: on the fleet path; the pooled K1 and K2's per-goal
form: on phase 10's runs, their lane forms on phase 8's options round; the
others: on the earlier paths), with every timed shape and its
launches listed beside them. The last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "ReplicaDistributionGoal"]
CHAIN = ["RackAwareGoal", "MinTopicLeadersPerBrokerGoal", "ReplicaCapacityGoal",
         "DiskCapacityGoal", "NetworkInboundCapacityGoal",
         "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
         "PotentialNwOutGoal", "LeaderReplicaDistributionGoal",
         "LeaderBytesInDistributionGoal"]
SWAP_GOALS = ["DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
              "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
              "TopicReplicaDistributionGoal"]
DEFAULT = CHAIN[:9] + SWAP_GOALS + CHAIN[9:]       # the reference's DEFAULT_GOALS
SLICE_SPEC = dict(num_brokers=1000, num_racks=20, num_topics=200,
                  num_partitions=50000, max_replication=3, skew=1.5, seed=3141,
                  target_cpu_util=0.45)
SMALL_SPEC = dict(num_brokers=32, num_partitions=1000, num_racks=4, num_topics=8,
                  max_replication=3, skew=1.5, seed=3141, target_cpu_util=0.45)
SMALL_2R_SPEC = dict(SMALL_SPEC, num_racks=2)       # spec-32b-2r: limit 2 for RF 3
MID_SPEC = dict(num_brokers=64, num_racks=4, num_topics=8, num_partitions=8000,
                max_replication=3, seed=3)
INTRA = ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
JBOD_CHAIN = CHAIN[:8] + INTRA                   # bench.py rung 5's ten goals
PLE = ["PreferredLeaderElectionGoal"]
# DeterministicClusterTest's 18-goal chain (tests/test_java_parity_matrix.py)
FULL_CHAIN = [
    "RackAwareGoal", "RackAwareDistributionGoal", "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
    "PotentialNwOutGoal", "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal", "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal", "TopicReplicaDistributionGoal",
    "PreferredLeaderElectionGoal"]
KAFKA_ASSIGNER = ["KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]
# a chain behind a goal without wave budgets (NoLeaderBudgetGoal, phase 10):
# the one-move-per-broker wave and the sequential leadership fallback
NOLB_CHAIN = ["RackAwareGoal", "ReplicaCapacityGoal", "NoLeaderBudgetGoal",
              "DiskCapacityGoal", "ReplicaDistributionGoal", "LeaderBytesInDistributionGoal"]
RACK_DIST = ["RackAwareDistributionGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal",
             "DiskUsageDistributionGoal"]
JBOD_SPEC = dict(num_brokers=1000, num_racks=20, num_topics=200, num_partitions=50000,
                 max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
                 target_cpu_util=0.45, num_dead_brokers=3, num_brokers_with_dead_disk=7)
JBOD_SMALL = dict(num_brokers=32, num_racks=4, num_topics=8, num_partitions=1000,
                  max_replication=3, skew=1.0, seed=3143, logdirs_per_broker=4,
                  target_cpu_util=0.45, num_dead_brokers=1, num_brokers_with_dead_disk=2)
JBOD_MID = dict(JBOD_SMALL, num_brokers=64, num_partitions=8000)
DEMOTED = [11, 222, 444, 666, 888]               # broker indices of /demote_broker
# BASELINE.json configs 4 and 5 (bench.py rungs 4 and 5, bench.py:657-691) at
# full size: 7,000 brokers, 500,000 partitions; "auto" resolves to bf16
RUNG4_SPEC = dict(num_brokers=7000, num_racks=40, num_topics=2000,
                  num_partitions=500000, max_replication=3, skew=1.0, seed=3142,
                  target_cpu_util=0.45)
RUNG5_SPEC = dict(RUNG4_SPEC, seed=3143, logdirs_per_broker=4, num_dead_brokers=20,
                  num_brokers_with_dead_disk=50)
# the goals whose keys the K1 keying kernel (replica_keys) computes, and
# which of their key functions
KEY_GOALS = ["CpuCapacityGoal", "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
             "DiskCapacityGoal", "PotentialNwOutGoal", "LeaderBytesInDistributionGoal",
             "DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
             "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
             "IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
KEY_FNS = {"CapacityGoal": ("replica_key", "leader_key"),
           "PotentialNwOutGoal": ("replica_key",),
           "LeaderBytesInDistributionGoal": ("leader_key",),
           "ResourceDistributionGoal": ("replica_key", "leader_key", "swap_out_key",
                                        "swap_in_key"),
           "IntraBrokerDiskCapacityGoal": ("replica_key",),
           "IntraBrokerDiskUsageDistributionGoal": ("replica_key",)}
# Outcomes of the JAX reference (JAX_PLATFORMS=cpu) on these specs; the
# tier-1 test tests/test_torch_slice.py holds the port to the live reference.
# ``digests``: the first 16 hex digits of the sha256 of the bytes of the
# reference's final float32 tallies (disk_util [B, D], util and leader_util
# [B, M], potential_nw_out [B]; the padded shape).
ORACLE = {
    "slice": dict(before={"RackAwareGoal", "ReplicaDistributionGoal"},
                  actions=[3051, 0, 0, 0, 18965], passes=[7, 3, 3, 3, 79],
                  moves=18656, leads=8081),
    "small": dict(before={"RackAwareGoal", "ReplicaDistributionGoal"},
                  actions=[60, 0, 0, 0, 207], passes=[6, 3, 3, 3, 15],
                  moves=245, leads=170),
    "chain_slice": dict(
        before={"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"},
        after={"ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
               "LeaderBytesInDistributionGoal"},
        actions=[3051, 0, 0, 0, 0, 0, 557, 18136, 0, 1393, 1680],
        passes=[7, 3, 3, 3, 3, 3, 6, 132, 3, 64, 160], moves=18469, leads=10751,
        proven=[False] * 9 + [True, True], rounds=[0] * 9 + [1, 2]),
    "chain_small": dict(
        before={"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"},
        after={"LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"},
        actions=[60, 0, 0, 0, 0, 0, 19, 178, 0, 19, 23],
        passes=[6, 3, 3, 3, 3, 3, 4, 12, 3, 35, 59], moves=258, leads=204,
        proven=[False] * 11, rounds=[0] * 11),
    "chain_mid": dict(
        before={"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"},
        after={"CpuCapacityGoal", "ReplicaDistributionGoal",
               "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"},
        actions=[1186] + [0] * 10, passes=[14, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8],
        moves=1186, leads=0, proven=[False] * 6 + [True, True, False, True, True],
        rounds=[0] * 6 + [1, 1, 0, 1, 1]),
}
_USAGE = {"DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
          "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal"}
ORACLE.update({
    "default_slice": dict(
        before={"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
                "LeaderBytesInDistributionGoal"} | _USAGE,
        after={"ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
               "LeaderBytesInDistributionGoal"},
        actions=[3051, 0, 0, 0, 0, 0, 557, 18136, 0, 1247, 1082, 1248, 1585, 617, 808,
                 1125],
        passes=[7, 3, 3, 3, 3, 3, 6, 132, 3, 104, 88, 99, 109, 22, 48, 152],
        moves=22642, leads=12778, proven=[False] * 14 + [True, True],
        rounds=[0] * 14 + [1, 3], swaps=[0] * 9 + [154, 166, 109, 110, 76, 0, 0]),
    "default_small": dict(
        before={"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"} | _USAGE,
        after={"LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"},
        actions=[60, 0, 0, 0, 0, 0, 19, 178, 0, 19, 20, 26, 18, 0, 0, 8],
        passes=[6, 3, 3, 3, 3, 3, 4, 12, 3, 8, 7, 13, 10, 3, 33, 64], moves=307,
        leads=242, proven=[False] * 16, rounds=[0] * 16,
        swaps=[0] * 9 + [1, 1, 4, 1, 0, 0, 0]),
    "default_mid": dict(
        before={"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"} | _USAGE,
        after={"CpuCapacityGoal", "ReplicaDistributionGoal",
               "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal"} | _USAGE,
        actions=[1186] + [0] * 15,
        passes=[14, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8], moves=1186, leads=0,
        proven=[False] * 6 + [True, True, False] + [True] * 4 + [False, True, True],
        rounds=[0] * 6 + [1, 1, 0] + [1] * 4 + [0, 1, 1], swaps=[0] * 16,
        swleft=[-1] * 9 + [0, 0, 0, 0] + [-1] * 3),
})
_HEAL = {"RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
         "ReplicaDistributionGoal"} | set(INTRA)
ORACLE.update({
    "jbod_intra": dict(before=set(INTRA), after=set(), actions=[165, 2713],
                       passes=[4, 7], moves=0, leads=0, disk=[165, 2713],
                       proposals=2313, digests=dict(
                           disk_util="40cc6af69c4636b0", util="826e628119038d85",
                           leader_util="885364b57121d475",
                           potential_nw_out="272e128a4beb390f")),
    "jbod_chain": dict(before=_HEAL, after=set(),
                       actions=[3799, 0, 0, 0, 0, 0, 105, 12173, 0, 3068],
                       passes=[8, 3, 3, 3, 3, 3, 5, 67, 3, 7], moves=13717, leads=5113,
                       disk=[0] * 9 + [3068], proposals=14319,
                       digests=dict(disk_util="25dde16fd944fdd9", util="41be1142d8dd2ce2",
                                    leader_util="aab38ec89964f1e5",
                                    potential_nw_out="554ae21877c99e4b")),
    "jbod_demote": dict(before=set(PLE), after=set(), actions=[1], passes=[0], moves=0,
                        leads=173, disk=[0]),
    "jbod_ple": dict(before=set(), after=set(), actions=[0], passes=[0], moves=0,
                     leads=0, disk=[0]),
    "jbod_intra_small": dict(before=set(INTRA), after=set(), actions=[13, 93],
                             passes=[4, 9], moves=0, leads=0, disk=[13, 93]),
    "jbod_chain_small": dict(before=_HEAL, after=set(),
                             actions=[78, 0, 0, 0, 0, 0, 5, 95, 0, 65],
                             passes=[6, 3, 3, 3, 3, 3, 4, 8, 3, 7], moves=170, leads=108,
                             disk=[0] * 9 + [65]),
    "jbod_intra_mid": dict(before=set(INTRA), after=set(), actions=[71, 137],
                           passes=[4, 5], moves=0, leads=0, disk=[71, 137],
                           proposals=194),
    "jbod_chain_mid": dict(before=_HEAL, after=set(),
                           actions=[581, 0, 0, 0, 0, 0, 6, 794, 0, 86],
                           passes=[9, 3, 3, 3, 3, 3, 4, 19, 3, 5], moves=1340, leads=860,
                           disk=[0] * 9 + [86], proposals=1336),
})
_FULL_BEFORE = {"RackAwareGoal", "RackAwareDistributionGoal", "CpuCapacityGoal",
                "ReplicaDistributionGoal", "TopicReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
                "PreferredLeaderElectionGoal"} | _USAGE
ORACLE.update({
    "full_slice": dict(
        before=_FULL_BEFORE,
        after={"ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
               "LeaderBytesInDistributionGoal", "TopicReplicaDistributionGoal"},
        actions=[3051, 0, 0, 0, 0, 0, 0, 557, 18136, 0, 1247, 1082, 1248, 1585, 772,
                 1111, 581, 1],
        passes=[7, 3, 3, 3, 3, 3, 3, 6, 132, 3, 104, 88, 99, 109, 48, 160, 40, 0],
        moves=22641, leads=10764, proven=[False] * 14 + [True, True, True, False],
        rounds=[0] * 14 + [1, 2, 1, 0],
        swaps=[0] * 10 + [154, 166, 109, 110, 0, 0, 110, 0],
        swleft=[-1] * 16 + [0, -1], proposals=19827),
    "full_small": dict(
        before={"ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
                "LeaderBytesInDistributionGoal", "PreferredLeaderElectionGoal"} | _USAGE,
        after=set(), actions=[0] * 8 + [81, 0, 1, 0, 11, 0, 0, 0, 0, 1],
        passes=[3] * 8 + [9, 3, 4, 3, 10, 3, 3, 3, 3, 0], moves=83, leads=66,
        proven=[False] * 18, rounds=[0] * 18, swaps=[0] * 12 + [1] + [0] * 5,
        proposals=75),
    "rack_dist_small_2r": dict(
        before={"RackAwareDistributionGoal", "ReplicaDistributionGoal",
                "DiskUsageDistributionGoal"}, after=set(), actions=[21, 0, 232, 18],
        passes=[4, 3, 18, 6], moves=244, leads=197, swaps=[0] * 4, proposals=237),
    "kafka_small": dict(
        before=set(KAFKA_ASSIGNER), after=set(), actions=[60, 100], passes=[6, 63],
        moves=237, leads=158, swaps=[0, 100], swleft=[-1, -1], proposals=218),
    "kafka_slice": dict(
        before=set(KAFKA_ASSIGNER), after={"KafkaAssignerDiskUsageDistributionGoal"},
        actions=[3051, 833], passes=[7, 194], moves=4612, leads=821,
        proven=[False, False], rounds=[0, 0], swaps=[0, 833], swleft=[-1, -1],
        proposals=4466),
})
# BASELINE configs 4 and 5 through the JAX reference (JAX 0.9.0,
# JAX_PLATFORMS=cpu, a fresh interpreter): ``python tests/torch_reference.py
# rung4`` ("auto", which resolves to bf16), ``... rung4 float32`` and
# ``... rung5``; digests as above.
_R4_BEFORE = {"RackAwareGoal", "CpuCapacityGoal", "ReplicaDistributionGoal",
              "TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
              "LeaderBytesInDistributionGoal"} | _USAGE
_R4_AFTER = {"LeaderBytesInDistributionGoal", "LeaderReplicaDistributionGoal",
             "NetworkOutboundUsageDistributionGoal"}
_R4_PROVEN = [False] * 11 + [True, False, False, True, True]
_R4_ROUNDS = [0] * 11 + [1, 0, 0, 1, 1]
_R4_SWLEFT = [-1] * 11 + [0] + [-1] * 4
ORACLE.update({
    "rung4_bf16": dict(
        before=_R4_BEFORE, after=_R4_AFTER,
        actions=[16714, 0, 0, 0, 0, 0, 825, 116773, 0, 12107, 11011, 11146, 10174, 674,
                 5207, 6621],
        passes=[8, 3, 3, 3, 3, 3, 4, 40, 3, 63, 78, 99, 115, 11, 56, 99],
        moves=155090, leads=90291, proven=_R4_PROVEN, rounds=_R4_ROUNDS,
        swaps=[0] * 9 + [137, 273, 282, 54, 34, 0, 0], swleft=_R4_SWLEFT,
        disk=[0] * 16, proposals=155734,
        digests=dict(disk_util="9b29a51824e2401a", util="7a1647b39da23a10",
                     leader_util="81c587cf26af977a", potential_nw_out="3c1cc249b40fbf99")),
    "rung4_f32": dict(
        before=_R4_BEFORE, after=_R4_AFTER,
        actions=[16714, 0, 0, 0, 0, 0, 826, 117145, 0, 12093, 11049, 11910, 11401, 692,
                 5445, 6758],
        passes=[8, 3, 3, 3, 3, 3, 4, 40, 3, 61, 80, 99, 112, 11, 63, 103],
        moves=156133, leads=91677, proven=_R4_PROVEN, rounds=_R4_ROUNDS,
        swaps=[0] * 9 + [130, 265, 257, 54, 26, 0, 0], swleft=_R4_SWLEFT,
        disk=[0] * 16, proposals=157085,
        digests=dict(disk_util="936391a989597ee3", util="691ae3bae0112cdd",
                     leader_util="b8b213304649cf14", potential_nw_out="49f31a764cb396b0")),
    "rung5_bf16": dict(
        before=_HEAL, after=set(), actions=[20431, 0, 0, 0, 0, 0, 860, 110704, 0, 16682],
        passes=[9, 3, 3, 3, 3, 3, 4, 38, 3, 22], moves=121897, leads=54475,
        proven=[False] * 10, rounds=[0] * 10, swaps=[0] * 10, swleft=[-1] * 10,
        disk=[0] * 9 + [16682], proposals=126681,
        digests=dict(disk_util="f0c73615645acc8d", util="bd6324618028f42a",
                     leader_util="1924067e9bfa289a", potential_nw_out="449f955b4861662d")),
})
# Phase 10's rows through the JAX reference (JAX 0.9.0, JAX_PLATFORMS=cpu, a
# fresh interpreter): ``python tests/torch_reference.py options``, the
# sixteen goals on slice-1000b with EngineParams(compact_keying=True) and with
# EngineParams(chain_cache=False), and NOLB_CHAIN on spec-32b (its
# NoLeaderBudgetGoal registered in the reference's process); digests as above.
ORACLE.update({
    "default_slice_compact": dict(
        ORACLE["default_slice"], proposals=21016, swleft=[-1] * 16, disk=[0] * 16,
        digests=dict(disk_util="81f320b375e33cd6", util="42f639b8b6b7bece",
                     leader_util="896531098df9109e", potential_nw_out="1e7cb9686098614f")),
    "default_slice_nocache": dict(
        before=ORACLE["default_slice"]["before"], after=ORACLE["default_slice"]["after"],
        actions=[3051, 0, 0, 0, 0, 0, 557, 18137, 0, 1220, 1100, 1291, 1472, 635, 823,
                 1062],
        passes=[7, 3, 3, 3, 3, 3, 6, 132, 3, 102, 90, 63, 97, 28, 48, 120],
        moves=22501, leads=12661, proven=[False] * 14 + [True, True], rounds=[0] * 14 + [1, 1],
        swaps=[0] * 9 + [151, 167, 90, 87, 69, 0, 0], swleft=[-1] * 16, disk=[0] * 16,
        proposals=20928,
        digests=dict(disk_util="0378ebb173888f8a", util="7e85e61fcc28a753",
                     leader_util="912f1bb662cb3b74", potential_nw_out="c6fee9eda479d3e9")),
    "nolb_small": dict(
        before={"RackAwareGoal", "NoLeaderBudgetGoal", "ReplicaDistributionGoal",
                "LeaderBytesInDistributionGoal"},
        after={"NoLeaderBudgetGoal", "LeaderBytesInDistributionGoal"},
        actions=[60, 0, 141, 0, 40, 19], passes=[6, 3, 71, 3, 17, 59], moves=223, leads=186,
        proven=[False] * 6, rounds=[0] * 6, swaps=[0] * 6, swleft=[-1] * 6, disk=[0] * 6,
        proposals=218,
        digests=dict(disk_util="be0c94c5d323b053", util="3aad0761769aeacb",
                     leader_util="1ff3ca632c13bc33", potential_nw_out="a54173f421334e03")),
})
# the kernels of the JBOD path that no earlier path launches
JBOD_KERNELS = ("disk_rows", "disk_apply", "preferred_leader")
# the kernels of the resident-session path (phase 6) that no earlier path
# launches: K5's finalize, K1 with a seed mask, K13's probe
SESSION_KERNELS = ("session_finalize", "select_candidates_masked", "seeded_probe")
# the kernel of the self-healing service path (phase 7) that no earlier path
# launches: K15's forecast
HEAL_KERNELS = ("forecast",)
# the kernels of the fleet path (phase 8) that no earlier path launches:
# the lane forms (K14) of the move wave's kernels, and of the leadership and
# swap branches' and the probe's
MOVE_LANE_KERNELS = ("replica_keys_lanes", "select_candidates_lanes",
                     "move_score_classes_lanes", "wave_admission_lanes")
BRANCH_LANE_KERNELS = ("leadership_rows_lanes", "swap_rows_lanes", "swap_admission_lanes",
                       "seeded_probe_lanes")
FLEET_KERNELS = MOVE_LANE_KERNELS + BRANCH_LANE_KERNELS
# the path whose launch shapes time each later slice's kernels
# the kernels of the engine's options (phase 10 and phase 8's options round)
# that no other path launches: the pooled K1 and K2's per-goal veto form,
# solo and in lanes
OPTION_KERNELS = ("select_pooled", "move_score_terms", "select_pooled_lanes",
                  "move_score_terms_lanes")
KERNEL_PATH = {**{n: "session" for n in SESSION_KERNELS},
               **{n: "heal" for n in HEAL_KERNELS},
               **{n: "fleet" for n in FLEET_KERNELS},
               "select_pooled": "options", "move_score_terms": "options",
               "select_pooled_lanes": "options_fleet",
               "move_score_terms_lanes": "options_fleet"}
# The e2e-1000b-50000p cell's rounds through the JAX reference (JAX 0.9.0,
# JAX_PLATFORMS=cpu, a fresh interpreter): ``python tests/torch_reference.py
# session-e2e``, the rows of ``cruise_control_tpu_torch.analyzer.
# session_script.session_script`` (digests: the first 16 hex digits of the
# sha256 of the final state's leaves, as f32 or i64). R2 is R1 re-stamped
# by the revalidation memo; R3 runs full, or reduced with dirty seeding.
_SESSION_R1 = {'sync': 'delta',
               'churn': 0,
               'round': 'full',
               'before': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                          'DiskUsageDistributionGoal', 'LeaderBytesInDistributionGoal',
                          'LeaderReplicaDistributionGoal', 'NetworkInboundUsageDistributionGoal',
                          'NetworkOutboundUsageDistributionGoal', 'RackAwareGoal',
                          'ReplicaDistributionGoal', 'TopicReplicaDistributionGoal'],
               'after': ['DiskUsageDistributionGoal', 'LeaderReplicaDistributionGoal',
                         'NetworkInboundUsageDistributionGoal',
                         'NetworkOutboundUsageDistributionGoal', 'ReplicaDistributionGoal'],
               'proven': [False, False, False, False, False, False, False, False, False, True,
                          True, False, False, False, True, False],
               'actions': [2522, 0, 0, 0, 0, 0, 12479, 28471, 0, 4722, 580, 6142, 469, 455, 3842,
                           0],
               'passes': [4, 3, 3, 3, 3, 3, 9, 170, 3, 196, 194, 200, 118, 43, 205, 3],
               'modes': ['full', 'full', 'full', 'full', 'full', 'full', 'full', 'full', 'full',
                         'full', 'full', 'full', 'full', 'full', 'full', 'full'],
               'moves': 45997,
               'leads': 36316,
               'proposals': 40307,
               'proposals_sha': '1deda5700010611c',
               'fallback': 0,
               'skipped': 0,
               'digests': {'replica_broker': '2a0d62b57d77e784',
                           'replica_is_leader': 'b4f54de1aa7c4df5',
                           'replica_disk': 'b527dab94f6bf43c',
                           'util': '1363f9a8f1e27710',
                           'leader_util': '8b7c754a2e28ccec',
                           'potential_nw_out': '86fb82b41d781330',
                           'disk_util': '60d08f201df88d3e',
                           'replica_count': '640d7a03a9b66f3b',
                           'leader_count': 'f2236f00f087180c',
                           'topic_broker_count': 'ef9dfa6d4e61562f'}}
_SESSION_R3_FULL = {'sync': 'delta',
                    'churn': 16,
                    'round': 'full',
                    'before': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                               'DiskUsageDistributionGoal', 'LeaderBytesInDistributionGoal',
                               'LeaderReplicaDistributionGoal', 'NetworkInboundUsageDistributionGoal',
                               'NetworkOutboundUsageDistributionGoal', 'RackAwareGoal',
                               'ReplicaDistributionGoal', 'TopicReplicaDistributionGoal'],
                    'after': ['DiskUsageDistributionGoal', 'LeaderReplicaDistributionGoal',
                              'NetworkInboundUsageDistributionGoal',
                              'NetworkOutboundUsageDistributionGoal', 'ReplicaDistributionGoal',
                              'TopicReplicaDistributionGoal'],
                    'proven': [False, False, False, False, False, False, False, False, False, True,
                               True, True, False, True, False, False],
                    'actions': [2522, 0, 0, 0, 0, 0, 12481, 28599, 0, 4837, 580, 6075, 508, 430, 3979,
                                0],
                    'passes': [4, 3, 3, 3, 3, 3, 9, 169, 3, 197, 194, 198, 140, 48, 206, 3],
                    'modes': ['full', 'full', 'full', 'full', 'full', 'full', 'full', 'full', 'full',
                              'full', 'full', 'full', 'full', 'full', 'full', 'full'],
                    'moves': 45817,
                    'leads': 36537,
                    'proposals': 40465,
                    'proposals_sha': '1ff8531688101287',
                    'fallback': 0,
                    'skipped': 0,
                    'digests': {'replica_broker': '98bb3f2c9e95f762',
                                'replica_is_leader': '7e7064f09b3e7e5d',
                                'replica_disk': 'b527dab94f6bf43c',
                                'util': 'd68ffcb73c93b84f',
                                'leader_util': '148866041b91fec0',
                                'potential_nw_out': '1053a3e8070e7d1c',
                                'disk_util': 'db2cc1f8a230693a',
                                'replica_count': '73dc53296108be02',
                                'leader_count': '56a5472ea9defeee',
                                'topic_broker_count': 'b757633f6b7b039c'}}
_SESSION_R3_REDUCED = {'sync': 'delta',
                       'churn': 16,
                       'round': 'reduced',
                       'before': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                  'DiskUsageDistributionGoal', 'LeaderBytesInDistributionGoal',
                                  'LeaderReplicaDistributionGoal', 'NetworkInboundUsageDistributionGoal',
                                  'NetworkOutboundUsageDistributionGoal', 'RackAwareGoal',
                                  'ReplicaDistributionGoal', 'TopicReplicaDistributionGoal'],
                       'after': ['DiskUsageDistributionGoal', 'LeaderBytesInDistributionGoal',
                                 'LeaderReplicaDistributionGoal', 'NetworkInboundUsageDistributionGoal',
                                 'NetworkOutboundUsageDistributionGoal', 'TopicReplicaDistributionGoal'],
                       'proven': [False, False, False, False, False, False, False, False, False, True,
                                  True, True, False, False, True, True],
                       'actions': [2522, 0, 0, 0, 0, 0, 12481, 30025, 0, 4837, 580, 6075, 1575, 443, 4688,
                                   0],
                       'passes': [4, 3, 3, 3, 3, 3, 9, 175, 3, 197, 194, 198, 186, 55, 366, 11],
                       'modes': ['full', 'reduced', 'reduced', 'reduced', 'reduced', 'reduced', 'full',
                                 'full', 'reduced', 'full', 'full', 'full', 'full', 'full', 'full',
                                 'full'],
                       'moves': 46134,
                       'leads': 37046,
                       'proposals': 40901,
                       'proposals_sha': 'f9a7adb806310ba4',
                       'fallback': 5,
                       'skipped': 0,
                       'digests': {'replica_broker': '099bd6da4c8de599',
                                   'replica_is_leader': 'a20943ea6e37c566',
                                   'replica_disk': 'b527dab94f6bf43c',
                                   'util': 'f0d32a594142d50d',
                                   'leader_util': 'ab3695b9488c6710',
                                   'potential_nw_out': '442cbb215145150b',
                                   'disk_util': '495fc73dbad5d8dc',
                                   'replica_count': '41d06e66ba559df6',
                                   'leader_count': '83d631844c6c0510',
                                   'topic_broker_count': 'fa83ea9dd6da203a'}}
_SESSION_R2 = dict(_SESSION_R1, round="revalidated", modes=["revalidated"] * 16)
SESSION_ORACLE = {"plain": [_SESSION_R1, _SESSION_R2, _SESSION_R3_FULL],
                  "seeded": [_SESSION_R1, _SESSION_R2, _SESSION_R3_REDUCED]}
# __graft_entry__.entry(): the reference's util disk column and total
ENTRY_DISK = [5630, 5660, 5670, 5660, 5660, 5680, 5660, 5660, 5010, 4950, 4860, 4950,
              4920, 4910, 4910, 4940]
ENTRY_UTIL_SUM = 105674.0
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels do f32 and integer arithmetic only)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
REPS = 20
# the kernels of the first slice's path (the five move-branch goals)
FIVE_GOAL_KERNELS = ("select_candidates", "move_score_classes", "wave_admission",
                     "segment_sum", "segment_count")


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


T_START = time.perf_counter()


def phase(name: str) -> None:
    log(f"== {name} (at {time.perf_counter() - T_START:.1f} s)")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median over ``reps`` of the CUDA-event time around one call (warm)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for work moving ``nbytes`` and doing
    ``nops`` f32 / integer operations on one H100."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    """Bytes of every tensor in ``ts``, walking nested tuples and lists."""
    total = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def fields_of(obj) -> list:
    """The tensors of a dataclass of kernel inputs, nested lists of
    dataclasses walked (the K7 inputs)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        for x in (v if isinstance(v, list) else [v]):
            out.extend(fields_of(x) if dataclasses.is_dataclass(x) else [x])
    return out


def lead_bytes(n: int, F: int) -> int:
    """The bytes one K6 launch over ``n`` candidate rows of ``F`` members
    must move: per (k, f) the member id, its broker, offline flag, broker
    flag and eight f32 table / veto reads; per row the candidate, its flag
    and two values; out a value and an index per row."""
    return n * F * (8 + 8 + 1 + 1 + 4 * 8) + n * (8 + 1 + 4 * 2) + n * (4 + 8)


def swap_rows_work(pairs, tables) -> tuple:
    """(bytes, operations) of one K7 ``swap_rows`` launch: every operand of
    the pairs and tables once (the topic table only where the topic veto or
    the topic family reads it), the three outputs per out row, and about
    60 + 10 V operations per pair."""
    from cruise_control_tpu_torch.kernels import swap
    k1, k2 = pairs.b_out.shape[0], pairs.b_in.shape[0]
    reads_tab = (pairs.topic_up is not None
                 or tables.family == swap.SWAP_TOPIC_REPLICA)
    nb = nbytes(*(x for x in fields_of(pairs) + fields_of(tables)
                  if x is not pairs.tab or reads_tab))
    return nb + k1 * (4 + 8 + 4), k1 * k2 * (60 + 10 * len(pairs.vetoes))


def to_device(obj, dev):
    """A copy of a dataclass of CPU tensors with every tensor on ``dev``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev).contiguous()
        for f in dataclasses.fields(obj) if hasattr(getattr(obj, f.name), "to")})


def compare(torch, got, want) -> float:
    """Max abs error of the float outputs; raises unless every output is
    bit-identical (floats compared as bits, so -0.0 != +0.0)."""
    err = 0.0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.dtype.is_floating_point:
            diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
            if diff.numel():
                err = max(err, float(torch.nan_to_num(diff, nan=float("inf")).max()))
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        require(same, f"output differs from the plain twin (max abs err {err})")
    return err


class Entry:
    """One kernel's checks and its timings, one per launch shape timed (the
    shape key is the one its wrapper counts launches under)."""

    def __init__(self, name):
        self.name = name
        self.checks = 0
        self.max_abs_err = 0.0
        self.timings = []


def check(torch, entry: Entry, kernel_fn, plain_fn, what: str,
          quiet: bool = False) -> None:
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = compare(torch, got, want)
    entry.checks += 1
    entry.max_abs_err = max(entry.max_abs_err, err)
    if not quiet:
        log(f"  {entry.name} {what}: bit-identical")


# the kernels redesigned for Hopper after their port (K4/K5 segment_sum and
# every form of K1): their timings add one call's device time and CUDA
# launches beside the event window, and the library call's device time
REDESIGNED = ("segment_sum", "select_candidates", "select_candidates_masked",
              "select_candidates_lanes", "select_pooled", "select_pooled_lanes")


def device_ms(torch, fn, reps: int = REPS) -> float:
    """One call's time on the device alone: ``reps`` calls enqueued behind a
    sleep kernel run back to back, with no host gap between them; the CUDA-
    event window around them over ``reps`` (warm). The sleep grows until it
    outlasts the host's enqueueing. (torch.profiler drops a random share of
    short kernels' events on this machine, so its sums are not used.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if s.elapsed_time(a) > host_ms or cycles >= 1 << 30:
            return a.elapsed_time(b) / reps
        cycles *= 4


def timing(torch, entry: Entry, kernel_fn, plain_fn, library_fn, nb, nops,
           shape: str, plain_reps: int = REPS) -> None:
    """Time the kernel, its twin and the library call at one shape; one
    counted launch first tells the shape key the wrapper counts it under.
    ``plain_reps`` cuts the windows of a twin that takes seconds (0: the
    twin is not timed). A redesigned kernel adds its device time and CUDA
    launches per call, and the library call's."""
    from cruise_control_tpu_torch import kernels as K
    K.reset_launches()
    kernel_fn()
    keys = K.launch_shapes()[entry.name]
    require(list(keys.values()) == [1],
            f"{entry.name} at {shape}: one timed call launched {keys}")
    cuda_launches = K.KERNELS[entry.name].cuda_launches
    ms = time_ms(torch, kernel_fn)
    plain_ms = time_ms(torch, plain_fn, plain_reps) if plain_reps else None
    lib_ms = time_ms(torch, library_fn) if library_fn is not None else None
    b_ms, by = bound(nb, nops)
    t = dict(shape=next(iter(keys)), at=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=b_ms, bound_by=by)
    extra = ""
    if entry.name in REDESIGNED:
        t["device_ms"], t["cuda_launches"] = device_ms(torch, kernel_fn), cuda_launches
        if library_fn is not None:
            t["library_device_ms"] = device_ms(torch, library_fn)
        extra = (f", device {t['device_ms']:.6f} ms in {cuda_launches} CUDA launches"
                 + (f", library device {t['library_device_ms']:.6f} ms"
                    if library_fn is not None else ""))
    entry.timings.append(t)
    log(f"  {entry.name} time at {shape}: kernel {ms:.6f} ms, plain "
        f"{'-' if plain_ms is None else f'{plain_ms:.6f} ms'}, "
        f"library {'-' if lib_ms is None else f'{lib_ms:.6f} ms'}, "
        f"bound {b_ms:.6f} ms ({by}){extra}")


def kernel_entry(name: str, k, e: Entry, launches: int, ran: dict,
                 by_path: dict) -> dict:
    """The kernels-line object of one kernel. Its times are those of the
    shape it launched most often on the counted paths (``ran``:
    {shape: launches}); every timed shape is listed beside it with its own
    launches, and the launched shapes that were not timed with theirs."""
    by_shape = [dict(t, launches=ran.get(t["shape"], 0)) for t in e.timings]
    top = max(by_shape, key=lambda t: t["launches"])
    most = max(ran.values(), default=0)
    require(top["launches"] == most,
            f"{name}: its most-launched shape {max(ran, key=ran.get)} ({most} "
            f"launches) was not timed (timed: {[t['shape'] for t in by_shape]})")
    timed = {t["shape"] for t in by_shape}
    return dict(name=name, route="cuda", source=k.source, replaces=k.replaces,
                launches=launches, max_abs_err=e.max_abs_err,
                **{key: top[key] for key in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")},
                shape=top["shape"], shape_launches=top["launches"], shapes=by_shape,
                untimed_shapes={s: n for s, n in ran.items() if s not in timed},
                launches_by_path=by_path)


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------
def kernel_checks(torch, ctx, seed: int) -> dict:
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.state import (
        apply_move_count_inputs, apply_sum_inputs, refresh_sum_inputs,
    )
    from cruise_control_tpu_torch.kernels import admission, move_score, segment, select

    env, st, goals, params = ctx["env"], ctx["st"], ctx["goals"], ctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed)
    R, B = env.num_replicas, env.num_brokers
    Kc = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(Kc, 1)))
    k_all = min(Kc * W, R)
    T = min(params.num_dst_choices, B)
    entries = {n: Entry(n) for n in K.KERNELS}
    log(f"kernel checks: R={R} B={B} K={Kc} K*W={k_all} T={T} seed={seed}")

    # --- K1 select_candidates -------------------------------------------
    e = entries["select_candidates"]
    keys = {}
    for goal in (goals[0], goals[4]):
        sev = goal.broker_severity(env, st)
        keys[goal.name] = goal.replica_key(env, st, sev).contiguous()
    adv = torch.randn(R, generator=g)
    adv[::7] = -torch.inf
    adv[::11] = 0.5
    adv[5::13] = -0.0
    adv[6::13] = 0.0
    adv[1::17] = 6e11
    keys["adversarial"] = adv.to(dev)
    for name, key in keys.items():
        for stall in (0, 3):
            check(torch, e, lambda: K.select_candidates(key, k_all, stall, 0),
                  lambda: select.select_candidates_plain(key, k_all, stall, 0),
                  f"{name} stall={stall}")
    key = keys["ReplicaDistributionGoal"]
    timing(torch, e, lambda: K.select_candidates(key, k_all, 0, 0),
           lambda: select.select_candidates_plain(key, k_all, 0, 0),
           lambda: torch.topk(key, k_all),
           nbytes(key) + k_all * (4 + 8), 4 * R, f"R={R} k={k_all}")

    # candidates of the two goals with work, as the first wave sees them
    cands = {}
    for goal in (goals[0], goals[4]):
        kv, cand = K.select_candidates(keys[goal.name], k_all, 0, 0)
        cands[goal.name] = (cand[:Kc].contiguous(), kv[:Kc].contiguous())

    # --- K2 move_score_classes --------------------------------------------
    e = entries["move_score_classes"]
    score_args = {}
    for i, goal in enumerate(goals):
        prev = tuple(goals[:i])
        cand, kv = cands["RackAwareGoal" if i == 0 else "ReplicaDistributionGoal"]
        rooms, rack_veto = engine._combined_move_rooms(prev, env, st)
        d_rows = engine.move_delta_rows(env, st, cand)
        args = engine._score_args(env, st, goal, rooms, rack_veto, cand, kv, d_rows, T)
        score_args[goal.name] = args
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"{goal.name} active, {len(prev)} previous goals")
    # adversarial: random rows, planted score ties, -inf rows, every family
    F = 4
    Kr = env.num_racks
    base = dict(
        cur_b=torch.randint(0, B, (Kc,), generator=g),
        orig_b=torch.randint(0, B, (Kc,), generator=g),
        sib_b=torch.randint(-1, B, (Kc, F), generator=g),
        row_ok=torch.rand(Kc, generator=g) > 0.1,
        d_rows=torch.randint(0, 3, (Kc, 8), generator=g).float(),
        dst_room=torch.randint(-1, 4, (8, B), generator=g).float(),
        prow=torch.randint(0, 2, (Kc, Kr), generator=g),
        row_f=torch.randint(0, 3, (Kc, 4), generator=g).float(),
        col_f=torch.rand((4, B), generator=g),
        dst_ok=torch.rand(B, generator=g) > 0.05,
        new_ok=torch.ones(B, dtype=torch.bool),
        broker_rack=torch.arange(B) % Kr,
    )
    base["col_f"][0] = torch.randint(80, 120, (B,), generator=g).float()
    for kind in range(4):
        a = {n: t.clone() for n, t in base.items()}
        if kind == move_score.GOAL_REPLICA_CAPACITY:
            a["col_f"][1] = 1.0                      # every destination ties
        if kind == move_score.GOAL_REPLICA_DIST:
            a["row_f"] = torch.stack([
                torch.randint(90, 110, (Kc,), generator=g).float(),
                torch.full((Kc,), 95.0), torch.full((Kc,), 105.0),
                (torch.rand(Kc, generator=g) > 0.95).float()], 1)
            a["col_f"] = torch.stack([
                torch.randint(90, 110, (B,), generator=g).float(),
                torch.full((B,), 95.0), torch.full((B,), 105.0),
                torch.rand(B, generator=g) + 1], 0)
        a = {n: t.to(dev).contiguous() for n, t in a.items()}
        lim1 = torch.ones(Kc, dtype=torch.int32, device=dev)   # RackAwareGoal's veto
        args = (kind, T, a["cur_b"], a["orig_b"], a["sib_b"], a["row_ok"],
                a["d_rows"], a["dst_room"], 0b10010, a["prow"], lim1, a["row_f"],
                a["col_f"], a["dst_ok"], a["new_ok"], a["broker_rack"])
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"adversarial family {kind}")
    args = score_args["ReplicaDistributionGoal"]
    rooms_used = bin(args[8]).count("1")
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(t for t in args if isinstance(t, torch.Tensor)))
           + Kc * T * (4 + 8),
           Kc * B * (2 * rooms_used + 12), f"K={Kc} B={B} T={T}")

    # --- K3 wave_admission ------------------------------------------------
    e = entries["wave_admission"]
    adm = {}
    for i, goal in ((0, goals[0]), (4, goals[4])):
        cand, kv = cands[goal.name]
        r_sorted, dst_s, args = engine._admission_args(
            env, st, goal, tuple(goals[:i]), params, cand, kv)
        adm[goal.name] = (r_sorted, dst_s, args)
        check(torch, e, lambda: K.wave_admission(*args),
              lambda: admission.wave_admission_plain(*args),
              f"{goal.name} first wave")
    d = torch.rand((Kc, 8), generator=g) * 100
    d[::9] = 0.0
    src_b = torch.randint(0, max(2, B // 16), (Kc,), generator=g)   # crowded groups
    dst_b = torch.randint(0, max(2, B // 4), (Kc,), generator=g)
    wave_ok = torch.rand(Kc, generator=g) > 0.2
    part = torch.randint(0, 1500, (Kc,), generator=g)
    ss = torch.rand((B, 8), generator=g) * 2000
    ds = torch.rand((B, 8), generator=g) * 2000
    ss[:, 5] = torch.inf
    sg = (torch.rand(B, generator=g) * 500).to(dev)
    dg = (torch.rand(B, generator=g) * 500).to(dev)
    esc = (torch.rand(Kc, generator=g) > 0.97).to(dev)
    base = [t.to(dev) for t in (d, src_b, dst_b, wave_ok, part, ss, ds)]
    for gain in (None, (sg, dg, 2)):
        args = (*base, gain, esc)
        check(torch, e, lambda: K.wave_admission(*args),
              lambda: admission.wave_admission_plain(*args),
              f"adversarial gain={'none' if gain is None else 'dim 2'}")
    args = adm["ReplicaDistributionGoal"][2]
    timing(torch, e, lambda: K.wave_admission(*args),
           lambda: admission.wave_admission_plain(*args), None,
           nbytes(*args[:7], *args[7][:2], args[8]) + Kc,
           Kc * 8 * 6, f"K={Kc}")

    # --- K4/K5 segment_sum ------------------------------------------------
    e = entries["segment_sum"]
    vals_r, seg_r = refresh_sum_inputs(env, st)
    check(torch, e, lambda: K.segment_sum(vals_r, seg_r, B),
          lambda: segment.segment_sum_plain(vals_r, seg_r, B), f"refresh R={R}")
    r_sorted, dst_s, args = adm["ReplicaDistributionGoal"]
    win = K.wave_admission(*args)
    vals_a, seg_a, init_a = apply_sum_inputs(env, st, r_sorted, dst_s, win)
    check(torch, e, lambda: K.segment_sum(vals_a, seg_a, B, init_a),
          lambda: segment.segment_sum_plain(vals_a, seg_a, B, init_a),
          f"apply wave of {int(win.sum())} moves")
    av = (torch.randn((3 * Kc, 17), generator=g) * 1000).to(dev)
    aseg = torch.randint(-1, 8, (3 * Kc,), generator=g).to(dev)  # long segments
    ainit = (torch.randn((B, 17), generator=g) * 1e5).to(dev)
    check(torch, e, lambda: K.segment_sum(av, aseg, B, ainit),
          lambda: segment.segment_sum_plain(av, aseg, B, ainit),
          "adversarial long segments")
    lib_seg = torch.where(seg_a >= 0, seg_a, torch.full_like(seg_a, B))
    lib_init = torch.cat([init_a, torch.zeros_like(init_a[:1])])
    timing(torch, e, lambda: K.segment_sum(vals_a, seg_a, B, init_a),
           lambda: segment.segment_sum_plain(vals_a, seg_a, B, init_a),
           lambda: torch.index_add(lib_init, 0, lib_seg, vals_a),
           nbytes(vals_a, seg_a, init_a) + B * vals_a.shape[1] * 4,
           vals_a.numel(), f"apply N={vals_a.shape[0]} C={vals_a.shape[1]} nseg={B}")
    lib_seg_r = torch.where(seg_r >= 0, seg_r, torch.full_like(seg_r, B))
    zeros_r = torch.zeros((B + 1, vals_r.shape[1]), dtype=torch.float32, device=dev)
    timing(torch, e, lambda: K.segment_sum(vals_r, seg_r, B),
           lambda: segment.segment_sum_plain(vals_r, seg_r, B),
           lambda: torch.index_add(zeros_r, 0, lib_seg_r, vals_r),
           nbytes(vals_r, seg_r) + B * vals_r.shape[1] * 4, vals_r.numel(),
           f"refresh N={R} C={vals_r.shape[1]} nseg={B}")
    disk_sum_checks(torch, e, env, st, (r_sorted, dst_s, win), timed=False)

    # --- K4/K5 segment_count ----------------------------------------------
    e = entries["segment_count"]
    rack = goals[0]
    viol = (rack._violating(env, st) | (st.replica_offline & env.replica_valid)).to(torch.int32)
    rb = st.replica_broker
    check(torch, e, lambda: K.segment_count(rb, B, viol),
          lambda: segment.segment_count_plain(rb, B, viol), f"rack severity R={R}")
    flat = env.replica_partition * env.num_racks + env.broker_rack[rb]
    vw = env.replica_valid.to(torch.int32)
    nseg = env.num_partitions * env.num_racks
    check(torch, e, lambda: K.segment_count(flat, nseg, vw),
          lambda: segment.segment_count_plain(flat, nseg, vw), "refresh partition x rack")
    zeros_b = torch.zeros(B, dtype=torch.int32, device=dev)
    timing(torch, e, lambda: K.segment_count(rb, B, viol),
           lambda: segment.segment_count_plain(rb, B, viol),
           lambda: torch.index_add(zeros_b, 0, rb, viol),
           nbytes(rb, viol) + B * 4, R, f"N={R} nseg={B}")
    counts = apply_move_count_inputs(env, st, r_sorted, dst_s, win)
    for what, a in zip(("replica", "leader", "partition x rack", "topic x broker",
                        "topic leader"), counts):
        check(torch, e, lambda: K.segment_count(*a),
              lambda: segment.segment_count_plain(*a),
              f"apply wave {what} counts N={a[0].shape[0]} nseg={a[1]}")
    for a in counts[0], counts[3]:
        seg_c, nseg_c, w_c, init_c = a
        timing(torch, e, lambda: K.segment_count(*a),
               lambda: segment.segment_count_plain(*a),
               lambda: torch.index_add(init_c, 0, seg_c, w_c),
               nbytes(*a) + nseg_c * 4, seg_c.shape[0],
               f"apply N={seg_c.shape[0]} nseg={nseg_c}")
    return entries


def disk_sum_checks(torch, e: Entry, env, st, wave, timed: bool) -> None:
    """K4/K5 ``segment_sum`` at the per-logdir disk tallies (C = 1, nseg =
    B * D): refresh's sums over every replica, and one move wave's update
    (``wave``: its rows, destinations and admission mask)."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.state import (
        apply_disk_sum_inputs, apply_sum_inputs, refresh_disk_inputs,
    )
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.kernels import segment

    replicas, dsts, mask = wave
    vals = apply_sum_inputs(env, st, replicas, dsts, mask)[0]
    ref = refresh_disk_inputs(env, st)
    app = apply_disk_sum_inputs(env, st, replicas, dsts, mask,
                                vals[replicas.shape[0]:, Resource.DISK])[:4]
    shapes = {"refresh": f"N={ref[0].shape[0]} C=1 nseg={ref[2]}",
              "apply": f"N={app[0].shape[0]} C=1 nseg={app[2]}"}
    for what, a, note in (("refresh", ref, ""),
                          ("apply", app, f", {int(mask.sum())} moves in the wave")):
        check(torch, e, lambda: K.segment_sum(*a), lambda: segment.segment_sum_plain(*a),
              f"{what} disk tallies {shapes[what]}{note}")
    if not timed:
        return
    for what, a in (("refresh", ref), ("apply", app)):
        v, seg, n = a[:3]
        init = a[3] if len(a) > 3 else torch.zeros((n, 1), dtype=v.dtype, device=v.device)
        lib_seg = torch.where(seg >= 0, seg, torch.full_like(seg, n))
        lib_init = torch.cat([init, torch.zeros_like(init[:1])])
        timing(torch, e, lambda: K.segment_sum(*a), lambda: segment.segment_sum_plain(*a),
               lambda: torch.index_add(lib_init, 0, lib_seg, v),
               nbytes(*a) + n * 4, v.numel(), f"{what} disk {shapes[what]}", plain_reps=3)


def chain_kernel_checks(torch, ctx, entries: dict, seed: int) -> None:
    """Phase 3, second part: the kernels of the eleven-goal chain at its
    shapes on the slice state — K6 (leadership branch [KL, F], lead scan
    [chunk, F], segment lead wave [K, F] x S colors), K1's compaction and
    the finisher's top-(K * W), K2 with T = 1 (move scan) and with the
    room-ordered columns (segment move wave), K3 with N = K * S rows,
    per-(topic, broker) budgets and leadership deltas."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.state import (
        apply_lead_count_inputs, apply_lead_sum_inputs,
    )
    from cruise_control_tpu_torch.kernels import (
        admission, leadership, move_score, segment, select,
    )

    env, st, params = ctx["env"], ctx["st"], ctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed + 1)
    goals = make_goals(CHAIN)
    R, B = env.num_replicas, env.num_brokers
    chunk = min(params.scan_chunk, R)
    pad = -(-R // chunk) * chunk
    Kf = min(params.finisher_candidates, R)
    W = max(1, min(params.finisher_waves, R // max(Kf, 1)))
    KL = min(params.num_leader_candidates, R)
    S, active = engine._segments(params, env)
    F = env.max_rf
    log(f"chain kernel checks: R={R} B={B} F={F} KL={KL} chunk={chunk} "
        f"K={Kf} K*W={Kf * W} S={S} K*S={Kf * S}")
    i_rd, i_lrd, i_lbi = (CHAIN.index(n) for n in (
        "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
        "LeaderBytesInDistributionGoal"))

    # --- K1 compact_eligible ------------------------------------------------
    e = entries["compact_eligible"]
    elig = {}
    for i in (i_rd, i_lrd):
        gl = goals[i]
        elig[gl.name] = gl.replica_key(env, st, gl.broker_severity(env, st)) > -torch.inf
    gl = goals[i_lbi]
    elig["LBI leaders"] = gl.leader_key(env, st, gl.broker_severity(env, st)) > -torch.inf
    for frac in (0.0, 0.3, 1.0):
        elig[f"adversarial {frac}"] = (torch.rand(R, generator=g) < frac).to(dev)
    for name, el in elig.items():
        check(torch, e, lambda: K.compact_eligible(el, pad),
              lambda: select.compact_eligible_plain(el, pad), f"{name} R={R}")
    el = elig["ReplicaDistributionGoal"]
    n_el = int(el.sum())
    timing(torch, e, lambda: K.compact_eligible(el, pad),
           lambda: select.compact_eligible_plain(el, pad),
           lambda: torch.nonzero(el).flatten(), R + pad * 8, R,
           f"R={R} eligible={n_el}")

    # the scans the finisher runs first (their gains feed the waves below)
    scans = {}
    for i in (i_rd, i_lrd):
        scans[goals[i].name] = engine._exhaustive_move_scan(
            env, st, goals[i], tuple(goals[:i]), chunk)[0]
    scans["LBI leaders"] = engine._exhaustive_lead_scan(
        env, st, goals[i_lbi], tuple(goals[:i_lbi]), chunk)[0]

    # --- K1 select_candidates at the finisher's k ---------------------------
    e = entries["select_candidates"]
    adv = torch.randn(R, generator=g)
    adv[::3] = -torch.inf
    adv[::7] = 0.25
    adv[3::11] = -0.0
    adv[4::11] = 0.0
    keys = dict(scans, adversarial=adv.to(dev))
    kw = Kf * W
    for name, key in keys.items():
        check(torch, e, lambda: K.select_candidates(key, kw, 0, 0),
              lambda: select.select_candidates_plain(key, kw, 0, 0),
              f"finisher top-k {name} k={kw}")
    key = scans["ReplicaDistributionGoal"]
    timing(torch, e, lambda: K.select_candidates(key, kw, 0, 0),
           lambda: select.select_candidates_plain(key, kw, 0, 0),
           lambda: torch.topk(key, kw), nbytes(key) + kw * (4 + 8), 4 * R,
           f"R={R} k={kw}")
    tops = {n: K.select_candidates(v, kw, 0, 0) for n, v in scans.items()}

    def band(name):
        kv, cand = tops[name]
        kv = kv[:Kf]
        return cand[:Kf].contiguous(), torch.where(
            kv > params.min_gain, kv, torch.full_like(kv, -torch.inf)).contiguous()

    # --- the leadership branch's pass: K1 at k = KL on the leader keys, K6
    # [KL, F], K3 in leadership form, K4/K5 on the transfer apply ----------
    e = entries["leadership_rows"]
    lead_pass = {}
    for i in (CHAIN.index("CpuCapacityGoal"), i_lrd, i_lbi):
        gl, prev = goals[i], tuple(goals[:i])
        lkey = gl.leader_key(env, st, gl.broker_severity(env, st)).contiguous()
        check(torch, entries["select_candidates"],
              lambda: K.select_candidates(lkey, KL, 0, 0),
              lambda: select.select_candidates_plain(lkey, KL, 0, 0),
              f"{gl.name} leader keys k={KL}")
        lkv, lcand = K.select_candidates(lkey, KL, 0, 0)
        args = engine._lead_args(env, st, gl, prev, lcand, lkv > -torch.inf)
        check(torch, e, lambda: K.leadership_rows(*args),
              lambda: leadership.leadership_rows_plain(*args),
              f"{gl.name} branch [{KL}, {F}], {i} previous goals")
        r_sorted, dst_rep, adm_args = engine._lead_admission_args(
            env, st, gl, prev, params, lcand, lkv)
        check(torch, entries["wave_admission"], lambda: K.wave_admission(*adm_args),
              lambda: admission.wave_admission_plain(*adm_args),
              f"{gl.name} leadership branch N={KL}")
        win = K.wave_admission(*adm_args)
        vals_l, seg_l, init_l = apply_lead_sum_inputs(env, st, r_sorted, dst_rep, win)
        sum_args = (vals_l, seg_l, B, init_l)
        check(torch, entries["segment_sum"], lambda: K.segment_sum(*sum_args),
              lambda: segment.segment_sum_plain(*sum_args),
              f"{gl.name} transfer apply of {int(win.sum())} winners "
              f"N={sum_args[0].shape[0]} C={sum_args[0].shape[1]}")
        counts = apply_lead_count_inputs(env, st, r_sorted, dst_rep, win)
        for what, a in zip(("leader", "topic leader"), counts):
            check(torch, entries["segment_count"], lambda: K.segment_count(*a),
                  lambda: segment.segment_count_plain(*a),
                  f"{gl.name} transfer apply {what} counts nseg={a[1]}")
        lead_pass[gl.name] = (lkey, adm_args, sum_args, counts)
    order, _n = K.compact_eligible(elig["LBI leaders"], pad)
    idx = order[:chunk]
    cand = torch.clamp(idx, max=R - 1)
    scan_args = engine._lead_args(env, st, goals[i_lbi], tuple(goals[:i_lbi]), cand,
                                  idx < R)
    check(torch, e, lambda: K.leadership_rows(*scan_args),
          lambda: leadership.leadership_rows_plain(*scan_args),
          f"LeaderBytesInDistributionGoal lead scan [{chunk}, {F}]")
    cand, kv = band("LBI leaders")
    gl = goals[i_lbi]
    ob = engine._segment_broker_order(env, st, gl, tuple(goals[:i_lbi]), S)
    colrank = torch.empty_like(ob)
    colrank[ob] = torch.arange(ob.shape[0], device=dev)
    color = (colrank % S).contiguous()
    seg_args = engine._lead_args(env, st, gl, tuple(goals[:i_lbi]), cand, kv > -torch.inf)
    check(torch, e, lambda: K.leadership_rows(*seg_args, color=color, S=S, active=active),
          lambda: leadership.leadership_rows_plain(*seg_args, color, S, active),
          f"LeaderBytesInDistributionGoal segment wave [{Kf}, {F}] x {S} colors")
    # adversarial: random tables for every family, two vetoes, planted ties
    n_adv, Ra = 1024, 5000
    a_cand = torch.randint(0, Ra, (n_adv,), generator=g)
    a_mem = torch.randint(-1, Ra, (n_adv, 4), generator=g)
    a_mem[:, 0] = a_cand
    fr = torch.randint(-2, 3, (Ra,), generator=g).float()
    base = [a_cand, a_mem, torch.rand(n_adv, generator=g) > 0.1,
            torch.rand(B, generator=g) > 0.05, torch.randint(0, B, (Ra,), generator=g),
            torch.rand(Ra, generator=g) < 0.05]
    base = [t.to(dev).contiguous() for t in base]
    vetoes = [leadership.Veto(torch.randint(0, 5, (B,), generator=g).float().to(dev),
                              torch.randint(0, 7, (B,), generator=g).float().to(dev),
                              x_rep=fr.to(dev)),
              leadership.Veto(torch.randint(0, 5, (B,), generator=g).float().to(dev),
                              torch.randint(0, 7, (B,), generator=g).float().to(dev),
                              x_row=torch.ones(n_adv, device=dev))]
    fb = torch.randint(0, 6, (3, B), generator=g).float()
    fb[2] += 3
    a_color = torch.randint(0, S, (B,), generator=g).to(dev)
    for fam in range(4):
        tb = leadership.LeadTables(
            fam, fb.to(dev), torch.randint(0, 4, (2, n_adv), generator=g).float().to(dev),
            fr=fr.to(dev), row_t=torch.randint(0, 16, (n_adv,), generator=g).to(dev),
            tab=torch.randint(0, 3, (16, B), generator=g).int().to(dev))
        a = (*base, tb, vetoes)
        check(torch, e, lambda: K.leadership_rows(*a, color=a_color, S=S, active=S - 2),
              lambda: leadership.leadership_rows_plain(*a, a_color, S, S - 2),
              f"adversarial family {fam}")
    lkv, lcand = K.select_candidates(goals[i_lrd].leader_key(
        env, st, goals[i_lrd].broker_severity(env, st)).contiguous(), KL, 0, 0)
    br_args = engine._lead_args(env, st, goals[i_lrd], tuple(goals[:i_lrd]), lcand,
                                lkv > -torch.inf)

    timing(torch, e, lambda: K.leadership_rows(*br_args),
           lambda: leadership.leadership_rows_plain(*br_args), None,
           lead_bytes(KL, F), KL * F * 30, f"branch [{KL}, {F}]")
    timing(torch, e, lambda: K.leadership_rows(*scan_args),
           lambda: leadership.leadership_rows_plain(*scan_args), None,
           lead_bytes(chunk, F), chunk * F * 30, f"lead scan [{chunk}, {F}]")
    timing(torch, e, lambda: K.leadership_rows(*seg_args, color=color, S=S, active=active),
           lambda: leadership.leadership_rows_plain(*seg_args, color, S, active), None,
           lead_bytes(Kf, F) + Kf * S * 12, Kf * F * (30 + S),
           f"segment wave [{Kf}, {F}] x {S}")
    lkey, adm_args, sum_args, counts = lead_pass["LeaderReplicaDistributionGoal"]
    timing(torch, entries["select_candidates"], lambda: K.select_candidates(lkey, KL, 0, 0),
           lambda: select.select_candidates_plain(lkey, KL, 0, 0),
           lambda: torch.topk(lkey, KL), nbytes(lkey) + KL * (4 + 8), 4 * R,
           f"leader keys R={R} k={KL}")
    timing(torch, entries["wave_admission"], lambda: K.wave_admission(*adm_args),
           lambda: admission.wave_admission_plain(*adm_args), None,
           nbytes(*adm_args) + KL, KL * (8 + 1) * 4 * 4, f"leadership branch N={KL}")
    vals_l, seg_l, _B, init_l = sum_args
    lib_seg_l = torch.where(seg_l >= 0, seg_l, torch.full_like(seg_l, B))
    lib_init_l = torch.cat([init_l, torch.zeros_like(init_l[:1])])
    timing(torch, entries["segment_sum"], lambda: K.segment_sum(*sum_args),
           lambda: segment.segment_sum_plain(*sum_args),
           lambda: torch.index_add(lib_init_l, 0, lib_seg_l, vals_l),
           nbytes(vals_l, seg_l, init_l) + init_l.numel() * 4, vals_l.numel(),
           f"transfer apply N={vals_l.shape[0]} C={vals_l.shape[1]} nseg={B}")
    for a in counts:
        timing(torch, entries["segment_count"], lambda: K.segment_count(*a),
               lambda: segment.segment_count_plain(*a),
               lambda: torch.index_add(a[3], 0, a[0], a[2]),
               nbytes(*a) + a[1] * 4, a[0].shape[0],
               f"transfer apply N={a[0].shape[0]} nseg={a[1]}")

    # --- K2 move_score_classes: T = 1 and the room-ordered columns -----------
    e = entries["move_score_classes"]
    t1 = {}
    for i in (i_rd, i_lrd):
        gl, prev = goals[i], tuple(goals[:i])
        order, _n = K.compact_eligible(elig[gl.name], pad)
        idx = order[:chunk]
        cand = torch.clamp(idx, max=R - 1)
        rooms, custom = engine._combined_move_rooms(prev, env, st)
        d_rows = engine.move_delta_rows(env, st, cand)
        args = engine._score_args(env, st, gl, rooms, custom, cand, None, d_rows, 1,
                                  row_ok=idx < R)
        t1[gl.name] = args
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"{gl.name} move scan T=1 [{chunk}, {B}]")
    seg2 = {}
    for i, name in ((i_rd, "ReplicaDistributionGoal"),
                    (i_lrd, "LeaderReplicaDistributionGoal")):
        gl, prev = goals[i], tuple(goals[:i])
        cand, kv = band(name)
        rooms, custom = engine._combined_move_rooms(prev, env, st)
        d_rows = engine.move_delta_rows(env, st, cand)
        ob = engine._segment_broker_order(env, st, gl, prev, S)
        args = engine._score_args(env, st, gl, rooms, custom, cand, kv, d_rows, S,
                                  order_b=ob)
        seg2[name] = args
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"{name} segment wave [{Kf}, {ob.shape[0]}] ordered, {S} classes")
    args = seg2["ReplicaDistributionGoal"]
    Bp = args[16].shape[0]
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(t for t in args if isinstance(t, torch.Tensor))) + Kf * S * 12,
           Kf * Bp * 16, f"K={Kf} Bp={Bp} S={S} ordered")
    args = t1["ReplicaDistributionGoal"]
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(t for t in args if isinstance(t, torch.Tensor))) + chunk * 12,
           chunk * B * 16, f"K={chunk} B={B} T=1")

    # --- K3 wave_admission: K * S rows, topic budgets, leadership deltas -----
    e = entries["wave_admission"]
    adm = {}
    for i, name in ((i_rd, "ReplicaDistributionGoal"),
                    (i_lrd, "LeaderReplicaDistributionGoal")):
        cand, kv = band(name)
        adm[name] = engine._segment_move_args(env, st, goals[i], tuple(goals[:i]),
                                              params, cand, kv)[3]
    cand, kv = band("LBI leaders")
    adm["LBI leaders"] = engine._segment_lead_args(
        env, st, goals[i_lbi], tuple(goals[:i_lbi]), params, cand, kv)[4]
    for name, args in adm.items():
        check(torch, e, lambda: K.wave_admission(*args),
              lambda: admission.wave_admission_plain(*args),
              f"{name} segment wave N={args[0].shape[0]} "
              f"topic budgets={'yes' if args[11] is not None else 'no'}")
    N = Kf * S
    d = torch.rand((N, 8), generator=g) * 100
    d[::9] = 0.0
    a = [d, torch.randint(0, max(2, B // 16), (N,), generator=g),
         torch.randint(0, max(2, B // 4), (N,), generator=g),
         torch.rand(N, generator=g) > 0.2, torch.randint(0, 3000, (N,), generator=g),
         torch.rand((B, 8), generator=g) * 2000, torch.rand((B, 8), generator=g) * 2000]
    a = [t.to(dev) for t in a]
    gain = ((torch.rand(B, generator=g) * 500).to(dev),
            (torch.rand(B, generator=g) * 500).to(dev), 2)
    topic = (torch.randint(0, 200, (N,), generator=g).to(dev), 224,
             (torch.rand((N, 1), generator=g) > 0.5).float().to(dev),
             torch.randint(0, 3, (N, 1), generator=g).float().to(dev),
             torch.full((N, 1), torch.inf, device=dev))
    kg = (torch.randint(0, Kf, (N,), generator=g).to(dev), Kf)
    esc = (torch.rand(N, generator=g) > 0.97).to(dev)
    d_dst = (torch.rand((N, 8), generator=g) * 100).to(dev)
    args = (*a, gain, esc, d_dst, kg, topic, 3000)
    check(torch, e, lambda: K.wave_admission(*args),
          lambda: admission.wave_admission_plain(*args),
          f"adversarial N={N} crowded, candidate and partition first-touch, topics")
    args = adm["ReplicaDistributionGoal"]
    n = args[0].shape[0]
    timing(torch, e, lambda: K.wave_admission(*args),
           lambda: admission.wave_admission_plain(*args), None,
           nbytes(*args[:4], args[4], args[8], args[10][0], *args[11][2:])
           + 2 * B * 8 * 4 + n, n * (8 + 1) * 4 * 4, f"N={n} (K*S) with topic budgets")


def swap_kernel_checks(torch, ctx, entries: dict, seed: int) -> None:
    """Phase 3, third part: the kernels the sixteen default goals add, on the
    slice state — K7 ``swap_rows`` and ``swap_admission`` at [K1, K2] =
    [32, 32] for each swap goal with its default-chain prefix (and with the
    prefix minus CpuCapacityGoal, which is violated here and vetoes every
    swap), K4/K5 on the swap apply's two legs, K2's resource-distribution
    and topic-replica families and topic veto, K6's capacity family for
    the usage goals and their vetoes; then K7 at [128, 128] on adversarial
    ``--seed`` inputs (planted ties, all -inf rows, every row picking one
    in-candidate, shared partitions and brokers, every veto kind)."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.state import (
        apply_move_count_inputs, apply_moves_batched, apply_sum_inputs,
    )
    from cruise_control_tpu_torch.kernels import (
        leadership, move_score, segment, select, swap,
    )

    env, st, params = ctx["env"], ctx["st"], ctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed + 2)
    goals = make_goals(DEFAULT)
    R, B = env.num_replicas, env.num_brokers
    k = min(params.num_swap_candidates, R, 128)
    mg = params.min_gain
    log(f"swap kernel checks: R={R} B={B} K1=K2={k} min_gain={mg}")

    def open_prefix(i):
        return tuple(x for x in goals[:i] if x.name != "CpuCapacityGoal")

    def swap_pass(i, prev, stall):
        gl = goals[i]
        okv, co, ikv, ci = engine._swap_pools(env, st, gl, params,
                                              gl.broker_severity(env, st), stall)
        pairs, tables = engine._swap_args(env, st, gl, prev, co, okv, ci, ikv)
        return co, ci, pairs, tables

    def admission_args(co, ci, pairs, rows):
        best, best_j, _n = rows
        order = engine._desc_order(best)
        j_s = best_j[order].contiguous()
        r_out, r_in = co[order], ci[j_s]
        return (r_out, r_in), (best[order].contiguous(), pairs.b_out[order].contiguous(),
                               pairs.b_in[j_s].contiguous(), j_s,
                               env.replica_partition[r_out].contiguous(),
                               env.replica_partition[r_in].contiguous(), mg)

    e_rows, e_adm = entries["swap_rows"], entries["swap_admission"]
    swap_i = [DEFAULT.index(n) for n in SWAP_GOALS]
    timed = {}
    for i in swap_i:
        for which, prev in (("default", tuple(goals[:i])), ("open", open_prefix(i))):
            for stall in ((0, 3) if which == "open" else (0,)):
                co, ci, pairs, tables = swap_pass(i, prev, stall)
                tag = f"{goals[i].name} {which} prefix stall={stall} [{k}, {k}]"
                check(torch, e_rows, lambda: K.swap_rows(pairs, tables, mg),
                      lambda: swap.swap_rows_plain(pairs, tables, mg), tag)
                rows = K.swap_rows(pairs, tables, mg)
                legs, adm = admission_args(co, ci, pairs, rows)
                check(torch, e_adm, lambda: K.swap_admission(*adm),
                      lambda: swap.swap_admission_plain(*adm), tag)
                if which == "open" and stall == 0:
                    timed[goals[i].name] = (pairs, tables, legs, adm, rows)
    # K4/K5 on the swap apply's two legs (the out leg first, both from the
    # pre-wave brokers): the first open-prefix wave that admits swaps
    waves = [(name, w, int(K.swap_admission(*w[3]).sum())) for name, w in timed.items()]
    name, (pairs, tables, (r_out, r_in), adm, rows), n_win = next(
        (x for x in waves if x[2] > 0), (None, (None,) * 5, 0))
    require(n_win > 0, f"no swap goal's open-prefix wave admits a swap: {waves}")
    win = K.swap_admission(*adm)
    log(f"  swap apply: {name}'s wave admits {n_win} of {k} rows")
    b_out, b_in = st.replica_broker[r_out], st.replica_broker[r_in]
    st1 = st
    for leg, (reps, dsts) in enumerate(((r_out, b_in), (r_in, b_out))):
        vals, seg, init = apply_sum_inputs(env, st1, reps, dsts, win)
        sum_args = (vals, seg, B, init)
        check(torch, entries["segment_sum"], lambda: K.segment_sum(*sum_args),
              lambda: segment.segment_sum_plain(*sum_args),
              f"swap apply leg {leg + 1} of {n_win} swaps N={vals.shape[0]} "
              f"C={vals.shape[1]}")
        for what, a in zip(("replica", "leader", "partition x rack", "topic x broker",
                            "topic leader"),
                           apply_move_count_inputs(env, st1, reps, dsts, win)):
            check(torch, entries["segment_count"], lambda: K.segment_count(*a),
                  lambda: segment.segment_count_plain(*a),
                  f"swap apply leg {leg + 1} {what} counts N={a[0].shape[0]} nseg={a[1]}")
        if leg == 0:
            swap_sum_args = sum_args
            swap_count_args = apply_move_count_inputs(env, st1, reps, dsts, win)[0]
            st1 = apply_moves_batched(env, st1, reps, dsts, win)
    timing(torch, e_rows, lambda: K.swap_rows(pairs, tables, mg),
           lambda: swap.swap_rows_plain(pairs, tables, mg), None,
           *swap_rows_work(pairs, tables), f"pass [{k}, {k}]")
    timing(torch, e_adm, lambda: K.swap_admission(*adm),
           lambda: swap.swap_admission_plain(*adm), None,
           nbytes(*adm[:6]) + k, k * k * 10, f"K1={k}")
    vals, seg, _B, init = swap_sum_args
    lib_seg = torch.where(seg >= 0, seg, torch.full_like(seg, B))
    lib_init = torch.cat([init, torch.zeros_like(init[:1])])
    timing(torch, entries["segment_sum"], lambda: K.segment_sum(*swap_sum_args),
           lambda: segment.segment_sum_plain(*swap_sum_args),
           lambda: torch.index_add(lib_init, 0, lib_seg, vals),
           nbytes(vals, seg, init) + init.numel() * 4, vals.numel(),
           f"swap apply leg N={vals.shape[0]} C={vals.shape[1]} nseg={B}")
    a = swap_count_args
    timing(torch, entries["segment_count"], lambda: K.segment_count(*a),
           lambda: segment.segment_count_plain(*a),
           lambda: torch.index_add(a[3], 0, a[0], a[2]), nbytes(*a) + a[1] * 4,
           a[0].shape[0], f"swap apply leg N={a[0].shape[0]} nseg={a[1]}")
    gl = goals[swap_i[0]]
    okey = gl.swap_out_key(env, st, gl.broker_severity(env, st)).contiguous()
    check(torch, entries["select_candidates"], lambda: K.select_candidates(okey, k, 3, 0),
          lambda: select.select_candidates_plain(okey, k, 3, 0),
          f"{gl.name} swap-out keys k={k} stall=3")
    timing(torch, entries["select_candidates"], lambda: K.select_candidates(okey, k, 0, 0),
           lambda: select.select_candidates_plain(okey, k, 0, 0),
           lambda: torch.topk(okey, k), nbytes(okey) + k * (4 + 8), 4 * R,
           f"swap pool R={R} k={k}")

    # K2: the usage and topic-replica families (the goal's own first wave)
    # and LeaderReplicaDistributionGoal behind TopicReplica's topic veto
    e = entries["move_score_classes"]
    Kc = min(params.num_candidates, R)
    T = min(params.num_dst_choices, B)
    i_lrd = DEFAULT.index("LeaderReplicaDistributionGoal")
    for i in swap_i + [i_lrd]:
        gl, prev = goals[i], tuple(goals[:i])
        key = gl.replica_key(env, st, gl.broker_severity(env, st)).contiguous()
        kv, cand = K.select_candidates(key, Kc, 0, 0)
        rooms, custom = engine._combined_move_rooms(prev, env, st)
        args = engine._score_args(env, st, gl, rooms, custom, cand, kv,
                                  engine.move_delta_rows(env, st, cand), T)
        require((args[18] is not None) == (i == i_lrd),
                f"{gl.name}: the topic veto is {'missing' if i == i_lrd else 'present'}")
        check(torch, e, lambda: K.move_score_classes(*args),
              lambda: move_score.move_score_classes_plain(*args),
              f"{gl.name} family {args[0]}, {i} previous goals"
              f"{', topic veto' if args[18] is not None else ''} [{Kc}, {B}] T={T}")
        if i == swap_i[0]:
            rd_args = args
    timing(torch, e, lambda: K.move_score_classes(*rd_args),
           lambda: move_score.move_score_classes_plain(*rd_args), None,
           nbytes(*(t for t in rd_args if isinstance(t, torch.Tensor))) + Kc * T * (4 + 8),
           Kc * B * 30, f"K={Kc} B={B} T={T} resource-distribution family")

    # K6: the capacity family of the CPU / NW_OUT usage goals, and
    # LeaderReplicaDistributionGoal behind the usage goals' vetoes
    e = entries["leadership_rows"]
    KL = min(params.num_leader_candidates, R)
    for name in ("NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
                 "LeaderReplicaDistributionGoal"):
        i = DEFAULT.index(name)
        gl, prev = goals[i], tuple(goals[:i])
        lkey = gl.leader_key(env, st, gl.broker_severity(env, st)).contiguous()
        lkv, lcand = K.select_candidates(lkey, KL, 0, 0)
        args = engine._lead_args(env, st, gl, prev, lcand, lkv > -torch.inf)
        check(torch, e, lambda: K.leadership_rows(*args),
              lambda: leadership.leadership_rows_plain(*args),
              f"{name} branch [{KL}, {env.max_rf}], {len(args[7])} vetoes")
        if name == "CpuUsageDistributionGoal":
            cpu_args = args
    F = env.max_rf
    timing(torch, e, lambda: K.leadership_rows(*cpu_args),
           lambda: leadership.leadership_rows_plain(*cpu_args), None,
           KL * F * (8 + 8 + 1 + 1 + 4 * 2 * (1 + len(cpu_args[7]))) + KL * (8 + 1 + 8)
           + KL * (4 + 8), KL * F * (10 + 3 * len(cpu_args[7])),
           f"branch [{KL}, {F}] CPU usage (capacity family, {len(cpu_args[7])} vetoes)")

    # K7 adversarial at [128, 128]
    n, Ba, Ta, F, Kr = 128, 24, 6, 4, 4

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g)

    def adversarial(family, ties):
        b_out, b_in = ri(0, 10, (n,)), ri(6, Ba, (n,))       # shared brokers
        row_ok_out = torch.rand(n, generator=g) > 0.1         # all -inf rows
        row_ok_out[:8] = False
        p = swap.SwapPairs(
            b_out=b_out, b_in=b_in, sib_out=ri(-1, Ba, (n, F)), sib_in=ri(-1, Ba, (n, F)),
            orig_out=ri(0, Ba, (n,)), orig_in=ri(0, Ba, (n,)), row_ok_out=row_ok_out,
            row_ok_in=torch.rand(n, generator=g) > 0.1,
            new_ok=torch.rand(Ba, generator=g) > 0.3, broker_rack=torch.arange(Ba) % Kr,
            t_out=ri(0, Ta, (n,)), t_in=ri(0, Ta, (n,)),
            tab=ri(0, 6, (Ta, Ba)).int(), prow_out=ri(0, 2, (n, Kr)),
            prow_in=ri(0, 2, (n, Kr)), lim_out=torch.ones(n, dtype=torch.int32),
            lim_in=torch.ones(n, dtype=torch.int32),
            vetoes=[swap.SwapVeto(kind, ri(0, 50, (Ba,)).float(), ri(40, 90, (Ba,)).float(),
                                  ri(0, 20, (n,)).float(), ri(0, 20, (n,)).float(),
                                  lo=ri(0, 30, (Ba,)).float())
                    for kind in range(4)],
            topic_up=ri(3, 8, (Ta,)).float())
        if family == swap.SWAP_RESOURCE_DIST:
            u = ri(0, 100, (Ba,)).float()
            x_in = torch.full((n,), 5.0) if ties else torch.rand(n, generator=g) * 20
            x_in[0] = 0.0 if ties else x_in[0]      # one in-candidate every row prefers
            t = swap.SwapTables(family, fb=torch.stack([u, u * 0 + 30.0, u * 0 + 60.0]),
                                x_out=ri(0, 30, (n,)).float(), x_in=x_in)
        else:
            t = swap.SwapTables(family, tl=torch.stack([ri(0, 2, (Ta,)).float(),
                                                        ri(2, 5, (Ta,)).float()]))
        p.vetoes = [to_device(v, dev) for v in p.vetoes]
        return to_device(p, dev), to_device(t, dev)

    for family in (swap.SWAP_RESOURCE_DIST, swap.SWAP_TOPIC_REPLICA):
        for ties in (False, True):
            for strip in (False, True):
                p, t = adversarial(family, ties)
                if strip:       # no vetoes, so more pairs score and tie
                    p = dataclasses.replace(p, vetoes=[], prow_out=None, prow_in=None,
                                            lim_out=None, lim_in=None, topic_up=None)
                check(torch, e_rows, lambda: K.swap_rows(p, t, mg),
                      lambda: swap.swap_rows_plain(p, t, mg),
                      f"adversarial family {family} ties={ties} vetoes={not strip} "
                      f"[{n}, {n}]")
    val = torch.tensor([1.0, 2.0, -float("inf"), 1e-10])[ri(0, 4, (n,))]
    val = val.sort(descending=True, stable=True).values
    adm = tuple(x.to(dev).contiguous() for x in (val, ri(0, 16, (n,)), ri(8, 24, (n,)),
                                                 ri(0, 8, (n,)), ri(0, 24, (n,)),
                                                 ri(0, 24, (n,)))) + (mg,)
    check(torch, e_adm, lambda: K.swap_admission(*adm),
          lambda: swap.swap_admission_plain(*adm),
          f"adversarial K1={n} crowded brokers, in-candidates and partitions")


def two_rack_state(torch, ctx):
    """The slice cluster with its brokers remapped to 2 racks (``b % 2``):
    RackAwareDistributionGoal's limit ceil(RF / 2) reaches 2 for RF 3. Its
    padded env and initial state on the card."""
    import numpy as np
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
    ct = dataclasses.replace(ctx["ct"], broker_rack=(
        np.arange(ctx["ct"].num_brokers) % 2).astype(np.int32))
    meta = dataclasses.replace(ctx["meta"], num_racks=2, rack_ids=["r0", "r1"])
    pct, pmeta = pad_cluster(ct, meta)
    env = make_env(pct, pmeta, device=ctx["env"].device)
    return env, init_state(env, pct.replica_broker, pct.replica_is_leader,
                           pct.replica_offline, pct.replica_disk)


def rack_kernel_checks(torch, ctx, entries: dict, seed: int) -> None:
    """Phase 3, the rack-distribution part: K2's GOAL_RACK_DIST family and
    the rack-limit veto (``others + 1 <= lim``) of K2 and K7, on the slice
    state (20 racks: every limit 1), on the slice cluster remapped to 2
    racks (limit 2 for RF 3; a chain holding both rack goals takes the
    minimum) and on adversarial ``--seed`` inputs with limits 0-3 and
    per-rack counts 0-3. Each at the main path's shapes: the move wave
    [K, B] at T, the exhaustive scan [chunk, B] at T = 1, K7's pass
    [32, 32]."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.kernels import move_score, swap

    env, st, params = ctx["env"], ctx["st"], ctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed + 4)
    R, B = env.num_replicas, env.num_brokers
    Kc, T = min(params.num_candidates, R), min(params.num_dst_choices, B)
    chunk = min(params.scan_chunk, R)
    k = min(params.num_swap_candidates, R, 128)
    mg = params.min_gain
    goals = make_goals(FULL_CHAIN[:-1])                 # PLE runs after the chain
    i_rd, i_repl, i_disk = (FULL_CHAIN.index(n) for n in (
        "RackAwareDistributionGoal", "ReplicaDistributionGoal",
        "DiskUsageDistributionGoal"))
    rd, repl, disk = goals[i_rd], goals[i_repl], goals[i_disk]
    e, e_rows = entries["move_score_classes"], entries["swap_rows"]
    states = {f"{env.num_real_racks} racks": (env, st),
              "2 racks": two_rack_state(torch, ctx)}
    timed = {}
    for tag, (env_s, st_s) in states.items():
        lim = rd.rack_limit(env_s, env_s.replica_partition[env_s.replica_valid])
        log(f"rack kernel checks, {tag}: RackAwareDistributionGoal limits "
            f"{sorted(set(lim.tolist()))}, violated {bool(rd.violated(env_s, st_s))}")
        require(int(lim.max()) == (2 if tag == "2 racks" else 1),
                f"{tag}: unexpected rack limits {int(lim.max())}")
        # the family, alone and behind RackAwareGoal (FULL_CHAIN's order)
        key = rd.replica_key(env_s, st_s, rd.broker_severity(env_s, st_s)).contiguous()
        kv, cand = K.select_candidates(key, Kc, 0, 0)
        n_rows = int((kv > -torch.inf).sum())
        d_rows = engine.move_delta_rows(env_s, st_s, cand)
        for prev in ((), tuple(goals[:i_rd])):
            rooms, custom = engine._combined_move_rooms(prev, env_s, st_s)
            args = engine._score_args(env_s, st_s, rd, rooms, custom, cand, kv, d_rows, T)
            require(args[0] == move_score.GOAL_RACK_DIST
                    and (args[10] is not None) == bool(prev), f"{tag}: the family's args")
            check(torch, e, lambda: K.move_score_classes(*args),
                  lambda: move_score.move_score_classes_plain(*args),
                  f"{tag}: rack-distribution family, {len(prev)} previous goals "
                  f"[{Kc}, {B}] T={T}, {n_rows} violating rows")
            timed[("family", tag)] = args
        # the veto: ReplicaDistributionGoal behind both rack goals (limit
        # min(1, ceil(RF / racks))) and behind RackAwareDistributionGoal
        # alone, its first wave at T and a move scan at T = 1
        key = repl.replica_key(env_s, st_s, repl.broker_severity(env_s, st_s)).contiguous()
        kv, cand = K.select_candidates(key, Kc, 0, 0)
        order, _n = K.compact_eligible(key > -torch.inf, -(-R // chunk) * chunk)
        idx = order[:chunk]
        scan = torch.clamp(idx, max=R - 1)
        for what, prev in (("both rack goals", tuple(goals[:i_repl])),
                           ("RackAwareDistributionGoal", (rd,))):
            rooms, custom = engine._combined_move_rooms(prev, env_s, st_s)
            args = engine._score_args(env_s, st_s, repl, rooms, custom, cand, kv,
                                      engine.move_delta_rows(env_s, st_s, cand), T)
            require(args[10] is not None, f"{tag}: no rack-limit veto behind {what}")
            check(torch, e, lambda: K.move_score_classes(*args),
                  lambda: move_score.move_score_classes_plain(*args),
                  f"{tag}: ReplicaDistributionGoal behind {what}, limits "
                  f"{sorted(set(args[10].tolist()))} [{Kc}, {B}] T={T}")
            timed[("veto", tag)] = args
            sargs = engine._score_args(env_s, st_s, repl, rooms, custom, scan, None,
                                       engine.move_delta_rows(env_s, st_s, scan), 1,
                                       row_ok=idx < R)
            check(torch, e, lambda: K.move_score_classes(*sargs),
                  lambda: move_score.move_score_classes_plain(*sargs),
                  f"{tag}: move scan behind {what} [{chunk}, {B}] T=1")
        # K7: DiskUsageDistributionGoal's swap pass behind FULL_CHAIN's
        # prefix (CpuCapacityGoal, violated here, left out: it vetoes every
        # swap) and behind RackAwareDistributionGoal alone
        okv, co, ikv, ci = engine._swap_pools(env_s, st_s, disk, params,
                                              disk.broker_severity(env_s, st_s), 0)
        for what, prev in (("the open prefix", tuple(
                x for x in goals[:i_disk] if x.name != "CpuCapacityGoal")),
                ("RackAwareDistributionGoal", (rd,))):
            pairs, tables = engine._swap_args(env_s, st_s, disk, prev, co, okv, ci, ikv)
            require(pairs.lim_out is not None, f"{tag}: no rack legs behind {what}")
            check(torch, e_rows, lambda: K.swap_rows(pairs, tables, mg),
                  lambda: swap.swap_rows_plain(pairs, tables, mg),
                  f"{tag}: DiskUsageDistributionGoal swap pass behind {what}, limits "
                  f"{sorted(set(pairs.lim_out.tolist()) | set(pairs.lim_in.tolist()))} "
                  f"[{k}, {k}]")
            timed[("swap", tag)] = (pairs, tables)

    # adversarial: limits 0-3 against per-rack counts 0-3 (the row's own
    # rack holds at least itself), every family with and without the veto
    F, Kr = 4, 3
    cur_b = torch.randint(0, B, (Kc,), generator=g)
    rack = torch.arange(B) % Kr
    prow = torch.randint(0, 4, (Kc, Kr), generator=g)
    own = prow.gather(1, rack[cur_b][:, None]).clamp(min=1)
    prow = prow.scatter(1, rack[cur_b][:, None], own)
    row_f = torch.stack([(torch.rand(Kc, generator=g) > 0.3).float(),
                         torch.randint(1, 4, (Kc,), generator=g).float(),
                         torch.zeros(Kc), torch.zeros(Kc)], 1)
    col_f = torch.zeros((4, B))
    col_f[0] = torch.randint(0, 3, (B,), generator=g).float()     # planted ties
    col_f[1] = 1.0
    a = dict(cur_b=cur_b, orig_b=torch.randint(0, B, (Kc,), generator=g),
             sib_b=torch.randint(-1, B, (Kc, F), generator=g),
             row_ok=torch.rand(Kc, generator=g) > 0.1,
             d_rows=torch.zeros((Kc, 8)), dst_room=torch.zeros((8, B)), prow=prow,
             row_f=row_f, col_f=col_f, dst_ok=torch.rand(B, generator=g) > 0.05,
             new_ok=torch.ones(B, dtype=torch.bool), broker_rack=rack)
    a = {n: t.to(dev).contiguous() for n, t in a.items()}
    lim = torch.randint(0, 4, (Kc,), generator=g, dtype=torch.int32).to(dev)
    for fam in (move_score.GOAL_RACK_DIST, move_score.GOAL_RACK,
                move_score.GOAL_REPLICA_CAPACITY):
        for veto in (None, lim):
            for TT in (T, 1):
                args = (fam, TT, a["cur_b"], a["orig_b"], a["sib_b"], a["row_ok"],
                        a["d_rows"], a["dst_room"], 0, a["prow"], veto, a["row_f"],
                        a["col_f"], a["dst_ok"], a["new_ok"], a["broker_rack"])
                check(torch, e, lambda: K.move_score_classes(*args),
                      lambda: move_score.move_score_classes_plain(*args),
                      f"adversarial family {fam} limits 1-3, veto "
                      f"{'0-3' if veto is not None else 'none'} [{Kc}, {B}] T={TT}")
    n, Ba = 128, 24
    rk = torch.arange(Ba) % Kr
    b_out = torch.randint(0, Ba, (n,), generator=g)
    b_in = torch.randint(0, Ba, (n,), generator=g)

    def counts(b):
        c = torch.randint(0, 4, (n, Kr), generator=g)
        return c.scatter(1, rk[b][:, None], c.gather(1, rk[b][:, None]).clamp(min=1))

    u = torch.randint(0, 100, (Ba,), generator=g).float()
    p = swap.SwapPairs(
        b_out=b_out, b_in=b_in, sib_out=torch.randint(-1, Ba, (n, F), generator=g),
        sib_in=torch.randint(-1, Ba, (n, F), generator=g),
        orig_out=torch.randint(0, Ba, (n,), generator=g),
        orig_in=torch.randint(0, Ba, (n,), generator=g),
        row_ok_out=torch.rand(n, generator=g) > 0.1,
        row_ok_in=torch.rand(n, generator=g) > 0.1,
        new_ok=torch.ones(Ba, dtype=torch.bool), broker_rack=rk,
        t_out=torch.zeros(n, dtype=torch.long), t_in=torch.zeros(n, dtype=torch.long),
        tab=torch.zeros((1, Ba), dtype=torch.int32), prow_out=counts(b_out),
        prow_in=counts(b_in),
        lim_out=torch.randint(1, 4, (n,), generator=g, dtype=torch.int32),
        lim_in=torch.randint(1, 4, (n,), generator=g, dtype=torch.int32))
    t = swap.SwapTables(swap.SWAP_RESOURCE_DIST,
                        fb=torch.stack([u, u * 0 + 30.0, u * 0 + 60.0]),
                        x_out=torch.randint(0, 30, (n,), generator=g).float(),
                        x_in=torch.randint(0, 30, (n,), generator=g).float())
    p, t = to_device(p, dev), to_device(t, dev)
    check(torch, e_rows, lambda: K.swap_rows(p, t, mg),
          lambda: swap.swap_rows_plain(p, t, mg),
          f"adversarial rack legs, limits 1-3 against counts 0-3 [{n}, {n}]")

    args = timed[("family", "2 racks")]
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(t for t in args if isinstance(t, torch.Tensor))) + Kc * T * (4 + 8),
           Kc * B * 14, f"K={Kc} B={B} T={T} rack-distribution family (2 racks)")
    args = timed[("veto", "2 racks")]
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(t for t in args if isinstance(t, torch.Tensor))) + Kc * T * (4 + 8),
           Kc * B * 16, f"K={Kc} B={B} T={T} rack-limit veto (2 racks)")
    pairs, tables = timed[("swap", "2 racks")]
    timing(torch, e_rows, lambda: K.swap_rows(pairs, tables, mg),
           lambda: swap.swap_rows_plain(pairs, tables, mg), None,
           nbytes(*(x for x in fields_of(pairs) + fields_of(tables)
                    if x is not pairs.tab)) + k * (4 + 8 + 4),
           k * k * (60 + 10 * len(pairs.vetoes)), f"pass [{k}, {k}] rack legs (2 racks)")


def jbod_context(torch):
    """The JBOD slice cluster (host), its padded form and its state on the
    card, with the scaled engine parameters of the padded shape."""
    import numpy as np
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    ct, meta = generate_scale(RandomClusterSpec(**JBOD_SPEC))
    dem = np.zeros(ct.num_brokers, bool)
    dem[DEMOTED] = True
    ct_demoted = dataclasses.replace(ct, broker_demoted=dem)
    pct, pmeta = pad_cluster(ct, meta)
    env = make_env(pct, pmeta, device="cuda")
    st = init_state(env, pct.replica_broker, pct.replica_is_leader,
                    pct.replica_offline, pct.replica_disk)
    penv_dem = make_env(*pad_cluster(ct_demoted, meta), device="cuda")
    params = GoalOptimizer(device="cuda").scaled_params(pct.num_replicas,
                                                       pct.num_brokers)
    log(f"jbod cluster: {meta.num_valid_replicas} replicas, "
        f"{int(ct.replica_offline.sum())} offline, R={pct.num_replicas} "
        f"B={pct.num_brokers} D={pct.num_disks} P={pct.num_partitions} "
        f"K={params.num_candidates}")
    return dict(ct=ct, ct_demoted=ct_demoted, meta=meta, env=env, st=st,
                env_demoted=penv_dem, params=params)


def disk_kernel_checks(torch, jctx, entries: dict, seed: int) -> None:
    """Phase 3, JBOD part: K8 ``disk_rows`` / ``disk_apply`` at K x D on the
    JBOD slice state (each intra-broker goal's first pass: K1's candidates,
    its previous goal's veto) and on an adversarial state (every logdir's
    utilization scaled by a random factor in [0.5, 2.5) or, for three in
    ten, by 50 to put it over its limit; 1,760 candidates from 40 brokers;
    every row maximum positive with planted ties, so the walk's order
    decides); K1 ``select_candidates`` on both intra goals' keys (dead-disk
    priority, -inf rows) at k = K; K12 ``preferred_leader`` at P x F with
    the five brokers demoted, with nothing demoted, and with random leader
    flags; K4/K5 ``segment_sum`` at the B x D disk tallies of refresh and of
    the ten-goal chain's first wave."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.goals.base import disk_state
    from cruise_control_tpu_torch.kernels import disk, ple, select

    env, st, params = jctx["env"], jctx["st"], jctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed)
    R, (B, D) = env.num_replicas, env.broker_disk_capacity.shape
    Kd = min(params.num_candidates, R)
    mg = params.min_gain
    e_rows, e_apply = entries["disk_rows"], entries["disk_apply"]
    cap_goal, band_goal = make_goals(INTRA)
    ds = disk_state(env, st)
    passes = {}
    e_sel = entries["select_candidates"]
    keys = {}
    for goal, prev in ((cap_goal, ()), (band_goal, (cap_goal,))):
        key = goal.replica_key(env, st, goal.broker_severity(env, st)).contiguous()
        keys[goal.name] = key
        for stall in (0, 3):
            check(torch, e_sel, lambda: K.select_candidates(key, Kd, stall, 0),
                  lambda: select.select_candidates_plain(key, Kd, stall, 0),
                  f"{goal.name} keys R={R} k={Kd} stall={stall}")
        kv, cand = K.select_candidates(key, Kd, 0, 0)
        rule = goal.disk_rule()
        vetoes = [p.disk_rule() for p in prev]
        args = (ds, cand, kv, rule, vetoes)
        check(torch, e_rows, lambda: K.disk_rows(*args),
              lambda: disk.disk_rows_plain(*args), f"{goal.name} first pass K={Kd} D={D}")
        best = K.disk_rows(*args)
        order = engine._desc_order(best).contiguous()
        aargs = (ds, cand, best, order, rule, vetoes, mg)
        check(torch, e_apply, lambda: K.disk_apply(*aargs),
              lambda: disk.disk_apply_plain(*aargs),
              f"{goal.name} first pass, {int((best > mg).sum())} rows walked")
        passes[goal.name] = (args, aargs, int((best > mg).sum()))
    # adversarial: crowded logdirs, several rows per broker, all rows positive
    scale = torch.rand((B, D), generator=g) * 2.0 + 0.5
    scale = torch.where(torch.rand((B, D), generator=g) < 0.3, 50.0, scale).to(dev)
    ds_adv = dataclasses.replace(ds, dutil=(ds.dutil * scale).contiguous())
    brokers = torch.randperm(B, generator=g)[:40].to(dev)
    pool = torch.nonzero(env.replica_valid & torch.isin(st.replica_broker, brokers))
    cand = pool.flatten()[torch.randperm(pool.shape[0], generator=g)[:Kd].to(dev)]
    cand = cand.contiguous()
    kv = torch.where(torch.rand(cand.shape[0], generator=g) < 0.1, -torch.inf,
                     1.0).to(dev)
    vals = torch.tensor([3.0, 2.0, 2.0, 1.0, 0.5, 1e-8])
    best = vals[torch.randint(0, vals.shape[0], (cand.shape[0],), generator=g)].to(dev)
    order = engine._desc_order(best).contiguous()
    for goal, prev in ((cap_goal, ()), (band_goal, (cap_goal,)), (cap_goal, (band_goal,))):
        rule, vetoes = goal.disk_rule(), [p.disk_rule() for p in prev]
        args = (ds_adv, cand, kv, rule, vetoes)
        check(torch, e_rows, lambda: K.disk_rows(*args),
              lambda: disk.disk_rows_plain(*args),
              f"adversarial {goal.name} after {len(prev)} goals")
        aargs = (ds_adv, cand, best, order, rule, vetoes, mg)
        got = K.disk_apply(*aargs)
        check(torch, e_apply, lambda: K.disk_apply(*aargs),
              lambda: disk.disk_apply_plain(*aargs),
              f"adversarial {goal.name} after {len(prev)} goals, all {cand.shape[0]} "
              f"rows walked, {int(got[4])} applied")
    # times at the band goal's first pass (the most rows walked)
    key = keys[band_goal.name]
    timing(torch, e_sel, lambda: K.select_candidates(key, Kd, 0, 0),
           lambda: select.select_candidates_plain(key, Kd, 0, 0),
           lambda: torch.topk(key, Kd), nbytes(key) + Kd * (4 + 8), 4 * R,
           f"disk keys R={R} k={Kd}")
    args, aargs, walked = passes[band_goal.name]
    row_bytes = 8 + 4 + 8 + 8 + 1 + 4 + 1 + 1 + 4       # the row's reads, best written
    state_bytes = B * D * (1 + 4 + 4) + B
    timing(torch, e_rows, lambda: K.disk_rows(*args),
           lambda: disk.disk_rows_plain(*args), None,
           Kd * row_bytes + state_bytes, Kd * D * 30, f"K={Kd} D={D}")
    timing(torch, e_apply, lambda: K.disk_apply(*aargs),
           lambda: disk.disk_apply_plain(*aargs), None,
           walked * (8 + 4 + 8 + row_bytes + D * 9 + 2 * 4 + 8 + 1 + 1)
           + 2 * (B * D * 4 + R * 10),
           walked * D * 40, f"K={Kd} D={D}, {walked} rows walked", plain_reps=3)

    # --- K12 preferred_leader -------------------------------------------
    e = entries["preferred_leader"]
    env_d = jctx["env_demoted"]
    Pn, F = env_d.partition_replicas.shape
    flips = (torch.rand(R, generator=g) < 0.1).to(dev)
    for what, en, lead in (("demoted", env_d, st.replica_is_leader),
                           ("steady", env, st.replica_is_leader),
                           ("random leader flags", env_d, st.replica_is_leader ^ flips)):
        pargs = (en.partition_replicas, st.replica_broker, lead.contiguous(),
                 st.replica_offline, en.broker_alive, en.broker_excluded_for_leadership,
                 en.broker_demoted, st.leadership_moved)
        for apply in (True, False):
            check(torch, e, lambda: K.preferred_leader(*pargs, apply=apply),
                  lambda: ple.preferred_leader_apply_plain(*pargs, apply),
                  f"{what} P={Pn} F={F} apply={apply}")
    pargs = (env_d.partition_replicas, st.replica_broker, st.replica_is_leader,
             st.replica_offline, env_d.broker_alive, env_d.broker_excluded_for_leadership,
             env_d.broker_demoted, st.leadership_moved)
    n_viol = int(K.preferred_leader(*pargs, apply=False)[2])
    n_members = int((env_d.partition_replicas >= 0).sum())
    # the member table, each real member's broker, offline and leader flags,
    # the three broker flag arrays and the count; applying adds the two
    # flag copies (read and written) and two rows of both flags per flip
    need = Pn * F * 8 + n_members * (8 + 1 + 1) + 3 * B + 4
    for apply in (True, False):
        timing(torch, e, lambda: K.preferred_leader(*pargs, apply=apply),
               lambda: ple.preferred_leader_apply_plain(*pargs, apply), None,
               need + (4 * R + 4 * n_viol if apply else 0),
               Pn * F * 10, f"P={Pn} F={F} {'apply' if apply else 'check'}")

    # --- K4/K5 segment_sum at D logdirs: refresh and a first wave's update
    goal = make_goals(JBOD_CHAIN[:1])[0]
    key = goal.replica_key(env, st, goal.broker_severity(env, st)).contiguous()
    kv, cand = K.select_candidates(key, Kd, 0, 0)
    r_sorted, dst_s, aargs = engine._admission_args(env, st, goal, (), params, cand, kv)
    disk_sum_checks(torch, entries["segment_sum"], env, st,
                    (r_sorted, dst_s, K.wave_admission(*aargs)), timed=True)


def rung_context(torch, spec: dict, tag: str) -> dict:
    """A BASELINE rung's cluster (host), its padded form and its state on
    the card, with the scaled engine parameters of the padded shape."""
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    t0 = time.perf_counter()
    ct, meta = generate_scale(RandomClusterSpec(**spec))
    pct, pmeta = pad_cluster(ct, meta)
    env = make_env(pct, pmeta, device="cuda")
    st = init_state(env, pct.replica_broker, pct.replica_is_leader,
                    pct.replica_offline, pct.replica_disk)
    params = GoalOptimizer(device="cuda").scaled_params(pct.num_replicas,
                                                       pct.num_brokers)
    log(f"{tag}: {meta.num_valid_replicas} replicas "
        f"({int(ct.replica_offline.sum())} offline), R={pct.num_replicas} "
        f"B={pct.num_brokers} D={pct.num_disks} P={pct.num_partitions}; "
        f"generated and on the card in {time.perf_counter() - t0:.3f} s")
    log(f"{tag}: scaled parameters: compute_dtype={params.compute_dtype} "
        f"K={params.num_candidates} KL={params.num_leader_candidates} "
        f"T={params.num_dst_choices} swap pool "
        f"{min(params.num_swap_candidates, pct.num_replicas, 128)} "
        f"pass_waves={params.pass_waves} finisher K={params.finisher_candidates}")
    return dict(ct=ct, meta=meta, env=env, st=st, params=params)


def rung_kernel_checks(torch, rctx: dict, entries: dict, tag: str,
                       sums: bool = True) -> None:
    """Phase 3 at a 7,000-broker rung's shapes (the scale faults the
    1,000-broker cells could not show), each kernel against its twin on the
    bf16 sweep view: K1 at R 1,048,576 (k 7,040 at stalls 0 and 3, and the
    finisher's 10,560), K2 at [1,760, 7,168] with T 71 (padded ``Bp``), K3,
    K4/K5's apply and refresh sums and counts at 7,168 (and 28,672 logdir)
    segments, K6 at KL 896, K7 at [128, 128]; for ReplicaDistributionGoal
    and the usage goals after their default-chain prefixes.
    ``sums`` False (rung 5): the per-goal kernels on the rung's own state
    (offline-healing keys, gain escapes), then the logdir sums checked but
    not timed; the finisher's top-k and the refresh sums are rung 4's
    shapes, checked there (the cut pays for phase 10)."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.state import (
        apply_move_count_inputs, apply_sum_inputs, refresh_disk_inputs,
        refresh_sum_inputs,
    )
    from cruise_control_tpu_torch.kernels import (
        admission, leadership, move_score, segment, select, swap,
    )
    env, st, params = rctx["env"], rctx["st"], rctx["params"]
    env_sw = engine._sweep_env(env, params)
    env_k, st_k = engine._sweep_view(env, st, env_sw)
    R, B = env.num_replicas, env.num_brokers
    Kc = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(Kc, 1)))
    T = min(params.num_dst_choices, B)
    goals = make_goals(DEFAULT)
    for i in (7, 9, 12):   # ReplicaDistribution, DiskUsage, CpuUsage
        goal, prev = goals[i], tuple(goals[:i])
        sev = goal.broker_severity(env, st)
        key = goal.replica_key(env_k, st_k, sev).contiguous()
        for stall in (0, 3):
            check(torch, entries["select_candidates"],
                  lambda: K.select_candidates(key, Kc * W, stall, 0),
                  lambda: select.select_candidates_plain(key, Kc * W, stall, 0),
                  f"{tag} {goal.name} R={R} k={Kc * W} stall={stall}")
        kv, cand = K.select_candidates(key, Kc * W, 0, 0)
        cand, kv = cand[:Kc].contiguous(), kv[:Kc].contiguous()
        rooms, custom = engine._combined_move_rooms(prev, env, st)
        d_rows = engine.move_delta_rows(env, st, cand)
        sargs = engine._score_args(env, st, goal, rooms, custom, cand, kv, d_rows, T,
                                   env_sw=env_sw)
        check(torch, entries["move_score_classes"], lambda: K.move_score_classes(*sargs),
              lambda: move_score.move_score_classes_plain(*sargs),
              f"{tag} {goal.name} K={Kc} B={B} T={T}")
        if tag == "rung 4" and i == 9:
            # the rung's own shapes: K1 over R ~ 1M, K2 at [1,760, 7,168], T 71
            timing(torch, entries["select_candidates"],
                   lambda: K.select_candidates(key, Kc * W, 0, 0),
                   lambda: select.select_candidates_plain(key, Kc * W, 0, 0),
                   lambda: torch.topk(key, Kc * W), nbytes(key) + Kc * W * (4 + 8),
                   4 * R, f"{tag} R={R} k={Kc * W}")
            rooms_used = bin(sargs[8]).count("1")
            timing(torch, entries["move_score_classes"],
                   lambda: K.move_score_classes(*sargs),
                   lambda: move_score.move_score_classes_plain(*sargs), None,
                   nbytes(*(t for t in sargs if isinstance(t, torch.Tensor)))
                   + Kc * T * (4 + 8), Kc * B * (2 * rooms_used + 12),
                   f"{tag} K={Kc} B={B} T={T}")
        r_sorted, dst_s, aargs = engine._admission_args(env, st, goal, prev, params,
                                                        cand, kv, env_sw)
        check(torch, entries["wave_admission"], lambda: K.wave_admission(*aargs),
              lambda: admission.wave_admission_plain(*aargs), f"{tag} {goal.name} wave")
        win = K.wave_admission(*aargs)
        va, sa, ia = apply_sum_inputs(env, st, r_sorted, dst_s, win)
        check(torch, entries["segment_sum"], lambda: K.segment_sum(va, sa, B, ia),
              lambda: segment.segment_sum_plain(va, sa, B, ia),
              f"{tag} {goal.name} apply of {int(win.sum())} moves")
        for a in apply_move_count_inputs(env, st, r_sorted, dst_s, win):
            check(torch, entries["segment_count"], lambda: K.segment_count(*a),
                  lambda: segment.segment_count_plain(*a),
                  f"{tag} {goal.name} apply counts nseg={a[1]}", quiet=True)
        if goal.uses_leadership_moves:
            lkey = goal.leader_key(env_k, st_k, sev).contiguous()
            KL = min(params.num_leader_candidates, R)
            lkv, lcand = K.select_candidates(lkey, KL, 0, 0)
            largs = engine._lead_args(env, st, goal, prev, lcand, lkv > -torch.inf, env_sw)
            check(torch, entries["leadership_rows"], lambda: K.leadership_rows(*largs),
                  lambda: leadership.leadership_rows_plain(*largs),
                  f"{tag} {goal.name} KL={KL}")
        if goal.uses_swaps:
            okv, co, ikv, ci = engine._swap_pools(env_k, st_k, goal, params, sev, 0)
            pairs, tables = engine._swap_args(env, st, goal, prev, co, okv, ci, ikv,
                                              env_sw)
            check(torch, entries["swap_rows"],
                  lambda: K.swap_rows(pairs, tables, params.min_gain),
                  lambda: swap.swap_rows_plain(pairs, tables, params.min_gain),
                  f"{tag} {goal.name} [{co.shape[0]}, {ci.shape[0]}]")
    kf = min(params.finisher_candidates, R) * max(1, min(params.finisher_waves,
                                                           R // params.finisher_candidates))
    D = env.broker_disk_capacity.shape[1]
    if not sums:
        vals, seg, _nseg = refresh_disk_inputs(env, st)
        check(torch, entries["segment_sum"], lambda: K.segment_sum(vals, seg, B * D),
              lambda: segment.segment_sum_plain(vals, seg, B * D),
              f"{tag} logdir sums R={R} nseg={B * D}")
        # timed without its twin, which takes seconds here (7E: 3.46 s)
        lib_seg = torch.where(seg >= 0, seg, torch.full_like(seg, B * D))
        zeros_d = torch.zeros((B * D + 1, 1), dtype=torch.float32, device=env.device)
        timing(torch, entries["segment_sum"], lambda: K.segment_sum(vals, seg, B * D),
               lambda: segment.segment_sum_plain(vals, seg, B * D),
               lambda: torch.index_add(zeros_d, 0, lib_seg, vals),
               nbytes(vals, seg) + B * D * 4, vals.numel(),
               f"{tag} logdir refresh N={R} C=1 nseg={B * D}", plain_reps=0)
        log(f"  {tag}: K1-K7 and the logdir sums bit-identical to their twins on this "
            f"rung's state (its finisher top-k and refresh sums: rung 4's shapes, above)")
        return
    gain = torch.where(torch.rand(R, device=env.device) < 0.3,
                       torch.rand(R, device=env.device), torch.full((R,), -torch.inf,
                                                                    device=env.device))
    check(torch, entries["select_candidates"], lambda: K.select_candidates(gain, kf, 0, 0),
          lambda: select.select_candidates_plain(gain, kf, 0, 0),
          f"{tag} finisher top-k R={R} k={kf}")
    vr, sr = refresh_sum_inputs(env, st)
    check(torch, entries["segment_sum"], lambda: K.segment_sum(vr, sr, B),
          lambda: segment.segment_sum_plain(vr, sr, B), f"{tag} refresh R={R} nseg={B}")
    # refresh's sums re-read the segment ids once per segment: timed at B
    lib_sr = torch.where(sr >= 0, sr, torch.full_like(sr, B))
    zeros_r = torch.zeros((B + 1, vr.shape[1]), dtype=torch.float32, device=env.device)
    timing(torch, entries["segment_sum"], lambda: K.segment_sum(vr, sr, B),
           lambda: segment.segment_sum_plain(vr, sr, B),
           lambda: torch.index_add(zeros_r, 0, lib_sr, vr),
           nbytes(vr, sr) + B * vr.shape[1] * 4, vr.numel(),
           f"{tag} refresh N={R} C={vr.shape[1]} nseg={B}", plain_reps=3)
    D = env.broker_disk_capacity.shape[1]
    if D > 1:
        vals, seg, _nseg = refresh_disk_inputs(env, st)
        check(torch, entries["segment_sum"], lambda: K.segment_sum(vals, seg, B * D),
              lambda: segment.segment_sum_plain(vals, seg, B * D),
              f"{tag} logdir sums R={R} nseg={B * D}")
        lib_seg = torch.where(seg >= 0, seg, torch.full_like(seg, B * D))
        zeros_d = torch.zeros((B * D + 1, 1), dtype=torch.float32, device=env.device)
        timing(torch, entries["segment_sum"], lambda: K.segment_sum(vals, seg, B * D),
               lambda: segment.segment_sum_plain(vals, seg, B * D),
               lambda: torch.index_add(zeros_d, 0, lib_seg, vals),
               nbytes(vals, seg) + B * D * 4, vals.numel(),
               f"{tag} logdir refresh N={R} C=1 nseg={B * D}", plain_reps=3)
    log(f"  {tag}: K1-K7 bit-identical to their twins at this rung's shapes")


# ---------------------------------------------------------------------------
# phase 3: the redesigned segment_sum and K1 at their edges
# ---------------------------------------------------------------------------
# (what, N, C, nseg) of the forms' timings: the main path's apply shapes
# (move, residual, leadership, swap leg, logdir update, the fleet's lane
# applies at L 16 x B 100), products on both sides of the cut-over, and
# refresh's shapes
FORM_SHAPES = (("move apply", 3520, 9, 1024), ("residual", 3520, 8, 1024),
               ("leadership apply", 256, 16, 1024), ("swap leg", 64, 17, 1024),
               ("logdir update", 3520, 1, 4096), ("lane apply", 5120, 9, 1600),
               ("lane residual", 5120, 8, 1600), ("lane disk", 5120, 1, 1600),
               ("segment wave", 14080, 9, 1024), ("mid", 20000, 9, 1024),
               ("mid", 40000, 9, 1024), ("refresh", 114688, 9, 1024),
               ("disk tallies", 114688, 1, 4096))


def seg_inputs(torch, g, dev, N: int, C: int, nseg: int, masked: float = 0.5,
               init: bool = True) -> tuple:
    """(values f32[N, C], seg i64[N], nseg, init f32[nseg, C] or None) of a
    synthetic apply: ``masked`` of the rows at seg -1, the rest uniform."""
    vals = (torch.randn((N, C), generator=g) * 100).to(dev).contiguous()
    seg = torch.randint(0, nseg, (N,), generator=g)
    seg[torch.rand(N, generator=g) < masked] = -1
    ini = (torch.randn((nseg, C), generator=g) * 1e4).to(dev).contiguous() if init else None
    return vals, seg.to(dev).contiguous(), nseg, ini


def seg_edge_cases(torch, g, dev) -> list:
    """(what, args) of segment_sum's edge cases, each run in both forms."""
    from cruise_control_tpu_torch.kernels import segment
    cases = []
    v, _s, _n, ini = seg_inputs(torch, g, dev, 20000, 9, 1)
    cases.append(("one segment holds every row N=20000 C=9",
                  (v, torch.zeros(20000, dtype=torch.int64, device=dev), 1, ini)))
    v, _s, _n, ini = seg_inputs(torch, g, dev, 20000, 9, 7)
    cases.append(("all rows in segment 3 of 7, the others empty",
                  (v, torch.full((20000,), 3, dtype=torch.int64, device=dev), 7, ini)))
    v, s, _n, _i = seg_inputs(torch, g, dev, 50000, 4, 1667, masked=0.0, init=False)
    cases.append(("empty segments (every third of 5,000 holds rows), no init",
                  (v, (3 * s).contiguous(), 5000, None)))
    v, _s, _n, ini = seg_inputs(torch, g, dev, 50000, 9, 2000)
    s = torch.randint(-3, 2003, (50000,), generator=g).to(dev)
    cases.append(("rows with seg < 0 and seg >= nseg", (v, s, 2000, ini)))
    for C in (1, 32):
        for with_init in (True, False):
            cases.append((f"C={C} init={'given' if with_init else 'none'}",
                          seg_inputs(torch, g, dev, 30000, C, 1500, init=with_init)))
    for with_init in (True, False):
        v, s, _n, ini = seg_inputs(torch, g, dev, 0, 9, 1024, init=with_init)
        cases.append((f"N=0 init={'given' if with_init else 'none'}", (v, s, 1024, ini)))
    La, B, D, Wr = 16, 100, 4, 320
    lane = torch.arange(La).repeat_interleave(Wr)
    s = lane * B * D + torch.randint(0, B * D, (La * Wr,), generator=g)
    s[torch.rand(La * Wr, generator=g) < 0.4] = -1
    v, _s, _n, ini = seg_inputs(torch, g, dev, La * Wr, 1, La * B * D)
    cases.append((f"lane ids at La*B*D={La * B * D}", (v, s.to(dev), La * B * D, ini)))
    for N in (segment.SCAN_FORM_MAX // 1024, segment.SCAN_FORM_MAX // 1024 + 1):
        cases.append((f"cut-over side N={N} nseg=1024 ({'scan' if segment.form_for(N, 1024) == segment.SCAN else 'list'} form by default)",
                      seg_inputs(torch, g, dev, N, 9, 1024)))
    # long segments beside short ones: ten of 10,000 rows, then a padding
    # block in segment 0 (the list form's CTA path)
    s = torch.randint(0, 3000, (200000,), generator=g)
    skew = torch.rand(200000, generator=g) < 0.5
    s[skew] = torch.randint(0, 10, (int(skew.sum()),), generator=g)
    s[-30000:] = 0
    v, _s, _n, ini = seg_inputs(torch, g, dev, 200000, 17, 3000)
    cases.append(("long segments and a padding block N=200000 C=17", (v, s.to(dev), 3000, ini)))
    return cases


def redesign_checks(torch, entries: dict, seed: int, r4: dict, r5: dict, lctx) -> None:
    """segment_sum (both forms) and K1 (solo and lanes) bit for bit against
    their twins at the edges (segment_sum: one segment holding every row,
    empty segments, rows outside [0, nseg), C 1 and 32, N 0, init given and
    not, lane ids at La*B*D, both sides of the cut-over, long segments;
    K1: every key equal so ties straddle k, k 1, k = n and 16,384, signed
    zeros, every key -inf, lanes with k = R); the same bits twice at the
    1,048,576-row shapes; and both segment_sum forms timed (event window and
    device time, ``device_ms``) at the main path's shapes, which set the
    cut-over."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.state import refresh_disk_inputs, refresh_sum_inputs
    from cruise_control_tpu_torch.kernels import segment, select
    dev = r4["env"].device
    g = torch.Generator().manual_seed(seed + 14)

    def against(e: Entry, got, want, what: str) -> None:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        e.max_abs_err = max(e.max_abs_err, compare(torch, got, want))
        e.checks += 1

    e = entries["segment_sum"]
    for what, a in seg_edge_cases(torch, g, dev):
        want = segment.segment_sum_plain(*a)
        for form in (None, segment.SCAN, segment.LIST):
            against(e, K.segment_sum(*a, form=form), want, f"{what} form {form}")
        log(f"  segment_sum {what}: bit-identical in both forms")

    e = entries["select_candidates"]
    R = r4["env"].num_replicas // 8    # 131,072
    kinds = {"every key equal": torch.full((R,), 0.5),
             "signed zeros": torch.where(torch.rand(R, generator=g) < 0.5,
                                         torch.tensor(-0.0), torch.tensor(0.0)),
             "every key -inf": torch.full((R,), -torch.inf),
             "integers with -inf": torch.where(torch.rand(R, generator=g) < 0.2,
                                               torch.tensor(-torch.inf),
                                               torch.randint(0, 4, (R,), generator=g).float())}
    kinds["signed zeros"][::97] = 1.0
    kinds["signed zeros"][1::89] = -1.0
    for name, key in kinds.items():
        key = key.to(dev).contiguous()
        for k in (1, 7040, select.MAX_K):
            for stall in (0, 3):
                against(e, K.select_candidates(key, k, stall, 0),
                        select.select_candidates_plain(key, k, stall, 0),
                        f"{name} k={k} stall={stall}")
        for n in (5000, select.MAX_K):
            sub = key[:n].contiguous()
            against(e, K.select_candidates(sub, n, 0, 0),
                    select.select_candidates_plain(sub, n, 0, 0), f"{name} k=n={n}")
        log(f"  select_candidates {name} R={R}: k 1, 7,040, 16,384 (stalls 0, 3) and "
            f"k = n at 5,000 and 16,384 bit-identical")
    e = entries["select_candidates_lanes"]
    Rl = lctx["stack"].num_replicas
    lk = torch.stack([kinds[list(kinds)[j % 4]][:Rl] for j in range(LANES)]).to(dev).contiguous()
    stalls = [j % 3 for j in range(LANES)]
    for k in (1, 640, Rl):
        against(e, K.select_candidates_lanes(lk, k, stalls),
                select.select_candidates_lanes_plain(lk, k, stalls), f"lanes k={k}")
    log(f"  select_candidates_lanes L={LANES} R={Rl}: the four kinds by lane, k 1, 640 "
        f"and k = R bit-identical")

    # the same bits twice at the 1,048,576-row shapes
    vr, sr = refresh_sum_inputs(r4["env"], r4["st"])
    B4 = r4["env"].num_brokers
    vd, sd, nd = refresh_disk_inputs(r5["env"], r5["st"])
    key = torch.randn(r4["env"].num_replicas, generator=g).to(dev)
    mask = (torch.rand(r4["env"].num_replicas, generator=g) < 0.3).to(dev)
    for what, fn in (("segment_sum refresh 1,048,576 x 9 -> 7,168",
                      lambda: K.segment_sum(vr, sr, B4)),
                     (f"segment_sum logdir 1,048,576 x 1 -> {nd}",
                      lambda: K.segment_sum(vd, sd, nd)),
                     ("select_candidates R 1,048,576 k 7,040",
                      lambda: K.select_candidates(key, 7040, 3, 0)),
                     ("select_candidates R 1,048,576 k 16,384, seed mask",
                      lambda: K.select_candidates(key, select.MAX_K, 0, 0, seed_mask=mask))):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        compare(torch, a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,))
        log(f"  {what}: the same bits twice")
    against(entries["select_candidates_masked"],
            K.select_candidates(key, select.MAX_K, 0, 0, seed_mask=mask),
            select.select_candidates_plain(key, select.MAX_K, 0, 0, mask),
            "R 1,048,576 k 16,384 seed mask")

    # both forms at the main path's shapes: the cut-over's evidence
    rows = []
    for what, N, C, nseg in FORM_SHAPES:
        v, sg, _n, ini = seg_inputs(torch, g, dev, N, C, nseg)
        lib_seg = torch.where(sg >= 0, sg, torch.full_like(sg, nseg))
        lib_init = torch.cat([ini, torch.zeros_like(ini[:1])])
        row = dict(what=what, N=N, C=C, nseg=nseg, default=segment.form_for(N, nseg),
                   bound_ms=bound(nbytes(v, sg, ini) + nseg * C * 4, v.numel())[0])
        for name, form in (("scan", segment.SCAN), ("list", segment.LIST)):
            fn = lambda: K.segment_sum(v, sg, nseg, ini, form=form)
            K.reset_launches()
            fn()
            row[f"{name}_launches"] = K.KERNELS["segment_sum"].cuda_launches
            row[f"{name}_ms"] = time_ms(torch, fn)
            row[f"{name}_device_ms"] = device_ms(torch, fn)
        lib = lambda: torch.index_add(lib_init, 0, lib_seg, v)
        row["index_add_ms"] = time_ms(torch, lib)
        row["index_add_device_ms"] = device_ms(torch, lib)
        rows.append(row)
        log(f"  segment_sum forms at {what} {N} x {C} -> {nseg}: scan {row['scan_ms']:.6f} "
            f"ms (device {row['scan_device_ms']:.6f}), list {row['list_ms']:.6f} ms (device "
            f"{row['list_device_ms']:.6f}, {row['list_launches']} launches), index_add "
            f"{row['index_add_ms']:.6f} ms (device {row['index_add_device_ms']:.6f}), bound "
            f"{row['bound_ms']:.6f} ms; default "
            f"{'scan' if row['default'] == segment.SCAN else 'list'}")
    log(f"segment_sum forms: {json.dumps(rows)}")


TIMED_KEYS = {("slice", "f32"), ("rung 4", "f32"), ("rung 4", "bf16")}


def key_kernel_checks(torch, states: list, entries: dict, seed: int) -> None:
    """Phase 3, K1 keying: ``replica_keys`` against its twin for every key
    function it computes (``KEY_FNS`` over ``KEY_GOALS``), with f32 tables
    and with the bf16 sweep view (``engine._sweep_env`` / ``_sweep_state``),
    on each (tag, env, state) of ``states`` and on an adversarial state made
    from ``seed`` on the first of them: loads from a few values whose
    leader - follower differences fall halfway between bf16 neighbours
    (round to nearest even decides), zeros of both signs and ties; a tenth
    of the replicas offline, leadership flipped on a fifth; severities of
    -1, -0.0, 0, 0.5 and 2. Timed at the slice state (f32) and at the
    rung-4 state (f32 and bf16) on ``ResourceDistributionGoal.replica_key``
    (its three broker rows); the torch chain it replaces is the library
    column (the twin is that chain)."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import base, make_goals
    from cruise_control_tpu_torch.kernels import keys

    e = entries["replica_keys"]
    goals = make_goals(KEY_GOALS)
    bf16 = engine.EngineParams(compute_dtype="bfloat16")

    def fns(goal):
        for cls in type(goal).__mro__:
            if cls.__name__ in KEY_FNS:
                return KEY_FNS[cls.__name__]
        raise SmokeFailure(f"no key functions listed for {goal.name}")

    def captured(goal, fn, env, st, sev):
        got = []
        real = base.replica_keys
        base.replica_keys = lambda *a: got.append(a) or real(*a)
        try:
            getattr(goal, fn)(env, st, sev)
        finally:
            base.replica_keys = real
        require(len(got) == 1, f"{goal.name}.{fn} did not run the keying kernel once")
        return got[0]

    g = torch.Generator().manual_seed(seed)
    tag0, env0, st0 = states[0]
    R, M = env0.leader_load.shape
    dev = env0.device
    lead_vals = torch.tensor([2.015625, 3.0, 1.0, 0.0, -0.0, 517.25, 1e-3])
    foll_vals = torch.tensor([0.0078125, 0.00390625, 0.0, -0.0, 2.015625, 0.75])
    pick = lambda v: v[torch.randint(0, v.shape[0], (R, M), generator=g)].to(dev)
    env_adv = dataclasses.replace(env0, leader_load=pick(lead_vals).contiguous(),
                                  follower_load=pick(foll_vals).contiguous())
    flip = (torch.rand(R, generator=g) < 0.2).to(dev)
    off = (torch.rand(R, generator=g) < 0.1).to(dev)
    st_adv = dataclasses.replace(st0, replica_is_leader=st0.replica_is_leader ^ flip,
                                 replica_offline=st0.replica_offline | off)
    sev_vals = torch.tensor([-1.0, -0.0, 0.0, 0.5, 2.0])
    B = env0.num_brokers
    sev_adv = sev_vals[torch.randint(0, 5, (B,), generator=g)].to(dev)
    runs = [(tag, env, st, None) for tag, env, st in states]
    runs.append((f"adversarial ({tag0})", env_adv, st_adv, sev_adv))
    timed = {}
    for tag, env, st, sev_fixed in runs:
        for dtype in ("f32", "bf16"):
            env_k = engine._sweep_env(env, bf16) if dtype == "bf16" else env
            st_k = engine._sweep_state(st, bf16) if dtype == "bf16" else st
            n = 0
            for goal in goals:
                sev = goal.broker_severity(env, st) if sev_fixed is None else sev_fixed
                for fn in fns(goal):
                    args = captured(goal, fn, env_k, st_k, sev)
                    check(torch, e, lambda: K.replica_keys(*args),
                          lambda: keys.replica_keys_plain(*args),
                          f"{tag} {dtype} {goal.name}.{fn}", quiet=True)
                    n += 1
                    if (fn == "replica_key" and goal.name == "DiskUsageDistributionGoal"
                            and (tag, dtype) in TIMED_KEYS):
                        timed[(tag, dtype)] = args
            log(f"  replica_keys {tag} {dtype}: {n} key functions bit-identical")
    for (tag, dtype), args in timed.items():
        L = args[1][0]
        R = L.shape[0]
        load_bytes = 2 * L.element_size()
        need = R * (load_bytes + 8 + 3 + 4) + nbytes(args[7], args[8])
        timing(torch, e, lambda: K.replica_keys(*args),
               lambda: keys.replica_keys_plain(*args),
               lambda: keys.replica_keys_plain(*args), need, 20 * R,
               f"{tag} {dtype}, ResourceDistributionGoal.replica_key")


# ---------------------------------------------------------------------------
# phase 3 and phase 10: the engine's options (the pooled K1, K2's per-goal
# veto form) and the non-budget fallbacks
# ---------------------------------------------------------------------------
# eligible shares of the pooled K1's checks: the pool (14,080 rows at the
# slice's k 7,040) holds 1% and 10% of R 114,688; 50% overflows it
POOL_SHARES = (0.01, 0.10, 0.50)
RUNG_R = 1 << 20
# the sixteen goals' previous goals and active goal of K2's per-goal checks:
# the active goal behind every interval-form goal of the chain, the rack and
# min-topic-leaders goals on K2's custom path
TERMS_GOAL = "DiskUsageDistributionGoal"


def register_no_leader_budget_goal():
    """``NoLeaderBudgetGoal``: LeaderReplicaDistributionGoal without its wave
    budgets (the reference's chains with such a goal take the one-move-per-
    broker wave and ``seq_body``; the tier-1 tests' ``_NoLeaderBudgetGoal``
    and the reference's twin in ``tests/torch_reference.py``)."""
    from cruise_control_tpu_torch.analyzer.goals import GOAL_CLASSES, GoalKernel
    from cruise_control_tpu_torch.analyzer.goals.distribution import (
        LeaderReplicaDistributionGoal,
    )

    @dataclasses.dataclass(frozen=True)
    class NoLeaderBudgetGoal(LeaderReplicaDistributionGoal):
        wave_budgets = GoalKernel.wave_budgets

        def __post_init__(self):
            super().__post_init__()
            object.__setattr__(self, "name", "NoLeaderBudgetGoal")

    GOAL_CLASSES["NoLeaderBudgetGoal"] = NoLeaderBudgetGoal


def pool_keys(torch, R: int, share: float, g, dev):
    """f32[R] keys with ``share`` of the rows eligible (the others -inf),
    planted ties among them and a few offline-healing keys (>= 5e11)."""
    key = torch.rand(R, generator=g)
    key[(torch.rand(R, generator=g) >= share)] = -torch.inf
    live = torch.nonzero(key > -torch.inf).flatten()
    key[live[::5]] = 0.5
    key[live[3::97]] = 6e11
    return key.to(dev).contiguous()


def pool_library(torch, key, mask, k: int, pool: int):
    """The library call of the pooled K1: ``torch.topk`` over the gathered
    pool (the eligible rows, compacted beforehand) when they fit it, else
    over every row."""
    elig = key > -torch.inf if mask is None else (key > -torch.inf) & mask
    idx = torch.nonzero(elig).flatten()
    if idx.shape[0] > pool:
        return lambda: torch.topk(key, k)
    gathered = torch.full((pool,), -torch.inf, device=key.device)
    gathered[:idx.shape[0]] = key[idx]
    return lambda: torch.topk(gathered, k)


def terms_args(torch, ctx, goals: list, cand, kv, T: int):
    """K2's per-goal form at the slice state: ``TERMS_GOAL`` behind its
    previous goals of the sixteen, their terms folded by dim."""
    from cruise_control_tpu_torch.analyzer import engine
    env, st = ctx["env"], ctx["st"]
    i = next(j for j, gl in enumerate(goals) if gl.name == TERMS_GOAL)
    rooms, custom, terms = engine._chain_move_vetoes(tuple(goals[:i]), env, st,
                                                     chain_cache=False)
    d_rows = engine.move_delta_rows(env, st, cand)
    return engine._score_args(env, st, goals[i], rooms, custom, cand, kv, d_rows, T,
                              terms=terms)


def plant_band_edges(torch, args, g) -> tuple:
    """The K2 arguments with band-edge bounds planted: for every term dim,
    three (row, broker) cells whose bound is set to ``lhs[b] + d[k]``
    exactly, one ulp below it (the row fails by one ulp) and one above."""
    args = list(args)
    bound = args[7].clone()
    lhs, d = args[19], args[6]
    K, B = d.shape[0], bound.shape[1]
    mask = args[8]
    n = 0
    for c in range(8):
        if not mask >> c & 1:
            continue
        ks = torch.randint(0, K, (3,), generator=g).tolist()
        bs = torch.randperm(B, generator=g)[:3].tolist()
        for (k, b), way in zip(zip(ks, bs), (0, -1, 1)):
            edge = (lhs[c, b] + d[k, c]).reshape(1)
            if way:
                edge = torch.nextafter(edge, torch.full_like(edge, way * torch.inf))
            bound[c, b] = edge[0]
            n += 1
    args[7] = bound.contiguous()
    return tuple(args), n


def option_kernel_checks(torch, ctx, lctx, entries: dict, seed: int) -> None:
    """The pooled K1 (``select_pooled``) against its twin at the slice's R
    114,688 and at R 1,048,576, k 7,040, eligible shares 1% and 10% (the
    pool) and 50% (the full sweep), stalls 0 and 3, with a seed mask, and
    in the lane form at L 16 (a branch per lane); K2's per-goal form
    (``move_score_terms``) at K 1,760, B 1,024, T 16 on the slice state with
    the sixteen goals' terms and planted band-edge rows, and its lane form
    at L 16 on the fleet cell's lanes. Bit for bit; each timed with its
    twin, the library call (``torch.topk`` over the gathered pool for K1)
    and its bound. The branch counters must show both branches."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.kernels import move_score, select
    env, st, params = ctx["env"], ctx["st"], ctx["params"]
    dev = env.device
    g = torch.Generator().manual_seed(seed + 13)
    R, B = env.num_replicas, env.num_brokers
    Kc = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(Kc, 1)))
    k_all = min(Kc * W, R)
    T = min(params.num_dst_choices, B)
    K.reset_pool_branches()

    # --- the pooled K1 ----------------------------------------------------
    e = entries["select_pooled"]
    for Rn in (R, RUNG_R):
        pool = select.pool_size(Rn, k_all, params.compact_pool)
        for share in POOL_SHARES:
            key = pool_keys(torch, Rn, share, g, dev)
            for stall in (0, 3):
                check(torch, e, lambda: K.select_pooled(key, k_all, stall, 0, pool=pool),
                      lambda: select.select_pooled_plain(key, k_all, stall, 0, pool=pool),
                      f"R={Rn} share {share} stall={stall}", quiet=True)
                kv, idx = K.select_pooled(key, k_all, stall, 0, pool=pool)
                kvf, idxf = K.select_candidates(key, k_all, stall, 0)
                live = kvf > -torch.inf
                require(torch.equal(kv.view(torch.int32), kvf.view(torch.int32))
                        and torch.equal(idx[live], idxf[live]),
                        f"select_pooled R={Rn} share {share}: not the full sweep's live rows")
            mask = (torch.rand(Rn, generator=g) < 0.3).to(dev)
            check(torch, e, lambda: K.select_pooled(key, k_all, 3, 101, seed_mask=mask,
                                                    pool=pool),
                  lambda: select.select_pooled_plain(key, k_all, 3, 101, mask, pool),
                  f"R={Rn} share {share} seed mask", quiet=True)
        log(f"  select_pooled R={Rn} k={k_all} pool={pool}: shares {POOL_SHARES} x "
            f"stalls 0, 3 and a seed mask bit-identical to the twin; the live rows the "
            f"full sweep's")
    # the leader and swap pools' k (pool 8,192): 1% eligible, and fewer
    # eligible rows than k (the pool's pad slots reach the output)
    leader_k = min(params.num_leader_candidates, R)
    swap_k = min(params.num_swap_candidates, R, 128)
    for k in (leader_k, swap_k):
        pk = select.pool_size(R, k, params.compact_pool)
        for share in (0.01, k / (2 * R)):
            key = pool_keys(torch, R, share, g, dev)
            n = int((key > -torch.inf).sum())
            for stall in (0, 3):
                check(torch, e, lambda: K.select_pooled(key, k, stall, 0, pool=pk),
                      lambda: select.select_pooled_plain(key, k, stall, 0, pool=pk),
                      f"R={R} k={k} {n} eligible stall={stall}", quiet=True)
            mask = (torch.rand(R, generator=g) < 0.5).to(dev)
            check(torch, e, lambda: K.select_pooled(key, k, 3, 101, seed_mask=mask, pool=pk),
                  lambda: select.select_pooled_plain(key, k, 3, 101, mask, pk),
                  f"R={R} k={k} {n} eligible seed mask", quiet=True)
            pads = int((K.select_pooled(key, k, 0, 0, pool=pk)[1] == R - 1).sum())
            require(n >= k or pads > 0, f"select_pooled k={k}: no pad slot with {n} eligible")
        log(f"  select_pooled R={R} k={k} pool={pk}: 1% eligible and fewer eligible rows "
            f"than k (pad slots) x stalls 0, 3 and a seed mask bit-identical to the twin")
    branches = K.pool_branch_counts()
    require(branches["pooled"] > 0 and branches["full"] > 0,
            f"select_pooled: a branch never ran {branches}")
    log(f"  select_pooled branches taken {branches}")
    pool = select.pool_size(R, k_all, params.compact_pool)
    for k in (k_all, leader_k, swap_k):
        pk = select.pool_size(R, k, params.compact_pool)
        key = pool_keys(torch, R, 0.01, g, dev)
        timing(torch, e, lambda: K.select_pooled(key, k, 0, 0, pool=pk),
               lambda: select.select_pooled_plain(key, k, 0, 0, pool=pk),
               pool_library(torch, key, None, k, pk), nbytes(key) + k * (4 + 8), 2 * R,
               f"R={R} k={k} pool={pk}, share 0.01")
    # lanes: every lane its own share (so its own branch), stall and mask
    e = entries["select_pooled_lanes"]
    shares = [POOL_SHARES[j % 3] for j in range(LANES)]
    keys = torch.stack([pool_keys(torch, R, s, g, dev) for s in shares]).contiguous()
    stalls = [j % 4 for j in range(LANES)]
    masks = (torch.rand((LANES, R), generator=g) < 0.6).to(dev)
    masks[::2] = True
    masks = masks.contiguous()
    for salt, m in ((0, None), (101, masks)):
        check(torch, e, lambda: K.select_pooled_lanes(keys, k_all, stalls, salt, m, pool),
              lambda: select.select_pooled_lanes_plain(keys, k_all, stalls, salt, m, pool),
              f"L={LANES} R={R} k={k_all} salt={salt} mask={m is not None}")
        got = K.select_pooled_lanes(keys, k_all, stalls, salt, m, pool)
        for j in range(LANES):
            solo = K.select_pooled(keys[j], k_all, stalls[j], salt,
                                   seed_mask=None if m is None else m[j], pool=pool)
            require(torch.equal(got[0][j].view(torch.int32), solo[0].view(torch.int32))
                    and torch.equal(got[1][j], solo[1]),
                    f"select_pooled_lanes: lane {j} is not its solo launch")
    log(f"  select_pooled_lanes: every lane its solo launch")
    timing(torch, e, lambda: K.select_pooled_lanes(keys, k_all, stalls, 0, None, pool),
           lambda: select.select_pooled_lanes_plain(keys, k_all, stalls, 0, None, pool),
           lambda: torch.topk(keys, k_all, dim=1), nbytes(keys) + LANES * k_all * (4 + 8),
           2 * LANES * R, f"L={LANES} R={R} k={k_all} pool={pool}")

    # --- K2's per-goal veto form --------------------------------------------
    e = entries["move_score_terms"]
    goals = make_goals(DEFAULT)
    goal = next(gl for gl in goals if gl.name == TERMS_GOAL)
    key = goal.replica_key(env, st, goal.broker_severity(env, st)).contiguous()
    kv, cand = K.select_candidates(key, k_all, 0, 0)
    cand, kv = cand[:Kc].contiguous(), kv[:Kc].contiguous()
    args = terms_args(torch, ctx, goals, cand, kv, T)
    dims = bin(args[8]).count("1")
    require(dims >= 3, f"move_score_terms: {dims} term dims")
    check(torch, e, lambda: K.move_score_classes(*args),
          lambda: move_score.move_score_classes_plain(*args),
          f"{TERMS_GOAL} behind its previous goals, {dims} term dims, T={T}")
    planted, n = plant_band_edges(torch, args, g)
    for t in (T, B):
        pa = planted[:1] + (t,) + planted[2:]
        check(torch, e, lambda: K.move_score_classes(*pa),
              lambda: move_score.move_score_classes_plain(*pa),
              f"{n} planted band-edge cells, T={t}")
    # the planted cells where the folded room (bound - lhs) and the goals'
    # own expression part (so the form matters there)
    lhs, d, bound = planted[19], planted[6], planted[7]
    rooms_ok = d.t()[:, :, None] <= (bound - lhs)[:, None, :]
    terms_ok = (lhs[:, None, :] + d.t()[:, :, None]) <= bound[:, None, :]
    log(f"  move_score_terms: the folded rooms and the terms part on "
        f"{int((rooms_ok != terms_ok).sum())} (dim, row, broker) cells of the planted state")
    timing(torch, e, lambda: K.move_score_classes(*args),
           lambda: move_score.move_score_classes_plain(*args), None,
           nbytes(*(a for a in args if isinstance(a, torch.Tensor))) + Kc * T * (4 + 8),
           Kc * B * (3 * dims + 12), f"K={Kc} B={B} T={T}")
    # lanes at the fleet cell's shape: the stack's lanes, TERMS_GOAL's terms
    e = entries["move_score_terms_lanes"]
    stack, lp = lctx["stack"], lctx["params"]
    lgoals = make_goals(DEFAULT)
    i = next(j for j, gl in enumerate(lgoals) if gl.name == TERMS_GOAL)
    Kl = min(lp.num_candidates, stack.num_replicas)
    Tl = min(lp.num_dst_choices, stack.env_b.num_brokers)
    lane_args = []
    for l in range(LANES):
        envl, stl = stack.envs[l], stack.sts[l]
        gl = lgoals[i]
        kvl, cl = K.select_candidates(
            gl.replica_key(envl, stl, gl.broker_severity(envl, stl)).contiguous(), Kl, l % 4)
        rooms, custom, terms = engine._chain_move_vetoes(tuple(lgoals[:i]), envl, stl, False)
        lane_args.append(engine._score_args(envl, stl, gl, rooms, custom, cl, kvl,
                                            engine.move_delta_rows(envl, stl, cl), Tl,
                                            terms=terms))
    mask_u = 0
    for a in lane_args:
        mask_u |= a[8]
    lane_args = [a[:8] + (mask_u,) + a[9:] for a in lane_args]
    check(torch, e, lambda: K.move_score_classes_lanes(lane_args),
          lambda: move_score.move_score_classes_lanes_plain(lane_args),
          f"L={LANES} K={Kl} T={Tl}, {bin(mask_u).count('1')} term dims")
    got = K.move_score_classes_lanes(lane_args)
    for j, a in enumerate(lane_args):
        solo = K.move_score_classes(*a)
        require(torch.equal(got[0][j].view(torch.int32), solo[0].view(torch.int32))
                and torch.equal(got[1][j], solo[1]),
                f"move_score_terms_lanes: lane {j} is not its solo launch")
    log("  move_score_terms_lanes: every lane its solo launch")
    dims_l = bin(mask_u).count("1")
    Bl = stack.env_b.num_brokers
    timing(torch, e, lambda: K.move_score_classes_lanes(lane_args),
           lambda: move_score.move_score_classes_lanes_plain(lane_args), None,
           sum(nbytes(*(t for t in a if isinstance(t, torch.Tensor))) for a in lane_args)
           + LANES * Kl * Tl * 12, LANES * Kl * Bl * (3 * dims_l + 12),
           f"L={LANES} K={Kl} T={Tl}")


def option_lane_checks(torch, entries: dict, stack, params, shapes: dict,
                       seed: int) -> None:
    """The pooled K1's lane form against its twin at every L 16 shape the
    fleet's options round launched (``shapes``: that run's launch shapes),
    on the fleet's own lanes: the move keys of ``TERMS_GOAL``, the leader
    keys of LeaderReplicaDistributionGoal and the swap out (with a seed
    mask) and in (salt 101) keys of ``TERMS_GOAL``, a stall per lane."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import lanes as lanes_mod
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.kernels import select
    g = torch.Generator().manual_seed(seed + 19)
    lanes = list(range(LANES))
    goals = {gl.name: gl for gl in make_goals(DEFAULT)}
    keys = {}
    for name, method in ((TERMS_GOAL, "replica_key"),
                         ("LeaderReplicaDistributionGoal", "leader_key"),
                         (TERMS_GOAL, "swap_out_key"), (TERMS_GOAL, "swap_in_key")):
        gl = goals[name]
        sev = {l: gl.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
        keys[f"{name}.{method}"] = lanes_mod.lane_keys(stack, gl, lanes, sev, params, method)
    stalls = [j % 4 for j in lanes]
    mask = (torch.rand((LANES, stack.num_replicas), generator=g) < 0.5).to(stack.device)
    checked = []
    for shape in shapes["select_pooled_lanes"]:
        f = dict(x.split("=") for x in shape.split())
        if int(f["L"]) != LANES:
            continue
        k, pool = int(f["k"]), int(f["pool"])
        for what, key in keys.items():
            for salt, m in ((0, None), (101, mask)):
                check(torch, entries["select_pooled_lanes"],
                      lambda: K.select_pooled_lanes(key, k, stalls, salt, m, pool),
                      lambda: select.select_pooled_lanes_plain(key, k, stalls, salt, m, pool),
                      f"{shape} {what} salt={salt} mask={m is not None}", quiet=True)
        checked.append(shape)
    require(checked, f"fleet options: no L={LANES} launch of the pooled K1's lane form")
    log(f"  select_pooled_lanes at the options round's shapes {checked}: the fleet's "
        f"move, leader and swap keys, a stall per lane, with and without a seed mask, "
        f"bit-identical to the twin")


def option_lane_timings(torch, entries: dict, stack, params, shapes: dict,
                        seed: int) -> None:
    """Time the two option lane kernels at the shapes the fleet's option
    round launched most (``shapes``: that run's launch shapes), on the
    fleet's own lanes: keys of the lanes' goals for the pooled K1, K2's
    per-goal form of ``TERMS_GOAL``; beside 16 solo launches."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.kernels import move_score, select
    g = torch.Generator().manual_seed(seed + 17)
    dev = stack.device
    R = stack.num_replicas
    for name in ("select_pooled_lanes", "move_score_terms_lanes"):
        ran = shapes[name]
        top = max(ran, key=ran.get)
        if any(t["shape"] == top for t in entries[name].timings):
            continue
        f = dict(x.split("=") for x in top.split())
        La = int(f["L"])
        e = entries[name]
        if name == "select_pooled_lanes":
            k, pool = int(f["k"]), int(f["pool"])
            keys = torch.stack([pool_keys(torch, R, 0.05, g, dev) for _ in range(La)])
            stalls = [0] * La
            timing(torch, e, lambda: K.select_pooled_lanes(keys, k, stalls, 0, None, pool),
                   lambda: select.select_pooled_lanes_plain(keys, k, stalls, 0, None, pool),
                   lambda: torch.topk(keys[:, :pool], k, dim=1),
                   nbytes(keys) + La * k * (4 + 8), 2 * La * R, top)
            ms = time_ms(torch, lambda: [K.select_pooled(keys[j], k, 0, 0, pool=pool)
                                         for j in range(La)])
        else:
            Tl = int(f["T"])
            goals = make_goals(DEFAULT)
            i = next(j for j, gl in enumerate(goals) if gl.name == TERMS_GOAL)
            Kl = min(params.num_candidates, R)
            la = []
            for l in range(La):
                envl, stl = stack.envs[l], stack.sts[l]
                gl = goals[i]
                kvl, cl = K.select_candidates(
                    gl.replica_key(envl, stl, gl.broker_severity(envl, stl)).contiguous(),
                    Kl, 0)
                rooms, custom, terms = engine._chain_move_vetoes(tuple(goals[:i]), envl,
                                                                 stl, False)
                la.append(engine._score_args(envl, stl, gl, rooms, custom, cl, kvl,
                                             engine.move_delta_rows(envl, stl, cl), Tl,
                                             terms=terms))
            dims = bin(la[0][8]).count("1")
            B = stack.env_b.num_brokers
            timing(torch, e, lambda: K.move_score_classes_lanes(la),
                   lambda: move_score.move_score_classes_lanes_plain(la), None,
                   sum(nbytes(*(t for t in a if isinstance(t, torch.Tensor))) for a in la)
                   + La * Kl * Tl * 12, La * Kl * B * (3 * dims + 12), top)
            ms = time_ms(torch, lambda: [K.move_score_classes(*a) for a in la])
        e.timings[-1]["solo_ms"] = ms
        log(f"  {name} at {top}: {La} solo launches {ms:.6f} ms")


def options_fleet_run(torch, fleet) -> dict:
    """The fleet's tenants (phase 8's, after its rounds) through
    ``GoalOptimizer(engine_params=EngineParams(compact_keying=True,
    chain_cache=False)).optimizations_batched``: the pooled K1's and K2's
    per-goal lane forms on the lane path, the launch counts zeroed just
    before and read just after; four tenants' solo runs must equal their
    lanes."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.engine import EngineParams
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    sessions = [fleet.tenants[cid].session for cid in fleet.cluster_ids]
    from cruise_control_tpu_torch.config import cruise_control_config
    # the incremental memo off: these sessions carry phase 8's certificates
    opt = GoalOptimizer(device="cuda",
                        config=cruise_control_config({"analyzer.incremental.enabled": False}),
                        engine_params=EngineParams(compact_keying=True, chain_cache=False))
    K.reset_launches()
    t0 = time.perf_counter()
    lanes = opt.optimizations_batched(sessions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = K.launches(), K.launch_shapes()
    branches = K.pool_branch_counts()
    log(f"fleet options: one batched round of {len(sessions)} tenants with compact "
        f"keying and the per-goal accept masks {wall:.6f} s; kernel launches {launches}")
    log(f"fleet options: launches by shape {json.dumps(shapes)}; pooled K1 branches "
        f"{branches}")
    require(all(launches[n] > 0 for n in ("select_pooled_lanes", "move_score_terms_lanes")),
            f"fleet options: a lane kernel of the options never launched: {launches}")
    require(branches["pooled"] > 0, f"fleet options: the pool was never taken {branches}")
    walls = []
    for j in range(0, len(sessions), 4):
        t0 = time.perf_counter()
        solo = opt.optimizations(None, session=sessions[j], raise_on_failure=False)
        walls.append(time.perf_counter() - t0)
        require(same_bits(torch, solo.final_state, lanes[j].final_state)
                and goal_rows(solo) == goal_rows(lanes[j])
                and len(solo.proposals) == len(lanes[j].proposals),
                f"fleet options: tenant {j}'s lane differs from its solo run")
    log(f"fleet options: tenants 0, 4, 8, 12 solo equal to their lanes; solo walls (s) "
        f"{walls}")
    return dict(launches=launches, shapes=shapes, branches=branches, wall=wall)


def goal_rows(res) -> list:
    return [(g.name, g.iterations, g.passes, g.fixpoint_proven, g.move_actions,
             g.lead_actions, g.swap_actions) for g in res.goal_results]


def options_phase(torch, ctx, default: dict, entries: dict) -> dict:
    """Phase 10 at full width (slice-1000b, the sixteen goals): the run
    with ``EngineParams(compact_keying=True)`` (the pooled K1; its row the
    reference's own run of that setting, which is the default run's, and
    its final state bit-identical to phase 5's sixteen-goal run) and the
    run with ``chain_cache=False`` (K2's per-goal veto form, the reference's
    row of that setting); then the non-budget chain at spec-32b (the
    one-move-per-broker wave and ``seq_body``). Each run's launch counts
    are zeroed just before and read just after; the pooled and full branch
    counts are printed."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.engine import EngineParams
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    ct, meta = ctx["ct"], ctx["meta"]
    runs = {}
    opt = GoalOptimizer(device="cuda", engine_params=EngineParams(compact_keying=True))
    runs["compact"] = run_slice(torch, opt, ct, meta, DEFAULT,
                                "slice (16 goals, compact keying)",
                                ORACLE["default_slice_compact"], twice=False)
    branches = K.pool_branch_counts()
    log(f"slice (16 goals, compact keying): pooled K1 branches {branches}")
    require(branches["pooled"] > 0 and branches["full"] > 0,
            f"compact keying: a branch of the pooled K1 never ran {branches}")
    require(runs["compact"]["launches"]["select_pooled"] > 0,
            "compact keying: the pooled K1 never launched")
    require(same_bits(torch, runs["compact"]["final"], default["final"]),
            "compact keying: the final state differs from the default run's")
    log("slice (16 goals, compact keying): final state bit-identical to phase 5's "
        "sixteen-goal run (every leaf same_bits reads)")
    runs["compact"]["branches"] = branches
    opt = GoalOptimizer(device="cuda", engine_params=EngineParams(chain_cache=False))
    runs["nocache"] = run_slice(torch, opt, ct, meta, DEFAULT,
                                "slice (16 goals, per-goal accept masks)",
                                ORACLE["default_slice_nocache"], twice=False)
    require(runs["nocache"]["launches"]["move_score_terms"] > 0
            and runs["nocache"]["launches"]["move_score_classes"] == 0,
            f"per-goal masks: K2 did not run its per-goal form only "
            f"{runs['nocache']['launches']}")
    register_no_leader_budget_goal()
    ct32, meta32 = generate_scale(RandomClusterSpec(**SMALL_SPEC))
    runs["nolb"] = run_slice(torch, GoalOptimizer(device="cuda"), ct32, meta32, NOLB_CHAIN,
                             "spec-32b (a goal without wave budgets)", ORACLE["nolb_small"],
                             twice=False)
    launches = {n: sum(r["launches"][n] for r in runs.values()) for n in K.KERNELS}
    shapes = {n: {} for n in K.KERNELS}
    for r in runs.values():
        for n, sh in r["shapes"].items():
            for s, c in sh.items():
                shapes[n][s] = shapes[n].get(s, 0) + c
    require(all(launches[n] > 0 for n in ("select_pooled", "move_score_terms")),
            f"a kernel of the options path never launched: {launches}")
    return dict(launches=launches, shapes=shapes, runs=runs)


# ---------------------------------------------------------------------------
# phases 4 and 5: the optimizer
# ---------------------------------------------------------------------------
def run_chain(opt, ct, meta, goals=GOALS):
    return opt.optimizations(ct, meta, goal_names=goals, skip_hard_goal_check=True,
                             raise_on_failure=False)


def outcome(res) -> dict:
    return dict(before=set(res.violated_goals_before),
                after=set(res.violated_goals_after),
                actions=[g.iterations for g in res.goal_results],
                passes=[g.passes for g in res.goal_results],
                moves=res.num_replica_movements,
                leads=res.num_leadership_movements,
                proven=[g.fixpoint_proven for g in res.goal_results],
                rounds=[g.finisher_rounds for g in res.goal_results],
                swaps=[g.swap_actions for g in res.goal_results],
                swleft=[g.swap_window_remaining for g in res.goal_results],
                disk=[g.disk_actions for g in res.goal_results],
                proposals=len(res.proposals))


def print_outcome(tag: str, out: dict, oracle: dict) -> None:
    log(f"{tag}: violated before {sorted(out['before'])} after {sorted(out['after'])}")
    log(f"{tag}: per-goal actions {out['actions']} (JAX reference {oracle['actions']})")
    log(f"{tag}: per-goal passes  {out['passes']} (JAX reference {oracle['passes']})")
    log(f"{tag}: replica movements {out['moves']} (JAX reference {oracle['moves']}), "
        f"leadership movements {out['leads']} (JAX reference {oracle['leads']})")
    if "proven" in oracle:
        log(f"{tag}: fixpoint proven {out['proven']}, finisher rounds {out['rounds']}")
    if "swaps" in oracle:
        log(f"{tag}: swap actions {out['swaps']}, swap windows {out['swleft']}")
    if "disk" in oracle:
        log(f"{tag}: disk actions {out['disk']} (JAX reference {oracle['disk']}), "
            f"proposals {out['proposals']} (JAX reference {oracle.get('proposals', '-')})")


def require_oracle(tag: str, out: dict, oracle: dict) -> None:
    for key in ("before", "after", "actions", "passes", "moves", "leads", "proven",
                "rounds", "swaps", "swleft", "disk", "proposals"):
        if key in oracle:
            require(out[key] == oracle[key],
                    f"{tag}: {key} {out[key]} != JAX reference {oracle[key]}")
    if "after" not in oracle:
        require(not out["after"], f"{tag}: goals still violated {out['after']}")


def same_bits(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in (
        (a.replica_broker, b.replica_broker), (a.replica_is_leader, b.replica_is_leader),
        (a.util.view(torch.int32), b.util.view(torch.int32)),
        (a.leader_util.view(torch.int32), b.leader_util.view(torch.int32)),
        (a.replica_count, b.replica_count), (a.leader_count, b.leader_count),
        (a.replica_disk, b.replica_disk), (a.replica_offline, b.replica_offline),
        (a.disk_util.view(torch.int32), b.disk_util.view(torch.int32)),
        (a.moved, b.moved), (a.leadership_moved, b.leadership_moved)))


def parity(torch, goals, spec, key: str, tag: str) -> dict:
    """One chain on a small cluster (a ``generate_scale`` spec, or a
    function that builds the cluster), on the card and on the CPU (the
    twins): the same bits and the JAX reference's outcome."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    from cruise_control_tpu_torch import kernels as K
    ct, meta = spec() if callable(spec) else generate_scale(RandomClusterSpec(**spec))
    K.reset_launches()
    t0 = time.perf_counter()
    on_card = run_chain(GoalOptimizer(device="cuda"), ct, meta, goals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shapes = K.launch_shapes()
    shapes["move_score_classes families"] = dict(K.FAMILY_LAUNCHES)
    on_cpu = run_chain(GoalOptimizer(device="cpu"), ct, meta, goals)
    out = outcome(on_card)
    print_outcome(tag, out, ORACLE[key])
    require(outcome(on_cpu) == out, f"{tag}: card and CPU outcomes differ")
    a, b = on_card.final_state, on_cpu.final_state
    require(same_bits(torch, to_device(a, "cpu"), b),
            f"{tag}: card and CPU final states differ")
    require_oracle(tag, out, ORACLE[key])
    log(f"{tag}: card == CPU bit for bit (assignment, logdirs, offline flags, "
        f"util, disk util, counts), == JAX reference counts "
        f"(card wall {wall:.6f} s, first run in this process)")
    log(f"{tag}: launches by shape on the card {json.dumps(shapes)}")
    return shapes


def fixture16():
    """``__graft_entry__._fixture_cluster()`` built with the port's builder:
    16 brokers in 4 racks, the first half crowded with integer loads."""
    from cruise_control_tpu_torch.model.builder import ClusterModelBuilder
    b = ClusterModelBuilder()
    for i in range(16):
        b.add_broker(i, rack=f"r{i % 4}")
    p = 0
    for i in range(8):
        for j in range(16):
            load = [1.0, 50.0, 100.0, 500.0 + 10 * (p % 7)]
            b.add_replica("load", p, i, is_leader=True, load=load)
            if j % 4 == 0:
                b.add_replica("load", p, (i + 1) % 8, is_leader=False, load=load)
            p += 1
    return b.build()


def entry_check(torch) -> None:
    """``__graft_entry__.entry()``'s run on the card: the port's
    ``optimize_goal`` for DiskUsageDistributionGoal with
    ``EngineParams(max_iters=64)`` on the 16-broker fixture (unpadded, as
    ``_setup()`` builds it) ends satisfied with the reference's util."""
    from cruise_control_tpu_torch.analyzer.engine import EngineParams, optimize_goal
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.goals import make_goal
    from cruise_control_tpu_torch.analyzer.state import init_state
    ct, meta = fixture16()
    env = make_env(ct, meta, device="cuda")
    st = init_state(env, ct.replica_broker, ct.replica_is_leader, ct.replica_offline,
                    ct.replica_disk)
    st2, info = optimize_goal(env, st, make_goal("DiskUsageDistributionGoal"), (),
                              EngineParams(max_iters=64))
    disk = st2.util[:, 3].tolist()
    total = float(st2.util.sum())
    log(f"entry: violated_after {info['violated_after']}, util sum {total}, "
        f"disk {disk}")
    require(info["violated_after"] is False and disk == ENTRY_DISK
            and total == ENTRY_UTIL_SUM,
            f"entry: not the reference's result (disk {ENTRY_DISK}, sum "
            f"{ENTRY_UTIL_SUM}, violated_after False)")


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def slice_checks(torch, res, tag: str, digests: dict | None = None) -> None:
    """Refresh-consistent tallies (ints equal, floats within 1e-3 relative,
    relative to at least 1.0). ``digests`` maps a float tally to the digest
    of the JAX reference's final value: that tally must be the reference's
    bit for bit, and its drift check then skips the entries the refresh
    reads as exactly 0 (a drained dead broker or logdir keeps the
    reference's own rounding residue of its sequential subtractions)."""
    from cruise_control_tpu_torch.analyzer.state import refresh
    env, st = res.env, res.final_state
    ref = refresh(env, st)
    digests = digests or {}
    for name in ("replica_count", "leader_count", "part_rack_count",
                 "topic_broker_count", "topic_leader_count"):
        require(torch.equal(getattr(st, name), getattr(ref, name)),
                f"refresh(final).{name} != incremental")
    for name, want_digest in digests.items():
        got_digest = digest(getattr(st, name))
        require(got_digest == want_digest,
                f"final {name} digest {got_digest} != JAX reference {want_digest}")
        log(f"{tag}: final {name} bit-identical to the JAX reference's "
            f"(sha256 {got_digest})")
    worst = 0.0
    for name in ("util", "leader_util", "potential_nw_out", "disk_util"):
        got, want = getattr(st, name), getattr(ref, name)
        err = (got - want).abs() / want.abs().clamp(min=1.0)
        if name in digests:
            err = torch.where(want == 0, torch.zeros_like(err), err)
        rel = float(err.max())
        worst = max(worst, rel)
        require(rel <= 1e-3, f"refresh(final).{name} off by {rel} relative")
    members = env.partition_replicas
    brokers = torch.where(members >= 0, st.replica_broker[members.clamp(min=0)],
                          -1 - torch.arange(members.shape[1], device=members.device))
    srt = brokers.sort(dim=1).values
    require(not bool((srt[:, 1:] == srt[:, :-1]).any()),
            "a partition has two replicas on one broker")
    log(f"{tag}: refresh(final) tallies == incremental; util max rel err {worst:.3e}; "
        f"no partition has two replicas on one broker")


# the phase-5 paths ``--profile`` may name, in the order they run
PROFILE_PATHS = ("five", "eleven", "sixteen", "eighteen", "kafka", "jbod_intra",
                 "jbod_chain", "jbod_demote", "jbod_ple", "rung4", "rung5", "session",
                 "heal")
# device function names of the hand kernels, as the profiler lists them
HAND_KERNEL_NAMES = (
    "sel_pass_a", "sel_pass_next", "sel_gather", "sel_sort", "sel_merge",
    "tile_counts", "scan_counts", "tile_write", "pad_tail",
    "move_score_kernel", "ft_init", "ft_cand", "ft_part", "side_scan", "finish(",
    "segment_sum_scan", "radix_hist", "scan_excl", "radix_scatter", "seg_sum_short",
    "seg_sum_long", "segment_count_kernel", "leadership_rows_kernel",
    "swap_rows_kernel", "swap_admission_kernel", "disk_rows_kernel",
    "disk_apply_kernel", "preferred_leader_kernel", "replica_keys_kernel",
    "finalize_kernel", "probe_kernel", "forecast_kernel")


def run_slice(torch, opt, ct, meta, goals, tag: str, oracle: dict,
              twice: bool = True) -> dict:
    """A path at the 1,000-broker size (or a 7,000-broker rung), run twice
    (once with ``twice`` False): the launch counts are zeroed just before
    run 1 and read just after it; the runs must be bit-identical and match
    the reference's outcome row."""
    from cruise_control_tpu_torch import kernels as K
    K.reset_launches()
    t0 = time.perf_counter()
    res1 = run_chain(opt, ct, meta, goals)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches = K.launches()
    shapes = K.launch_shapes()
    families = dict(K.FAMILY_LAUNCHES)
    key_families = dict(K.KEY_FAMILY_LAUNCHES)
    if twice:
        t0 = time.perf_counter()
        res2 = run_chain(opt, ct, meta, goals)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        log(f"{tag}: run 1 wall {wall1:.6f} s, run 2 wall {wall2:.6f} s")
    else:
        wall2 = None
        log(f"{tag}: run 1 wall {wall1:.6f} s (one run)")
    log(f"{tag}: kernel launches in run 1 {launches}")
    log(f"{tag}: launches by shape in run 1 {json.dumps(shapes)}")
    log(f"{tag}: K2 launches by goal family in run 1 {json.dumps(families)}")
    log(f"{tag}: K1 keying launches by family in run 1 {json.dumps(key_families)}")
    out = outcome(res1)
    print_outcome(tag, out, oracle)
    require_oracle(tag, out, oracle)
    if twice:
        require(same_bits(torch, res1.final_state, res2.final_state)
                and outcome(res2) == out, f"{tag}: the two runs differ")
        log(f"{tag}: run 1 and run 2 bit-identical (assignment, leadership, util, "
            f"leader util, counts, logdirs, offline flags, disk util, moved flags)")
    slice_checks(torch, res1, tag, oracle.get("digests"))
    return dict(launches=launches, shapes=shapes, families=families,
                key_families=key_families, walls=(wall1, wall2),
                run=(ct, meta, goals, tag), final=res1.final_state)


def profile_run(torch, opt, ct, meta, goals, tag: str) -> None:
    """One more run of a path under torch.profiler (``profile_call``)."""
    profile_call(torch, lambda: run_chain(opt, ct, meta, goals), tag)


def profile_call(torch, fn, tag: str):
    """``fn()`` under torch.profiler: device busy share of the wall and
    device time by kernel (device-side events only, so an op's kernels are
    not counted twice). Returns what ``fn`` returns."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_report(prof, wall, tag)
    return out


def profile_report(prof, wall: float, tag: str) -> None:
    """Print a profiled call's device busy share and its top device kernels."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    ours = [r for r in rows if any(n in r[2] for n in HAND_KERNEL_NAMES)]
    own = sum(r[0] for r in ours) / 1e6
    launches = sum(r[1] for r in rows)
    log(f"profile {tag}: wall {wall:.6f} s under the profiler, device busy "
        f"{busy:.6f} s ({100 * busy / wall:.2f}% of wall), {launches} device events; "
        f"hand kernels {own:.6f} s ({100 * own / max(busy, 1e-12):.2f}% of busy)")
    for dev_us, count, key in rows[:25]:
        log(f"profile {tag}:   {dev_us / 1e3:12.3f} ms  {count:7d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phase 6: the resident-session service rounds
# ---------------------------------------------------------------------------
def one_sided(full: dict, reduced: dict, names: list) -> dict:
    """The seeding contract of a reduced round against the full round on
    the same churn: violations only shrink, certificates only appear."""
    cf = {n for n, c in zip(names, full["proven"]) if c}
    cr = {n for n, c in zip(names, reduced["proven"]) if c}
    return dict(violations_shrink=set(reduced["after"]) <= set(full["after"]),
                certificates_appear=cf <= cr,
                new_violations=sorted(set(reduced["after"]) - set(full["after"])),
                lost_certificates=sorted(cf - cr))


def session_phase(torch, entries: dict, profile: bool, seed: int) -> dict:
    """The e2e-1000b-50000p cell through ``SimulatedClusterBackend`` ->
    ``LoadMonitor`` -> ``ResidentClusterSession`` -> ``GoalOptimizer(config=
    ...).optimizations(None, session=...)`` on the card: the plain script
    (R1 full, R2 revalidated, R3 full after 8 leadership flips), then the
    same script on a fresh backend, monitor and session with dirty seeding
    (its R3 reduced). The launch counts are zeroed just before the two
    scripts and read just after; every round must give the JAX reference's
    row; the second script's R1 and R2 repeat the first's bit for bit; then
    K5, K1's seed mask and K13 are held against their twins at the cell's
    padded R on the inputs the reduced round saw."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.session import finalize_inputs
    from cruise_control_tpu_torch.analyzer.session_script import (
        SESSION_E2E, port_ns, session_script,
    )
    from cruise_control_tpu_torch.config import DEFAULT_GOALS
    from cruise_control_tpu_torch.kernels import finalize, probe, select
    ns = port_ns("cuda")
    walls = {"plain": [], "seeded": []}
    syncs = {"plain": [], "seeded": []}
    seen = {}

    def runner(key):
        def run_round(i, call, sess):
            if key == "seeded" and i == 2:
                # the reduced round's inputs, for the kernel checks below
                rd = sess._round_delta
                seen.update(env=sess.env, st=sess.state,
                            h={k: v.copy() for k, v in sess._h.items()},
                            dirty=sess.dirty_replica_mask(rd["dirty_brokers"],
                                                          rd["dirty_topics"]))
            t0 = time.perf_counter()
            if profile and key == "plain" and i == 2:
                res = profile_call(torch, call, "session R3 (full, 8 leadership flips)")
            else:
                res = call()
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
            return res
        return run_round

    K.reset_launches()
    t0 = time.perf_counter()
    rows = {}
    for key, seed_dirty in (("plain", False), ("seeded", True)):
        rows[key] = session_script(
            ns, SESSION_E2E, seed_dirty=seed_dirty, run_round=runner(key),
            on_sync=lambda info, wall, key=key: syncs[key].append((info["mode"], wall)))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches, shapes = K.launches(), K.launch_shapes()
    log(f"session: kernel launches {launches}")
    log(f"session: launches by shape {json.dumps(shapes)}")
    for key in rows:
        log(f"session {key}: sync walls (s) {syncs[key]}; round walls (s) {walls[key]}")
        for i, (got, want) in enumerate(zip(rows[key], SESSION_ORACLE[key])):
            diff = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
            require(not diff, f"session {key} R{i + 1} differs from the JAX reference: {diff}")
            log(f"session {key} R{i + 1}: sync {got['sync']} (churn {got['churn']}), round "
                f"{got['round']}, violated after {got['after']}, {got['moves']} replica / "
                f"{got['leads']} leadership movements, {got['proposals']} proposals, "
                f"{got['fallback']} fallback goals: the JAX reference's row (final state "
                f"digests {got['digests']['util']} util, {got['digests']['replica_broker']} "
                f"assignment)")
    require(rows["plain"][:2] == rows["seeded"][:2],
            "session: the second script's R1 / R2 differ from the first's")
    log("session: the second script's R1 and R2 (a fresh backend, monitor, session and "
        "optimizer) are bit-identical to the first's, final-state digests included")
    got_v = one_sided(rows["plain"][2], rows["seeded"][2], DEFAULT_GOALS)
    want_v = one_sided(SESSION_ORACLE["plain"][2], SESSION_ORACLE["seeded"][2],
                       DEFAULT_GOALS)
    require(got_v == want_v, f"session: one-sided verdict {got_v} != the reference's {want_v}")
    log(f"session: the reduced R3 against the full R3, the one-sided contract: {got_v} "
        f"(the JAX reference's own verdict on this cell, equal)")
    require(all(n > 0 for name, n in launches.items()
                if name not in JBOD_KERNELS + HEAL_KERNELS + FLEET_KERNELS + OPTION_KERNELS),
            f"a kernel of the session path never launched: {launches}")
    log(f"session: both scripts {total:.6f} s")

    # --- the new kernels against their twins at the cell's padded R ---------
    env, st, h, dirty = seen["env"], seen["st"], seen["h"], seen["dirty"]
    dev = env.device
    R, B = env.num_replicas, env.num_brokers
    g = torch.Generator().manual_seed(seed)
    broker, lead_packed, disk = finalize_inputs(h, dev)
    fargs = (lead_packed, broker, disk, env.replica_topic, env.replica_valid,
             env.broker_alive, env.broker_disk_alive, env.topic_excluded,
             env.broker_excluded_for_replica_move)
    e = entries["session_finalize"]
    check(torch, e, lambda: K.session_finalize(*fargs),
          lambda: finalize.session_finalize_plain(*fargs), f"R={R} B={B}")
    lead, off, rtexcl, dst = K.session_finalize(*fargs)
    require(torch.equal(lead, st.replica_is_leader) and torch.equal(off, st.replica_offline)
            and torch.equal(rtexcl, env.replica_topic_excluded)
            and torch.equal(dst, env.dst_candidate),
            "session_finalize disagrees with the resident state its sync built")
    for n in (1, 7, 1003):
        Ba, Da, Ta = 5, 3, 4
        adv = (torch.randint(0, 256, ((n + 7) // 8,), generator=g, dtype=torch.uint8),
               torch.randint(0, Ba, (n,), generator=g), torch.randint(0, Da, (n,), generator=g),
               torch.randint(0, Ta, (n,), generator=g), torch.rand(n, generator=g) < 0.9,
               torch.rand(Ba, generator=g) < 0.7, torch.rand((Ba, Da), generator=g) < 0.7,
               torch.rand(Ta, generator=g) < 0.5, torch.rand(Ba, generator=g) < 0.3)
        adv = tuple(a.to(dev) for a in adv)
        check(torch, e, lambda: K.session_finalize(*adv),
              lambda: finalize.session_finalize_plain(*adv), f"adversarial R={n}")
    timing(torch, e, lambda: K.session_finalize(*fargs),
           lambda: finalize.session_finalize_plain(*fargs), None,
           nbytes(fargs) + 3 * R + B, 4 * R, f"R={R} B={B}")

    goals = make_goals(DEFAULT_GOALS)
    mask = torch.tensor(dirty, device=dev)
    masks = {"dirty": mask, "none": torch.zeros_like(mask), "all": torch.ones_like(mask),
             "random": (torch.rand(R, generator=g) < 0.3).to(dev)}
    log(f"session: the reduced round's dirty set holds {int(mask.sum())} of {R} replicas")
    sev = {gl.name: gl.broker_severity(env, st) for gl in goals}
    keys = {gl.name: gl.replica_key(env, st, sev[gl.name]).contiguous()
            for gl in goals if gl.uses_replica_moves}
    e = entries["select_candidates_masked"]
    ran_k = sorted(int(k.split("=")[1]) for k in shapes["select_candidates_masked"])
    for name in ("RackAwareGoal", "ReplicaDistributionGoal", "DiskUsageDistributionGoal"):
        for mname, m in masks.items():
            for stall in (0, 3):
                for k in ran_k:
                    check(torch, e, lambda: K.select_candidates(keys[name], k, stall,
                                                                seed_mask=m),
                          lambda: select.select_candidates_plain(keys[name], k, stall,
                                                                 seed_mask=m),
                          f"{name} mask {mname} stall={stall} k={k}", quiet=True)
    log(f"  select_candidates_masked: {e.checks} checks bit-identical (k in {ran_k}, "
        f"masks {list(masks)}, stall 0 and 3)")
    key = keys["ReplicaDistributionGoal"]
    for k in ran_k:
        timing(torch, e, lambda: K.select_candidates(key, k, 0, seed_mask=mask),
               lambda: select.select_candidates_plain(key, k, 0, seed_mask=mask),
               lambda: torch.topk(torch.where(mask, key, -torch.inf), k),
               nbytes(key, mask) + k * (4 + 8), 4 * R, f"R={R} k={k}")

    e = entries["seeded_probe"]
    by_count = {}
    for gl in goals:
        ks = []
        if gl.uses_replica_moves or gl.uses_disk_moves:
            ks.append(gl.replica_key(env, st, sev[gl.name]))
        if gl.uses_leadership_moves:
            ks.append(gl.leader_key(env, st, sev[gl.name]))
        if gl.uses_swaps:
            ks.append(gl.swap_out_key(env, st, sev[gl.name]))
        ks = [x.contiguous() for x in ks]
        by_count.setdefault(len(ks), ks)
        for mname, m in masks.items():
            check(torch, e, lambda: K.seeded_probe(m, ks),
                  lambda: probe.seeded_probe_plain(m, ks), f"{gl.name} mask {mname}",
                  quiet=True)
    neg = torch.full((R,), -torch.inf, device=dev)
    for n in (1, 2, 3):
        for row in (0, R - 1, R // 2):
            ks = [neg.clone() for _ in range(n)]
            ks[-1][row] = 0.0
            for mname, m in masks.items():
                check(torch, e, lambda: K.seeded_probe(m, ks),
                      lambda: probe.seeded_probe_plain(m, ks),
                      f"one eligible row {row} of {n} keys, mask {mname}", quiet=True)
    log(f"  seeded_probe: {e.checks} checks bit-identical (every default goal's keys, "
        f"masks {list(masks)}, one eligible row at the ends and the middle)")
    for shape in shapes["seeded_probe"]:
        n = int(shape.split("keys=")[1])
        ks = by_count[n]
        cmp = mask & (ks[0] > -torch.inf)
        timing(torch, e, lambda: K.seeded_probe(mask, ks),
               lambda: probe.seeded_probe_plain(mask, ks), lambda: torch.any(cmp),
               nbytes(mask, ks) + 4, 2 * n * R, f"R={R} keys={n}")
    return dict(launches=launches, shapes=shapes, walls=walls, syncs=syncs)


# ---------------------------------------------------------------------------
# phase 3, K15: the forecaster's kernel against its twin
# ---------------------------------------------------------------------------
# the forecaster's shape at e2e-1000b-50000p: 50,000 partitions, the ring's 4
# and 5 completed windows, the 10 partition metrics
FORECAST_E, FORECAST_M = 50_000, 10


def forecast_kernel_checks(torch, entries: dict, seed: int) -> None:
    """K15 against its twin: random histories with holes (leading,
    trailing, interior, all-holes rows) at the heal cell's shapes under the
    heal config's knobs and adversarial ones, signed and tiny values, one
    window; then timed at W 4 and 5."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.heal_script import HEAL_CONFIG
    from cruise_control_tpu_torch.kernels import forecast
    e = entries["forecast"]
    g = torch.Generator().manual_seed(seed)
    heal_knobs = (0.45, 0.25, 0.5, HEAL_CONFIG["forecast.horizon.ms"] / 300_000.0)
    knob_sets = [heal_knobs, (0.9, 0.1, 0.2, 2.0), (0.2, 0.5, 0.8, 20.0),
                 (0.7252333, 0.9459341, 0.5998188, 1.5724896)]

    def history(E, W, M, scale=100.0, signed=False):
        vals = torch.rand((E, W, M), generator=g) * scale
        if signed:
            vals = vals * 2.0 - scale
        mask = torch.rand((E, W), generator=g) > 0.25
        if E >= 4:
            mask[0, 0] = False
            mask[1, -1] = False
            mask[2, W // 2] = False
            mask[3, :] = False
        return vals.float().cuda().contiguous(), mask.cuda().contiguous()

    cases = [(FORECAST_E, 5, FORECAST_M, 100.0, False),
             (FORECAST_E, 4, FORECAST_M, 1e5, False),
             (1003, 5, FORECAST_M, 50.0, True), (257, 1, 3, 10.0, False),
             (64, 8, 4, 1e-3, False), (7, 2, 10, 1.0, True)]
    for E, W, M, scale, signed in cases:
        vals, mask = history(E, W, M, scale, signed)
        for knobs in knob_sets:
            check(torch, e, lambda: K.forecast_batch(vals, mask, *knobs),
                  lambda: forecast.forecast_plain(vals, mask, *knobs),
                  f"E={E} W={W} M={M} knobs {knobs}", quiet=True)
    log(f"  forecast: {e.checks} checks bit-identical (E up to {FORECAST_E}, W 1-8, holes, "
        f"signed and tiny values, {len(knob_sets)} knob sets)")
    for W in (4, 5):
        vals, mask = history(FORECAST_E, W, FORECAST_M)
        nb = nbytes(vals, mask) + FORECAST_E * FORECAST_M * 4
        timing(torch, e, lambda: K.forecast_batch(vals, mask, *heal_knobs),
               lambda: forecast.forecast_plain(vals, mask, *heal_knobs), None,
               nb, 12 * FORECAST_E * W * FORECAST_M, f"E={FORECAST_E} W={W} M={FORECAST_M}")


# ---------------------------------------------------------------------------
# phase 7: the self-healing service
# ---------------------------------------------------------------------------
# The heal script at e2e-1000b-50000p through the JAX reference (JAX 0.9.0,
# JAX_PLATFORMS=cpu, a fresh interpreter): ``python tests/torch_reference.py
# heal-e2e``, the rows of ``cruise_control_tpu_torch.analyzer.heal_script.
# heal_script`` (sha256 digests: their first 16 hex digits).
HEAL_ORACLE = [{'step': 'broker_failure',
  'detected': 2,
  'handled': [[{'type': 'BROKER_FAILURE', 'action': 'CHECK', 'fix': None, 'error': None},
               {'type': 'GOAL_VIOLATION', 'action': 'IGNORE', 'fix': None, 'error': None}],
              [{'type': 'BROKER_FAILURE',
                'action': 'FIX',
                'fix': {'operation': 'REMOVE_BROKER',
                        'executed': True,
                        'proposals': 34565,
                        'proposals_sha': '718a41f7b63601cc'},
                'error': None}]],
  'census': {'state': 'NO_TASK_IN_PROGRESS',
             'total': 63472,
             'by_state': {'COMPLETED': 63472},
             'executions': 1,
             'completed_total': 63472},
  'sim_ms': 490000.0,
  'assignment': '0c50bacc5b8cd11a'},
 {'step': 'disk_failure',
  'detected': 1,
  'handled': [[{'type': 'DISK_FAILURE',
                'action': 'FIX',
                'fix': {'operation': 'FIX_OFFLINE_REPLICAS',
                        'executed': True,
                        'proposals': 121,
                        'proposals_sha': '5616fbdc861262df'},
                'error': None}],
              []],
  'census': {'state': 'NO_TASK_IN_PROGRESS',
             'total': 205,
             'by_state': {'COMPLETED': 205},
             'executions': 2,
             'completed_total': 63677},
  'sim_ms': 710000.0,
  'assignment': '8e6db39fc2577147'},
 {'step': 'predicted_breach',
  'detected': 1,
  'handled': [[{'type': 'PREDICTED_GOAL_VIOLATION',
                'action': 'FIX',
                'fix': {'operation': 'forecast_heal',
                        'executed': True,
                        'proposals': 1,
                        'proposals_sha': 'b181409496cb644d'},
                'error': None}]],
  'census': {'state': 'NO_TASK_IN_PROGRESS',
             'total': 2,
             'by_state': {'COMPLETED': 2},
             'executions': 3,
             'completed_total': 63679},
  'sim_ms': 720000.0,
  'assignment': '40af3afbc01f1011',
  'forecast': 'e28d9abca45f2937',
  'forecast_shape': [50000, 10],
  'rising': True,
  'predicted': ['NetworkOutboundCapacityGoal'],
  'predictions': 1,
  'speculative': {'installs': 1, 'hits': 1, 'stale': 0},
  'cached_proposals': 8311,
  'cached_violated_after': ['CpuCapacityGoal', 'ReplicaDistributionGoal']}]


HEAL_PROFILED = ("detect a", "fix a", "fix b", "detect c", "fix c")


def heal_phase(torch, profile: bool = False) -> dict:
    """``heal_script`` at e2e-1000b-50000p through the port's
    ``CruiseControl(device="cuda")`` once (twice before the front door
    joined the smoke; phase 9 checks determinism at the same cell), the
    launch counts zeroed just
    before and read just after: the broker failure (CHECK, then the FIX's
    evacuation executed on ``SimClock``), the disk failure (FIX of the
    offline replicas on the resident session), the predicted breach (K15's
    forecast, the PREDICTED verdict, the pre-breach heal and the speculative
    install). Every row must be the JAX reference's. ``profile`` adds a run
    whose detection and FIX steps run under torch.profiler."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer.heal_script import (
        HEAL_E2E, heal_script, port_heal_ns,
    )
    walls = []

    def timer_for(run_walls):
        import contextlib

        @contextlib.contextmanager
        def timer(label):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            run_walls[label] = time.perf_counter() - t0
        return timer

    K.reset_launches()
    t0 = time.perf_counter()
    runs = []
    for _ in range(1):
        run_walls = {}
        t_run = time.perf_counter()
        runs.append(heal_script(port_heal_ns("cuda"), HEAL_E2E, timer=timer_for(run_walls)))
        torch.cuda.synchronize()
        run_walls["script"] = time.perf_counter() - t_run
        walls.append(run_walls)
    total = time.perf_counter() - t0
    launches, shapes = K.launches(), K.launch_shapes()
    log(f"heal: kernel launches {launches}")
    log(f"heal: launches by shape {json.dumps(shapes)}")
    for i, rows in enumerate(runs):
        for got, want in zip(rows, HEAL_ORACLE):
            diff = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
            require(not diff, f"heal run {i + 1} {want['step']} differs from the JAX "
                              f"reference: {diff}")
        require(len(rows) == len(HEAL_ORACLE), f"heal run {i + 1}: {len(rows)} steps")
    prev_ms = 0.0
    for row in runs[0]:
        handled = [[(h["type"], h["action"]) + ((h["fix"]["operation"], h["fix"]["proposals"])
                                                if h["fix"] else ()) for h in hs]
                   for hs in row["handled"]]
        log(f"heal {row['step']}: handled {handled}; executor census "
            f"{row['census']['by_state']} ({row['census']['total']} tasks), executor run "
            f"{row['sim_ms'] - prev_ms:.1f} simulated ms; assignment {row['assignment']}: "
            f"the JAX reference's row" + (f"; forecast {row['forecast_shape']} sha256 "
                                         f"{row['forecast']}, predicted {row['predicted']}, "
                                         f"speculative {row['speculative']}"
                                         if "forecast" in row else ""))
        prev_ms = row["sim_ms"]
    for i, w in enumerate(walls):
        log(f"heal run {i + 1} walls (s): detection rounds a/b/c {w['detect a']:.6f} / "
            f"{w['detect b']:.6f} / {w['detect c']:.6f}; FIX rounds (optimize and "
            f"execute) a/b/c {w['fix a']:.6f} / {w['fix b']:.6f} / {w['fix c']:.6f}; "
            f"forecast {w['forecast']:.6f}; the whole script {w['script']:.6f}")
    require(launches["forecast"] > 0, f"K15 never launched on the heal path: {launches}")
    require(all(launches[n] > 0 for n in FIVE_GOAL_KERNELS),
            f"a kernel of the heal path's optimize rounds never launched: {launches}")
    log(f"heal: the run {total:.6f} s")
    if profile:
        import contextlib

        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        @contextlib.contextmanager
        def profiled(label):
            if label not in HEAL_PROFILED:
                yield
                return
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            profile_report(prof, wall, f"heal {label}")
        heal_script(port_heal_ns("cuda"), HEAL_E2E, timer=profiled)
    return dict(launches=launches, shapes=shapes, walls=walls)


# ---------------------------------------------------------------------------
# phase 3 and phase 8: the fleet's lane kernels (K14) and fleet-16x100b
# ---------------------------------------------------------------------------
# a lane stack at the fleet-16x100b shape: 16 tenants of 100 brokers on 4
# racks with 5,000 RF-2 partitions (10,000 replicas each, padded R 10,240)
LANES = 16
# the tenants whose solo rounds phase 8 holds against their lanes
SOLO_TENANTS = (0, 5, 10, 15)
LANE_SPEC = dict(num_brokers=100, num_racks=4, num_topics=12, num_partitions=5000,
                 max_replication=2, skew=1.0, target_cpu_util=0.45)
LANE_GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
              "ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
# The fleet-16x100b cell's rounds through the JAX reference (JAX 0.9.0,
# JAX_PLATFORMS=cpu, a fresh interpreter): ``python tests/torch_reference.py
# fleet-e2e``, the rows of ``cruise_control_tpu_torch.fleet_script.fleet_e2e``
# (digest: the first 16 hex digits of the sha256 of the final assignment).
FLEET_ORACLE = {'rounds': [{'tenant-0': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1207, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1207,
                                         'mode': 'full',
                                         'digest': 'cd558f6567f4588c'},
                            'tenant-1': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1162, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1162,
                                         'mode': 'full',
                                         'digest': 'ac40e015eea86a27'},
                            'tenant-2': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1248, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1248,
                                         'mode': 'full',
                                         'digest': 'a11b3dc0559dc6af'},
                            'tenant-3': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1215, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1215,
                                         'mode': 'full',
                                         'digest': 'b66c57b870468a17'},
                            'tenant-4': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1197, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1197,
                                         'mode': 'full',
                                         'digest': '53b682a1fb551dca'},
                            'tenant-5': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1264, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1264,
                                         'mode': 'full',
                                         'digest': 'afe012e5f50a5c45'},
                            'tenant-6': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1217, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1217,
                                         'mode': 'full',
                                         'digest': '3efdfff227d244aa'},
                            'tenant-7': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1231, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1231,
                                         'mode': 'full',
                                         'digest': '627e69fd909f5b04'},
                            'tenant-8': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1158, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1158,
                                         'mode': 'full',
                                         'digest': '23718ced52a08428'},
                            'tenant-9': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1192, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1192,
                                         'mode': 'full',
                                         'digest': 'f6630e2b0d693fc0'},
                            'tenant-10': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1206, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1206,
                                          'mode': 'full',
                                          'digest': 'c0a7a8962dacb5db'},
                            'tenant-11': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1205, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1205,
                                          'mode': 'full',
                                          'digest': '7dd9aff6335a3848'},
                            'tenant-12': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1287, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1287,
                                          'mode': 'full',
                                          'digest': '19ee01d2c643892d'},
                            'tenant-13': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1217, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1217,
                                          'mode': 'full',
                                          'digest': '2b4ac9b1672cf0f7'},
                            'tenant-14': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1232, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1232,
                                          'mode': 'full',
                                          'digest': 'e8dd80f5005a9213'},
                            'tenant-15': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1177, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1177,
                                          'mode': 'full',
                                          'digest': '1dae701a40aaec37'}},
                           {'tenant-0': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1207, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1207,
                                         'mode': 'full',
                                         'digest': 'cd558f6567f4588c'},
                            'tenant-1': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1162, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1162,
                                         'mode': 'full',
                                         'digest': 'ac40e015eea86a27'},
                            'tenant-2': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1248, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1248,
                                         'mode': 'full',
                                         'digest': 'a11b3dc0559dc6af'},
                            'tenant-3': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1215, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1215,
                                         'mode': 'full',
                                         'digest': 'b66c57b870468a17'},
                            'tenant-4': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1197, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1197,
                                         'mode': 'full',
                                         'digest': '53b682a1fb551dca'},
                            'tenant-5': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1264, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1264,
                                         'mode': 'full',
                                         'digest': 'afe012e5f50a5c45'},
                            'tenant-6': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1217, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1217,
                                         'mode': 'full',
                                         'digest': '3efdfff227d244aa'},
                            'tenant-7': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1231, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1231,
                                         'mode': 'full',
                                         'digest': '627e69fd909f5b04'},
                            'tenant-8': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1158, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1158,
                                         'mode': 'full',
                                         'digest': '23718ced52a08428'},
                            'tenant-9': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal',
                                                   'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal',
                                                   'ReplicaDistributionGoal'],
                                         'actions': [1192, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                         'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                         'proven': [False, False, False, False, False, False, True, True,
                                                    False, True, True, True, True, False, True, True],
                                         'proposals': 1192,
                                         'mode': 'full',
                                         'digest': 'f6630e2b0d693fc0'},
                            'tenant-10': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1206, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1206,
                                          'mode': 'full',
                                          'digest': 'c0a7a8962dacb5db'},
                            'tenant-11': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1205, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1205,
                                          'mode': 'full',
                                          'digest': '7dd9aff6335a3848'},
                            'tenant-12': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1287, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1287,
                                          'mode': 'full',
                                          'digest': '19ee01d2c643892d'},
                            'tenant-13': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1217, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1217,
                                          'mode': 'full',
                                          'digest': '2b4ac9b1672cf0f7'},
                            'tenant-14': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1232, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1232,
                                          'mode': 'full',
                                          'digest': 'e8dd80f5005a9213'},
                            'tenant-15': {'after': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                    'DiskUsageDistributionGoal',
                                                    'LeaderBytesInDistributionGoal',
                                                    'LeaderReplicaDistributionGoal',
                                                    'NetworkInboundUsageDistributionGoal',
                                                    'NetworkOutboundUsageDistributionGoal',
                                                    'ReplicaDistributionGoal'],
                                          'actions': [1177, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                                          'passes': [7, 3, 3, 3, 3, 3, 8, 8, 3, 8, 8, 8, 8, 3, 8, 8],
                                          'proven': [False, False, False, False, False, False, True, True,
                                                     False, True, True, True, True, False, True, True],
                                          'proposals': 1177,
                                          'mode': 'full',
                                          'digest': '1dae701a40aaec37'}}],
                'reports': [{'launches': 1,
                             'optimized': ['tenant-0', 'tenant-1', 'tenant-10', 'tenant-11', 'tenant-12',
                                           'tenant-13', 'tenant-14', 'tenant-15', 'tenant-2', 'tenant-3',
                                           'tenant-4', 'tenant-5', 'tenant-6', 'tenant-7', 'tenant-8',
                                           'tenant-9'],
                             'failed': {}},
                            {'launches': 1,
                             'optimized': ['tenant-0', 'tenant-1', 'tenant-10', 'tenant-11', 'tenant-12',
                                           'tenant-13', 'tenant-14', 'tenant-15', 'tenant-2', 'tenant-3',
                                           'tenant-4', 'tenant-5', 'tenant-6', 'tenant-7', 'tenant-8',
                                           'tenant-9'],
                             'failed': {}}]}


def lane_context(torch) -> dict:
    """A lane stack of ``LANES`` generate_scale clusters at the fleet cell's
    shape on the card (seeds 100..115), with the optimizer's params."""
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.lanes import LaneStack
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    raw = [generate_scale(RandomClusterSpec(**LANE_SPEC, seed=100 + k))
           for k in range(LANES)]
    # one shape bucket for all lanes: the largest padded dims as pad floors
    padded = [pad_cluster(ct, meta)[0] for ct, meta in raw]
    floors = dict(min_replicas=max(c.num_replicas for c in padded),
                  min_brokers=max(c.num_brokers for c in padded),
                  min_partitions=max(c.num_partitions for c in padded),
                  min_topics=max(c.num_topics for c in padded))
    envs, sts = [], []
    for ct, meta in raw:
        ct, meta = pad_cluster(ct, meta, **floors)
        env = make_env(ct, meta, device="cuda")
        envs.append(env)
        sts.append(init_state(env, ct.replica_broker, ct.replica_is_leader,
                              ct.replica_offline, ct.replica_disk))
    params = GoalOptimizer(device="cuda").scaled_params(envs[0].num_replicas,
                                                        envs[0].num_brokers)
    return dict(stack=LaneStack(envs, sts), params=params, goals=make_goals(LANE_GOALS))


def lane_wave(torch, lctx, goal_name: str, lanes: list, seed: int) -> dict:
    """The first move wave's inputs of the four lane launches for ``lanes``
    (each lane's solo SPI on its views, as the lane pass loop builds them),
    with a different stall and seed mask in every lane (one all-ones)."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer.goals.base import KeySpec, capture_keys
    from cruise_control_tpu_torch.kernels.keys import env_loads
    stack, params = lctx["stack"], lctx["params"]
    names = [gl.name for gl in lctx["goals"]]
    gi = names.index(goal_name)
    goal, prev = lctx["goals"][gi], tuple(lctx["goals"][:gi])
    dev = stack.device
    R = stack.num_replicas
    g = torch.Generator().manual_seed(seed)
    sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
    with capture_keys():
        specs = [goal.replica_key(stack.envs[l], stack.sts[l], sev[l]) for l in lanes]
    out = dict(goal=goal, lanes=lanes)
    if isinstance(specs[0], KeySpec):
        st_b = stack.st_b
        out["keys"] = (specs[0].family, env_loads(stack.env_b), specs[0].col,
                       st_b.replica_broker, st_b.replica_is_leader, st_b.replica_offline,
                       stack.env_b.replica_valid, lanes,
                       torch.stack([sp.bt for sp in specs]).contiguous(),
                       torch.stack([sp.sc for sp in specs]).contiguous())
        key = K.replica_keys_lanes(*out["keys"])
    else:
        key = torch.stack(specs).contiguous()
    Kc = min(params.num_candidates, R)
    W = max(1, min(params.max_pass_waves, R // max(Kc, 1)))
    k_all = min(Kc * W, R)
    mask = (torch.rand((len(lanes), R), generator=g) < 0.8).to(dev)
    mask[0] = True
    stalls = [j % 3 for j in range(len(lanes))]
    out["select"] = (key, k_all, stalls, 0, mask.contiguous())
    kv, cand = K.select_candidates_lanes(key, k_all, stalls, seed_mask=mask.contiguous())
    preps = [engine._score_prep(stack.envs[l], stack.sts[l], goal, prev, params,
                                cand[j, :Kc], kv[j, :Kc])
             for j, l in enumerate(lanes)]
    room_mask = 0
    for _d, a in preps:
        room_mask |= a[8]
    out["score"] = [a[:8] + (room_mask,) + a[9:] for _d, a in preps]
    cls_val, cls_q = K.move_score_classes_lanes(out["score"])
    fins = [engine._admission_from_scores(stack.envs[l], stack.sts[l], goal, prev, params,
                                          cand[j, :Kc], preps[j][0], cls_val[j], cls_q[j])
            for j, l in enumerate(lanes)]
    out["admit"] = [f[2] for f in fins]
    out["K"], out["R"], out["B"] = Kc, R, stack.env_b.num_brokers
    return out


def lane_timings(torch, entries: dict, wv: dict, tag: str) -> None:
    """Time the four lane kernels at ``wv``'s lanes beside their lane twins,
    the same lanes' solo launches one after another and the bound."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.kernels import admission, keys, move_score, select
    La, R, Kc, B = len(wv["lanes"]), wv["R"], wv["K"], wv["B"]

    def solo_ms(e, fn):
        ms = time_ms(torch, fn)
        e.timings[-1]["solo_ms"] = ms
        log(f"  {e.name} at {tag}: {La} solo launches {ms:.6f} ms")

    if "keys" in wv:
        e = entries["replica_keys_lanes"]
        a = wv["keys"]
        timing(torch, e, lambda: K.replica_keys_lanes(*a),
               lambda: keys.replica_keys_lanes_plain(*a), None,
               La * R * (2 * 4 + 8 + 3 + 4) + nbytes(a[8], a[9]), La * 20 * R, tag)
        solo = [(a[0], (a[1][0][l], a[1][1][l]), a[2], a[3][l], a[4][l], a[5][l], a[6][l],
                 a[8][j], a[9][j]) for j, l in enumerate(a[7])]
        solo_ms(e, lambda: [K.replica_keys(*x) for x in solo])
    e = entries["select_candidates_lanes"]
    key, k_all, stalls, salt, mask = wv["select"]
    timing(torch, e, lambda: K.select_candidates_lanes(key, k_all, stalls, salt, mask),
           lambda: select.select_candidates_lanes_plain(key, k_all, stalls, salt, mask),
           lambda: torch.topk(torch.where(mask, key, -torch.inf), k_all, dim=1),
           nbytes(key, mask) + La * k_all * (4 + 8), La * 4 * R, tag)
    solo_ms(e, lambda: [K.select_candidates(key[j], k_all, stalls[j], salt,
                                            seed_mask=mask[j]) for j in range(La)])
    e = entries["move_score_classes_lanes"]
    sa = wv["score"]
    T = sa[0][1]
    rooms_used = bin(sa[0][8]).count("1")
    timing(torch, e, lambda: K.move_score_classes_lanes(sa),
           lambda: move_score.move_score_classes_lanes_plain(sa), None,
           sum(nbytes(*(t for t in a if isinstance(t, torch.Tensor))) for a in sa)
           + La * Kc * T * (4 + 8), La * Kc * B * (2 * rooms_used + 12), tag)
    solo_ms(e, lambda: [K.move_score_classes(*a) for a in sa])
    e = entries["wave_admission_lanes"]
    aa = wv["admit"]
    N = aa[0][0].shape[0]
    timing(torch, e, lambda: K.wave_admission_lanes(aa),
           lambda: admission.wave_admission_lanes_plain(aa), None,
           sum(nbytes(*a[:7], *a[7][:2], a[8]) + N for a in aa), La * N * 8 * 6, tag)
    solo_ms(e, lambda: [K.wave_admission(*a) for a in aa])


def lane_kernel_checks(torch, lctx, entries: dict, seed: int) -> None:
    """The four lane kernels against their lane twins (loops of the solo
    twins) at L = 16 and on a running subset (every other lane, so frozen
    lanes sit between running ones), for a goal with the K1 keying
    (DiskUsageDistributionGoal) and one with plain keys
    (ReplicaDistributionGoal); then timed at L = 16."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.kernels import admission, keys, move_score, select
    full = list(range(LANES))
    for goal_name in ("DiskUsageDistributionGoal", "ReplicaDistributionGoal"):
        for lanes in (full, full[1::2]):
            wv = lane_wave(torch, lctx, goal_name, lanes, seed)
            tag = f"{goal_name} L={len(lanes)}"
            if "keys" in wv:
                a = wv["keys"]
                check(torch, entries["replica_keys_lanes"],
                      lambda: K.replica_keys_lanes(*a),
                      lambda: keys.replica_keys_lanes_plain(*a), tag)
            key, k_all, stalls, salt, mask = wv["select"]
            check(torch, entries["select_candidates_lanes"],
                  lambda: K.select_candidates_lanes(key, k_all, stalls, salt, mask),
                  lambda: select.select_candidates_lanes_plain(key, k_all, stalls, salt,
                                                               mask), tag)
            check(torch, entries["move_score_classes_lanes"],
                  lambda: K.move_score_classes_lanes(wv["score"]),
                  lambda: move_score.move_score_classes_lanes_plain(wv["score"]), tag)
            check(torch, entries["wave_admission_lanes"],
                  lambda: K.wave_admission_lanes(wv["admit"]),
                  lambda: admission.wave_admission_lanes_plain(wv["admit"]), tag)
    # adversarial K1 lanes: keys tied across lanes, signed zeros, all -inf lanes
    g = torch.Generator().manual_seed(seed)
    R = lctx["stack"].num_replicas
    base = torch.randint(0, 6, (R,), generator=g).float()
    adv = torch.stack([base, base, -base, torch.zeros(R), torch.full((R,), -torch.inf)])
    adv[0, :64] = -0.0
    adv = adv.cuda().contiguous()
    for stalls in ([0, 0, 0, 0, 0], [0, 2, 1, 5, 3]):
        check(torch, entries["select_candidates_lanes"],
              lambda: K.select_candidates_lanes(adv, 1024, stalls),
              lambda: select.select_candidates_lanes_plain(adv, 1024, stalls),
              f"adversarial ties across lanes, stalls {stalls}")
    lane_timings(torch, entries, lane_wave(torch, lctx, "DiskUsageDistributionGoal", full,
                                           seed), f"L={LANES}")


# the goals of the branch lane kernels' checks: a leadership-primary goal
# (K6) and a swap goal (K7), each after the lane stack's move goals, and the
# probe's goals (K13: two and three key kinds)
LANE_LEAD_GOAL = "LeaderReplicaDistributionGoal"
LANE_SWAP_GOAL = "DiskUsageDistributionGoal"
# a goal whose probe reads 1, 2 or 3 key kinds
PROBE_GOALS = {1: "ReplicaDistributionGoal", 2: "DiskUsageDistributionGoal",
               3: "CpuUsageDistributionGoal"}


def branch_lane_wave(torch, lctx, lanes: list, seed: int, adversarial: bool = False,
                     probe_goal: str = LANE_SWAP_GOAL) -> dict:
    """The inputs of the leadership and swap branches' lane launches for
    ``lanes`` (each lane's solo SPI on its views, as
    ``lanes.lead_branch_lanes`` / ``swap_branch_lanes`` build them, with a
    different stall in every lane) and of the probe's (a seed mask per lane:
    one all-false, one all-true, the others random; ``probe_goal``'s keys).
    ``adversarial``: half
    the leadership rows and swap out rows of every other lane vetoed, the
    swap admission's rows on a few brokers and partitions with tied values,
    and probe keys of -inf, NaN and +inf."""
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.analyzer import lanes as lanes_mod
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.kernels import leadership, swap
    stack, params = lctx["stack"], lctx["params"]
    dev = stack.device
    R = stack.num_replicas
    g = torch.Generator().manual_seed(seed)
    out = dict(lanes=lanes, R=R, B=stack.env_b.num_brokers)
    stalls = {l: j % 3 for j, l in enumerate(lanes)}
    envs = [stack.envs[l] for l in lanes]
    sts = [stack.sts[l] for l in lanes]
    # K6: the leader keys, K1 at KL, then each lane's K6 operands
    lead = make_goals(LANE_GOALS + [LANE_LEAD_GOAL])
    goal, prev = lead[-1], tuple(lead[:-1])
    sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
    kl = min(params.num_leader_candidates, R)
    lkey = lanes_mod.lane_keys(stack, goal, lanes, sev, params, "leader_key")
    out["lead_select"] = (lkey, kl, [stalls[l] for l in lanes])
    lkv, lcand = lanes_mod.select_candidates_lanes(*out["lead_select"])
    args = []
    for j in range(len(lanes)):
        a = engine._lead_args(envs[j], sts[j], goal, prev, lcand[j], lkv[j] > -torch.inf)
        if adversarial and j % 2:
            a = (a[0], a[1], (a[2] & (torch.rand(kl, generator=g) < 0.5).to(dev))
                 .contiguous()) + a[3:]
        args.append(a)
    out["lead"] = args
    # the assignment and the swap pairs' racks and topic counts read from the
    # stack's rows at the lane index list, as the fleet's branches read them
    out["lead_stacked"] = (lanes, stack.st_b.replica_broker, stack.st_b.replica_offline)
    out["swap_stacked"] = (lanes, stack.env_b.broker_rack, stack.st_b.topic_broker_count)
    best_l, f_l = leadership.leadership_rows_lanes_plain(args)
    out["lead_admit"] = [engine._lead_admission_from_scores(
        envs[j], sts[j], goal, prev, params, lcand[j], best_l[j], f_l[j])[2]
        for j in range(len(lanes))]
    # K7: the out and in pools, then each lane's pair operands
    goals = make_goals(LANE_GOALS)
    gi = LANE_GOALS.index(LANE_SWAP_GOAL)
    sgoal, sprev = goals[gi], tuple(goals[:gi])
    sev = {l: sgoal.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
    k = min(params.num_swap_candidates, R, 128)
    st_list = [stalls[l] for l in lanes]
    okv, cand_out = lanes_mod.select_candidates_lanes(
        lanes_mod.lane_keys(stack, sgoal, lanes, sev, params, "swap_out_key"), k, st_list)
    ikv, cand_in = lanes_mod.select_candidates_lanes(
        lanes_mod.lane_keys(stack, sgoal, lanes, sev, params, "swap_in_key"), k, st_list,
        salt=101)
    pairs, tables = [], []
    for j in range(len(lanes)):
        pr, tb = engine._swap_args(envs[j], sts[j], sgoal, sprev, cand_out[j], okv[j],
                                   cand_in[j], ikv[j])
        if adversarial and j % 2:
            pr = dataclasses.replace(pr, row_ok_out=(
                pr.row_ok_out & (torch.rand(k, generator=g) < 0.5).to(dev)).contiguous())
        pairs.append(pr)
        tables.append(tb)
    out["swap"] = (pairs, tables, params.min_gain)
    best, best_j, _n = swap.swap_rows_lanes_plain(pairs, tables, params.min_gain)
    adm = [engine._swap_admission_inputs(envs[j], pairs[j], cand_out[j], cand_in[j],
                                         best[j], best_j[j]) for j in range(len(lanes))]
    rows = [torch.stack([a[2][i] for a in adm]).contiguous() for i in range(6)]
    if adversarial:
        La = len(lanes)
        rows[0] = torch.randint(-2, 3, (La, k), generator=g).float().to(dev)
        for i in (1, 2, 4, 5):
            rows[i] = torch.randint(0, 6, (La, k), generator=g).to(dev)
        rows[3] = torch.randint(0, 8, (La, k), generator=g).to(dev)
    out["swap_adm"] = rows + [params.min_gain]
    # K13: a seed mask per lane against the probe goal's keys
    pgoal = make_goals([probe_goal])[0]
    methods = pgoal.seeded_work_methods()
    sev = {l: pgoal.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
    keys = [lanes_mod.lane_keys(stack, pgoal, lanes, sev, None, m) for m in methods]
    mask = (torch.rand((len(lanes), R), generator=g) < 0.01).to(dev)
    mask[0] = False
    if len(lanes) > 1:
        mask[1] = True
    if adversarial:
        special = torch.tensor([-torch.inf, float("nan"), torch.inf, -0.0])
        keys = [torch.where(torch.rand(k_.shape, generator=g).to(dev) < 0.999,
                            torch.full_like(k_, -torch.inf),
                            special[torch.randint(0, 4, k_.shape, generator=g)].to(dev))
                .contiguous() for k_ in keys]
    out["probe"] = (mask.contiguous(), keys)
    return out


def branch_lane_timings(torch, entries: dict, wv: dict, tag: str) -> None:
    """Time the leadership, swap and probe lane kernels at ``wv``'s lanes
    beside their lane twins, the same lanes' solo launches one after another
    and the bound; and the move wave's lane kernels that these branches
    launch at shapes of their own (K1 at the leader and swap pools' k, K3
    at the leadership wave's N), when ``entries`` holds them."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.kernels import admission, leadership, probe, select, swap
    La = len(wv["lanes"])

    def solo_ms(e, fn):
        ms = time_ms(torch, fn)
        e.timings[-1]["solo_ms"] = ms
        log(f"  {e.name} at {tag}: {La} solo launches {ms:.6f} ms")

    # each bound is La times the solo launch's (``lead_bytes``,
    # ``swap_rows_work``): a lane gathers only its own rows' members
    la, ls, ss = wv["lead"], wv["lead_stacked"], wv["swap_stacked"]
    Kl, F = la[0][1].shape
    timing(torch, entries["leadership_rows_lanes"], lambda: K.leadership_rows_lanes(la, ls),
           lambda: leadership.leadership_rows_lanes_plain(la), None,
           La * lead_bytes(Kl, F), La * Kl * F * 30, tag)
    solo_ms(entries["leadership_rows_lanes"], lambda: [K.leadership_rows(*a) for a in la])
    pairs, tables, mg = wv["swap"]
    K1 = pairs[0].b_out.shape[0]
    work = [swap_rows_work(p, t) for p, t in zip(pairs, tables)]
    timing(torch, entries["swap_rows_lanes"],
           lambda: K.swap_rows_lanes(pairs, tables, mg, ss),
           lambda: swap.swap_rows_lanes_plain(pairs, tables, mg), None,
           sum(w[0] for w in work), sum(w[1] for w in work), tag)
    solo_ms(entries["swap_rows_lanes"],
            lambda: [K.swap_rows(p, t, mg) for p, t in zip(pairs, tables)])
    ad = wv["swap_adm"]
    timing(torch, entries["swap_admission_lanes"], lambda: K.swap_admission_lanes(*ad),
           lambda: swap.swap_admission_lanes_plain(*ad), None,
           nbytes(*ad[:6]) + La * K1, La * K1 * K1 * 10, tag)
    solo_ms(entries["swap_admission_lanes"],
            lambda: [K.swap_admission(*(x[j] for x in ad[:6]), mg) for j in range(La)])
    mask, keys = wv["probe"]
    timing(torch, entries["seeded_probe_lanes"], lambda: K.seeded_probe_lanes(mask, keys),
           lambda: probe.seeded_probe_lanes_plain(mask, keys),
           lambda: torch.stack([(torch.where(mask, k_, -torch.inf) > -torch.inf).any(dim=1)
                                for k_ in keys]).any(dim=0),
           nbytes(mask, *keys) + La * 4, La * wv["R"] * 2 * len(keys), tag)
    solo_ms(entries["seeded_probe_lanes"],
            lambda: [K.seeded_probe(mask[j], [k_[j] for k_ in keys]) for j in range(La)])
    if "select_candidates_lanes" in entries:
        key, kl, stalls = wv["lead_select"]
        timing(torch, entries["select_candidates_lanes"],
               lambda: K.select_candidates_lanes(key, kl, stalls),
               lambda: select.select_candidates_lanes_plain(key, kl, stalls),
               lambda: torch.topk(key, kl, dim=1), nbytes(key) + La * kl * (4 + 8),
               La * 4 * wv["R"], tag)
        solo_ms(entries["select_candidates_lanes"],
                lambda: [K.select_candidates(key[j], kl, stalls[j]) for j in range(La)])
    if "wave_admission_lanes" in entries:
        aa = wv["lead_admit"]
        N = aa[0][0].shape[0]
        timing(torch, entries["wave_admission_lanes"], lambda: K.wave_admission_lanes(aa),
               lambda: admission.wave_admission_lanes_plain(aa), None,
               sum(nbytes(*a[:7], *a[7][:2], a[8]) + N for a in aa), La * N * 8 * 6, tag)
        solo_ms(entries["wave_admission_lanes"], lambda: [K.wave_admission(*a) for a in aa])


def branch_lane_checks(torch, lctx, entries: dict, seed: int) -> None:
    """The leadership, swap and probe lane kernels (K6, K7's rows and
    admission, K13) against their lane twins (loops of the solo twins) at
    the fleet cell's shape, L = 16 and every other lane, on the lanes'
    states and adversarially; then timed at L = 16."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.kernels import leadership, probe, swap
    full = list(range(LANES))
    for lanes in (full, full[1::2]):
        for adversarial in (False, True):
            wv = branch_lane_wave(torch, lctx, lanes, seed, adversarial)
            tag = f"L={len(lanes)}{' adversarial' if adversarial else ''}"
            check(torch, entries["leadership_rows_lanes"],
                  lambda: K.leadership_rows_lanes(wv["lead"], wv["lead_stacked"]),
                  lambda: leadership.leadership_rows_lanes_plain(wv["lead"]), tag)
            pairs, tables, mg = wv["swap"]
            check(torch, entries["swap_rows_lanes"],
                  lambda: K.swap_rows_lanes(pairs, tables, mg, wv["swap_stacked"]),
                  lambda: swap.swap_rows_lanes_plain(pairs, tables, mg), tag)
            check(torch, entries["swap_admission_lanes"],
                  lambda: K.swap_admission_lanes(*wv["swap_adm"]),
                  lambda: swap.swap_admission_lanes_plain(*wv["swap_adm"]), tag)
            mask, keys = wv["probe"]
            check(torch, entries["seeded_probe_lanes"],
                  lambda: K.seeded_probe_lanes(mask, keys),
                  lambda: probe.seeded_probe_lanes_plain(mask, keys), tag)
    branch_lane_timings(torch, entries, branch_lane_wave(torch, lctx, full, seed),
                        f"L={LANES}")


def fleet_phase(torch, lctx, entries: dict, seed: int) -> dict:
    """The fleet-16x100b cell through ``FleetScheduler.run_round`` on the
    card (``fleet_script.fleet_e2e``): round 1 (full) and round 2 (one more
    window, delta syncs), the launch counts zeroed just before and read just
    after, every tenant's row the JAX reference's; the 16 solo rounds, equal
    to the lanes; the memory budget's LRU spill and a bit-identical readmit;
    the move wave's, the leadership branch's and the swap branch's launches
    in one pass at L = 1 and L = 16; the walls and the card's busy share."""
    import threading
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import lanes as lanes_mod
    from cruise_control_tpu_torch.fleet_script import (
        FLEET_E2E, fleet_e2e, port_fleet_ns, solo_e2e,
    )
    ns = port_fleet_ns("cuda")
    util = []
    stop = threading.Event()

    def sample_util():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=utilization.gpu",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                util.append(float(out.stdout.strip().splitlines()[0]))
            stop.wait(0.2)

    K.reset_launches()
    sampler = threading.Thread(target=sample_util, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        # round 1 on the sampled windows, round 2 after one more window: the
        # delta syncs, the per-lane seed masks and the fleet memo's re-check
        run = fleet_e2e(ns, FLEET_E2E, rounds=2)
        torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join(60)
    total = time.perf_counter() - t0
    launches, shapes = K.launches(), K.launch_shapes()
    log(f"fleet: kernel launches {launches}")
    log(f"fleet: launches by shape {json.dumps(shapes)}")
    log(f"fleet: round walls (s) {run['walls']}, {total:.6f} s in all; "
        f"nvidia-smi utilization.gpu sampled every 0.2 s during them: mean "
        f"{statistics.mean(util) if util else float('nan'):.3f}% over {len(util)} samples")
    for r, (got, want) in enumerate(zip(run["rounds"], FLEET_ORACLE["rounds"])):
        for cid in want:
            diff = {k: (got[cid].get(k), v) for k, v in want[cid].items()
                    if got[cid].get(k) != v}
            require(not diff, f"fleet R{r + 1} {cid} differs from the JAX reference: {diff}")
        log(f"fleet R{r + 1}: {len(want)} tenants, every row the JAX reference's "
            f"({sum(v['proposals'] for v in got.values())} proposals)")
    require(len(run["rounds"]) == len(FLEET_ORACLE["rounds"]),
            f"fleet: {len(run['rounds'])} rounds ran")
    require(run["reports"] == FLEET_ORACLE["reports"],
            f"fleet reports {run['reports']} != the reference's {FLEET_ORACLE['reports']}")
    require(all(launches[n] > 0 for n in FLEET_KERNELS + FIVE_GOAL_KERNELS),
            f"a kernel of the fleet path never launched: {launches}")
    fleet = run["fleet"]

    # four solo rounds on the card (tenants 0, 5, 10, 15; a cut of depth
    # that pays for phase 10): each equal to its lane
    solo = solo_e2e(ns, FLEET_E2E, tenants=SOLO_TENANTS)
    require(solo["rows"] == {cid: run["rounds"][0][cid] for cid in solo["rows"]},
            "fleet: a lane differs from its solo round")
    log(f"fleet: the {len(solo['rows'])} solo rounds of tenants {SOLO_TENANTS} equal "
        f"their lanes; solo walls (s) {solo['walls']}, x {LANES / len(SOLO_TENANTS):g} "
        f"{sum(solo['walls']) * LANES / len(SOLO_TENANTS):.6f} s against the fleet's "
        f"round 1 {run['walls'][0]:.6f} s")

    # the memory budget: LRU spill, readmit bit-identical
    ids = fleet.cluster_ids
    sess = fleet.tenants[ids[0]].session
    sess._ensure_state()
    pre = {("env", f.name): getattr(sess.env, f.name).clone()
           for f in dataclasses.fields(sess.env)
           if hasattr(getattr(sess.env, f.name), "clone")}
    pre.update({("st", f.name): getattr(sess.state, f.name).clone()
                for f in dataclasses.fields(sess.state)})
    for t in fleet.tenants.values():
        t.last_round_seq = 1
    fleet.tenants[ids[0]].last_round_seq = 0           # the coldest
    resident = fleet.device_bytes()
    fleet.memory_budget_bytes = resident - 1
    spilled = fleet.enforce_memory_budget()
    require(spilled == [ids[0]], f"fleet: the LRU spilled {spilled}, not {ids[0]}")
    freed = fleet.device_bytes()
    require(freed < resident and sess.spilled, "fleet: nothing was freed")
    fleet.memory_budget_bytes = -1
    require(sess.readmit(), "fleet: the readmit did nothing")
    for (kind, name), v in pre.items():
        now = getattr(sess.env if kind == "env" else sess.state, name)
        require(now.dtype == v.dtype and torch.equal(now, v),
                f"fleet: {kind}.{name} differs after spill and readmit")
    log(f"fleet: with LRU ranks that make {ids[0]} the coldest, a budget of "
        f"{resident - 1} bytes spilled {spilled} ({resident} -> {freed} bytes "
        f"resident); its readmit is bit-identical, every env and state leaf")
    # the fleet's own lane stack (its tenants' states after round 2) for the
    # timings at the shapes the cell launched most
    fctx = dict(lctx, stack=lanes_mod.LaneStack(
        *zip(*(fleet.tenants[cid].session.revalidation_view() for cid in ids))))
    fctx["params"] = fleet.optimizer.scaled_params(fctx["stack"].num_replicas,
                                                   fctx["stack"].env_b.num_brokers)
    # the engine's options on the lane path: one batched round of the
    # fleet's tenants, the option lane kernels timed at its shapes
    options = options_fleet_run(torch, fleet)
    option_lane_checks(torch, entries, fctx["stack"], fctx["params"], options["shapes"],
                       seed)
    option_lane_timings(torch, entries, fctx["stack"], fctx["params"], options["shapes"],
                        seed)
    fleet.shutdown()

    # the move wave's launches in one pass at L = 1 and L = 16
    goal = next(gl for gl in lctx["goals"] if gl.name == "DiskUsageDistributionGoal")
    one = dataclasses.replace(lctx["params"], max_iters=1)
    per_pass = {}
    for La in (1, LANES):
        K.reset_launches()
        lanes_mod.fleet_goal_loop(lctx["stack"], goal, (), {l: one for l in range(La)},
                                  list(range(La)), 0, {})
        torch.cuda.synchronize()
        per_pass[La] = {n: c for n, c in K.launches().items() if c}
    log(f"fleet: the move wave's launches in one pass, L=1 {per_pass[1]}, "
        f"L={LANES} {per_pass[LANES]}")
    require(per_pass[1] == per_pass[LANES],
            "fleet: the move wave's launches per pass depend on the lane count")
    # the leadership and swap branches' launches in one pass at L = 1 and 16
    branch_pass = branch_launches_per_pass(torch, lctx)
    # time the lane kernels at the shapes the cell launched most
    for name in MOVE_LANE_KERNELS:
        ran = shapes[name]
        top = max(ran, key=ran.get)
        La = int(top.split()[0].split("=")[1])
        if all(t["shape"] != top for t in entries[name].timings):
            wv = lane_wave(torch, fctx, "DiskUsageDistributionGoal", list(range(La)), seed)
            lane_timings(torch, {name: entries[name],
                                 **{n: Entry(n) for n in MOVE_LANE_KERNELS if n != name}},
                         wv, f"L={La}")
    for name in BRANCH_LANE_KERNELS:
        ran = shapes[name]
        top = max(ran, key=ran.get)
        if all(t["shape"] != top for t in entries[name].timings):
            La = int(top.split()[0].split("=")[1])
            keys = int(top.split("keys=")[1]) if "keys=" in top else 2
            require(keys in PROBE_GOALS, f"no probe goal reads {keys} key kinds")
            wv = branch_lane_wave(torch, fctx, list(range(La)), seed,
                                  probe_goal=PROBE_GOALS[keys])
            branch_lane_timings(torch, {name: entries[name],
                                        **{n: Entry(n) for n in BRANCH_LANE_KERNELS
                                           if n != name}}, wv, f"L={La}")
    # K1 and K3 lanes at the branches' own shapes, when one of those is
    # the shape the cell launched most
    for name in ("select_candidates_lanes", "wave_admission_lanes"):
        ran = shapes[name]
        top = max(ran, key=ran.get)
        if all(t["shape"] != top for t in entries[name].timings):
            La = int(top.split()[0].split("=")[1])
            wv = branch_lane_wave(torch, fctx, list(range(La)), seed)
            branch_lane_timings(torch, {name: entries[name],
                                        **{n: Entry(n) for n in BRANCH_LANE_KERNELS}},
                                wv, f"L={La}")
    return dict(launches=launches, shapes=shapes, walls=run["walls"],
                solo_walls=solo["walls"], util=util, branch_pass=branch_pass,
                rows=run["rounds"], options=options)


def branch_launches_per_pass(torch, lctx) -> dict:
    """The kernel launches of one leadership-branch pass
    (``lanes.lead_branch_lanes``, LeaderReplicaDistributionGoal) and one
    swap-branch pass (``swap_branch_lanes``, DiskUsageDistributionGoal) at
    L = 1 and L = 16: each must be the same at both lane counts."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch.analyzer import lanes as lanes_mod
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    stack, params = lctx["stack"], lctx["params"]
    lead = make_goals(LANE_GOALS + [LANE_LEAD_GOAL])
    goals = make_goals(LANE_GOALS)
    gi = LANE_GOALS.index(LANE_SWAP_GOAL)
    out = {}
    for tag, goal, prev, fn, extra in (
            ("leadership", lead[-1], tuple(lead[:-1]), lanes_mod.lead_branch_lanes, ()),
            ("swap", goals[gi], tuple(goals[:gi]), lanes_mod.swap_branch_lanes, (True,))):
        per = {}
        for La in (1, LANES):
            lanes = list(range(La))
            sev = {l: goal.broker_severity(stack.envs[l], stack.sts[l]) for l in lanes}
            K.reset_launches()
            fn(stack, goal, prev, params, sev, {l: 0 for l in lanes}, lanes, {}, *extra)
            torch.cuda.synchronize()
            per[La] = {n: c for n, c in K.launches().items() if c}
        log(f"fleet: the {tag} branch's launches in one pass, L=1 {per[1]}, "
            f"L={LANES} {per[LANES]}")
        require(per[1] == per[LANES],
                f"fleet: the {tag} branch's launches per pass depend on the lane count")
        out[tag] = per
    return out


# ---------------------------------------------------------------------------
# phase 9: the front door
# ---------------------------------------------------------------------------
# The front door's rows through the JAX reference (JAX 0.9.0,
# JAX_PLATFORMS=cpu, a fresh interpreter): ``python tests/torch_reference.py
# service-e2e``, the rows of ``cruise_control_tpu_torch.service_script``'s
# ``service_e2e`` at e2e-1000b-50000p and ``fleet_service_e2e`` at
# fleet-16x100b (digests: the first 16 hex digits of the sha256 of the
# bodies' canonical JSON without their wall-clock fields and stats; the
# stats those of the final state; an error body's stack trace is dropped).
# The fleet service's tenant rows and round report are FLEET_ORACLE's round
# 1, the reference's fleet_e2e, exactly; its part here is ``python
# tests/torch_reference.py service-e2e fleet`` (every tenant is
# under-provisioned, so its POST /rebalance answers 500 with the hard-goal
# failure and the provision recommendation).
SERVICE_ORACLE = {'service': {'round': {'sync': 'pipelined',
                                        'churn': 0,
                                        'round': 'full',
                                        'before': ['CpuCapacityGoal', 'CpuUsageDistributionGoal',
                                                   'DiskUsageDistributionGoal', 'LeaderBytesInDistributionGoal',
                                                   'LeaderReplicaDistributionGoal',
                                                   'NetworkInboundUsageDistributionGoal',
                                                   'NetworkOutboundUsageDistributionGoal', 'RackAwareGoal',
                                                   'ReplicaDistributionGoal', 'TopicReplicaDistributionGoal'],
                                        'after': ['DiskUsageDistributionGoal', 'LeaderReplicaDistributionGoal',
                                                  'NetworkInboundUsageDistributionGoal',
                                                  'NetworkOutboundUsageDistributionGoal',
                                                  'ReplicaDistributionGoal'],
                                        'proven': [False, False, False, False, False, False, False, False, False,
                                                   True, True, False, False, False, True, False],
                                        'actions': [2522, 0, 0, 0, 0, 0, 12479, 28471, 0, 4722, 580, 6142, 469, 455,
                                                    3842, 0],
                                        'passes': [4, 3, 3, 3, 3, 3, 9, 170, 3, 196, 194, 200, 118, 43, 205, 3],
                                        'modes': ['full', 'full', 'full', 'full', 'full', 'full', 'full', 'full',
                                                  'full', 'full', 'full', 'full', 'full', 'full', 'full', 'full'],
                                        'moves': 45997,
                                        'leads': 36316,
                                        'proposals': 40307,
                                        'proposals_sha': '1deda5700010611c',
                                        'fallback': 0,
                                        'skipped': 0,
                                        'digests': {'replica_broker': '2a0d62b57d77e784',
                                                    'replica_is_leader': 'b4f54de1aa7c4df5',
                                                    'replica_disk': 'b527dab94f6bf43c',
                                                    'util': '1363f9a8f1e27710',
                                                    'leader_util': '8b7c754a2e28ccec',
                                                    'potential_nw_out': '86fb82b41d781330',
                                                    'disk_util': '60d08f201df88d3e',
                                                    'replica_count': '640d7a03a9b66f3b',
                                                    'leader_count': 'f2236f00f087180c',
                                                    'topic_broker_count': 'ef9dfa6d4e61562f'}},
                              'sync': {'mode': 'delta', 'ingested': 51000},
                              'steps': [{'ingested': 1, 'sync': None, 'skipped': True},
                                        {'ingested': 1, 'sync': 'rebuild', 'skipped': False},
                                        {'ingested': 1, 'sync': 'delta', 'skipped': False},
                                        {'ingested': 1, 'sync': 'delta', 'skipped': False},
                                        {'ingested': 1, 'sync': 'delta', 'skipped': False},
                                        {'ingested': 1, 'sync': 'delta', 'skipped': False}],
                              'rebalance': {'summary': {'numReplicaMovements': 45997,
                                                        'numLeaderMovements': 36316,
                                                        'numIntraBrokerReplicaMovements': 0,
                                                        'violatedGoalsBefore': ['RackAwareGoal', 'CpuCapacityGoal',
                                                                                'ReplicaDistributionGoal',
                                                                                'DiskUsageDistributionGoal',
                                                                                'NetworkInboundUsageDistributionGoal',
                                                                                'NetworkOutboundUsageDistributionGoal',
                                                                                'CpuUsageDistributionGoal',
                                                                                'TopicReplicaDistributionGoal',
                                                                                'LeaderReplicaDistributionGoal',
                                                                                'LeaderBytesInDistributionGoal'],
                                                        'violatedGoalsAfter': ['ReplicaDistributionGoal',
                                                                               'DiskUsageDistributionGoal',
                                                                               'NetworkInboundUsageDistributionGoal',
                                                                               'NetworkOutboundUsageDistributionGoal',
                                                                               'LeaderReplicaDistributionGoal']},
                                            'sums': {'dataToMoveMB': 10732861, 'intraBrokerDataToMoveMB': 0},
                                            'stale': None,
                                            'digest': '6652013c8a2b411d',
                                            'stats': {'metadata': {'brokers': 1000,
                                                                   'replicas': 100000,
                                                                   'topics': 200},
                                                      'statistics': {'AVG': {'cpu': 45.6494,
                                                                             'networkInbound': 1991.9742,
                                                                             'networkOutbound': 1991.9742,
                                                                             'disk': 19919.7402,
                                                                             'potentialNwOut': 3983.9485,
                                                                             'replicas': 100.0,
                                                                             'leaderReplicas': 50.0,
                                                                             'topicReplicas': 0.5},
                                                                     'MAX': {'cpu': 49.7587,
                                                                             'networkInbound': 2504.8337,
                                                                             'networkOutbound': 2181.2451,
                                                                             'disk': 25048.3262,
                                                                             'potentialNwOut': 5009.6675,
                                                                             'replicas': 109,
                                                                             'leaderReplicas': 72.0,
                                                                             'topicReplicas': 3.0},
                                                                     'MIN': {'cpu': 36.5994,
                                                                             'networkInbound': 1802.6973,
                                                                             'networkOutbound': 1347.7023,
                                                                             'disk': 18026.9863,
                                                                             'potentialNwOut': 3605.3945,
                                                                             'replicas': 59,
                                                                             'leaderReplicas': 18.0,
                                                                             'topicReplicas': 0.0},
                                                                     'STD': {'cpu': 3.4584,
                                                                             'networkInbound': 153.7976,
                                                                             'networkOutbound': 193.1999,
                                                                             'disk': 1537.9761,
                                                                             'potentialNwOut': 307.5952,
                                                                             'replicas': 9.773432731628418,
                                                                             'leaderReplicas': 10.7348,
                                                                             'topicReplicas': 0.6975}}}},
                              'proposals': [{'summary': {'numReplicaMovements': 45997,
                                                         'numLeaderMovements': 36316,
                                                         'numIntraBrokerReplicaMovements': 0,
                                                         'violatedGoalsBefore': ['RackAwareGoal', 'CpuCapacityGoal',
                                                                                 'ReplicaDistributionGoal',
                                                                                 'DiskUsageDistributionGoal',
                                                                                 'NetworkInboundUsageDistributionGoal',
                                                                                 'NetworkOutboundUsageDistributionGoal',
                                                                                 'CpuUsageDistributionGoal',
                                                                                 'TopicReplicaDistributionGoal',
                                                                                 'LeaderReplicaDistributionGoal',
                                                                                 'LeaderBytesInDistributionGoal'],
                                                         'violatedGoalsAfter': ['ReplicaDistributionGoal',
                                                                                'DiskUsageDistributionGoal',
                                                                                'NetworkInboundUsageDistributionGoal',
                                                                                'NetworkOutboundUsageDistributionGoal',
                                                                                'LeaderReplicaDistributionGoal']},
                                             'sums': {'dataToMoveMB': 10732861, 'intraBrokerDataToMoveMB': 0},
                                             'stale': False,
                                             'digest': '6cb47ab94e3377bf',
                                             'stats': {'metadata': {'brokers': 1000,
                                                                    'replicas': 100000,
                                                                    'topics': 200},
                                                       'statistics': {'AVG': {'cpu': 45.6494,
                                                                              'networkInbound': 1991.9742,
                                                                              'networkOutbound': 1991.9742,
                                                                              'disk': 19919.7402,
                                                                              'potentialNwOut': 3983.9485,
                                                                              'replicas': 100.0,
                                                                              'leaderReplicas': 50.0,
                                                                              'topicReplicas': 0.5},
                                                                      'MAX': {'cpu': 49.7587,
                                                                              'networkInbound': 2504.8337,
                                                                              'networkOutbound': 2181.2451,
                                                                              'disk': 25048.3262,
                                                                              'potentialNwOut': 5009.6675,
                                                                              'replicas': 109,
                                                                              'leaderReplicas': 72.0,
                                                                              'topicReplicas': 3.0},
                                                                      'MIN': {'cpu': 36.5994,
                                                                              'networkInbound': 1802.6973,
                                                                              'networkOutbound': 1347.7023,
                                                                              'disk': 18026.9863,
                                                                              'potentialNwOut': 3605.3945,
                                                                              'replicas': 59,
                                                                              'leaderReplicas': 18.0,
                                                                              'topicReplicas': 0.0},
                                                                      'STD': {'cpu': 3.4584,
                                                                              'networkInbound': 153.7976,
                                                                              'networkOutbound': 193.1999,
                                                                              'disk': 1537.9761,
                                                                              'potentialNwOut': 307.5952,
                                                                              'replicas': 9.773432731628418,
                                                                              'leaderReplicas': 10.7348,
                                                                              'topicReplicas': 0.6975}}}},
                                            {'summary': {'numReplicaMovements': 45997,
                                                         'numLeaderMovements': 36316,
                                                         'numIntraBrokerReplicaMovements': 0,
                                                         'violatedGoalsBefore': ['RackAwareGoal', 'CpuCapacityGoal',
                                                                                 'ReplicaDistributionGoal',
                                                                                 'DiskUsageDistributionGoal',
                                                                                 'NetworkInboundUsageDistributionGoal',
                                                                                 'NetworkOutboundUsageDistributionGoal',
                                                                                 'CpuUsageDistributionGoal',
                                                                                 'TopicReplicaDistributionGoal',
                                                                                 'LeaderReplicaDistributionGoal',
                                                                                 'LeaderBytesInDistributionGoal'],
                                                         'violatedGoalsAfter': ['ReplicaDistributionGoal',
                                                                                'DiskUsageDistributionGoal',
                                                                                'NetworkInboundUsageDistributionGoal',
                                                                                'NetworkOutboundUsageDistributionGoal',
                                                                                'LeaderReplicaDistributionGoal']},
                                             'sums': {'dataToMoveMB': 10732861, 'intraBrokerDataToMoveMB': 0},
                                             'stale': False,
                                             'digest': '6cb47ab94e3377bf',
                                             'stats': {'metadata': {'brokers': 1000,
                                                                    'replicas': 100000,
                                                                    'topics': 200},
                                                       'statistics': {'AVG': {'cpu': 45.6494,
                                                                              'networkInbound': 1991.9742,
                                                                              'networkOutbound': 1991.9742,
                                                                              'disk': 19919.7402,
                                                                              'potentialNwOut': 3983.9485,
                                                                              'replicas': 100.0,
                                                                              'leaderReplicas': 50.0,
                                                                              'topicReplicas': 0.5},
                                                                      'MAX': {'cpu': 49.7587,
                                                                              'networkInbound': 2504.8337,
                                                                              'networkOutbound': 2181.2451,
                                                                              'disk': 25048.3262,
                                                                              'potentialNwOut': 5009.6675,
                                                                              'replicas': 109,
                                                                              'leaderReplicas': 72.0,
                                                                              'topicReplicas': 3.0},
                                                                      'MIN': {'cpu': 36.5994,
                                                                              'networkInbound': 1802.6973,
                                                                              'networkOutbound': 1347.7023,
                                                                              'disk': 18026.9863,
                                                                              'potentialNwOut': 3605.3945,
                                                                              'replicas': 59,
                                                                              'leaderReplicas': 18.0,
                                                                              'topicReplicas': 0.0},
                                                                      'STD': {'cpu': 3.4584,
                                                                              'networkInbound': 153.7976,
                                                                              'networkOutbound': 193.1999,
                                                                              'disk': 1537.9761,
                                                                              'potentialNwOut': 307.5952,
                                                                              'replicas': 9.773432731628418,
                                                                              'leaderReplicas': 10.7348,
                                                                              'topicReplicas': 0.6975}}}}],
                              'load': {'brokers': 1000, 'digest': '94b0e45fe3ce0f20'},
                              'kafka_cluster_state': {'summary': {'Brokers': 1000,
                                                                  'Topics': 200,
                                                                  'Replicas': 100000,
                                                                  'Leaders': 50000},
                                                      'digest': '1d25f4ce7682c2e2'},
                              'partition_load': {'records': 50, 'digest': 'f069909f88523c8f'},
                              'pipeline': {'mode': 'threaded',
                                           'stalled': False,
                                           'stallCount': 0,
                                           'releaseCount': 0,
                                           'ingestRounds': 7,
                                           'syncRounds': 7,
                                           'optimizeRounds': 1,
                                           'staleRoundsDropped': 0,
                                           'syncedGeneration': 6,
                                           'optimizedGeneration': 5},
                              'round_traces': [{'mode': 'full', 'proposals': 40307, 'moves': 45997},
                                               {'mode': 'full', 'proposals': 40307, 'moves': 45997},
                                               {'mode': 'revalidated', 'proposals': 40307, 'moves': 45997}]},
                  'fleet': {'bodies': {'tenant-0': {'summary': {'numReplicaMovements': 1207,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 300659, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': '617bd0426aa83444',
                                                    'status': 200},
                                       'tenant-1': {'summary': {'numReplicaMovements': 1162,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 297992, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': 'ad6525e07c16563d',
                                                    'status': 200},
                                       'tenant-2': {'summary': {'numReplicaMovements': 1248,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 312411, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': '2a7e5d31483f665c',
                                                    'status': 200},
                                       'tenant-3': {'summary': {'numReplicaMovements': 1215,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 312760, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': 'e6c568cbee35a386',
                                                    'status': 200},
                                       'tenant-4': {'summary': {'numReplicaMovements': 1197,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 315322, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': '881b0a3772ee7aa3',
                                                    'status': 200},
                                       'tenant-5': {'summary': {'numReplicaMovements': 1264,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 314259, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': '3e42f1997864a0c9',
                                                    'status': 200},
                                       'tenant-6': {'summary': {'numReplicaMovements': 1217,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 315419, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': 'c6e3e1058fd0cdf0',
                                                    'status': 200},
                                       'tenant-7': {'summary': {'numReplicaMovements': 1231,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 309077, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': '31063a616a511735',
                                                    'status': 200},
                                       'tenant-8': {'summary': {'numReplicaMovements': 1158,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 293195, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': 'a0088549fbc48d55',
                                                    'status': 200},
                                       'tenant-9': {'summary': {'numReplicaMovements': 1192,
                                                                'numLeaderMovements': 0,
                                                                'numIntraBrokerReplicaMovements': 0,
                                                                'violatedGoalsBefore': ['RackAwareGoal',
                                                                                        'CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal'],
                                                                'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                       'ReplicaDistributionGoal',
                                                                                       'DiskUsageDistributionGoal',
                                                                                       'NetworkInboundUsageDistributionGoal',
                                                                                       'NetworkOutboundUsageDistributionGoal',
                                                                                       'CpuUsageDistributionGoal',
                                                                                       'LeaderReplicaDistributionGoal',
                                                                                       'LeaderBytesInDistributionGoal']},
                                                    'sums': {'dataToMoveMB': 301167, 'intraBrokerDataToMoveMB': 0},
                                                    'stale': False,
                                                    'digest': '2bb37403e2e71b56',
                                                    'status': 200},
                                       'tenant-10': {'summary': {'numReplicaMovements': 1206,
                                                                 'numLeaderMovements': 0,
                                                                 'numIntraBrokerReplicaMovements': 0,
                                                                 'violatedGoalsBefore': ['RackAwareGoal',
                                                                                         'CpuCapacityGoal',
                                                                                         'ReplicaDistributionGoal',
                                                                                         'DiskUsageDistributionGoal',
                                                                                         'NetworkInboundUsageDistributionGoal',
                                                                                         'NetworkOutboundUsageDistributionGoal',
                                                                                         'CpuUsageDistributionGoal',
                                                                                         'LeaderReplicaDistributionGoal',
                                                                                         'LeaderBytesInDistributionGoal'],
                                                                 'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal']},
                                                     'sums': {'dataToMoveMB': 304460, 'intraBrokerDataToMoveMB': 0},
                                                     'stale': False,
                                                     'digest': 'ddbd28f7bb1c2648',
                                                     'status': 200},
                                       'tenant-11': {'summary': {'numReplicaMovements': 1205,
                                                                 'numLeaderMovements': 0,
                                                                 'numIntraBrokerReplicaMovements': 0,
                                                                 'violatedGoalsBefore': ['RackAwareGoal',
                                                                                         'CpuCapacityGoal',
                                                                                         'ReplicaDistributionGoal',
                                                                                         'DiskUsageDistributionGoal',
                                                                                         'NetworkInboundUsageDistributionGoal',
                                                                                         'NetworkOutboundUsageDistributionGoal',
                                                                                         'CpuUsageDistributionGoal',
                                                                                         'LeaderReplicaDistributionGoal',
                                                                                         'LeaderBytesInDistributionGoal'],
                                                                 'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal']},
                                                     'sums': {'dataToMoveMB': 307744, 'intraBrokerDataToMoveMB': 0},
                                                     'stale': False,
                                                     'digest': '1078d573a4682ca4',
                                                     'status': 200},
                                       'tenant-12': {'summary': {'numReplicaMovements': 1287,
                                                                 'numLeaderMovements': 0,
                                                                 'numIntraBrokerReplicaMovements': 0,
                                                                 'violatedGoalsBefore': ['RackAwareGoal',
                                                                                         'CpuCapacityGoal',
                                                                                         'ReplicaDistributionGoal',
                                                                                         'DiskUsageDistributionGoal',
                                                                                         'NetworkInboundUsageDistributionGoal',
                                                                                         'NetworkOutboundUsageDistributionGoal',
                                                                                         'CpuUsageDistributionGoal',
                                                                                         'LeaderReplicaDistributionGoal',
                                                                                         'LeaderBytesInDistributionGoal'],
                                                                 'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal']},
                                                     'sums': {'dataToMoveMB': 313126, 'intraBrokerDataToMoveMB': 0},
                                                     'stale': False,
                                                     'digest': 'a24391cb92bb2460',
                                                     'status': 200},
                                       'tenant-13': {'summary': {'numReplicaMovements': 1217,
                                                                 'numLeaderMovements': 0,
                                                                 'numIntraBrokerReplicaMovements': 0,
                                                                 'violatedGoalsBefore': ['RackAwareGoal',
                                                                                         'CpuCapacityGoal',
                                                                                         'ReplicaDistributionGoal',
                                                                                         'DiskUsageDistributionGoal',
                                                                                         'NetworkInboundUsageDistributionGoal',
                                                                                         'NetworkOutboundUsageDistributionGoal',
                                                                                         'CpuUsageDistributionGoal',
                                                                                         'LeaderReplicaDistributionGoal',
                                                                                         'LeaderBytesInDistributionGoal'],
                                                                 'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal']},
                                                     'sums': {'dataToMoveMB': 313620, 'intraBrokerDataToMoveMB': 0},
                                                     'stale': False,
                                                     'digest': '7f0aeb4045849796',
                                                     'status': 200},
                                       'tenant-14': {'summary': {'numReplicaMovements': 1232,
                                                                 'numLeaderMovements': 0,
                                                                 'numIntraBrokerReplicaMovements': 0,
                                                                 'violatedGoalsBefore': ['RackAwareGoal',
                                                                                         'CpuCapacityGoal',
                                                                                         'ReplicaDistributionGoal',
                                                                                         'DiskUsageDistributionGoal',
                                                                                         'NetworkInboundUsageDistributionGoal',
                                                                                         'NetworkOutboundUsageDistributionGoal',
                                                                                         'CpuUsageDistributionGoal',
                                                                                         'LeaderReplicaDistributionGoal',
                                                                                         'LeaderBytesInDistributionGoal'],
                                                                 'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal']},
                                                     'sums': {'dataToMoveMB': 306447, 'intraBrokerDataToMoveMB': 0},
                                                     'stale': False,
                                                     'digest': '74d40af306fac95f',
                                                     'status': 200},
                                       'tenant-15': {'summary': {'numReplicaMovements': 1177,
                                                                 'numLeaderMovements': 0,
                                                                 'numIntraBrokerReplicaMovements': 0,
                                                                 'violatedGoalsBefore': ['RackAwareGoal',
                                                                                         'CpuCapacityGoal',
                                                                                         'ReplicaDistributionGoal',
                                                                                         'DiskUsageDistributionGoal',
                                                                                         'NetworkInboundUsageDistributionGoal',
                                                                                         'NetworkOutboundUsageDistributionGoal',
                                                                                         'CpuUsageDistributionGoal',
                                                                                         'LeaderReplicaDistributionGoal',
                                                                                         'LeaderBytesInDistributionGoal'],
                                                                 'violatedGoalsAfter': ['CpuCapacityGoal',
                                                                                        'ReplicaDistributionGoal',
                                                                                        'DiskUsageDistributionGoal',
                                                                                        'NetworkInboundUsageDistributionGoal',
                                                                                        'NetworkOutboundUsageDistributionGoal',
                                                                                        'CpuUsageDistributionGoal',
                                                                                        'LeaderReplicaDistributionGoal',
                                                                                        'LeaderBytesInDistributionGoal']},
                                                     'sums': {'dataToMoveMB': 300286, 'intraBrokerDataToMoveMB': 0},
                                                     'stale': False,
                                                     'digest': '71a07960f2f6c240',
                                                     'status': 200}},
                            'errors': {'no-such-tenant': 404, '../etc': 400},
                            'queued': 16,
                            'rebalanced': {'tenant-0': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': '33f9d5057ac4ce77',
                                                        'status': 500},
                                           'tenant-1': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': '50fde14978916434',
                                                        'status': 500},
                                           'tenant-2': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': 'b5ad443b58a6d333',
                                                        'status': 500},
                                           'tenant-3': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': 'b7cd35c82ef9166f',
                                                        'status': 500},
                                           'tenant-4': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': 'e14fccb45dd2ffdc',
                                                        'status': 500},
                                           'tenant-5': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': 'fc4745cde5e823b8',
                                                        'status': 500},
                                           'tenant-6': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': '54bf7bd814b2920d',
                                                        'status': 500},
                                           'tenant-7': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': '6701f746cf34a459',
                                                        'status': 500},
                                           'tenant-8': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': '1eac921d208432b3',
                                                        'status': 500},
                                           'tenant-9': {'summary': {'numReplicaMovements': None,
                                                                    'numLeaderMovements': None,
                                                                    'numIntraBrokerReplicaMovements': None,
                                                                    'violatedGoalsBefore': None,
                                                                    'violatedGoalsAfter': None},
                                                        'sums': {'dataToMoveMB': None,
                                                                 'intraBrokerDataToMoveMB': None},
                                                        'stale': None,
                                                        'digest': '08aa2b5e8b58fd7d',
                                                        'status': 500},
                                           'tenant-10': {'summary': {'numReplicaMovements': None,
                                                                     'numLeaderMovements': None,
                                                                     'numIntraBrokerReplicaMovements': None,
                                                                     'violatedGoalsBefore': None,
                                                                     'violatedGoalsAfter': None},
                                                         'sums': {'dataToMoveMB': None,
                                                                  'intraBrokerDataToMoveMB': None},
                                                         'stale': None,
                                                         'digest': '23a0c5e1d05f4ee9',
                                                         'status': 500},
                                           'tenant-11': {'summary': {'numReplicaMovements': None,
                                                                     'numLeaderMovements': None,
                                                                     'numIntraBrokerReplicaMovements': None,
                                                                     'violatedGoalsBefore': None,
                                                                     'violatedGoalsAfter': None},
                                                         'sums': {'dataToMoveMB': None,
                                                                  'intraBrokerDataToMoveMB': None},
                                                         'stale': None,
                                                         'digest': '375954db9139f0df',
                                                         'status': 500},
                                           'tenant-12': {'summary': {'numReplicaMovements': None,
                                                                     'numLeaderMovements': None,
                                                                     'numIntraBrokerReplicaMovements': None,
                                                                     'violatedGoalsBefore': None,
                                                                     'violatedGoalsAfter': None},
                                                         'sums': {'dataToMoveMB': None,
                                                                  'intraBrokerDataToMoveMB': None},
                                                         'stale': None,
                                                         'digest': 'bd5387ca0e94daa4',
                                                         'status': 500},
                                           'tenant-13': {'summary': {'numReplicaMovements': None,
                                                                     'numLeaderMovements': None,
                                                                     'numIntraBrokerReplicaMovements': None,
                                                                     'violatedGoalsBefore': None,
                                                                     'violatedGoalsAfter': None},
                                                         'sums': {'dataToMoveMB': None,
                                                                  'intraBrokerDataToMoveMB': None},
                                                         'stale': None,
                                                         'digest': 'bb852e7ba5823c7c',
                                                         'status': 500},
                                           'tenant-14': {'summary': {'numReplicaMovements': None,
                                                                     'numLeaderMovements': None,
                                                                     'numIntraBrokerReplicaMovements': None,
                                                                     'violatedGoalsBefore': None,
                                                                     'violatedGoalsAfter': None},
                                                         'sums': {'dataToMoveMB': None,
                                                                  'intraBrokerDataToMoveMB': None},
                                                         'stale': None,
                                                         'digest': '3796d12bee13b02d',
                                                         'status': 500},
                                           'tenant-15': {'summary': {'numReplicaMovements': None,
                                                                     'numLeaderMovements': None,
                                                                     'numIntraBrokerReplicaMovements': None,
                                                                     'violatedGoalsBefore': None,
                                                                     'violatedGoalsAfter': None},
                                                         'sums': {'dataToMoveMB': None,
                                                                  'intraBrokerDataToMoveMB': None},
                                                         'stale': None,
                                                         'digest': 'ca5847d541b694a2',
                                                         'status': 500}}}}
# the kernels the single-tenant service's path must launch: the default
# chain's, the sync's finalize and the first chunked round's probe
SERVICE_KERNELS = FIVE_GOAL_KERNELS + ("replica_keys", "leadership_rows", "swap_rows",
                                       "swap_admission", "session_finalize",
                                       "seeded_probe")


def service_phase(torch, fleet_rows: list) -> dict:
    """The front door on the card (``service_script``): the single-tenant
    service at e2e-1000b-50000p through ``main.build_app`` /
    ``build_server``, the pipelined loop in lockstep then threaded, driven
    over HTTP through the client; then the fleet service
    (``fleet.cluster.ids``, ``main.build_fleet``) at fleet-16x100b, a
    cluster-scoped ``POST /rebalance`` per tenant, one dispatch of the
    queued requests, every tenant's proposals read through
    ``?cluster_id=``. The launch counts are zeroed just before each and read
    just after; every row must be the JAX reference's (``SERVICE_ORACLE``;
    the stats within ``service_script.STATS_RTOL``), the fleet's tenant rows
    ``FLEET_ORACLE``'s round 1 and, bit for bit, phase 8's round 1
    (``fleet_rows``: a fresh fleet gives the same rows)."""
    from cruise_control_tpu_torch import kernels as K
    from cruise_control_tpu_torch import service_script as ss
    ns = ss.port_service_ns("cuda")
    out = {}
    for tag, fn, spec, need in (
            ("service", ss.service_e2e, ss.SERVICE_E2E, SERVICE_KERNELS),
            ("fleet_service", ss.fleet_service_e2e, ss.FLEET_SERVICE_E2E, FLEET_KERNELS)):
        walls = {}
        K.reset_launches()
        t0 = time.perf_counter()
        # the oracle's rows came through JSON: compare like with like
        row = json.loads(json.dumps(fn(ns, spec, walls)))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches, shapes = K.launches(), K.launch_shapes()
        log(f"{tag}: kernel launches {launches}")
        want = (SERVICE_ORACLE["service"] if tag == "service" else
                dict(SERVICE_ORACLE["fleet"], rows=FLEET_ORACLE["rounds"][0],
                     report=FLEET_ORACLE["reports"][0]))
        diff = ss.same_rows(row, want)
        require(not diff, f"{tag} differs from the JAX reference: {diff[:8]}")
        require(all(launches[n] > 0 for n in need),
                f"a kernel of the {tag} path never launched: {launches}")
        traces = walls.pop("round_traces", [])
        log(f"{tag}: every row the JAX reference's; {total:.6f} s in all; host walls "
            f"(s) {json.dumps(walls)}")
        for i, t in enumerate(traces):
            log(f"{tag}: round trace {i}: wall {t['wall_s']} s, overlap "
                f"{json.dumps(t['overlap'])}")
        out[tag] = dict(launches=launches, shapes=shapes, row=row, wall=total)
    frow = out["fleet_service"]["row"]
    require(frow["rows"] == FLEET_ORACLE["rounds"][0],
            "fleet service: a tenant's row differs from FLEET_ORACLE's round 1")
    require(frow["rows"] == json.loads(json.dumps(fleet_rows[0])),
            "fleet service: a fresh fleet's rows differ from phase 8's round 1")
    n = len(frow["rows"])
    require(frow["queued"] == n and frow["report"]["launches"] == 1
            and frow["report"]["optimized"] == sorted(frow["rows"]),
            f"fleet service: {frow['queued']} queued, report {frow['report']}")
    require(all(b["status"] == 200 for b in frow["bodies"].values())
            and frow["errors"] == {"no-such-tenant": 404, "../etc": 400},
            f"fleet service: statuses {frow['bodies']} {frow['errors']}")
    statuses = sorted({b["status"] for b in frow["rebalanced"].values()})
    log(f"fleet service: {n} cluster-scoped POST /rebalance answered {statuses}, the "
        f"reference's bodies, and queued {frow['queued']} rebalance-lane requests; one "
        f"dispatch ran them in {frow['report']['launches']} batched launch; the {n} "
        f"tenants' rows FLEET_ORACLE's round 1 and phase 8's round 1 bit for bit, read "
        f"through ?cluster_id=; unknown id 404, malformed 400")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the adversarial kernel-check inputs")
    ap.add_argument("--profile", nargs="*", metavar="PATH", choices=PROFILE_PATHS,
                    help="add a run of every phase-5 path (or of the named ones) "
                         "under torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "cruise_control_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the cruise_control_tpu_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    # 1. device
    phase("phase 1: device")
    card = nvidia_smi()
    log(card)
    device_kind = torch.cuda.get_device_name(0)
    log(f"device: {device_kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build
    phase("phase 2: build")
    from cruise_control_tpu_torch import kernels as K
    info = K.build_all()
    log(f"build: {info['seconds']:.3f} s for {len(info['built'])} libraries "
        f"({', '.join(info['built']) or 'already built'})")
    for name, text in info["log"].items():
        for line in text.splitlines():
            if "Compiling entry function" in line or "Used" in line:
                log(f"  {name}: {line.strip()}")

    # the slice cluster (host) and its state on the card
    from cruise_control_tpu_torch.analyzer.env import make_env
    from cruise_control_tpu_torch.analyzer.goals import make_goals
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.state import init_state
    from cruise_control_tpu_torch.model.cluster_tensor import pad_cluster
    from cruise_control_tpu_torch.model.random_cluster import (
        RandomClusterSpec, generate_scale,
    )
    t0 = time.perf_counter()
    ct, meta = generate_scale(RandomClusterSpec(**SLICE_SPEC))
    log(f"slice cluster: {meta.num_valid_replicas} replicas generated in "
        f"{time.perf_counter() - t0:.3f} s")
    opt = GoalOptimizer(device="cuda")
    pct, pmeta = pad_cluster(ct, meta)
    params = opt.scaled_params(pct.num_replicas, pct.num_brokers)
    env = make_env(pct, pmeta, device="cuda")
    st = init_state(env, pct.replica_broker, pct.replica_is_leader,
                    pct.replica_offline, pct.replica_disk)
    ctx = dict(env=env, st=st, goals=make_goals(GOALS), params=params, ct=ct, meta=meta)

    # 3. kernels against their twins
    phase("phase 3: kernels against their twins")
    entries = kernel_checks(torch, ctx, args.seed)
    phase("phase 3: the eleven-goal chain's kernels")
    chain_kernel_checks(torch, ctx, entries, args.seed)
    phase("phase 3: the sixteen goals' kernels")
    swap_kernel_checks(torch, ctx, entries, args.seed)
    phase("phase 3: the rack-distribution family and the rack-limit veto")
    rack_kernel_checks(torch, ctx, entries, args.seed)
    phase("phase 3: the JBOD path's kernels")
    jctx = jbod_context(torch)
    disk_kernel_checks(torch, jctx, entries, args.seed)
    phase("phase 3: BASELINE configs 4 and 5 on the card")
    r4 = rung_context(torch, RUNG4_SPEC, "rung 4")
    r5 = rung_context(torch, RUNG5_SPEC, "rung 5")
    phase("phase 3: K1-K7 at the 7,000-broker shapes")
    rung_kernel_checks(torch, r4, entries, "rung 4")
    rung_kernel_checks(torch, r5, entries, "rung 5", sums=False)
    phase("phase 3: K15, the forecaster's kernel")
    forecast_kernel_checks(torch, entries, args.seed)
    phase("phase 3: the fleet's lane kernels (K14)")
    lctx = lane_context(torch)
    lane_kernel_checks(torch, lctx, entries, args.seed)
    phase("phase 3: segment_sum and K1 redesigned: edges, determinism, both forms")
    redesign_checks(torch, entries, args.seed, r4, r5, lctx)
    phase("phase 3: the fleet's leadership, swap and probe lane kernels (K14)")
    branch_lane_checks(torch, lctx, entries, args.seed)
    phase("phase 3: the engine's options, the pooled K1 and K2's per-goal form")
    option_kernel_checks(torch, ctx, lctx, entries, args.seed)
    phase("phase 3: the K1 keying kernel")
    key_kernel_checks(torch, [("slice", env, st), ("jbod-1000b", jctx["env"], jctx["st"]),
                              ("rung 4", r4["env"], r4["st"]),
                              ("rung 5", r5["env"], r5["st"])], entries, args.seed)
    for en in entries.values():
        require(en.checks > 0 and en.timings or en.name in SESSION_KERNELS,
                f"{en.name} was not checked")

    # 4. small parity against the CPU run and the JAX reference's counts
    phase("phase 4: small parity")
    parity(torch, GOALS, SMALL_SPEC, "small", "small (32 brokers, 5 goals)")
    parity(torch, CHAIN, SMALL_SPEC, "chain_small", "small (32 brokers, 11 goals)")
    mid_shapes = parity(torch, CHAIN, MID_SPEC, "chain_mid", "mid (64 brokers, 11 goals)")
    require(mid_shapes["move_score_classes"].get("T=1", 0) > 0,
            "the 64-broker chain never ran the move scan (K2 at T=1)")
    parity(torch, DEFAULT, SMALL_SPEC, "default_small", "small (32 brokers, 16 goals)")
    mid16 = parity(torch, DEFAULT, MID_SPEC, "default_mid", "mid (64 brokers, 16 goals)")
    window = mid16["swap_rows"].get("window [32, 32]", 0)
    require(window == 4, f"the 64-broker sixteen goals ran {window} swap windows, "
                         f"not the four usage goals' 4")
    log(f"mid (64 brokers, 16 goals): K7 at the swap window launched {window} times")
    for spec, size, tag in ((JBOD_SMALL, "small", "jbod 32 brokers"),
                            (JBOD_MID, "mid", "jbod 64 brokers")):
        for goals, req in ((INTRA, "intra"), (JBOD_CHAIN, "chain")):
            shapes = parity(torch, goals, spec, f"jbod_{req}_{size}",
                            f"{tag}, {len(goals)} goals")
            require(all(shapes[n] for n in ("disk_rows", "disk_apply")),
                    f"{tag}: the disk branch never launched")
    parity(torch, FULL_CHAIN, fixture16, "full_small", "fixture16 (16 brokers, 18 goals)")
    rd_shapes = parity(torch, RACK_DIST, SMALL_2R_SPEC, "rack_dist_small_2r",
                       "small 2 racks (32 brokers, rack-distribution chain)")
    require(sum(rd_shapes["swap_rows"].values()) > 0,
            "the 2-rack chain never ran a swap pass (K7's rack legs at limit 2)")
    from cruise_control_tpu_torch.kernels.move_score import GOAL_RACK_DIST
    require(rd_shapes["move_score_classes families"].get(GOAL_RACK_DIST, 0) > 0,
            "the 2-rack chain never launched K2's rack-distribution family")
    ka_shapes = parity(torch, KAFKA_ASSIGNER, SMALL_SPEC, "kafka_small",
                       "small (32 brokers, kafka-assigner chain)")
    require(sum(ka_shapes["swap_rows"].values()) > 0,
            "the kafka-assigner chain never swapped")
    entry_check(torch)

    # 5. the slices: each path counted on its first run; the five- and
    # eleven-goal slices of the earlier slices run once each (the smoke's
    # time limit), the sixteen goals once too (phase 10's compact-keying
    # run holds its final state bit for bit)
    phase("phase 5: the 1,000-broker slices")
    log(f"slice: R={pct.num_replicas} B={pct.num_brokers} K={params.num_candidates} "
        f"KL={params.num_leader_candidates} T={params.num_dst_choices} "
        f"pass_waves={params.pass_waves} pass_chunk={params.pass_chunk} "
        f"compute_dtype={params.compute_dtype}")
    five = run_slice(torch, opt, ct, meta, GOALS, "slice (5 goals)", ORACLE["slice"],
                     twice=False)
    require(all(five["launches"][n] > 0 for n in FIVE_GOAL_KERNELS),
            f"a kernel of the five-goal path never launched: {five['launches']}")
    chain = run_slice(torch, opt, ct, meta, CHAIN, "slice (11 goals)",
                      ORACLE["chain_slice"], twice=False)
    launches = chain["launches"]
    require(all(n > 0 for name, n in launches.items()
                if not name.startswith("swap_")
                and name not in JBOD_KERNELS + SESSION_KERNELS + HEAL_KERNELS
                + FLEET_KERNELS + OPTION_KERNELS),
            f"a kernel of the eleven-goal path never launched: {launches}")
    Kf = min(params.finisher_candidates, pct.num_replicas)
    W = max(1, min(params.finisher_waves, pct.num_replicas // max(Kf, 1)))
    S = max(2, min(params.max_finisher_segments, pct.num_brokers))
    want = {"select_candidates": f"k={Kf * W}", "move_score_classes": "ordered",
            "wave_admission": f"N={Kf * S}", "leadership_rows": f"segments S={S}"}
    shapes = chain["shapes"]
    for name, shape in want.items():
        require(shapes[name].get(shape, 0) > 0,
                f"the eleven-goal path never launched {name} at {shape}: "
                f"{shapes[name]}")
    log(f"slice (11 goals): the finisher's launch shapes all ran: {want}; its "
        f"move scan finds no eligible row (LeaderReplicaDistributionGoal's "
        f"finisher proves 0 moves left, as in the reference), so K2 at T=1 "
        f"launched {shapes['move_score_classes'].get('T=1', 0)} times here and "
        f"{mid_shapes['move_score_classes'].get('T=1', 0)} times in the 64-broker "
        f"run")
    default = run_slice(torch, opt, ct, meta, DEFAULT, "slice (16 goals)",
                        ORACLE["default_slice"], twice=False)
    launches, shapes = default["launches"], default["shapes"]
    require(all(n > 0 for name, n in launches.items()
                if name not in JBOD_KERNELS + SESSION_KERNELS + HEAL_KERNELS
                + FLEET_KERNELS + OPTION_KERNELS),
            f"a kernel of the sixteen-goal path never launched: {launches}")
    k = min(params.num_swap_candidates, pct.num_replicas, 128)
    for name, shape in (("swap_rows", f"pass [{k}, {k}]"), ("swap_admission", f"K1={k}")):
        require(shapes[name].get(shape, 0) > 0,
                f"the sixteen-goal path never launched {name} at {shape}: "
                f"{shapes[name]}")
    full = run_slice(torch, opt, ct, meta, FULL_CHAIN, "slice (18 goals)",
                     ORACLE["full_slice"], twice=False)
    launches = full["launches"]
    require(all(n > 0 for name, n in launches.items()
                if name not in ("disk_rows", "disk_apply") + SESSION_KERNELS
                + HEAL_KERNELS + FLEET_KERNELS + OPTION_KERNELS),
            f"a kernel of the 18-goal path never launched: {launches}")
    require(launches["preferred_leader"] == 2,
            "the 18-goal chain's preferred-leader pass is one apply and one check")
    kafka = run_slice(torch, opt, ct, meta, KAFKA_ASSIGNER, "slice (kafka-assigner)",
                      ORACLE["kafka_slice"])
    launches = kafka["launches"]
    ka_kernels = ("select_candidates", "move_score_classes", "wave_admission",
                  "segment_sum", "segment_count", "swap_rows", "swap_admission")
    require(all(launches[n] > 0 for n in ka_kernels),
            f"a kernel of the kafka-assigner path never launched: {launches}")
    jbod = {}
    for req, goals, cl in (("intra", INTRA, jctx["ct"]), ("chain", JBOD_CHAIN, jctx["ct"]),
                           ("demote", PLE, jctx["ct_demoted"])):
        jbod[req] = run_slice(torch, opt, cl, jctx["meta"], goals,
                              f"jbod ({req}, {len(goals)} goals)", ORACLE[f"jbod_{req}"])
        log(f"jbod ({req}): launches of the JBOD kernels in run 1 "
            f"{ {n: jbod[req]['launches'][n] for n in JBOD_KERNELS} }")
    steady = run_slice(torch, opt, jctx["ct"], jctx["meta"], PLE,
                       "jbod (preferred leader, nothing demoted)", ORACLE["jbod_ple"],
                       twice=False)
    jbod_launches = {n: sum(jbod[r]["launches"][n] for r in jbod) for n in K.KERNELS}
    require(all(jbod_launches[n] > 0 for n in JBOD_KERNELS),
            f"a kernel of the JBOD path never launched: {jbod_launches}")
    require(jbod["demote"]["launches"]["preferred_leader"] == 2
            and steady["launches"]["preferred_leader"] == 2,
            "the preferred-leader pass is one apply and one check launch")
    for req in ("intra", "chain"):
        require(all(jbod[req]["launches"][n] > 0 for n in ("disk_rows", "disk_apply")),
                f"jbod ({req}): the disk branch never launched")
    # 5e. BASELINE configs 4 and 5 at full size through GoalOptimizer()'s
    # defaults ("auto" resolves to bf16), and rung 4 pinned to f32
    phase("phase 5e: BASELINE configs 4 and 5 (7,000 brokers)")
    from cruise_control_tpu_torch.analyzer.engine import EngineParams
    for ctx_r, tag in ((r4, "rung 4"), (r5, "rung 5")):
        require(ctx_r["params"].compute_dtype == "bfloat16",
                f"{tag}: auto resolved to {ctx_r['params'].compute_dtype}, not bfloat16")
    log("rung 4 / rung 5: GoalOptimizer() resolves compute_dtype to bfloat16")
    rung4 = run_slice(torch, opt, r4["ct"], r4["meta"], DEFAULT,
                      "rung 4 (16 goals, bf16)", ORACLE["rung4_bf16"], twice=False)
    rung5 = run_slice(torch, opt, r5["ct"], r5["meta"], JBOD_CHAIN,
                      "rung 5 (10 goals, bf16)", ORACLE["rung5_bf16"])
    opt32 = GoalOptimizer(device="cuda", engine_params=EngineParams(compute_dtype="float32"))
    rung4_f32 = run_slice(torch, opt32, r4["ct"], r4["meta"], DEFAULT,
                          "rung 4 (16 goals, pinned f32)", ORACLE["rung4_f32"],
                          twice=False)
    rung5_kernels = ("select_candidates", "move_score_classes", "wave_admission",
                     "segment_sum", "segment_count", "leadership_rows", "disk_rows",
                     "disk_apply", "replica_keys")
    for run, ctx_r, tag, need in (
            (rung4, r4, "rung 4 bf16", [n for n in K.KERNELS
                                        if n not in JBOD_KERNELS + SESSION_KERNELS
                                        + HEAL_KERNELS + FLEET_KERNELS + OPTION_KERNELS]),
            (rung5, r5, "rung 5 bf16", rung5_kernels)):
        R = ctx_r["env"].num_replicas
        require(run["shapes"]["replica_keys"].get(f"R={R} bf16", 0) > 0,
                f"{tag}: the keying kernel never ran on bf16 tables")
        require(all(run["launches"][n] > 0 for n in need),
                f"{tag}: a kernel of the path never launched: {run['launches']}")
    log(f"phase 5e: walls (s) rung 4 bf16 {rung4['walls']}, rung 5 bf16 "
        f"{rung5['walls']}, rung 4 f32 {rung4_f32['walls'][0]}")
    # 6. the resident-session service rounds (e2e-1000b-50000p)
    phase("phase 6: resident-session rounds (e2e-1000b-50000p)")
    profile_session = args.profile is not None and (not args.profile
                                                    or "session" in args.profile)
    session = session_phase(torch, entries, profile_session, args.seed)
    # 7. the self-healing service (e2e-1000b-50000p)
    phase("phase 7: self-healing service (e2e-1000b-50000p)")
    heal = heal_phase(torch, args.profile is not None
                      and (not args.profile or "heal" in args.profile))
    # 8. fleet mode (fleet-16x100b)
    phase("phase 8: fleet mode (fleet-16x100b)")
    fleet = fleet_phase(torch, lctx, entries, args.seed)
    # 9. the front door (e2e-1000b-50000p, fleet-16x100b)
    phase("phase 9: the front door (e2e-1000b-50000p, fleet-16x100b)")
    service = service_phase(torch, fleet["rows"])
    # 10. the engine's options at full width and the non-budget fallbacks
    phase("phase 10: the engine's options (slice-1000b) and the non-budget fallbacks")
    options = options_phase(torch, ctx, default, entries)
    for en in entries.values():
        require(en.checks > 0 and en.timings, f"{en.name} was not checked")
    if args.profile is not None:
        phase("profile")
        runs = dict(zip(PROFILE_PATHS, (five, chain, default, full, kafka,
                                        *jbod.values(), steady, rung4, rung5)))
        for name in args.profile or PROFILE_PATHS:
            if name not in ("session", "heal"):
                profile_run(torch, opt, *runs[name]["run"])
    for name, e in entries.items():
        for t in e.timings:
            log(f"timing {name} at {t['at']}: {json.dumps(t)}")

    paths = {"default": default, "full18": full, "kafka": kafka,
             **{f"jbod_{r}": v for r, v in jbod.items()}, "rung4": rung4, "rung5": rung5,
             "session": session, "heal": heal, "fleet": fleet,
             "service": service["service"], "fleet_service": service["fleet_service"],
             "options": options, "options_fleet": fleet["options"]}
    kernels = []
    for name, k in K.KERNELS.items():
        by_path = {p: v["launches"][name] for p, v in paths.items()}
        # the timed shapes of the earlier kernels are those of the earlier
        # paths; the session kernels' those of the session path, K15's those
        # of the heal path, the lane kernels' those of the fleet path
        ran = {}
        for p, v in paths.items():
            # the front door's paths time nothing: they rerun the earlier ones
            if (p in ("service", "fleet_service") or KERNEL_PATH.get(name)
                    != (p if p in ("session", "heal", "fleet", "options", "options_fleet")
                        else None)):
                continue
            for shape, c in v["shapes"][name].items():
                ran[shape] = ran.get(shape, 0) + c
        kernels.append(kernel_entry(name, k, entries[name], sum(by_path.values()),
                                    ran, by_path))
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
