"""The priority lanes the fleet's admission engine shares with the
pipelined service loop (counterpart of ``cruise_control_tpu/pipeline.py``
:62-68). Lower values drain first: heals (detector FIX/PREDICTED verdicts)
preempt user-initiated hygiene rebalances, which preempt background refresh.

The pipelined service loop itself is not ported yet (ROADMAP.md Queue 1
item 12): setting ``CruiseControl.service_pipeline`` raises, so the fleet
installs each result inline.
"""
LANE_HEAL = 0
LANE_REBALANCE = 1
LANE_REFRESH = 2
LANE_NAMES = ("heal", "rebalance", "refresh")
