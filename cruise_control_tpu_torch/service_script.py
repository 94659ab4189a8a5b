"""The service's front door as a script: a single-tenant service and a fleet
service started through the entry point's builders (``main.build_app``,
``build_server``, ``build_fleet``) and driven over HTTP through the client,
for the classes of either package.

``service_e2e(ns, spec)`` starts the service over the session cell's
simulated cluster (``analyzer.session_script.session_backend``) and drives
the pipelined loop in lockstep: one ingest-and-sync step a window, then
``pipelined_round`` (R1, a full round, with the next window's ingest and
sync overlapped under it: the round trace's overlap fractions). The REST
server then serves ``POST /rebalance?dryrun=true`` (the 202 /
``User-Task-ID`` protocol; a full round: the overlapped sync left no load
baseline, so no memo), one more ingest-and-sync step runs, the loop goes
threaded, and the server serves ``GET /proposals`` twice (the certificate
memo after that sync, then the cache), ``/load``,
``/kafka_cluster_state``, ``/partition_load`` and
``/state?substates=PIPELINE,ROUND_TRACES``. The
threaded loop's sampling interval is an hour, so nothing moves under the
requests and both packages answer alike. ``fleet_service_e2e(ns, spec)`` starts the fleet service
(``fleet.cluster.ids``) over the fleet cell's tenants
(``fleet_script.seed_tenant``) and drives one fleet round through
cluster-scoped requests: ``POST /rebalance?cluster_id=<id>&dryrun=true``
for every tenant (each answers with the tenant's own round, or with the
hard-goal failure's 500 where the tenant is under-provisioned, and queues
a rebalance-lane request on the fleet), then one ``dispatch_once``, the
dispatch an enqueued request wakes the precompute thread for: ONE batched
launch over the queued tenants, installed into their caches. Every
tenant's proposals are then read through ``?cluster_id=``.

Every row holds plain values, so the two packages' rows compare with
``==`` (``same_rows``): the JSON bodies enter as sha256 digests of their
canonical form after ``scrub`` drops the fields that carry wall-clock
times, task ids or timestamps and an error's stack trace (``SCRUBBED``).
An optimization body's ``clusterModelStats`` and its data-to-move totals
leave its digest; the last goal's stats (the final state's) travel beside
it as ``stats`` and the totals as ``sums``. Both are f32 sums (the stats' means over the brokers,
the totals over the moved replicas) in torch's reduction order, which is
not XLA's and on the card not the CPU's, so they may differ in the last
place (a megabyte at ten million); ``same_rows`` holds them to a relative
``STATS_RTOL``. ``chip_smoke.py`` phase 9 runs both on the card
against the reference's rows (``python tests/torch_reference.py
service-e2e``).
"""
from __future__ import annotations

import hashlib
import json

from cruise_control_tpu_torch.analyzer.session_script import (
    SESSION_E2E, SESSION_SMALL, round_row, session_backend,
)
from cruise_control_tpu_torch.fleet_script import (
    FLEET_E2E, FLEET_GOALS, FLEET_SMALL, T0, WINDOW_MS, e2e_row, seed_tenant,
)

SERVICE_E2E = dict(SESSION_E2E, flips=0)
SERVICE_SMALL = dict(SESSION_SMALL, flips=0)
FLEET_SERVICE_E2E = FLEET_E2E
FLEET_SERVICE_SMALL = FLEET_SMALL
# the tier-1 cut: the small clusters on fleet_script's five-goal chain
SERVICE_TEST = dict(SERVICE_SMALL, goals=FLEET_GOALS)
FLEET_SERVICE_TEST = dict(FLEET_SMALL, goals=FLEET_GOALS)
# the properties both services share: an ephemeral port, requests that
# block until their task ends, no detection round and a threaded sampling
# interval of an hour (the lockstep steps sample)
SERVICE_PROPS = {"webserver.http.port": 0,
                 "webserver.request.maxBlockTimeMs": 3_600_000,
                 "anomaly.detection.interval.ms": 10_000_000,
                 "metric.sampling.interval.ms": 3_600_000}
# JSON fields that carry wall-clock times, task ids or timestamps, and an
# error body's stack trace (each package's own file paths)
SCRUBBED = frozenset({"stackTrace",
    "nowMs", "ts_ms", "tsMs", "wall_s", "wallS", "sampling_s", "sync_s", "syncS",
    "revalidate_s", "revalidateS", "durationS", "duration_s", "durationMs",
    "startMs", "submittedMs", "staleAgeMs", "computedMs", "ageMs",
    "round_id", "trace_id", "traceId", "UserTaskId", "userTaskId",
    "stages", "overlap", "lastUpdateMs"})


STATS = "clusterModelStats"
SUMS = ("dataToMoveMB", "intraBrokerDataToMoveMB")
# relative tolerance of the stats' floats: a few f32 ulps plus the
# renderer's rounding to four decimals
STATS_RTOL = 1e-6


def scrub(body, drop=SCRUBBED):
    """``body`` without the fields named in ``drop``, at every depth."""
    if isinstance(body, dict):
        return {k: scrub(v, drop) for k, v in body.items() if k not in drop}
    if isinstance(body, list):
        return [scrub(v, drop) for v in body]
    return body


def body_digest(body, drop=SCRUBBED) -> str:
    """The first 16 hex digits of the sha256 of a body's canonical JSON
    after ``scrub``."""
    text = json.dumps(scrub(body, drop), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def optimization_row(body: dict, stats: bool = True) -> dict:
    """An optimization body's counts, its digest without the stats and
    (``stats``) the final state's stats."""
    res = body.get("result") or body.get("summary") or body
    summ = res.get("summary", {})
    row = dict(summary={k: summ.get(k) for k in (
                   "numReplicaMovements", "numLeaderMovements",
                   "numIntraBrokerReplicaMovements", "violatedGoalsBefore",
                   "violatedGoalsAfter")},
               sums={k: summ.get(k) for k in SUMS},
               stale=body.get("stale"),
               digest=body_digest(body, SCRUBBED | {STATS, *SUMS}))
    goals = res.get("goalSummary", [])
    if stats and goals:
        row["stats"] = goals[-1].get(STATS)
    return row


def _close(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return abs(a - b) <= STATS_RTOL * max(abs(a), abs(b))
    return a == b


def same_rows(got, want, path: str = "") -> list:
    """The paths where ``got`` differs from ``want`` (the stats and sums
    within ``STATS_RTOL``, everything else exactly); [] when they agree."""
    if isinstance(got, dict) and isinstance(want, dict):
        if got.keys() != want.keys():
            return [f"{path}: keys {sorted(got)} != {sorted(want)}"]
        out = []
        for k in want:
            if k in ("stats", "sums"):
                if not _close(got[k], want[k]):
                    out.append(f"{path}/{k}: {got[k]!r} != {want[k]!r}")
            else:
                out += same_rows(got[k], want[k], f"{path}/{k}")
        return out
    if isinstance(got, list) and isinstance(want, list) and len(got) == len(want):
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in same_rows(g, w, f"{path}[{i}]")]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def _props(spec: dict, **over) -> dict:
    """The service's properties: ``SERVICE_PROPS``, the spec's monitor
    config and, with ``spec["goals"]``, that chain as the service's goals
    (ReplicaCapacityGoal hard, as ``fleet_script``'s tier-1 chain)."""
    props = dict(SERVICE_PROPS)
    props.update(spec.get("config", {}))
    if spec.get("goals"):
        props.update({"goals": ",".join(spec["goals"]),
                      "default.goals": ",".join(spec["goals"]),
                      "hard.goals": "ReplicaCapacityGoal"})
    props.update(over)
    return props


def _client(ns, server):
    return ns["CruiseControlClient"](f"127.0.0.1:{server.port}", timeout_s=3600.0,
                                     poll_interval_s=0.05)


def scoped_request(server, endpoint: str, cluster_id: str, method: str = "GET",
                   **params) -> tuple:
    """(status, body) of ``<method> /<endpoint>?cluster_id=<id>&<params>``,
    a 202 followed with its ``User-Task-ID`` to the final answer (the
    client's parameter specs hold no routing selector, so cluster-scoped
    requests go out as plain ones)."""
    import time
    import urllib.error
    import urllib.parse
    import urllib.request
    url = (f"http://127.0.0.1:{server.port}/kafkacruisecontrol/{endpoint}?"
           + urllib.parse.urlencode({"cluster_id": cluster_id, **params}))
    task = None
    while True:
        headers = {"User-Task-ID": task} if task else {}
        req = urllib.request.Request(url, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=3600.0) as resp:
                status, body = resp.status, json.loads(resp.read().decode())
                task = resp.headers.get("User-Task-ID")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode() or "{}")
        if status != 202:
            return status, body
        time.sleep(0.05)


def scoped_get(server, endpoint: str, cluster_id: str) -> tuple:
    """(status, body) of ``GET /<endpoint>?cluster_id=<id>``."""
    return scoped_request(server, endpoint, cluster_id)


def service_e2e(ns: dict, spec: dict, timings: dict | None = None) -> dict:
    """The single-tenant service over ``spec``'s cluster (see the module
    doc). Returns its rows; ``timings`` (a dict) receives the host walls of
    the lockstep steps and of each request."""
    import time
    main = ns["main"]
    kw = ns.get("kw", {})
    config = ns["cruise_control_config"](_props(spec))
    be = session_backend(ns, spec)
    cc = main.build_app(config, backend=be, **kw)
    cc.start_up(proposal_precompute=False)
    pipe = ns["PipelinedServiceLoop"](cc, config)
    cc.service_pipeline = pipe
    walls = timings if timings is not None else {}
    steps = []

    def step(t):
        t0 = time.perf_counter()
        out = pipe.step(now_ms=t * WINDOW_MS, optimize=False)
        walls.setdefault("steps", []).append(time.perf_counter() - t0)
        sync = out["sync"]
        steps.append(dict(ingested=out["ingested"], sync=sync.get("mode"),
                          skipped="skipped" in sync))

    for t in range(spec["windows"]):
        step(t)
    rnd = pipe.pipelined_round(now_ms=spec["windows"] * WINDOW_MS)
    walls["pipelined_round"] = rnd["wall_s"]
    walls["pipelined_round_overlap"] = rnd["trace"].overlap
    # the round's own overlapped spans: the next window's ingest and sync
    # (the summary above also counts the lockstep steps' spans before it)
    walls["pipelined_round_spans"] = rnd["trace"].stages[-2:]
    # a sync that ran while R1 held the lent state took the shadow slot
    sess = cc.resident_session
    walls["shadow_syncs"] = sess.shadow_syncs if sess is not None else None
    row = dict(round=round_row({"mode": "pipelined"}, rnd["result"]),
               sync=dict(mode=rnd["sync_info"].get("mode"),
                         ingested=rnd["sync_info"].get("ingested")))
    server = main.build_server(cc, config)
    server.start()
    try:
        client = _client(ns, server)

        def call(name, fn):
            t0 = time.perf_counter()
            body = fn()
            walls[name] = time.perf_counter() - t0
            return body

        reb = call("rebalance", lambda: client.rebalance(dryrun=True))
        step(spec["windows"] + 1)
        pipe.start()
        p1 = call("proposals", client.proposals)
        p2 = call("proposals_again", client.proposals)
        load = call("load", client.load)
        kcs = call("kafka_cluster_state", client.kafka_cluster_state)
        pl = call("partition_load", client.partition_load)
        state = call("state", lambda: client.state(substates="PIPELINE,ROUND_TRACES"))
    finally:
        server.stop()
        pipe.stop()
        cc.shutdown()
    row["steps"] = steps
    pstate = state["PipelineState"]
    traces = state["RoundTraces"]
    row.update(
        rebalance=optimization_row(reb),
        proposals=[optimization_row(p) for p in (p1, p2)],
        load=dict(brokers=len(load["brokers"]), digest=body_digest(load)),
        kafka_cluster_state=dict(
            summary=kcs["KafkaBrokerState"]["Summary"], digest=body_digest(kcs)),
        partition_load=dict(records=len(pl["records"]), digest=body_digest(pl)),
        pipeline={k: pstate[k] for k in ("mode", "stalled", "stallCount", "releaseCount",
                                         "ingestRounds", "syncRounds", "optimizeRounds",
                                         "staleRoundsDropped", "syncedGeneration",
                                         "optimizedGeneration")},
        round_traces=[dict(mode=t.get("round_mode"), proposals=t.get("num_proposals"),
                           moves=t.get("num_replica_movements"))
                      for t in traces.get("traces", [])])
    walls["round_traces"] = [dict(wall_s=t.get("wall_s"), overlap=t.get("overlap"),
                                  stages=t.get("stages"))
                             for t in traces.get("traces", [])]
    return row


def fleet_service_e2e(ns: dict, spec: dict, timings: dict | None = None) -> dict:
    """The fleet service over ``spec``'s tenants (see the module doc):
    ``fleet.cluster.ids`` names them, ``main.build_fleet`` mounts one
    facade per tenant behind the server, each tenant's backend is seeded
    and its windows sampled; a cluster-scoped ``POST /rebalance`` per
    tenant queues the round, one dispatch runs it as one batched launch,
    and each tenant's proposals are read through ``?cluster_id=``. Returns
    the tenants' rows after the dispatch (``fleet_script.e2e_row``), the
    rebalance and proposal bodies' counts and the declared errors of an
    unknown and a malformed id."""
    import time
    main = ns["main"]
    kw = ns.get("kw", {})
    ids = [f"tenant-{k}" for k in range(spec["tenants"])]
    props = _props(dict(goals=spec.get("goals")), **{"fleet.cluster.ids": ",".join(ids)})
    base, overlays = main.split_fleet_overlays(props)
    config = ns["cruise_control_config"](base)
    cc = main.build_app(config, backend=ns["SimulatedClusterBackend"](), **kw)
    fleet = main.build_fleet(cc, config, base, overlays, **kw)
    walls = timings if timings is not None else {}
    for k, cid in enumerate(ids):
        t = fleet.tenants[cid]
        seed_tenant(t.cc.backend, spec["seed0"] + k, num_brokers=spec["brokers"],
                    num_partitions=spec["partitions"], rf=spec["rf"],
                    racks=spec["racks"], topics=spec["topics"])
        for w in range(spec["windows"]):
            t.cc.load_monitor.sample_once(now_ms=w * WINDOW_MS)
    server = main.build_server(cc, config, fleet=fleet)
    server.start()
    try:
        rebalanced = {}
        t0 = time.perf_counter()
        for cid in ids:
            # at fleet-16x100b every tenant is under-provisioned: its own
            # round ends with CpuCapacityGoal violated and answers 500 with
            # the provision recommendation; the request is queued either way
            status, body = scoped_request(server, "rebalance", cid, "POST",
                                          dryrun="true", reason="fleet round")
            rebalanced[cid] = dict(optimization_row(body, stats=False), status=status)
        walls["rebalances"] = time.perf_counter() - t0
        queued = fleet.admission_state_json()["lanes"]["rebalance"]["depth"]
        t0 = time.perf_counter()
        rep = fleet.dispatch_once(now_ms=T0)
        walls["round"] = time.perf_counter() - t0
        rows, bodies = {}, {}
        t0 = time.perf_counter()
        for cid in ids:
            status, body = scoped_get(server, "proposals", cid)
            bodies[cid] = dict(optimization_row(body, stats=False), status=status)
            rows[cid] = e2e_row(fleet.app_for(cid).cached_proposals())
        walls["proposals"] = time.perf_counter() - t0
        errors = {bad: scoped_get(server, "state", bad)[0]
                  for bad in ("no-such-tenant", "../etc")}
    finally:
        server.stop()
        fleet.shutdown()
        cc.shutdown()
    return dict(report=dict(launches=rep["launches"], optimized=sorted(rep["optimized"]),
                            failed=rep["failed"]),
                rows=rows, rebalanced=rebalanced, queued=queued, bodies=bodies,
                errors=errors)


def port_service_ns(device="cuda") -> dict:
    """The port's classes for these scripts, its builders on ``device``."""
    from cruise_control_tpu_torch import main
    from cruise_control_tpu_torch.backend.simulated import SimulatedClusterBackend
    from cruise_control_tpu_torch.client.client import CruiseControlClient
    from cruise_control_tpu_torch.config import cruise_control_config
    from cruise_control_tpu_torch.pipeline import PipelinedServiceLoop
    return dict(main=main, cruise_control_config=cruise_control_config,
                PipelinedServiceLoop=PipelinedServiceLoop,
                CruiseControlClient=CruiseControlClient,
                SimulatedClusterBackend=SimulatedClusterBackend, kw=dict(device=device))
