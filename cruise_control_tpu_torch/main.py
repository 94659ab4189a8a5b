"""Process bootstrap: properties file -> full Cruise Control service (counterpart of
``cruise_control_tpu/main.py``).

Reference: KafkaCruiseControlMain.java:26-41 (takes a cruisecontrol.properties
path, builds the config, boots KafkaCruiseControlApp) and
KafkaCruiseControlApp.java:36-121 (constructs the facade, mounts the servlet,
starts monitor + detection + web server). Run as::

    python -m cruise_control_tpu_torch config/cruisecontrol.properties \
        [--cluster-spec cluster.json] [--device cuda|cpu]

The backend comes from ``executor.backend.class`` (simulated by default);
``--cluster-spec`` seeds it from a JSON file of brokers + partitions so a
standalone process has something to balance. ``--device`` (default
``cuda``) is the device of every facade the process builds: ``cpu`` runs
the kernels' plain twins, and ``cuda`` without a card raises. The RPC
backend (``backend/rpc.py``) is not ported yet: naming it as
``executor.backend.class`` raises ``NotImplementedError`` (ROADMAP Queue 1
item 12, the rest).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import time

LOG = logging.getLogger("cruise_control_tpu_torch.main")


def resolve_env_refs(value: str) -> str:
    """Env-var indirection in property values (config/EnvConfigProvider.java
    role): ``${env:VAR}`` -> os.environ["VAR"]; unset vars are a loud
    ConfigException-shaped error rather than a silent empty string."""
    import os
    import re

    def sub(m):
        var = m.group(1)
        if var not in os.environ:
            raise ValueError(
                f"property references ${{env:{var}}} but {var} is not set")
        return os.environ[var]

    return re.sub(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}", sub, value)


def load_properties(path: str) -> dict:
    """Parse a Kafka-style ``key=value`` properties file (comments with #),
    resolving ``${env:VAR}`` references in values."""
    props: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            props[key.strip()] = resolve_env_refs(value.strip())
    return props


def seed_backend_from_spec(backend, spec: dict) -> None:
    """Seed a simulated backend from {"brokers": [...], "partitions": [...]}."""
    for b in spec.get("brokers", []):
        backend.add_broker(int(b["id"]), b.get("rack", "r0"),
                           logdirs=b.get("logdirs"))
    for p in spec.get("partitions", []):
        backend.create_partition(
            p["topic"], int(p["partition"]), [int(x) for x in p["replicas"]],
            size_mb=float(p.get("sizeMb", 0.0)),
            bytes_in_rate=float(p.get("bytesInRate", 0.0)),
            bytes_out_rate=float(p.get("bytesOutRate", 0.0)),
            cpu_util=float(p.get("cpuUtil", 0.0)))


def split_fleet_overlays(props: dict) -> tuple:
    """Pop ``fleet.tenant.<id>.<key>`` overlay properties out of the raw
    props (the config schema rejects unknown keys, and these are per-tenant,
    not service-wide) and group them by cluster id. Ids may contain dots, so
    the split resolves against the declared ``fleet.cluster.ids`` — longest
    declared id wins. Returns (base_props, {cluster_id: {key: value}})."""
    prefix = "fleet.tenant."
    base = {k: v for k, v in props.items() if not k.startswith(prefix)}
    raw_ids = props.get("fleet.cluster.ids", "")
    if isinstance(raw_ids, str):
        raw_ids = raw_ids.split(",")
    ids = [str(s).strip() for s in raw_ids if str(s).strip()]
    overlays: dict = {cid: {} for cid in ids}
    for k, v in props.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        cid = next((c for c in sorted(ids, key=len, reverse=True)
                    if rest.startswith(c + ".")), None)
        if cid is None:
            raise ValueError(
                f"fleet.tenant property {k!r} matches no declared "
                f"fleet.cluster.ids entry (declared: {ids or 'none'})")
        overlays[cid][rest[len(cid) + 1:]] = v
    return base, overlays


def build_fleet(cc, config, base_props: dict, overlays: dict, device="cuda"):
    """``fleet.cluster.ids`` -> a started FleetScheduler behind the server:
    one tenant facade per declared cluster, each over its own configured
    backend, with the service's base properties plus that tenant's
    ``fleet.tenant.<id>.*`` overlay. Returns None when no ids are declared
    (single-tenant service, no fleet surface mounted)."""
    ids = [str(s).strip() for s in config.get_list("fleet.cluster.ids")
           if str(s).strip()]
    if not ids:
        return None
    from cruise_control_tpu_torch.config import cruise_control_config
    from cruise_control_tpu_torch.fleet import FleetScheduler
    fleet = FleetScheduler(config=config, sensors=cc.sensors, device=device)
    for cid in ids:
        tprops = dict(base_props)
        tprops.pop("fleet.cluster.ids", None)
        # batched fleet rounds install into resident sessions; a tenant
        # overlay may tune anything else but not opt out of the session
        tprops["analyzer.resident.session.enabled"] = True
        tprops.update(overlays.get(cid, {}))
        tconfig = cruise_control_config(tprops)
        backend = tconfig.get_configured_instance("executor.backend.class")
        tenant = fleet.add_tenant(cid, backend=backend, config=tconfig)
        # bare start_up: monitor replay only — the scheduler's rounds are
        # the tenants' precompute, they must not spawn their own threads
        tenant.cc.start_up()
    return fleet


RPC_BACKEND = "backend.rpc."


def build_app(config, backend=None, device="cuda"):
    """Construct backend + facade (KafkaCruiseControl wiring order). The
    RPC backend and its client provider (``backend/rpc.py``) are not ported
    yet: naming them raises ``NotImplementedError`` before any class is
    resolved."""
    from cruise_control_tpu_torch.app import CruiseControl
    if backend is None:
        spec = config.get("executor.backend.class")
        name = spec if isinstance(spec, str) else getattr(spec, "__module__", "")
        if RPC_BACKEND in str(name):
            raise NotImplementedError(
                "the RPC backend (backend/rpc.py) is not ported yet "
                "(ROADMAP.md Queue 1 item 12, the rest)")
        backend = config.get_configured_instance("executor.backend.class")
    return CruiseControl(backend, config, device=device)


def build_server(cc, config, fleet=None):
    """Mount the REST layer per the webserver.* config surface
    (KafkaCruiseControlApp.java:45-61 Jetty bootstrap role)."""
    from cruise_control_tpu_torch.api import CruiseControlServer
    from cruise_control_tpu_torch.api.security import (
        BasicSecurityProvider, JwtSecurityProvider, NoopSecurityProvider,
        TrustedProxySecurityProvider,
    )
    security = NoopSecurityProvider()
    if config.get_boolean("webserver.security.enable"):
        scheme = config.get_string("webserver.security.provider").upper()
        if scheme == "SPNEGO":
            from cruise_control_tpu_torch.api.security import (
                SpnegoSecurityProvider, hmac_token_validator,
            )
            secret_file = config.get_string("spnego.principal.secret.file")
            if not secret_file:
                raise ValueError("SPNEGO security requires "
                                 "spnego.principal.secret.file "
                                 "(spnego.keytab.file)")
            with open(secret_file, "rb") as f:
                validator = hmac_token_validator(f.read().strip())
            roles = {}
            roles_file = config.get_string("spnego.principal.roles.file")
            if roles_file:
                roles = BasicSecurityProvider.from_file(roles_file).user_roles()
            security = SpnegoSecurityProvider(
                validator, roles=roles,
                service_principal=config.get_string("spnego.principal"))
        elif scheme == "JWT":
            secret_file = config.get_string("jwt.secret.file")
            cert_file = config.get_string("jwt.auth.certificate.location")
            secret = None
            if secret_file:
                with open(secret_file, "rb") as f:
                    secret = f.read().strip()
            rs256_key = None
            if cert_file:
                from cruise_control_tpu_torch.api.security import (
                    rsa_public_key_from_pem,
                )
                with open(cert_file) as f:
                    rs256_key = rsa_public_key_from_pem(f.read())
            security = JwtSecurityProvider(
                secret, rs256_key=rs256_key,
                principal_claim=config.get_string("jwt.principal.claim"),
                cookie_name=config.get_string("jwt.cookie.name"),
                expected_audiences=config.get("jwt.expected.audiences"),
                provider_url=config.get_string(
                    "jwt.authentication.provider.url"))
        else:
            cred_file = config.get_string("webserver.auth.credentials.file")
            if not cred_file:
                raise ValueError("webserver.security.enable requires "
                                 "webserver.auth.credentials.file")
            security = BasicSecurityProvider.from_file(cred_file)
            if scheme == "TRUSTED_PROXY":
                # the realm file doubles as the doAs-principal role map
                security = TrustedProxySecurityProvider(
                    security,
                    trusted_services=config.get_list("trusted.proxy.services"),
                    user_roles=security.user_roles(),
                    fallback_to_delegate=config.get_boolean(
                        "trusted.proxy.fallback.enabled"),
                    ip_regex=config.get_string(
                        "trusted.proxy.services.ip.regex"))
    ssl_ctx = build_ssl_context(config)
    return CruiseControlServer(
        cc,
        host=config.get_string("webserver.http.address"),
        port=config.get_int("webserver.http.port"),
        ssl_context=ssl_ctx,
        security_provider=security,
        two_step_verification=config.get_boolean("two.step.verification.enabled"),
        max_block_ms=float(config.get_int("webserver.request.maxBlockTimeMs")),
        max_active_user_tasks=config.get_int("max.active.user.tasks"),
        completed_user_task_retention_ms=float(
            config.get_int("completed.user.task.retention.time.ms")),
        config=config, fleet=fleet)


def build_ssl_context(config):
    """webserver.ssl.* -> ssl.SSLContext (PEM stack; keystore spellings are
    aliases). Protocol floors/allowlists and cipher include/exclude lists
    mirror Jetty's SslContextFactory knobs on the stdlib API."""
    if not config.get_boolean("webserver.ssl.enable"):
        return None
    import ssl

    cert = config.get_string("webserver.ssl.cert.location")
    if not cert:
        raise ValueError("webserver.ssl.enable requires "
                         "webserver.ssl.cert.location "
                         "(webserver.ssl.keystore.location)")
    key = config.get_string("webserver.ssl.key.location") or None
    password = config.get_string("webserver.ssl.key.password") or None
    # read the full webserver.ssl.* family BEFORE touching the filesystem:
    # a bad protocol/cipher config should fail fast, not after cert IO
    proto = config.get_string("webserver.ssl.protocol")
    include = set(config.get("webserver.ssl.include.protocols") or [])
    exclude = set(config.get("webserver.ssl.exclude.protocols") or [])
    ciphers = config.get("webserver.ssl.include.ciphers")
    exclude_ciphers = set(config.get("webserver.ssl.exclude.ciphers") or [])
    ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ssl_ctx.load_cert_chain(cert, keyfile=key, password=password)
    allowed = include or {"TLSv1.2", "TLSv1.3"}
    allowed -= exclude
    if proto == "TLSv1.3":
        allowed &= {"TLSv1.3"}
    elif proto == "TLSv1.2":
        allowed &= {"TLSv1.2", "TLSv1.3"}
    if not allowed:
        raise ValueError("webserver.ssl.{include,exclude}.protocols leave no "
                         "enabled TLS version")
    ssl_ctx.minimum_version = (ssl.TLSVersion.TLSv1_3
                               if "TLSv1.2" not in allowed
                               else ssl.TLSVersion.TLSv1_2)
    ssl_ctx.maximum_version = (ssl.TLSVersion.TLSv1_2
                               if "TLSv1.3" not in allowed
                               else ssl.TLSVersion.TLSv1_3)
    if ciphers:
        ssl_ctx.set_ciphers(":".join(c for c in ciphers
                                     if c not in exclude_ciphers))
    elif exclude_ciphers:
        ssl_ctx.set_ciphers("DEFAULT:" + ":".join(
            f"!{c}" for c in exclude_ciphers))
    return ssl_ctx


class SamplingLoop:
    """Periodic sampling driver (LoadMonitorTaskRunner SamplingTask schedule).

    When the backend carries a simulated clock (``advance``), each round also
    advances it by the interval so detector grace periods / deferred re-checks
    move with wall time — otherwise a standalone run against the simulated
    backend would mix a frozen sim clock with wall-clock sample stamps.
    """

    def __init__(self, load_monitor, interval_ms: float, backend=None):
        self._lm = load_monitor
        self._backend = backend
        self._interval_ms = interval_ms
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="sampling-loop",
                                        daemon=True)

    def _run(self):
        while not self._stop.wait(self._interval_ms / 1000.0):
            try:
                if self._backend is not None and hasattr(self._backend, "advance"):
                    self._backend.advance(self._interval_ms)
                self._lm.sample_once()
            except Exception:
                LOG.exception("sampling round failed")

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)


def build_sampling_loop(cc, config) -> SamplingLoop:
    """The sampling schedule main() starts (metric.sampling.interval.ms)."""
    return SamplingLoop(cc.load_monitor,
                        config.get_int("metric.sampling.interval.ms"),
                        backend=cc.backend)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cruise-control-tpu-torch",
        description="Cruise Control service on the PyTorch port")
    parser.add_argument("properties", help="cruisecontrol.properties path")
    parser.add_argument("--cluster-spec", default=None,
                        help="JSON cluster spec to seed the simulated backend")
    parser.add_argument("--no-detection", action="store_true",
                        help="do not start the anomaly detection loop")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device of the optimizer's kernels (cpu: their "
                             "plain twins)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from cruise_control_tpu_torch.config import cruise_control_config
    base_props, overlays = split_fleet_overlays(
        load_properties(args.properties))
    config = cruise_control_config(base_props)
    cc = build_app(config, device=args.device)
    if args.cluster_spec:
        with open(args.cluster_spec) as f:
            seed_backend_from_spec(cc.backend, json.load(f))

    # startUp order mirrors KafkaCruiseControl.startUp (:201-207): monitor
    # replay, steady-loop drive, anomaly detection, then the web server.
    # service.pipeline.enabled (default): the steady loop is the four-stage
    # CONTINUOUS pipeline (pipeline.py) — its optimize
    # stage replaces the proposal-precompute threads (same cache, driven by
    # synced generations + completeness backpressure instead of polling) and
    # its ingest stage replaces the blocking SamplingLoop. Off restores the
    # legacy blocking round.
    pipelined = config.get_boolean("service.pipeline.enabled")
    cc.start_up(proposal_precompute=not pipelined)
    sampling = None
    pipeline = None
    if pipelined:
        from cruise_control_tpu_torch.pipeline import PipelinedServiceLoop
        pipeline = PipelinedServiceLoop(cc, config)
        cc.service_pipeline = pipeline
        pipeline.start()
        if config.get_boolean("analyzer.warmup.on.start"):
            threading.Thread(target=cc._warmup_quietly,
                             name="engine-warmup", daemon=True).start()
    else:
        sampling = build_sampling_loop(cc, config)
        sampling.start()
    if not args.no_detection:
        cc.anomaly_detector.start_detection(
            config.get_int("anomaly.detection.interval.ms"))
    # fleet.cluster.ids declared -> multi-tenant: one FleetScheduler behind
    # the server (cluster-scoped REST routing + batched precompute rounds)
    fleet = build_fleet(cc, config, base_props, overlays, device=args.device)
    if fleet is not None:
        fleet.start_precompute()
    server = build_server(cc, config, fleet=fleet)
    server.start()
    LOG.info("cruise-control-tpu-torch serving on %s (%s loop%s)", server.base_url,
             "pipelined" if pipelined else "blocking",
             f", {len(fleet.cluster_ids)} fleet tenants" if fleet else "")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        LOG.info("shutting down")
    finally:
        server.stop()
        if fleet is not None:
            fleet.shutdown()
        if pipeline is not None:
            pipeline.stop()
        if sampling is not None:
            sampling.stop()
        cc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
