"""cccli — argparse console client (counterpart of
``cruise_control_tpu/client/cli.py``).

Reference: cruise-control-client/cruisecontrolclient/client/cccli.py (console
script ``cccli``, setup.py:5-27) + Display.py (human-readable rendering).
Subcommands and their flags are GENERATED from the server's endpoint
parameter specs, so the CLI surface tracks the API surface automatically
(one add-broker flag per typed CCParameter in the reference).

Usage:
    cccli -a localhost:9090 state
    cccli -a localhost:9090 rebalance --dryrun --goals DiskCapacityGoal
    cccli -a localhost:9090 remove_broker --brokerid 3,4
"""
from __future__ import annotations

import argparse
import json
import sys

from cruise_control_tpu_torch.api.endpoints import (
    COMMON_PARAMS, ENDPOINT_PARAMS, EndPoint, ParamType,
)
from cruise_control_tpu_torch.client.client import (
    CruiseControlClient, CruiseControlClientError,
)

_SKIP_COMMON = {"json", "get_response_schema", "doas"}  # always-JSON client


def _add_params(sub: argparse.ArgumentParser, endpoint: EndPoint) -> None:
    spec = {**{k: v for k, v in COMMON_PARAMS.items() if k not in _SKIP_COMMON},
            **ENDPOINT_PARAMS[endpoint]}
    for name, ps in sorted(spec.items()):
        flag = f"--{name.replace('_', '-')}"
        if ps.type is ParamType.BOOL:
            if ps.default is True:
                # tri-state: --dryrun / --no-dryrun, absent = server default
                sub.add_argument(flag, dest=name, action="store_true",
                                 default=None)
                sub.add_argument(f"--no-{name.replace('_', '-')}", dest=name,
                                 action="store_false")
            else:
                sub.add_argument(flag, dest=name, action="store_true",
                                 default=None)
        elif ps.type is ParamType.INT:
            sub.add_argument(flag, dest=name, type=int, default=None)
        elif ps.type is ParamType.DOUBLE:
            sub.add_argument(flag, dest=name, type=float, default=None)
        else:  # STRING / lists: comma-separated string passed through
            sub.add_argument(flag, dest=name, type=str, default=None)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cccli", description="Cruise Control command-line client")
    parser.add_argument("-a", "--address", required=True,
                        help="host:port of the cruise-control server")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="overall request timeout incl. async polling (s)")
    parser.add_argument("--user", default=None, help="basic-auth user")
    parser.add_argument("--password", default=None, help="basic-auth password")
    parser.add_argument("--raw", action="store_true",
                        help="print the raw JSON response body")
    subs = parser.add_subparsers(dest="endpoint", required=True)
    for ep in EndPoint:
        sub = subs.add_parser(ep.path, help=f"{ep.path} endpoint")
        _add_params(sub, ep)
    return parser


def _render(endpoint: EndPoint, body: dict, raw: bool, out) -> None:
    if raw or endpoint not in _TABLES:
        json.dump(body, out, indent=2)
        out.write("\n")
        return
    _TABLES[endpoint](body, out)


def _render_load(body: dict, out) -> None:
    cols = ("Broker", "Rack", "BrokerState", "DiskMB", "DiskPct", "CpuPct",
            "LeaderNwInRate", "NwOutRate", "Leaders", "Replicas")
    rows = body.get("brokers", [])
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows), 1)
              for c in cols}
    out.write("  ".join(c.ljust(widths[c]) for c in cols) + "\n")
    for r in rows:
        out.write("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols)
                  + "\n")


def _render_user_tasks(body: dict, out) -> None:
    for t in body.get("userTasks", []):
        out.write(f"{t['UserTaskId']}  {t['Status']:22s} {t['RequestURL']}"
                  f"  client={t['ClientIdentity']}\n")


_TABLES = {EndPoint.LOAD: _render_load, EndPoint.USER_TASKS: _render_user_tasks}


def main(argv=None, out=sys.stdout) -> int:
    args = build_parser().parse_args(argv)
    endpoint = EndPoint.from_path(args.endpoint)
    auth = (args.user, args.password) if args.user else None
    client = CruiseControlClient(args.address, timeout_s=args.timeout,
                                 auth=auth)
    reserved = {"address", "timeout", "user", "password", "raw", "endpoint"}
    params = {k: v for k, v in vars(args).items()
              if k not in reserved and v is not None}
    try:
        body = client.request(endpoint, **params)
    except CruiseControlClientError as e:
        print(f"error ({e.status}): {e}", file=sys.stderr)
        return 1
    _render(endpoint, body, args.raw, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
