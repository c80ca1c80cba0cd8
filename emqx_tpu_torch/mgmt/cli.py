"""Operator CLI — parity with ``emqx_ctl`` / ``emqx_mgmt_cli.erl``.

Verbs drive the running broker through the management REST API (the
reference's ctl RPCs into the live node map to HTTP here):

    emqx_ctl status | broker | cluster
    emqx_ctl clients list | show <id> | kick <id>
    emqx_ctl subscriptions list | topics list
    emqx_ctl metrics | stats
    emqx_ctl publish <topic> <payload> [--qos N] [--retain]
    emqx_ctl banned list | add <kind> <who> | del <kind> <who>
    emqx_ctl rules list | show <id> | delete <id>
    emqx_ctl retainer topics | clean <topic>
    emqx_ctl gateway list | show <name> | clients <name> |
             kick <name> <clientid> | unload <name>

Auth via --user/--pass (dashboard login) or EMQX_API_KEY/EMQX_API_SECRET
(basic auth).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import urllib.error
import urllib.request
from typing import Any, Optional


class CtlClient:
    def __init__(self, base: str = "http://127.0.0.1:18083",
                 username: str = "admin", password: str = "public",
                 api_key: Optional[str] = None,
                 api_secret: Optional[str] = None) -> None:
        self.base = base.rstrip("/")
        self.api_key = api_key or os.environ.get("EMQX_API_KEY")
        self.api_secret = api_secret or os.environ.get("EMQX_API_SECRET")
        self.username, self.password = username, password
        self._token: Optional[str] = None

    def _auth_header(self) -> str:
        if self.api_key:
            raw = f"{self.api_key}:{self.api_secret or ''}".encode()
            return "Basic " + base64.b64encode(raw).decode()
        if self._token is None:
            resp = self._raw("POST", "/api/v5/login",
                             {"username": self.username,
                              "password": self.password}, auth=False)
            self._token = resp["token"]
        return f"Bearer {self._token}"

    def _raw(self, method: str, path: str, body: Any = None,
             auth: bool = True) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        if auth:
            req.add_header("Authorization", self._auth_header())
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                err = json.loads(raw)
            except ValueError:
                err = {"code": str(e.code)}
            raise SystemExit(
                f"error {e.code}: {err.get('code')} "
                f"{err.get('message', '')}".strip()) from e
        if not raw:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return raw.decode()

    def request(self, method: str, path: str, body: Any = None) -> Any:
        return self._raw(method, path, body)


def _print(obj: Any) -> None:
    if isinstance(obj, str):
        print(obj, end="" if obj.endswith("\n") else "\n")
    else:
        print(json.dumps(obj, indent=2, default=str))


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="emqx_ctl",
                                 description="emqx_tpu control CLI")
    ap.add_argument("--url", default=os.environ.get(
        "EMQX_API_URL", "http://127.0.0.1:18083"))
    ap.add_argument("--user", default="admin")
    ap.add_argument("--password", default="public")
    sub = ap.add_subparsers(dest="verb", required=True)

    for simple in ("status", "metrics", "stats", "broker"):
        sub.add_parser(simple)
    sub.add_parser("cluster")

    p = sub.add_parser("clients")
    p.add_argument("action", choices=["list", "show", "kick"])
    p.add_argument("clientid", nargs="?")

    p = sub.add_parser("subscriptions")
    p.add_argument("action", choices=["list"])
    p = sub.add_parser("topics")
    p.add_argument("action", choices=["list"])

    p = sub.add_parser("publish")
    p.add_argument("topic")
    p.add_argument("payload")
    p.add_argument("--qos", type=int, default=0)
    p.add_argument("--retain", action="store_true")

    p = sub.add_parser("banned")
    p.add_argument("action", choices=["list", "add", "del"])
    p.add_argument("kind", nargs="?",
                   choices=["clientid", "username", "peerhost"])
    p.add_argument("who", nargs="?")
    p.add_argument("--seconds", type=float, default=None)

    p = sub.add_parser("rules")
    p.add_argument("action", choices=["list", "show", "delete"])
    p.add_argument("id", nargs="?")

    p = sub.add_parser("retainer")
    p.add_argument("action", choices=["topics", "clean"])
    p.add_argument("topic", nargs="?")

    # emqx_gateway_cli: gateway list | show <name> | clients <name> |
    # kick <name> <clientid> | unload <name>
    p = sub.add_parser("gateway")
    p.add_argument("action",
                   choices=["list", "show", "clients", "kick", "unload"])
    p.add_argument("name", nargs="?")
    p.add_argument("clientid", nargs="?")

    args = ap.parse_args(argv)
    ctl = CtlClient(args.url, args.user, args.password)

    if args.verb in ("status", "broker"):
        _print(ctl.request("GET", "/api/v5/status"))
    elif args.verb == "cluster":
        _print(ctl.request("GET", "/api/v5/nodes"))
    elif args.verb == "metrics":
        _print(ctl.request("GET", "/api/v5/metrics"))
    elif args.verb == "stats":
        _print(ctl.request("GET", "/api/v5/stats"))
    elif args.verb == "clients":
        if args.action == "list":
            _print(ctl.request("GET", "/api/v5/clients"))
        elif args.action == "show":
            _print(ctl.request("GET", f"/api/v5/clients/{args.clientid}"))
        else:
            ctl.request("DELETE", f"/api/v5/clients/{args.clientid}")
            print(f"kicked {args.clientid}")
    elif args.verb == "subscriptions":
        _print(ctl.request("GET", "/api/v5/subscriptions"))
    elif args.verb == "topics":
        _print(ctl.request("GET", "/api/v5/topics"))
    elif args.verb == "publish":
        _print(ctl.request("POST", "/api/v5/publish", {
            "topic": args.topic, "payload": args.payload,
            "qos": args.qos, "retain": args.retain}))
    elif args.verb == "banned":
        if args.action == "list":
            _print(ctl.request("GET", "/api/v5/banned"))
        elif args.action == "add":
            _print(ctl.request("POST", "/api/v5/banned", {
                "as": args.kind, "who": args.who,
                "seconds": args.seconds}))
        else:
            ctl.request("DELETE",
                        f"/api/v5/banned/{args.kind}/{args.who}")
            print(f"unbanned {args.kind}={args.who}")
    elif args.verb == "rules":
        if args.action == "list":
            _print(ctl.request("GET", "/api/v5/rules"))
        elif args.action == "show":
            _print(ctl.request("GET", f"/api/v5/rules/{args.id}"))
        else:
            ctl.request("DELETE", f"/api/v5/rules/{args.id}")
            print(f"deleted rule {args.id}")
    elif args.verb == "retainer":
        if args.action == "topics":
            _print(ctl.request("GET", "/api/v5/retainer/messages"))
        else:
            ctl.request("DELETE",
                        f"/api/v5/retainer/message/{args.topic}")
            print(f"cleaned {args.topic}")
    elif args.verb == "gateway":
        if args.action == "list":
            _print(ctl.request("GET", "/api/v5/gateways"))
        elif args.action == "show":
            _print(ctl.request("GET", f"/api/v5/gateways/{args.name}"))
        elif args.action == "clients":
            _print(ctl.request(
                "GET", f"/api/v5/gateways/{args.name}/clients"))
        elif args.action == "kick":
            ctl.request("DELETE", f"/api/v5/gateways/{args.name}"
                                  f"/clients/{args.clientid}")
            print(f"kicked {args.clientid} from {args.name}")
        else:
            ctl.request("DELETE", f"/api/v5/gateways/{args.name}")
            print(f"unloaded {args.name}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
