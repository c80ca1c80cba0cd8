"""REST management API — parity with ``apps/emqx_management`` +
``apps/emqx_dashboard`` (minirest/cowboy + swagger).

Endpoints (subset mirroring emqx_mgmt_api_*.erl, /api/v5 prefix):

    POST /login                     → bearer token (dashboard JWT slot)
    GET  /status /nodes /metrics /stats /prometheus /alarms
    GET  /clients [?page,limit,like_clientid]   GET/DELETE /clients/{id}
    GET  /subscriptions             GET /topics (the route table)
    POST /publish                   {topic, payload, qos, retain}
    GET/POST /banned                DELETE /banned/{kind}/{value}
    GET  /configs?path=a.b          PUT /configs {path, value}
    GET/POST /rules   GET/PUT/DELETE /rules/{id}   POST /rule_test
    GET  /retainer/messages         DELETE /retainer/message/{topic}
    GET  /api-docs.json             (swagger-ish doc from the registry)

Auth: ``Authorization: Bearer <token>`` from /login, or API-key basic
auth (emqx_mgmt_auth analogue). Runs a stdlib ThreadingHTTPServer on a
daemon thread beside the asyncio broker.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from emqx_tpu_torch.core.message import Message


class HtmlPage(str):
    """Marker: a handler EXPLICITLY returning HTML. The reply path
    keys content-type on this type, never on body sniffing — a string
    handler echoing user data must stay text/plain."""


class ApiError(Exception):
    def __init__(self, status: int, code: str, message: str = "") -> None:
        super().__init__(message or code)
        self.status = status
        self.code = code


class ApiKeys:
    """API key/secret pairs (emqx_mgmt_auth.erl)."""

    def __init__(self) -> None:
        self._keys: dict[str, str] = {}       # key → sha256(secret)

    def create(self, key: Optional[str] = None,
               secret: Optional[str] = None) -> tuple[str, str]:
        key = key or base64.urlsafe_b64encode(os.urandom(9)).decode()
        secret = secret or base64.urlsafe_b64encode(os.urandom(18)).decode()
        self._keys[key] = hashlib.sha256(secret.encode()).hexdigest()
        return key, secret

    def check(self, key: str, secret: str) -> bool:
        want = self._keys.get(key)
        return want is not None and hmac.compare_digest(
            want, hashlib.sha256(secret.encode()).hexdigest())

    def delete(self, key: str) -> bool:
        return self._keys.pop(key, None) is not None

    def list(self) -> list[str]:
        return list(self._keys)


class Dashboard:
    """Admin users + bearer tokens (emqx_dashboard_admin/_token)."""

    TOKEN_TTL_S = 3600.0

    def __init__(self) -> None:
        self._users: dict[str, str] = {}
        self._tokens: dict[str, tuple[str, float]] = {}
        self.add_user("admin", "public")      # the reference's default

    def add_user(self, username: str, password: str) -> None:
        self._users[username] = hashlib.sha256(password.encode()).hexdigest()

    def login(self, username: str, password: str) -> Optional[str]:
        want = self._users.get(username)
        if want is None or not hmac.compare_digest(
                want, hashlib.sha256(password.encode()).hexdigest()):
            return None
        token = base64.urlsafe_b64encode(os.urandom(24)).decode()
        self._tokens[token] = (username, time.time() + self.TOKEN_TTL_S)
        return token

    def verify(self, token: str) -> bool:
        hit = self._tokens.get(token)
        if hit is None:
            return False
        if time.time() > hit[1]:
            del self._tokens[token]
            return False
        return True


class ManagementApi:
    """Route registry + handlers over a BrokerApp (and optional cluster
    node for /nodes)."""

    def __init__(self, app, cluster_node=None) -> None:
        self.app = app
        self.cluster = cluster_node
        self.api_keys = ApiKeys()
        self.dashboard = Dashboard()
        self._routes: list[tuple[str, re.Pattern, list[str], Callable,
                                 str]] = []
        self._register_all()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None

    # -- routing ------------------------------------------------------------

    def route(self, method: str, path: str, fn: Callable,
              desc: str = "") -> None:
        names = re.findall(r"\{(\w+)\}", path)
        pat = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$")
        self._routes.append((method, pat, names, fn, desc or path))

    def handle(self, method: str, path: str, query: dict,
               body: Any, authed: bool) -> tuple[int, Any]:
        if path == "/api/v5/login" and method == "POST":
            # body may be raw bytes when the client skipped the JSON
            # content-type — a malformed login is a 400, not a crash
            if not isinstance(body, dict):
                return 400, {"code": "BAD_REQUEST",
                             "message": "JSON body required"}
            return self._login(body)
        if path == "/api-docs.json" and method == "GET":
            return 200, self._docs()
        if path in ("/", "/dashboard") and method == "GET":
            # minimal built-in status page (the reference ships a full
            # Vue app from a separate repo; this keeps the dashboard
            # surface self-contained: login + live monitor over the
            # same REST API)
            return 200, HtmlPage(_DASHBOARD_HTML)
        if not authed:
            return 401, {"code": "UNAUTHORIZED",
                         "message": "missing or bad credentials"}
        for m, pat, names, fn, _desc in self._routes:
            if m != method:
                continue
            match = pat.match(path)
            if match is None:
                continue
            try:
                kwargs = {n: urllib.parse.unquote(match.group(n))
                          for n in names}
                result = fn(query=query, body=body, **kwargs)
                if isinstance(result, tuple):
                    return result
                return (204, None) if result is None else (200, result)
            except ApiError as e:
                return e.status, {"code": e.code, "message": str(e)}
            except Exception as e:        # noqa: BLE001 — surface as 500
                return 500, {"code": "INTERNAL_ERROR", "message": str(e)}
        return 404, {"code": "NOT_FOUND", "message": path}

    def _login(self, body: dict) -> tuple[int, Any]:
        token = self.dashboard.login(body.get("username", ""),
                                     body.get("password", ""))
        if token is None:
            return 401, {"code": "BAD_USERNAME_OR_PWD"}
        return 200, {"token": token, "version": "5"}

    def check_auth(self, headers) -> bool:
        auth = headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            return self.dashboard.verify(auth[7:].strip())
        if auth.startswith("Basic "):
            try:
                user, _, pw = base64.b64decode(
                    auth[6:].strip()).decode().partition(":")
            except Exception:
                return False
            return self.api_keys.check(user, pw)
        return False

    def _docs(self) -> dict:
        from emqx_tpu_torch.mgmt import swagger

        return swagger.generate(self)

    # -- handlers -----------------------------------------------------------

    def _register_all(self) -> None:
        r = self.route
        r("GET", "/api/v5/status", self.h_status)
        r("GET", "/api/v5/nodes", self.h_nodes)
        r("GET", "/api/v5/metrics", self.h_metrics)
        r("GET", "/api/v5/stats", self.h_stats)
        r("GET", "/api/v5/prometheus", self.h_prometheus)
        r("GET", "/api/v5/alarms", self.h_alarms)
        r("GET", "/api/v5/clients", self.h_clients)
        r("GET", "/api/v5/clients/{clientid}", self.h_client)
        r("DELETE", "/api/v5/clients/{clientid}", self.h_kick)
        r("GET", "/api/v5/subscriptions", self.h_subscriptions)
        r("GET", "/api/v5/topics", self.h_topics)
        r("POST", "/api/v5/publish", self.h_publish)
        r("GET", "/api/v5/banned", self.h_banned_list)
        r("POST", "/api/v5/banned", self.h_banned_create)
        r("DELETE", "/api/v5/banned/{kind}/{value}", self.h_banned_delete)
        r("GET", "/api/v5/configs", self.h_config_get)
        r("PUT", "/api/v5/configs", self.h_config_put)
        r("GET", "/api/v5/cluster_rpc", self.h_cluster_rpc_status)
        r("POST", "/api/v5/cluster_rpc/skip", self.h_cluster_rpc_skip)
        r("POST", "/api/v5/cluster_rpc/fast_forward",
          self.h_cluster_rpc_ff)
        r("GET", "/api/v5/rules", self.h_rules_list)
        r("POST", "/api/v5/rules", self.h_rules_create)
        r("GET", "/api/v5/rules/{id}", self.h_rule_get)
        r("PUT", "/api/v5/rules/{id}", self.h_rule_put)
        r("DELETE", "/api/v5/rules/{id}", self.h_rule_delete)
        r("POST", "/api/v5/rule_test", self.h_rule_test)
        r("GET", "/api/v5/retainer/messages", self.h_retained)
        r("DELETE", "/api/v5/retainer/message/{topic}",
          self.h_retained_delete)
        r("GET", "/api/v5/api_key", self.h_api_keys)
        r("POST", "/api/v5/api_key", self.h_api_key_create)
        r("GET", "/api/v5/trace", self.h_trace_list)
        r("POST", "/api/v5/trace", self.h_trace_create)
        r("DELETE", "/api/v5/trace/{name}", self.h_trace_delete)
        r("PUT", "/api/v5/trace/{name}/stop", self.h_trace_stop)
        r("GET", "/api/v5/trace/{name}/log", self.h_trace_log)
        # native distributed tracing (round 13): the queryable last-N
        # span ring + the degradation ledger's event ring/totals
        r("GET", "/api/v5/tracing/spans", self.h_tracing_spans)
        r("GET", "/api/v5/tracing/ledger", self.h_tracing_ledger)
        # kernel-plane observability (round 19): trie-health snapshot
        # from the device-metrics fold (counters + gauges + stages)
        r("GET", "/api/v5/kernel/stats", self.h_kernel_stats)
        r("GET", "/api/v5/slow_subscriptions", self.h_slow_subs)
        r("DELETE", "/api/v5/slow_subscriptions", self.h_slow_subs_clear)
        r("GET", "/api/v5/mqtt/topic_metrics", self.h_topic_metrics)
        r("POST", "/api/v5/mqtt/topic_metrics", self.h_topic_metrics_add)
        r("DELETE", "/api/v5/mqtt/topic_metrics/{topic}",
          self.h_topic_metrics_del)
        r("GET", "/api/v5/mqtt/topic_rewrite", self.h_rewrite_get)
        r("PUT", "/api/v5/mqtt/topic_rewrite", self.h_rewrite_put)
        r("GET", "/api/v5/mqtt/auto_subscribe", self.h_auto_sub_get)
        r("PUT", "/api/v5/mqtt/auto_subscribe", self.h_auto_sub_put)
        r("GET", "/api/v5/plugins", self.h_plugins)
        r("PUT", "/api/v5/plugins/{name}/{action}", self.h_plugin_action)
        r("DELETE", "/api/v5/plugins/{name}", self.h_plugin_delete)
        r("GET", "/api/v5/monitor", self.h_monitor)
        r("GET", "/api/v5/monitor_current", self.h_monitor_current)
        # listeners (emqx_mgmt_api_listeners): list + stop by id
        r("GET", "/api/v5/listeners", self.h_listeners)
        r("DELETE", "/api/v5/listeners/{lid}", self.h_listener_stop)
        # gateways (emqx_gateway_api / _api_clients): list, detail,
        # per-gateway clients + kick, unload
        r("GET", "/api/v5/gateways", self.h_gateways)
        r("GET", "/api/v5/gateways/{name}", self.h_gateway)
        r("DELETE", "/api/v5/gateways/{name}", self.h_gateway_unload)
        r("GET", "/api/v5/gateways/{name}/clients",
          self.h_gateway_clients)
        r("DELETE", "/api/v5/gateways/{name}/clients/{clientid}",
          self.h_gateway_kick)

    @staticmethod
    def _page(items: list, query: dict) -> dict:
        page = int(query.get("page", 1))
        limit = int(query.get("limit", 100))
        return {
            "data": items[(page - 1) * limit: page * limit],
            "meta": {"page": page, "limit": limit, "count": len(items)},
        }

    def h_status(self, query, body):
        return {"node": self.app.broker.node, "status": "running",
                "uptime": int(self.app.sys.uptime_s()),
                "version": __import__(
                    "emqx_tpu_torch.observe.sys", fromlist=["VERSION"]).VERSION}

    def h_nodes(self, query, body):
        me = {"node": self.app.broker.node, "status": "running",
              "role": getattr(self.cluster, "role", "core")}
        if self.cluster is None:
            return [me]
        return [me] + [
            {"node": n, "status": "running" if m.get("alive")
             else "stopped", "role": m.get("role", "core")}
            for n, m in self.cluster.members.items()
        ]

    def _cluster_conf(self):
        if self.cluster is None:
            raise ApiError(503, "NO_CLUSTER",
                           "node is not part of a cluster")
        return self.cluster.conf

    def h_cluster_rpc_status(self, query, body):
        return {"data": self._cluster_conf().cluster_status()}

    def h_cluster_rpc_skip(self, query, body):
        return {"tnx_id": self._cluster_conf().skip_failed_commit()}

    def h_cluster_rpc_ff(self, query, body):
        body = body or {}
        try:
            tnx_id = int(body["tnx_id"])
        except (KeyError, ValueError, TypeError) as e:
            raise ApiError(400, "BAD_REQUEST", "tnx_id required") from e
        return {"tnx_id":
                self._cluster_conf().fast_forward_to_commit(tnx_id)}

    def h_metrics(self, query, body):
        return self.app.metrics.all()

    def h_stats(self, query, body):
        self.app.stats.tick()
        return self.app.stats.all()

    def h_prometheus(self, query, body):
        # ?format=openmetrics opts into trace-id exemplars (illegal in
        # the default text 0.0.4 exposition — a classic parser would
        # fail the whole scrape on them)
        om = query.get("format") == "openmetrics"
        return 200, self.app.prometheus(openmetrics=om)

    def h_alarms(self, query, body):
        which = ("activated" if query.get("activated") in ("true", "1")
                 else "all")
        return [
            {"name": a.name, "message": a.message, "details": a.details,
             "activate_at": a.activate_at, "deactivate_at": a.deactivate_at}
            for a in self.app.alarms.get_alarms(which)
        ]

    def _client_info(self, cid: str, ch) -> dict:
        ci = ch.conninfo
        return {
            "clientid": cid, "username": ci.username,
            "peername": ci.peername, "proto_ver": ci.proto_ver,
            "keepalive": ci.keepalive, "clean_start": ci.clean_start,
            "connected": ch.conn_state == "connected",
            "connected_at": ci.connected_at,
            "subscriptions_cnt": len(ch.session.subscriptions)
            if ch.session else 0,
        }

    def h_clients(self, query, body):
        like = query.get("like_clientid")
        items = [
            self._client_info(cid, ch)
            for cid, ch in sorted(self.app.cm.all_channels())
            if like is None or like in cid
        ]
        return self._page(items, query)

    def h_client(self, query, body, clientid):
        ch = self.app.cm.lookup_channel(clientid)
        if ch is None:
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        return self._client_info(clientid, ch)

    def h_kick(self, query, body, clientid):
        if not self.app.cm.kick(clientid):
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        return None

    def h_subscriptions(self, query, body):
        items = [
            {"clientid": sid, "topic": t, "qos": opts.qos, "nl": opts.nl,
             "rap": opts.rap, "rh": opts.rh}
            for (sid, t), opts in sorted(self.app.broker.suboption.items())
        ]
        return self._page(items, query)

    def h_topics(self, query, body):
        router = self.app.broker.router
        items = [
            {"topic": t, "node": str(r.dest)}
            for t in sorted(router.topics())
            for r in router.lookup_routes(t)
        ]
        return self._page(items, query)

    def h_publish(self, query, body):
        body = body or {}
        topic = body.get("topic")
        if not topic:
            raise ApiError(400, "BAD_REQUEST", "topic required")
        payload = body.get("payload", "")
        if body.get("payload_encoding") == "base64":
            payload = base64.b64decode(payload)
        elif isinstance(payload, str):
            payload = payload.encode()
        msg = Message(
            topic=topic, payload=payload, qos=int(body.get("qos", 0)),
            from_="mgmt_api",
            flags={"retain": bool(body.get("retain", False))},
            headers={"properties": body.get("properties") or {}},
        )
        self.app.cm.dispatch(self.app.broker.publish(msg))
        return {"id": msg.id}

    def h_banned_list(self, query, body):
        return self._page([
            {"as": e.kind, "who": e.value, "by": e.by, "reason": e.reason,
             "at": e.at, "until": e.until}
            for e in self.app.access.banned.all()
        ], query)

    def h_banned_create(self, query, body):
        body = body or {}
        try:
            entry = self.app.access.banned.create(
                body.get("as", "clientid"), body["who"],
                by=body.get("by", "mgmt_api"),
                reason=body.get("reason", ""),
                duration_s=body.get("seconds"))
        except (KeyError, ValueError) as e:
            raise ApiError(400, "BAD_REQUEST", str(e)) from e
        return 201, {"as": entry.kind, "who": entry.value}

    def h_banned_delete(self, query, body, kind, value):
        if not self.app.access.banned.delete(kind, value):
            raise ApiError(404, "NOT_FOUND")
        return None

    def _conf(self):
        conf = getattr(self.app, "config", None)
        if conf is None:
            raise ApiError(503, "NO_CONFIG",
                           "app not booted from a Config")
        return conf

    def h_config_get(self, query, body):
        return {"value": self._conf().get(query.get("path", ""))}

    def h_config_put(self, query, body):
        from emqx_tpu_torch.cluster.conf import (ClusterConfError,
                                                 ClusterConfRejected)

        body = body or {}
        try:
            value = self._conf().put(body["path"], body["value"])
        except KeyError as e:
            raise ApiError(400, "BAD_REQUEST", "path/value required") from e
        except ClusterConfRejected as e:
            # validation failure on the coordinator — permanently bad
            # value, same 400 a non-clustered node would return
            raise ApiError(400, "BAD_VALUE", str(e)) from e
        except ClusterConfError as e:
            # transient cluster condition (no core reachable, coordinator
            # catching up, local apply stalled) — retryable, not a bad
            # request
            raise ApiError(503, "CLUSTER_UNAVAILABLE", str(e)) from e
        except Exception as e:
            raise ApiError(400, "BAD_VALUE", str(e)) from e
        return {"value": value}

    def _rule_info(self, rule) -> dict:
        return {"id": rule.id, "sql": rule.sql, "enable": rule.enabled,
                "description": rule.description, "actions": rule.actions,
                "metrics": self.app.rules.metrics.get_counters(rule.id)}

    def h_rules_list(self, query, body):
        return self._page([self._rule_info(r)
                           for r in self.app.rules.list_rules()], query)

    def h_rules_create(self, query, body):
        body = body or {}
        try:
            rule = self.app.rules.create_rule(
                body.get("id") or f"rule_{int(time.time() * 1000):x}",
                body["sql"], body.get("actions", []),
                enabled=body.get("enable", True),
                description=body.get("description", ""))
        except KeyError as e:
            raise ApiError(400, "BAD_REQUEST", "sql required") from e
        except ValueError as e:
            raise ApiError(400, "BAD_SQL", str(e)) from e
        return 201, self._rule_info(rule)

    def h_rule_get(self, query, body, id):
        rule = self.app.rules.get_rule(id)
        if rule is None:
            raise ApiError(404, "RULE_NOT_FOUND")
        return self._rule_info(rule)

    def h_rule_put(self, query, body, id):
        if self.app.rules.get_rule(id) is None:
            raise ApiError(404, "RULE_NOT_FOUND")
        body = body or {}
        self.app.rules.delete_rule(id)
        try:
            rule = self.app.rules.create_rule(
                id, body["sql"], body.get("actions", []),
                enabled=body.get("enable", True),
                description=body.get("description", ""))
        except ValueError as e:
            raise ApiError(400, "BAD_SQL", str(e)) from e
        return self._rule_info(rule)

    def h_rule_delete(self, query, body, id):
        if not self.app.rules.delete_rule(id):
            raise ApiError(404, "RULE_NOT_FOUND")
        return None

    def h_rule_test(self, query, body):
        body = body or {}
        try:
            res = self.app.rules.test_sql(body["sql"],
                                          body.get("context", {}))
        except KeyError as e:
            raise ApiError(400, "BAD_REQUEST", "sql required") from e
        except ValueError as e:
            raise ApiError(400, "BAD_SQL", str(e)) from e
        if res is None:
            raise ApiError(412, "SQL_NO_MATCH", "WHERE filtered out")
        return res

    def h_retained(self, query, body):
        items = []
        for t in sorted(self.app.retainer.topics()):
            for m in self.app.retainer.match(t):
                items.append({
                    "topic": m.topic, "qos": m.qos,
                    "payload": base64.b64encode(m.payload).decode(),
                    "from_clientid": m.from_, "publish_at": m.timestamp})
        return self._page(items, query)

    def h_retained_delete(self, query, body, topic):
        if not self.app.retainer.delete(topic):
            raise ApiError(404, "NOT_FOUND")
        return None

    def h_api_keys(self, query, body):
        return [{"api_key": k} for k in self.api_keys.list()]

    def h_api_key_create(self, query, body):
        body = body or {}
        key, secret = self.api_keys.create(body.get("api_key"),
                                           body.get("api_secret"))
        return 201, {"api_key": key, "api_secret": secret}

    # -- trace / slow subs (emqx_mgmt_api_trace, emqx_slow_subs_api) ---------

    def h_trace_list(self, query, body):
        return self.app.trace.list()

    def h_trace_create(self, query, body):
        body = body or {}
        try:
            self.app.trace.start(
                body["name"], body.get("type", "clientid"),
                body.get(body.get("type", "clientid"), body.get("value", "")),
                duration_s=body.get("duration"),
                # "punt" (default) = full-fidelity slow-path capture;
                # "native" = stay on the fast path, log sampled span
                # timelines instead (the production-safe mode)
                mode=body.get("mode", "punt"))
        except (KeyError, ValueError) as e:
            raise ApiError(400, "BAD_REQUEST", str(e)) from None
        return 201, {"name": body["name"]}

    def h_tracing_spans(self, query, body):
        """Recent assembled span timelines from the native tracing
        plane (empty when no native server is attached)."""
        fn = getattr(self.app, "native_spans_fn", None)
        if fn is None:
            return []
        try:
            limit = int(query.get("limit", 32))
        except (TypeError, ValueError):
            limit = 32
        return fn(max(1, limit))   # a negative slice would invert
        #                            the newest-N semantics

    def h_kernel_stats(self, query, body):
        """Trie-health + device-counter snapshot from the kernel-plane
        fold; 404 when the app runs without a device router (or with
        EMQX_TPU_KERNEL_TELEMETRY=0)."""
        dm = getattr(self.app, "device_metrics", None)
        if dm is None:
            raise ApiError(404, "NOT_FOUND",
                           "kernel telemetry not attached")
        return dm.snapshot()

    def h_tracing_ledger(self, query, body):
        """Degradation-ledger totals + the bounded structured event
        ring (ring-full punts, trunk punts, sheds, device failovers,
        store degradations)."""
        led = getattr(self.app, "ledger", None)
        if led is None:
            return {"totals": {}, "events": []}
        try:
            limit = int(query.get("limit", 64))
        except (TypeError, ValueError):
            limit = 64
        return {"totals": led.totals(),
                "events": led.recent(max(1, limit))}

    def h_trace_delete(self, query, body, name):
        if not self.app.trace.delete(name):
            raise ApiError(404, "NOT_FOUND")
        return 204, None

    def h_trace_stop(self, query, body, name):
        if not self.app.trace.stop(name):
            raise ApiError(404, "NOT_FOUND")
        return {"name": name, "status": "stopped"}

    def h_trace_log(self, query, body, name):
        if name not in self.app.trace.traces:
            raise ApiError(404, "NOT_FOUND")
        return 200, "\n".join(self.app.trace.log_lines(name))

    def h_slow_subs(self, query, body):
        return self._page([
            {"clientid": e.clientid, "topic": e.topic,
             "timespan": e.latency_ms, "last_update_time": e.last_update}
            for e in self.app.slow_subs.top()
        ], query)

    def h_slow_subs_clear(self, query, body):
        self.app.slow_subs.clear()
        return 204, None

    # -- mqtt modules (emqx_mgmt_api_topic_metrics / _rewrite / _auto_sub) ---

    def h_topic_metrics(self, query, body):
        return self.app.topic_metrics.all()

    def h_topic_metrics_add(self, query, body):
        try:
            if not self.app.topic_metrics.register((body or {})["topic"]):
                raise ApiError(400, "BAD_REQUEST", "already registered")
        except (KeyError, ValueError) as e:
            raise ApiError(400, "BAD_REQUEST", str(e)) from None
        return 201, {"topic": body["topic"]}

    def h_topic_metrics_del(self, query, body, topic):
        if not self.app.topic_metrics.deregister(topic):
            raise ApiError(404, "NOT_FOUND")
        return 204, None

    def h_rewrite_get(self, query, body):
        return self.app.rewrite.list()

    def h_rewrite_put(self, query, body):
        # validate the full replacement set first — a bad body must leave
        # the existing rules untouched
        from emqx_tpu_torch.services.rewrite import TopicRewrite

        staged = TopicRewrite()
        import re as _re
        try:
            for spec in body or []:
                staged.add_rule(
                    action=spec.get("action", "all"),
                    source_topic=spec["source_topic"],
                    re=spec["re"], dest_topic=spec["dest_topic"])
        except (KeyError, ValueError, TypeError, _re.error) as e:
            raise ApiError(400, "BAD_REQUEST", str(e)) from None
        self.app.rewrite.replace(staged.pub_rules, staged.sub_rules)
        return self.app.rewrite.list()

    def h_auto_sub_get(self, query, body):
        return self.app.auto_subscribe.topics

    def h_auto_sub_put(self, query, body):
        from emqx_tpu_torch.services.auto_subscribe import AutoSubscribe

        staged = AutoSubscribe(self.app)     # validate before swapping in
        try:
            for spec in body or []:
                staged.add(
                    topic=spec["topic"], qos=int(spec.get("qos", 0)),
                    nl=int(spec.get("nl", 0)), rh=int(spec.get("rh", 0)),
                    rap=int(spec.get("rap", 0)))
        except (KeyError, ValueError, TypeError) as e:
            raise ApiError(400, "BAD_REQUEST", str(e)) from None
        self.app.auto_subscribe.topics = staged.topics
        return self.app.auto_subscribe.topics

    # -- plugins / monitor (emqx_mgmt_api_plugins, emqx_dashboard_monitor) --

    def h_plugins(self, query, body):
        self.app.plugins.scan()
        return self.app.plugins.list()

    def h_plugin_action(self, query, body, name, action):
        pm = self.app.plugins
        pm.scan()
        if name not in pm.plugins:
            raise ApiError(404, "NOT_FOUND", f"plugin {name} not installed")
        try:
            if action == "start":
                pm.ensure_enabled(name)
                pm.ensure_started(name)
                if pm.plugins[name].error:
                    raise ApiError(400, "BAD_PLUGIN",
                                   pm.plugins[name].error)
            elif action == "stop":
                pm.ensure_stopped(name)
                pm.ensure_disabled(name)
            elif action == "restart":
                pm.restart(name)
                if pm.plugins[name].error:
                    raise ApiError(400, "BAD_PLUGIN",
                                   pm.plugins[name].error)
            else:
                raise ApiError(400, "BAD_REQUEST",
                               f"unknown action {action}")
            return pm.describe(name)
        except (ValueError, KeyError) as e:
            raise ApiError(404, "NOT_FOUND", str(e)) from None

    def h_plugin_delete(self, query, body, name):
        if not self.app.plugins.ensure_uninstalled(name):
            raise ApiError(404, "NOT_FOUND")
        return 204, None

    def h_monitor(self, query, body):
        latest = query.get("latest")
        try:
            window = float(latest) if latest else None
        except ValueError:
            raise ApiError(400, "BAD_REQUEST",
                           f"latest must be numeric: {latest!r}") from None
        return self.app.monitor.history(window)

    def h_monitor_current(self, query, body):
        return self.app.monitor.current()

    # -- listeners (emqx_mgmt_api_listeners) --------------------------------

    def h_listeners(self, query, body):
        sup = getattr(self.app, "listeners", None)
        return sup.info() if sup is not None else []

    def h_listener_stop(self, query, body, lid):
        import asyncio

        sup = getattr(self.app, "listeners", None)
        server = sup.find(lid) if sup is not None else None
        if server is None:
            raise ApiError(404, "LISTENER_NOT_FOUND")
        # the listener's sockets live on the broker loop; this handler
        # runs on the REST thread — stop must execute over there
        srv = getattr(server, "_server", None)
        loop = srv.get_loop() if srv is not None else None
        if loop is not None and loop.is_running():
            asyncio.run_coroutine_threadsafe(
                sup.stop(lid), loop).result(timeout=10)
        else:
            raise ApiError(409, "LISTENER_NOT_RUNNING")
        return None

    # -- gateways (emqx_gateway_api / emqx_gateway_api_clients) -------------

    def h_gateways(self, query, body):
        return self._page(self.app.gateway.list(), query)

    def h_gateway(self, query, body, name):
        for g in self.app.gateway.list():
            if g["name"] == name:
                return g
        raise ApiError(404, "GATEWAY_NOT_FOUND")

    def h_gateway_unload(self, query, body, name):
        if not self.app.gateway.unload(name):
            raise ApiError(404, "GATEWAY_NOT_FOUND")
        return None

    def h_gateway_clients(self, query, body, name):
        clients = self.app.gateway.clients(name)
        if clients is None:
            raise ApiError(404, "GATEWAY_NOT_FOUND")
        return self._page(clients, query)

    def h_gateway_kick(self, query, body, name, clientid):
        ctx = self.app.gateway.contexts.get(name)
        if ctx is None:
            raise ApiError(404, "GATEWAY_NOT_FOUND")
        if clientid not in ctx.sessions:
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        if not self.app.cm.kick(clientid):
            raise ApiError(404, "CLIENTID_NOT_FOUND")
        return None

    # -- http server --------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _run(self, method: str) -> None:
                parsed = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(parsed.query))
                body = None
                ln = int(self.headers.get("Content-Length") or 0)
                if ln:
                    raw = self.rfile.read(ln)
                    ctype = self.headers.get("Content-Type", "")
                    if "json" in ctype or not ctype:
                        try:
                            body = json.loads(raw)
                        except ValueError:
                            self._reply(400, {"code": "BAD_JSON"})
                            return
                    else:
                        body = raw
                status, result = api.handle(
                    method, parsed.path, query, body,
                    authed=api.check_auth(self.headers))
                self._reply(status, result)

            def _reply(self, status: int, result: Any) -> None:
                if isinstance(result, str):
                    data = result.encode()
                    ctype = ("text/html; charset=utf-8"
                             if isinstance(result, HtmlPage)
                             else "text/plain; version=0.0.4")
                elif result is None:
                    data = b""
                    ctype = "application/json"
                else:
                    # rule_test / trace results can carry bytes (gzip,
                    # payloads); never let a reply crash the handler
                    data = json.dumps(
                        result,
                        default=lambda o: (
                            o.decode("utf-8", "replace")
                            if isinstance(o, (bytes, bytearray))
                            else str(o)),
                    ).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._run("GET")

            def do_POST(self):
                self._run("POST")

            def do_PUT(self):
                self._run("PUT")

            def do_DELETE(self):
                self._run("DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="mgmt-api").start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


# ---------------------------------------------------------------------------
# built-in status page (served at / — the reference's dashboard is a
# separate Vue application; this is the self-contained equivalent
# surface: login + live broker stats over the same REST API)

_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>emqx_tpu dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#fafafa}
 h1{font-size:1.2rem} .err{color:#b00}
 .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(220px,1fr));
       gap:12px;margin-top:1rem}
 .card{background:#fff;border:1px solid #ddd;border-radius:8px;
       padding:12px 16px}
 .card b{display:block;font-size:1.6rem;margin-top:4px}
 .muted{color:#777;font-size:.85rem}
 table{border-collapse:collapse;margin-top:1rem;background:#fff;width:100%}
 td,th{border:1px solid #ddd;padding:6px 10px;font-size:.9rem;
       text-align:left}
 input,button{padding:6px 10px;font-size:1rem}
</style></head><body>
<h1>emqx_tpu &mdash; broker status</h1>
<div id="login">
 <input id="u" placeholder="username" value="admin">
 <input id="p" placeholder="password" type="password" value="public">
 <button onclick="login()">Login</button> <span id="msg" class="err"></span>
</div>
<div id="main" style="display:none">
 <div class="grid" id="cards"></div>
 <table id="clients"><tr><th>client</th><th>connected</th></tr></table>
 <p class="muted">auto-refreshes every 2s &middot;
    <a href="/api-docs.json">API docs</a></p>
</div>
<script>
let tok=null;
// every interpolated value passes through esc(): clientids are
// ATTACKER-CONTROLLED (any connecting client picks one) and raw
// innerHTML interpolation would be stored XSS in the admin session
function esc(v){const d=document.createElement('div');
  d.textContent=String(v??'');return d.innerHTML}
async function login(){
  const r=await fetch('/api/v5/login',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({username:u.value,password:p.value})});
  if(!r.ok){msg.textContent='login failed';return}
  tok=(await r.json()).token;
  document.getElementById('login').style.display='none';
  document.getElementById('main').style.display='';
  tick();setInterval(tick,2000);
}
async function get(p){const r=await fetch(p,
  {headers:{Authorization:'Bearer '+tok}});return r.json()}
function card(k,v){return `<div class=card><span class=muted>${esc(k)}</span>`+
  `<b>${esc(v)}</b></div>`}
async function tick(){
  const [st,stats,mon]=await Promise.all([
    get('/api/v5/status'),get('/api/v5/stats'),
    get('/api/v5/monitor_current')]);
  const cards=document.getElementById('cards');
  cards.innerHTML=
    card('node',st.node??'-')+
    card('uptime s',Math.round(st.uptime??0))+
    card('connections',stats['connections.count']??0)+
    card('subscriptions',stats['subscriptions.count']??0)+
    card('topics',stats['topics.count']??0)+
    card('msgs received',mon['messages.received']??0)+
    card('msgs sent',mon['messages.sent']??0);
  const cl=await get('/api/v5/clients');
  const rows=(cl.data||[]).slice(0,50).map(c=>
    `<tr><td>${esc(c.clientid)}</td><td>${esc(c.connected_at)}</td></tr>`);
  document.getElementById('clients').innerHTML=
    '<tr><th>client</th><th>connected</th></tr>'+rows.join('');
}
</script></body></html>
"""
