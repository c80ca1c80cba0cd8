"""Protobuf wire codec for the ``emqx.exhook.v2`` surface.

A from-scratch proto3 encoder/decoder (varint + length-delimited wire
types only — this service uses nothing else) plus schema tables
mirroring ``apps/emqx_exhook/priv/protos/exhook.proto`` field-for-field
(message names, field numbers and types are the gRPC interop contract
with stock HookProviders; the COMMENT there pins the package to
``emqx.exhook.v2`` for all of EMQX 5.x).

The translator functions at the bottom map between this wire surface
and the framed-transport dict shapes (exhook/proto.py) so both
transports feed the same ``ExhookMgr`` logic.

tests/test_exhook_grpc.py cross-checks this codec against the official
``google.protobuf`` runtime via dynamically-built descriptors — the
differential oracle for field numbers/types.
"""

from __future__ import annotations

import time
from typing import Any, Optional

# ---------------------------------------------------------------------------
# proto3 wire primitives


def _varint(n: int) -> bytes:
    if n < 0:                          # int64 negatives: 10-byte two's cpl
        n += 1 << 64
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise ValueError("pb: truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            return n, pos
        shift += 7


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


# field kinds: varint-backed ("u32", "u64", "i64", "bool", "enum") and
# length-delimited ("str", "bytes", "msg", "map_ss"); any kind may be
# ("rep", inner) for repeated fields. "obool" = bool inside a oneof:
# ALWAYS serialized when the caller supplies it — oneof presence is the
# signal, so a False verdict must still appear on the wire
_VARINT_KINDS = {"u32", "u64", "i64", "bool", "enum", "obool"}


def encode(schema: dict, values: dict) -> bytes:
    """dict (by field name) → wire bytes. proto3 defaults (0 / "" /
    empty) are omitted."""
    by_name = {spec[0]: (num, spec) for num, spec in schema.items()}
    out = bytearray()
    for name, v in values.items():
        if name not in by_name or v is None:
            continue
        num, spec = by_name[name]
        kind = spec[1]
        if isinstance(kind, tuple) and kind[0] == "rep":
            for item in v:
                out += _encode_one(num, kind[1],
                                   spec[2] if len(spec) > 2 else None, item)
        elif kind == "map_ss":
            for k, mv in v.items():
                entry = encode({1: ("key", "str"), 2: ("value", "str")},
                               {"key": str(k), "value": str(mv)})
                out += _key(num, 2) + _varint(len(entry)) + entry
        else:
            if v in (0, "", b"", False) and kind not in ("msg", "obool"):
                continue                       # proto3 default
            out += _encode_one(num, kind,
                               spec[2] if len(spec) > 2 else None, v)
    return bytes(out)


def _encode_one(num: int, kind: str, sub: Optional[dict], v: Any) -> bytes:
    if kind in _VARINT_KINDS:
        if kind in ("bool", "obool"):
            v = 1 if v else 0
        return _key(num, 0) + _varint(int(v))
    if kind == "str":
        b = v.encode() if isinstance(v, str) else bytes(v)
        return _key(num, 2) + _varint(len(b)) + b
    if kind == "bytes":
        b = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
        return _key(num, 2) + _varint(len(b)) + bytes(b)
    if kind == "msg":
        b = encode(sub, v)
        return _key(num, 2) + _varint(len(b)) + b
    raise ValueError(f"pb: unknown kind {kind}")


def decode(schema: dict, data: bytes) -> dict:
    """wire bytes → dict by field name; unknown fields skipped; absent
    fields get proto3 defaults."""
    out: dict = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        num, wire = tag >> 3, tag & 0x07
        spec = schema.get(num)
        if wire == 0:
            v, pos = _read_varint(data, pos)
            if spec:
                out[spec[0]] = _coerce_varint(spec[1], v)
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            chunk = data[pos:pos + ln]
            if len(chunk) != ln:
                raise ValueError("pb: truncated length-delimited field")
            pos += ln
            if spec:
                _put_len_delim(out, spec, chunk)
        elif wire == 5:
            pos += 4                           # fixed32 (unused here)
        elif wire == 1:
            pos += 8                           # fixed64 (unused here)
        else:
            raise ValueError(f"pb: unsupported wire type {wire}")
    _fill_defaults(schema, out)
    return out


def _coerce_varint(kind, v: int):
    if isinstance(kind, tuple):                # repeated varint (unused)
        return v
    if kind in ("bool", "obool"):
        return bool(v)
    if kind == "i64" and v >= (1 << 63):
        return v - (1 << 64)
    return v


def _put_len_delim(out: dict, spec: tuple, chunk: bytes) -> None:
    name, kind = spec[0], spec[1]
    sub = spec[2] if len(spec) > 2 else None
    if isinstance(kind, tuple) and kind[0] == "rep":
        inner = kind[1]
        if inner == "str":
            out.setdefault(name, []).append(chunk.decode("utf-8",
                                                         "replace"))
        elif inner == "msg":
            out.setdefault(name, []).append(decode(sub, chunk))
        else:
            raise ValueError(f"pb: repeated {inner} unsupported")
    elif kind == "map_ss":
        entry = decode({1: ("key", "str"), 2: ("value", "str")}, chunk)
        out.setdefault(name, {})[entry["key"]] = entry["value"]
    elif kind == "str":
        out[name] = chunk.decode("utf-8", "replace")
    elif kind == "bytes":
        out[name] = chunk
    elif kind == "msg":
        out[name] = decode(sub, chunk)
    else:
        raise ValueError(f"pb: field {name} kind {kind} with wire type 2")


def _fill_defaults(schema: dict, out: dict) -> None:
    for spec in schema.values():
        name, kind = spec[0], spec[1]
        if name in out:
            continue
        if isinstance(kind, tuple):
            out[name] = []
        elif kind == "map_ss":
            out[name] = {}
        elif kind == "obool":
            continue                           # oneof member: presence only
        elif kind in _VARINT_KINDS:
            out[name] = False if kind == "bool" else 0
        elif kind == "str":
            out[name] = ""
        elif kind == "bytes":
            out[name] = b""
        # "msg": stays absent (proto3 message presence)


# ---------------------------------------------------------------------------
# emqx.exhook.v2 schemas (exhook.proto field numbers)

REQUEST_META = {1: ("node", "str"), 2: ("version", "str"),
                3: ("sysdescr", "str"), 4: ("cluster_name", "str")}

BROKER_INFO = {1: ("version", "str"), 2: ("sysdescr", "str"),
               3: ("uptime", "i64"), 4: ("datetime", "str")}

HOOK_SPEC = {1: ("name", "str"), 2: ("topics", ("rep", "str"))}

CONN_INFO = {1: ("node", "str"), 2: ("clientid", "str"),
             3: ("username", "str"), 4: ("peerhost", "str"),
             5: ("sockport", "u32"), 6: ("proto_name", "str"),
             7: ("proto_ver", "str"), 8: ("keepalive", "u32")}

CLIENT_INFO = {1: ("node", "str"), 2: ("clientid", "str"),
               3: ("username", "str"), 4: ("password", "str"),
               5: ("peerhost", "str"), 6: ("sockport", "u32"),
               7: ("protocol", "str"), 8: ("mountpoint", "str"),
               9: ("is_superuser", "bool"), 10: ("anonymous", "bool"),
               11: ("cn", "str"), 12: ("dn", "str")}

MESSAGE = {1: ("node", "str"), 2: ("id", "str"), 3: ("qos", "u32"),
           4: ("from", "str"), 5: ("topic", "str"), 6: ("payload", "bytes"),
           7: ("timestamp", "u64"), 8: ("headers", "map_ss")}

PROPERTY = {1: ("name", "str"), 2: ("value", "str")}

TOPIC_FILTER = {1: ("name", "str"), 2: ("qos", "u32")}

SUB_OPTS = {1: ("qos", "u32"), 2: ("share", "str"), 3: ("rh", "u32"),
            4: ("rap", "u32"), 5: ("nl", "u32")}

LOADED_RESPONSE = {1: ("hooks", ("rep", "msg"), HOOK_SPEC)}

VALUED_RESPONSE = {1: ("type", "enum"),          # 0 CONTINUE 1 IGNORE 2 STOP
                   3: ("bool_result", "obool"),  # oneof value
                   4: ("message", "msg", MESSAGE)}

EMPTY_SUCCESS: dict = {}

_META = ("meta", "msg", REQUEST_META)

REQUEST_SCHEMAS: dict[str, dict] = {
    "OnProviderLoaded": {1: ("broker", "msg", BROKER_INFO), 2: _META},
    "OnProviderUnloaded": {1: _META},
    "OnClientConnect": {1: ("conninfo", "msg", CONN_INFO),
                        2: ("props", ("rep", "msg"), PROPERTY), 3: _META},
    "OnClientConnack": {1: ("conninfo", "msg", CONN_INFO),
                        2: ("result_code", "str"),
                        3: ("props", ("rep", "msg"), PROPERTY), 4: _META},
    "OnClientConnected": {1: ("clientinfo", "msg", CLIENT_INFO), 2: _META},
    "OnClientDisconnected": {1: ("clientinfo", "msg", CLIENT_INFO),
                             2: ("reason", "str"), 3: _META},
    "OnClientAuthenticate": {1: ("clientinfo", "msg", CLIENT_INFO),
                             2: ("result", "bool"), 3: _META},
    "OnClientAuthorize": {1: ("clientinfo", "msg", CLIENT_INFO),
                          2: ("type", "enum"),   # 0 PUBLISH 1 SUBSCRIBE
                          3: ("topic", "str"), 4: ("result", "bool"),
                          5: _META},
    "OnClientSubscribe": {1: ("clientinfo", "msg", CLIENT_INFO),
                          2: ("props", ("rep", "msg"), PROPERTY),
                          3: ("topic_filters", ("rep", "msg"), TOPIC_FILTER),
                          4: _META},
    "OnClientUnsubscribe": {1: ("clientinfo", "msg", CLIENT_INFO),
                            2: ("props", ("rep", "msg"), PROPERTY),
                            3: ("topic_filters", ("rep", "msg"),
                                TOPIC_FILTER),
                            4: _META},
    "OnSessionCreated": {1: ("clientinfo", "msg", CLIENT_INFO), 2: _META},
    "OnSessionSubscribed": {1: ("clientinfo", "msg", CLIENT_INFO),
                            2: ("topic", "str"),
                            3: ("subopts", "msg", SUB_OPTS), 4: _META},
    "OnSessionUnsubscribed": {1: ("clientinfo", "msg", CLIENT_INFO),
                              2: ("topic", "str"), 3: _META},
    "OnSessionResumed": {1: ("clientinfo", "msg", CLIENT_INFO), 2: _META},
    "OnSessionDiscarded": {1: ("clientinfo", "msg", CLIENT_INFO), 2: _META},
    "OnSessionTakenover": {1: ("clientinfo", "msg", CLIENT_INFO), 2: _META},
    "OnSessionTerminated": {1: ("clientinfo", "msg", CLIENT_INFO),
                            2: ("reason", "str"), 3: _META},
    "OnMessagePublish": {1: ("message", "msg", MESSAGE), 2: _META},
    "OnMessageDelivered": {1: ("clientinfo", "msg", CLIENT_INFO),
                           2: ("message", "msg", MESSAGE), 3: _META},
    "OnMessageDropped": {1: ("message", "msg", MESSAGE),
                         2: ("reason", "str"), 3: _META},
    "OnMessageAcked": {1: ("clientinfo", "msg", CLIENT_INFO),
                       2: ("message", "msg", MESSAGE), 3: _META},
}

# RPCs answering ValuedResponse; every other one answers EmptySuccess
# except OnProviderLoaded (LoadedResponse)
VALUED_RPCS = {"OnClientAuthenticate", "OnClientAuthorize",
               "OnMessagePublish"}

SERVICE = "emqx.exhook.v2.HookProvider"


def method_path(rpc: str) -> str:
    return f"/{SERVICE}/{rpc}"


# ---------------------------------------------------------------------------
# framed-dict ↔ proto-dict translation (broker side)

_ENUM_TYPE = {"publish": 0, "subscribe": 1}
_TYPE_NAMES = {0: "CONTINUE", 1: "IGNORE", 2: "STOP_AND_RETURN"}


def _pb_clientinfo(ci: dict) -> dict:
    peer = str(ci.get("peerhost") or ci.get("peername") or "")
    host, _, port = peer.rpartition(":")
    out = {"clientid": str(ci.get("clientid") or ""),
           "username": str(ci.get("username") or ""),
           "peerhost": host or peer,
           "node": str(ci.get("node") or "emqx_tpu@127.0.0.1")}
    if ci.get("password") is not None:
        pw = ci["password"]
        out["password"] = (pw.decode("utf-8", "replace")
                           if isinstance(pw, bytes) else str(pw))
    if port.isdigit():
        out["sockport"] = int(port)
    if ci.get("proto_ver") is not None:
        out["protocol"] = str(ci["proto_ver"])
    if ci.get("mountpoint"):
        out["mountpoint"] = str(ci["mountpoint"])
    if ci.get("is_superuser"):
        out["is_superuser"] = True
    return out


# the proto's headers map carries ONLY these string keys (exhook.proto
# Message.headers comment: username/protocol/peerhost readonly +
# allow_publish writable) — broker-internal structured headers
# (properties dicts etc.) never cross the wire
_WIRE_HEADERS = ("username", "protocol", "peerhost", "allow_publish")


def _pb_message(m: dict) -> dict:
    payload = m.get("payload", b"")
    if isinstance(payload, str):
        payload = payload.encode()
    src = m.get("headers") or {}
    headers = {k: str(src[k]) for k in _WIRE_HEADERS if src.get(k)
               is not None}
    return {"id": str(m.get("id") or ""), "qos": int(m.get("qos") or 0),
            "from": str(m.get("from") or ""),
            "topic": str(m.get("topic") or ""), "payload": payload,
            "timestamp": int(m.get("timestamp") or time.time() * 1000),
            "headers": headers,
            "node": str(m.get("node") or "emqx_tpu@127.0.0.1")}


def _from_pb_message(pm: dict) -> dict:
    headers = {k: v for k, v in (pm.get("headers") or {}).items()
               if k in _WIRE_HEADERS}
    return {"id": pm.get("id") or "", "qos": pm.get("qos", 0),
            "from": pm.get("from", ""), "topic": pm.get("topic", ""),
            "payload": pm.get("payload", b""),
            "timestamp": pm.get("timestamp", 0),
            "headers": headers, "flags": {}}


def build_request(rpc: str, args: dict, meta: Optional[dict] = None) -> bytes:
    """framed-transport args (exhook/proto.py shapes) → request bytes."""
    v: dict[str, Any] = {"meta": meta or {"node": "emqx_tpu@127.0.0.1",
                                          "version": "5.0.14"}}
    if rpc == "OnProviderLoaded":
        b = args.get("broker") or {}
        v["broker"] = {"version": str(b.get("version", "5.0.14")),
                       "sysdescr": str(b.get("sysdescr", "emqx_tpu")),
                       "uptime": int(b.get("uptime", 0)),
                       "datetime": str(b.get("datetime", ""))}
    elif rpc in ("OnClientConnect", "OnClientConnack"):
        # these two carry ConnInfo (not ClientInfo) + connack's
        # result_code; the hook ships positional args through the
        # notify shape
        plain = args.get("args") or []
        dicts = [a for a in plain if isinstance(a, dict)]
        ci = dicts[0] if dicts else (args.get("conninfo") or {})
        peer = str(ci.get("peerhost") or ci.get("peername") or "")
        host, _, port = peer.rpartition(":")
        conninfo = {"clientid": str(ci.get("clientid") or ""),
                    "username": str(ci.get("username") or ""),
                    "peerhost": host or peer,
                    "proto_name": str(ci.get("proto_name") or "MQTT"),
                    "proto_ver": str(ci.get("proto_ver") or ""),
                    "node": "emqx_tpu@127.0.0.1"}
        if port.isdigit():
            conninfo["sockport"] = int(port)
        if ci.get("keepalive"):
            conninfo["keepalive"] = int(ci["keepalive"])
        v["conninfo"] = conninfo
        if rpc == "OnClientConnack":
            rcs = [a for a in plain if isinstance(a, (int, str))
                   and not isinstance(a, bool)]
            rc = rcs[0] if rcs else args.get("result_code", 0)
            v["result_code"] = ("success" if rc in (0, "0", "success")
                                else str(rc))
    elif rpc == "OnClientAuthenticate":
        v["clientinfo"] = _pb_clientinfo(args.get("clientinfo") or {})
    elif rpc == "OnClientAuthorize":
        v["clientinfo"] = _pb_clientinfo(args.get("clientinfo") or {})
        v["type"] = _ENUM_TYPE.get(str(args.get("type", "publish")), 0)
        v["topic"] = str(args.get("topic", ""))
    elif rpc in ("OnMessagePublish", "OnMessageDropped"):
        v["message"] = _pb_message(args.get("message") or {})
        if args.get("reason"):
            v["reason"] = str(args["reason"])
    elif rpc in ("OnMessageDelivered", "OnMessageAcked"):
        v["clientinfo"] = _pb_clientinfo(args.get("clientinfo") or {})
        v["message"] = _pb_message(args.get("message") or {})
    else:
        # notify RPCs: the framed transport ships {"args": [...]} — pick
        # out recognizable positional payloads for the proto fields
        plain = args.get("args") or []
        dicts = [a for a in plain if isinstance(a, dict)]
        strs = [a for a in plain if isinstance(a, str)]
        if dicts:
            first = dicts[0]
            if "topic" in first and "payload" in first:
                v["message"] = _pb_message(first)
            else:
                v["clientinfo"] = _pb_clientinfo(first)
        if strs and rpc in ("OnClientDisconnected", "OnSessionTerminated"):
            v["reason"] = strs[0]
        elif strs and rpc in ("OnSessionSubscribed",
                              "OnSessionUnsubscribed"):
            v["topic"] = strs[0]
            if rpc == "OnSessionSubscribed" and len(dicts) > 1:
                v["subopts"] = {k: dicts[1][k] for k in
                                ("qos", "rh", "rap", "nl")
                                if isinstance(dicts[1].get(k), int)}
    schema = REQUEST_SCHEMAS[rpc]
    return encode(schema, {k: x for k, x in v.items()
                           if any(s[0] == k for s in schema.values())})


def parse_response(rpc: str, data: bytes) -> Any:
    """response bytes → the framed-transport result shape the
    ExhookMgr logic consumes."""
    if rpc == "OnProviderLoaded":
        resp = decode(LOADED_RESPONSE, data)
        return {"hooks": [h["name"] for h in resp.get("hooks", [])]}
    if rpc in VALUED_RPCS:
        resp = decode(VALUED_RESPONSE, data)
        out: dict[str, Any] = {
            "type": _TYPE_NAMES.get(resp.get("type", 0), "CONTINUE")}
        value: dict[str, Any] = {}
        if "message" in resp and resp["message"] is not None:
            pm = resp["message"]
            if (pm.get("headers") or {}).get("allow_publish") == "false":
                value["drop"] = True
            else:
                value["message"] = _from_pb_message(pm)
        else:
            value["result"] = bool(resp.get("bool_result"))
        out["value"] = value
        return out
    return {}                                   # EmptySuccess
