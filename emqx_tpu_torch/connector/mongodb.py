"""MongoDB connector — the ``emqx_connector_mongo`` analogue.

A from-scratch OP_MSG (opcode 2013) client with a minimal BSON codec
(documents, strings, int32/64, double, bool, null, arrays, embedded
docs, binary) — the modern command protocol every supported server
speaks. Commands are plain documents (``find``/``insert``/``update``
with ``$db``), replies are single kind-0 body sections.

``MiniMongo`` is the in-repo miniature backend for tests: real OP_MSG
framing + BSON over dict collections, answering ``hello``/``ping``/
``find`` (equality filters)/``insert``. Auth is unauthenticated, the
reference's default mongo topology for authn tests.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Any, Optional

from emqx_tpu_torch.resource.resource import Resource


class MongoError(Exception):
    pass


# ---------------------------------------------------------------------------
# minimal BSON


def bson_encode(doc: dict) -> bytes:
    body = b"".join(_enc_elem(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _enc_elem(key: str, v: Any) -> bytes:
    k = key.encode() + b"\x00"
    if isinstance(v, bool):
        return b"\x08" + k + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + k + struct.pack("<i", v)
        return b"\x12" + k + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + k + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"\x02" + k + struct.pack("<i", len(b) + 1) + b + b"\x00"
    if isinstance(v, bytes):
        return b"\x05" + k + struct.pack("<i", len(v)) + b"\x00" + v
    if v is None:
        return b"\x0a" + k
    if isinstance(v, dict):
        return b"\x03" + k + bson_encode(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + k + bson_encode(
            {str(i): x for i, x in enumerate(v)})
    raise MongoError(f"unsupported BSON type {type(v).__name__}")


def bson_decode(data: bytes, pos: int = 0) -> tuple[dict, int]:
    (ln,) = struct.unpack_from("<i", data, pos)
    end = pos + ln - 1
    pos += 4
    out: dict = {}
    while pos < end:
        t = data[pos]
        pos += 1
        z = data.index(b"\x00", pos)
        key = data[pos:z].decode()
        pos = z + 1
        if t == 0x01:
            (out[key],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif t == 0x02:
            (sl,) = struct.unpack_from("<i", data, pos)
            out[key] = data[pos + 4:pos + 4 + sl - 1].decode()
            pos += 4 + sl
        elif t in (0x03, 0x04):
            sub, pos = bson_decode(data, pos)
            out[key] = (list(sub.values()) if t == 0x04 else sub)
        elif t == 0x05:
            (bl,) = struct.unpack_from("<i", data, pos)
            out[key] = data[pos + 5:pos + 5 + bl]
            pos += 5 + bl
        elif t == 0x08:
            out[key] = data[pos] == 1
            pos += 1
        elif t == 0x0A:
            out[key] = None
        elif t == 0x10:
            (out[key],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif t == 0x12:
            (out[key],) = struct.unpack_from("<q", data, pos)
            pos += 8
        elif t == 0x07:                       # ObjectId — keep raw
            out[key] = data[pos:pos + 12]
            pos += 12
        elif t == 0x11:                       # timestamp
            (out[key],) = struct.unpack_from("<q", data, pos)
            pos += 8
        else:
            raise MongoError(f"unsupported BSON element type 0x{t:02x}")
    return out, end + 1


# ---------------------------------------------------------------------------
# OP_MSG framing

OP_MSG = 2013


def _op_msg(doc: dict, request_id: int, response_to: int = 0) -> bytes:
    body = struct.pack("<I", 0) + b"\x00" + bson_encode(doc)
    return struct.pack("<iiii", len(body) + 16, request_id,
                       response_to, OP_MSG) + body


def _parse_op_msg(payload: bytes) -> dict:
    # flagBits(4) + kind byte; kind 0 = single body document
    if payload[4] != 0:
        raise MongoError("only kind-0 OP_MSG sections supported")
    doc, _ = bson_decode(payload, 5)
    return doc


class MongoClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 database: str = "mqtt", timeout_s: float = 5.0) -> None:
        self.addr = (host, port)
        self.database = database
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._req = 0
        self._lock = threading.Lock()

    def _exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("mongo closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def command(self, doc: dict) -> dict:
        """Run one database command; raises MongoError on ok: 0."""
        doc = {**doc}
        doc.setdefault("$db", self.database)
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._sock = socket.create_connection(
                            self.addr, self.timeout_s)
                        self._sock.settimeout(self.timeout_s)
                        self._buf = b""
                    self._req += 1
                    self._sock.sendall(_op_msg(doc, self._req))
                    head = self._exact(16)
                    (ln, _rid, _rto, op) = struct.unpack("<iiii", head)
                    payload = self._exact(ln - 16)
                    break
                except (OSError, ConnectionError):
                    self.close()
                    if attempt:
                        raise
            if op != OP_MSG:
                raise MongoError(f"unexpected opcode {op}")
            reply = _parse_op_msg(payload)
            if not reply.get("ok"):
                raise MongoError(reply.get("errmsg", "command failed"))
            return reply

    def find(self, collection: str, filter_: dict) -> list[dict]:
        reply = self.command({"find": collection, "filter": filter_})
        return reply.get("cursor", {}).get("firstBatch", [])

    def insert(self, collection: str, docs: list[dict]) -> int:
        reply = self.command({"insert": collection, "documents": docs})
        return int(reply.get("n", 0))

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._buf = b""


class MongoConnector(Resource):
    def __init__(self, **kw: Any) -> None:
        self.client = MongoClient(**kw)

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(f"mongodb {self.client.addr} unreachable")

    def on_stop(self) -> None:
        self.client.close()

    def on_query(self, req: Any) -> Any:
        try:
            if isinstance(req, dict) and "find" in req:
                return self.client.find(req["find"],
                                        req.get("filter", {}))
            if isinstance(req, dict) and "insert" in req:
                return self.client.insert(req["insert"],
                                          req.get("documents", []))
            return self.client.command(dict(req))
        except (OSError, ConnectionError) as e:
            raise ConnectionError(str(e)) from None

    def on_health_check(self) -> bool:
        try:
            return bool(self.client.command({"ping": 1}).get("ok"))
        except (OSError, ConnectionError, MongoError):
            return False


# ---------------------------------------------------------------------------
# in-repo miniature server (test backend)


class MiniMongo:
    """OP_MSG subset over dict collections: hello/ping/find (equality
    filter)/insert."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.collections: dict[str, list[dict]] = {}
        mini = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    mini._session(self.request)
                except (ConnectionError, OSError):
                    pass

        class _S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _S((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _session(self, sock: socket.socket) -> None:
        buf = b""

        def exact(n: int) -> bytes:
            nonlocal buf
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError
                buf += chunk
            out, rest = buf[:n], buf[n:]
            buf = rest
            return out

        while True:
            head = exact(16)
            (ln, rid, _rto, op) = struct.unpack("<iiii", head)
            payload = exact(ln - 16)
            if op != OP_MSG:
                return
            try:
                cmd = _parse_op_msg(payload)
                reply = self._run(cmd)
            except Exception as e:   # noqa: BLE001 — protocol reply
                reply = {"ok": 0.0, "errmsg": str(e)}
            sock.sendall(_op_msg(reply, 0, rid))

    def _run(self, cmd: dict) -> dict:
        name = next(iter(cmd))
        if name in ("hello", "isMaster", "ismaster"):
            return {"isWritablePrimary": True, "maxWireVersion": 17,
                    "minWireVersion": 0, "ok": 1.0}
        if name == "ping":
            return {"ok": 1.0}
        if name == "find":
            coll = self.collections.get(cmd["find"], [])
            filt = cmd.get("filter", {}) or {}
            batch = [d for d in coll
                     if all(d.get(k) == v for k, v in filt.items())]
            return {"cursor": {"id": 0, "ns": f"mqtt.{cmd['find']}",
                               "firstBatch": batch}, "ok": 1.0}
        if name == "insert":
            docs = cmd.get("documents", [])
            self.collections.setdefault(cmd["insert"], []).extend(docs)
            return {"n": len(docs), "ok": 1.0}
        raise MongoError(f"no such command: '{name}'")

    def start(self) -> "MiniMongo":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mini-mongo")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
