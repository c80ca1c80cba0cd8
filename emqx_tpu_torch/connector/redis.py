"""Redis connector — the ``emqx_connector_redis`` (eredis) analogue.

A from-scratch RESP2 client over a blocking socket (no external deps):
commands go out as RESP arrays, replies parse simple strings, errors,
integers, bulk and multi-bulk. Query shape: ``{"cmd": ["HGETALL", key]}``
or a raw list. The in-repo ``MiniRedis`` server below backs the tests
the way the reference's CI uses a real Redis container (SURVEY.md §4.5 —
real backends, not mocks; ours is a protocol-faithful miniature).
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Any, Optional

from emqx_tpu_torch.resource.resource import Resource


class RedisError(Exception):
    pass


def encode_command(args: list) -> bytes:
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        b = a if isinstance(a, bytes) else str(a).encode()
        out.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
    return b"".join(out)


class _RespReader:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = b""

    def _line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _exactly(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def read(self) -> Any:
        line = self._line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RedisError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._exactly(n)
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self.read() for _ in range(n)]
        raise RedisError(f"bad RESP type byte {t!r}")


class RedisClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: Optional[str] = None, db: int = 0,
                 timeout_s: float = 5.0) -> None:
        self.addr = (host, port)
        self.password = password
        self.db = db
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[_RespReader] = None
        self._lock = threading.Lock()

    def _connect(self) -> None:
        self._sock = socket.create_connection(self.addr, self.timeout_s)
        self._sock.settimeout(self.timeout_s)
        self._reader = _RespReader(self._sock)
        if self.password:
            self._do(["AUTH", self.password])
        if self.db:
            self._do(["SELECT", self.db])

    def _do(self, args: list) -> Any:
        self._sock.sendall(encode_command(args))
        return self._reader.read()

    # Commands that are safe to resend after an ambiguous failure (the
    # request may or may not have executed server-side).  Write commands
    # (LPUSH/INCR/SET...) are excluded: a reply-phase drop after the
    # request was written would make a blind retry execute them twice.
    _IDEMPOTENT = frozenset({
        "PING", "GET", "MGET", "EXISTS", "TYPE", "TTL", "PTTL", "STRLEN",
        "HGET", "HMGET", "HGETALL", "HLEN", "HEXISTS", "HKEYS", "HVALS",
        "LRANGE", "LLEN", "LINDEX", "SMEMBERS", "SISMEMBER", "SCARD",
        "ZRANGE", "ZSCORE", "ZCARD", "KEYS", "SCAN", "INFO", "TIME",
        "SELECT", "AUTH",
    })

    def command(self, args: list) -> Any:
        with self._lock:
            connecting = self._sock is None
            try:
                if connecting:
                    try:
                        self._connect()
                    except (OSError, ConnectionError):
                        self.close()
                        raise
                request_written = False
                try:
                    self._sock.sendall(encode_command(args))
                    request_written = True
                    return self._reader.read()
                except (OSError, ConnectionError):
                    self.close()
                    if connecting:
                        raise
                    # Stale pooled connection (server restarted, idle
                    # drop): retry once on a fresh connection — but only
                    # when the failure provably preceded the request
                    # (nothing written yet) or the command is idempotent.
                    # A non-idempotent command that may already have
                    # executed must surface the error to the caller.
                    cmd = str(args[0]).upper() if args else ""
                    if request_written and cmd not in self._IDEMPOTENT:
                        raise
                    try:
                        self._connect()
                        return self._do(args)
                    except (OSError, ConnectionError, RedisError):
                        self.close()
                        raise
            except RedisError:
                if connecting:
                    # handshake rejection (AUTH/SELECT error, -LOADING):
                    # drop the half-set-up socket so the next command
                    # retries the full handshake instead of running
                    # unauthenticated forever
                    self.close()
                raise

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._reader = None


class RedisConnector(Resource):
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: Optional[str] = None, db: int = 0,
                 timeout_s: float = 5.0) -> None:
        self.client = RedisClient(host, port, password, db, timeout_s)

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(f"redis {self.client.addr} unreachable")

    def on_stop(self) -> None:
        self.client.close()

    def on_query(self, req: Any) -> Any:
        cmd = req["cmd"] if isinstance(req, dict) else req
        try:
            return self.client.command(list(cmd))
        except (OSError, ConnectionError) as e:
            raise ConnectionError(str(e)) from None

    def on_health_check(self) -> bool:
        try:
            return self.client.command(["PING"]) == "PONG"
        except (OSError, ConnectionError, RedisError):
            return False


# ---------------------------------------------------------------------------
# in-repo miniature server (test backend)


class MiniRedis:
    """Protocol-faithful subset: PING/AUTH/SELECT/GET/SET/DEL/HSET/HGET/
    HGETALL/SMEMBERS/SADD/EXISTS — what the authn/authz/bridge paths use."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: Optional[str] = None) -> None:
        self.data: dict[bytes, Any] = {}
        self.password = password
        store = self.data
        required = password

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                reader = _RespReader(self.request)
                authed = required is None
                while True:
                    try:
                        args = reader.read()
                    except (ConnectionError, OSError):
                        return
                    except RedisError:
                        # malformed RESP from the client: reply -ERR and
                        # drop (protocol state is unrecoverable)
                        try:
                            self.request.sendall(b"-ERR protocol error\r\n")
                        except OSError:
                            pass
                        return
                    if not isinstance(args, list) or not args:
                        continue
                    cmd = bytes(args[0]).upper()
                    try:
                        if cmd == b"AUTH":
                            if required is not None and bytes(
                                    args[1]).decode() == required:
                                authed = True
                                resp = b"+OK\r\n"
                            else:
                                resp = b"-ERR invalid password\r\n"
                        elif not authed:
                            resp = b"-NOAUTH Authentication required.\r\n"
                        else:
                            resp = MiniRedis._exec(store, cmd, args[1:])
                    except Exception as e:   # noqa: BLE001 — protocol error
                        resp = f"-ERR {e}\r\n".encode()
                    try:
                        self.request.sendall(resp)
                    except OSError:
                        return

        class _S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _S((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _bulk(v: Optional[bytes]) -> bytes:
        if v is None:
            return b"$-1\r\n"
        return f"${len(v)}\r\n".encode() + v + b"\r\n"

    @staticmethod
    def _array(items: list[bytes]) -> bytes:
        return (f"*{len(items)}\r\n".encode()
                + b"".join(MiniRedis._bulk(i) for i in items))

    @staticmethod
    def _exec(store: dict, cmd: bytes, args: list) -> bytes:
        a = [bytes(x) for x in args]
        if cmd == b"PING":
            return b"+PONG\r\n"
        if cmd == b"SELECT":
            return b"+OK\r\n"
        if cmd == b"SET":
            store[a[0]] = a[1]
            return b"+OK\r\n"
        if cmd == b"GET":
            v = store.get(a[0])
            return MiniRedis._bulk(v if isinstance(v, bytes) else None)
        if cmd == b"DEL":
            n = sum(1 for k in a if store.pop(k, None) is not None)
            return f":{n}\r\n".encode()
        if cmd == b"EXISTS":
            return f":{sum(1 for k in a if k in store)}\r\n".encode()
        if cmd == b"HSET":
            h = store.setdefault(a[0], {})
            n = 0
            for i in range(1, len(a) - 1, 2):
                n += a[i] not in h
                h[a[i]] = a[i + 1]
            return f":{n}\r\n".encode()
        if cmd == b"HGET":
            h = store.get(a[0]) or {}
            return MiniRedis._bulk(h.get(a[1]))
        if cmd == b"HGETALL":
            h = store.get(a[0]) or {}
            flat: list[bytes] = []
            for k, v in h.items():
                flat += [k, v]
            return MiniRedis._array(flat)
        if cmd == b"SADD":
            s = store.setdefault(a[0], set())
            n = sum(1 for m in a[1:] if m not in s)
            s.update(a[1:])
            return f":{n}\r\n".encode()
        if cmd == b"SMEMBERS":
            return MiniRedis._array(sorted(store.get(a[0]) or set()))
        return f"-ERR unknown command '{cmd.decode()}'\r\n".encode()

    def start(self) -> "MiniRedis":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mini-redis")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
