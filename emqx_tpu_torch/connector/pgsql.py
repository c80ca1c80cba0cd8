"""PostgreSQL connector — the ``emqx_connector_pgsql`` (epgsql) analogue.

A from-scratch v3 wire-protocol client (no external deps), simple-query
flow only: StartupMessage → Authentication (trust, cleartext or MD5) →
ReadyForQuery; ``Query`` messages return text-format rows parsed from
RowDescription/DataRow/CommandComplete. The reference uses prepared
statements (epgsql equery); here placeholders substitute client-side
with literal quoting — same observable queries, no second round trip.

``MiniPg`` is the in-repo miniature backend for tests (SURVEY §4.5:
real wire protocols, not mocks): startup + cleartext auth + a tiny SQL
engine over dict tables (SELECT ... WHERE col = 'v' [AND ...] /
INSERT INTO ... VALUES).
"""

from __future__ import annotations

import hashlib
import re
import socket
import socketserver
import struct
import threading
from typing import Any, Optional

from emqx_tpu_torch.resource.resource import Resource


class PgError(Exception):
    pass


def quote_literal(v: Any) -> str:
    """Escape a value as a SQL literal (client-side parameterization)."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, bytes):
        v = v.decode("utf-8", "replace")
    return "'" + str(v).replace("'", "''").replace("\\", "\\\\") + "'"


def render_sql(template: str, binds: dict) -> str:
    """``${username}``-style placeholder substitution with quoting."""
    def sub(m):
        return quote_literal(binds.get(m.group(1), ""))
    return re.sub(r"\$\{(\w+)\}", sub, template)


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


class PgClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5432,
                 user: str = "postgres", password: str = "",
                 database: str = "mqtt", timeout_s: float = 5.0) -> None:
        self.addr = (host, port)
        self.user, self.password, self.database = user, password, database
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()

    # -- wire ----------------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("pg closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_msg(self) -> tuple[bytes, bytes]:
        head = self._read_exact(5)
        tag = head[:1]
        (ln,) = struct.unpack(">I", head[1:5])
        return tag, self._read_exact(ln - 4)

    def _connect(self) -> None:
        self._sock = socket.create_connection(self.addr, self.timeout_s)
        self._sock.settimeout(self.timeout_s)
        self._buf = b""
        params = (f"user\0{self.user}\0database\0{self.database}\0\0"
                  .encode())
        startup = struct.pack(">I", 196608) + params      # protocol 3.0
        self._sock.sendall(struct.pack(">I", len(startup) + 4) + startup)
        while True:
            tag, body = self._read_msg()
            if tag == b"R":
                (kind,) = struct.unpack(">I", body[:4])
                if kind == 0:
                    continue                               # AuthenticationOk
                if kind == 3:                              # cleartext
                    self._sock.sendall(
                        _msg(b"p", self.password.encode() + b"\0"))
                elif kind == 5:                            # MD5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._sock.sendall(
                        _msg(b"p", b"md5" + outer.encode() + b"\0"))
                else:
                    raise PgError(f"unsupported auth method {kind}")
            elif tag in (b"S", b"K", b"N"):
                continue            # ParameterStatus/BackendKeyData/Notice
            elif tag == b"Z":
                return              # ReadyForQuery
            elif tag == b"E":
                raise PgError(self._err_text(body))
            else:
                raise PgError(f"unexpected startup message {tag!r}")

    @staticmethod
    def _err_text(body: bytes) -> str:
        fields = {}
        for part in body.split(b"\0"):
            if part:
                fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
        return fields.get("M", "error")

    # -- API -----------------------------------------------------------------

    def query(self, sql: str) -> tuple[list[str], list[list]]:
        """Simple query → (column names, rows of str|None). Retries once
        on a stale pooled connection before the request is written."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(_msg(b"Q", sql.encode() + b"\0"))
                    break
                except (OSError, ConnectionError):
                    self.close()
                    if attempt:
                        raise
            cols: list[str] = []
            rows: list[list] = []
            err: Optional[str] = None
            try:
                while True:
                    tag, body = self._read_msg()
                    if tag == b"T":
                        cols = self._parse_cols(body)
                    elif tag == b"D":
                        rows.append(self._parse_row(body))
                    elif tag == b"E":
                        err = self._err_text(body)
                    elif tag in (b"C", b"N", b"S"):
                        continue
                    elif tag == b"Z":
                        break
            except (OSError, ConnectionError):
                self.close()
                raise
            if err is not None:
                raise PgError(err)
            return cols, rows

    @staticmethod
    def _parse_cols(body: bytes) -> list[str]:
        (n,) = struct.unpack(">H", body[:2])
        cols, pos = [], 2
        for _ in range(n):
            end = body.index(b"\0", pos)
            cols.append(body[pos:end].decode())
            pos = end + 1 + 18          # skip the fixed field descriptor
        return cols

    @staticmethod
    def _parse_row(body: bytes) -> list:
        (n,) = struct.unpack(">H", body[:2])
        out, pos = [], 2
        for _ in range(n):
            (ln,) = struct.unpack(">i", body[pos:pos + 4])
            pos += 4
            if ln == -1:
                out.append(None)
            else:
                out.append(body[pos:pos + ln].decode("utf-8", "replace"))
                pos += ln
        return out

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._buf = b""


class PgConnector(Resource):
    """Resource wrapper: query templates with ${placeholders}
    (emqx_connector_pgsql.erl's prepared-statement surface)."""

    def __init__(self, **kw: Any) -> None:
        self.client = PgClient(**kw)

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(f"pgsql {self.client.addr} unreachable")

    def on_stop(self) -> None:
        self.client.close()

    def on_query(self, req: Any) -> Any:
        sql = req["sql"] if isinstance(req, dict) else str(req)
        binds = req.get("binds", {}) if isinstance(req, dict) else {}
        try:
            return self.client.query(render_sql(sql, binds))
        except (OSError, ConnectionError) as e:
            raise ConnectionError(str(e)) from None

    def on_health_check(self) -> bool:
        try:
            self.client.query("SELECT 1")
            return True
        except (OSError, ConnectionError, PgError):
            return False


# ---------------------------------------------------------------------------
# in-repo miniature server (test backend)


_SELECT_RE = re.compile(
    r"^\s*SELECT\s+(?P<cols>.+?)\s+FROM\s+(?P<table>\w+)"
    r"(?:\s+WHERE\s+(?P<where>.+?))?\s*;?\s*$", re.I | re.S)
_INSERT_RE = re.compile(
    r"^\s*INSERT\s+INTO\s+(?P<table>\w+)\s*\((?P<cols>[^)]*)\)\s*"
    r"VALUES\s*\((?P<vals>.*)\)\s*;?\s*$", re.I | re.S)
_COND_RE = re.compile(r"(\w+)\s*=\s*('(?:[^']|'')*'|\d+)")


def _unquote(tok: str) -> str:
    tok = tok.strip()
    if tok.startswith("'") and tok.endswith("'"):
        return tok[1:-1].replace("''", "'")
    return tok


class MiniPg:
    """Startup + cleartext-auth + simple-query subset over dict tables:
    ``tables = {name: [ {col: val} ]}``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: Optional[str] = None) -> None:
        self.tables: dict[str, list[dict]] = {}
        self.password = password
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

    # -- session -------------------------------------------------------------

    def _session(self, sock: socket.socket) -> None:
        buf = b""

        def read_exact(n: int) -> bytes:
            nonlocal buf
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError
                buf += chunk
            out, rest = buf[:n], buf[n:]
            buf = rest
            return out

        (ln,) = struct.unpack(">I", read_exact(4))
        startup = read_exact(ln - 4)
        (proto,) = struct.unpack(">I", startup[:4])
        if proto == 80877103:          # SSLRequest → refuse, retry plain
            sock.sendall(b"N")
            (ln,) = struct.unpack(">I", read_exact(4))
            startup = read_exact(ln - 4)
        if self.password is not None:
            sock.sendall(_msg(b"R", struct.pack(">I", 3)))   # cleartext
            tag = read_exact(1)
            (ln,) = struct.unpack(">I", read_exact(4))
            body = read_exact(ln - 4)
            if tag != b"p" or body.rstrip(b"\0").decode() != self.password:
                sock.sendall(_msg(b"E", b"SERROR\0C28P01\0"
                                  b"Mpassword authentication failed\0\0"))
                return
        sock.sendall(_msg(b"R", struct.pack(">I", 0)))       # Ok
        sock.sendall(_msg(b"Z", b"I"))
        while True:
            tag = read_exact(1)
            (ln,) = struct.unpack(">I", read_exact(4))
            body = read_exact(ln - 4)
            if tag == b"X":            # Terminate
                return
            if tag != b"Q":
                sock.sendall(_msg(b"E", b"SERROR\0C0A000\0"
                                  b"Msimple query only\0\0"))
                sock.sendall(_msg(b"Z", b"I"))
                continue
            sql = body.rstrip(b"\0").decode("utf-8", "replace")
            try:
                sock.sendall(self._run(sql))
            except Exception as e:     # noqa: BLE001 — surfaced as pg error
                sock.sendall(_msg(
                    b"E", b"SERROR\0C42601\0M" + str(e).encode() + b"\0\0"))
            sock.sendall(_msg(b"Z", b"I"))

    # -- the tiny SQL engine -------------------------------------------------

    def _run(self, sql: str) -> bytes:
        if sql.strip().upper().startswith("SELECT 1"):
            return self._result(["?column?"], [["1"]])
        m = _SELECT_RE.match(sql)
        if m:
            table = self.tables.get(m.group("table").lower(), [])
            conds = []
            if m.group("where"):
                conds = [(c, _unquote(v))
                         for c, v in _COND_RE.findall(m.group("where"))]
            cols = [c.strip() for c in m.group("cols").split(",")]
            rows = []
            for rec in table:
                if all(str(rec.get(c, "")) == v for c, v in conds):
                    if cols == ["*"]:
                        cols = list(rec)
                    rows.append([None if rec.get(c) is None
                                 else str(rec.get(c, "")) for c in cols])
            return self._result(cols if cols != ["*"] else [], rows)
        m = _INSERT_RE.match(sql)
        if m:
            cols = [c.strip() for c in m.group("cols").split(",")]
            vals = [_unquote(v) for v in
                    re.findall(r"'(?:[^']|'')*'|[^,]+", m.group("vals"))]
            self.tables.setdefault(m.group("table").lower(), []).append(
                dict(zip(cols, vals)))
            return _msg(b"C", b"INSERT 0 1\0")
        raise PgError(f"unsupported SQL: {sql[:60]}")

    @staticmethod
    def _result(cols: list[str], rows: list[list]) -> bytes:
        out = []
        desc = struct.pack(">H", len(cols))
        for c in cols:
            desc += c.encode() + b"\0" + struct.pack(
                ">IHIHiH", 0, 0, 25, -1 & 0xFFFF, -1, 0)
        out.append(_msg(b"T", desc))
        for row in rows:
            body = struct.pack(">H", len(row))
            for v in row:
                if v is None:
                    body += struct.pack(">i", -1)
                else:
                    b = str(v).encode()
                    body += struct.pack(">i", len(b)) + b
            out.append(_msg(b"D", body))
        out.append(_msg(b"C", f"SELECT {len(rows)}\0".encode()))
        return b"".join(out)

    def start(self) -> "MiniPg":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="mini-pg")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
