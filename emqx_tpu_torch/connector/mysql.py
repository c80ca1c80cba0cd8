"""MySQL connector — the ``emqx_connector_mysql`` analogue.

A from-scratch client-server protocol implementation (no external deps):
HandshakeV10 → HandshakeResponse41 with ``mysql_native_password``
(SHA1(pw) ⊕ SHA1(scramble ∥ SHA1(SHA1(pw)))) → COM_QUERY text
resultsets (column definitions + rows as length-encoded strings,
EOF-terminated). Placeholders substitute client-side with literal
quoting, mirroring the observable queries of the reference's prepared
statements.

``MiniMySQL`` is the in-repo miniature backend for tests: real
handshake + scramble verification + the same tiny SQL engine as MiniPg.
"""

from __future__ import annotations

import hashlib
import os
import re
import socket
import socketserver
import struct
import threading
from typing import Any, Optional

from emqx_tpu_torch.connector.pgsql import (_COND_RE, _INSERT_RE, _SELECT_RE,
                                      _unquote, render_sql)
from emqx_tpu_torch.resource.resource import Resource

CLIENT_LONG_PASSWORD = 0x0001
CLIENT_PROTOCOL_41 = 0x0200
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x00080000

_CAPS = CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41 | \
    CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH


class MySqlError(Exception):
    pass


def native_password(password: str, scramble: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(scramble + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _lenenc(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


class _Conn:
    """Packet-framed socket (3-byte little-endian length + sequence id)."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = b""
        self.seq = 0

    def _exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("mysql closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def read(self) -> bytes:
        head = self._exact(4)
        ln = int.from_bytes(head[:3], "little")
        self.seq = head[3] + 1
        return self._exact(ln)

    def write(self, payload: bytes) -> None:
        self.sock.sendall(
            len(payload).to_bytes(3, "little") + bytes([self.seq & 0xFF])
            + payload)
        self.seq += 1


def _read_lenenc(data: bytes, pos: int) -> tuple[Optional[int], int]:
    b0 = data[pos]
    if b0 < 0xFB:
        return b0, pos + 1
    if b0 == 0xFB:
        return None, pos + 1                       # NULL
    if b0 == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if b0 == 0xFD:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9


class MySqlClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "mqtt", timeout_s: float = 5.0) -> None:
        self.addr = (host, port)
        self.user, self.password, self.database = user, password, database
        self.timeout_s = timeout_s
        self._conn: Optional[_Conn] = None
        self._lock = threading.Lock()

    def _connect(self) -> None:
        sock = socket.create_connection(self.addr, self.timeout_s)
        sock.settimeout(self.timeout_s)
        conn = _Conn(sock)
        greet = conn.read()
        if greet[:1] == b"\xff":
            raise MySqlError(greet[9:].decode("utf-8", "replace"))
        pos = 1
        end = greet.index(b"\0", pos)              # server version
        pos = end + 1 + 4                          # thread id
        scramble = greet[pos:pos + 8]
        pos += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10      # filler..reserved
        scramble += greet[pos:pos + 12]            # part 2 (12 of 13)
        auth = native_password(self.password, scramble)
        resp = struct.pack("<IIB", _CAPS, 1 << 24, 0x21) + b"\0" * 23
        resp += self.user.encode() + b"\0"
        resp += bytes([len(auth)]) + auth
        resp += b"mysql_native_password\0"
        conn.write(resp)
        ok = conn.read()
        if ok[:1] == b"\xff":
            raise MySqlError(ok[9:].decode("utf-8", "replace"))
        self._conn = conn
        if self.database:
            self._query_locked(f"USE {self.database}")

    def query(self, sql: str) -> tuple[list[str], list[list]]:
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._connect()
                    return self._query_locked(sql)
                except (OSError, ConnectionError):
                    self.close()
                    if attempt:
                        raise
            raise ConnectionError("unreachable")

    def _query_locked(self, sql: str) -> tuple[list[str], list[list]]:
        conn = self._conn
        conn.seq = 0
        conn.write(b"\x03" + sql.encode())
        first = conn.read()
        if first[:1] == b"\xff":
            raise MySqlError(first[9:].decode("utf-8", "replace"))
        if first[:1] == b"\x00":                   # OK packet (no resultset)
            return [], []
        ncols, _ = _read_lenenc(first, 0)
        cols = []
        for _ in range(ncols):
            d = conn.read()
            # catalog, schema, table, org_table, name, org_name (lenenc strs)
            pos = 0
            vals = []
            for _f in range(6):
                ln, pos = _read_lenenc(d, pos)
                vals.append(d[pos:pos + (ln or 0)])
                pos += ln or 0
            cols.append(vals[4].decode())
        eof = conn.read()
        assert eof[:1] == b"\xfe"
        rows: list[list] = []
        while True:
            d = conn.read()
            if d[:1] == b"\xfe" and len(d) < 9:    # EOF
                break
            if d[:1] == b"\xff":
                raise MySqlError(d[9:].decode("utf-8", "replace"))
            row, pos = [], 0
            for _ in range(ncols):
                ln, pos = _read_lenenc(d, pos)
                if ln is None:
                    row.append(None)
                else:
                    row.append(d[pos:pos + ln].decode("utf-8", "replace"))
                    pos += ln
            rows.append(row)
        return cols, rows

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.sock.close()
            except OSError:
                pass
        self._conn = None


class MySqlConnector(Resource):
    def __init__(self, **kw: Any) -> None:
        self.client = MySqlClient(**kw)

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(f"mysql {self.client.addr} unreachable")

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
        except (OSError, ConnectionError, MySqlError):
            return False


# ---------------------------------------------------------------------------
# in-repo miniature server (test backend)


class MiniMySQL:
    """HandshakeV10 + native-password verification + the tiny SQL engine
    (same dict tables as MiniPg)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 user: str = "root", password: str = "") -> None:
        self.tables: dict[str, list[dict]] = {}
        self.user, self.password = user, password
        mini = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    mini._session(_Conn(self.request))
                except (ConnectionError, OSError):
                    pass

        class _S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _S((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _session(self, conn: _Conn) -> None:
        scramble = os.urandom(20)
        greet = (b"\x0a" + b"8.0-mini\0" + struct.pack("<I", 1)
                 + scramble[:8] + b"\0"
                 + struct.pack("<H", _CAPS & 0xFFFF) + b"\x21"
                 + struct.pack("<H", 2)
                 + struct.pack("<H", (_CAPS >> 16) & 0xFFFF)
                 + bytes([21]) + b"\0" * 10
                 + scramble[8:] + b"\0"
                 + b"mysql_native_password\0")
        conn.write(greet)
        resp = conn.read()
        pos = 4 + 4 + 1 + 23
        end = resp.index(b"\0", pos)
        user = resp[pos:end].decode()
        pos = end + 1
        alen = resp[pos]
        auth = resp[pos + 1:pos + 1 + alen]
        want = native_password(self.password, scramble)
        if user != self.user or auth != want:
            conn.write(b"\xff" + struct.pack("<H", 1045) + b"#28000"
                       + b"Access denied")
            return
        conn.write(b"\x00\x00\x00\x02\x00\x00\x00")     # OK
        while True:
            conn.seq = 0
            try:
                pkt = conn.read()
            except (ConnectionError, OSError):
                return
            if not pkt or pkt[:1] == b"\x01":            # COM_QUIT
                return
            if pkt[:1] != b"\x03":                       # only COM_QUERY
                conn.write(b"\x00\x00\x00\x02\x00\x00\x00")
                continue
            sql = pkt[1:].decode("utf-8", "replace")
            try:
                self._run(conn, sql)
            except Exception as e:   # noqa: BLE001 — surfaced as mysql err
                conn.write(b"\xff" + struct.pack("<H", 1064) + b"#42000"
                           + str(e).encode())

    def _run(self, conn: _Conn, sql: str) -> None:
        up = sql.strip().upper()
        if up.startswith(("USE ", "SET ")):
            conn.write(b"\x00\x00\x00\x02\x00\x00\x00")
            return
        if up.startswith("SELECT 1"):
            self._result(conn, ["1"], [["1"]])
            return
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
            self._result(conn, cols if cols != ["*"] else [], rows)
            return
        m = _INSERT_RE.match(sql)
        if m:
            cols = [c.strip() for c in m.group("cols").split(",")]
            vals = [_unquote(v) for v in
                    re.findall(r"'(?:[^']|'')*'|[^,]+", m.group("vals"))]
            self.tables.setdefault(m.group("table").lower(), []).append(
                dict(zip(cols, vals)))
            conn.write(b"\x00\x01\x00\x02\x00\x00\x00")  # OK, 1 row
            return
        raise MySqlError(f"unsupported SQL: {sql[:60]}")

    @staticmethod
    def _result(conn: _Conn, cols: list[str], rows: list[list]) -> None:
        conn.write(_lenenc(len(cols)))
        for c in cols:
            name = c.encode()
            d = (_lenenc(3) + b"def" + _lenenc(0) + _lenenc(0) + _lenenc(0)
                 + _lenenc(len(name)) + name + _lenenc(len(name)) + name
                 + b"\x0c" + struct.pack("<HIBHB", 0x21, 255, 253, 0, 0)
                 + b"\0\0")
            conn.write(d)
        conn.write(b"\xfe\x00\x00\x02\x00")              # EOF
        for row in rows:
            out = b""
            for v in row:
                if v is None:
                    out += b"\xfb"
                else:
                    b = str(v).encode()
                    out += _lenenc(len(b)) + b
            conn.write(out)
        conn.write(b"\xfe\x00\x00\x02\x00")              # EOF

    def start(self) -> "MiniMySQL":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mini-mysql")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
