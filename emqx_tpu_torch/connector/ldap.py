"""LDAP connector — the ``emqx_connector_ldap`` analogue.

A from-scratch LDAPv3 client (RFC 4511) over a minimal BER codec:
simple BindRequest, SearchRequest with RFC 4515 filter strings,
UnbindRequest. The reference pools `eldap` connections and exposes
``{search, Base, Filter, Attributes}`` queries
(emqx_connector_ldap.erl:102-118, search/4); this client exposes the
same surface plus ``check_bind`` (re-bind as a looked-up DN), the
classic LDAP password-check primitive its authn integrations use.

``MiniLDAP`` is the in-repo miniature directory for tests: real BER
framing over an in-memory DN tree, answering bind (against
``userPassword``), search (base/one/sub scopes, and/or/not/equality/
presence/substring filters) and unbind — the same role the reference's
docker-compose openldap container plays in CI
(.ci/docker-compose-file/docker-compose-ldap-tcp.yaml).
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Any, Iterable, Optional

from emqx_tpu_torch.resource.resource import Resource


class LdapError(Exception):
    pass


class TruncatedBer(LdapError):
    """More bytes may complete the element — retry after recv().
    Distinct from structural malformation (plain LdapError), which no
    amount of extra bytes can repair; the client must fail fast on the
    latter instead of spinning on recv() until the socket timeout."""


# ---------------------------------------------------------------------------
# minimal BER (definite lengths only — LDAP never needs indefinite)

SEQUENCE = 0x30
SET = 0x31
INTEGER = 0x02
OCTET_STRING = 0x04
ENUMERATED = 0x0A
BOOLEAN = 0x01


def ber(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    lb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(lb)]) + lb + content


def ber_int(v: int, tag: int = INTEGER) -> bytes:
    if v == 0:
        return bytes([tag, 1, 0])
    out = v.to_bytes((v.bit_length() // 8) + 1, "big", signed=True)
    # strip redundant leading 0x00 for positive values that fit
    while len(out) > 1 and out[0] == 0 and out[1] < 0x80:
        out = out[1:]
    return ber(tag, out)


def ber_str(s: str | bytes, tag: int = OCTET_STRING) -> bytes:
    return ber(tag, s.encode() if isinstance(s, str) else s)


def ber_read(data: bytes, pos: int) -> tuple[int, bytes, int]:
    """-> (tag, content, next_pos). Raises TruncatedBer when more bytes
    may complete the element, LdapError on structural malformation."""
    if pos + 2 > len(data):
        raise TruncatedBer("truncated BER header")
    tag = data[pos]
    ln = data[pos + 1]
    pos += 2
    if ln & 0x80:
        k = ln & 0x7F
        if k == 0:            # X.690 8.1.3.6: 0x80 = indefinite form,
            raise LdapError(  # forbidden in LDAP's DER subset
                "reserved/indefinite BER length")
        if pos + k > len(data):
            raise TruncatedBer("truncated BER length")
        ln = int.from_bytes(data[pos:pos + k], "big")
        pos += k
    if pos + ln > len(data):
        raise TruncatedBer("truncated BER content")
    return tag, data[pos:pos + ln], pos + ln


def ber_seq(data: bytes) -> list[tuple[int, bytes]]:
    """Decode all TLVs inside a constructed value."""
    out, pos = [], 0
    while pos < len(data):
        tag, content, pos = ber_read(data, pos)
        out.append((tag, content))
    return out


def _decode_int(content: bytes) -> int:
    return int.from_bytes(content, "big", signed=True)


# ---------------------------------------------------------------------------
# RFC 4515 filter strings -> LDAP Filter BER

_F_AND, _F_OR, _F_NOT = 0xA0, 0xA1, 0xA2
_F_EQ, _F_SUBSTR, _F_GE, _F_LE, _F_PRESENT = 0xA3, 0xA4, 0xA5, 0xA6, 0x87


def parse_filter(s: str) -> bytes:
    """Parse an RFC 4515 filter string into its BER encoding.

    Supports &, |, !, equality, presence (=*), substrings (a=*b*c),
    >= and <= — the operator set the reference's LDAP integrations
    generate.
    """
    out, pos = _parse_filter(s.strip(), 0)
    if pos != len(s.strip()):
        raise LdapError(f"trailing filter input at {pos}")
    return out


def _parse_filter(s: str, pos: int) -> tuple[bytes, int]:
    if pos >= len(s) or s[pos] != "(":
        raise LdapError(f"filter must start with '(' at {pos}")
    pos += 1
    if pos >= len(s):
        raise LdapError("unterminated filter")
    c = s[pos]
    if c in "&|":
        tag = _F_AND if c == "&" else _F_OR
        pos += 1
        subs = []
        while pos < len(s) and s[pos] == "(":
            sub, pos = _parse_filter(s, pos)
            subs.append(sub)
        if not subs:
            raise LdapError("empty and/or filter")
        return _close(s, pos, ber(tag, b"".join(subs)))
    if c == "!":
        sub, pos = _parse_filter(s, pos + 1)
        return _close(s, pos, ber(_F_NOT, sub))
    # item: attr OP value
    end = s.find(")", pos)
    if end < 0:
        raise LdapError("unterminated filter item")
    item = s[pos:end]
    pos = end
    for op, tag in (("<=", _F_LE), (">=", _F_GE), ("=", _F_EQ)):
        k = item.find(op)
        if k > 0:
            attr, val = item[:k], item[k + len(op):]
            break
    else:
        raise LdapError(f"no operator in filter item {item!r}")
    if tag == _F_EQ and val == "*":
        return _close(s, pos, ber_str(attr, _F_PRESENT))
    if tag == _F_EQ and "*" in val:
        parts = val.split("*")
        subs = b""
        if parts[0]:
            subs += ber_str(_unescape(parts[0]), 0x80)      # initial
        for mid in parts[1:-1]:
            if mid:
                subs += ber_str(_unescape(mid), 0x81)       # any
        if parts[-1]:
            subs += ber_str(_unescape(parts[-1]), 0x82)     # final
        return _close(s, pos, ber(
            _F_SUBSTR, ber_str(attr) + ber(SEQUENCE, subs)))
    return _close(s, pos, ber(
        tag, ber_str(attr) + ber_str(_unescape(val))))


def _close(s: str, pos: int, encoded: bytes) -> tuple[bytes, int]:
    if pos >= len(s) or s[pos] != ")":
        raise LdapError(f"expected ')' at {pos}")
    return encoded, pos + 1


def _unescape(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\":
            if i + 3 > len(v):
                raise LdapError("truncated filter escape")
            try:
                out.append(chr(int(v[i + 1:i + 3], 16)))
            except ValueError:
                raise LdapError(
                    f"bad filter escape \\{v[i + 1:i + 3]}") from None
            i += 3
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def ldap_escape(v: str) -> str:
    """RFC 4515 §3 value escaping — for substituting untrusted strings
    (usernames, clientids) into filter templates."""
    return "".join(f"\\{ord(c):02x}" if c in "\\*()\x00" else c for c in v)


# ---------------------------------------------------------------------------
# protocol ops (APPLICATION tags, RFC 4511 §4)

_OP_BIND_REQ, _OP_BIND_RESP = 0x60, 0x61
_OP_UNBIND = 0x42
_OP_SEARCH_REQ = 0x63
_OP_SEARCH_ENTRY, _OP_SEARCH_DONE = 0x64, 0x65

SCOPES = {"base": 0, "one": 1, "sub": 2}

RESULT_SUCCESS = 0
RESULT_INVALID_CREDENTIALS = 49
RESULT_NO_SUCH_OBJECT = 32
RESULT_UNWILLING = 53


def _msg(msg_id: int, op: bytes) -> bytes:
    return ber(SEQUENCE, ber_int(msg_id) + op)


def _bind_request(msg_id: int, dn: str, password: str | bytes) -> bytes:
    body = ber_int(3) + ber_str(dn) + ber_str(password, 0x80)  # simple auth
    return _msg(msg_id, ber(_OP_BIND_REQ, body))


def _search_request(msg_id: int, base: str, scope: str, filt: bytes,
                    attrs: Iterable[str], size_limit: int = 0) -> bytes:
    body = (ber_str(base) + ber_int(SCOPES[scope], ENUMERATED) +
            ber_int(0, ENUMERATED) +                 # neverDerefAliases
            ber_int(size_limit) + ber_int(0) +       # sizeLimit, timeLimit
            bytes([BOOLEAN, 1, 0]) +                 # typesOnly = false
            filt +
            ber(SEQUENCE, b"".join(ber_str(a) for a in attrs)))
    return _msg(msg_id, ber(_OP_SEARCH_REQ, body))


def _result(op_tag: int, code: int, dn: str = "", diag: str = "") -> bytes:
    return ber(op_tag,
               ber_int(code, ENUMERATED) + ber_str(dn) + ber_str(diag))


def _parse_result(content: bytes) -> tuple[int, str]:
    parts = ber_seq(content)
    code = _decode_int(parts[0][1])
    diag = parts[2][1].decode("utf-8", "replace") if len(parts) > 2 else ""
    return code, diag


def _parse_entry(content: bytes) -> tuple[str, dict[str, list[str]]]:
    parts = ber_seq(content)
    dn = parts[0][1].decode("utf-8", "replace")
    attrs: dict[str, list[str]] = {}
    for _tag, pa in ber_seq(parts[1][1]):
        fields = ber_seq(pa)
        name = fields[0][1].decode("utf-8", "replace")
        vals = [v.decode("utf-8", "replace")
                for _t, v in ber_seq(fields[1][1])]
        attrs[name] = vals
    return dn, attrs


# ---------------------------------------------------------------------------
# client


class LdapClient:
    """Blocking LDAPv3 client: connect-and-bind lazily, retry once on a
    dead socket (same discipline as the other wire clients here)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 389,
                 bind_dn: str = "", bind_password: str = "",
                 timeout_s: float = 5.0) -> None:
        self.addr = (host, port)
        self.bind_dn = bind_dn
        self.bind_password = bind_password
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._msg_id = 0
        self._lock = threading.Lock()

    # -- wire --------------------------------------------------------------

    def _connect(self) -> None:
        self._sock = socket.create_connection(self.addr, self.timeout_s)
        self._sock.settimeout(self.timeout_s)
        self._buf = b""
        self._msg_id = 0
        code, diag = self._bind(self.bind_dn, self.bind_password)
        if code != RESULT_SUCCESS:
            self.close()
            raise LdapError(f"bind failed ({code}): {diag}")

    def _recv_msg(self) -> tuple[int, int, bytes]:
        """-> (msg_id, op_tag, op_content)"""
        while True:
            try:
                _tag, content, used = ber_read(self._buf, 0)
            except TruncatedBer:      # only truncation retries; malformed
                chunk = self._sock.recv(65536)   # BER fails fast below
                if not chunk:
                    raise ConnectionError("ldap closed") from None
                self._buf += chunk
                continue
            except LdapError:
                # wire desync is unrecoverable: drop the connection so
                # the next call reconnects instead of replaying the
                # poisoned buffer forever
                self.close()
                raise
            self._buf = self._buf[used:]
            try:
                parts = ber_seq(content)
                msg_id = _decode_int(parts[0][1])
                op_tag, op_content = parts[1][0], parts[1][1]
            except (LdapError, IndexError) as e:
                # a complete outer envelope with malformed content is
                # the same desync — same teardown
                self.close()
                raise LdapError(f"malformed LDAPMessage: {e}") from None
            return msg_id, op_tag, op_content

    def _bind(self, dn: str, password: str | bytes) -> tuple[int, str]:
        self._msg_id += 1
        self._sock.sendall(_bind_request(self._msg_id, dn, password))
        while True:
            mid, op, content = self._recv_msg()
            if mid == self._msg_id and op == _OP_BIND_RESP:
                return _parse_result(content)

    # -- public ------------------------------------------------------------

    def search(self, base: str, filter_: str, attrs: Iterable[str] = (),
               scope: str = "sub") -> list[tuple[str, dict[str, list[str]]]]:
        """{search, Base, Filter, Attributes} — returns [(dn, attrs)]."""
        filt = parse_filter(filter_)
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    self._msg_id += 1
                    self._sock.sendall(_search_request(
                        self._msg_id, base, scope, filt, attrs))
                    entries = []
                    while True:
                        mid, op, content = self._recv_msg()
                        if mid != self._msg_id:
                            continue
                        if op == _OP_SEARCH_ENTRY:
                            entries.append(_parse_entry(content))
                        elif op == _OP_SEARCH_DONE:
                            code, diag = _parse_result(content)
                            if code not in (RESULT_SUCCESS,
                                            RESULT_NO_SUCH_OBJECT):
                                raise LdapError(
                                    f"search failed ({code}): {diag}")
                            return entries
                except (OSError, ConnectionError):
                    self.close()
                    if attempt:
                        raise

    def check_bind(self, dn: str, password: str | bytes) -> bool:
        """Authenticate by re-binding as ``dn`` on a scratch connection —
        the LDAP way to verify a password without reading the hash."""
        sock = socket.create_connection(self.addr, self.timeout_s)
        sock.settimeout(self.timeout_s)
        try:
            sock.sendall(_bind_request(1, dn, password))
            buf = b""
            while True:
                try:
                    _t, content, _u = ber_read(buf, 0)
                    break
                except TruncatedBer:    # malformed BER propagates; the
                    chunk = sock.recv(65536)   # finally closes the sock
                    if not chunk:
                        raise ConnectionError("ldap closed") from None
                    buf += chunk
            parts = ber_seq(content)
            code, _ = _parse_result(parts[1][1])
            return code == RESULT_SUCCESS
        finally:
            try:
                sock.sendall(ber(SEQUENCE, ber_int(2) + ber(_OP_UNBIND, b"")))
                sock.close()
            except OSError:
                pass

    def ping(self) -> bool:
        try:
            self.search("", "(objectClass=*)", scope="base")
            return True
        except (OSError, ConnectionError, LdapError):
            return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._buf = b""


class LdapConnector(Resource):
    """emqx_resource-shaped wrapper (emqx_connector_ldap.erl on_start/
    on_query/on_get_status)."""

    def __init__(self, **kw: Any) -> None:
        self.client = LdapClient(**kw)

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(f"ldap {self.client.addr} unreachable")

    def on_stop(self) -> None:
        self.client.close()

    def on_query(self, req: Any) -> Any:
        try:
            if isinstance(req, dict) and "search" in req:
                return self.client.search(
                    req["search"], req.get("filter", "(objectClass=*)"),
                    req.get("attributes", ()), req.get("scope", "sub"))
            if isinstance(req, dict) and "bind" in req:
                return self.client.check_bind(
                    req["bind"], req.get("password", ""))
            raise LdapError(f"unsupported ldap query {req!r}")
        except (OSError, ConnectionError) as e:
            raise ConnectionError(str(e)) from None

    def on_health_check(self) -> bool:
        return self.client.ping()


# ---------------------------------------------------------------------------
# in-repo miniature directory server (test backend)


class MiniLDAP:
    """BER-real LDAP subset over an in-memory DN→attrs map.

    bind: "" (anonymous), the configured root DN, or any entry DN whose
    ``userPassword`` matches. search: base/one/sub scopes with the
    filter operators parse_filter emits.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 root_dn: str = "cn=admin,dc=emqx,dc=io",
                 root_password: str = "admin") -> None:
        self.entries: dict[str, dict[str, list[str]]] = {}
        self.root_dn = root_dn.lower()
        self.root_password = root_password
        mini = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                mini._live.add(self.request)
                try:
                    mini._session(self.request)
                except (ConnectionError, OSError, LdapError):
                    pass
                finally:
                    mini._live.discard(self.request)

        class _S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _S((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None
        self._live: set[socket.socket] = set()

    def add(self, dn: str, **attrs: str | list[str]) -> None:
        self.entries[dn.lower()] = {
            k.replace("_", "").lower(): (v if isinstance(v, list) else [v])
            for k, v in attrs.items()}

    # -- session -----------------------------------------------------------

    def _session(self, sock: socket.socket) -> None:
        buf = b""
        while True:
            while True:
                try:
                    _t, content, used = ber_read(buf, 0)
                    break
                except TruncatedBer:
                    chunk = sock.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                except LdapError:
                    return            # malformed frame: drop the session
            buf = buf[used:]
            try:
                parts = ber_seq(content)
                msg_id = _decode_int(parts[0][1])
                op_tag, op = parts[1]
            except (LdapError, IndexError):
                return                # malformed content: drop the session
            if op_tag == _OP_UNBIND:
                return
            if op_tag == _OP_BIND_REQ:
                sock.sendall(_msg(msg_id, self._do_bind(op)))
            elif op_tag == _OP_SEARCH_REQ:
                for frame in self._do_search(msg_id, op):
                    sock.sendall(frame)
            else:
                sock.sendall(_msg(msg_id, _result(
                    _OP_SEARCH_DONE, RESULT_UNWILLING,
                    diag="unsupported operation")))

    def _do_bind(self, op: bytes) -> bytes:
        fields = ber_seq(op)
        dn = fields[1][1].decode("utf-8", "replace").lower()
        password = fields[2][1].decode("utf-8", "replace")
        ok = (dn == "" or
              (dn == self.root_dn and password == self.root_password) or
              password in self.entries.get(dn, {}).get("userpassword", ()))
        return _result(_OP_BIND_RESP,
                       RESULT_SUCCESS if ok else RESULT_INVALID_CREDENTIALS,
                       diag="" if ok else "invalid credentials")

    def _do_search(self, msg_id: int, op: bytes):
        fields = ber_seq(op)
        base = fields[0][1].decode("utf-8", "replace").lower()
        scope = _decode_int(fields[1][1])
        filt = (fields[6][0], fields[6][1])
        attrs_wanted = [a.decode() for _t, a in ber_seq(fields[7][1])]
        frames = []
        for dn, attrs in self.entries.items():
            if not _in_scope(dn, base, scope):
                continue
            if not _eval_filter(filt, attrs):
                continue
            out = {k: v for k, v in attrs.items()
                   if not attrs_wanted or k in [a.lower()
                                                for a in attrs_wanted]}
            body = ber_str(dn) + ber(SEQUENCE, b"".join(
                ber(SEQUENCE, ber_str(k) + ber(SET, b"".join(
                    ber_str(x) for x in vs)))
                for k, vs in out.items()))
            frames.append(_msg(msg_id, ber(_OP_SEARCH_ENTRY, body)))
        frames.append(_msg(msg_id, _result(_OP_SEARCH_DONE, RESULT_SUCCESS)))
        return frames

    def start(self) -> "MiniLDAP":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="mini-ldap")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        for s in list(self._live):       # drop live sessions too, so a
            try:                         # "restarted" server on the same
                s.close()                # port gets the reconnects
            except OSError:
                pass


def _in_scope(dn: str, base: str, scope: int) -> bool:
    if scope == 0:
        return dn == base
    if dn == base:
        # RFC 4511 §4.5.1.2: wholeSubtree includes the base object;
        # singleLevel (scope 1) covers immediate subordinates only
        return scope == 2
    if base and not dn.endswith("," + base):
        return False
    rel = dn[:-len(base)].rstrip(",") if base else dn
    if scope == 1:
        return "," not in rel
    return True


def _eval_filter(filt: tuple[int, bytes],
                 attrs: dict[str, list[str]]) -> bool:
    tag, content = filt

    def vals(name: bytes) -> list[str]:
        return attrs.get(name.decode().lower(), [])

    if tag == _F_AND:
        return all(_eval_filter(f, attrs) for f in ber_seq(content))
    if tag == _F_OR:
        return any(_eval_filter(f, attrs) for f in ber_seq(content))
    if tag == _F_NOT:
        (inner,) = ber_seq(content)
        return not _eval_filter(inner, attrs)
    if tag == _F_PRESENT:
        return bool(vals(content))
    if tag == _F_EQ:
        a, v = ber_seq(content)
        return v[1].decode().lower() in [x.lower() for x in vals(a[1])]
    if tag in (_F_GE, _F_LE):
        a, v = ber_seq(content)
        want = v[1].decode()
        op = (lambda x: x >= want) if tag == _F_GE else (lambda x: x <= want)
        return any(op(x) for x in vals(a[1]))
    if tag == _F_SUBSTR:
        a, subseq = ber_seq(content)
        cands = [x.lower() for x in vals(a[1])]
        pieces = ber_seq(subseq[1])
        for cand in cands:
            pos, ok = 0, True
            for i, (ptag, pval) in enumerate(pieces):
                p = pval.decode().lower()
                if ptag == 0x80:                      # initial
                    if not cand.startswith(p):
                        ok = False
                        break
                    pos = len(p)
                elif ptag == 0x82:                    # final
                    if not cand.endswith(p) or cand.rfind(p) < pos:
                        ok = False
                        break
                else:                                 # any
                    k = cand.find(p, pos)
                    if k < 0:
                        ok = False
                        break
                    pos = k + len(p)
            if ok:
                return True
        return False
    raise LdapError(f"unsupported filter tag 0x{tag:02x}")
