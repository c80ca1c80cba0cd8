"""STOMP 1.2 gateway — parity with
``apps/emqx_gateway/src/stomp/`` (frame: emqx_stomp_frame.erl,
channel: emqx_stomp_channel.erl).

STOMP destinations map 1:1 onto topics. SEND publishes; SUBSCRIBE
(id + destination) bridges into the broker; deliveries come back as
MESSAGE frames carrying ``subscription``/``message-id``. RECEIPT is
honored on any client frame carrying ``receipt``; ERROR closes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from emqx_tpu_torch.gateway.ctx import GatewayImpl, GwChannel, GwContext, GwFrame

SUPPORTED_VERSIONS = ("1.0", "1.1", "1.2")


@dataclass
class StompFrame:
    command: str
    headers: dict = field(default_factory=dict)
    body: bytes = b""


# -- codec (emqx_stomp_frame.erl) -------------------------------------------

def _unescape(s: str) -> str:
    return (s.replace("\\r", "\r").replace("\\n", "\n")
             .replace("\\c", ":").replace("\\\\", "\\"))


def _escape(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\r", "\\r")
             .replace("\n", "\\n").replace(":", "\\c"))


class Frame(GwFrame):
    def initial_parse_state(self, opts: Optional[dict] = None) -> bytes:
        return b""

    def parse(self, data: bytes, state: bytes) -> tuple[list, bytes]:
        buf = (state or b"") + data
        out: list[StompFrame] = []
        while True:
            # heart-beats: bare EOLs between frames
            buf = buf.lstrip(b"\r\n")
            # header block ends at the first blank line — LF or CRLF
            # line endings are both spec-legal (STOMP 1.2 §augmented BNF)
            p_lf, p_crlf = buf.find(b"\n\n"), buf.find(b"\r\n\r\n")
            if p_crlf >= 0 and (p_lf < 0 or p_crlf < p_lf):
                head, body_start = buf[:p_crlf], p_crlf + 4
            elif p_lf >= 0:
                head, body_start = buf[:p_lf], p_lf + 2
            else:
                break                                 # incomplete head
            lines = head.decode("utf-8", "replace").split("\n")
            command = lines[0].strip("\r")
            headers: dict = {}
            for line in lines[1:]:
                line = line.rstrip("\r")
                if not line:
                    continue
                k, _, v = line.partition(":")
                # repeated header: first occurrence wins (spec)
                headers.setdefault(_unescape(k), _unescape(v))
            # content-length framing lets bodies carry NUL bytes;
            # without it the body ends at the first NUL
            clen = headers.get("content-length")
            if clen is not None and clen.isdigit():
                n = int(clen)
                if len(buf) < body_start + n + 1:
                    break                             # incomplete body
                body = buf[body_start:body_start + n]
                buf = buf[body_start + n + 1:]        # skip the NUL
            else:
                end = buf.find(b"\x00", body_start)
                if end < 0:
                    break
                body = buf[body_start:end]
                buf = buf[end + 1:]
            out.append(StompFrame(command, headers, body))
        return out, buf

    def serialize(self, pkt: StompFrame) -> bytes:
        if pkt.command == "":            # server heart-beat
            return b"\n"
        lines = [pkt.command]
        hdrs = dict(pkt.headers)
        if pkt.body and "content-length" not in hdrs:
            hdrs["content-length"] = str(len(pkt.body))
        for k, v in hdrs.items():
            lines.append(f"{_escape(str(k))}:{_escape(str(v))}")
        return ("\n".join(lines) + "\n\n").encode() + pkt.body + b"\x00"


# -- channel (emqx_stomp_channel.erl) ---------------------------------------

class Channel(GwChannel):
    def __init__(self, ctx: GwContext) -> None:
        self.ctx = ctx
        self.conn_state = "idle"
        self.clientid: Optional[str] = None
        self.subs: dict[str, str] = {}       # sub id -> destination
        self._msg_seq = 0
        # STOMP transactions (emqx_stomp_channel.erl:453,547): BEGIN
        # opens a buffer; SEND/ACK/NACK carrying `transaction` defer
        # into it; COMMIT replays in order; ABORT (or the timeout in
        # housekeep) discards. txid → (started_at_monotonic, [thunks])
        self._tx: dict[str, tuple[float, list]] = {}
        self.tx_timeout_s = 60.0
        self.max_tx = 16                 # concurrent txs per channel
        self.max_tx_ops = 1000           # buffered frames per tx
        self._session_open = False

    # -- inbound -------------------------------------------------------------

    def handle_in(self, frame: StompFrame) -> list[StompFrame]:
        cmd = frame.command.upper()
        if self.conn_state in ("disconnected", "terminated"):
            return []        # kicked/closed: drop, never publish
        if self.conn_state == "idle" and cmd not in ("CONNECT", "STOMP"):
            return [self._error("Not connected")]
        try:
            handler = getattr(self, f"_in_{cmd.lower()}", None)
            if handler is None:
                return [self._error(f"Unknown command {cmd}")]
            out = handler(frame)
        except Exception as e:
            return [self._error(str(e))]
        receipt = frame.headers.get("receipt")
        if receipt and cmd not in ("CONNECT", "STOMP") and not any(
                f.command == "ERROR" for f in out):
            # STOMP: a failed frame answers ERROR, never RECEIPT — a
            # RECEIPT after ERROR would tell the client its COMMIT of
            # an expired transaction succeeded
            out.append(StompFrame("RECEIPT", {"receipt-id": receipt}))
        return out

    def _in_connect(self, frame: StompFrame) -> list[StompFrame]:
        if self.conn_state == "connected":
            return [self._error("Already connected")]
        accepts = (frame.headers.get("accept-version") or "1.0").split(",")
        version = max((v for v in accepts if v in SUPPORTED_VERSIONS),
                      default=None)
        if version is None:
            return [self._error("Supported protocol versions < 1.2")]
        login = frame.headers.get("login")
        self.clientid = (frame.headers.get("client-id")
                         or login or f"stomp-{id(self):x}")
        if not self.ctx.authenticate(
                self.clientid, username=login,
                password=frame.headers.get("passcode")):
            return [self._error("Login failed")]
        self.ctx.open_session(self.clientid, self)
        self._session_open = True
        self.conn_state = "connected"
        return [StompFrame("CONNECTED", {
            "version": version, "server": "emqx-tpu",
            "heart-beat": frame.headers.get("heart-beat", "0,0"),
        })]

    _in_stomp = _in_connect

    def _in_send(self, frame: StompFrame) -> list[StompFrame]:
        dest = frame.headers.get("destination")
        if not dest:
            return [self._error("Missing destination")]

        def do(dest=dest, body=frame.body, headers=dict(frame.headers)):
            self.ctx.publish(self.clientid, dest, body,
                             qos=0, props={
                                 k: v for k, v in headers.items()
                                 if k not in ("destination", "receipt",
                                              "content-length",
                                              "transaction")
                             })
        return self._maybe_defer(frame, do)

    # -- transactions --------------------------------------------------------

    def _maybe_defer(self, frame: StompFrame, thunk) -> list[StompFrame]:
        txid = frame.headers.get("transaction")
        if txid is None:
            thunk()
            return []
        tx = self._tx.get(txid)
        if tx is None:
            return [self._error(f"Transaction {txid} not found")]
        if len(tx[1]) >= self.max_tx_ops:   # bound buffered bodies
            self._tx.pop(txid, None)
            return [self._error(f"Transaction {txid} too large")]
        tx[1].append(thunk)
        return []

    def _in_begin(self, frame: StompFrame) -> list[StompFrame]:
        import time
        txid = frame.headers.get("transaction")
        if not txid:
            return [self._error("Missing transaction")]
        if txid in self._tx:
            return [self._error(f"Transaction {txid} already started")]
        if len(self._tx) >= self.max_tx:     # bound tx count
            return [self._error("Too many open transactions")]
        self._tx[txid] = (time.monotonic(), [])
        return []

    def _in_commit(self, frame: StompFrame) -> list[StompFrame]:
        txid = frame.headers.get("transaction")
        tx = self._tx.pop(txid, None)
        if tx is None:
            return [self._error(f"Transaction {txid} not found")]
        for thunk in tx[1]:
            thunk()
        return []

    def _in_abort(self, frame: StompFrame) -> list[StompFrame]:
        txid = frame.headers.get("transaction")
        if self._tx.pop(txid, None) is None:
            return [self._error(f"Transaction {txid} not found")]
        return []

    def housekeep(self) -> list[StompFrame]:
        import time
        now = time.monotonic()
        dead = [txid for txid, (at, _ops) in self._tx.items()
                if now - at > self.tx_timeout_s]
        for txid in dead:
            del self._tx[txid]
        return []

    def _in_subscribe(self, frame: StompFrame) -> list[StompFrame]:
        sid = frame.headers.get("id")
        dest = frame.headers.get("destination")
        if not sid or not dest:
            return [self._error("Missing id or destination")]
        if sid in self.subs:
            return [self._error(f"Subscription id {sid} already exists")]
        self.subs[sid] = dest
        self.ctx.subscribe(self.clientid, dest, qos=0)
        return []

    def _in_unsubscribe(self, frame: StompFrame) -> list[StompFrame]:
        sid = frame.headers.get("id")
        dest = self.subs.pop(sid, None)
        if dest is not None and dest not in self.subs.values():
            self.ctx.unsubscribe(self.clientid, dest)
        return []

    def _in_ack(self, frame: StompFrame) -> list[StompFrame]:
        # QoS0 bridge: ack itself is a no-op (reference parity) — but a
        # transactional ack must still validate its transaction
        return self._maybe_defer(frame, lambda: None)

    def _in_nack(self, frame: StompFrame) -> list[StompFrame]:
        return self._maybe_defer(frame, lambda: None)

    def _in_disconnect(self, frame: StompFrame) -> list[StompFrame]:
        self.conn_state = "disconnected"
        return []

    # -- outbound ------------------------------------------------------------

    def handle_deliver(self, deliveries: list) -> list[StompFrame]:
        out = []
        for sub_topic, msg in deliveries:
            plain = self.ctx.unmount(sub_topic)
            for sid, dest in self.subs.items():
                if _dest_match(plain, dest):
                    self._msg_seq += 1
                    out.append(StompFrame("MESSAGE", {
                        "subscription": sid,
                        "message-id": str(self._msg_seq),
                        "destination": self.ctx.unmount(msg.topic),
                    }, msg.payload))
                    break
        return out

    def terminate(self, reason: str) -> None:
        # session cleanup keys on _session_open, NOT conn_state: a
        # graceful DISCONNECT (or an ERROR) flips conn_state before the
        # transport teardown reaches here, and gating on it would leak
        # ghost entries into ctx.sessions / the gateway REST surface
        if self._session_open:
            self._session_open = False
            self.ctx.close_session(self.clientid, self, reason)
        if self.conn_state != "terminated":
            self.conn_state = "terminated"
            self._tx.clear()
            # an admin kick must actually drop the socket, not leave it
            # open until the client's next frame
            self.request_close()

    def _error(self, text: str) -> StompFrame:
        # STOMP 1.2 §ERROR: the server MUST close the connection just
        # after sending an ERROR frame. The TCP adapter closes on
        # conn_state == "disconnected" after flushing our reply; the
        # explicit request_close() makes the close adapter-independent
        # (it is deferred via call_soon_threadsafe, so the ERROR frame
        # is written before the socket drops — never a half-open
        # session whose subsequent frames we silently swallow).
        self.conn_state = "disconnected"
        self.request_close()
        return StompFrame("ERROR", {"message": text}, text.encode())


def _dest_match(topic: str, dest: str) -> bool:
    from emqx_tpu_torch.core import topic as T
    return T.match(topic, dest)


class StompGateway(GatewayImpl):
    name = "stomp"

    def __init__(self, host: str = "127.0.0.1", port: int = 61613) -> None:
        self.host, self.port = host, port
        self.listener = None
        self.ctx: Optional[GwContext] = None

    def on_gateway_load(self, ctx: GwContext, conf: dict) -> None:
        from emqx_tpu_torch.gateway.conn import TcpGwListener

        self.ctx = ctx
        self.host = conf.get("host", self.host)
        self.port = conf.get("port", self.port)
        self.listener = TcpGwListener(
            lambda: Channel(self.ctx), Frame(),
            host=self.host, port=self.port)

    async def start_listeners(self) -> None:
        await self.listener.start()
        self.port = self.listener.port

    async def stop_listeners(self) -> None:
        await self.listener.stop()
