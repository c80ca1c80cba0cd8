"""Exhook wire protocol — the ``exhook.proto`` surface
(apps/emqx_exhook/priv/protos/exhook.proto:29-72) over length-prefixed
codec frames.

RPCs (same names/cardinality as the reference's 21-RPC HookProvider
service, plus the batched publish extension):

    OnProviderLoaded(broker)             → {hooks: [hookpoint...]}
    OnProviderUnloaded()
    OnClientConnect/Connack/Connected/Disconnected(...)
    OnClientAuthenticate(clientinfo)     → valued bool
    OnClientAuthorize(clientinfo, action, topic) → valued bool
    OnClientSubscribe/Unsubscribe(...)
    OnSessionCreated/Subscribed/Unsubscribed/Resumed/Discarded/
      Takenover/Terminated(...)
    OnMessagePublish(message)            → valued message (rewrite/drop)
    OnMessagePublishBatch(messages)      → per-message verdicts  [batch]
    OnMessageDelivered/Acked/Dropped(...)

Responses carry {"type": "CONTINUE" | "STOP_AND_RETURN" | "IGNORE",
"value": ...} — the ValuedResponse of the reference.

WIRE FORMAT (normative — what an external provider must speak)
==============================================================

Transport: one TCP connection per pool slot, provider is the listener.
Framing: every message is::

    +----------------+----------------------------------+
    | uint32 big-end | body: UTF-8 JSON, that many bytes|
    +----------------+----------------------------------+

No TLS at this layer (front it with a TLS proxy if needed). Requests
and responses alternate strictly on one connection (synchronous RPC;
concurrency comes from the pool, one in-flight call per connection —
the same discipline as the reference's per-conn gRPC streams).

Request body::

    {"rpc": "<RpcName>", "args": {...}}

Response body::

    {"type": "CONTINUE" | "STOP_AND_RETURN" | "IGNORE", "value": ...}

`args` payloads mirror exhook.proto messages field-for-field in JSON:
clientinfo {clientid, username, peername, proto_ver}, message {id,
topic, payload, qos, retain, from, timestamp, headers}. Binary fields
(payload) use the codec's tagged encoding: {"$b": "<base64>"}
(cluster/codec.py) — providers must decode/encode that tag.

DESIGN NOTE — two transports: ``ExhookServer(transport="grpc")``
speaks the reference's REAL gRPC ``emqx.exhook.v2.HookProvider``
service (exhook/grpc_transport.py + the hand-written proto codec in
exhook/pbwire.py), so stock providers connect with no adapter. This
framed JSON protocol remains as the dependency-free second transport
(providers in constrained environments; also what exproto gateways
reuse). RPC names, request fields, ValuedResponse semantics, timeout
and failed_action behaviour are identical across both.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Optional

from emqx_tpu_torch.cluster import codec

# hookpoint name (broker side) → RPC name
HOOK_RPCS = {
    "client.connect": "OnClientConnect",
    "client.connack": "OnClientConnack",
    "client.connected": "OnClientConnected",
    "client.disconnected": "OnClientDisconnected",
    "client.authenticate": "OnClientAuthenticate",
    "client.authorize": "OnClientAuthorize",
    "client.subscribe": "OnClientSubscribe",
    "client.unsubscribe": "OnClientUnsubscribe",
    "session.created": "OnSessionCreated",
    "session.subscribed": "OnSessionSubscribed",
    "session.unsubscribed": "OnSessionUnsubscribed",
    "session.resumed": "OnSessionResumed",
    "session.discarded": "OnSessionDiscarded",
    "session.takenover": "OnSessionTakenover",
    "session.terminated": "OnSessionTerminated",
    "message.publish": "OnMessagePublish",
    "message.delivered": "OnMessageDelivered",
    "message.acked": "OnMessageAcked",
    "message.dropped": "OnMessageDropped",
}
RPC_HOOKS = {v: k for k, v in HOOK_RPCS.items()}

CONTINUE = "CONTINUE"
STOP_AND_RETURN = "STOP_AND_RETURN"
IGNORE = "IGNORE"


def send_frame(sock: socket.socket, obj: Any) -> None:
    body = codec.encode(obj)
    sock.sendall(struct.pack(">I", len(body)) + body)


def recv_frame(sock: socket.socket) -> Optional[Any]:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (ln,) = struct.unpack(">I", head)
    body = _recv_exact(sock, ln)
    if body is None:
        return None
    return codec.decode(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
