"""Wire codec for the cluster planes.

JSON envelope with tagged binaries (``{"$b": base64}``) and tagged
tuples (``{"$t": [...]}``, needed because route destinations use tuples
as ``(group, node)``) — the gen_rpc/ETF serialization slot. Message and
SubOpts get explicit to/from-dict forms so forwarding and takeover are
cross-process safe, not just cross-object.
"""

from __future__ import annotations

import base64
import json
from typing import Any

from emqx_tpu_torch.core.message import Message, SubOpts


def _enc(obj: Any) -> Any:
    if isinstance(obj, bytes):
        return {"$b": base64.b64encode(obj).decode()}
    if isinstance(obj, tuple):
        return {"$t": [_enc(x) for x in obj]}
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, set)):
        return [_enc(x) for x in obj]
    return obj


def _dec(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "$b" in obj and len(obj) == 1:
            return base64.b64decode(obj["$b"])
        if "$t" in obj and len(obj) == 1:
            return tuple(_dec(x) for x in obj["$t"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(x) for x in obj]
    return obj


def encode(obj: Any) -> bytes:
    return json.dumps(_enc(obj), separators=(",", ":")).encode()


def decode(data: bytes) -> Any:
    return _dec(json.loads(data.decode()))


# -- domain objects --------------------------------------------------------


def msg_to_dict(m: Message) -> dict:
    return {
        "topic": m.topic, "payload": m.payload, "qos": m.qos,
        "from": m.from_, "id": m.id, "flags": dict(m.flags),
        "headers": dict(m.headers), "timestamp": m.timestamp,
    }


def msg_from_dict(d: dict) -> Message:
    return Message(
        topic=d["topic"], payload=d["payload"], qos=d["qos"],
        from_=d.get("from", ""), id=d.get("id", 0),
        flags=d.get("flags") or {}, headers=d.get("headers") or {},
        timestamp=d.get("timestamp", 0),
    )


def subopts_to_dict(o: SubOpts) -> dict:
    return {"qos": o.qos, "rh": o.rh, "rap": o.rap, "nl": o.nl,
            "share": o.share, "subid": o.subid}


def subopts_from_dict(d: dict) -> SubOpts:
    return SubOpts(qos=d.get("qos", 0), rh=d.get("rh", 0),
                   rap=d.get("rap", 0), nl=d.get("nl", 0),
                   share=d.get("share"), subid=d.get("subid"))
