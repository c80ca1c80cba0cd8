"""MQTT control-packet model (3.1 / 3.1.1 / 5.0).

Parity with the reference's packet records (``apps/emqx/include/emqx_mqtt.hrl``)
and helpers (``apps/emqx/src/emqx_packet.erl``): packet type constants,
per-type dataclasses, v5 reason codes, and property names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# protocol versions
MQTT_V3 = 3
MQTT_V4 = 4   # a.k.a. 3.1.1
MQTT_V5 = 5

# control packet types
CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
PUBREC = 5
PUBREL = 6
PUBCOMP = 7
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14
AUTH = 15

TYPE_NAMES = {
    CONNECT: "CONNECT", CONNACK: "CONNACK", PUBLISH: "PUBLISH",
    PUBACK: "PUBACK", PUBREC: "PUBREC", PUBREL: "PUBREL",
    PUBCOMP: "PUBCOMP", SUBSCRIBE: "SUBSCRIBE", SUBACK: "SUBACK",
    UNSUBSCRIBE: "UNSUBSCRIBE", UNSUBACK: "UNSUBACK", PINGREQ: "PINGREQ",
    PINGRESP: "PINGRESP", DISCONNECT: "DISCONNECT", AUTH: "AUTH",
}

QOS_0, QOS_1, QOS_2 = 0, 1, 2

# MQTT 5.0 reason codes (subset used broker-wide; emqx_mqtt.hrl RC_*)
RC_SUCCESS = 0x00
RC_GRANTED_QOS_1 = 0x01
RC_GRANTED_QOS_2 = 0x02
RC_NO_MATCHING_SUBSCRIBERS = 0x10
RC_NO_SUBSCRIPTION_EXISTED = 0x11
RC_UNSPECIFIED_ERROR = 0x80
RC_MALFORMED_PACKET = 0x81
RC_PROTOCOL_ERROR = 0x82
RC_IMPLEMENTATION_SPECIFIC_ERROR = 0x83
RC_UNSUPPORTED_PROTOCOL_VERSION = 0x84
RC_CLIENT_IDENTIFIER_NOT_VALID = 0x85
RC_BAD_USER_NAME_OR_PASSWORD = 0x86
RC_NOT_AUTHORIZED = 0x87
RC_SERVER_UNAVAILABLE = 0x88
RC_SERVER_BUSY = 0x89
RC_BANNED = 0x8A
RC_BAD_AUTHENTICATION_METHOD = 0x8C
RC_KEEP_ALIVE_TIMEOUT = 0x8D
RC_SESSION_TAKEN_OVER = 0x8E
RC_TOPIC_FILTER_INVALID = 0x8F
RC_TOPIC_NAME_INVALID = 0x90
RC_PACKET_IDENTIFIER_IN_USE = 0x91
RC_PACKET_IDENTIFIER_NOT_FOUND = 0x92
RC_RECEIVE_MAXIMUM_EXCEEDED = 0x93
RC_TOPIC_ALIAS_INVALID = 0x94
RC_PACKET_TOO_LARGE = 0x95
RC_MESSAGE_RATE_TOO_HIGH = 0x96
RC_QUOTA_EXCEEDED = 0x97
RC_ADMINISTRATIVE_ACTION = 0x98
RC_PAYLOAD_FORMAT_INVALID = 0x99
RC_RETAIN_NOT_SUPPORTED = 0x9A
RC_QOS_NOT_SUPPORTED = 0x9B
RC_USE_ANOTHER_SERVER = 0x9C
RC_SERVER_MOVED = 0x9D
RC_SHARED_SUBSCRIPTIONS_NOT_SUPPORTED = 0x9E
RC_CONNECTION_RATE_EXCEEDED = 0x9F
RC_MAXIMUM_CONNECT_TIME = 0xA0
RC_SUBSCRIPTION_IDENTIFIERS_NOT_SUPPORTED = 0xA1
RC_WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED = 0xA2

# v5 property ids → (name, type); type ∈ byte|two|four|varint|utf8|binary|utf8pair
PROPERTIES = {
    0x01: ("Payload-Format-Indicator", "byte"),
    0x02: ("Message-Expiry-Interval", "four"),
    0x03: ("Content-Type", "utf8"),
    0x08: ("Response-Topic", "utf8"),
    0x09: ("Correlation-Data", "binary"),
    0x0B: ("Subscription-Identifier", "varint"),
    0x11: ("Session-Expiry-Interval", "four"),
    0x12: ("Assigned-Client-Identifier", "utf8"),
    0x13: ("Server-Keep-Alive", "two"),
    0x15: ("Authentication-Method", "utf8"),
    0x16: ("Authentication-Data", "binary"),
    0x17: ("Request-Problem-Information", "byte"),
    0x18: ("Will-Delay-Interval", "four"),
    0x19: ("Request-Response-Information", "byte"),
    0x1A: ("Response-Information", "utf8"),
    0x1C: ("Server-Reference", "utf8"),
    0x1F: ("Reason-String", "utf8"),
    0x21: ("Receive-Maximum", "two"),
    0x22: ("Topic-Alias-Maximum", "two"),
    0x23: ("Topic-Alias", "two"),
    0x24: ("Maximum-QoS", "byte"),
    0x25: ("Retain-Available", "byte"),
    0x26: ("User-Property", "utf8pair"),
    0x27: ("Maximum-Packet-Size", "four"),
    0x28: ("Wildcard-Subscription-Available", "byte"),
    0x29: ("Subscription-Identifier-Available", "byte"),
    0x2A: ("Shared-Subscription-Available", "byte"),
}
PROP_IDS = {name: (pid, ty) for pid, (name, ty) in PROPERTIES.items()}


class FrameError(Exception):
    """Malformed packet (maps to RC_MALFORMED_PACKET / connection close)."""

    def __init__(self, reason: str, rc: int = RC_MALFORMED_PACKET):
        super().__init__(reason)
        self.rc = rc


@dataclass
class Connect:
    proto_name: str = "MQTT"
    proto_ver: int = MQTT_V4
    clean_start: bool = True
    keepalive: int = 60
    clientid: str = ""
    username: Optional[str] = None
    password: Optional[bytes] = None
    will_flag: bool = False
    will_qos: int = 0
    will_retain: bool = False
    will_topic: Optional[str] = None
    will_payload: Optional[bytes] = None
    will_props: dict[str, Any] = field(default_factory=dict)
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = CONNECT


@dataclass
class Connack:
    session_present: bool = False
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = CONNACK


@dataclass
class Publish:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None   # required iff qos > 0
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = PUBLISH


@dataclass
class PubAck:
    packet_id: int
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = PUBACK


@dataclass
class PubRec:
    packet_id: int
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = PUBREC


@dataclass
class PubRel:
    packet_id: int
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = PUBREL


@dataclass
class PubComp:
    packet_id: int
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = PUBCOMP


@dataclass
class Subscribe:
    packet_id: int
    # [(topic_filter, {qos, nl, rap, rh})]
    topic_filters: list[tuple[str, dict[str, int]]] = field(default_factory=list)
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = SUBSCRIBE


@dataclass
class SubAck:
    packet_id: int
    reason_codes: list[int] = field(default_factory=list)
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = SUBACK


@dataclass
class Unsubscribe:
    packet_id: int
    topic_filters: list[str] = field(default_factory=list)
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = UNSUBSCRIBE


@dataclass
class UnsubAck:
    packet_id: int
    reason_codes: list[int] = field(default_factory=list)
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = UNSUBACK


@dataclass
class PingReq:
    type: int = PINGREQ


@dataclass
class PingResp:
    type: int = PINGRESP


@dataclass
class Disconnect:
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = DISCONNECT


@dataclass
class Auth:
    reason_code: int = RC_SUCCESS
    properties: dict[str, Any] = field(default_factory=dict)
    type: int = AUTH


Packet = (
    Connect | Connack | Publish | PubAck | PubRec | PubRel | PubComp
    | Subscribe | SubAck | Unsubscribe | UnsubAck | PingReq | PingResp
    | Disconnect | Auth
)
