"""Typed config schema — parity with ``emqx_schema.erl`` + typerefl.

A schema is a tree of ``Field``s (leaf types with defaults/validators)
and ``Struct``s (nested maps). ``check`` validates + fills defaults and
returns the *checked* config; unknown keys error (the reference's
strict HOCON check). The same schema objects drive doc/swagger
generation in the management API (emqx_dashboard_swagger analogue:
``to_doc``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from emqx_tpu_torch.config.hocon import ByteSize, Duration


class SchemaError(ValueError):
    def __init__(self, path: str, msg: str) -> None:
        super().__init__(f"{path or '<root>'}: {msg}")
        self.path = path


class Field:
    """Leaf field: type ∈ bool/int/float/string/duration/bytesize/
    enum/array/map (map = free-form dict)."""

    def __init__(self, type_: str = "string", default: Any = None,
                 required: bool = False, enum: Optional[list] = None,
                 validator: Optional[Callable[[Any], bool]] = None,
                 item: Optional["Field | Struct"] = None,
                 desc: str = "") -> None:
        self.type = type_
        self.default = default
        self.required = required
        self.enum = enum
        self.validator = validator
        self.item = item               # element schema for arrays
        self.desc = desc

    def check(self, val: Any, path: str) -> Any:
        if val is None:
            if self.required:
                raise SchemaError(path, "required field missing")
            return self.default
        t = self.type
        if t == "bool":
            if not isinstance(val, bool):
                raise SchemaError(path, f"expected bool, got {val!r}")
        elif t == "int":
            if isinstance(val, bool) or not isinstance(val, int):
                # durations/bytesizes coerce onto int fields
                if isinstance(val, (Duration, ByteSize)):
                    val = int(val)
                elif isinstance(val, float) and val.is_integer():
                    val = int(val)
                else:
                    raise SchemaError(path, f"expected int, got {val!r}")
        elif t == "float":
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise SchemaError(path, f"expected number, got {val!r}")
            val = float(val)
        elif t == "string":
            if not isinstance(val, str):
                raise SchemaError(path, f"expected string, got {val!r}")
        elif t == "duration":
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                val = Duration(val)
            else:
                raise SchemaError(path, f"expected duration, got {val!r}")
        elif t == "bytesize":
            if isinstance(val, int) and not isinstance(val, bool):
                val = ByteSize(val)
            else:
                raise SchemaError(path, f"expected bytesize, got {val!r}")
        elif t == "enum":
            if val not in (self.enum or []):
                raise SchemaError(path,
                                  f"expected one of {self.enum}, got {val!r}")
        elif t == "array":
            if not isinstance(val, list):
                raise SchemaError(path, f"expected array, got {val!r}")
            if self.item is not None:
                val = [self.item.check(v, f"{path}[{i}]")
                       for i, v in enumerate(val)]
        elif t == "map":
            if not isinstance(val, dict):
                raise SchemaError(path, f"expected object, got {val!r}")
            if self.item is not None:      # value schema (e.g. listeners)
                val = {k: self.item.check(v, f"{path}.{k}")
                       for k, v in val.items()}
        else:
            raise SchemaError(path, f"unknown field type {t!r}")
        if self.validator is not None and not self.validator(val):
            raise SchemaError(path, f"validation failed for {val!r}")
        return val

    def to_doc(self) -> dict:
        d: dict[str, Any] = {"type": self.type}
        if self.default is not None:
            d["default"] = self.default
        if self.enum:
            d["enum"] = self.enum
        if self.required:
            d["required"] = True
        if self.desc:
            d["desc"] = self.desc
        return d


class Struct:
    """Nested object of named fields/structs. ``open=True`` tolerates
    unknown keys (for extension points like zones/listeners)."""

    def __init__(self, fields: dict[str, "Field | Struct"],
                 open: bool = False, desc: str = "") -> None:
        self.fields = fields
        self.open = open
        self.desc = desc

    def check(self, val: Any, path: str = "") -> dict:
        if val is None:
            val = {}
        if not isinstance(val, dict):
            raise SchemaError(path, f"expected object, got {val!r}")
        out: dict[str, Any] = {}
        for k, v in val.items():
            sub = self.fields.get(k)
            kp = f"{path}.{k}" if path else k
            if sub is None:
                if self.open:
                    out[k] = v
                    continue
                raise SchemaError(kp, "unknown config key")
            out[k] = sub.check(v, kp)
        for k, sub in self.fields.items():
            if k not in out:
                kp = f"{path}.{k}" if path else k
                out[k] = sub.check(None, kp)
        return out

    def to_doc(self) -> dict:
        return {"type": "object",
                "fields": {k: f.to_doc() for k, f in self.fields.items()},
                **({"desc": self.desc} if self.desc else {})}


# -- the broker's root schema (emqx_schema.erl, trimmed to what the
#    runtime consumes today; widened as features land) --------------------

def mqtt_schema() -> Struct:
    """Zone-overridable MQTT caps (emqx_schema 'mqtt' section)."""
    return Struct({
        "max_packet_size": Field("bytesize", default=1 << 20),
        "max_clientid_len": Field("int", default=65535),
        "max_topic_levels": Field("int", default=128),
        "max_qos_allowed": Field("int", default=2,
                                 validator=lambda v: 0 <= v <= 2),
        "max_topic_alias": Field("int", default=65535),
        "retain_available": Field("bool", default=True),
        "wildcard_subscription": Field("bool", default=True),
        "shared_subscription": Field("bool", default=True),
        "exclusive_subscription": Field("bool", default=False),
        "ignore_loop_deliver": Field("bool", default=False),
        "session_expiry_interval": Field("duration", default=7200.0),
        "max_awaiting_rel": Field("int", default=100),
        "await_rel_timeout": Field("duration", default=300.0),
        "max_subscriptions": Field("int", default=0),   # 0 = infinity
        "upgrade_qos": Field("bool", default=False),
        "keepalive_backoff": Field("float", default=0.75),
        "max_inflight": Field("int", default=32),
        "retry_interval": Field("duration", default=30.0),
        "max_mqueue_len": Field("int", default=1000),
        "mqueue_store_qos0": Field("bool", default=True),
    })


def ssl_options_schema() -> Struct:
    """esockd ssl_options surface (emqx_listeners.erl:196-238,
    emqx_schema.erl ssl defaults)."""
    return Struct({
        "certfile": Field("string", default=""),
        "keyfile": Field("string", default=""),
        "password": Field("string", default=""),
        "cacertfile": Field("string", default=""),
        "verify": Field("enum", enum=["verify_none", "verify_peer"],
                        default="verify_none"),
        "fail_if_no_peer_cert": Field("bool", default=False),
        "versions": Field("array", default=["tlsv1.2", "tlsv1.3"],
                          item=Field("enum", enum=[
                              "tlsv1", "tlsv1.1", "tlsv1.2", "tlsv1.3"])),
        "ciphers": Field("array", default=[], item=Field("string")),
        "handshake_timeout": Field("duration", default=15.0),
        "enable_psk": Field("bool", default=False),
    }, open=True)


def listener_schema() -> Struct:
    return Struct({
        # "native" = the C++ epoll host with the QoS0/1 publish data
        # plane (broker/native_server.py); fast_path turns the data
        # plane off while keeping C++ socket IO
        "type": Field("enum",
                      enum=["tcp", "ssl", "ws", "wss", "quic", "native"],
                      default="tcp"),
        "fast_path": Field("bool", default=True),
        "bind": Field("string", default="0.0.0.0:1883"),
        "enabled": Field("bool", default=True),
        "max_connections": Field("int", default=1_000_000),
        "mountpoint": Field("string", default=""),
        "zone": Field("string", default="default"),
        "proxy_protocol": Field("bool", default=False),
        "websocket_path": Field("string", default="/mqtt"),
        "peer_cert_as_username": Field(
            "enum", enum=["disabled", "cn", "dn"], default="disabled"),
        "peer_cert_as_clientid": Field(
            "enum", enum=["disabled", "cn", "dn"], default="disabled"),
        "ssl_options": ssl_options_schema(),
    }, open=True)


def root_schema() -> Struct:
    return Struct({
        "node": Struct({
            "name": Field("string", default="emqx_tpu@127.0.0.1"),
            "cookie": Field("string", default="emqxsecretcookie"),
            "data_dir": Field("string", default="data"),
        }),
        "cluster": Struct({
            "name": Field("string", default="emqxcl"),
            "discovery_strategy": Field(
                "enum", enum=["manual", "static", "dns"], default="manual"),
            "static": Struct({
                "seeds": Field("array", default=[], item=Field("string")),
            }),
        }, open=True),
        "mqtt": mqtt_schema(),
        "zones": Field("map", default={}),       # name → mqtt overrides
        # name → listener conf, each checked against listener_schema
        "listeners": Field("map", default={}, item=listener_schema()),
        "authentication": Field("array", default=[], item=Field("map")),
        "authorization": Struct({
            "no_match": Field("enum", enum=["allow", "deny"],
                              default="allow"),
            "deny_action": Field("enum", enum=["ignore", "disconnect"],
                                 default="ignore"),
            "cache": Struct({
                "enable": Field("bool", default=True),
                "max_size": Field("int", default=32),
                "ttl": Field("duration", default=60.0),
            }),
            "sources": Field("array", default=[], item=Field("map")),
        }),
        "retainer": Struct({
            "enable": Field("bool", default=True),
            "max_retained_messages": Field("int", default=0),
            "msg_expiry_interval": Field("duration", default=0.0),
        }, open=True),
        "delayed": Struct({
            "enable": Field("bool", default=True),
            "max_delayed_messages": Field("int", default=0),
        }),
        # durable-session plane (round 10): the host-side message store
        # the C++ data plane appends to below the GIL (store.h) plus the
        # PersistentSessions service backing resume. enable=false keeps
        # CONFIG-BUILT apps persistence-less (persistent sessions punt,
        # the pre-round-10 shape); an app constructed with an explicit
        # persistent_store gets the native plane by default regardless —
        # EMQX_DURABLE_STORE=0 is the runtime escape hatch for both.
        "durable": Struct({
            "enable": Field("bool", default=False),
            # "" → <node.data_dir>/durable/store for the native message
            # log (+ /durable/sessions for the Python session store)
            "store_dir": Field("string", default=""),
            "segment_bytes": Field("bytesize", default=4 * 1024 * 1024),
            # never = page cache only; batch = msync per flushed batch
            # (PUBACK-after-store gives real qos1 durability);
            # interval = ~100ms cadence
            "fsync": Field("enum", enum=["never", "batch", "interval"],
                           default="batch"),
            # global cap on stored-session retention; 0 = each
            # session's own Session-Expiry-Interval governs
            "session_expiry": Field("duration", default=0.0),
        }),
        "router": Struct({
            # the device router on the serving path: subscriptions
            # compile into the trie and dense pool on the card; publishes
            # coalesce into batched routing-step launches
            "device": Struct({
                "enable": Field("bool", default=False),
                "n_sub_slots": Field("int", default=1024),
                "batch_max": Field("int", default=512),
                # publish batches smaller than this answer from the
                # host oracle instead of paying a device round trip
                # (SURVEY §7 hard part (b): the latency knee).
                # -1 = adaptive: the pipeline estimates the knee from
                # measured device RTT and host-oracle cost EMAs; over a
                # model on a CUDA card -1 resolves to 0 (every batch
                # runs the step) until the knee is measured there
                "min_batch": Field("int", default=-1),
                # in-flight kernel launches the pipeline keeps (service
                # rate ≈ depth × batch_max / device RTT)
                "pipeline_depth": Field("int", default=4),
                # queue-sojourn bound (ms) before a batch spills to the
                # host oracle; -1 = adaptive (3 × measured RTT)
                "spill_ms": Field("int", default=-1),
                "max_levels": Field("int", default=16),
                "frontier_k": Field("int", default=32),
                "match_cap": Field("int", default=128),
                # device→host columns returned per topic; topics
                # matching more fall back to the host oracle
                "return_cap": Field("int", default=16),
            }),
        }),
        "shared_subscription_strategy": Field(
            "enum", enum=["random", "round_robin", "round_robin_per_group",
                          "sticky", "local", "hash_clientid", "hash_topic"],
            default="round_robin"),
        "flapping_detect": Struct({
            "enable": Field("bool", default=False),
            "max_count": Field("int", default=15),
            "window_time": Field("duration", default=60.0),
            "ban_time": Field("duration", default=300.0),
        }),
        "force_gc": Struct({
            "enable": Field("bool", default=True),
            "count": Field("int", default=16000),
            "bytes": Field("bytesize", default=16 * 1024 * 1024),
        }),
        "sysmon": Struct({
            "os": Struct({
                "cpu_high_watermark": Field("float", default=0.80),
                "cpu_low_watermark": Field("float", default=0.60),
                "mem_high_watermark": Field("float", default=0.70),
            }),
        }, open=True),
        "sys_topics": Struct({
            "sys_msg_interval": Field("duration", default=60.0),
            "sys_heartbeat_interval": Field("duration", default=30.0),
        }),
        "log": Struct({
            "level": Field("enum",
                           enum=["debug", "info", "warning", "error"],
                           default="warning"),
            "to": Field("enum", enum=["console", "file", "both"],
                        default="console"),
            "file": Field("string", default="log/emqx.log"),
            # emqx_logger_jsonfmt vs textfmt (emqx_conf_schema
            # log.console.formatter)
            "formatter": Field("enum", enum=["text", "json"],
                               default="text"),
        }),
        "prometheus": Struct({
            "enable": Field("bool", default=False),
            "port": Field("int", default=18083),
        }, open=True),
        "rule_engine": Field("map", default={}),
        "bridges": Field("map", default={}),
        "gateway": Field("map", default={}),
        "rewrite": Field("array", default=[], item=Field("map")),
        "auto_subscribe": Struct({
            "topics": Field("array", default=[], item=Field("map")),
        }),
        "telemetry": Struct({
            "enable": Field("bool", default=False),
        }),
        # emqx_exhook_schema: out-of-process hook providers; url scheme
        # grpc:// = real HookProvider service, framed:// = the
        # documented JSON framing (exhook/proto.py)
        "exhook": Struct({
            "servers": Field("array", default=[], item=Field("map")),
        }),
        "statsd": Struct({
            "enable": Field("bool", default=False),
            "server": Field("string", default="127.0.0.1:8125"),
            "flush_time_interval": Field("duration", default=30.0),
        }),
        "psk_authentication": Struct({
            "enable": Field("bool", default=False),
            "init_file": Field("string", default=""),
            "separator": Field("string", default=":"),
        }),
        "slow_subs": Struct({
            "enable": Field("bool", default=True),
            "threshold": Field("duration", default=0.5),
            "top_k_num": Field("int", default=10),
            "expire_interval": Field("duration", default=300.0),
        }),
        "api": Struct({
            "enable": Field("bool", default=False),
            "bind": Field("string", default="127.0.0.1:18083"),
        }, open=True),
        "limiter": Field("map", default={}),
    })
