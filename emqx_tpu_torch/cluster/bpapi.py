"""BPAPI — versioned cross-node protos, parity with
``apps/emqx/src/bpapi/`` + the static snapshot check
(``apps/emqx/test/emqx_bpapi_static_checks.erl``).

Every cross-node call goes through a registered proto: a named,
versioned bundle of method signatures. Signatures are FROZEN once
released — ``snapshot()`` renders the registry to a canonical dict that
a test pins verbatim; any drift fails the suite, which is exactly the
mechanism that makes rolling upgrades safe in the reference. A node
announces ``supported_versions()`` at join; callers pick
``negotiate(peer_versions, proto)`` = highest common version.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Proto:
    name: str
    version: int
    # method name → argument names (the wire signature)
    methods: dict = field(default_factory=dict)

    @property
    def id(self) -> str:
        return f"{self.name}_v{self.version}"


_REGISTRY: dict[str, Proto] = {}


def register(proto: Proto) -> Proto:
    if proto.id in _REGISTRY and _REGISTRY[proto.id] != proto:
        raise ValueError(f"BPAPI {proto.id} redefined with new signature")
    _REGISTRY[proto.id] = proto
    return proto


def get(name: str, version: int) -> Proto:
    return _REGISTRY[f"{name}_v{version}"]


def snapshot() -> dict[str, dict]:
    """Canonical registry dump — pinned by tests/test_cluster.py."""
    return {
        p.id: {m: list(args) for m, args in sorted(p.methods.items())}
        for p in sorted(_REGISTRY.values(), key=lambda p: p.id)
    }


def supported_versions() -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    for p in _REGISTRY.values():
        out.setdefault(p.name, []).append(p.version)
    return {k: sorted(v) for k, v in out.items()}


def negotiate(peer_versions: dict[str, list[int]], name: str) -> int:
    """Highest proto version both sides speak (emqx_bpapi:supported_version)."""
    mine = set(supported_versions().get(name, ()))
    theirs = set(peer_versions.get(name, ()))
    common = mine & theirs
    if not common:
        raise ValueError(f"no common version for BPAPI {name!r}")
    return max(common)


# -- the v1 protos (mirroring apps/emqx/src/proto/*_proto_v1.erl) ---------

BROKER_V1 = register(Proto("broker", 1, {
    # emqx_broker_proto_v1:forward_async/3 — dispatch on the remote node
    "dispatch": ["filter", "msg"],
}))

CM_V1 = register(Proto("cm", 1, {
    # emqx_cm_proto_v1: takeover_session / kick / lookup
    "takeover": ["clientid"],
    "kick": ["clientid"],
    "lookup": ["clientid"],
}))

SHARED_SUB_V1 = register(Proto("shared_sub", 1, {
    # emqx_shared_sub_proto_v1:dispatch — deliver to a group member
    "deliver": ["sid", "sub_topic", "msg"],
}))

RLOG_V1 = register(Proto("rlog", 1, {
    # mria-rlog analogue: delta stream + bootstrap
    "apply_deltas": ["from_node", "deltas"],
    "bootstrap": ["from_node"],
    "shared_delta": ["from_node", "op", "group", "topic", "sid"],
    "registry_delta": ["from_node", "op", "clientid"],
}))

EXCL_V1 = register(Proto("excl", 1, {
    # $exclusive cluster lock (emqx_exclusive_subscription try_subscribe):
    # peer-confirmed acquire + release broadcast + periodic claim sync
    # (the GC for claims orphaned by lost casts)
    "try": ["from_node", "topic", "sid"],
    "release": ["from_node", "topic", "sid"],
    "sync": ["from_node", "holders"],
}))

NODE_V1 = register(Proto("node", 1, {
    "hello": ["node", "versions"],
    "ping": ["node"],
    "bye": ["node"],
}))


# -- v2 protos (opt-in rollouts) -------------------------------------------
#
# RLOG v2 compacts the delta stream: ``apply_deltas2`` carries
# (op, topic, dest) tuples instead of keyed dicts. Registration is
# OPT-IN via EMQX_BPAPI_RLOG_V2=1 — exactly the reference's
# rolling-upgrade shape (a cluster mixes releases mid-upgrade): a node
# without the flag announces rlog [1], ``negotiate`` downshifts the v2
# node to the v1 dict wire, and route replication keeps flowing either
# way (tests/test_cluster_procs.py drives both mixes with real
# processes). The v1 signature stays frozen per the snapshot pin.
RLOG_V2 = None
if os.environ.get("EMQX_BPAPI_RLOG_V2"):
    RLOG_V2 = register(Proto("rlog", 2, {
        "apply_deltas": ["from_node", "deltas"],
        "apply_deltas2": ["from_node", "deltas"],
        "bootstrap": ["from_node"],
        "shared_delta": ["from_node", "op", "group", "topic", "sid"],
        "registry_delta": ["from_node", "op", "clientid"],
    }))
