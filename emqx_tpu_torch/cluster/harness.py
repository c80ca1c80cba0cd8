"""Multi-node-on-one-host test harness — the
``emqx_common_test_helpers:emqx_cluster/2`` analogue (SURVEY.md §4.3):
N real broker nodes with the real replication/RPC stack, no real
network (LocalBus) or loopback TCP (TcpTransport), one process.
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.cluster.node import ClusterNode
from emqx_tpu_torch.cluster.transport import LocalBus, TcpTransport


def make_cluster(n: int, transport: str = "local",
                 names: Optional[list[str]] = None,
                 **app_kw) -> list[ClusterNode]:
    """Boot an n-node cluster, fully joined. ``transport``: "local"
    (in-process bus) or "tcp" (loopback sockets)."""
    names = names or [f"node{i + 1}" for i in range(n)]
    nodes: list[ClusterNode] = []
    if transport == "local":
        fabric = LocalBus.Fabric()
        for name in names:
            nodes.append(ClusterNode(name, LocalBus(name, fabric),
                                     **app_kw))
        for node in nodes:
            node.fabric = fabric
    else:
        transports = [TcpTransport(name) for name in names]
        for t in transports:
            for u in transports:
                if t is not u:
                    t.add_peer(u.node, u.host, u.port)
        for name, t in zip(names, transports):
            nodes.append(ClusterNode(name, t, **app_kw))
    # join everyone to the first seed (static discovery)
    for node in nodes[1:]:
        node.join([names[0]])
    sync(nodes)
    return nodes


def sync(nodes: list[ClusterNode]) -> None:
    """Flush every node's replication stream (deterministic settle)."""
    for node in nodes:
        node.flush()


def stop(nodes: list[ClusterNode]) -> None:
    for node in nodes:
        node.transport.close()
