"""Standalone cluster peer process — one real broker node in its own OS
process, the piece ``ct_slave`` provides the reference (real peer BEAM
nodes on one host, emqx_common_test_helpers.erl:553-620). The test
harness spawns N of these, wires their loopback cluster ports together,
and drives them with real MQTT clients; killing one exercises the
failure-detection path for real.

Usage:
    python -m emqx_tpu_torch.cluster.peer --name n1 \
        --cluster-port 7001 --mqtt-port 1884 \
        --peer n2:127.0.0.1:7002 --seed n2

Prints ``READY <mqtt_port> <mgmt_port> rlog=<v>`` on stdout once both
listeners serve; ``rlog=<v>`` is the rlog BPAPI version negotiated with
the join seed (or this node's own max when it boots alone) — the
mixed-version interop test asserts the downshift on it.
"""

from __future__ import annotations

import argparse
import asyncio
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--cluster-port", type=int, default=0)
    ap.add_argument("--mqtt-port", type=int, default=0)
    ap.add_argument("--peer", action="append", default=[],
                    help="name:host:port, repeatable")
    ap.add_argument("--seed", default=None,
                    help="node name to join (first peer by default)")
    ap.add_argument("--role", default="core",
                    choices=["core", "replicant"])
    ap.add_argument("--mgmt", action="store_true",
                    help="also serve the REST API (port printed on READY)")
    args = ap.parse_args()

    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.broker.server import BrokerServer
    from emqx_tpu_torch.cluster.node import ClusterNode
    from emqx_tpu_torch.cluster.transport import TcpTransport
    from emqx_tpu_torch.config.config import Config

    conf = Config()
    conf.init_load("")
    app = BrokerApp.from_config(conf, node=args.name)
    transport = TcpTransport(args.name, port=args.cluster_port)
    for spec in args.peer:
        name, host, port = spec.rsplit(":", 2)
        transport.add_peer(name, host, int(port))
    node = ClusterNode(args.name, transport, app=app, role=args.role)
    if args.peer:
        seed = args.seed or args.peer[0].split(":", 1)[0]
        node.join([seed])

    mgmt_port = 0
    if args.mgmt:
        from emqx_tpu_torch.mgmt.api import ManagementApi
        mgmt = ManagementApi(app, cluster_node=node)
        mgmt_port = mgmt.start()

    async def serve() -> None:
        from emqx_tpu_torch.cluster import bpapi

        server = BrokerServer(port=args.mqtt_port, app=node.app)
        await server.start()
        rlog_v = (min(node.proto_rlog.values()) if node.proto_rlog
                  else max(bpapi.supported_versions()["rlog"]))
        print(f"READY {server.port} {mgmt_port} rlog={rlog_v}",
              flush=True)
        await asyncio.Event().wait()          # run until killed

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
