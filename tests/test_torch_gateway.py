"""The port's protocol gateways (``emqx_tpu_torch/gateway/``: the TCP and
UDP adapters, STOMP, MQTT-SN, CoAP, LwM2M with its object registry and
TLV codec, ExProto over the framed handler and over gRPC) against the
reference's.

- The cases of ``tests/test_gateway.py`` and ``test_exproto_grpc.py`` over
  both packages (``pkg``), from the reference's own source with the package
  name pointed at the port for ``port``, each over its package's own
  ``BrokerApp``.
- Every module of the slice has the reference's public names, signatures
  and constants.
- ``import emqx_tpu_torch.gateway.exproto_grpc`` succeeds where ``grpc``
  does not import, as on the card's machine.
- The gateways as a whole: one seeded scenario of STOMP, MQTT-SN and CoAP
  subscribers over each package's ``BrokerApp`` with a CPU ``RouterModel``,
  fed by ``Broker.publish_batch`` and by the ``PublishPipeline``, gives
  exactly the same frames, delivery maps and route tables.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_harness import PKGS, REPO, app_class, call_reference, \
    reference_calls, reference_case_names, waiting
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

REFERENCE = {"test_gateway": 53, "test_exproto_grpc": 3}
CASES = [(name, case, i) for name in REFERENCE
         for case, i in reference_calls(name, waiting(name))]


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_case_names(name)) == n, name
        assert not waiting(name), name
    assert not waiting("test_mgmt")
    assert len(CASES) == sum(REFERENCE.values())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,case,i", CASES)
def test_reference_gateway_case(name, case, i, pkg, tmp_path, monkeypatch,
                                capsys):
    monkeypatch.chdir(tmp_path)
    call_reference(name, pkg, case, i, tmp_path=tmp_path,
                   monkeypatch=monkeypatch, capsys=capsys)


def mod(pkg: str, name: str):
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    return importlib.import_module(f"{root}.{name}")


MODULES = ["gateway.conn", "gateway.stomp", "gateway.mqttsn",
           "gateway.coap", "gateway.lwm2m_objects", "gateway.lwm2m_tlv",
           "gateway.lwm2m", "gateway.exproto", "gateway.exproto_grpc"]


@pytest.mark.parametrize("name", MODULES)
def test_public_names_and_signatures(name):
    """Every module of the slice has the reference module's public names,
    with the same signatures, methods and constants."""
    import test_torch_broker as tb
    r, p = tb._public(mod("ref", name)), tb._public(mod("port", name))
    assert sorted(p) == sorted(r)
    for n in r:
        if getattr(r[n], "__module__", None) == "typing":
            continue
        assert tb._shape(p[n]) == tb._shape(r[n]), n


def test_gateway_package_exports_the_reference_names():
    import inspect

    def names(pkg):
        return sorted(n for n, v in vars(mod(pkg, "gateway")).items()
                      if not (n.startswith("_") or inspect.ismodule(v)))
    assert names("port") == names("ref")


def test_exproto_grpc_imports_without_grpc():
    """The gRPC adapter imports ``grpc`` only where it serves, as the
    reference does: the module and its gateway class import with ``grpc``
    blocked."""
    code = ("import sys\n"
            "sys.modules['grpc'] = None\n"
            "from emqx_tpu_torch.gateway import exproto_grpc as g\n"
            "assert g.GrpcExprotoGateway and 'grpc' not in {\n"
            "    k for k, v in sys.modules.items() if v is not None}\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# the gateways as a whole over a CPU RouterModel
# ---------------------------------------------------------------------------

WORDS = ["a", "b", "c", "dd"]


def seeded_filter(rng) -> str:
    ws = [str(w) for w in rng.choice(WORDS + ["+"], int(rng.integers(1, 4)))]
    if rng.random() < 0.25:
        ws.append("#")
    return "/".join(ws)


def gateway_plan(seed: int) -> dict:
    """STOMP, MQTT-SN and CoAP subscribers, each on 2 filters of a small
    tree; batches of topics for ``publish_batch`` and for the pipeline."""
    rng = np.random.default_rng(seed)

    def filters():
        out = []
        while len(out) < 2:
            f = seeded_filter(rng)
            if f not in out:
                out.append(f)
        return out

    def topics(n):
        return ["/".join(str(w) for w in rng.choice(
            WORDS, int(rng.integers(1, 5)))) for _ in range(n)]

    return {"stomp": [filters() for _ in range(4)],
            "sn": [filters() for _ in range(4)],
            "coap": [filters() for _ in range(3)],
            "batches": [topics(int(rng.integers(8, 24))) for _ in range(3)],
            "pipe": topics(24)}


def cpu_model():
    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex
    return RouterModel(TrieIndex(max_levels=8), n_sub_slots=64, K=16, M=32,
                       ret_cap=8, device="cpu")


async def drain(recv, quiet_s: float = 0.3) -> list:
    """What a client receives until it has been quiet for ``quiet_s``."""
    out = []
    while True:
        try:
            out.append(await recv(timeout=quiet_s))
        except asyncio.TimeoutError:
            return out


def frame_key(pkg: str, f) -> tuple:
    """A received frame of either package as plain data."""
    if type(f).__name__ == "StompFrame":
        return ("stomp", f.command, sorted(f.headers.items()), f.body)
    if type(f).__name__ == "SnMessage":
        return ("sn", f.type, f.flags, f.topic_id, f.msg_id, f.topic_name,
                f.rc, f.data)
    return ("coap", f.type, f.code, f.mid, f.token, f.options, f.payload)


def gateway_run(pkg: str, seed: int) -> dict:
    return asyncio.run(_gateway_run(pkg, seed))


async def _gateway_run(pkg: str, seed: int) -> dict:
    """``pkg``'s ``BrokerApp`` over a CPU ``RouterModel`` with its STOMP,
    MQTT-SN and CoAP gateways on 127.0.0.1, the clients of
    ``tests/test_gateway.py`` (on ``pkg``'s codecs) subscribed by
    :func:`gateway_plan`; its batches through ``Broker.publish_batch``
    (each delivery map dispatched by the CM) and its pipeline topics
    through ``PublishPipeline.submit`` + ``flush`` (its knee 0, so that
    batch takes the step too).  Returns every frame
    each client received, the delivery maps, the route tables, the
    gateways' client lists and the model's step count."""
    from test_torch_harness import delivery_map, reference_tests
    t = reference_tests("test_gateway", pkg)
    ST, SN, C = t.ST, t.SN, t.C
    Message = mod(pkg, "core.message").Message
    plan = gateway_plan(seed)
    model = cpu_model()
    app = app_class(pkg)(router_model=model)
    app.pipeline.min_device_batch = 0     # every batch on the step
    gws = [app.gateway.load(ST.StompGateway(port=0)),
           app.gateway.load(SN.MqttsnGateway(port=0)),
           app.gateway.load(C.CoapGateway(port=0))]
    for gw in gws:
        await gw.start_listeners()
    clients, acks = [], []
    try:
        for i, filters in enumerate(plan["stomp"]):
            c = t.StompClient(gws[0].port)
            await c.connect()
            await c.send("CONNECT", {"accept-version": "1.2",
                                     "client-id": f"st{i}"})
            acks.append(frame_key(pkg, await c.recv()))
            for k, f in enumerate(filters):
                await c.send("SUBSCRIBE", {"id": str(k), "destination": f,
                                           "receipt": f"r{k}"})
                acks.append(frame_key(pkg, await c.recv()))
            clients.append(c)
        for i, filters in enumerate(plan["sn"]):
            c = t.SnClient(gws[1].port)
            await c.start()
            c.send(SN.SnMessage(SN.CONNECT, clientid=f"sn{i}"))
            acks.append(frame_key(pkg, await c.recv()))
            for k, f in enumerate(filters):
                c.send(SN.SnMessage(SN.SUBSCRIBE, flags=SN.qos_flags(0),
                                    msg_id=k + 1, topic_name=f))
                acks.append(frame_key(pkg, await c.recv()))
            clients.append(c)
        for i, filters in enumerate(plan["coap"]):
            c = t.CoapClient(gws[2].port)
            await c.start()
            for k, f in enumerate(filters):
                c.request(C.GET, f"ps/{f}", token=b"o%d" % k,
                          options=[(C.OPT_OBSERVE, b"")],
                          queries=[f"clientid=co{i}"])
                acks.append(frame_key(pkg, await c.recv()))
            clients.append(c)
        steps = model.launch_count
        maps = []
        for b, topics in enumerate(plan["batches"]):
            msgs = [Message(topic=tp, payload=b"b%d-%d" % (b, k))
                    for k, tp in enumerate(topics)]
            for d in app.broker.publish_batch(msgs):
                maps.append(delivery_map(d))
                app.cm.dispatch(d)
        for k, tp in enumerate(plan["pipe"]):
            app.pipeline.submit(Message(topic=tp, payload=b"p-%d" % k))
        app.pipeline.flush()
        got = [[frame_key(pkg, f) for f in fs] for fs in
               await asyncio.gather(*(drain(c.recv) for c in clients))]
        return dict(
            acks=acks, got=got, maps=maps,
            steps=model.launch_count - steps,
            host_batches=app.pipeline.host_batches,
            routes=sorted(app.broker.router.dump()),
            suboptions=sorted(app.broker.suboption),
            gateways=[(row["name"], row["current_connections"])
                      for row in app.gateway.list()],
            clients={n: [c["clientid"] for c in app.gateway.clients(n)]
                     for n in ("stomp", "mqttsn", "coap")})
    finally:
        for c in clients:
            if hasattr(c, "w"):
                c.w.close()
            else:
                c.tr.close()
        for gw in gws:
            await gw.stop_listeners()


@pytest.mark.parametrize("seed", range(2))
def test_gateways_over_the_step_match_the_reference(seed):
    """One seeded scenario of STOMP, MQTT-SN and CoAP subscribers over each
    package's ``BrokerApp`` with a CPU ``RouterModel``: the same frames to
    every client, the same delivery maps, route tables and gateway client
    lists, and every batch through the step."""
    ref, port = gateway_run("ref", seed), gateway_run("port", seed)
    assert port == ref
    plan = gateway_plan(seed)
    assert ref["steps"] == len(plan["batches"]) + 1
    assert ref["host_batches"] == 0
    assert all(ref["got"][:4]) and any(ref["got"][4:8]) \
        and any(ref["got"][8:])
    assert {c for cs in ref["clients"].values() for c in cs} == {
        *(f"st{i}" for i in range(4)), *(f"sn{i}" for i in range(4)),
        *(f"co{i}" for i in range(3))}
