"""The port's TLS helpers (``emqx_tpu_torch/broker/tls.py``) and its TLS
listeners against the reference's.

Every case of ``tests/test_tls.py`` over both packages (``pkg``), from the
reference's own source with the package name pointed at the port for
``port``: each package's own ``BrokerApp``, ``Listeners`` and ``Config``
(``test_psk_handshake`` keeps the reference's skip: a TLS-PSK handshake
needs CPython 3.13).  The cases that need no app also run written out here,
each package's ``BrokerServer`` / ``WsBrokerServer`` over its own
``Broker`` and ``CM`` with a server context from its own ``tls`` module, and
its own ``MqttClient``.  Besides: the contexts both modules build from the
same ``ssl_options`` have the same versions, verify mode, hostname check and
ciphers, and ``peer_cert_identity`` gives the same fields.

The test PKI is generated with the ``cryptography`` package; where it is
missing the tests that need certificates skip, as the reference's do.
"""

from __future__ import annotations

import asyncio
import base64
import datetime
import os
import ssl

import pytest

from test_torch_harness import PKGS, call_reference, net, \
    reference_calls, reference_case_names

TLS = reference_calls("test_tls")


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """CA + server cert (CN=localhost, SAN 127.0.0.1) + client cert
    (CN=device-007), as tests/test_tls.py makes them."""
    pytest.importorskip("cryptography",
                        reason="the test PKI is made with `cryptography`")
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("pki")
    now = datetime.datetime(2026, 1, 1)
    until = now + datetime.timedelta(days=3650)

    def write(name, key, cert):
        (d / f"{name}.key").write_bytes(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
        (d / f"{name}.pem").write_bytes(
            cert.public_bytes(serialization.Encoding.PEM))

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "test-ca")])
    ca = (x509.CertificateBuilder()
          .subject_name(ca_name).issuer_name(ca_name)
          .public_key(ca_key.public_key())
          .serial_number(x509.random_serial_number())
          .not_valid_before(now).not_valid_after(until)
          .add_extension(x509.BasicConstraints(ca=True, path_length=1),
                         critical=True)
          .sign(ca_key, hashes.SHA256()))
    write("ca", ca_key, ca)

    def issue(name, cn, san=False):
        key = ec.generate_private_key(ec.SECP256R1())
        builder = (x509.CertificateBuilder()
                   .subject_name(x509.Name(
                       [x509.NameAttribute(NameOID.COMMON_NAME, cn),
                        x509.NameAttribute(NameOID.ORGANIZATION_NAME,
                                           "emqx-tpu-test")]))
                   .issuer_name(ca_name)
                   .public_key(key.public_key())
                   .serial_number(x509.random_serial_number())
                   .not_valid_before(now).not_valid_after(until))
        if san:
            builder = builder.add_extension(
                x509.SubjectAlternativeName(
                    [x509.DNSName("localhost"),
                     x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
        write(name, key, builder.sign(ca_key, hashes.SHA256()))

    issue("server", "localhost", san=True)
    issue("client", "device-007")
    return d


def server_opts(pki, **extra):
    return {"certfile": str(pki / "server.pem"),
            "keyfile": str(pki / "server.key"),
            "cacertfile": str(pki / "ca.pem"), **extra}


def client_opts(pki, with_cert=False, **extra):
    o = {"cacertfile": str(pki / "ca.pem"), **extra}
    if with_cert:
        o.update(certfile=str(pki / "client.pem"),
                 keyfile=str(pki / "client.key"))
    return o


def test_reference_case_count():
    assert len(reference_case_names("test_tls")) == 15 == len(TLS)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", TLS)
def test_reference_tls_case(case, i, pkg, pki, tmp_path):
    if case == "test_psk_handshake":
        tls = net(pkg).tls
        if not tls.psk_supported():      # the reference's own skip
            pytest.skip("stdlib TLS-PSK callbacks need CPython >= 3.13")
    call_reference("test_tls", pkg, case, i, pki=pki, tmp_path=tmp_path)


def serve_tls(n, scenario, ws: bool = False, **kw):
    """Run ``scenario(server, cm)`` against a TLS listener of package
    ``n`` over a fresh Broker and CM."""
    async def main():
        cm = n.CM()
        cls = n.ws.WsBrokerServer if ws else n.BrokerServer
        server = cls(port=0, broker=n.Broker(), cm=cm, **kw)
        await server.start()
        try:
            await scenario(server, cm)
        finally:
            await server.stop()
    asyncio.run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_tls_connect_pub_sub(pki, pkg):
    n = net(pkg)

    async def scenario(server, cm):
        clients = [n.MqttClient(
            port=server.port, clientid=cid, proto_ver=5,
            ssl=n.tls.make_client_context(client_opts(pki)),
            server_hostname="localhost") for cid in ("s1", "p1")]
        sub, pub = clients
        await sub.connect()
        await sub.subscribe("secure/+", qos=1)
        await pub.connect()
        await pub.publish("secure/x", b"over-tls", qos=1)
        msg = await sub.recv()
        assert (msg.topic, msg.payload, msg.qos) == ("secure/x",
                                                     b"over-tls", 1)
        for c in clients:
            await c.disconnect()

    serve_tls(n, scenario, ssl_context=n.tls.make_server_context(
        server_opts(pki)))


@pytest.mark.parametrize("pkg", PKGS)
def test_tls_refuses_untrusted_server_cert(pki, pkg):
    n = net(pkg)

    async def scenario(server, cm):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)   # system CAs only
        c = n.MqttClient(port=server.port, ssl=ctx,
                         server_hostname="localhost")
        with pytest.raises(ssl.SSLError):
            await c.connect()

    serve_tls(n, scenario, ssl_context=n.tls.make_server_context(
        server_opts(pki)))


@pytest.mark.parametrize("pkg", PKGS)
def test_mutual_tls_requires_client_cert(pki, pkg):
    n = net(pkg)

    async def scenario(server, cm):
        # TLS 1.2 for the probe without a certificate: there the refusal
        # comes in the handshake (under 1.3 only at the first read)
        nocert = n.MqttClient(
            port=server.port, clientid="nc", proto_ver=5,
            ssl=n.tls.make_client_context(client_opts(
                pki, versions=["tlsv1.2"])),
            server_hostname="localhost")
        with pytest.raises((ssl.SSLError, ConnectionError)):
            await nocert.connect()
        ok = n.MqttClient(
            port=server.port, clientid="ok", proto_ver=5,
            ssl=n.tls.make_client_context(client_opts(pki, with_cert=True)),
            server_hostname="localhost")
        await ok.connect()
        assert ok.connack.reason_code == 0
        await ok.disconnect()

    serve_tls(n, scenario, ssl_context=n.tls.make_server_context(
        server_opts(pki, verify="verify_peer", fail_if_no_peer_cert=True)))


@pytest.mark.parametrize("field", ["username", "clientid"])
@pytest.mark.parametrize("pkg", PKGS)
def test_peer_cert_identity_replaces_connect_field(pki, pkg, field):
    """verify_peer + ``peer_cert_as_username`` / ``_clientid`` = cn: the
    channel sees the client certificate's CN, whatever the CONNECT says."""
    n = net(pkg)

    async def scenario(server, cm):
        c = n.MqttClient(
            port=server.port, clientid="c7", proto_ver=5,
            username="ignored", password=b"x",
            ssl=n.tls.make_client_context(client_opts(pki, with_cert=True)),
            server_hostname="localhost")
        await c.connect()
        if field == "username":
            chan = cm.lookup_channel("c7")
            assert chan.conninfo.username == "device-007"
        else:
            chan = cm.lookup_channel("device-007")
            assert cm.lookup_channel("c7") is None
            assert chan.conninfo.username == "ignored"
        await c.disconnect()

    serve_tls(n, scenario, ssl_context=n.tls.make_server_context(
        server_opts(pki, verify="verify_peer", fail_if_no_peer_cert=True)),
        **{f"peer_cert_as_{field}": "cn"})


@pytest.mark.parametrize("pkg", PKGS)
def test_wss_full_mqtt_flow(pki, pkg):
    n = net(pkg)
    W, P = n.ws, n.P

    async def scenario(server, cm):
        r, w = await asyncio.open_connection(
            "127.0.0.1", server.port,
            ssl=n.tls.make_client_context(client_opts(pki)),
            server_hostname="localhost")
        key = base64.b64encode(os.urandom(16)).decode()
        w.write((f"GET /mqtt HTTP/1.1\r\nHost: localhost\r\n"
                 "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                 f"Sec-WebSocket-Key: {key}\r\n"
                 "Sec-WebSocket-Version: 13\r\n"
                 "Sec-WebSocket-Protocol: mqtt\r\n\r\n").encode())
        resp = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 5)
        assert b"101" in resp.split(b"\r\n")[0]
        assert W.accept_key(key).encode() in resp
        dec, parser = W.FrameDecoder(require_mask=False), n.Parser()
        w.write(W.encode_frame(W.OP_BINARY, n.serialize(
            P.Connect(proto_ver=P.MQTT_V4, clientid="wss1"), P.MQTT_V4),
            mask=True))
        await w.drain()
        pkts = []
        while not pkts:
            data = await asyncio.wait_for(r.read(4096), 5)
            for op, payload in dec.feed(data):
                if op == W.OP_BINARY:
                    pkts.extend(parser.feed(payload))
        assert pkts[0].type == P.CONNACK and pkts[0].reason_code == 0
        assert cm.lookup_channel("wss1") is not None
        w.close()

    serve_tls(n, scenario, ws=True, ssl_context=n.tls.make_server_context(
        server_opts(pki)))


# ---------------------------------------------------------------------------
# the helpers, held to each other
# ---------------------------------------------------------------------------


class Psk:
    """The ``lookup`` a PSK store offers the server context."""

    def lookup(self, identity: str):
        return {"dev1": bytes.fromhex("deadbeef")}.get(identity)


@pytest.mark.parametrize("pkg", PKGS)
def test_psk_gating_matches_runtime(pkg):
    tls = net(pkg).tls
    if tls.psk_supported():
        assert tls.make_server_context(
            {"ciphers": ["PSK-AES128-GCM-SHA256"], "versions": ["tlsv1.2"]},
            psk_store=Psk()) is not None
    else:
        with pytest.raises(RuntimeError, match="3.13"):
            tls.make_server_context({}, psk_store=Psk())


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_tls_versions_are_config_errors(pki, pkg):
    tls = net(pkg).tls
    with pytest.raises(ValueError, match="unknown TLS version"):
        tls.make_server_context(server_opts(pki, versions=["tls1.2"]))
    with pytest.raises(ValueError, match="non-contiguous"):
        tls.make_server_context(
            server_opts(pki, versions=["tlsv1", "tlsv1.3"]))


def context_key(ctx: ssl.SSLContext) -> tuple:
    return (ctx.minimum_version, ctx.maximum_version, ctx.verify_mode,
            ctx.check_hostname,
            tuple(c["name"] for c in ctx.get_ciphers()))


SERVER_OPTS = [{}, {"versions": ["tlsv1.2"]}, {"versions": ["tlsv1.3"]},
               {"verify": "verify_peer"},
               {"verify": "verify_peer", "fail_if_no_peer_cert": True},
               {"ciphers": ["ECDHE-ECDSA-AES128-GCM-SHA256"],
                "versions": ["tlsv1.2"]}]
CLIENT_OPTS = [{}, {"verify": "verify_none"}, {"versions": ["tlsv1.2"]},
               {"with_cert": True}]


def test_contexts_equal(pki):
    for opts in SERVER_OPTS:
        got = {pkg: context_key(net(pkg).tls.make_server_context(
            server_opts(pki, **opts))) for pkg in PKGS}
        assert got["port"] == got["ref"], opts
    for opts in CLIENT_OPTS:
        got = {pkg: context_key(net(pkg).tls.make_client_context(
            client_opts(pki, **opts))) for pkg in PKGS}
        assert got["port"] == got["ref"], opts


PEERCERTS = [
    None, {},
    {"subject": ((("commonName", "device-007"),),
                 (("organizationName", "acme"),))},
    {"subject": ((("countryName", "SE"),), (("commonName", "a"),),
                 (("commonName", "b"),), (("emailAddress", "x@y"),),
                 (("serialNumber", "42"),))},
]


def test_peer_cert_identity_fields_equal():
    for cert in PEERCERTS:
        assert (net("port").tls.peer_cert_identity(cert)
                == net("ref").tls.peer_cert_identity(cert))
    ident = net("port").tls.peer_cert_identity(PEERCERTS[2])
    assert ident["cn"] == "device-007"
    assert "CN=device-007" in ident["dn"] and "O=acme" in ident["dn"]
