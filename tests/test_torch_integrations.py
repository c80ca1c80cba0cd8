"""The port's integrations (``emqx_tpu_torch/connector/``, the DB-backed
access backends ``access/{db,redis,ldap}_backends.py``, ``exhook/``,
``cluster/codec.py`` and ``utils/snappy.py``) against the reference's.

- The cases of ``tests/test_exhook.py``, ``test_exhook_grpc.py``,
  ``test_db_backends.py``, ``test_redis.py``, ``test_ldap.py``,
  ``test_bridge.py``, ``test_kafka.py``, ``test_gcp_pubsub.py``,
  ``test_snappy.py`` and ``test_props_codecs.py`` over both packages
  (``pkg``), from the reference's own source with the package name pointed
  at the port for ``port``, against the in-repo mini servers, every case
  of them (``test_snappy``'s native-vs-Python differential on each
  package's own native library).
- Exhook verdicts: over one seeded message stream, both packages' exhook
  chains (a provider that drops, rewrites and passes) give the same
  verdicts per message and batched, and ``pbwire`` encodes the same bytes.
- The DB-backed authn and authz backends of both packages give the same
  answers against the same mini servers.
- A Kafka record batch is byte-equal in both packages, snappy on and off,
  with snappy on both packages' native codecs and on both Python paths.
- ``BrokerApp.from_config`` boots an ``exhook.servers`` entry and authn and
  authz on each DB backend, where the port raised before.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_harness import PKGS, call_reference, reference_calls, \
    reference_case_names, waiting
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

REFERENCE = {"test_exhook": 7, "test_exhook_grpc": 7, "test_db_backends": 8,
             "test_redis": 10, "test_ldap": 12, "test_bridge": 13,
             "test_kafka": 8, "test_gcp_pubsub": 6, "test_snappy": 8,
             "test_props_codecs": 10}
CASES = [(name, case, i) for name in REFERENCE
         for case, i in reference_calls(name, waiting(name))]


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_case_names(name)) == n, name
    assert not [n for n in REFERENCE if waiting(n)]
    # test_db_backends: two cases over pgsql, mysql and mongodb
    assert len(CASES) == sum(REFERENCE.values()) + 4


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,case,i", CASES)
def test_reference_integration_case(name, case, i, pkg, tmp_path,
                                    monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    call_reference(name, pkg, case, i, tmp_path=tmp_path,
                   monkeypatch=monkeypatch, capsys=capsys)


def mod(pkg: str, name: str):
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    return importlib.import_module(f"{root}.{name}")


MODULES = [
    "session.persistent", "mgmt.swagger", "mgmt.cli", "mgmt.api",
    "cluster.codec", "exhook.pbwire", "exhook.proto", "exhook.provider",
    "exhook.server", "exhook.grpc_transport", "utils.snappy",
    "connector.memory", "connector.http", "connector.mqtt",
    "connector.redis", "connector.mysql", "connector.pgsql",
    "connector.mongodb", "connector.ldap", "connector.kafka",
    "connector.gcp_pubsub", "access.db_backends", "access.redis_backends",
    "access.ldap_backends"]


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


def test_subpackages_export_the_reference_names():
    import inspect
    for sub in ("mgmt", "cluster", "exhook", "connector", "session"):
        def names(pkg):
            return sorted(n for n, v in vars(mod(pkg, sub)).items()
                          if not (n.startswith("_") or inspect.ismodule(v)))
        assert names("port") == names("ref"), sub


# ---------------------------------------------------------------------------
# exhook: verdicts and wire bytes
# ---------------------------------------------------------------------------

def marking_provider(pkg: str):
    """``pkg``'s ``HookProvider`` that drops a message whose payload
    starts ``drop``, moves one whose payload starts ``rw`` to ``rw/`` +
    its topic (payload suffixed ``!``) and passes the rest."""
    proto = mod(pkg, "exhook.proto")

    class Marking(mod(pkg, "exhook.provider").HookProvider):
        def on_message_publish(self, args):
            m = args["message"]
            if m["payload"].startswith(b"drop"):
                return {"type": proto.STOP_AND_RETURN,
                        "value": {"drop": True}}
            if m["payload"].startswith(b"rw"):
                return {"type": proto.STOP_AND_RETURN, "value": {
                    "message": {**m, "topic": "rw/" + m["topic"],
                                "payload": m["payload"] + b"!"}}}
            return {"type": proto.CONTINUE}

        def on_client_connected(self, args):
            return None

    return Marking()


def seeded_messages(pkg: str, seed: int, n: int = 48) -> list:
    rng = np.random.default_rng(seed)
    Message = mod(pkg, "core.message").Message
    out = []
    for i in range(n):
        topic = "/".join(rng.choice(["a", "b", "dd", "$SYS"] if i % 7 == 0
                                    else ["a", "b", "dd"],
                                    int(rng.integers(1, 4))))
        mark = ["", "drop", "rw"][int(rng.integers(0, 3))]
        out.append(Message(topic=topic, payload=f"{mark}-{i}".encode(),
                           qos=int(rng.integers(0, 2)), from_=f"c{i % 5}",
                           id=1000 + i, timestamp=1_700_000_000_000 + i))
    return out


def verdict(m) -> tuple:
    if m is None:
        return None
    return (m.topic, m.payload, m.qos, m.from_, m.id,
            m.headers.get("allow_publish", True))


def exhook_run(pkg: str, seed: int) -> dict:
    """``pkg``'s exhook chain over one provider: each seeded message's
    ``message.publish`` fold (the hook the app wires), then the same
    messages through ``on_message_publish_batch`` once."""
    ProviderServer = mod(pkg, "exhook.provider").ProviderServer
    server_mod = mod(pkg, "exhook.server")
    app = mod(pkg, "app").BrokerApp()
    psrv = ProviderServer(marking_provider(pkg))
    psrv.start()
    mgr = server_mod.ExhookMgr(metrics=app.metrics)
    mgr.attach(app.hooks)
    wanted = mgr.enable(server_mod.ExhookServer(
        "p", psrv.host, psrv.port, pool_size=2, timeout_s=5.0))
    try:
        msgs = seeded_messages(pkg, seed)
        each = [verdict(app.hooks.run_fold("message.publish", (), m))
                for m in msgs]
        batch = [verdict(m) for m in mgr.on_message_publish_batch(msgs)]
        return dict(wanted=sorted(wanted), each=each, batch=batch,
                    calls=app.metrics.val("exhook.message_publish"),
                    batches=app.metrics.val("exhook.message_publish_batch"))
    finally:
        mgr.disable("p")
        psrv.stop()


@pytest.mark.parametrize("seed", range(3))
def test_exhook_verdicts_match_the_reference(seed):
    """Per message and batched, both packages' exhook chains give the same
    verdicts (drop, rewrite, pass), and outside ``$SYS`` the batch's
    verdicts are the per-message ones.  The per-message hook skips a
    ``$SYS`` topic and the batch lane does not, in both packages
    (``ROADMAP.md`` §3 R8)."""
    ref, port = exhook_run("ref", seed), exhook_run("port", seed)
    assert port == ref
    assert ref["wanted"] == ["client.connected", "message.publish"]
    msgs = seeded_messages("port", seed)
    sys_ = [m.topic.startswith("$SYS/") for m in msgs]
    each = [v if v is None or v[-1] else None for v in ref["each"]]
    assert [b for b, s in zip(ref["batch"], sys_) if not s] == [
        e for e, s in zip(each, sys_) if not s]
    assert any(sys_) and ref["batches"] == 1
    assert {m.payload.split(b"-")[0] for m in msgs} == {b"", b"drop", b"rw"}
    assert ref["calls"] == len(msgs) - sum(sys_)


def pb_args(seed: int) -> list:
    """Seeded RPC requests of every shape ``pbwire.build_request``
    encodes (client info, messages, the notify RPCs' positional args)."""
    rng = np.random.default_rng(seed)

    def text(k=8):
        return "".join(rng.choice(list("abcxyz/+#é$"),
                                  int(rng.integers(0, k))))

    out = []
    for _ in range(6):
        ci = {"clientid": text(), "username": text(), "password": text(),
              "peerhost": f"10.0.0.{rng.integers(1, 255)}:"
                          f"{rng.integers(1, 65535)}",
              "sockport": int(rng.integers(1, 65535)), "protocol": "mqtt",
              "mountpoint": text(), "is_superuser": bool(rng.integers(0, 2)),
              "anonymous": bool(rng.integers(0, 2)), "keepalive": 30,
              "proto_ver": 5}
        msg = {"node": "n1", "id": int(rng.integers(1 << 40)),
               "qos": int(rng.integers(0, 3)), "from": text(),
               "topic": text(12), "payload": bytes(rng.integers(
                   0, 256, int(rng.integers(0, 40)), dtype=np.uint8)),
               "timestamp": int(rng.integers(1 << 41)),
               "headers": {text(): text()}}
        out += [("OnProviderLoaded", {"broker": {"version": text()}}),
                ("OnClientConnect", {"args": [ci, {}]}),
                ("OnClientConnack", {"args": [ci, int(rng.integers(0, 3))]}),
                ("OnClientAuthenticate", {"clientinfo": ci}),
                ("OnClientAuthorize", {"clientinfo": ci, "type": str(
                    rng.choice(["publish", "subscribe"])),
                    "topic": text(12)}),
                ("OnMessagePublish", {"message": msg}),
                ("OnMessageDropped", {"message": msg, "reason": text()}),
                ("OnMessageDelivered", {"clientinfo": ci, "message": msg}),
                ("OnClientDisconnected", {"args": [ci, text()]}),
                ("OnSessionSubscribed", {"args": [ci, text(), {
                    "qos": 1, "rh": 0, "rap": 1, "nl": 0}]}),
                ("OnSessionTerminated", {"args": [ci, text()]}),
                ("OnMessageAcked", {"clientinfo": ci, "message": msg}),
                ("OnSessionResumed", {"args": [ci]})]
    return out


@pytest.mark.parametrize("seed", range(3))
def test_pbwire_bytes_match_the_reference(seed):
    """``pbwire.build_request`` encodes the same bytes in both packages,
    each package decodes the other's, and a valued response parses to the
    same verdict."""
    ref, port = mod("ref", "exhook.pbwire"), mod("port", "exhook.pbwire")
    rpcs = set()
    for rpc, args in pb_args(seed):
        a, b = ref.build_request(rpc, args), port.build_request(rpc, args)
        assert a == b, rpc
        assert port.decode(port.REQUEST_SCHEMAS[rpc], a) == ref.decode(
            ref.REQUEST_SCHEMAS[rpc], b)
        rpcs.add(rpc)
        if rpc in ref.VALUED_RPCS:
            for value in ({"type": 2, "bool_result": True}, {"type": 0},
                          {"type": 2, "message": ref.decode(
                              ref.REQUEST_SCHEMAS["OnMessagePublish"],
                              ref.build_request("OnMessagePublish", {
                                  "message": {"topic": "t", "payload": a[:9],
                                              "headers": {}}}))["message"]}):
                body = ref.encode(ref.VALUED_RESPONSE, value)
                assert port.encode(port.VALUED_RESPONSE, value) == body
                assert port.parse_response(rpc, body) == \
                    ref.parse_response(rpc, body)
    assert len(rpcs) == 13


# ---------------------------------------------------------------------------
# DB-backed authn and authz against the same mini servers
# ---------------------------------------------------------------------------

DB = ["redis", "mysql", "postgresql", "mongodb", "ldap"]
USERS = {"alice": ("pw-alice", False), "bob": ("pw-bob", True),
         "dave": ("", False)}
SALTED = {"name": "sha256", "salt_position": "prefix"}


def seeded_acl(seed: int) -> list:
    """(username, permission, action, topic) rows, first match wins."""
    rng = np.random.default_rng(seed)
    rows = [("alice", "allow", "publish", "up/${username}/#"),
            ("alice", "allow", "subscribe", "up/#")]
    for _ in range(6):
        who = str(rng.choice(list(USERS)))
        topic = "/".join(rng.choice(["up", "dn", "+", "a", "#"],
                                    int(rng.integers(1, 4))))
        if "#" in topic.split("/")[:-1]:
            topic = topic[:topic.index("#") + 1]
        rows.append((who, str(rng.choice(["allow", "deny"])),
                     str(rng.choice(["publish", "subscribe", "all"])),
                     topic))
    return rows + [("alice", "deny", "publish", "#")]


def start_db(pkg: str, backend: str, seed: int):
    """``pkg``'s mini server for ``backend``, holding ``USERS`` (salted
    sha256 where the backend hashes) and :func:`seeded_acl`."""
    hashing = mod(pkg, "access.hashing")
    spec = hashing.HashSpec(**SALTED)

    def stored(user, pw):
        salt = f"s-{user}".encode()
        return hashing.hash_password(spec, salt, pw.encode()).decode(), \
            salt.decode()

    acl = seeded_acl(seed)
    if backend == "ldap":
        srv = mod(pkg, "connector.ldap").MiniLDAP()
        srv.add("ou=mqtt,dc=emqx,dc=io", objectClass=["organizationalUnit"],
                ou="mqtt")
        for u, (pw, su) in USERS.items():
            attrs = {"mqttPublishTopic": [t for w, p, a, t in acl if w == u
                                          and p == "allow"
                                          and a == "publish"],
                     "mqttSubscriptionTopic": [
                         t for w, p, a, t in acl if w == u
                         and p == "allow" and a == "subscribe"],
                     "mqttPubSubTopic": [t for w, p, a, t in acl if w == u
                                         and p == "allow" and a == "all"]}
            srv.add(f"uid={u},ou=mqtt,dc=emqx,dc=io",
                    objectClass=["mqttUser"], uid=u, userPassword=pw,
                    isSuperuser=str(su).lower(),
                    **{k: v for k, v in attrs.items() if v})
        return srv.start()
    if backend == "redis":
        srv = mod(pkg, "connector.redis").MiniRedis().start()
        admin = mod(pkg, "connector.redis").RedisClient(port=srv.port)
        for u, (pw, su) in USERS.items():
            h, salt = stored(u, pw)
            admin.command(["HSET", f"mqtt_user:{u}", "password_hash", h,
                           "salt", salt, "is_superuser", str(su).lower()])
        for w, p, a, t in acl:
            if p == "allow":
                admin.command(["HSET", f"mqtt_acl:{w}", t, a])
        admin.close()
        return srv
    users = []
    for u, (pw, su) in USERS.items():
        h, salt = stored(u, pw)
        users.append({"username": u, "password_hash": h, "salt": salt,
                      "is_superuser": su if backend == "mongodb"
                      else str(int(su))})
    if backend == "mongodb":
        srv = mod(pkg, "connector.mongodb").MiniMongo()
        srv.collections["mqtt_user"] = users
        srv.collections["mqtt_acl"] = [
            {"username": w, "permission": p, "action": a, "topics": [t]}
            for w, p, a, t in acl]
        return srv.start()
    srv = (mod(pkg, "connector.mysql").MiniMySQL(user="root", password="")
           if backend == "mysql" else mod(pkg, "connector.pgsql").MiniPg())
    srv.tables["mqtt_user"] = users
    srv.tables["mqtt_acl"] = [
        {"username": w, "permission": p, "action": a, "topic": t}
        for w, p, a, t in acl]
    return srv.start()


def db_spec(backend: str, srv) -> dict:
    spec = {"mechanism": "password_based", "backend": backend,
            "server": f"127.0.0.1:{srv.port}",
            "password_hash_algorithm": dict(SALTED)}
    if backend == "mysql":
        spec.update(username="root", password="", database="mqtt")
    elif backend == "postgresql":
        spec.update(username="postgres", password="", database="mqtt")
    elif backend == "mongodb":
        spec.update(database="mqtt")
    elif backend == "ldap":
        spec.update(base_dn="dc=emqx,dc=io")
    return spec


def db_answers(pkg: str, backend: str, srv, seed: int) -> list:
    """``pkg``'s app booted from a config with authn and authz on
    ``backend`` (``srv``), asked seeded credentials and requests."""
    rng = np.random.default_rng(seed + 100)
    conf = mod(pkg, "config.config").Config()
    conf.init_load("authorization { no_match = deny, cache.enable = false }")
    spec = db_spec(backend, srv)
    conf.put("authentication", [spec], layer="local")
    conf.put("authorization.sources", [{**spec, "type": backend}],
             layer="local")
    app = mod(pkg, "app").BrokerApp.from_config(conf)
    out = []
    for _ in range(16):
        user = str(rng.choice([*USERS, "carol"]))
        pw = (USERS.get(user, ("x",))[0] if rng.random() < 0.6
              else "wrong")
        ret = app.access.authn.authenticate(
            {"clientid": f"c-{user}", "username": user, "password": pw})
        out.append(("authn", user, pw, ret))
        topic = "/".join(rng.choice(["up", "dn", user, "a"],
                                    int(rng.integers(1, 4))))
        action = str(rng.choice(["publish", "subscribe"]))
        out.append(("authz", user, action, topic, app.access.authz.authorize(
            {"clientid": f"c-{user}", "username": user}, action, topic)))
    return out


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("server_pkg", PKGS)
@pytest.mark.parametrize("backend", DB)
def test_db_backends_match_the_reference(backend, server_pkg, seed):
    """Against the same mini server (either package's), the port's authn
    and authz on each DB backend give the reference's answers: accepted,
    refused and unknown users, superusers, and allow / deny verdicts."""
    srv = start_db(server_pkg, backend, seed)
    try:
        ref = db_answers("ref", backend, srv, seed)
        port = db_answers("port", backend, srv, seed)
    finally:
        srv.stop()
    assert port == ref
    authn = [r[3][0] for r in ref if r[0] == "authn"]
    authz = [r[4] for r in ref if r[0] == "authz"]
    assert {"ok", "error"} <= set(authn)
    assert {"allow", "deny"} <= set(authz)


# ---------------------------------------------------------------------------
# Kafka record batches, snappy on and off
# ---------------------------------------------------------------------------

SNAPPY = ["native", "python"]


def python_snappy(monkeypatch, path: str = "python") -> None:
    """Both packages' snappy on one path: their native codecs (the same
    C++ source), or their Python paths (the native codec emits other,
    equally valid, bytes than the Python one)."""
    for pkg in PKGS:
        snappy = mod(pkg, "utils.snappy")
        if path == "python":
            monkeypatch.setattr(snappy, "_native", lambda: None)
        else:
            assert snappy._native() is not None, pkg


def seeded_records(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 40))):
        key = None if rng.random() < 0.3 else f"k{i % 4}".encode()
        value = (b"telemetry/" * int(rng.integers(0, 30))
                 + bytes(rng.integers(0, 256, int(rng.integers(0, 64)),
                                      dtype=np.uint8)))
        out.append((key, value))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("codec", ["none", "snappy"])
def test_kafka_record_batch_bytes_match_the_reference(codec, seed):
    ref, port = mod("ref", "connector.kafka"), mod("port", "connector.kafka")
    c = {"none": ref.CODEC_NONE, "snappy": ref.CODEC_SNAPPY}[codec]
    recs = seeded_records(seed)
    for path in SNAPPY:
        with pytest.MonkeyPatch.context() as monkeypatch:
            python_snappy(monkeypatch, path)
            a = ref.encode_record_batch(recs, base_ts=1_700_000_000_000,
                                        codec=c)
            b = port.encode_record_batch(recs, base_ts=1_700_000_000_000,
                                         codec=c)
            assert a == b, path
            assert port.decode_record_batch(a) == \
                ref.decode_record_batch(b) == recs


def bridge_batches(pkg: str, seed: int) -> tuple:
    with pytest.MonkeyPatch.context() as monkeypatch:
        return _bridge_batches(pkg, monkeypatch, seed)


def _bridge_batches(pkg: str, monkeypatch, seed: int) -> tuple:
    """The raw record batches ``pkg``'s Kafka bridge (snappy on) produces
    into the reference's ``MiniKafka`` for a rule's seeded messages, with
    the batches' timestamp pinned, and what the broker stored."""
    kafka = mod(pkg, "connector.kafka")
    encode = kafka.encode_record_batch
    monkeypatch.setattr(kafka, "encode_record_batch",
                        lambda recs, base_ts=None, codec=0: encode(
                            recs, base_ts=1_700_000_000_000, codec=codec))
    server_mod = mod("ref", "connector.kafka")
    seen = []
    decode = server_mod.decode_record_batch
    monkeypatch.setattr(server_mod, "decode_record_batch",
                        lambda data: seen.append(bytes(data)) or decode(data))
    srv = server_mod.MiniKafka(topics={"mqtt-up": 2}).start()
    try:
        app = mod(pkg, "app").BrokerApp()
        app.bridges.create(
            "kafka", "up", kafka.KafkaConnector(port=srv.port,
                                                compression="snappy"),
            {"kafka_topic": "mqtt-up", "key_template": "${clientid}",
             "value_template": '{"t":"${topic}","p":"${payload}"}'},
            batch_size=64, batch_time_s=60.0)
        app.rules.create_rule(
            "to-kafka", 'SELECT clientid, topic, payload FROM "k/#"',
            [{"function": "kafka:up", "args": {}}])
        Message = mod(pkg, "core.message").Message
        rng = np.random.default_rng(seed)
        for i in range(40):
            topic = str(rng.choice(["k/1", "k/2/x", "other"]))
            app.broker.publish(Message(
                topic=topic, payload=b"v%d" % i * int(rng.integers(1, 20)),
                from_=f"dev-{i % 3}"))
        app.bridges.get("kafka:up").worker.flush()
        return seen, dict(srv.records)
    finally:
        srv.stop()


@pytest.mark.parametrize("seed", range(2))
def test_kafka_bridge_batches_match_the_reference(seed, monkeypatch):
    """A rule's Kafka bridge with snappy on sends the same record batches,
    byte for byte, from both packages (both on their native codecs)."""
    python_snappy(monkeypatch, "native")
    ref, port = bridge_batches("ref", seed), bridge_batches("port", seed)
    assert port == ref
    assert ref[0] and sum(len(v) for v in ref[1].values()) > 0
