"""The port's app assembly (``emqx_tpu_torch/app.py``) and the layers below
it (the hook services, the overload protection, the observability
modules, listeners, bridges, resources, the gateway context) against the
reference's.

- Every module of the slice has the reference module's public names and
  signatures, and its subpackages export the reference's names.  The one
  deliberate difference: ``logfmt.setup_logging`` configures the
  ``emqx_tpu_torch`` logger tree by default, where the port's loggers live.
- The cases of ``tests/test_modules.py``, ``tests/test_observe2.py``,
  ``tests/test_session.py`` and ``tests/test_device_serving.py`` over both
  packages (``pkg``), from the reference's own source with the package name
  pointed at the port for ``port``, each over that package's own
  ``BrokerApp`` (the harness's ``app_class``): ``from_config`` with
  ``router.device`` enabled takes the port's ``RouterModel`` on the CPU
  through ``router_model=`` on both sides (the reference's model does not
  import here, ``ROADMAP.md`` R1; the port's needs a card).
- ``PluginManager.scan`` over the same install directory finds the same
  plugins in the same order, with the same enablement.
- The boot on the card: without one, ``from_config`` with
  ``router.device.enable`` raises (no CPU fallback); on the CPU path it
  builds the model of the config's shape.  D3: over a model on the card the
  config's adaptive knee (-1) resolves to 0, a knee >= 0 applies as
  written, and over a CPU model the knee is the reference's.  D1 under the
  app: a step that raises on the card reaches the caller.
- The branches whose modules came with the persistent-sessions,
  integrations and native-plane slices boot as the reference's do:
  ``durable.enable`` on ``NativeDurableStore`` where the native library
  builds and on a ``MemStore`` where it does not (D4), a ``native``
  listener on the port's ``NativeBrokerServer``.
- The port's loggers keep the records the config's log settings leave
  them, and a boot writes nothing outside ``node.data_dir``.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import json
import logging
import re

import pytest

import test_torch_broker as tb
from emqx_tpu_torch.core.message import Message
from test_torch_harness import PKGS, app_class, call_reference, \
    config_model, cpu_router_models, net, reference_calls, \
    reference_case_names, reference_tests
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

MODULES = [
    "config.hocon", "config.schema", "config.config", "access.banned",
    "access.flapping", "access.psk", "access.hashing", "access.authz",
    "access.authn", "access.control", "broker.olp", "services.slow_subs",
    "services.rewrite", "services.topic_metrics", "services.auto_subscribe",
    "services.telemetry", "services.plugins", "observe.sysmon",
    "observe.statsd", "observe.monitor", "observe.logfmt", "utils.replayq",
    "resource.resource", "resource.worker", "bridge.bridge", "gateway.ctx",
    "broker.listeners", "app"]
# (module, name) -> the port's shape, where it deliberately differs
DIFFERENT = {
    ("observe.logfmt", "setup_logging"): repr((
        "callable", "(level: 'str' = 'warning', formatter: 'str' = 'text', "
        "stream=None, to: 'str' = 'console', file_path: 'str' = "
        "'log/emqx.log', logger_name: 'str' = 'emqx_tpu_torch') -> "
        "'logging.Handler'")),
}


def _shape(obj) -> str:
    """``test_torch_broker``'s shape of a public name, as text less the
    addresses in the reprs of default values (a default encoder)."""
    return re.sub(r" at 0x[0-9a-f]+", "", repr(tb._shape(obj)))


@pytest.mark.parametrize("name", MODULES)
def test_public_names_and_signatures(name):
    ref = importlib.import_module(f"emqx_tpu.{name}")
    port = importlib.import_module(f"emqx_tpu_torch.{name}")
    r, p = tb._public(ref), tb._public(port)
    assert sorted(p) == sorted(r)
    for n in r:
        if getattr(r[n], "__module__", None) == "typing":
            continue
        want = DIFFERENT.get((name, n), _shape(r[n]))
        assert _shape(p[n]) == want, n


def test_subpackages_export_the_reference_names():
    for sub in ("config", "access", "resource", "bridge", "gateway",
                "services"):
        ref = importlib.import_module(f"emqx_tpu.{sub}")
        port = importlib.import_module(f"emqx_tpu_torch.{sub}")
        def names(pkg):
            return sorted(n for n, v in vars(pkg).items() if not (
                n.startswith("_") or inspect.ismodule(v)))

        assert names(port) == names(ref), sub
        for n in names(ref):
            assert getattr(port, n).__name__ == getattr(ref, n).__name__


# ---------------------------------------------------------------------------
# the reference's app-level test modules over both packages
# ---------------------------------------------------------------------------

REFERENCE = {"test_modules": 7, "test_observe2": 15, "test_session": 20,
             "test_device_serving": 11}
APP = [(name, case, i) for name in REFERENCE
       for case, i in reference_calls(name)]


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_case_names(name)) == n, name
    assert len(APP) == sum(REFERENCE.values())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,case,i", APP)
def test_reference_app_case(name, case, i, pkg, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)         # a default app's relative paths
    call_reference(name, pkg, case, i, tmp_path=tmp_path,
                   monkeypatch=monkeypatch)


def test_device_serving_runs_the_port_model_on_both_sides():
    """The device serving cases' apps: each package's own ``BrokerApp``
    over the port's ``RouterModel`` on the CPU, built from the config's
    ``router.device`` knobs and refreshed, with every batch on the step."""
    from emqx_tpu_torch.models.router_model import RouterModel
    for pkg in PKGS:
        app = reference_tests("test_device_serving", pkg).make_device_app()
        root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
        assert type(app).__mro__[1].__module__ == f"{root}.app"
        assert type(app.broker).__module__ == f"{root}.broker.broker"
        model = app.broker.model
        assert isinstance(model, RouterModel) and model.device.type == "cpu"
        assert (model.index.max_levels, model.n_sub_slots, model.K, model.M,
                model.ret_cap) == (8, 1024, 32, 128, 16)
        assert model.upload_count >= 1
        assert app.pipeline.min_device_batch == 0
        assert app.device_metrics is not None


def _plugin(d, name: str, vsn: str = "1.0.0") -> None:
    pdir = d / f"{name}-{vsn}"
    pdir.mkdir()
    (pdir / "release.json").write_text(json.dumps(
        {"name": name, "rel_vsn": vsn, "description": name}))


def test_plugin_scan_equals_the_reference(tmp_path):
    """``PluginManager.scan`` over one install directory (three plugins, a
    directory without ``release.json``, one with a broken one, and a
    persisted enablement order) finds the same plugins, in the same order,
    with the same enablement, in both packages."""
    for name in ("beta", "alpha", "gamma"):
        _plugin(tmp_path, name)
    (tmp_path / "no-release").mkdir()
    (tmp_path / "broken-1.0").mkdir()
    (tmp_path / "broken-1.0" / "release.json").write_text("{not json")
    (tmp_path / "plugins_state.json").write_text(json.dumps({"states": [
        {"name_vsn": "gamma-1.0.0", "enabled": True},
        {"name_vsn": "alpha-1.0.0", "enabled": False},
        {"name_vsn": "gone-1.0.0", "enabled": True}]}))
    seen = {}
    for pkg in PKGS:
        app = app_class(pkg)()
        mgr = app.plugins
        mgr.install_dir = str(tmp_path)
        found = mgr.scan()
        seen[pkg] = (found, list(mgr.order),
                     {k: (p.enabled, p.info) for k, p in mgr.plugins.items()})
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == ["alpha-1.0.0", "beta-1.0.0", "gamma-1.0.0"]
    assert seen["port"][1][0] == "gamma-1.0.0"


# ---------------------------------------------------------------------------
# the boot on the card: no fallback, D3, D1
# ---------------------------------------------------------------------------


def _device_conf(pkg: str = "port", **extra):
    conf = app_class(pkg).mods.config.Config()
    conf.put("router.device.enable", True)
    conf.put("router.device.max_levels", 8)
    conf.put("router.device.n_sub_slots", 64)
    for k, v in extra.items():
        conf.put(k, v)
    return conf


def test_from_config_without_a_card_raises(tmp_path):
    """``router.device.enable`` and no ``router_model=``: the port builds
    its model on the card, and with no card it raises (no CPU model in its
    place)."""
    import torch

    from emqx_tpu_torch.app import BrokerApp
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: from_config builds the model there")
    conf = _device_conf(**{"node.data_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BrokerApp.from_config(conf)


def test_from_config_builds_the_configured_model(monkeypatch, tmp_path):
    """The port's own model build: a ``RouterModel`` of the config's
    shape, refreshed at boot, in the broker, the pipeline and the fold."""
    cpu_router_models(monkeypatch)
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.models.router_model import RouterModel
    conf = _device_conf(**{"router.device.frontier_k": 8,
                           "router.device.match_cap": 16,
                           "router.device.return_cap": 4,
                           "router.device.batch_max": 64,
                           "router.device.pipeline_depth": 2,
                           "node.data_dir": str(tmp_path)})
    app = BrokerApp.from_config(conf)
    model = app.broker.model
    assert isinstance(model, RouterModel) and model.device.type == "cpu"
    assert (model.index.max_levels, model.n_sub_slots, model.K, model.M,
            model.ret_cap) == (8, 64, 8, 16, 4)
    assert model.upload_count == 1
    assert app.pipeline.broker is app.broker
    assert (app.pipeline.max_batch, app.pipeline.depth) == (64, 2)
    assert model.telemetry is app.device_metrics
    app.broker.subscribe("s", "a/+")
    assert [sorted(d) for d in app.broker.publish_batch(
        [Message(topic="a/b")])] == [["s"]]
    assert model.launch_count == 1 and model.host_match_count == 0


def _card_model():
    """A CPU model that reports the card as its device: the broker and the
    pipeline then take the card's policies (D1, D2, D3)."""
    import torch

    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex
    model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=64,
                        device="cpu")
    model.refresh()
    model.device = torch.device("cuda")
    return model


@pytest.mark.parametrize("knee", [None, -1, 0, 7])
def test_d3_the_configured_knee_over_the_card(knee, tmp_path):
    """D3: ``router.device.min_batch`` of -1 (the schema's default, the
    adaptive knee) resolves to 0 over a model on the card; a knee >= 0
    applies as written.  Over a CPU model the port's knee is the
    reference's for the same config."""
    from emqx_tpu_torch.app import BrokerApp
    extra = {"node.data_dir": str(tmp_path)}
    if knee is not None:
        extra["router.device.min_batch"] = knee
    app = BrokerApp.from_config(_device_conf(**extra),
                                router_model=_card_model())
    want = 0 if knee in (None, -1) else knee
    assert app.pipeline.min_device_batch == want
    assert app.pipeline.device_knee() == want
    if want == 0:
        assert app.pipeline.spill_deadline_ms() is None
    got = {}
    for pkg in PKGS:
        a = app_class(pkg).from_config(_device_conf(pkg, **extra))
        got[pkg] = (a.pipeline.min_device_batch, a.pipeline.device_knee(),
                    a.pipeline.spill_deadline_ms())
    assert got["port"] == got["ref"]
    assert got["port"][0] == (-1 if knee is None else knee)


@pytest.mark.parametrize("stage", ["submit", "collect"])
def test_d1_a_failing_step_under_the_app_reaches_the_caller(stage, tmp_path):
    """D1 under the app: a step that raises over a model on the card
    reaches ``publish_batch``'s caller, and nothing is served from the host
    oracle or counted as a failover; the app's pipeline too."""
    import torch

    from emqx_tpu_torch.app import BrokerApp
    app = BrokerApp.from_config(
        _device_conf(**{"node.data_dir": str(tmp_path)}),
        router_model=_card_model())
    model, broker = app.broker.model, app.broker
    broker.subscribe("s", "a/+")
    M = Message
    msgs = [M(topic="a/b", payload=b"x")]

    def broken(*_a, **_kw):
        raise RuntimeError("the kernel did not launch")

    token = None
    if stage == "collect":          # submitted as the card's step would be
        card, model.device = model.device, torch.device("cpu")
        token = broker.publish_batch_submit(msgs)
        model.device = card
    setattr(model, f"publish_batch_{stage}", broken)
    with pytest.raises(RuntimeError, match="did not launch"):
        broker.publish_batch_collect(
            token if token is not None else broker.publish_batch_submit(msgs))
    if stage == "submit":
        app.pipeline.submit(M(topic="a/b", payload=b"y"))
        with pytest.raises(RuntimeError, match="did not launch"):
            app.pipeline.flush()
        assert app.pipeline.host_batches == 0
    assert app.metrics.val("messages.device_failover") == 0
    assert app.ledger.totals().get("device_failover", 0) == 0
    assert model.host_match_count == 0


# ---------------------------------------------------------------------------
# the branches that waited for a later slice, and those that still wait
# ---------------------------------------------------------------------------

PERSISTENT = "persistent-sessions slice"
INTEGRATIONS = "integrations slice"
DB = ["redis", "mysql", "postgresql", "mongodb", "ldap"]


def _boot(pkg: str, conf_of, tmp_path):
    """``pkg``'s ``BrokerApp.from_config`` of the config ``conf_of`` fills
    (``Config`` of that package) with ``router.device`` on, over the
    port's model on the CPU, its data under ``tmp_path/pkg``."""
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    config = importlib.import_module(f"{root}.config.config")
    app_mod = importlib.import_module(f"{root}.app")
    conf = config.Config()
    conf.put("node.data_dir", str(tmp_path / pkg))
    conf.put("router.device.enable", True)
    conf_of(conf)
    app = app_mod.BrokerApp.from_config(conf, router_model=config_model(conf))
    assert app.broker.model.device.type == "cpu"
    return app


def test_persistent_store_waits_for_its_slice(tmp_path):
    """The persistent-sessions and native-plane slices came:
    ``persistent_store`` installs ``PersistentSessions`` on the store
    given; ``NativeDurableStore`` with no injected store opens the port's
    native store in its directory."""
    from emqx_tpu_torch import native
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.session.persistent import MemStore, \
        NativeDurableStore, PersistentSessions
    store = MemStore()
    app = BrokerApp(persistent_store=store)
    assert isinstance(app.persistent, PersistentSessions)
    assert app.persistent.store is store
    assert app.cm.persistence is app.persistent
    durable = NativeDurableStore(str(tmp_path / "ps"))
    try:
        assert isinstance(durable.native, native.NativeStore)
        assert (tmp_path / "ps" / "store").is_dir()
    finally:
        durable.close()


@pytest.mark.parametrize("key,value,slice_", [
    ("durable.enable", True, PERSISTENT),
    ("exhook.servers", [{"name": "e", "url": "grpc://127.0.0.1:1",
                         "auto_reconnect": False}], INTEGRATIONS),
])
def test_config_branch_waits_for_its_slice(key, value, slice_, tmp_path,
                                           monkeypatch):
    """The branch its slice brought boots as the reference's does:
    ``durable.enable``, with both packages' native libraries unavailable,
    on a ``MemStore`` with the reference's warning (D4), and an exhook
    server that does not answer stays registered, unloaded."""
    for root in ("emqx_tpu", "emqx_tpu_torch"):
        native = importlib.import_module(f"{root}.native")
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(native, "build_error", lambda: "unavailable")
    apps = {}
    for pkg in PKGS:
        # on the app's own logger: a boot's log settings may have turned
        # its tree's propagation off
        app_log = logging.getLogger(
            {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg] + ".app")
        tap = _Records()
        tap.setLevel(logging.WARNING)
        app_log.addHandler(tap)
        try:
            apps[pkg] = _boot(pkg, lambda c: c.put(key, value), tmp_path)
        finally:
            app_log.removeHandler(tap)
        warned = [r for r in tap.records if "durable.enable" in r]
        if slice_ == PERSISTENT:
            assert type(apps[pkg].persistent.store).__name__ == "MemStore"
            assert len(warned) == 1 and "MEMORY only" in warned[0]
            assert "(unavailable)" in warned[0]
        else:
            assert apps[pkg].persistent is None and not warned
            mgr = apps[pkg].exhook
            assert sorted(mgr.servers) == ["e"]
            assert not mgr.servers["e"].loaded
            assert mgr.servers["e"].transport == "grpc"
    assert not (tmp_path / "port" / "durable").exists()


@pytest.mark.parametrize("backend", DB)
@pytest.mark.parametrize("where", ["authentication", "authorization"])
def test_db_backend_waits_for_its_slice(where, backend, tmp_path):
    """The integrations slice came: authn and authz on each DB backend
    boot (the connector connects at the first query) with the reference's
    provider or source class."""
    def conf_of(conf):
        if where == "authentication":
            conf.put("authentication", [{"mechanism": "password_based",
                                         "backend": backend,
                                         "server": "127.0.0.1:1"}])
        else:
            conf.put("authorization.sources", [{"type": backend,
                                                "server": "127.0.0.1:1"}])

    def made(app):
        if where == "authentication":
            return [type(p) for p in app.access.authn.providers]
        return [type(s) for s in app.access.authz.sources]

    got = {pkg: made(_boot(pkg, conf_of, tmp_path)) for pkg in PKGS}
    assert [c.__name__ for c in got["port"]] == [
        c.__name__ for c in got["ref"]]
    assert got["port"][-1].__module__.startswith("emqx_tpu_torch.access.")


def test_durable_enable_boots_on_the_native_store(tmp_path):
    """With both packages' native libraries built, ``durable.enable``
    boots each on its own ``NativeDurableStore`` under
    ``node.data_dir/durable``, as the reference does."""
    for pkg in PKGS:
        app = _boot(pkg, lambda c: c.put("durable.enable", True), tmp_path)
        store = app.persistent.store
        try:
            assert type(store).__name__ == "NativeDurableStore"
            assert type(store).__module__.startswith(
                {"ref": "emqx_tpu.", "port": "emqx_tpu_torch."}[pkg])
            assert (tmp_path / pkg / "durable" / "store").is_dir()
        finally:
            store.close()


def test_native_listener_waits_for_its_slice():
    """The native plane came: a ``native`` listener boots the port's
    ``NativeBrokerServer`` beside a tcp one, an MQTT client publishes
    through it, and both stop."""
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.broker.native_server import NativeBrokerServer
    from emqx_tpu_torch.mqtt.client import MqttClient

    async def main():
        app = BrokerApp()
        ok = {"type": "tcp", "bind": "127.0.0.1:0"}
        native = {"type": "native", "bind": "127.0.0.1:0"}
        started = await app.listeners.start_all({"a": ok, "n": native})
        try:
            assert sorted(started) == ["native:n", "tcp:a"]
            lst = app.listeners.servers["native:n"]
            assert isinstance(lst._srv, NativeBrokerServer)
            sub = MqttClient(port=lst.port, clientid="s")
            pub = MqttClient(port=lst.port, clientid="p")
            await sub.connect()
            await pub.connect()
            await sub.subscribe("n/+", qos=0)
            await pub.publish("n/x", b"hi", qos=0)
            msg = await sub.recv(timeout=5)
            assert (msg.topic, msg.payload) == ("n/x", b"hi")
            await sub.disconnect()
            await pub.disconnect()
        finally:
            await app.listeners.stop_all()
        assert app.listeners.info() == []
    asyncio.run(main())


# ---------------------------------------------------------------------------
# logging and the boot's files
# ---------------------------------------------------------------------------


class _Records(logging.Handler):
    def __init__(self) -> None:
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record) -> None:
        self.records.append(record.getMessage())


def test_log_config_reaches_the_port_loggers(tmp_path):
    """``log.level`` configures the ``emqx_tpu_torch`` tree (the reference
    configures ``emqx_tpu``): below it, a handler on the pipeline's logger
    still gets its ERROR records, and a WARNING under ``log.level = error``
    goes nowhere."""
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.config.config import Config
    root = logging.getLogger("emqx_tpu_torch")
    saved = (root.level, list(root.handlers), root.propagate)
    conf = Config()
    conf.init_load(f'node.data_dir = "{tmp_path}"\nlog.level = error\n')
    try:
        BrokerApp.from_config(conf)
        assert root.level == logging.ERROR and root.propagate is False
        console = [h for h in root.handlers
                   if getattr(h, "_emqx_console", False)]
        assert len(console) == 1
        pipe_log = logging.getLogger("emqx_tpu_torch.pipeline")
        tap = _Records()
        pipe_log.addHandler(tap)
        try:
            pipe_log.warning("a warning")
            pipe_log.error("an error")
        finally:
            pipe_log.removeHandler(tap)
        assert tap.records == ["an error"]
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        root.level, root.propagate = saved[0], saved[2]
        for h in saved[1]:
            root.addHandler(h)


def test_boot_writes_nothing_outside_the_data_dir(tmp_path, monkeypatch):
    """A config boot with listeners, authn, authz, rewrite and
    auto-subscribe, run from an empty working directory, leaves it empty;
    the plugins are looked for under ``node.data_dir``."""
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.config.config import Config
    cwd, data = tmp_path / "cwd", tmp_path / "data"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    conf = Config()
    conf.init_load(f'''
    node.data_dir = "{data}"
    listeners.t {{ type = tcp, bind = "127.0.0.1:0" }}
    authentication = [{{ mechanism = password_based,
      backend = built_in_database, user_id_type = clientid,
      bootstrap_users = [{{ user_id = "c1", password = "pw" }}] }}]
    authorization {{ no_match = deny, sources = [{{ type = file,
      rules = "allow all all #" }}] }}
    rewrite = [{{ action = all, source_topic = "a/#", re = "^a/(.+)$",
      dest_topic = "b/$1" }}]
    auto_subscribe.topics = [{{ topic = "auto/${{clientid}}" }}]
    ''')
    app = BrokerApp.from_config(conf)

    async def main():
        await app.listeners.start_all(conf.get("listeners"))
        await app.listeners.stop_all()
    asyncio.run(main())
    app.tick()
    assert app.plugins.install_dir == str(data / "plugins")
    assert list(cwd.iterdir()) == []


def test_default_app_servers_serve_its_broker():
    """``BrokerServer()`` with no app serves the port's default app: a
    client's publish reaches a subscriber through it."""
    n = net("port")

    async def main():
        server = n.BrokerServer(port=0)
        await server.start()
        try:
            sub = n.MqttClient(port=server.port, clientid="s")
            pub = n.MqttClient(port=server.port, clientid="p")
            for c in (sub, pub):
                await c.connect()
            await sub.subscribe("x/+", qos=1)
            await pub.publish("x/y", b"v", qos=1)
            got = await sub.recv(timeout=5)
            assert (got.topic, got.payload) == ("x/y", b"v")
            assert server.app.metrics.val("messages.delivered") >= 1
            for c in (sub, pub):
                await c.disconnect()
        finally:
            await server.stop()
    asyncio.run(main())
