"""The port's native plane itself: its C++ sources, its build, its public
surface, and D5.

- ``emqx_tpu_torch/native/src`` holds the same fifteen files as the
  reference's ``emqx_tpu/native/src``, byte for byte: the reference's own
  tests and the sanitizer and ``nativecheck`` runs over the port hold the
  C++ through this copy.
- The port builds its library from that copy into
  ``emqx_tpu_torch/_build/native/`` and loads it from there: never next to
  its sources, never the reference's ``emqx_tpu/native/*.so``.
- ``native`` and ``broker/native_server.py`` have the reference's public
  names, signatures and constants.
- D5 (``ROADMAP.md`` §3): over a model on the card, a lane submit or
  collect that raises, or the pump's answer after a collect that
  succeeded, stops the pump, keeps the exception and answers the
  held frames with no audience: nothing is punted to the host path, and
  ``NativeBrokerServer.stop()`` (and ``NativeListener.stop`` through it)
  re-raises it.  Over a CPU model the batch punts to the Python path, as
  in the reference.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from test_torch_harness import REPO, config_model

PORT_SRC = REPO / "emqx_tpu_torch" / "native" / "src"
REF_SRC = REPO / "emqx_tpu" / "native" / "src"


def test_sources_equal_the_reference_byte_for_byte():
    ref = sorted(p.name for p in REF_SRC.iterdir())
    assert sorted(p.name for p in PORT_SRC.iterdir()) == ref
    assert len(ref) == 15
    for name in ref:
        assert (PORT_SRC / name).read_bytes() == \
            (REF_SRC / name).read_bytes(), name


def test_library_builds_and_loads_from_the_port_build_dir():
    """In a fresh process: the port's library loads from
    ``emqx_tpu_torch/_build/native/`` and no library of the reference's
    directory is mapped."""
    from emqx_tpu_torch import native
    build = REPO / "emqx_tpu_torch" / "_build" / "native"
    assert Path(native._BUILD_DIR) == build
    assert Path(native._LIB_PATH).parent == build
    assert native.available(), native.build_error()
    code = (
        "from emqx_tpu_torch import native\n"
        "assert native.available(), native.build_error()\n"
        "print(native._lib._name)\n"
        "print(open('/proc/self/maps').read())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    name, maps = proc.stdout.split("\n", 1)
    assert Path(name) == build / "libemqx_native.so"
    assert str(build / "libemqx_native.so") in maps
    assert str(REPO / "emqx_tpu" / "native") not in maps


@pytest.mark.parametrize("env,lib", [
    ({}, "libemqx_native.so"),
    ({"EMQX_NATIVE_NOFAULT": "1"}, "libemqx_native.nofault.so"),
    ({"EMQX_NATIVE_SANITIZE": "address"}, "libemqx_native.address.so"),
])
def test_build_writes_only_the_port_build_dir(env, lib, monkeypatch,
                                              tmp_path):
    """The build command of each variant compiles the port's copy of the
    sources and writes its output under ``_build/native`` (through a
    private name renamed into place); ``_needs_build`` reads that
    output's age against the port's sources."""
    monkeypatch.delenv("EMQX_NATIVE_NOFAULT", raising=False)
    monkeypatch.delenv("EMQX_NATIVE_SANITIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "_native_copy", REPO / "emqx_tpu_torch" / "native" / "__init__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "build"
    monkeypatch.setattr(mod, "_BUILD_DIR", str(out))
    monkeypatch.setattr(mod, "_LIB_PATH", str(out / lib))
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
    monkeypatch.setattr(mod.subprocess, "run", fake_run)
    assert mod._needs_build()
    mod._build()
    assert not mod._needs_build()
    mod._build()                          # fresh: no second compile
    (cmd,) = runs
    srcs = [a for a in cmd if a.endswith(".cc")]
    assert [Path(a).name for a in srcs] == [
        "host.cc", "snappy.cc", "loadgen.cc", "bcrypt.cc"]
    assert all(Path(a).parent == PORT_SRC for a in srcs)
    assert Path(cmd[cmd.index("-o") + 1]).parent == out
    assert sorted(p.name for p in out.iterdir()) == [lib, lib + ".lock"]
    if "EMQX_NATIVE_NOFAULT" in env:
        assert "-DEMQX_NO_FAULTLINE" in cmd
    if "EMQX_NATIVE_SANITIZE" in env:
        assert "-fsanitize=address" in cmd


@pytest.mark.parametrize("name", ["native", "broker.native_server"])
def test_public_names_and_signatures(name):
    import test_torch_broker as tb
    r = tb._public(importlib.import_module(f"emqx_tpu.{name}"))
    p = tb._public(importlib.import_module(f"emqx_tpu_torch.{name}"))
    assert sorted(p) == sorted(r)
    for n in r:
        if getattr(r[n], "__module__", None) == "typing":
            continue
        assert tb._shape(p[n]) == tb._shape(r[n]), n


# ---------------------------------------------------------------------------
# D5: the device lane over a step that raises
# ---------------------------------------------------------------------------


class FailingStep:
    """A CPU ``RouterModel`` behind a stand-in that reports ``device`` (a
    model on the card for ``"cuda"``) and whose step raises at ``stage``
    (``"submit"`` or ``"collect"``) once ``armed``."""

    def __init__(self, model, device: str, stage: str) -> None:
        import torch
        self.__dict__.update(_m=model, device=torch.device(device),
                             stage=stage, armed=False, raised=0, submits=0)

    def __getattr__(self, name):
        return getattr(self._m, name)

    def __setattr__(self, name, value):
        if name in self.__dict__:
            self.__dict__[name] = value
        else:
            setattr(self._m, name, value)

    def _fail(self, stage: str) -> None:
        if self.armed and self.stage == stage:
            self.__dict__["raised"] += 1
            raise RuntimeError(f"the step failed at {stage}")

    def publish_batch_submit(self, *a, **kw):
        self.__dict__["submits"] += self.armed
        self._fail("submit")
        return self._m.publish_batch_submit(*a, **kw)

    def publish_batch_collect(self, *a, **kw):
        self._fail("collect")
        return self._m.publish_batch_collect(*a, **kw)


def lane_app(device: str, stage: str):
    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.config.config import Config
    conf = Config()
    conf.put("router.device.enable", True)
    conf.put("router.device.min_batch", 0)
    model = FailingStep(config_model(conf), device, stage)
    return BrokerApp.from_config(conf, router_model=model), model


async def lane_traffic(port: int, model, n: int) -> list:
    """A subscriber and a publisher on ``port``: a warm publish earns the
    permit on the Python path, then the step is armed and ``n`` QoS 0
    publishes ride the lane.  Returns the payloads the subscriber got
    within 3 s."""
    from emqx_tpu_torch.mqtt.client import MqttClient
    sub = MqttClient(port=port, clientid="d5s")
    await sub.connect()
    await sub.subscribe("d5/+", qos=0)
    pub = MqttClient(port=port, clientid="d5p")
    await pub.connect()
    await pub.publish("d5/t", b"warm", qos=0)
    assert (await sub.recv(timeout=20)).payload == b"warm"
    await asyncio.sleep(0.6)                 # the permit's grant
    model.armed = True
    for i in range(n):
        await pub.publish("d5/t", str(i).encode(), qos=0)
    got = []
    try:
        while True:
            got.append((await sub.recv(timeout=3)).payload)
    except asyncio.TimeoutError:
        pass
    await sub.close()
    await pub.close()
    return got


def fail_respond(server, model) -> None:
    """The pump's answer after a collect that succeeded raises once the
    step is armed (an error in the pump outside submit and collect)."""
    respond = server._lane_respond

    def failing(seqs, matched, fallback):
        if model.armed and not model.raised:
            model.__dict__["raised"] += 1
            raise RuntimeError("the step failed at respond")
        return respond(seqs, matched, fallback)
    server._lane_respond = failing


@pytest.mark.parametrize("stage", ["submit", "collect", "respond"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_d5_lane_step_failure(device, stage):
    from emqx_tpu_torch.broker.native_server import NativeBrokerServer
    app, model = lane_app(device, stage)
    server = NativeBrokerServer(port=0, app=app, device_lane="on")
    if stage == "respond":
        fail_respond(server, model)
    server.start()
    try:
        got = asyncio.run(lane_traffic(server.port, model, 16))
        st = server.fast_stats()
    except BaseException:
        server.lane_error = None
        server.stop()
        raise
    assert model.raised >= 1 and st["lane_in"] >= 1, st
    if device == "cuda":
        # D5: the pump ran no step after the error (at most the batches
        # in flight when it raised); no frame was punted to the host
        # path and none stale-tripped: every laned message answered no
        # one; stop() re-raises the step's error
        assert isinstance(server.lane_error, RuntimeError)
        assert model.submits <= (1 if stage == "submit" else 2), \
            model.submits
        assert st["lane_punts"] == st["lane_stale"] == 0, st
        assert st["lane_out"] == st["lane_in"], st
        assert got == [], got
        with pytest.raises(RuntimeError, match=f"failed at {stage}"):
            server.stop()
    else:
        # the reference's behaviour over a CPU model: the failed batches
        # punt to the Python path, which delivers every message (a punted
        # batch may land after a later batch's lane answer)
        assert server.lane_error is None
        assert st["lane_punts"] >= 1, st
        assert sorted(got, key=int) == [str(i).encode() for i in range(16)]
        server.stop()


def test_d5_native_listener_stop_reraises():
    """Through the app's listeners: a ``native`` listener with the lane
    on over a failing step on the card; ``stop_all`` raises the step's
    error."""
    app, model = lane_app("cuda", "submit")

    async def main():
        await app.listeners.start_all({"n": {
            "type": "native", "bind": "127.0.0.1:0", "device_lane": "on"}})
        lst = app.listeners.servers["native:n"]
        await lane_traffic(lst.port, model, 4)
        t0 = time.monotonic()
        while lst._srv.lane_error is None and time.monotonic() - t0 < 5:
            await asyncio.sleep(0.05)
        with pytest.raises(RuntimeError, match="failed at submit"):
            await app.listeners.stop_all()
    asyncio.run(main())


def test_smoke_native_path_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s native path at a small size over a CPU model:
    the serving app booted from the smoke's config, its ``native``
    listener with the device lane on, the wire legs in the smoke's child
    process and the load generator, with every check of the path.  The
    card runs it at 1M subscriptions; the launch counts are the card's
    alone."""
    import gc

    import chip_smoke
    import emqx_tpu_torch.broker.pipeline as pipeline
    monkeypatch.setattr(chip_smoke, "path_counts", lambda name: {})
    monkeypatch.setattr(pipeline, "_on_card", lambda model: True)
    sv = None
    try:
        sv = chip_smoke.serving_load(4000, 42, "cpu", None, sessions=512,
                                     recorded=64)
        chip_smoke.serve_overlay(sv)
        out = chip_smoke.native_phase(sv, 42, "cpu", subs=8, pubs=3,
                                      topics=16, qos0=48, qos1=8,
                                      loadgen=100)
    finally:
        gc.unfreeze()               # the load froze its heap
        if sv is not None:
            import shutil
            shutil.rmtree(sv["data_dir"], ignore_errors=True)
    warm, qos0, qos1 = out["legs"]
    assert warm["lane"]["lane_in"] == 0
    for leg in (qos0, qos1):
        assert leg["lane"]["lane_in"] > 0 and leg["lane"]["punts"] > 0
        assert leg["lane"]["lane_stale"] == leg["lane"]["lane_punts"] == 0
        assert leg["deliveries"] > 0
    assert qos1["qos1_deliveries"] > 0
    lg = out["loadgen"]
    assert lg["received"] == lg["sent"] == 8 * 100
    assert lg["lane_batches"] > 0 and out["patches"] > 0
    assert out["overlay_lifted"] == 24 * 96
