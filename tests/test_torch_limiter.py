"""The port's limiter (``emqx_tpu_torch/broker/limiter.py``) against the
reference's.

- the 7 host cases of ``tests/test_limiter.py`` over both packages, from the
  reference's own source (``pkg``);
- its live case, ``message_in`` backpressure over a real socket, on each
  package's ``BrokerServer`` over its ``Broker`` and ``CM`` (the reference
  case builds the reference's app, which the port does not have yet);
- a seeded op stream over a node → listener → client bucket tree, with the
  clock injected on both sides: every grant, retry delay and token count
  equal.
"""

from __future__ import annotations

import asyncio
import types

import numpy as np
import pytest

from test_torch_harness import PKGS, net, reference_case_names, \
    reference_tests

LIVE = "test_live_broker_message_in_backpressure"
HOST_CASES = [c for c in reference_case_names("test_limiter") if c != LIVE]


def test_reference_case_counts():
    assert len(HOST_CASES) == 7
    assert LIVE in reference_case_names("test_limiter")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", HOST_CASES)
def test_reference_limiter_case(case, pkg):
    getattr(reference_tests("test_limiter", pkg), case)()


@pytest.mark.parametrize("pkg", PKGS)
def test_live_broker_message_in_backpressure(pkg):
    """tests/test_limiter.py's live case over ``BrokerServer(broker=,
    cm=)``: 8 messages/s a client after a burst of 4, so 10 QoS 1
    publishes take more than 0.4 s and all get through."""
    n = net(pkg)
    L = n.limiter

    async def main():
        limiter = L.LimiterServer()
        limiter.add_listener(
            "tcp:default", L.LimiterConfig(),
            client_config=L.LimiterConfig(message_in=8.0,
                                          message_in_burst=4.0))
        srv = n.BrokerServer(port=0, broker=n.Broker(), cm=n.CM(),
                             limiter=limiter)
        await srv.start()
        try:
            c = n.MqttClient(port=srv.port, clientid="lim1")
            await c.connect()
            await c.subscribe("t/#", qos=0)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            for i in range(10):
                await c.publish("t/x", b"m%d" % i, qos=1)
            elapsed = loop.time() - t0
            assert elapsed > 0.4, f"no backpressure applied ({elapsed:.2f}s)"
            got = [await c.recv() for _ in range(10)]
            assert [m.payload for m in got] == [b"m%d" % i for i in range(10)]
            await c.disconnect()
            await c.close()
        finally:
            await srv.stop()

    asyncio.run(main())


class Clock:
    """The injected ``time`` of a limiter module: ``monotonic`` reads
    ``now``."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def _rate(rng) -> float | None:
    return None if rng.random() < 0.3 else float(rng.integers(1, 50))


def _config(L, rng):
    kw = {}
    for t in L.TYPES:
        kw[t] = _rate(rng)
        kw[f"{t}_burst"] = (None if rng.random() < 0.5
                            else float(rng.integers(1, 40)))
    return L.LimiterConfig(**kw)


def drive(pkg: str, seed: int, monkeypatch) -> list:
    """A node, three listeners and their clients' containers from one seed,
    then 600 ops — admissions, checks, direct consumes with and without an
    explicit ``now`` — while the injected clock moves forward by random
    steps (zero included)."""
    L = net(pkg).limiter
    clock = Clock()
    monkeypatch.setattr(L, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    rng = np.random.default_rng(seed)
    srv = L.LimiterServer(_config(L, rng))
    lids = [f"tcp:{i}" for i in range(3)]
    for lid in lids:
        srv.add_listener(lid, _config(L, rng), client_config=_config(L, rng))
    conts = [srv.make_container(lids[int(rng.integers(3))])
             for _ in range(6)] + [srv.make_container("unknown")]
    out = []
    for _ in range(600):
        clock.now += float(rng.choice([0.0, 0.01, 0.05, 0.25, 1.0]))
        op = int(rng.integers(4))
        if op == 0:
            r = srv.connect(lids[int(rng.integers(3))])
        elif op == 1:
            c = conts[int(rng.integers(len(conts)))]
            r = c.check(str(rng.choice(["bytes_in", "message_in",
                                        "message_routing", "connection"])),
                        float(rng.integers(1, 30)))
        else:
            c = conts[int(rng.integers(len(conts)))]
            if not c.buckets:
                continue
            b = c.buckets[sorted(c.buckets)[int(rng.integers(
                len(c.buckets)))]]
            n = float(rng.integers(1, 30))
            r = (b.try_consume(n, clock.now) if op == 2
                 else (b.retry_after(n), None))
        out.append((op, r))
        out.append(tuple(
            (t, b.tokens, b.burst, b.rate) for c in conts
            for t, b in sorted(c.buckets.items())))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_op_stream_equal(seed, monkeypatch):
    ref = drive("ref", seed, monkeypatch)
    port = drive("port", seed, monkeypatch)
    assert port == ref
    assert sum(1 for op, r in ref[::2] if r[0] is False) > 0   # refusals
