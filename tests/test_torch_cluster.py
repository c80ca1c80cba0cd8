"""The port's cluster plane (``emqx_tpu_torch/cluster/``: the transports,
the versioned BPAPI, the replicated config, ``ClusterNode``, the harness and
the peer process) against the reference's.

- The cases of ``tests/test_cluster.py``, ``test_cluster_conf.py`` and
  ``test_cluster_procs.py`` over both packages (``pkg``), from the
  reference's own source with the package name pointed at the port for
  ``port``: the port's copy of ``test_cluster_procs.py`` spawns the port's
  peer (``python -m emqx_tpu_torch.cluster.peer``).
- Every module of the slice has the reference's public names, signatures
  and constants.
- The cluster as a whole: one seeded scenario on a two-node ``LocalBus``
  cluster, each node's ``BrokerApp`` over a CPU ``RouterModel``, batches
  published on n1 forwarded to n2, gives exactly the same deliveries,
  delivery maps and route tables in both packages.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from test_torch_harness import PKGS, app_class, call_reference, \
    reference_calls, reference_case_names, waiting
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

REFERENCE = {"test_cluster": 20, "test_cluster_conf": 15,
             "test_cluster_procs": 6}
CASES = [(name, case, i) for name in REFERENCE
         for case, i in reference_calls(name, waiting(name))]


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_case_names(name)) == n, name
        assert not waiting(name), name
    assert len(CASES) == sum(REFERENCE.values())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,case,i", CASES)
def test_reference_cluster_case(name, case, i, pkg, tmp_path, monkeypatch,
                                capsys):
    monkeypatch.chdir(tmp_path)
    call_reference(name, pkg, case, i, tmp_path=tmp_path,
                   monkeypatch=monkeypatch, capsys=capsys)


def mod(pkg: str, name: str):
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    return importlib.import_module(f"{root}.{name}")


MODULES = ["cluster.transport", "cluster.bpapi", "cluster.conf",
           "cluster.node", "cluster.harness", "cluster.peer"]


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


# ---------------------------------------------------------------------------
# a two-node cluster over CPU RouterModels
# ---------------------------------------------------------------------------

WORDS = ["a", "b", "c", "dd"]


def cluster_plan(seed: int) -> dict:
    """Sessions of n1 (subscribed before n2 joins: n2 bootstraps their
    routes) and of n2 (after: their deltas reach n1 by ``flush``), each on
    2 filters of a small tree; batches published on n1 and on n2, and
    topics for n1's pipeline."""
    rng = np.random.default_rng(seed)

    def filt():
        ws = [str(w) for w in rng.choice(WORDS + ["+"],
                                         int(rng.integers(1, 4)))]
        return "/".join(ws + ["#"] if rng.random() < 0.25 else ws)

    def topics(n):
        return ["/".join(str(w) for w in rng.choice(
            WORDS, int(rng.integers(1, 5)))) for _ in range(n)]

    return {"n1": {f"s1-{i}": [filt(), filt()] for i in range(6)},
            "n2": {f"s2-{i}": [filt(), filt()] for i in range(6)},
            "on_n1": [topics(int(rng.integers(8, 24))) for _ in range(3)],
            "on_n2": [topics(int(rng.integers(8, 24))) for _ in range(2)],
            "pipe": topics(24)}


def cpu_model():
    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex
    return RouterModel(TrieIndex(max_levels=8), n_sub_slots=64, K=16, M=32,
                       ret_cap=8, device="cpu")


def cluster_run(pkg: str, seed: int) -> dict:
    """``pkg``'s two-node ``LocalBus`` cluster, each node's ``BrokerApp``
    over its own CPU ``RouterModel`` (its pipeline's knee 0), driven by
    :func:`cluster_plan`: each session a recording channel in its node's
    CM; batches through ``Broker.publish_batch`` on n1 and n2 (each
    delivery map dispatched by the CM, remote routes forwarded), then n1's
    pipeline.  Returns the delivery maps, what every channel got, both
    nodes' route tables, the members and the steps each model ran."""
    from test_torch_harness import RecordingChannel, delivery_map
    transport = mod(pkg, "cluster.transport")
    harness = mod(pkg, "cluster.harness")
    ClusterNode = mod(pkg, "cluster.node").ClusterNode
    M = mod(pkg, "core.message")
    plan = cluster_plan(seed)
    fabric = transport.LocalBus.Fabric()
    nodes, channels = {}, {}
    for name in ("n1", "n2"):
        app = app_class(pkg)(node=name, router_model=cpu_model())
        app.pipeline.min_device_batch = 0
        nodes[name] = ClusterNode(name, transport.LocalBus(name, fabric),
                                  app=app)

    def subscribe(name):
        app = nodes[name].app
        for sid, filters in plan[name].items():
            channels[sid] = RecordingChannel()
            app.cm.register_channel(sid, channels[sid])
            for f in filters:
                app.broker.subscribe(sid, f, M.SubOpts(qos=0))

    try:
        subscribe("n1")
        nodes["n2"].join(["n1"])
        harness.sync(list(nodes.values()))
        subscribe("n2")
        harness.sync(list(nodes.values()))
        steps = {n: nd.app.broker.model.launch_count
                 for n, nd in nodes.items()}
        maps = []
        for name, key in (("n1", "on_n1"), ("n2", "on_n2")):
            app = nodes[name].app
            for b, topics in enumerate(plan[key]):
                msgs = [M.Message(topic=t, payload=b"%s-%d-%d" % (
                    name.encode(), b, k), from_=f"pub-{name}")
                        for k, t in enumerate(topics)]
                for d in app.broker.publish_batch(msgs):
                    maps.append((name, delivery_map(d)))
                    app.cm.dispatch(d)
        pipe = nodes["n1"].app.pipeline
        for k, t in enumerate(plan["pipe"]):
            pipe.submit(M.Message(topic=t, payload=b"p-%d" % k))
        pipe.flush()
        return dict(
            maps=maps, got={sid: ch.got for sid, ch in channels.items()},
            routes={n: sorted(nd.app.broker.router.dump(), key=repr)
                    for n, nd in nodes.items()},
            members={n: sorted(nd.alive_peers())
                     for n, nd in nodes.items()},
            steps={n: nd.app.broker.model.launch_count - steps[n]
                   for n, nd in nodes.items()},
            host_batches=pipe.host_batches,
            forwards={n: nd.app.metrics.val("messages.forward")
                      for n, nd in nodes.items()})
    finally:
        harness.stop(list(nodes.values()))


@pytest.mark.parametrize("seed", range(2))
def test_cluster_over_the_step_matches_the_reference(seed):
    """One seeded scenario on a two-node cluster over CPU models: n2
    bootstraps n1's routes and replicates its own, batches published on
    each node run its step and forward to the other; both packages give
    the same delivery maps, deliveries, route tables and members."""
    ref, port = cluster_run("ref", seed), cluster_run("port", seed)
    assert port == ref
    plan = cluster_plan(seed)
    assert ref["steps"] == {"n1": len(plan["on_n1"]) + 1,
                            "n2": len(plan["on_n2"])}
    assert ref["host_batches"] == 0
    assert ref["members"] == {"n1": ["n2"], "n2": ["n1"]}
    dests = {n: {d for _t, d in r} for n, r in ref["routes"].items()}
    assert dests["n1"] == dests["n2"] == {"n1", "n2"}
    assert ref["forwards"]["n1"] > 0 and ref["forwards"]["n2"] > 0
    assert any(ref["got"][s] for s in plan["n2"]) and any(
        ref["got"][s] for s in plan["n1"])
