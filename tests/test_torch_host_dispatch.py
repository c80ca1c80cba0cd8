"""The port's host-matcher dispatch, against the JAX reference's.

``EMQX_TPU_CPU_KERNEL`` decides where ``RouterModel.publish_batch`` is
served: ``host`` from the host matcher (keyed by fid: the C++
``NativeSubTable`` where the port's native library builds, as the
reference picks it, else the host oracle ``Trie``), ``xla`` from the step (what ``tests/conftest.py`` pins for
the suite, so the CPU tests run the kernels' plain versions), and auto
from the host matcher iff the model runs on the CPU.  The first tests
mirror ``tests/test_host_dispatch.py`` on ``RouterModel(device="cpu")``;
then the port's host path and the reference's (in the harness's child
process) run one seeded op stream and must answer alike, batch for batch,
with the same ``host_match_count``.  The test marked ``cuda`` checks that
auto picks the kernels on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu_torch import RouterModel
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import drive_model, gen_filters, gen_topics, \
    run_reference

FILTERS = [
    ("a/b", 1), ("a/+", 2), ("c/#", 3), ("+/b", 4),
    ("deep/x/y/z/w", 5), ("deep/x/+/z/#", 6), ("$SYS/#", 7), ("#", 8),
]
TOPICS = ["a/b", "c/d/e", "deep/x/y/z/w", "$SYS/broker/uptime",
          "no/match/here", "a"]


def _mk(monkeypatch, mode, index=None, device="cpu"):
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", mode)
    model = RouterModel(index or TrieIndex(max_levels=8), n_sub_slots=256,
                        device=device)
    for f, s in FILTERS:
        model.subscribe(f, s)
    model.aux_register("a/#")
    return model


def test_mode_gates(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "host")
    assert RouterModel(TrieIndex(), device="cpu")._host_matcher is not None
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "xla")
    assert RouterModel(TrieIndex(), device="cpu")._host_matcher is None
    # auto: a model on the CPU serves from the host matcher
    monkeypatch.delenv("EMQX_TPU_CPU_KERNEL")
    model = RouterModel(TrieIndex(), device="cpu")
    assert model._host_matcher is not None
    # the reference's choice: the C++ table where the native library builds
    from emqx_tpu_torch import native
    assert native.available(), native.build_error()
    assert model._host_matcher.backend == "native"
    monkeypatch.setattr(native, "available", lambda: False)
    model = RouterModel(TrieIndex(), device="cpu")
    assert model._host_matcher.backend == "oracle"
    monkeypatch.undo()
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "AUTO")
    assert RouterModel(TrieIndex(), device="cpu")._host_matcher is not None
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "Host")
    assert RouterModel(TrieIndex(), device="cpu")._host_matcher is not None


@pytest.mark.parametrize("index_kind", ["flat", "sharded"])
def test_host_dispatch_parity_with_xla(monkeypatch, index_kind):
    def mk_index():
        return (ShardedTrieIndex(4, max_levels=8)
                if index_kind == "sharded" else TrieIndex(max_levels=8))

    host = _mk(monkeypatch, "host", mk_index())
    xla = _mk(monkeypatch, "xla", mk_index())
    rh = host.publish_batch(TOPICS)
    rx = xla.publish_batch(TOPICS)
    assert [sorted(x) for x in rh[0]] == [sorted(x) for x in rx[0]]
    assert [sorted(x) for x in rh[1]] == [sorted(x) for x in rx[1]]
    assert rh[2] == rx[2]
    assert rh[3] == rx[3] == []
    assert host.launch_count == 0 and host.host_match_count == 1
    assert xla.launch_count == 1 and xla.host_match_count == 0


def test_host_dispatch_tracks_unsubscribe_and_aux(monkeypatch):
    model = _mk(monkeypatch, "host")
    assert sorted(model.publish_batch(["a/b"])[0][0]) == \
        ["#", "+/b", "a/+", "a/b"]
    model.unsubscribe("a/+", 2)
    model.unsubscribe("#", 8)
    assert sorted(model.publish_batch(["a/b"])[0][0]) == ["+/b", "a/b"]
    assert model.publish_batch(["a/b"])[1][0] == ["a/#"]
    model.aux_release("a/#")
    assert model.publish_batch(["a/b"])[1][0] == []


def test_host_dispatch_rides_submit_collect(monkeypatch):
    """The pipeline calls submit/collect, not publish_batch: the host path
    flows through the same two stages, and the pending handle is exactly
    ``("host", result)``, the shape the broker recognizes."""
    model = _mk(monkeypatch, "host")
    pending = model.publish_batch_submit(["a/b"])
    assert isinstance(pending, tuple) and len(pending) == 2 \
        and pending[0] == "host"
    matched, aux, slots, fallback = model.publish_batch_collect(pending)
    assert "a/b" in matched[0] and slots[0] and fallback == []
    assert (matched, aux, slots, fallback) == pending[1]


def test_host_dispatch_sys_topics(monkeypatch):
    """MQTT-3.7.2-1: root-level wildcards must not match $-topics on the
    host path either."""
    model = _mk(monkeypatch, "host")
    r = model.publish_batch(["$SYS/broker/uptime"])
    assert r[0][0] == ["$SYS/#"]


def test_host_dispatch_telemetry_and_no_refresh(monkeypatch):
    """Each host batch calls ``telemetry.on_host_batch(n)`` and nothing
    else of the hook; no step runs, so no table is uploaded."""
    model = _mk(monkeypatch, "host")

    class Hook:
        def __init__(self):
            self.host, self.device = [], 0

        def on_host_batch(self, n):
            self.host.append(n)

        def on_batch(self, *_a, **_kw):
            self.device += 1

    model.telemetry = hook = Hook()
    model.publish_batch(TOPICS)
    model.publish_batch_collect(model.publish_batch_submit(TOPICS[:2]))
    assert hook.host == [len(TOPICS), 2] and hook.device == 0
    assert model.host_match_count == 2 and model.launch_count == 0
    assert model.upload_count == 0 and model._trie_dev is None


# ---------------------------------------------------------------------------
# the port's host path against the reference's, in the harness's child
# ---------------------------------------------------------------------------

LEVELS = 6


def _ops(seed: int) -> list:
    """A seeded op stream: subscribes (random filters, slots, a '#' and a
    '$SYS/#'), aux filters, publishes with '$' topics and topics deeper
    than the index's levels (the host path has no fallback), unsubscribes
    and aux releases between them."""
    rng = np.random.default_rng(seed)
    filters = gen_filters(rng, 120, max_words=LEVELS) + ["#", "$SYS/#",
                                                         "+/a"]
    subs = [(f, int(rng.integers(0, 64))) for f in filters]
    ops = [("sub", f, s) for f, s in subs]
    aux = filters[:6] + ["a/#", "zz/+"]
    ops += [("aux", f) for f in aux]

    def pub():
        topics = gen_topics(rng, 40, max_words=LEVELS + 3) + [
            "$SYS/x", "$SYS", "a/b/c/dd/a/b/c/dd/a", "a"]
        return ("pub", topics)

    ops += [pub(), ("host_counts",)]
    for f, s in subs[::3]:
        ops.append(("unsub", f, s))
    ops += [("aux_release", f) for f in aux[::2]]
    ops += [pub(), ("sub", "a/#", 5), ("sub", "zz/+", 9), pub(),
            ("host_counts",)]
    return ops


HOST_CASES = [dict(max_levels=LEVELS, model_kw=dict(n_sub_slots=64),
                   ops=_ops(seed), **({"shards": 4} if sharded else {}))
              for seed, sharded in ((21, False), (22, True))]


@pytest.fixture(scope="module")
def ref_host():
    return run_reference({"ref_host_model": HOST_CASES})["ref_host_model"]


def _normal(seen: list) -> list:
    """Matched and aux filters as sorted lists (the reference's native
    matcher and the oracle trie list a topic's filters in other orders)."""
    out = []
    for item in seen:
        if item[0] == "pub":
            matched, aux, slots, fallback = item[1]
            out.append(("pub", [sorted(m) for m in matched],
                        [sorted(a) for a in aux], slots, fallback))
        else:
            out.append(item)
    return out


@pytest.mark.parametrize("i", range(len(HOST_CASES)),
                         ids=["flat", "S4"])
def test_host_path_equals_reference(monkeypatch, ref_host, i):
    case = HOST_CASES[i]
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "host")
    index = (ShardedTrieIndex(case["shards"], max_levels=LEVELS)
             if case.get("shards") else TrieIndex(max_levels=LEVELS))
    model = RouterModel(index, device="cpu", **case["model_kw"])
    assert model._host_matcher is not None
    got = drive_model(model, case["ops"])
    assert _normal(got) == _normal(ref_host[i])
    counts = [s for s in got if s[0] == "host_counts"]
    assert counts[-1][1:3] == (0, 3)          # no launch, three batches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: auto dispatch on a card model")
    return torch.device("cuda")


@pytest.mark.cuda
def test_auto_on_the_card_runs_the_kernels(monkeypatch, cuda_device):
    monkeypatch.delenv("EMQX_TPU_CPU_KERNEL", raising=False)
    model = _mk(monkeypatch, "auto", device=cuda_device)
    assert model._host_matcher is None
    res = model.publish_batch(TOPICS)
    assert model.launch_count == 1 and model.host_match_count == 0
    host = _mk(monkeypatch, "host", device=cuda_device)
    want = host.publish_batch(TOPICS)
    assert [sorted(x) for x in res[0]] == [sorted(x) for x in want[0]]
    assert res[1:] == want[1:]
    assert host.launch_count == 0 and host.host_match_count == 1
