"""The port's serving plane, held to the JAX package's.

The port keeps its own copies of the modules around the routing model:
``core/message.py``, ``router/router.py``, ``broker/hooks.py``,
``mqtt/packet.py``, ``session/{inflight,mqueue,session}.py``,
``broker/cm.py``, ``observe/{metrics,trace}.py``, ``broker/broker.py``,
``broker/pipeline.py`` and ``observe/device_metrics.py``.  Each must have
the reference module's public names and signatures.  Then the port's
``Broker`` + ``CM`` + ``PublishPipeline`` + ``DeviceMetricsFold`` and the
reference's run the same seeded op streams over two copies of the same port
``RouterModel(device="cpu")``: seeded random filters and topics, ``$``
topics, ``$share/g/...`` groups, a hook that drops a message, K=2 frontier
overflow and topics deeper than the index (the host-oracle fallback), an
unsubscribe between a batch's submit and its collect, the pipeline's knee
and sojourn spill, and the host-matcher dispatch.  They must give the same
delivery maps, the same deliveries to each channel in the same order, and
the same metric slots, ledger, fold, pipeline and model counts.  The whole
port slice is also held to the reference's slice over the reference's
``RouterModel``, in the harness's child process (there one message's legs
to one session are compared in sorted order: on the host path they follow
the iteration order of a set of strings, which differs between processes).
Where the port parts from the reference on purpose, over a model on the
card, a step that raises reaches the caller instead of failing over to the
host oracle, and the pipeline's knee defaults to 0.  Tests marked ``cuda``
run the port's plane over a model on the card.
"""

from __future__ import annotations

import importlib
import inspect
import threading

import numpy as np
import pytest
import torch

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import build_model, gen_filters, gen_topics, \
    run_reference, run_serving, serving_plane, drive_serving, \
    serving_state

MODULES = ["core.message", "router.router", "broker.hooks", "mqtt.packet",
           "session.inflight", "session.mqueue", "session.session",
           "broker.cm", "observe.metrics", "observe.trace", "broker.broker",
           "broker.pipeline", "observe.device_metrics"]


def _public(mod) -> dict:
    return {n: v for n, v in vars(mod).items() if not n.startswith("_")}


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return None


def _value(v) -> str:
    """A constant's repr, or its type's name where the repr is only an
    address (a sentinel ``object()``)."""
    r = repr(v).replace("emqx_tpu_torch", "emqx_tpu")
    return type(v).__name__ if " at 0x" in r else r


def _shape(obj):
    """What a public name is, as far as its callers can tell: a class's
    signature and its own public methods' and properties', a function's
    signature, a module's name, a constant's value."""
    if inspect.ismodule(obj):
        return ("module", obj.__name__.replace("emqx_tpu_torch", "emqx_tpu"))
    if inspect.isclass(obj):
        members = {}
        for n, v in vars(obj).items():
            if n.startswith("_") and n != "__init__":
                continue
            if isinstance(v, (staticmethod, classmethod)):
                v = v.__func__
            if callable(v):
                members[n] = _signature(v)
            elif isinstance(v, property):
                members[n] = "property"
            else:
                members[n] = _value(v)
        return ("class", _signature(obj), members)
    if callable(obj):
        return ("callable", _signature(obj))
    return ("value", _value(obj))


# Where the port adds to the reference's surface on purpose: the publish
# path's batch traces (observe/trace.py) and the router's away index (the
# routes that are not its node's own, which the map build walks).  By the
# reference class's module
# and name, the members the port's class has with another signature or in
# addition; by module, the names only the port's has.
PORT_MEMBERS = {
    "broker.broker.Broker": {
        "publish_batch_submit": "(self, msgs: 'Sequence[Message]', "
                                "force_host: 'bool' = False, trace=None)",
        "publish_batch_collect": "(self, token, trace=None) -> "
                                 "'list[dict[Sid, list[tuple[str, "
                                 "Message]]]]'",
    },
    "observe.device_metrics.DeviceMetricsFold": {
        "on_batch": "(self, counters, *, n_topics: 'int', submit_ns: 'int', "
                    "step_ns: 'int', decode_ns: 'int', t_submit_ns: 'int', "
                    "t_collect_ns: 'int', trace=None) -> 'None'",
    },
    "observe.trace.SpanCollector": {
        "commit": "(self, batch: 'BatchTrace') -> 'None'",
        "resize": "(self, max_traces: 'int') -> 'None'",
        "batch": "(self, trace_id: 'int') -> 'Optional[BatchTrace]'",
        "batches": "(self) -> 'list'",
        "find": "(self, msg_id: 'int') -> 'Optional[BatchTrace]'",
    },
    "router.router.Router": {
        "set_home": "(self, dest: 'Any') -> 'None'",
        "match_away_routes": "(self, topic: 'str') -> 'list[Route]'",
        "home": "property",
        "away_count": "property",
    },
    "app.BrokerApp": {
        "trace_batches": "(self, sample_every: 'int', max_traces: 'int')",
    },
}
PORT_NAMES = {"observe.trace": {"BatchTrace", "active_batch", "now_ns"}}


def port_shape(ref_obj):
    """The shape the port's counterpart of ``ref_obj`` must have: the
    reference's, with the :data:`PORT_MEMBERS` of its class laid over it."""
    shape = _shape(ref_obj)
    if shape[0] == "class":
        key = (ref_obj.__module__.removeprefix("emqx_tpu.") + "."
               + ref_obj.__qualname__)
        shape = (*shape[:2], {**shape[2], **PORT_MEMBERS.get(key, {})})
    return shape


@pytest.mark.parametrize("name", MODULES)
def test_public_names_and_signatures(name):
    ref = importlib.import_module(f"emqx_tpu.{name}")
    port = importlib.import_module(f"emqx_tpu_torch.{name}")
    r, p = _public(ref), _public(port)
    assert sorted(p) == sorted(set(r) | PORT_NAMES.get(name, set()))
    for n in r:
        if getattr(r[n], "__module__", None) == "typing":
            continue
        assert _shape(p[n]) == port_shape(r[n]), n


def test_subpackages_export_the_reference_names():
    for sub in ("broker", "session", "core", "mqtt"):
        ref = importlib.import_module(f"emqx_tpu.{sub}")
        port = importlib.import_module(f"emqx_tpu_torch.{sub}")
        assert port.__all__ == ref.__all__
        for n in ref.__all__:
            assert getattr(port, n).__name__.replace("emqx_tpu_torch",
                                                     "emqx_tpu") == \
                getattr(ref, n).__name__
    # the port's router also exports its device indexes
    import emqx_tpu.router as ref_router
    import emqx_tpu_torch.router as port_router
    assert set(ref_router.__all__) <= set(port_router.__all__)


def test_fold_takes_the_steps_counter_fields():
    from emqx_tpu.observe import device_metrics as ref_dm
    from emqx_tpu_torch.observe import device_metrics as dm
    from emqx_tpu_torch.ops import trie_match as tm
    assert dm.KERNEL_COUNTER_FIELDS is tm.KERNEL_COUNTER_FIELDS
    assert dm.KERNEL_COUNTER_FIELDS == ref_dm.KERNEL_COUNTER_FIELDS


# ---------------------------------------------------------------------------
# the serving plane, op stream by op stream
# ---------------------------------------------------------------------------

LEVELS = 6


def _msgs(rng, topics) -> list:
    return [(t, f"p{i}".encode(), int(rng.integers(0, 3)))
            for i, t in enumerate(topics)]


def serving_ops(seed: int, n_sids: int = 24, n_filters: int = 90) -> list:
    """A seeded op stream over the serving plane."""
    rng = np.random.default_rng(seed)
    filters = gen_filters(rng, n_filters, max_words=LEVELS) + [
        "#", "$SYS/#", "+/a", "a/+", "drop/#"]
    sids = [f"c{i}" for i in range(n_sids)]
    subs = [(sids[int(rng.integers(0, n_sids))], f, int(rng.integers(0, 3)))
            for f in filters]
    subs += [(sids[i], f"$share/g/{f}", 1)
             for i, f in zip(range(0, n_sids, 5), ("a/#", "b/+", "#", "a/b",
                                                   "$SYS/+"))]
    subs += [(sids[1], "a/+", 2), (sids[2], "a/+", 0)]  # shared filters
    ops = [("sub", *s) for s in subs]

    def batch(n):
        topics = gen_topics(rng, n, max_words=LEVELS + 2) + [
            "$SYS/x", "$SYS", "a/b", "drop/x", "a/b/c/dd/a/b/c/dd"]
        return _msgs(rng, topics)

    ops += [("pub", batch(40)), ("host", batch(20))]
    # an unsubscribe (and a subscriber gone) between submit and collect
    ops += [("submit", batch(30))]
    ops += [("unsub", s, f) for s, f, _ in subs[:8]]
    ops += [("down", sids[3]), ("collect",), ("pub", batch(30))]
    # the pipeline: three full batches and a tail, depth 4, then a burst
    # whose head waited past the spill deadline
    ops += [("pipe", batch(50)), ("pipe", batch(30)), ("flush",)]
    ops += [("aged", batch(3)), ("pipe", batch(10)), ("flush",)]
    # a batch of two: below a knee of 4
    ops += [("pipe", _msgs(rng, ["a/b", "$SYS/x"])), ("flush",)]
    ops += [("sub", sids[5], "a/#", 1), ("pub", batch(20))]
    return ops


def _case(seed, **kw) -> dict:
    case = dict(max_levels=LEVELS, model_kw=dict(
        n_sub_slots=kw.pop("n_sub_slots", 16), kernel_telemetry=True,
        K=kw.pop("K", 32), M=kw.pop("M", 16), ret_cap=kw.pop("ret_cap", 8)),
        drop="drop/", max_batch=16, depth=4, min_batch=kw.pop("min_batch", 0),
        spill_ms=kw.pop("spill_ms", 60_000.0), ops=serving_ops(seed))
    case.update(kw)
    return case


# name: case.  16 slots for 24 session ids: slots are shared past 16.
CASES = {
    "flat": _case(31),
    "k2_overflow": _case(32, K=2),
    "s4": _case(33, shards=4),
    "knee_spill": _case(34, min_batch=4, spill_ms=5_000.0),
    "host_matcher": _case(35, cpu_kernel="host"),
    "s4_host_matcher": _case(36, shards=4, cpu_kernel="host", K=2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_plane_equals_reference_plane_over_one_model(name):
    """The port's Broker, CM, pipeline and fold against the reference's,
    each over its own copy of the same port RouterModel."""
    case = CASES[name]
    port = run_serving("emqx_tpu_torch", build_model("emqx_tpu_torch", case),
                       case)
    ref = run_serving("emqx_tpu", build_model("emqx_tpu_torch", case), case)
    assert port["seen"] == ref["seen"]
    assert port["state"] == ref["state"]
    st = port["state"]
    launches, host_batches = st["model"][:2]
    assert st["fold"]["batches"] == launches
    assert st["fold"]["host_batches"] == host_batches
    assert st["metrics"]["messages.kernel.hostmatch"] == host_batches
    if case.get("cpu_kernel") == "host":
        assert launches == 0 and host_batches > 0
        assert st["ledger"]["kernel_hostmatch"] == host_batches
    else:
        assert host_batches == 0 and launches > 0
    if case["model_kw"]["K"] == 2 and case.get("cpu_kernel") != "host":
        assert st["ledger"]["kernel_overflow"] > 0
    if name == "knee_spill":
        assert st["pipeline"][2] > 0 and st["pipeline"][3] == 1
    # every published message went somewhere or was counted as dropped
    assert st["metrics"]["messages.dropped"] > 0       # the drop hook
    assert st["metrics"]["messages.delivered"] > 0


def _legs_sorted(state: dict) -> dict:
    """A serving state whose channels list one message's deliveries to one
    session (a run of one topic and payload) in sorted order; the order of
    the messages stays.  Two legs of one message to one session (a plain
    and a ``$share`` filter, or two filters) come in the order of a set of
    strings on the host path, so in an order that differs between two
    processes; and the reference's native host matcher lists a topic's
    filters in another order than the oracle trie."""
    def runs(got):
        out, i = [], 0
        while i < len(got):
            j = i
            while j < len(got) and got[j][1:3] == got[i][1:3]:
                j += 1
            out += sorted(got[i:j])
            i = j
        return out
    return dict(state, channels={s: runs(g)
                                 for s, g in state["channels"].items()})


@pytest.fixture(scope="module")
def ref_slice():
    return run_reference({"ref_serving": list(CASES.values()),
                          "ref_serving_copied": list(CASES.values())})


def _settled(state: dict) -> dict:
    """A serving state without the counters of batches collected after an
    unsubscribe made while they were in flight, nor the fold's totals and
    last block, which sum them.  On the CPU the reference's step may run
    before or after such an unsubscribe reaches its tables (ROADMAP.md
    R4): those counters vary from run to run there; the deliveries do not.
    The port's are held in full to the reference's plane over the port's
    model, and to the reference's slice with its uploads copied."""
    skip = set(state["unsub_in_flight"])
    fold = {k: v for k, v in state["fold"].items()
            if k not in ("totals", "last")}
    return dict(state, fold=fold, blocks=[
        b for i, b in enumerate(state["blocks"]) if i not in skip])


@pytest.mark.parametrize("i", range(len(CASES)), ids=list(CASES))
def test_port_slice_equals_reference_slice(ref_slice, i):
    """The whole port slice (its serving plane over its RouterModel)
    against the reference's plane over the reference's RouterModel."""
    case = list(CASES.values())[i]
    port = run_serving("emqx_tpu_torch", build_model("emqx_tpu_torch", case),
                       case)
    ref = ref_slice["ref_serving"][i]
    assert port["seen"] == ref["seen"]
    got = _legs_sorted(_settled(port["state"]))
    want = _legs_sorted(_settled(ref["state"]))
    if case.get("cpu_kernel") != "host":
        assert got["unsub_in_flight"] == [1]
    assert got == want


@pytest.mark.parametrize("i", range(len(CASES)), ids=list(CASES))
def test_port_slice_equals_reference_slice_with_copied_uploads(ref_slice, i):
    """The whole port slice against the reference's slice whose uploads
    copy its host tables (``_copied_uploads``): every counter, the
    in-flight batches' and the fold's totals included (ROADMAP.md R4)."""
    case = list(CASES.values())[i]
    port = run_serving("emqx_tpu_torch", build_model("emqx_tpu_torch", case),
                       case)
    ref = ref_slice["ref_serving_copied"][i]
    assert port["seen"] == ref["seen"]
    got, want = _legs_sorted(port["state"]), _legs_sorted(ref["state"])
    if case.get("cpu_kernel") != "host":
        assert got["unsub_in_flight"] == [1] and got["blocks"][1] is not None
    assert got == want


def test_collect_after_unsubscribe_drops_the_leg():
    """A filter unsubscribed while its batch is in flight decodes to no
    delivery, on the port as on the reference (the fid stays quarantined
    until the batch is collected)."""
    case = dict(CASES["flat"], ops=[
        ("sub", "c1", "q/+", 0), ("sub", "c2", "q/1", 0),
        ("submit", [("q/1", b"x", 0)]), ("unsub", "c1", "q/+"),
        ("collect",), ("pub", [("q/1", b"y", 0)])])
    for pkg in ("emqx_tpu_torch", "emqx_tpu"):
        got = run_serving(pkg, build_model("emqx_tpu_torch", case), case)
        assert got["seen"][0][1] == [{"c2": [("q/1", "q/1", b"x", 0)]}]
        assert got["seen"][1][1] == [{"c2": [("q/1", "q/1", b"y", 0)]}]


def _plain_plane(device: str):
    """A port Broker and pipeline over a port RouterModel on the CPU whose
    ``device`` then reads as ``device`` (its host tables stay on the CPU)."""
    from emqx_tpu_torch import RouterModel, TrieIndex
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.cm import CM
    from emqx_tpu_torch.broker.pipeline import PublishPipeline
    from emqx_tpu_torch.observe.metrics import DegradationLedger, Metrics
    model = RouterModel(TrieIndex(max_levels=LEVELS), n_sub_slots=16,
                        device="cpu")
    metrics = Metrics()
    broker = Broker(node="n1", router_model=model, metrics=metrics)
    broker.ledger = DegradationLedger(metrics)
    broker.subscribe("c1", "a/+")
    model.device = torch.device(device)
    return model, broker, PublishPipeline(broker, CM())


@pytest.mark.parametrize("stage", ["submit", "collect"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_step_that_raises_fails_over_only_off_the_card(device, stage):
    """A step that raises at submit or at collect: over a CPU model the
    host oracle serves the batch and the failover is counted, as in the
    reference; over a model on the card the error reaches the caller and
    nothing is served or counted."""
    from emqx_tpu_torch.core.message import Message
    model, broker, _ = _plain_plane("cpu")
    msgs = [Message(topic="a/b", payload=b"x")]

    def broken(*_a, **_kw):
        raise RuntimeError("the kernel did not launch")

    token = None
    if stage == "collect":
        token = broker.publish_batch_submit(msgs)
    model.device = torch.device(device)
    setattr(model, f"publish_batch_{stage}", broken)

    def publish():
        return broker.publish_batch_collect(
            token if token is not None else broker.publish_batch_submit(msgs))

    if device == "cuda":
        with pytest.raises(RuntimeError, match="did not launch"):
            publish()
        assert broker.metrics.val("messages.device_failover") == 0
        assert broker.ledger.totals().get("device_failover", 0) == 0
    else:
        assert [sorted(d) for d in publish()] == [["c1"]]
        assert broker.metrics.val("messages.device_failover") == 1
        assert broker.ledger.totals()["device_failover"] == 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_pipeline_knee_defaults_to_the_card(device):
    """Over a model on the card every batch runs the step unless the knee
    is set (no host bypass and no implicit spill); over a CPU model the
    knee is the reference's adaptive one."""
    _, _, pipe = _plain_plane(device)
    if device == "cuda":
        assert pipe.min_device_batch == 0 and pipe.device_knee() == 0
        assert pipe.spill_deadline_ms() is None
    else:
        assert pipe.min_device_batch == -1 and pipe.device_knee() > 1
        assert pipe.spill_deadline_ms() == 30.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the serving plane over a model "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flat", "k2_overflow", "s4"])
def test_plane_on_the_card_equals_the_cpu(cuda_device, name):
    case = CASES[name]
    card = run_serving("emqx_tpu_torch",
                       build_model("emqx_tpu_torch", case, cuda_device), case)
    cpu = run_serving("emqx_tpu_torch", build_model("emqx_tpu_torch", case),
                      case)
    assert card["seen"] == cpu["seen"]
    assert card["state"] == cpu["state"]
    assert card["state"]["metrics"]["messages.device_failover"] == 0


def _valid_topics(rng, n: int) -> list[str]:
    """Seeded topic names a client may publish: no '+' or '#' level (a
    channel rejects those before the broker sees them; where such a name
    equals a filter, the host path delivers it twice, the step once:
    ROADMAP.md R5)."""
    return [t for t in gen_topics(rng, n, max_words=LEVELS)
            if not {"+", "#"} & set(t.split("/"))]


def _flush_on_a_worker_thread(device) -> None:
    """The servers flush on a worker thread while subscribes refresh the
    tables from another: both reach the model under its lock (on the card,
    on the default stream), every batch runs the step, and the channels
    get what the host path routes."""
    case = dict(CASES["flat"], ops=[])
    model = build_model("emqx_tpu_torch", case, device)
    plane = serving_plane("emqx_tpu_torch", model, case)
    rng = np.random.default_rng(7)
    filters = gen_filters(rng, 200, max_words=LEVELS)
    drive_serving(plane, [("sub", f"c{i % 24}", f, 1)
                          for i, f in enumerate(filters)])
    msgs = _msgs(rng, _valid_topics(rng, 480))
    drive_serving(plane, [("pipe", msgs)])
    cuda = torch.device(device).type == "cuda"
    streams = []

    def on_stream():
        if cuda:
            streams.append(torch.cuda.current_stream(device)
                           == torch.cuda.default_stream(device))

    def flush():
        on_stream()
        plane["pipe"].flush()

    def churn():
        on_stream()
        for i, f in enumerate(gen_filters(rng, 50, max_words=LEVELS)):
            model.subscribe(f, 15 - i % 4)
            model.refresh()

    threads = [threading.Thread(target=flush), threading.Thread(target=churn)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(streams) and len(streams) == (2 if cuda else 0)
    st = serving_state(plane)
    n_batches = -(-len(msgs) // 16)
    assert st["pipeline"][:4] == (len(msgs), n_batches, 0, 0)
    assert st["model"][:2] == (n_batches, 0)
    assert st["metrics"]["messages.device_failover"] == 0
    # the churn thread's filters are in the model only: the broker holds
    # no subscription to them
    from emqx_tpu_torch.core.message import Message
    want = {}
    for t, p, q in msgs:
        for sid, items in plane["broker"].publish(
                Message(topic=t, payload=p, qos=q)).items():
            want.setdefault(sid, []).extend(
                (st_, m.topic, bytes(m.payload), m.qos) for st_, m in items)
    got = {s: g for s, g in st["channels"].items() if g}
    assert {s: sorted(g) for s, g in got.items()} == \
        {s: sorted(g) for s, g in want.items()}
    for g in got.values():          # each session's messages in order
        order = [int(p[1:]) for _, _, p, _ in g]
        assert order == sorted(order)


def test_pipeline_flush_on_a_worker_thread():
    _flush_on_a_worker_thread("cpu")


@pytest.mark.cuda
def test_pipeline_flush_on_a_worker_thread_on_the_card(cuda_device):
    _flush_on_a_worker_thread(cuda_device)
