"""The port's shared subscriptions, retainer and delayed publish
(``emqx_tpu_torch/broker/shared_sub.py``, ``services/{retainer,delayed}.py``)
against the reference's, and the whole slice of this layer: those services,
the rule engine co-batched on the routing step, alarms, stats and ``$SYS``,
wired onto the broker as the reference's app wires them.

- Every module of the slice has the reference module's public names and
  signatures, and the new subpackages export the reference's names.
- The cases of ``tests/test_services.py`` over both packages (``pkg``),
  from the reference's own source with the package name pointed at the port
  for ``port``; ``BrokerApp`` (which its source imports at module level) is
  that package's own (the harness's ``app_class``).
- Seeded op streams (numpy): subscribes and unsubscribes (plain,
  ``$share/g/...``, retain handling 0/1/2), a subscriber gone, an offline
  shared member, rule creates and deletes (``SELECT ... FROM ... WHERE``,
  a recording action, a ``republish`` action on some), publish batches
  through ``Broker.publish_batch`` (retained and empty retained messages,
  ``$delayed/n/...`` and malformed delayed topics, topics deeper than the
  index), host publishes, the delayed queue's tick, an alarm and the
  ``$SYS`` stats and metrics.  The port's app over the port's
  ``RouterModel`` on the CPU and the reference's app over the reference's (in
  the harness's child process) give the same delivery maps, fired rules
  (less the columns that read the clock or mint an id), channel
  deliveries (the republished messages among them), retained set after
  each op, the model's aux column per message, metric slots and stats,
  with shared picks under ``round_robin``, ``sticky`` and
  ``hash_clientid``, and a model whose ``M`` and ``ret_cap`` spill rows
  to the host fallback.  Integers and strings only: no tolerance.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import test_torch_broker as tb
from test_torch_harness import ALPHABET, PKGS, build_model, call_reference, \
    gen_filters, reference_calls, reference_case_names, run_reference, \
    run_services
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

MODULES = ["utils.jq", "rules.sqlparser", "rules.funcs", "rules.runtime",
           "rules.events", "rules.engine", "broker.shared_sub",
           "services.retainer", "services.delayed", "observe.alarm",
           "observe.stats", "observe.sys", "observe.prometheus"]


@pytest.mark.parametrize("name", MODULES)
def test_public_names_and_signatures(name):
    ref = importlib.import_module(f"emqx_tpu.{name}")
    port = importlib.import_module(f"emqx_tpu_torch.{name}")
    r, p = tb._public(ref), tb._public(port)
    assert sorted(p) == sorted(r)
    for n in r:
        if getattr(r[n], "__module__", None) == "typing":
            continue
        assert tb._shape(p[n]) == tb._shape(r[n]), n


def test_new_subpackages_export_the_reference_names():
    for sub in ("rules", "services", "utils"):
        ref = importlib.import_module(f"emqx_tpu.{sub}")
        port = importlib.import_module(f"emqx_tpu_torch.{sub}")
        assert getattr(port, "__all__", None) == getattr(ref, "__all__",
                                                         None)
        for n in getattr(ref, "__all__", ()):
            assert getattr(port, n).__name__ == getattr(ref, n).__name__


SERVICES = reference_calls("test_services")


def test_reference_case_counts():
    assert len(reference_case_names("test_services")) == len(SERVICES) == 26


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", SERVICES)
def test_reference_services_case(case, i, pkg):
    call_reference("test_services", pkg, case, i)


# ---------------------------------------------------------------------------
# the slice, op stream by op stream
# ---------------------------------------------------------------------------

LEVELS = 6
WORDS = [w for w in ALPHABET if w != "$SYS"] + ["zz"]
FORMS = [  # (select, where): the rule SQL shapes
    ("topic, payload", ""),
    ("topic, qos, clientid AS who", " WHERE qos > 0"),
    ("*", ""),
    ("topic, upper(payload) AS up, retain", ""),
    ("topic, payload", " WHERE clientid = 'p1'"),
]


def _topics(rng, n: int) -> list[str]:
    """Valid topic names, a tenth under ``$SYS``, some deeper than the
    index."""
    out = []
    for _ in range(n):
        ws = [WORDS[i] for i in rng.integers(0, len(WORDS),
                                             rng.integers(1, LEVELS + 3))]
        out.append("/".join((["$SYS"] if rng.random() < 0.1 else []) + ws))
    return out


def _batch(rng, n: int, retain: float = 0.0) -> list:
    """``n`` messages (topic, payload, qos, retain, publisher), with
    ``$delayed`` ones and one malformed delayed topic."""
    out = []
    for i, t in enumerate(_topics(rng, n)):
        r = rng.random()
        if r < 0.08:
            t = f"$delayed/{int(rng.integers(0, 4))}/{t}"
        elif r < 0.1:
            t = "$delayed/xx/" + t
        out.append((t, f"p{i}".encode(), int(rng.integers(0, 3)),
                    bool(rng.random() < retain), f"p{int(rng.integers(0, 4))}"))
    return out


def services_ops(seed: int, n_sids: int = 20) -> list:
    """A seeded op stream over the services."""
    rng = np.random.default_rng(seed)
    filters = gen_filters(rng, 40, max_words=LEVELS) + [
        "#", "a/+", "+/b", "a/#", "$SYS/#"]
    filters = [f for f in dict.fromkeys(filters) if "$SYS" not in f[1:]]
    sids = [f"c{i}" for i in range(n_sids)]

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    def rule(i):
        sel, where = FORMS[i % len(FORMS)]
        src = ", ".join(f'"{pick(filters)}"' for _ in range(1 + (i % 4 == 3)))
        return ("rule", f"r{i}", f"SELECT {sel} FROM {src}{where}",
                i % 6 == 2)

    ops = [rule(i) for i in range(32)]
    ops.append(("rule", "rp", 'SELECT topic, payload FROM "$rp/#"', False))
    # retained messages before anyone subscribes
    ops.append(("host", [(t, b"r-" + t.encode(), 1, True, "p0")
                         for t in _topics(rng, 12) if "$SYS" not in t]))
    subs = [("sub", pick(sids), f, int(rng.integers(0, 3)),
             int(rng.integers(0, 3))) for f in filters]
    subs += [("sub", sids[g * 3 + k], f"$share/g{g}/{f}", 1, 0)
             for g, f in enumerate(("#", "a/+", "+/b", "a/#"))
             for k in range(3)]
    subs += [("sub", "sys", "$SYS/#", 0, 0), ("sub", "rp", "$rp/#", 0, 0)]
    ops += subs
    ops.append(("pub", _batch(rng, 40, retain=0.2)))
    ops.append(("offline", sids[1]))          # a shared member: nacks qos>0
    ops.append(("pub", _batch(rng, 40)))
    # an empty retained publish clears its topic and is not routed
    ops.append(("pub", [(t, b"", 0, True, "p2") for t in
                        [op[1][0][0] for op in ops if op[0] == "host"][:1]]
                + _batch(rng, 6)))
    # resubscribes: retain handling 1 on an existing subscription, 0, 2
    for s in subs[:4]:
        ops.append(("sub", s[1], s[2], s[3], 1))
    ops.append(("sub", "late", "#", 1, 0))
    ops.append(("sub", "late", "+/+", 0, 2))
    ops += [("unrule", f"r{i}") for i in range(0, 32, 5)]
    ops.append(rule(40))                        # a replacement of an id
    ops[-1] = ops[-1][:1] + ("r1",) + ops[-1][2:]
    ops.append(("pub", _batch(rng, 40)))
    ops += [("unsub", s[1], s[2]) for s in subs[4:12]]
    ops += [("down", sids[3]), ("down", sids[6])]
    ops.append(("pub", _batch(rng, 40, retain=0.1)))
    ops.append(("host", _batch(rng, 12)))
    ops += [("tick",), ("alarm", "high_cpu"), ("sys",)]
    ops.append(("pub", _batch(rng, 20)))
    return ops


def _case(seed: int, strategy: str, **model_kw) -> dict:
    return dict(max_levels=LEVELS, strategy=strategy, seed=seed,
                model_kw=dict(n_sub_slots=16, kernel_telemetry=True, K=32,
                              M=model_kw.get("M", 16),
                              ret_cap=model_kw.get("ret_cap", 8)),
                ops=services_ops(seed))


# three seeds, one shared strategy each; then M and ret_cap that spill
CASES = {
    "round_robin": _case(101, "round_robin"),
    "sticky": _case(102, "sticky"),
    "hash_clientid": _case(103, "hash_clientid"),
    "spill": _case(104, "round_robin", M=8, ret_cap=4),
}


@pytest.fixture(scope="module")
def ref_slice():
    return run_reference({"ref_services": list(CASES.values())})


@pytest.mark.parametrize("i", range(len(CASES)), ids=list(CASES))
def test_port_slice_equals_reference_slice(ref_slice, i):
    """The port's services over its RouterModel against the reference's
    over the reference's RouterModel, op by op."""
    case = list(CASES.values())[i]
    got = run_services("emqx_tpu_torch",
                       build_model("emqx_tpu_torch", case), case)
    want = ref_slice["ref_services"][i]
    assert len(got["seen"]) == len(want["seen"]) == len(case["ops"])
    for j, (g, w) in enumerate(zip(got["seen"], want["seen"])):
        assert g == w, (j, case["ops"][j][0])
    assert got["aux"] == want["aux"]
    assert got["metrics"] == want["metrics"]
    assert got["stats"] == want["stats"]
    # the streams exercise what they are for
    fired = [f for _, _, fs, _, _ in got["seen"] for f in fs]
    assert len(fired) > 50 and any(f[0] == "rp" for f in fired)
    assert any(a is None for _, a in got["aux"])
    assert any(a for _, a in got["aux"])
    delivered = [d for _, _, _, chans, _ in got["seen"] for d in chans]
    assert "rp" in delivered and "sys" in delivered
    shared = [t for op, out, *_ in got["seen"] if op == "pub"
              for d in out for items in d.values() for t, *_ in items
              if t.startswith("$share/")]
    assert len(shared) > 10
    assert any(r for *_, r in got["seen"])
    if case["model_kw"]["M"] == 8:
        assert sum(a is None for _, a in got["aux"]) > 20
