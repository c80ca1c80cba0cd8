"""The port's rule engine (``emqx_tpu_torch/rules/``) and jq interpreter
(``emqx_tpu_torch/utils/jq.py``) against the reference's, and the rules
co-batched on the port's routing step.

- The cases of ``tests/test_rules.py`` and ``tests/test_jq.py`` over both
  packages (``pkg``), from the reference's own source with the package name
  pointed at the port for ``port`` (a parametrised case once per parameter
  set); ``BrokerApp`` is that package's own (the harness's
  ``app_class``).  The device co-batch cases build ``RouterModel()`` with no
  device: they run on the port's model on the CPU on both sides (the
  reference's model does not import here: ``ROADMAP.md`` R1), so on
  ``ref`` the reference's engine, broker and services drive the port's
  model, and on ``port`` everything is the port's.
- The co-batch boundary on the port: rows whose matched filters
  (subscriptions and rule FROM filters) pass ``M`` or ``ret_cap`` take the
  host fallback, where ``on_matched(m, None)`` matches on the engine's own
  trie; every other row's rules come from the step's aux column; each
  rule fires once a message, as ``rules_for_topic`` says, and as the
  reference's engine and broker over a copy of the same model.
- ``delete_rule`` releases the rule's aux filters from the model, and a
  filter shared by a rule and a subscription keeps its refcounts.

The whole slice (rules, shared subscriptions, retainer, delayed publish)
is held to the reference's over the reference's model in
``tests/test_torch_services.py``.
"""

from __future__ import annotations

import pytest

from test_torch_harness import APP_CASES, PKGS, app_class, \
    call_reference, cpu_router_models, reference_calls, \
    reference_case_names, reference_tests
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

DEVICE_CASES = {
    "test_device_cobatch_fires_rules_once",
    "test_cobatch_fallback_topic_still_fires_rules",
    "test_rule_filter_shared_with_subscription_survives_unsubscribe",
    "test_delayed_message_from_device_batch_still_fires_rules",
    "test_denied_publish_still_fires_rules_on_device_path",
}
RULES = reference_calls("test_rules")
JQ = reference_calls("test_jq")


def test_reference_case_counts():
    assert len(reference_case_names("test_rules")) == len(RULES) == 32
    assert DEVICE_CASES <= {c for c, _ in RULES}
    assert len(reference_case_names("test_jq")) == 7
    assert len(JQ) > 60                 # the parametrised jq manual cases
    assert not [c for c in APP_CASES
                if c.split("::")[0] in ("test_rules", "test_jq")]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", RULES)
def test_reference_rules_case(case, i, pkg, monkeypatch):
    if case in DEVICE_CASES:
        cpu_router_models(monkeypatch)
    call_reference("test_rules", pkg, case, i)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", JQ)
def test_reference_jq_case(case, i, pkg):
    call_reference("test_jq", pkg, case, i)


def test_device_cases_drive_the_port_model(monkeypatch):
    """On both sides the co-batch cases' ``RouterModel`` is the port's,
    built on the CPU, and the rule FROM filter is in its trie."""
    cpu_router_models(monkeypatch)
    from emqx_tpu_torch.models.router_model import RouterModel
    for pkg in PKGS:
        app = reference_tests("test_rules", pkg).BrokerApp(
            router_model=RouterModel(n_sub_slots=64))
        assert type(app.broker).__module__ == {
            "ref": "emqx_tpu.broker.broker",
            "port": "emqx_tpu_torch.broker.broker"}[pkg]
        assert app.broker.model.device.type == "cpu"
        assert app.broker.rules_gate_fn == app.rules.publish_gate
        app.rules.create_rule("r", 'SELECT topic FROM "a/+"', [])
        assert app.broker.model.index.fid_of("a/+") is not None


# ---------------------------------------------------------------------------
# the co-batch boundary: M and ret_cap spill rows to the host fallback
# ---------------------------------------------------------------------------

SPILL_FILTERS = ["s/+/+", "s/#", "+/+/+", "#", "s/x/+", "s/+/y"]


def _spill_app(pkg: str, model):
    """``pkg``'s services over ``model`` (M=8, ret_cap=4): 6 rules, a
    subscriber on each of their filters and on 4 more, and a recorder of
    (rule, topic) per firing and of each ``on_matched`` call's aux."""
    app = app_class(pkg)(router_model=model)
    fired, seen = [], []
    app.rules.register_action("record", lambda cols, args: fired.append(
        (cols["__rule_id"], cols["topic"])))
    for i, f in enumerate(SPILL_FILTERS):
        app.rules.create_rule(f"r{i}", f'SELECT topic FROM "{f}"',
                              [{"function": "record"}])
    for i, f in enumerate(SPILL_FILTERS + ["s/x/y", "s/x/#", "+/x/y",
                                           "+/+/y"]):
        app.broker.subscribe(f"c{i}", f)
    inner = app.broker.rules_matched_fn

    def on_matched(m, aux):
        seen.append((m.topic, None if aux is None else sorted(aux)))
        inner(m, aux)

    app.broker.rules_matched_fn = on_matched
    return app, fired, seen


SPILL_TOPICS = ["s/x/y",          # 10 subscriptions + every rule: spills
                "s/q/y",          # s/+/+ s/# +/+/+ # s/+/y +/+/y: over ret_cap
                "s/x/z",          # s/+/+ s/# +/+/+ # s/x/+ s/x/#: over ret_cap
                "t/q/z",          # +/+/+ #: on the step
                "s/q",            # s/# #: on the step
                "u"]              # #: on the step


def test_spilled_rows_fire_their_rules_once_from_the_host_trie(monkeypatch):
    cpu_router_models(monkeypatch)
    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex

    def model():
        return RouterModel(TrieIndex(max_levels=4), n_sub_slots=64, M=8,
                           ret_cap=4, kernel_telemetry=True)

    runs = {}
    for pkg in PKGS:
        app, fired, seen = _spill_app(pkg, model())
        msgs = [app.mods.message.Message(topic=t, payload=b"x")
                for t in SPILL_TOPICS]
        launches = app.broker.model.launch_count
        maps = app.broker.publish_batch(msgs)
        assert app.broker.model.launch_count == launches + 1
        want = sorted((r.id, t) for t in SPILL_TOPICS
                      for r in app.rules.rules_for_topic(t))
        assert sorted(fired) == want and len(set(fired)) == len(fired)
        runs[pkg] = (sorted(fired), seen,
                     [sorted(sid for sid in d) for d in maps],
                     app.ledger.totals().get("kernel_overflow"))
    fired, seen, maps, overflow = runs["port"]
    assert runs["port"] == runs["ref"]
    # the first three rows spill (host trie, aux None); the rest ride
    # the step's aux column
    assert [a is None for _, a in seen] == [True] * 3 + [False] * 3
    assert overflow == 3
    assert dict(seen)["t/q/z"] == ["#", "+/+/+"]
    assert dict(seen)["u"] == ["#"]
    assert maps[0] == [f"c{i}" for i in range(10)]


def test_delete_rule_releases_its_aux_filters(monkeypatch):
    """``delete_rule`` → ``aux_release``: a filter no rule and no
    subscription holds leaves the model's trie at the next refresh, and
    the step stops firing its rules; a filter two rules share stays until
    both are deleted; one a subscription shares stays routed."""
    cpu_router_models(monkeypatch)
    from emqx_tpu_torch.models.router_model import RouterModel
    for pkg in PKGS:
        app = app_class(pkg)(router_model=RouterModel(n_sub_slots=64))
        model, fired = app.broker.model, []
        app.rules.register_action("record", lambda cols, args: fired.append(
            cols["__rule_id"]))
        for rid, f in (("a", "x/+"), ("b", "x/+"), ("c", "y/#"),
                       ("d", "z/1")):
            app.rules.create_rule(rid, f'SELECT topic FROM "{f}"',
                                  [{"function": "record"}])
        app.broker.subscribe("s1", "z/1")
        # the engine registers a filter once, for the first rule on it
        assert model._aux_refs[model.index.fid_of("x/+")] == 1
        assert app.rules._filter_rules["x/+"] == {"a", "b"}

        def publish():
            fired.clear()
            M = app.mods.message.Message
            out = app.broker.publish_batch(
                [M(topic=t) for t in ("x/1", "y/2/3", "z/1")])
            return sorted(fired), [sorted(d) for d in out]

        assert publish() == (["a", "b", "c", "d"], [[], [], ["s1"]])
        app.rules.delete_rule("a")
        app.rules.delete_rule("c")
        app.rules.delete_rule("d")
        model.refresh()
        assert model.index.fid_of("y/#") is None
        assert model.index.fid_of("x/+") is not None
        assert model.index.fid_of("z/1") is not None    # s1's
        assert model.index.fid_of("z/1") not in model._aux_refs
        assert publish() == (["b"], [[], [], ["s1"]])
        app.rules.delete_rule("b")
        model.refresh()
        assert model.index.fid_of("x/+") is None and not model._aux_refs
        assert publish() == ([], [[], [], ["s1"]])
