"""The port's alarm, stats, ``$SYS`` heartbeat and Prometheus exposition
(``emqx_tpu_torch/observe/{alarm,stats,sys,prometheus}.py``) against the
reference's.

- The cases of ``tests/test_observe.py`` over both packages (``pkg``), from
  the reference's own source with the package name pointed at the port for
  ``port``; ``BrokerApp`` is that package's own (the harness's
  ``app_class``).
- The cases of ``tests/test_kernel_observe.py`` over both packages, each
  over the port's ``RouterModel`` on the CPU (the reference's model does
  not import here: ``ROADMAP.md`` R1): the fold, the broker's ledger and
  the app's wiring (``BrokerApp.prometheus``, ``kernel_summary``, the
  ``$SYS`` kernel heartbeat, the server's surface, the management API's
  ``/api/v5/kernel/stats``).
- Both packages' ``SysHeartbeat.publish_kernel`` and ``prometheus.render``
  over one fold after the same batches give the same topics, payloads and
  lines.
"""

from __future__ import annotations

import pytest

from test_torch_harness import APP_CASES, PKGS, call_reference, \
    cpu_router_models, reference_calls, reference_case_names, \
    reference_tests, services, waiting
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)


OBSERVE = reference_calls("test_observe", waiting("test_observe"))
HEARTBEAT = ["test_sys_kernel_heartbeat_renders_at_zero"]
KERNEL = reference_calls("test_kernel_observe",
                         waiting("test_kernel_observe") | set(HEARTBEAT))


def test_reference_case_counts():
    names = reference_case_names("test_observe")
    assert len(names) == 13
    assert {c for c in APP_CASES if c.startswith("test_observe::")} == {
        f"test_observe::{c}" for c in set(names) - {c for c, _ in OBSERVE}}
    assert len(OBSERVE) == 13
    names = reference_case_names("test_kernel_observe")
    assert len(names) == 14
    assert waiting("test_kernel_observe") == set()
    assert set(HEARTBEAT) <= set(names) and len(KERNEL) == 13


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", OBSERVE)
def test_reference_observe_case(case, i, pkg):
    call_reference("test_observe", pkg, case, i)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", HEARTBEAT)
def test_reference_kernel_heartbeat_case(case, pkg, monkeypatch):
    cpu_router_models(monkeypatch, reference_tests("test_kernel_observe",
                                                   pkg))
    call_reference("test_kernel_observe", pkg, case, 0)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case,i", KERNEL)
def test_reference_kernel_observe_case(case, i, pkg, monkeypatch):
    cpu_router_models(monkeypatch, reference_tests("test_kernel_observe",
                                                   pkg))
    call_reference("test_kernel_observe", pkg, case, i,
                   monkeypatch=monkeypatch)


def _heartbeat(pkg: str, fold, metrics, ledger) -> tuple:
    m = services(pkg)
    seen = []
    hb = m.sys.SysHeartbeat("n1", lambda msg: seen.append(
        (msg.topic, msg.payload, msg.qos, msg.retain)), metrics=metrics,
        ledger=ledger, kernel=fold)
    hb.publish_kernel()
    hb.publish_ledger()
    hb.publish_metrics()
    text = m.prometheus.render(metrics, node="n1", kernel=fold.gauges())
    # less the process's RSS and the scrape's wall-clock second
    return seen, [ln for ln in text.splitlines()
                  if not ln.startswith(("emqx_vm_memory_bytes", "# EOF"))]


def test_kernel_heartbeat_and_exposition_equal_the_reference(monkeypatch):
    """One port model on the CPU, its batches folded by the port's fold;
    both packages' heartbeat and exposition over that fold's state."""
    cpu_router_models(monkeypatch)
    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex
    port = services("port")
    metrics = port.metrics.Metrics()
    ledger = port.metrics.DegradationLedger(metrics)
    model = RouterModel(TrieIndex(max_levels=4), n_sub_slots=64,
                        kernel_telemetry=True)
    fold = port.device_metrics.DeviceMetricsFold(
        metrics, ledger=ledger, spans=port.trace.SpanCollector(),
        model=model, node="n1")
    model.telemetry = fold
    broker = port.broker.Broker(node="n1", router_model=model,
                                metrics=metrics)
    broker.ledger = ledger
    for i, f in enumerate(["a/+", "a/b", "#", "c/+/d"]):
        broker.subscribe(f"s{i}", f)
    M = port.message.Message
    for topics in (["a/b", "c/x/d"], ["deep/a/b/c/d/e", "a/q"]):
        broker.publish_batch([M(topic=t) for t in topics])
    assert fold.batches == 2 and ledger.totals()["kernel_overflow"] == 1
    got = _heartbeat("port", fold, metrics, ledger)
    want = _heartbeat("ref", fold, metrics, ledger)
    assert [t for t, *_ in got[0] if "/kernel/" in t]
    stamps = ("/ledger/last",)      # the newest event's wall-clock stamp
    assert [x for x in got[0] if not x[0].endswith(stamps)] == \
        [x for x in want[0] if not x[0].endswith(stamps)]
    assert got[1] == want[1]
    assert any(ln.startswith("emqx_latency_kernel_step_seconds_count")
               for ln in got[1])
