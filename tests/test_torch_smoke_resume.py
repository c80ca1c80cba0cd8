"""``chip_smoke.py``'s resumes wait for the dispatches they need.

The publish pipeline counts a batch as published before its flush thread
builds the delivery map and dispatches it.  A persistent session resumed
in between races that dispatch (ROADMAP R15, a race of the reference's
that the port copies): on one node the resume replays the stored copy
and the late dispatch delivers the message again; across nodes the
takeover hands the resuming node only what the old node's session holds,
and the late dispatch finds no channel.  So the smoke's durable leg and
its cluster takeover wait until the pipeline has dispatched what it
counted (``dispatched``) before they resume.  Here every dispatch to an
away session (a disconnected channel) is held back after its
delivery-map build, which opens that window for certain: without the waits the resumes fail (a duplicate, clients short),
with them every message arrives once, in order.
"""

from __future__ import annotations

import gc
import time


def test_smoke_resumes_wait_for_the_dispatch(monkeypatch):
    import chip_smoke
    import emqx_tpu_torch.broker.cm as cm
    import emqx_tpu_torch.broker.pipeline as pipeline
    monkeypatch.setattr(chip_smoke, "path_counts", lambda name: {})
    monkeypatch.setattr(pipeline, "_on_card", lambda model: True)
    dispatch, held = cm.CM.dispatch, []

    def late_dispatch(self, deliveries):
        if any(getattr(self.lookup_channel(sid), "conn_state", None)
               == "disconnected" for sid in deliveries):
            held.append(len(deliveries))        # to an away session
            time.sleep(0.5)
        return dispatch(self, deliveries)

    monkeypatch.setattr(cm.CM, "dispatch", late_dispatch)
    try:
        out = chip_smoke.durable_phase(
            42, "cpu", "cpu", n_filters=4000, sessions=512, subs=16,
            pubs=4, n_msgs=128, n_exhook=48, connects=4, n_bridge=48,
            gateway={"stomp": 6, "sn": 6, "coap": 4, "lwm2m": 3,
                     "exproto": 3, "pubs": 3, "qos0": 96, "qos1": 24,
                     "up_subs": 4, "up_stomp": 3, "up_sn": 3, "up_coap": 2},
            cluster={"subs": 8, "pubs": 3, "qos0": 96, "qos1": 24,
                     "n2_msgs": 48, "takeover": 3, "pending": 4,
                     "recorded": 32, "after": 48})
    finally:
        gc.unfreeze()               # the phase's load froze its heap
    assert len(held) >= 2, "no dispatch to an away session was held back"
    assert out["persistent"]["markers_stored"] > 0
    assert out["cluster"]["takeover"]["clients"] == 3
    assert out["cluster"]["takeover"]["pending"] == 4
