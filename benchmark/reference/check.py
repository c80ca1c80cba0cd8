"""The comparison that decides ``correct``: what the window delivered to the
recording channels, against the reference router's deliveries for every
message sent.

For each message sent, the deliveries it must have are the reference's
``(session, filter)`` subscriptions matching its topic; each delivery
recorded must carry the message's own topic and payload.  Per publisher,
each channel must receive the publisher's messages in the order they were
sent.  Every count below has the limit 0: the comparison is exact.
"""

from __future__ import annotations

from benchmark.reference.router import ReferenceRouter

LIMITS = {
    "missing_deliveries": 0,       # a subscription the message matches,
                                   # with no delivery of it
    "extra_deliveries": 0,         # a delivery no subscription calls for,
                                   # or a second one of the same
    "payload_mismatches": 0,       # a delivery whose topic or payload is
                                   # not the message's
    "order_violations": 0,         # a publisher's message received after
                                   # a later one of the same publisher
    "undelivered_messages": 0,     # a message sent with no delivery at all
}


def compare(router: ReferenceRouter, channels: dict, log) -> dict:
    """``channels``: ``{session id: [stamp_ns, filter, payload, topic, ...]}``,
    four entries a delivery in the order received;
    ``log``: the message log (``pool``, ``topic``, ``pub``, ``seq``,
    ``payload(i)``).  Returns the counts of ``LIMITS``, ``done``
    (``{message index: stamp of its last delivery}``), ``faulty`` (the set
    of message indices with any fault) and ``checked`` (messages sent)."""
    n = len(log.pub)
    got: dict[int, list] = {}
    done: dict[int, int] = {}
    faulty: set[int] = set()
    bad_payload = order = 0
    for sid, flat in channels.items():
        last: dict[int, int] = {}
        for j in range(0, len(flat), 4):
            stamp, filt, payload, topic = flat[j:j + 4]
            payload = bytes(payload)
            i = int.from_bytes(payload[:8], "little")
            if (i >= n or payload != log.payload(i)
                    or topic != log.pool[log.topic[i]]):
                bad_payload += 1
                if i < n:
                    faulty.add(i)
                continue
            got.setdefault(i, []).append((sid, filt))
            if done.get(i, 0) < stamp:
                done[i] = stamp
            p, k = log.pub[i], log.seq[i]
            if last.get(p, -1) > k:
                order += 1
                faulty.add(i)
            else:
                last[p] = k
    missing = extra = undelivered = 0
    want_of: dict[int, set] = {}
    for i in range(n):
        t = log.topic[i]
        want = want_of.get(t)
        if want is None:
            want = want_of[t] = router.deliveries(log.pool[t])
        have = got.get(i, [])
        if want and not have:
            undelivered += 1
        hit = want.intersection(have)
        miss = len(want) - len(hit)
        over = len(have) - len(hit)
        if miss or over:
            faulty.add(i)
        missing += miss
        extra += over
    counts = {"missing_deliveries": missing, "extra_deliveries": extra,
              "payload_mismatches": bad_payload, "order_violations": order,
              "undelivered_messages": undelivered}
    return {"counts": counts, "done": done, "faulty": faulty, "checked": n,
            "deliveries": sum(len(v) for v in got.values())}
