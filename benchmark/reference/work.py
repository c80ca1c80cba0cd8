"""The bytes the step's kernels need for a batch of topics, counted from
the reference router's walk of the subscribed filters (see
``benchmark/yardstick.py`` for what each byte is)."""

from __future__ import annotations

from benchmark.reference.router import ReferenceRouter
from benchmark.yardstick import DENSE_THRESHOLD, fanout_bytes, walk_bytes


def batch_bytes(router: ReferenceRouter, topics: list[str],
                slots: int) -> tuple[int, int]:
    """``(walk bytes, fan-out bytes)`` for one batch of ``topics`` over a
    subscriber space of ``slots`` slots.  A filter's subscribers are its
    sessions, which the program maps onto at most as many slots."""
    walk = fids = 0
    dense: set[str] = set()
    for t in topics:
        matched, edges = router.walk(t)
        walk += walk_bytes(len(t.split("/")), len(matched), edges)
        fids += len(matched)
        dense.update(f for f in matched
                     if len(router.holders[f]) > DENSE_THRESHOLD)
    return walk, fanout_bytes(len(topics), fids, len(dense), slots)
