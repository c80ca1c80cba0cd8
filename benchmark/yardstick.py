"""The fixed arithmetic of the benchmark: the card's published peaks, the
union of device intervals, percentiles, and the bytes a kernel needs,
counted from the reference's walk of the filters and topics alone (never
from the program's arrays, so a new layout or kernel cannot move it)."""

from __future__ import annotations

import math

# copied from chip_smoke.py (HBM_BYTES_PER_S, SCALAR_OPS_PER_S, bound_ms):
# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


# copied from chip_smoke.py bound_ms
def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the interval union of chip_smoke.py idle_phase
def union_length(spans, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` spans clipped to
    ``[lo, hi]``."""
    busy, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans
                       if b > lo and a < hi):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at least
    ``q`` of all values at or below it (``inf`` counts as a value)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def walk_bytes(words: int, fids: int, edges: int) -> int:
    """Bytes a trie walk needs for one topic: its words in (4 bytes each),
    its length and ``$`` flag (5 bytes), the matched filter ids out (4 bytes
    each) and 4 bytes for each trie edge the walk of the subscribed
    filters must follow."""
    return 4 * words + 5 + 4 * fids + 4 * edges


# RouterModel's default dense_threshold (models/router_model.py): a filter
# with more subscribers than this owns a row of the dense pool, which the
# fan-out ORs; the slots of every other filter are decoded on the host
DENSE_THRESHOLD = 64


def fanout_bytes(topics: int, fids: int, dense_rows: int,
                 slots: int) -> int:
    """Bytes a fan-out of one batch needs: the matched filter ids in and
    each one's pool-row entry (4 bytes each), the pool row of each distinct
    matched filter with more than ``DENSE_THRESHOLD`` subscribers read once,
    and one output row a topic (a bit a slot)."""
    row = slots // 8
    return 8 * fids + dense_rows * row + topics * row
