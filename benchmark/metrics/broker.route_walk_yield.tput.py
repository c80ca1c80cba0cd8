"""The host route walk's yield: the walks that found a shared or remote
leg over all walks (the ``route_walk_hits`` and ``route_walks`` counters),
over the window's batches."""

from benchmark.program_spans import counter, in_window


def read(run):
    batches = in_window(run)
    walks = counter(batches, "route_walks")
    return counter(batches, "route_walk_hits") / walks if walks else None
