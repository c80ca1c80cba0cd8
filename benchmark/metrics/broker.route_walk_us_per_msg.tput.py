"""The broker's host route walk a message (``_collect_nonlocal``, the walk
for shared and remote legs): the ``route_walk_ns`` counter, summed over the
window's batches, over their messages."""

from benchmark.program_spans import counter, in_window, per_msg_us


def read(run):
    batches = in_window(run)
    return per_msg_us(batches, counter(batches, "route_walk_ns"))
