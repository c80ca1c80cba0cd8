"""The expansion's yield: deliveries over the suboption probes that found
them (the ``deliveries`` and ``expand_probes`` counters), over the window's
batches."""

from benchmark.program_spans import counter, in_window


def read(run):
    batches = in_window(run)
    probes = counter(batches, "expand_probes")
    return counter(batches, "deliveries") / probes if probes else None
