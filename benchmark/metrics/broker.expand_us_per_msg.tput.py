"""The broker's slot -> session -> filter expansion a message: the
``expand_ns`` counter of ``Broker.publish_batch_collect``, summed over the
window's batches, over their messages."""

from benchmark.program_spans import counter, in_window, per_msg_us


def read(run):
    batches = in_window(run)
    return per_msg_us(batches, counter(batches, "expand_ns"))
