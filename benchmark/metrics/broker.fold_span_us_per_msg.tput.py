"""The broker's hook fold a message from inside the program: the
``broker.fold`` span of ``Broker.publish_batch_submit``, summed over the
window's batches, over their messages (``broker.fold_us_per_msg.tput``
reads the same stage from outside)."""

from benchmark.program_spans import in_window, per_msg_us, span_ns


def read(run):
    batches = in_window(run)
    return per_msg_us(batches, span_ns(batches, "broker.fold"))
