"""The model's wait for the step a message: its ``model.wait`` span (the
copy back's events synchronised), summed over the window's batches, over
their messages."""

from benchmark.program_spans import in_window, per_msg_us, span_ns


def read(run):
    batches = in_window(run)
    return per_msg_us(batches, span_ns(batches, "model.wait"))
