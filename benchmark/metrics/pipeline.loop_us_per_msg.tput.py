"""The pipeline's own time a message: its ``pipeline.assemble`` (the pop,
knee and spill checks) and ``pipeline.merge`` (the batch's results merged
into one delivery map) spans, summed over the window's batches, over their
messages."""

from benchmark.program_spans import in_window, per_msg_us, span_ns


def read(run):
    batches = in_window(run)
    return per_msg_us(batches, span_ns(batches, "pipeline.assemble",
                                       "pipeline.merge"))
