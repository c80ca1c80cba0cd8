"""95th percentile over the window's batches' messages of the wait from a
message's ``PublishPipeline.submit`` to the start of its batch's
``Broker.publish_batch_submit``."""

from benchmark.yardstick import nearest_rank


def read(run):
    waits = [(t - run.log.submit[i]) / 1e6
             for t, idx in run.batches() for i in idx]
    return nearest_rank(waits, 0.95) if waits else None
