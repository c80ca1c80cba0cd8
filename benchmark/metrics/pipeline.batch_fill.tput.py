"""Messages a pipeline batch over the window: the pipeline's ``published``
and ``batches`` counters read at the window's edges."""


def read(run):
    w = run.win
    if w.batches0 is None or w.batches1 is None or w.batches1 == w.batches0:
        return None
    return (w.published1 - w.published0) / (w.batches1 - w.batches0)
