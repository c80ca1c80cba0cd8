"""The model's submit a message (tokenize, upload, launch): the
``submit_ns`` its telemetry hook reports for each batch collected in the
window, over the batches' topics."""


def read(run):
    rows = [r for r in run.spans.telemetry if run.in_window(r[0])] \
        if run.spans is not None else []
    n = sum(r[1] for r in rows)
    return sum(r[2] for r in rows) / 1e3 / n if n else None
