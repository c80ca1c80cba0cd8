"""The card's idle share over the window: 1 less the union of the
profiler's device intervals (kernels, copies, sets) over the window's
length."""


def read(run):
    t = run.trace
    if t is None or not t["device_events"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
