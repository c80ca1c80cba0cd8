"""The fan-out's share of its roofline, in %: the bytes a fan-out of the
window's batches needs (counted by the reference, ``benchmark/yardstick.py``
``fanout_bytes``) over the card's 3.35 TB/s, over the fan-out kernel's
device time, each as a mean over the window's batches and launches."""

from benchmark.spans import FANOUT_KERNEL
from benchmark.yardstick import bound_ms


def read(run):
    if run.trace is None:
        return None
    times = run.trace["kernels"][FANOUT_KERNEL]
    work = run.work()
    if not times or not work:
        return None
    need = sum(f for _, f in work) / len(work)
    ms, _ = bound_ms(need, 0)
    return 100.0 * ms / 1e3 / (sum(times) / len(times))
