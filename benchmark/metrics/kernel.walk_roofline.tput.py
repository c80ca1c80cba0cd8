"""The trie walk's share of its roofline, in %: the bytes a walk of the
window's batches needs (counted by the reference, ``benchmark/yardstick.py``
``walk_bytes``) over the card's 3.35 TB/s, over the walk kernel's device
time, each as a mean over the window's batches and launches."""

from benchmark.spans import WALK_KERNEL
from benchmark.yardstick import bound_ms


def read(run):
    if run.trace is None:
        return None
    times = run.trace["kernels"][WALK_KERNEL]
    work = run.work()
    if not times or not work:
        return None
    need = sum(w for w, _ in work) / len(work)
    ms, _ = bound_ms(need, 0)
    return 100.0 * ms / 1e3 / (sum(times) / len(times))
