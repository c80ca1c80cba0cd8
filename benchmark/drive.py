"""The load: recording channels in the CM, the message log, and the two
loops that drive ``PublishPipeline.submit`` / ``flush``.

Every message's payload is its index in the log (8 bytes, little endian)
followed by a seeded tail, so each delivery names the message it carries.
A closed loop keeps ``inflight`` messages outstanding for each of its
``publishers``: a message is done when its batch's dispatch through the CM
returns, and its publisher then sends the next.  An open loop submits on
a schedule fixed in advance from the seed, whatever the system does, and
each message is timed from when it was due.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

TAIL = 56                     # seeded payload bytes after the 8-byte index


class RecordingChannel:
    """A CM channel that keeps what it is sent: for each delivery, in order,
    the time it came (``perf_counter_ns``), its subscription's filter and the
    message's payload and topic, four entries in one flat list.  It keeps
    atoms (ints, strings, bytes), which the garbage collector never walks,
    and not the messages: a recording that kept them would make every
    collection in the window longer as it grew."""

    __slots__ = ("log",)

    def __init__(self) -> None:
        self.log: list = []

    def handle_deliver(self, items):
        return items

    def send(self, items) -> None:
        now = time.perf_counter_ns()
        log = self.log
        for filt, m in items:
            log += (now, filt, m.payload, m.topic)


def msg_index(msg) -> int:
    return int.from_bytes(msg.payload[:8], "little")


class MessageLog:
    """What was sent: for message ``i`` its publisher, its place in the
    publisher's sequence, its topic (an index into the pool), its tail,
    and when it was due and submitted (``perf_counter_ns``)."""

    def __init__(self, pool: list[str], tails: bytes) -> None:
        self.pool = pool
        self.tails = tails
        self.n_tails = len(tails) // TAIL
        self.pub: list[int] = []
        self.seq: list[int] = []
        self.topic: list[int] = []
        self.due: list[int] = []
        self.submit: list[int] = []

    def __len__(self) -> int:
        return len(self.pub)

    def payload(self, i: int) -> bytes:
        t = (i % self.n_tails) * TAIL
        return i.to_bytes(8, "little") + self.tails[t:t + TAIL]

    def new(self, pub: int, seq: int, topic: int, due: int):
        from emqx_tpu_torch.core.message import Message
        i = len(self.pub)
        self.pub.append(pub)
        self.seq.append(seq)
        self.topic.append(topic)
        self.due.append(due)
        self.submit.append(0)
        return Message(topic=self.pool[topic], payload=self.payload(i),
                       from_=f"p{pub}")


class Window:
    """The measured window on ``perf_counter_ns``: ``t0`` (the first timed
    message) and ``t_end``, and the pipeline's batch count at each."""

    def __init__(self) -> None:
        self.t0 = self.t_end = None
        self.batches0 = self.batches1 = None
        self.published0 = self.published1 = None
        self.backlog: list[tuple[int, int]] = []
        self.stalled = False


def warm_shapes(pipe, log: MessageLog, rng: np.random.Generator,
                pub: int) -> None:
    """One batch of each padded size the step can take (64, 128, ... up to
    the pipeline's ``max_batch``), from publisher ``pub``, flushed."""
    size = 64
    seq = 0
    while size <= pipe.max_batch:
        for t in rng.integers(0, len(log.pool), size).tolist():
            now = time.perf_counter_ns()
            m = log.new(pub, seq, t, now)
            seq += 1
            log.submit[-1] = now
            pipe.submit(m)
        pipe.flush()
        size *= 2


def closed_loop(pipe, cm, log: MessageLog, mix: dict,
                seconds: float) -> Window:
    """``mix["publishers"]`` publishers with ``mix["inflight"]`` messages
    each outstanding; the window opens once ``warm_batches`` batches and
    ``warm_s`` seconds have passed, and closes ``seconds`` later; then
    no publisher sends again and the pipeline drains."""
    n_pub, depth = mix["publishers"], mix["inflight"]
    n_topics = len(log.pool)
    stride = max(1, n_topics // n_pub)
    next_seq = [0] * n_pub
    win = Window()
    state = {"stop": False, "batches": 0}
    t_start = time.perf_counter_ns()
    warm_ns = int(mix["warm_s"] * 1e9)
    orig = cm.dispatch

    def send(p: int) -> None:
        k = next_seq[p]
        next_seq[p] = k + 1
        now = time.perf_counter_ns()
        m = log.new(p, k, (p * stride + k) % n_topics, now)
        log.submit[-1] = now
        pipe.submit(m)

    def dispatch(merged) -> None:
        orig(merged)
        now = time.perf_counter_ns()
        state["batches"] += 1
        if win.t0 is None:
            if (state["batches"] >= mix["warm_batches"]
                    and now - t_start >= warm_ns):
                win.t0 = now
                win.batches0, win.published0 = pipe.batches, pipe.published
        elif not state["stop"] and now - win.t0 >= seconds * 1e9:
            state["stop"] = True
            win.t_end = win.t0 + int(seconds * 1e9)
            win.batches1, win.published1 = pipe.batches, pipe.published
        if state["stop"]:
            return
        done = {id(m): m for items in merged.values() for _, m in items}
        for m in done.values():
            i = msg_index(m)
            if i < len(log.pub) and log.pub[i] < n_pub:
                send(log.pub[i])

    cm.dispatch = dispatch
    try:
        for _ in range(depth):
            for p in range(n_pub):
                send(p)
        # a flush returns once its queue ran dry, also where the last
        # dispatch queued the publishers' next messages: flush again
        while pipe.pending():
            pipe.flush()
    finally:
        cm.dispatch = orig
    if win.t_end is None:
        # every outstanding message went undelivered: the loop stalled, and
        # the comparison counts what is missing
        win.t0 = win.t0 or time.perf_counter_ns()
        win.t_end = win.t0 + int(seconds * 1e9)
        win.stalled = True
    return win


def arrivals(mix: dict, seconds: float, seed_rng: np.random.Generator
             ) -> np.ndarray:
    """Due offsets (ns from the loop's start) of an open loop at
    ``mix["rate"]`` messages a second over ``warm_s + seconds``: the gaps of
    a Poisson process at that rate, as the quantiles of the exponential
    law, so every seed has the same gaps, in an order drawn from the seed."""
    rate = float(mix["rate"])
    n = int(rate * (mix["warm_s"] + seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    seed_rng.shuffle(gaps)
    return (np.cumsum(gaps) * 1e9).astype(np.int64)


def open_loop(pipe, log: MessageLog, mix: dict, seconds: float,
              due: np.ndarray) -> Window:
    """Submit message ``i`` at ``start + due[i]`` from a generator thread
    (late ones at once), publisher ``i mod publishers``; the calling
    thread flushes the pipeline whenever messages are pending.  The window
    is ``[start + warm_s, start + warm_s + seconds)``; ``win.backlog``
    samples the pipeline's queue every 100 ms."""
    n_pub = mix["publishers"]
    n_topics = len(log.pool)
    win = Window()
    wake = threading.Event()
    done = threading.Event()
    backlog: list[tuple[int, int]] = []
    base = len(log)
    msgs = [log.new(i % n_pub, i // n_pub, i % n_topics, 0)
            for i in range(len(due))]
    # the messages made in advance are the generator's, not the system's
    # heap: out of the collector's sight, as the set-up is
    gc.freeze()
    start = time.perf_counter_ns() + 20_000_000
    for j in range(len(due)):
        log.due[base + j] = start + int(due[j])
    win.t0 = start + int(mix["warm_s"] * 1e9)
    win.t_end = win.t0 + int(seconds * 1e9)
    errors: list = []

    def generate() -> None:
        try:
            j, n = 0, len(msgs)
            next_probe = start
            while j < n:
                now = time.perf_counter_ns()
                while j < n and log.due[base + j] <= now:
                    log.submit[base + j] = now
                    msgs[j].timestamp = time.time_ns() // 1_000_000
                    pipe.submit(msgs[j])
                    j += 1
                wake.set()
                if now >= next_probe:
                    backlog.append((now, pipe.pending()))
                    next_probe = now + 100_000_000
                if j < n:
                    gap = log.due[base + j] - time.perf_counter_ns()
                    if gap > 0:
                        time.sleep(gap / 1e9)
        except BaseException as e:        # noqa: BLE001 — re-raised below
            errors.append(e)
            raise
        finally:
            done.set()
            wake.set()

    gen = threading.Thread(target=generate, name="bench-open-loop")
    gen.start()
    try:
        while True:
            if pipe.flush() == 0:
                if done.is_set() and pipe.pending() == 0:
                    break
                wake.wait(0.001)
                wake.clear()
    finally:
        gen.join()
    if errors:
        raise errors[0]
    win.backlog = backlog
    return win
