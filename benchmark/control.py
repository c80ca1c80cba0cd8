"""The control of the comparison that decides ``correct``: the reference
router put in the program's place with one of the configuration's
guarantees broken, run through the same loop, recording channels and
comparison as a cell's run.  The comparison must find it not correct.

The guarantee broken is "every subscription whose filter matches the topic
gets the message": the control takes an exact-topic fast path, and a topic
that some session subscribed to by name goes to those sessions alone, its
wildcard subscribers skipped.  A shortcut of that kind is what an
optimisation of the routing could be tempted into.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \\
        --seconds <s>

prints each seed's compared numbers and exits 0 when the comparison failed
the control on every seed, 1 otherwise.  The benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference.router import ReferenceRouter  # noqa: E402
from benchmark.system import System  # noqa: E402


class FastPathRouter(ReferenceRouter):
    """The reference with the exact-topic fast path."""

    def deliveries(self, topic: str) -> set[tuple[str, str]]:
        held = self.holders.get(topic)
        if held:
            return {(sid, topic) for sid in held}
        return super().deliveries(topic)


class ControlBroker:
    def __init__(self) -> None:
        self.table: list[tuple[str, str]] = []

    def subscribe(self, sid: str, filt: str) -> None:
        self.table.append((sid, filt))


class ControlCM:
    def __init__(self) -> None:
        self.channels: dict = {}

    def register_channel(self, sid: str, channel) -> None:
        self.channels[sid] = channel

    def dispatch(self, deliveries: dict) -> None:
        for sid, items in deliveries.items():
            ch = self.channels.get(sid)
            if ch is not None:
                ch.send(ch.handle_deliver(items))


class ControlPipeline:
    """``submit`` / ``flush`` as the program's pipeline offers them: batches
    of at most ``max_batch`` in submission order, each routed by the
    control router and dispatched through the CM."""

    def __init__(self, broker: ControlBroker, cm: ControlCM,
                 max_batch: int) -> None:
        self.broker, self.cm, self.max_batch = broker, cm, max_batch
        self.router = None
        self._q: deque = deque()
        self.batches = self.published = 0

    def submit(self, msg) -> None:
        self._q.append(msg)

    def pending(self) -> int:
        return len(self._q)

    def flush(self) -> int:
        if self.router is None:
            self.router = FastPathRouter(self.broker.table)
        total = 0
        while self._q:
            batch = [self._q.popleft()
                     for _ in range(min(len(self._q), self.max_batch))]
            merged: dict = {}
            for m in batch:
                for sid, f in sorted(self.router.deliveries(m.topic)):
                    merged.setdefault(sid, []).append((f, m))
            self.batches += 1
            self.published += len(batch)
            total += len(batch)
            self.cm.dispatch(merged)
        return total


def build(conf: dict, device: str, data_dir: str) -> System:
    broker, cm = ControlBroker(), ControlCM()
    pipe = ControlPipeline(broker, cm,
                           int(conf["router_device"]["batch_max"]))
    return System(broker, cm, pipe, None, None)


def run(workload: str, seed: int, seconds: float, root=ROOT) -> dict:
    return harness.run(workload, seed, seconds, False, device="cpu",
                       root=root, build=build)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    failed_all = True
    for seed in a.seeds:
        out = run(a.workload, seed, a.seconds)
        failed_all &= not out["correct"]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "compared": out["compared"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
