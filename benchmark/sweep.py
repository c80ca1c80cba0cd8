"""The knee sweep of an open-loop cell: one set-up, then the cell's open
loop at each rate given, one after another, and for each rate the
backlog at the start and the end of its window and the 95th percentile of
its publish latency (due to last delivery).  The knee is the highest rate
whose backlog stays flat; the cell runs at about four fifths of it, a
number written into its traffic file.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --rates <r> [<r> ...]

prints one JSON line a rate.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import drive, harness  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402
from benchmark.yardstick import nearest_rank  # noqa: E402


def completions(channels: dict, since: dict) -> dict:
    """``{message index: stamp of its last delivery}`` over what each
    channel received after its entry ``since[sid]`` (advanced)."""
    done: dict[int, int] = {}
    for sid, ch in channels.items():
        flat = ch.log
        for j in range(since.get(sid, 0), len(flat), 4):
            i = int.from_bytes(flat[j + 2][:8], "little")
            if done.get(i, 0) < flat[j]:
                done[i] = flat[j]
        since[sid] = len(flat)
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    man = Manifest()
    cell = man.cell(a.workload)
    conf = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    rng = harness.seeds(a.seed)
    with tempfile.TemporaryDirectory(prefix="bench_data_") as data_dir:
        pre = harness.prepare(conf, mix, man.generator(conf["generator"]),
                              rng, "cuda", data_dir)
        since: dict = {}
        completions(pre.channels, since)
        gc.collect()
        gc.freeze()
        for rate in a.rates:
            m = dict(mix, rate=rate)
            due = drive.arrivals(m, a.seconds, rng["arrivals"])
            base = len(pre.log)
            t = time.perf_counter()
            win = drive.open_loop(pre.sut.pipe, pre.log, m, a.seconds, due)
            wall = time.perf_counter() - t
            done = completions(pre.channels, since)
            lat = [(done[i] - pre.log.due[i]) / 1e6 if i in done else math.inf
                   for i in range(base, len(pre.log))
                   if win.t0 <= pre.log.due[i] < win.t_end]
            inside = [q for t_, q in win.backlog if win.t0 <= t_ < win.t_end]
            print(json.dumps({
                "rate": rate, "messages": len(pre.log) - base,
                "window_s": a.seconds, "wall_s": round(wall, 3),
                "backlog_start": inside[0] if inside else None,
                "backlog_end": inside[-1] if inside else None,
                "backlog_max": max(inside) if inside else None,
                "p50_ms": nearest_rank(lat, 0.5),
                "p95_ms": nearest_rank(lat, 0.95),
                "p99_ms": nearest_rank(lat, 0.99)}), flush=True)
        gc.unfreeze()
    return 0


if __name__ == "__main__":
    sys.exit(main())
