"""The vehicle-fleet generators: the subscription table and the topics
published into it, seeded.

``build_filters`` and ``make_topics`` are copies of ``chip_smoke.py``'s
(which follow ``bench.py`` and EMQX 5.0.14 ``emqx_broker_bench.erl``
``run1/4``), kept here so that a change to the program's own smoke test
cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np


# copied from chip_smoke.py build_filters
def build_filters(n: int, rng: np.random.Generator) -> list[str]:
    """Vehicle-fleet topic tree, 7 levels deep, ~10% '+' wildcards, a few
    percent '#' (bench.py build_filters)."""
    n_vehicles = max(1000, n // 2)
    kinds = rng.random(n)
    vids = rng.integers(0, n_vehicles, n)
    fleets = rng.integers(0, 512, n)
    metrics = rng.integers(0, 16, n)
    parts = rng.integers(0, 8, n)
    out = []
    for k, v, fl, m, p in zip(kinds.tolist(), vids.tolist(), fleets.tolist(),
                              metrics.tolist(), parts.tolist()):
        if k < 0.80:
            out.append(f"fleet/f{fl}/vehicle/v{v}/part/p{p}/m{m}")
        elif k < 0.90:
            out.append(f"fleet/f{fl}/vehicle/+/part/p{p}/m{m}")
        elif k < 0.95:
            out.append(f"fleet/f{fl}/vehicle/v{v}/part/+/m{m}")
        elif k < 0.98:
            out.append(f"fleet/f{fl}/vehicle/v{v}/#")
        else:
            out.append(f"fleet/+/vehicle/v{v}/part/p{p}/#")
    return out


# copied from chip_smoke.py make_topics
def make_topics(live: list[str], rng: np.random.Generator, count: int,
                n_vehicles: int) -> list[str]:
    """Publish into the subscribed tree: a random subscribed filter with
    its wildcards instantiated (bench.py make_topics)."""
    picks = rng.integers(0, len(live), count)
    v = rng.integers(0, n_vehicles, count)
    p = rng.integers(0, 8, count)
    m = rng.integers(0, 16, count)
    fl = rng.integers(0, 512, count)
    topics = []
    for i in range(count):
        out = []
        for j, w in enumerate(live[picks[i]].split("/")):
            if w == "+":
                out.append(f"v{v[i]}" if j == 3 else
                           f"p{p[i]}" if j == 5 else f"f{fl[i]}")
            elif w == "#":
                out.extend([f"part/p{p[i]}", f"m{m[i]}"][: 7 - j])
                break
            else:
                out.append(w)
        topics.append("/".join(out))
    return topics


def subscriptions(conf: dict, rng: np.random.Generator) -> list[tuple]:
    """The configuration's table: ``(session id, filter)`` for each of its
    subscriptions, the filters those of ``build_filters`` and their owners
    drawn uniformly from the sessions (as ``chip_smoke.serving_load``)."""
    n, sessions = conf["subscriptions"], conf["sessions"]
    filters = build_filters(n, rng)
    owners = rng.integers(0, sessions, n).tolist()
    return [(f"c{s}", f) for s, f in zip(owners, filters)]


def overlay(mix: dict, conf: dict, rng: np.random.Generator) -> list[tuple]:
    """The mix's extra subscriptions: each of its broadcast filters held
    by ``sessions_each`` distinct sessions of the table."""
    out = []
    spec = mix.get("broadcast")
    if not spec:
        return out
    for f in spec["filters"]:
        for s in rng.choice(conf["sessions"], spec["sessions_each"],
                            replace=False).tolist():
            out.append((f"c{s}", f))
    return out


def topic_pool(table: list[tuple], conf: dict, mix: dict,
               rng: np.random.Generator) -> list[str]:
    """``mix["topic_pool"]`` topics, each a random distinct subscribed
    filter of the table with its wildcards filled in."""
    live = list(dict.fromkeys(f for _, f in table))
    return make_topics(live, rng, mix["topic_pool"],
                       max(1000, conf["subscriptions"] // 2))
