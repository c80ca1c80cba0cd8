"""The port router's away index: the routes whose dest is not the router's
home (its node), kept beside the route table so that the broker's walk for
shared and remote legs after a device step covers only them.

Seeded interleavings of ``add_route`` / ``delete_route`` / ``cleanup_dest``
over home routes, ``(group, node)`` shared dests, other nodes' names, a
session id and the default ``"local"`` dest, on filters with ``+`` and
``#`` and topics under ``$SYS``.  After every step, for every topic of a
small tree, ``match_away_routes`` is ``match_routes`` without the home
routes, in the same order, and ``away_count`` counts those routes.  A twin
router with no home, driven through the same steps, gives the same delta
log, route observer events, stats, dump and matches: the index changes
nothing the table already served."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from emqx_tpu_torch.router.router import Router

HOME = "n1"
DESTS = [HOME, ("g1", HOME), ("g2", "n2"), ("g1", "n3"), "n2", "n3",
         "local", "sess-7"]
WORDS = ["a", "b", "c"]
# every topic name of up to three levels over WORDS, and under $SYS
TOPICS = ["/".join(ws) for n in (1, 2, 3)
          for ws in itertools.product(WORDS, repeat=n)]
TOPICS += ["$SYS/" + t for t in TOPICS if t.count("/") < 2] + ["$SYS"]


def filters(rng, n: int) -> list[str]:
    """``n`` seeded filters over WORDS: ``+`` levels, a trailing ``#``, a
    bare ``#`` and ``+``, and some rooted at ``$SYS``."""
    out = ["#", "+", "$SYS/#", "+/#"]
    while len(out) < n:
        ws = [str(w) for w in rng.choice(WORDS + ["+"],
                                         int(rng.integers(1, 4)))]
        if rng.random() < 0.15:
            ws[0] = "$SYS"
        if rng.random() < 0.3:
            ws.append("#")
        out.append("/".join(ws))
    return out


def check(r: Router, twin: Router) -> None:
    home = r.home
    n_away = 0
    for t in TOPICS:
        full = r.match_routes(t)
        assert full == twin.match_routes(t), t
        want = full if home is None else [x for x in full if x.dest != home]
        assert r.match_away_routes(t) == want, t
    for _t, d in r.dump():
        n_away += d != home
    if home is not None:
        assert r.away_count == n_away
    assert r.stats() == twin.stats()
    assert sorted(r.dump(), key=repr) == sorted(twin.dump(), key=repr)
    assert r.deltas_since(0) == twin.deltas_since(0)


# name: (when the home is set: "first", at a step of the run, or never)
SHAPES = {"home_first": 0, "home_midway": 60, "no_home": None}
SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_away_routes_are_match_routes_without_home(shape, seed):
    rng = np.random.default_rng(4000 + 17 * seed
                                + list(SHAPES).index(shape))
    home_at = SHAPES[shape]
    r, twin = Router(), Router()
    events, twin_events = [], []
    r.route_observers.append(lambda *e: events.append(e))
    twin.route_observers.append(lambda *e: twin_events.append(e))
    assert r.home is None
    pool = filters(rng, 14)
    held: list = []           # routes added, so deletes and re-adds hit
    for step in range(120):
        if step == home_at:
            r.set_home(HOME)
            r.set_home(HOME)              # the same home again: no change
            assert r.home == HOME
        op = rng.random()
        if op < 0.55 or not held:
            topic = pool[int(rng.integers(len(pool)))]
            dest = DESTS[int(rng.integers(len(DESTS)))]
            got = r.add_route(topic, dest)
            assert got == twin.add_route(topic, dest)
            if got:
                held.append((topic, dest))
        elif op < 0.93:
            topic, dest = held.pop(int(rng.integers(len(held))))
            assert r.delete_route(topic, dest)
            assert twin.delete_route(topic, dest)
            if rng.random() < 0.3:        # re-add the route just deleted
                assert r.add_route(topic, dest)
                assert twin.add_route(topic, dest)
                held.append((topic, dest))
        else:
            dest = DESTS[int(rng.integers(len(DESTS)))]
            assert r.cleanup_dest(dest) == twin.cleanup_dest(dest)
            held = [h for h in held if h[1] != dest]
        check(r, twin)
    assert events == twin_events
    if home_at is None:
        assert r.home is None
        r.set_home("n2")                  # a home over a full table
        check(r, twin)
        assert r.home == "n2"
    with pytest.raises(ValueError):
        r.set_home("n9")
    # emptied, the away index holds nothing
    for topic, dest in list(r.dump()):
        r.delete_route(topic, dest)
        twin.delete_route(topic, dest)
    check(r, twin)
    assert r.away_count == 0 and r._away == {} and r._away_trie.is_empty()
