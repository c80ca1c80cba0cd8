"""The plain reference router: which subscriptions an MQTT 5.0 broker
must deliver a published topic to (MQTT 5.0 section 4.7).

A trie of nested dicts keyed by topic level, built from the subscription
list alone; a walk follows, at each level, the level's own word and
``+``, and takes a ``#`` child as matching the rest of the topic and its
parent level.  A topic whose first level starts with ``$`` is not matched
by a filter that starts with a wildcard.  Each matching ``(session,
filter)`` subscription gets one delivery; a session that subscribed one
filter twice holds one subscription.  Plain Python; it imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import Iterable

_END = None          # the key under which a node keeps the filter ending there


class ReferenceRouter:
    def __init__(self, table: Iterable[tuple]) -> None:
        """``table``: ``(session id, filter)`` pairs."""
        self.root: dict = {}
        self.holders: dict[str, set] = {}
        for sid, filt in table:
            held = self.holders.get(filt)
            if held is None:
                held = self.holders[filt] = set()
                node = self.root
                for w in filt.split("/"):
                    nxt = node.get(w)
                    if nxt is None:
                        nxt = node[w] = {}
                    node = nxt
                node[_END] = filt
            held.add(sid)

    def walk(self, topic: str) -> tuple[list[str], int]:
        """The filters matching ``topic``, and the trie edges the walk
        followed to find them (each child entered: a level's word, ``+``
        or ``#``)."""
        words = topic.split("/")
        sys_topic = words[0].startswith("$")
        out: list[str] = []
        edges = 0
        frontier = [self.root]
        for i, w in enumerate(words):
            nxt = []
            wild = not (i == 0 and sys_topic)
            for node in frontier:
                if wild:
                    h = node.get("#")
                    if h is not None:
                        edges += 1
                        out.append(h[_END])
                    p = node.get("+")
                    if p is not None:
                        edges += 1
                        nxt.append(p)
                c = node.get(w)
                if c is not None:
                    edges += 1
                    nxt.append(c)
            frontier = nxt
        for node in frontier:
            f = node.get(_END)
            if f is not None:
                out.append(f)
            h = node.get("#")
            if h is not None:
                edges += 1
                out.append(h[_END])
        return out, edges

    def match(self, topic: str) -> list[str]:
        return self.walk(topic)[0]

    def deliveries(self, topic: str) -> set[tuple[str, str]]:
        """``{(session id, filter)}``: one delivery per subscription that
        matches ``topic``."""
        return {(sid, f) for f in self.match(topic)
                for sid in self.holders[f]}
