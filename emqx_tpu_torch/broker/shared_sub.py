"""Shared subscriptions (``$share/group/topic``) — parity with
``apps/emqx/src/emqx_shared_sub.erl``.

Group membership per (group, topic) with the reference's 7 dispatch
strategies (emqx_shared_sub.erl:78-85, :309-379):

- ``random``               uniform pick
- ``round_robin``          per-(group,topic) rotating cursor
- ``round_robin_per_group`` one cursor per group (all topics share it)
- ``sticky``               pin to one member until it leaves
- ``local``                prefer members on this node, else random
- ``hash_clientid``        publisher clientid hash
- ``hash_topic``           topic hash

QoS1/2 ack/redispatch (:190-217, :244-266): if the picked member nacks
(session window full / down), redispatch to another member not yet tried.
"""

from __future__ import annotations

import random
import threading
import zlib
from typing import Any, Optional

from emqx_tpu_torch.core.message import Message


class SharedSub:
    def __init__(self, node: str = "node1", strategy: str = "round_robin",
                 seed: Optional[int] = None):
        self.node = node
        self.strategy = strategy
        # (group, topic) -> [(sid, node)]
        self._members: dict[tuple[str, str], list[tuple[str, str]]] = {}
        # dispatch table: (group, topic) -> [members, sub_topic, rr_cursor]
        # — ONE dict lookup on the per-message hot path instead of three
        # (members, pre-formatted "$share/g/t", and the round-robin
        # cursor live in the same entry; members aliases _members[key])
        self._tab: dict[tuple[str, str], list] = {}
        self._rr_group: dict[str, int] = {}
        self._sticky: dict[tuple[str, str], tuple[str, str]] = {}
        self._rng = random.Random(seed)
        self._lock = threading.RLock()

    # -- membership --------------------------------------------------------

    def join(self, group: str, topic: str, sid: str,
             node: Optional[str] = None) -> None:
        with self._lock:
            key = (group, topic)
            members = self._members.setdefault(key, [])
            if key not in self._tab:
                self._tab[key] = [members, f"$share/{group}/{topic}", -1]
            entry = (sid, node or self.node)
            if entry not in members:
                members.append(entry)

    def leave(self, group: str, topic: str, sid: str,
              node: Optional[str] = None) -> None:
        with self._lock:
            key = (group, topic)
            members = self._members.get(key)
            if not members:
                return
            entry = (sid, node or self.node)
            if entry in members:
                members.remove(entry)
            if not members:
                self._members.pop(key, None)
                self._tab.pop(key, None)
                self._sticky.pop(key, None)
            elif self._sticky.get(key) == entry:
                self._sticky.pop(key, None)

    def _purge(self, dead) -> None:
        """Drop members matching ``dead((sid, node))`` from every group."""
        with self._lock:
            for key in list(self._members):
                members = self._members[key]
                members[:] = [m for m in members if not dead(m)]
                if not members:
                    self._members.pop(key, None)
                    self._tab.pop(key, None)
                    self._sticky.pop(key, None)
                elif (sticky := self._sticky.get(key)) and dead(sticky):
                    self._sticky.pop(key, None)

    def member_down(self, sid: str) -> None:
        """Clean a dead subscriber out of every group, any node
        (emqx_shared_sub.erl:456-519)."""
        self._purge(lambda m: m[0] == sid)

    def groups_for(self, topic: str) -> list[str]:
        with self._lock:
            return [g for (g, t) in self._members if t == topic]

    def members(self) -> dict[tuple[str, str], list[tuple[str, str]]]:
        """{(group, topic): [(sid, node)]} snapshot (cluster bootstrap)."""
        with self._lock:
            return {k: list(v) for k, v in self._members.items()}

    def node_down(self, node: str) -> None:
        """Purge every member hosted on a dead node
        (emqx_shared_sub node-down sweep)."""
        self._purge(lambda m: m[1] == node)

    # -- dispatch ----------------------------------------------------------

    def pick(self, group: str, topic: str, msg: Message,
             exclude: Optional[set] = None) -> Optional[tuple[str, str]]:
        """Pick one member (sid, node) per the strategy; ``exclude`` is the
        already-nacked set during redispatch."""
        with self._lock:
            key = (group, topic)
            members = self._members.get(key)
            if exclude and members:
                # redispatch path only: the common no-exclusion pick
                # must not copy the member list per message
                members = [m for m in members if m not in exclude]
            if not members:
                return None
            s = self.strategy
            if s == "sticky":
                cur = self._sticky.get(key)
                if cur in members:
                    return cur
                choice = self._rng.choice(members)
                self._sticky[key] = choice
                return choice
            if s == "round_robin":
                ent = self._tab[key]
                i = ent[2] + 1
                ent[2] = i
                return members[i % len(members)]
            if s == "round_robin_per_group":
                i = self._rr_group.get(group, -1) + 1
                self._rr_group[group] = i
                return members[i % len(members)]
            if s == "local":
                local = [m for m in members if m[1] == self.node]
                return self._rng.choice(local or members)
            # deterministic hash (erlang:phash2 analogue): Python's hash()
            # is salted per process and would repick after restarts/nodes
            if s == "hash_clientid":
                return members[zlib.crc32(msg.from_.encode()) % len(members)]
            if s == "hash_topic":
                return members[zlib.crc32(msg.topic.encode()) % len(members)]
            return self._rng.choice(members)   # random

    def dispatch(self, group: str, topic: str, msg: Message,
                 deliver_fn=None) -> list[tuple[str, str, str]]:
        """Broker-facing dispatch: pick a member; with ``deliver_fn``
        ((sid, node) → bool ack) retry un-acked members (QoS>0 redispatch
        semantics). Returns [(sid, node, sub_topic)] that accepted."""
        tried: Optional[set] = None      # allocated only on redispatch
        while True:
            member = self.pick(group, topic, msg, exclude=tried)
            if member is None:
                return []
            sid, node = member
            ent = self._tab.get((group, topic))
            sub_topic = ent[1] if ent else f"$share/{group}/{topic}"
            if deliver_fn is None or msg.qos == 0:
                return [(sid, node, sub_topic)]
            if deliver_fn(sid, node):
                return [(sid, node, sub_topic)]
            if tried is None:
                tried = set()
            tried.add(member)
            if self.strategy == "sticky":
                # nacked: unpin so the next pick rotates
                self._sticky.pop((group, topic), None)

    def dispatch_batch(self, legs, deliver_fn=None) -> list:
        """Batched strategy picks: one lock hold and an
        inlined cursor walk for a whole publish batch's shared legs,
        instead of a pick() call (lock + strategy branch + dict walks)
        per message. ``legs`` is ``[(group, topic, msg)]``; returns one
        ``(sid, node, sub_topic) | None`` per leg, order-preserving.
        Strategies other than the rotating/hash families — and every
        ack/redispatch (deliver_fn) path — fall back to ``dispatch``
        per leg, so the semantics match the single-message API
        (emqx_shared_sub.erl:138-157 strategy table)."""
        s = self.strategy
        if s not in ("round_robin", "round_robin_per_group",
                     "hash_clientid", "hash_topic") or (
                deliver_fn is not None and s != "round_robin"):
            return [
                (d[0] if (d := self.dispatch(g, t, m,
                                             deliver_fn=deliver_fn))
                 else None)
                for g, t, m in legs
            ]
        out = []
        append = out.append
        # QoS>0 legs whose pick must survive a deliver_fn verdict; the
        # callback runs AFTER the lock is released. dispatch() already
        # keeps deliver_fn outside its hold, and a batch must match: an
        # arbitrary callback (it may re-enter SharedSub, block on a
        # session, or just be slow) must not extend the table hold
        # across the whole batch and starve concurrent join/leave
        pending: list = []
        with self._lock:
            tab_get = self._tab.get
            if s == "round_robin":
                for group, topic, msg in legs:
                    ent = tab_get((group, topic))
                    if ent is None or not ent[0]:
                        append(None)
                        continue
                    members = ent[0]
                    i = ent[2] + 1
                    ent[2] = i
                    m = members[i % len(members)]
                    if deliver_fn is not None and msg.qos:
                        pending.append((len(out), group, topic, msg, m))
                    append((m[0], m[1], ent[1]))
            elif s == "round_robin_per_group":
                rrg = self._rr_group
                for group, topic, msg in legs:
                    ent = tab_get((group, topic))
                    if ent is None or not ent[0]:
                        append(None)
                        continue
                    members = ent[0]
                    i = rrg.get(group, -1) + 1
                    rrg[group] = i
                    m = members[i % len(members)]
                    append((m[0], m[1], ent[1]))
            else:                        # hash_clientid / hash_topic
                by_client = s == "hash_clientid"
                for group, topic, msg in legs:
                    ent = tab_get((group, topic))
                    if ent is None or not ent[0]:
                        append(None)
                        continue
                    members = ent[0]
                    word = msg.from_ if by_client else msg.topic
                    m = members[zlib.crc32(word.encode()) % len(members)]
                    append((m[0], m[1], ent[1]))
        # outside the lock: confirm QoS>0 picks; a nack falls back to the
        # single-leg dispatch(), whose rotate-past-nacked retry loop
        # already interleaves pick() and deliver_fn without holding the
        # table lock (the cursor advance above keeps rotation fair)
        for idx, group, topic, msg, m in pending:
            if deliver_fn(m[0], m[1]):
                continue
            d = self.dispatch(group, topic, msg, deliver_fn=deliver_fn)
            out[idx] = d[0] if d else None
        return out
