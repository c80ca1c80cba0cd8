"""Route table + match_routes — parity with ``apps/emqx/src/emqx_router.erl``.

- routes: topic-filter → set of destinations (the ``emqx_route`` bag table,
  emqx_router.erl:78-92). A destination is a node name, ``(group, node)``
  for shared subs, or a session id.
- only wildcard filters enter the trie (emqx_trie.erl:262-264); exact-topic
  routes are matched by direct dict lookup (emqx_router.erl:141-153).
- add/delete are serialized per topic in the reference via a pool worker
  picked by topic hash (emqx_router.erl:200-204); here a single lock guards
  the table + trie + delta log so the same ordering discipline holds.
- every mutation appends to a **delta log** consumed by (a) the device-index
  incremental refresher and (b) cluster replication (the mria-rlog analogue,
  the route-replication log).
- once the owning broker names its node (``set_home``), the routes whose
  destination is not that node — ``(group, node)`` shared dests, other
  nodes, any other dest — are also indexed apart (the *away index*), so
  the broker's walk for shared and remote legs after a device step covers
  only them (``match_away_routes``); on one node without ``$share`` it is
  empty.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional

from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Route
from emqx_tpu_torch.router.trie import Trie


@dataclass(frozen=True)
class RouteDelta:
    seq: int
    op: str            # "add" | "del"
    topic: str
    dest: Any
    filter_new: bool   # first route for this filter / last route removed


class Router:
    """Node-local replica of the cluster route table."""

    def __init__(self) -> None:
        self._routes: dict[str, set[Any]] = {}
        self._trie = Trie()
        self._lock = threading.RLock()
        self._seq = 0
        self._base_seq = 0
        self._log: list[RouteDelta] = []
        # the away index (set_home): topic -> how many of its dests are
        # not home, and the trie of those topics that are wildcards.  The
        # dests themselves are read from _routes, so the away matches come
        # in match_routes' order
        self._home: Any = None
        self._away: dict[str, int] = {}
        self._away_trie = Trie()
        self._n_away = 0
        # route observers: fn(op, topic, dest) with op in {"add","del"},
        # fired UNDER the router lock so callbacks see table order —
        # an add/del pair for the same route delivered out of order
        # would permanently desync a mirror. Observers must be quick
        # and must not call back into the Router. The native host
        # mirrors REMOTE routes as punt markers through this seam so
        # its fast path stays complete on a clustered node
        # (broker/native_server.py)
        self.route_observers: list = []

    # -- mutation (emqx_router:do_add_route/2 :123-138) ---------------------

    def add_route(self, topic: str, dest: Any = "local") -> bool:
        if not T.validate_filter(topic):
            # channel/session reject invalid filters before routing; this
            # guard keeps the trie consistent with the match oracle even
            # for direct API users
            raise ValueError(f"invalid topic filter: {topic!r}")
        with self._lock:
            dests = self._routes.setdefault(topic, set())
            if dest in dests:
                return False
            dests.add(dest)
            filter_new = False
            if T.wildcard(topic):
                filter_new = self._trie.insert(topic)
            if self._home is not None and dest != self._home:
                self._away_add(topic)
            self._append("add", topic, dest, filter_new)
            for obs in self.route_observers:
                obs("add", topic, dest)
            return True

    def delete_route(self, topic: str, dest: Any = "local") -> bool:
        with self._lock:
            dests = self._routes.get(topic)
            if dests is None or dest not in dests:
                return False
            dests.discard(dest)
            if not dests:
                del self._routes[topic]
            filter_gone = False
            if T.wildcard(topic):
                filter_gone = self._trie.delete(topic)
            if self._home is not None and dest != self._home:
                self._away_del(topic)
            self._append("del", topic, dest, filter_gone)
            for obs in self.route_observers:
                obs("del", topic, dest)
            return True

    def _away_add(self, topic: str) -> None:
        n = self._away.get(topic, 0)
        self._away[topic] = n + 1
        self._n_away += 1
        if n == 0 and T.wildcard(topic):
            self._away_trie.insert(topic)

    def _away_del(self, topic: str) -> None:
        n = self._away[topic] - 1
        self._n_away -= 1
        if n:
            self._away[topic] = n
            return
        del self._away[topic]
        if T.wildcard(topic):
            self._away_trie.delete(topic)

    def _append(self, op: str, topic: str, dest: Any, fnew: bool) -> None:
        self._seq += 1
        self._log.append(RouteDelta(self._seq, op, topic, dest, fnew))

    # -- read path (emqx_router:match_routes/1 :141-153) --------------------

    def match_routes(self, topic: str) -> list[Route]:
        with self._lock:
            out: list[Route] = []
            for dest in self._routes.get(topic, ()):
                out.append(Route(topic, dest))
            for filt in self._trie.match(topic):
                for dest in self._routes.get(filt, ()):
                    out.append(Route(filt, dest))
            return out

    def match_away_routes(self, topic: str) -> list[Route]:
        """``match_routes(topic)`` without the routes whose dest is home,
        in the same order; with no home, ``match_routes(topic)``."""
        with self._lock:
            home = self._home
            if home is None:
                return self.match_routes(topic)
            out: list[Route] = []
            if topic in self._away:
                for dest in self._routes[topic]:
                    if dest != home:
                        out.append(Route(topic, dest))
            if self._away_trie.is_empty():
                return out
            for filt in self._away_trie.match(topic):
                for dest in self._routes[filt]:
                    if dest != home:
                        out.append(Route(filt, dest))
            return out

    @property
    def home(self) -> Any:
        """The dest the away index leaves out (the owning node), or None."""
        with self._lock:
            return self._home

    @property
    def away_count(self) -> int:
        """Routes in the away index: those whose dest is not home."""
        with self._lock:
            return self._n_away

    def set_home(self, dest: Any) -> None:
        """Name the dest that is this node's own and build the away index
        from the table; a home once set does not change."""
        with self._lock:
            if self._home is not None:
                if self._home != dest:
                    raise ValueError(
                        f"router home is {self._home!r}, not {dest!r}")
                return
            self._home = dest
            for topic, dests in self._routes.items():
                for d in dests:
                    if d != dest:
                        self._away_add(topic)

    def lookup_routes(self, topic: str) -> list[Route]:
        with self._lock:
            return [Route(topic, d) for d in self._routes.get(topic, ())]

    def has_route(self, topic: str, dest: Any) -> bool:
        with self._lock:
            return dest in self._routes.get(topic, ())

    def dump(self) -> list[tuple[str, Any]]:
        """All (topic, dest) pairs — route-observer bootstrap snapshot."""
        with self._lock:
            return [(t, d) for t, ds in self._routes.items() for d in ds]

    def topics(self) -> list[str]:
        with self._lock:
            return list(self._routes)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "routes.count": sum(len(d) for d in self._routes.values()),
                "topics.count": len(self._routes),
                "filters.count": len(self._trie),
            }

    # -- node-down purge (emqx_router_helper semantics) ----------------------

    def cleanup_dest(self, dest: Any) -> int:
        """Purge every route pointing at ``dest`` (dead node/session)."""
        with self._lock:
            victims = [t for t, ds in self._routes.items() if dest in ds]
            for t in victims:
                self.delete_route(t, dest)
            return len(victims)

    # -- delta log (device refresh + replication) ----------------------------

    def deltas_since(self, seq: int) -> Optional[list[RouteDelta]]:
        """Deltas after ``seq``; None if that prefix was trimmed away
        (consumer must full-resync — mria replicant bootstrap analogue)."""
        with self._lock:
            if seq < self._base_seq or seq > self._seq:
                # prefix trimmed away, or consumer is ahead of us (we
                # restarted fresh): either way its state is unreachable
                # from this log — full resync required
                return None
            if not self._log or seq >= self._log[-1].seq:
                return []
            # log is append-only with dense seqs; _base_seq = seq of the
            # entry preceding _log[0]
            return self._log[seq - self._base_seq:]

    def trim_log(self, upto_seq: int) -> None:
        """Drop deltas ≤ upto_seq once every consumer has applied them."""
        with self._lock:
            upto = min(upto_seq, self._seq)
            if upto <= self._base_seq:
                return
            del self._log[: upto - self._base_seq]
            self._base_seq = upto

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def snapshot_filters(self) -> list[tuple[str, int]]:
        """(filter, refcount) snapshot taken under the router lock — the
        device-index builder's input (never hand out the live trie)."""
        with self._lock:
            return list(self._trie.filters())

    def match_filters(self, topic: str) -> list[str]:
        """Wildcard filters matching ``topic`` (host-oracle path)."""
        with self._lock:
            return self._trie.match(topic)
