"""Host-side wildcard-filter trie: the correctness oracle.

Semantic parity with ``apps/emqx/src/emqx_trie.erl`` (insert/1 :113-127,
match/1 :146-169/:282-344, delete/1 :129-144): only *wildcard* filters are
stored (``emqx_trie.erl:262-264``); edges/terminals are refcounted so
concurrent subscribe/unsubscribe of the same filter compose; match walks
topic words branching on ``+`` and probing a ``#`` terminal at every level;
topics whose first level starts with ``$`` skip root wildcards.

The reference compacts multi-word prefixes into single ETS keys to shrink
ETS lookups (``emqx_trie.erl:199-233``); that is a BEAM-storage optimisation
— our equivalent packing lives in the *device* index builder
(``router/index.py``), so the host oracle stays a plain pointer trie.

This structure is also the mutation source of truth: the device index is
(re)built/delta-patched from it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

from emqx_tpu_torch.core import topic as T


@dataclass
class _Node:
    children: dict[str, "_Node"] = field(default_factory=dict)
    # refcount of filters terminating exactly at this node
    term_count: int = 0
    # full filter string for terminals (host-side convenience)
    filter: Optional[str] = None


class Trie:
    """Refcounted wildcard-filter trie with MQTT match semantics."""

    def __init__(self) -> None:
        self._root = _Node()
        self._count = 0  # distinct filters stored

    def __len__(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    # -- mutation ----------------------------------------------------------

    def insert(self, filt: str) -> bool:
        """Insert one refcount of ``filt``. True if the filter is new."""
        node = self._root
        for w in T.words(filt):
            node = node.children.setdefault(w, _Node())
        node.term_count += 1
        if node.term_count == 1:
            node.filter = filt
            self._count += 1
            return True
        return False

    def delete(self, filt: str) -> bool:
        """Drop one refcount of ``filt``. True if the filter is now gone."""
        path: list[tuple[_Node, str]] = []
        node = self._root
        for w in T.words(filt):
            child = node.children.get(w)
            if child is None:
                return False
            path.append((node, w))
            node = child
        if node.term_count == 0:
            return False
        node.term_count -= 1
        if node.term_count > 0:
            return False
        node.filter = None
        self._count -= 1
        # prune now-empty nodes bottom-up
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.term_count == 0 and not child.children:
                del parent.children[w]
            else:
                break
        return True

    # -- match -------------------------------------------------------------

    def match(self, topic: str) -> list[str]:
        """All stored filters matching publish-topic ``topic``.

        Iterative frontier walk (no recursion: filters may legally have
        thousands of levels). The frontier at level *i* is the set of trie
        nodes whose path matches ``ws[:i]`` — the same shape the device
        kernel uses, so this doubles as its semantic oracle.
        """
        ws = T.words(topic)
        out: list[str] = []
        sys_root = T.is_sys(ws)
        frontier = [self._root]
        for i, w in enumerate(ws):
            nxt: list[_Node] = []
            for node in frontier:
                hash_child = node.children.get(T.HASH)
                if hash_child is not None and not (sys_root and i == 0):
                    # '#' child matches the remainder (incl. zero levels)
                    if hash_child.term_count > 0:
                        out.append(hash_child.filter)
                # a literal '#' topic word (illegal in validated names) must
                # not descend into the '#' terminal — it already matched via
                # hash_child above; descending would emit the filter twice
                exact = node.children.get(w) if w != T.HASH else None
                if exact is not None:
                    nxt.append(exact)
                # w == '+' (legal only in not-yet-validated names) would make
                # exact and plus the same node — don't double-count it
                if w != T.PLUS and not (sys_root and i == 0):
                    plus = node.children.get(T.PLUS)
                    if plus is not None:
                        nxt.append(plus)
            frontier = nxt
            if not frontier:
                break
        for node in frontier:
            if node.term_count > 0:
                out.append(node.filter)
            hash_child = node.children.get(T.HASH)
            if hash_child is not None and hash_child.term_count > 0:
                out.append(hash_child.filter)
        return out

    # -- introspection (device-index builder input) ------------------------

    def filters(self) -> Iterator[tuple[str, int]]:
        """Yield (filter, refcount) for all stored filters."""
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.term_count > 0:
                yield node.filter, node.term_count
            stack.extend(node.children.values())
