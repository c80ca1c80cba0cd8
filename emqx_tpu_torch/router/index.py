"""TrieIndex — the level-packed, device-resident form of the wildcard trie.

The port's own copy of the JAX package's ``router/index.py``: the flat
trie builder and the subscription-sharded ``ShardedTrieIndex``.  The
hashes, the array layout and the shard assignment are the contract
between the host builder and the device walk, so they stay bit-identical
to the reference — parity tests hold them to it.

This is the accelerator answer to ``emqx_trie.erl``'s ETS ordered_set walk
(emqx_trie.erl:282-344): instead of one ETS lookup per topic level per
message, the whole trie lives in device memory as flat int32 arrays and a
*batch* of topics is matched per kernel launch
(``emqx_tpu_torch.ops.trie_match``).

Layout
------
Nodes are integer ids (root = 0). Per node:

- ``plus_child[n]``  child via a ``+`` edge, -1 if none
- ``hash_fid[n]``    filter id of the ``prefix/#`` filter hanging under n
                     (``#`` is always terminal, so the '#' child is folded
                     into its parent as a filter id), -1 if none
- ``node_fid[n]``    filter id of a filter ending exactly at n, -1 if none

Exact (non-wildcard) edges live in one open-addressed hash table keyed by
``(parent_node, word_id)``:

- ``ht_parent[s] / ht_word[s] / ht_child[s]`` with -1 marking empty slots;
  linear probing, builder-verified max probe length ≤ ``max_probes`` (the
  table is grown until that bound holds, so the device probe loop is a
  *static* unrolled bound).

Words are interned host-side: PAD=0 (beyond end of topic), PLUS=1, HASH=2,
UNK=3 (topic word never seen in any filter — can only match wildcards),
real words ≥ 4. Wildcard ids never appear as hash-table keys, which is what
makes the device walk agree with the host oracle on degenerate topics
containing literal '+'/'#'.

Match-uniqueness invariant (why the kernel needs no dedup): a filter is
emitted either as ``hash_fid`` at exactly one (node, depth) or as
``node_fid`` at exactly one node at end-of-topic; trie nodes are a tree, so
a frontier never contains the same node twice ⇒ every matching filter id is
emitted exactly once per topic.

Incremental maintenance (emqx_trie.erl:113-144 — O(topic-depth) insert
and delete, the BASELINE.json north-star sentence)
---------------------------------------------------------------------
The numpy arrays ARE the trie: ``insert``/``delete`` walk them directly
and patch in place —

- insert appends nodes into pre-allocated capacity (arrays are built
  with ~1.5× headroom and every slot pre-initialised to -1, so a fresh
  node needs **no** device write), claims free edge-table slots within
  the probe bound, and sets the terminal fid;
- delete clears the terminal fid only.  Edges/nodes of dead paths stay
  as garbage until the next compaction — they match nothing (fid = -1)
  and removing them eagerly would need probe-chain repair.  ``garbage``
  counts them so the owner can ``rebuild()`` opportunistically.

Every patched index is recorded in ``pending`` (array-name → dirty
indices); the device owner (models.RouterModel) drains it and scatters
just those elements into device memory with one scatter launch — subscribe→routable is
O(topic-depth), not O(table).  Structural growth (node capacity, edge
load > 50%, probe-bound overflow) flips ``needs_rebuild`` and the next
``ensure()`` does a double-buffered full rebuild with fresh headroom.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from emqx_tpu_torch.core import topic as T

PAD = 0
PLUS_ID = 1
HASH_ID = 2
UNK = 3
FIRST_WORD_ID = 4

_MIX_A = np.uint32(0x9E3779B1)
_MIX_B = np.uint32(0x85EBCA77)


def edge_hash(parent: np.ndarray, word: np.ndarray, mask: int) -> np.ndarray:
    """Slot hash for the (parent, word) edge key — same formula on host
    (builder) and device (prober); uint32 wraparound arithmetic."""
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        p = parent.astype(np.uint32) * _MIX_A
        w = word.astype(np.uint32) * _MIX_B
        h = p ^ w
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(12)
        return (h & np.uint32(mask)).astype(np.int32)


def edge_step(parent: np.ndarray, word: np.ndarray, mask: int) -> np.ndarray:
    """Double-hashing probe stride for the edge key (odd → coprime with
    the pow2 table, so the sequence visits distinct slots). Linear
    probing's primary clustering made >8-probe chains common enough at
    tens of millions of edges to force table doublings (r2's 10M build
    grew the table 4×); per-key strides keep the probe bound honest at
    4× load. Must match the device prober (ops/trie_match.py)."""
    with np.errstate(over="ignore"):
        p = parent.astype(np.uint32) * np.uint32(0xC2B2AE3D)
        w = word.astype(np.uint32) * np.uint32(0x27D4EB2F)
        h = p ^ w
        h ^= h >> np.uint32(13)
        h *= np.uint32(0x165667B1)
        h ^= h >> np.uint32(16)
        return ((h | np.uint32(1)) & np.uint32(mask)).astype(np.int32)


@dataclass
class TrieIndexArrays:
    """The device-side arrays (numpy here; moved to the card by the matcher).

    Arrays are allocated at CAPACITY (≥ live size) so in-place appends
    need no realloc; ``n_nodes`` is the live node count."""

    ht_parent: np.ndarray
    ht_word: np.ndarray
    ht_child: np.ndarray
    plus_child: np.ndarray
    hash_fid: np.ndarray
    node_fid: np.ndarray
    n_nodes: int
    n_filters: int
    max_probes: int


class TrieIndex:
    """Host-side builder + incremental maintainer: filters → interned
    vocab + flat trie arrays, patched in place per mutation (see module
    docstring)."""

    def __init__(self, max_levels: int = 16, max_probes: int = 8) -> None:
        self.max_levels = max_levels
        self.max_probes = max_probes
        # minimum edge-table size for the next rebuild.  The sharded
        # wrapper (ShardedTrieIndex) raises this so every shard's table
        # is the SAME pow2 — the device stacks shards into one [S, H]
        # buffer and the probe mask (H-1) must hold per shard.
        self.ht_size_floor = 64
        self.vocab: dict[str, int] = {}
        self.filters: list[Optional[str]] = []   # fid -> filter string
        self._filter_ids: dict[str, int] = {}
        self._free_fids: list[int] = []
        # fid-reuse quarantine: while any publish batch is in flight
        # (submitted, not yet decoded), freed fids must NOT be reused —
        # the in-flight results reference them, and a reuse would decode
        # a stale match as the NEW filter (wrong-subscriber delivery).
        # RouterModel brackets submit/collect with begin/end_inflight.
        self._inflight = 0
        self._quarantined_fids: list[int] = []
        self.arrays: Optional[TrieIndexArrays] = None
        self.n_nodes = 0
        self.n_edges = 0
        self.garbage = 0          # deletes since last rebuild (dead paths)
        self.needs_rebuild = True
        self.rebuild_count = 0    # observability + test hook
        # array-name → set of dirty indices awaiting device scatter
        self.pending: dict[str, set[int]] = {
            "ht_parent": set(), "ht_word": set(), "ht_child": set(),
            "plus_child": set(), "hash_fid": set(), "node_fid": set(),
        }

    # -- vocab -------------------------------------------------------------

    def intern(self, word: str) -> int:
        wid = self.vocab.get(word)
        if wid is None:
            wid = FIRST_WORD_ID + len(self.vocab)
            self.vocab[word] = wid
        return wid

    def word_id(self, word: str) -> int:
        if word == T.PLUS:
            return PLUS_ID
        if word == T.HASH:
            return HASH_ID
        return self.vocab.get(word, UNK)

    # -- filter set mutation ----------------------------------------------

    def fid_of(self, filt: str) -> Optional[int]:
        return self._filter_ids.get(filt)

    def insert(self, filt: str) -> int:
        """Register a filter, return its stable fid.  O(topic-depth)
        in-place patch unless a rebuild is already pending."""
        if not T.validate_filter(filt):
            # same guard as Router.add_route: an invalid filter (e.g.
            # 'a/#/b') would be silently truncated at '#' by rebuild() and
            # diverge from the host oracle
            raise ValueError(f"invalid topic filter: {filt!r}")
        fid = self._filter_ids.get(filt)
        if fid is not None:
            return fid
        if self._free_fids:
            fid = self._free_fids.pop()
            self.filters[fid] = filt
        else:
            fid = len(self.filters)
            self.filters.append(filt)
        self._filter_ids[filt] = fid
        if not self.needs_rebuild and self.arrays is not None:
            self._insert_arrays(filt, fid)
        else:
            self.needs_rebuild = True
            for w in T.words(filt):
                if w not in (T.PLUS, T.HASH):
                    self.intern(w)
        return fid

    def begin_inflight(self) -> None:
        self._inflight += 1

    def end_inflight(self) -> None:
        self._inflight -= 1
        if self._inflight <= 0:
            self._inflight = 0
            if self._quarantined_fids:
                self._free_fids.extend(self._quarantined_fids)
                self._quarantined_fids.clear()

    def delete(self, filt: str) -> Optional[int]:
        fid = self._filter_ids.pop(filt, None)
        if fid is None:
            return None
        self.filters[fid] = None
        (self._quarantined_fids if self._inflight
         else self._free_fids).append(fid)
        if not self.needs_rebuild and self.arrays is not None:
            self._delete_arrays(filt, fid)
            self.garbage += 1
        return fid

    def load(self, filters: Sequence[str]) -> None:
        for f in filters:
            self.insert(f)

    # -- incremental array patching ---------------------------------------

    def _mark(self, name: str, idx: int) -> None:
        self.pending[name].add(idx)

    def _new_node(self) -> Optional[int]:
        a = self.arrays
        if self.n_nodes >= a.plus_child.shape[0]:
            self.needs_rebuild = True
            return None
        idx = self.n_nodes
        self.n_nodes = idx + 1
        a.n_nodes = self.n_nodes
        # plus/hash/node entries are pre-initialised -1 on host AND
        # device, so a fresh node costs zero writes
        return idx

    def _ht_find(self, parent: int, wid: int
                 ) -> tuple[Optional[int], Optional[int]]:
        """(child, free_slot): child if the edge exists, else the first
        free slot within the probe bound (None, None = no room)."""
        a = self.arrays
        mask = a.ht_parent.shape[0] - 1
        slot = int(edge_hash(np.int32(parent), np.int32(wid), mask))
        step = int(edge_step(np.int32(parent), np.int32(wid), mask))
        for p in range(self.max_probes):
            s = (slot + p * step) & mask
            sp = int(a.ht_parent[s])
            if sp == -1:
                return None, s
            if sp == parent and int(a.ht_word[s]) == wid:
                return int(a.ht_child[s]), None
        return None, None

    def _insert_arrays(self, filt: str, fid: int) -> None:
        a = self.arrays
        node = 0
        for w in T.words(filt):
            if w == T.HASH:           # '#' is terminal: fold to parent
                a.hash_fid[node] = fid
                self._mark("hash_fid", node)
                a.n_filters = len(self.filters)
                return
            if w == T.PLUS:
                c = int(a.plus_child[node])
                if c == -1:
                    c = self._new_node()
                    if c is None:
                        return              # rebuild pending
                    a.plus_child[node] = c
                    self._mark("plus_child", node)
                node = c
            else:
                wid = self.intern(w)
                child, free = self._ht_find(node, wid)
                if child is None:
                    c = self._new_node()
                    if c is None:
                        return
                    if free is None:        # probe bound full here
                        self.needs_rebuild = True
                        return
                    a.ht_parent[free] = node
                    a.ht_word[free] = wid
                    a.ht_child[free] = c
                    for nm in ("ht_parent", "ht_word", "ht_child"):
                        self._mark(nm, free)
                    self.n_edges += 1
                    if 2 * self.n_edges > a.ht_parent.shape[0]:
                        # >50% load: grow at the NEXT ensure(); this
                        # insert itself is already placed and valid
                        self.needs_rebuild = True
                    node = c
                else:
                    node = child
        a.node_fid[node] = fid
        self._mark("node_fid", node)
        a.n_filters = len(self.filters)

    def _delete_arrays(self, filt: str, fid: int) -> None:
        a = self.arrays
        node = 0
        for w in T.words(filt):
            if w == T.HASH:
                if int(a.hash_fid[node]) == fid:
                    a.hash_fid[node] = -1
                    self._mark("hash_fid", node)
                return
            if w == T.PLUS:
                node = int(a.plus_child[node])
            else:
                wid = self.vocab.get(w)
                if wid is None:
                    return                  # never inserted ⇒ no-op
                node, _ = self._ht_find(node, wid)  # type: ignore
            if node is None or node < 0:
                return                      # path absent (defensive)
        if int(a.node_fid[node]) == fid:
            a.node_fid[node] = -1
            self._mark("node_fid", node)

    def drain_updates(self) -> dict[str, list[int]]:
        """Dirty indices per array since the last drain (values live in
        ``self.arrays``); clears the pending sets."""
        out = {k: sorted(v) for k, v in self.pending.items() if v}
        for v in self.pending.values():
            v.clear()
        return out

    # -- build -------------------------------------------------------------

    # above this many live filters the vectorized builder wins (the
    # python pointer-trie walk costs ~100s/1M filters; the numpy
    # level-synchronous build is ~20× faster and is what makes the
    # BASELINE config-3 cold start (10M filters) feasible)
    VECTOR_BUILD_MIN = 50_000

    def rebuild(self) -> TrieIndexArrays:
        """Double-buffered full rebuild: one pass over filters → fresh
        flat arrays with ~1.5× node headroom and ≤25% edge-table load
        (so the next growth rebuild is a long way off)."""
        n_live = sum(1 for f in self.filters if f is not None)
        if n_live >= self.VECTOR_BUILD_MIN:
            return self._rebuild_vectorized()
        return self._rebuild_scalar()

    def _rebuild_scalar(self) -> TrieIndexArrays:
        # 1. build a pointer trie over word ids
        children: list[dict[int, int]] = [{}]   # node -> {word_id: child}
        plus: list[int] = [-1]
        hashf: list[int] = [-1]
        nodef: list[int] = [-1]

        def new_node() -> int:
            children.append({})
            plus.append(-1)
            hashf.append(-1)
            nodef.append(-1)
            return len(children) - 1

        n_edges = 0
        for fid, filt in enumerate(self.filters):
            if filt is None:
                continue
            node = 0
            ws = T.words(filt)
            for i, w in enumerate(ws):
                if w == T.HASH:
                    hashf[node] = fid        # '#' is terminal: fold to parent
                    break
                if w == T.PLUS:
                    if plus[node] == -1:
                        plus[node] = new_node()
                    node = plus[node]
                else:
                    wid = self.intern(w)
                    nxt = children[node].get(wid)
                    if nxt is None:
                        nxt = new_node()
                        children[node][wid] = nxt
                        n_edges += 1
                    node = nxt
            else:
                nodef[node] = fid
        n_nodes = len(children)
        cap = 64
        while cap < n_nodes + n_nodes // 2:
            cap *= 2

        # 2. open-addressed edge table, grown until probe bound holds
        size = max(64, self.ht_size_floor)
        while size < 4 * max(1, n_edges):
            size *= 2
        while True:
            ht_parent = np.full(size, -1, np.int32)
            ht_word = np.full(size, -1, np.int32)
            ht_child = np.full(size, -1, np.int32)
            mask = size - 1
            ok = True
            for parent, edges in enumerate(children):
                for wid, child in edges.items():
                    slot = int(edge_hash(np.int32(parent), np.int32(wid), mask))
                    step = int(edge_step(np.int32(parent), np.int32(wid),
                                         mask))
                    for probe in range(self.max_probes):
                        s = (slot + probe * step) & mask
                        if ht_parent[s] == -1:
                            ht_parent[s] = parent
                            ht_word[s] = wid
                            ht_child[s] = child
                            break
                    else:
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                break
            size *= 2

        def padded(src: list[int]) -> np.ndarray:
            out = np.full(cap, -1, np.int32)
            out[:n_nodes] = src
            return out

        self.arrays = TrieIndexArrays(
            ht_parent=ht_parent,
            ht_word=ht_word,
            ht_child=ht_child,
            plus_child=padded(plus),
            hash_fid=padded(hashf),
            node_fid=padded(nodef),
            n_nodes=n_nodes,
            n_filters=len(self.filters),
            max_probes=self.max_probes,
        )
        self.n_nodes = n_nodes
        self.n_edges = n_edges
        self.garbage = 0
        self.needs_rebuild = False
        self.rebuild_count += 1
        for v in self.pending.values():      # superseded by the rebuild
            v.clear()
        return self.arrays

    def _rebuild_vectorized(self) -> TrieIndexArrays:
        """Numpy level-synchronous trie build (same result as the scalar
        builder, ~20× faster at millions of filters).

        All filters advance one topic level per iteration, so every
        (parent, word) pair seen at iteration *i* keys a depth-*i* node;
        ``np.unique`` over the pair set mints the level's node ids in one
        shot.  The edge table fills with vectorized probe rounds: each
        round places every still-unplaced edge whose probe slot is free,
        first-come-per-slot arbitration via ``np.unique(return_index)``.
        """
        live_fids = np.asarray(
            [fid for fid, f in enumerate(self.filters) if f is not None],
            np.int64)
        word_lists = [T.words(self.filters[f]) for f in live_fids]
        L = self.max_levels
        # intern new words through the existing vocab (ids must stay
        # stable — tokenize depends on them); dict-dedupe + sorted for a
        # deterministic id order (an object-dtype np.unique here cost a
        # 30s python-string sort at 2M filters)
        fresh = {w for ws in word_lists for w in ws
                 if w not in (T.PLUS, T.HASH) and w not in self.vocab}
        for w in sorted(fresh):
            self.intern(w)
        F = len(live_fids)
        toks = np.full((F, max(1, L)), -1, np.int64)
        lengths = np.fromiter(map(len, word_lists), np.int64, F)
        # validate_filter guarantees '#' is only ever the LAST word, so
        # hash detection is a tail check, not a scan
        has_hash_l = np.fromiter(
            (1 if ws and ws[-1] == T.HASH else 0 for ws in word_lists),
            np.int64, F)
        hash_pos = np.where(has_hash_l == 1, lengths - 1, -np.int64(1))
        eff_len = np.where(hash_pos >= 0, hash_pos, lengths)
        # scatter the (depth-clipped) token ids in one shot
        clip = np.minimum(eff_len, L)
        vocab = self.vocab
        flat_ids = np.fromiter(
            (PLUS_ID if w == T.PLUS else vocab[w]
             for ws, n in zip(word_lists, clip.tolist())
             for w in ws[:n]),
            np.int64)
        rows = np.repeat(np.arange(F), clip)
        ends = np.cumsum(clip)
        cols = np.arange(len(flat_ids)) - np.repeat(ends - clip, clip)
        toks[rows, cols] = flat_ids

        cur = np.zeros(F, np.int64)           # current node per filter
        n_nodes = 1
        plus_edges: list[tuple[np.ndarray, np.ndarray]] = []
        exact_edges: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for i in range(L):
            act = eff_len > i
            if not act.any():
                break
            pa, wi = cur[act], toks[act, i]
            keys = pa * (len(vocab) + FIRST_WORD_ID + 2) + wi
            uniq, inv = np.unique(keys, return_inverse=True)
            child = n_nodes + np.arange(len(uniq))
            n_nodes += len(uniq)
            # representative (parent, word) per unique key
            first = np.full(len(uniq), -1, np.int64)
            first[inv[::-1]] = np.arange(len(pa))[::-1]   # first index
            rp, rw, rc = pa[first], wi[first], child
            isplus = rw == PLUS_ID
            plus_edges.append((rp[isplus], rc[isplus]))
            exact_edges.append((rp[~isplus], rw[~isplus], rc[~isplus]))
            cur[act] = child[inv]

        cap = 64
        while cap < n_nodes + n_nodes // 2:
            cap *= 2
        plus_child = np.full(cap, -1, np.int32)
        hash_fid = np.full(cap, -1, np.int32)
        node_fid = np.full(cap, -1, np.int32)
        for rp, rc in plus_edges:
            plus_child[rp] = rc
        # terminals beyond depth L are unreachable from the device matcher
        # (topics deeper than max_levels take the host-oracle fallback in
        # tokenize()), so — like the scalar builder's deeper-than-L nodes —
        # they are simply not marked; marking them at the truncated depth-L
        # node would create FALSE matches for depth-L topics
        has_hash = (hash_pos >= 0) & (hash_pos <= L)
        hash_fid[cur[has_hash]] = live_fids[has_hash]
        ends = (hash_pos < 0) & (lengths <= L)
        node_fid[cur[ends]] = live_fids[ends]

        ep = np.concatenate([e[0] for e in exact_edges]) \
            if exact_edges else np.zeros(0, np.int64)
        ew = np.concatenate([e[1] for e in exact_edges]) \
            if exact_edges else np.zeros(0, np.int64)
        ec = np.concatenate([e[2] for e in exact_edges]) \
            if exact_edges else np.zeros(0, np.int64)
        n_edges = len(ep)

        size = max(64, self.ht_size_floor)
        while size < 4 * max(1, n_edges):
            size *= 2
        while True:
            ht_parent = np.full(size, -1, np.int32)
            ht_word = np.full(size, -1, np.int32)
            ht_child = np.full(size, -1, np.int32)
            mask = size - 1
            home = edge_hash(ep.astype(np.int32), ew.astype(np.int32),
                             mask).astype(np.int64)
            stride = edge_step(ep.astype(np.int32), ew.astype(np.int32),
                               mask).astype(np.int64)
            unplaced = np.arange(n_edges)
            for probe in range(self.max_probes):
                if len(unplaced) == 0:
                    break
                s = (home[unplaced] + probe * stride[unplaced]) & mask
                free = ht_parent[s] == -1
                cand = unplaced[free]
                cs = s[free]
                # first-come-per-slot: np.unique picks one winner per slot
                uslot, first_idx = np.unique(cs, return_index=True)
                winners = cand[first_idx]
                ht_parent[uslot] = ep[winners]
                ht_word[uslot] = ew[winners]
                ht_child[uslot] = ec[winners]
                placed = np.zeros(len(unplaced), bool)
                # a candidate is placed iff its slot now holds its own
                # child id (child ids are unique per edge, so equality
                # identifies the winner; losers retry at the next probe)
                placed[free] = ht_child[cs] == ec[cand]
                unplaced = unplaced[~placed]
            if len(unplaced) and self._kick_place(
                    unplaced, ep, ew, ec, home, stride,
                    ht_parent, ht_word, ht_child, mask):
                unplaced = unplaced[:0]
            if len(unplaced) == 0:
                break
            size *= 2                     # pathological fallback only

        self.arrays = TrieIndexArrays(
            ht_parent=ht_parent, ht_word=ht_word, ht_child=ht_child,
            plus_child=plus_child, hash_fid=hash_fid, node_fid=node_fid,
            n_nodes=n_nodes, n_filters=len(self.filters),
            max_probes=self.max_probes,
        )
        self.n_nodes = n_nodes
        self.n_edges = n_edges
        self.garbage = 0
        self.needs_rebuild = False
        self.rebuild_count += 1
        for v in self.pending.values():
            v.clear()
        return self.arrays

    def _kick_place(self, unplaced, ep, ew, ec, home, stride,
                    ht_parent, ht_word, ht_child, mask) -> bool:
        """Depth-1 displacement for the rare edges whose whole probe
        window is full (expected O(n·α^max_probes) ≈ a handful at 4×
        headroom): evict one window occupant to the first EMPTY slot of
        ITS OWN probe sequence and take its place.

        Correctness of the device prober's stop-at-empty rule is
        preserved: a kick only CONSUMES empties (the vacated slot is
        immediately refilled by the stuck edge), so every key's probe
        prefix stays fully occupied. Returns False if any edge stays
        unplaceable (caller doubles the table — pathological hash
        behaviour only)."""
        for e in unplaced:
            placed = False
            for p in range(self.max_probes):
                s = int((home[e] + p * stride[e]) & mask)
                # the occupant's key is right there in the table — derive
                # its probe sequence and find an empty alternative
                op, ow = np.int32(ht_parent[s]), np.int32(ht_word[s])
                oh = int(edge_hash(op, ow, mask))
                ostep = int(edge_step(op, ow, mask))
                for p2 in range(self.max_probes):
                    s2 = (oh + p2 * ostep) & mask
                    if ht_parent[s2] == -1:
                        ht_parent[s2] = op
                        ht_word[s2] = ow
                        ht_child[s2] = ht_child[s]
                        ht_parent[s] = ep[e]
                        ht_word[s] = ew[e]
                        ht_child[s] = ec[e]
                        placed = True
                        break
                if placed:
                    break
            if not placed:
                return False
        return True

    def ensure(self) -> TrieIndexArrays:
        if self.needs_rebuild or self.arrays is None:
            return self.rebuild()
        return self.arrays

    # -- topic tokenizer ---------------------------------------------------

    def tokenize(
        self, topics: Sequence[str]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[int]]:
        """topics → (tokens [B,L], lengths [B], sys_flags [B], too_long).

        ``too_long`` lists batch positions whose topic exceeds max_levels —
        they must take the host-oracle fallback (mirrors the reference's
        escape hatch for pathological topics).
        """
        B, L = len(topics), self.max_levels
        tokens = np.zeros((B, L), np.int32)
        lengths = np.zeros(B, np.int32)
        sys_flags = np.zeros(B, bool)
        too_long: list[int] = []
        for b, topic in enumerate(topics):
            ws = T.words(topic)
            if len(ws) > L:
                too_long.append(b)
                # length 0 + sys flag ⇒ the kernel emits nothing for this
                # row (even root '#'/'+' which match an empty prefix);
                # caller routes it through the host oracle instead
                lengths[b] = 0
                sys_flags[b] = True
                continue
            lengths[b] = len(ws)
            sys_flags[b] = ws[0].startswith("$") if ws else False
            for i, w in enumerate(ws):
                tokens[b, i] = self.word_id(w)
        return tokens, lengths, sys_flags, too_long


# ---------------------------------------------------------------------------
# subscription-space sharding: S tries stacked into [S, ...] device tensors
# ---------------------------------------------------------------------------


def shard_of_filter(filt: str, n_shards: int) -> int:
    """Stable filter → shard assignment. crc32, NOT Python hash():
    str hashing is salted per process, and the shard a filter lives in
    must survive restarts (the bench disk cache and any future
    cross-process handoff key on it)."""
    return zlib.crc32(filt.encode()) % n_shards


class _ShardedFilters:
    """Read-only fid → filter view over a ShardedTrieIndex.

    Global fids interleave the per-shard namespaces:
    ``global = local * S + shard``, so each shard's fid space grows
    independently while every global fid stays stable and decodes with
    one divmod.  Gaps (a shard shorter than the longest) read as None —
    the same convention as a freed fid in the flat TrieIndex.
    """

    def __init__(self, owner: "ShardedTrieIndex") -> None:
        self._owner = owner

    def __len__(self) -> int:
        s = self._owner.shards
        return self._owner.n_shards * max(
            (len(t.filters) for t in s), default=0)

    def __getitem__(self, g) -> Optional[str]:
        g = int(g)
        shard = g % self._owner.n_shards
        local = g // self._owner.n_shards
        fl = self._owner.shards[shard].filters
        return fl[local] if 0 <= local < len(fl) else None

    def __iter__(self):
        for g in range(len(self)):
            yield self[g]


class ShardedTrieIndex:
    """S per-shard TrieIndexes presenting one fid namespace — the
    subscription-space partition of the level-packed trie.

    Each filter lives in exactly one shard (``shard_of_filter``), each
    shard owns its own node/edge arrays, and the device stacks them
    into ``[S, ...]`` tensors (``ops.trie_match.stacked_device_trie``)
    so one walk launch covers every shard.  Invariants:

    - the word vocab is SHARED (one dict aliased into every shard):
      tokenized topics are matched against every shard, so word ids
      must agree across shards;
    - global fids are ``local * S + shard`` (see _ShardedFilters);
      the per-shard trie arrays store LOCAL fids and the device match
      translates local → global with one fused elementwise op;
    - every shard's edge table is the SAME pow2 size (``ensure``
      equalizes via ``ht_size_floor`` + rebuild) because the stacked
      [S, H] probe mask is shared;
    - an incremental insert/delete touches only the owning shard's
      arrays, and ``drain_updates`` reports (shard, index) pairs so the
      device scatter patches just that shard's slice of [S, ...].

    S = 1 degenerates to the flat layout bit-for-bit (global == local).
    """

    def __init__(self, n_shards: int, max_levels: int = 16,
                 max_probes: int = 8) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.max_levels = max_levels
        self.max_probes = max_probes
        self.shards = [TrieIndex(max_levels, max_probes)
                       for _ in range(n_shards)]
        shared_vocab = self.shards[0].vocab
        for s in self.shards[1:]:
            s.vocab = shared_vocab
        self.vocab = shared_vocab
        self.filters = _ShardedFilters(self)

    # -- fid namespace -----------------------------------------------------

    def _shard(self, filt: str) -> int:
        return shard_of_filter(filt, self.n_shards)

    def _global(self, shard: int, local: int) -> int:
        return local * self.n_shards + shard

    def insert(self, filt: str) -> int:
        shard = self._shard(filt)
        return self._global(shard, self.shards[shard].insert(filt))

    def delete(self, filt: str) -> Optional[int]:
        shard = self._shard(filt)
        local = self.shards[shard].delete(filt)
        return None if local is None else self._global(shard, local)

    def fid_of(self, filt: str) -> Optional[int]:
        shard = self._shard(filt)
        local = self.shards[shard].fid_of(filt)
        return None if local is None else self._global(shard, local)

    def load(self, filters: Sequence[str]) -> None:
        for f in filters:
            self.insert(f)

    def begin_inflight(self) -> None:
        for s in self.shards:
            s.begin_inflight()

    def end_inflight(self) -> None:
        for s in self.shards:
            s.end_inflight()

    @property
    def _inflight(self) -> int:
        return self.shards[0]._inflight

    # -- build / maintenance ----------------------------------------------

    @property
    def needs_rebuild(self) -> bool:
        return any(s.needs_rebuild or s.arrays is None for s in self.shards)

    @property
    def rebuild_count(self) -> int:
        return sum(s.rebuild_count for s in self.shards)

    @property
    def garbage(self) -> int:
        return sum(s.garbage for s in self.shards)

    def ensure(self) -> list[TrieIndexArrays]:
        """Rebuild dirty shards, then equalize edge-table sizes: the
        stacked [S, H] device buffer shares one probe mask, so every
        shard must sit at the common (max) pow2 H."""
        for s in self.shards:
            s.ensure()
        H = max(s.arrays.ht_parent.shape[0] for s in self.shards)
        for s in self.shards:
            if s.arrays.ht_parent.shape[0] != H:
                s.ht_size_floor = H
                s.rebuild()
        return [s.arrays for s in self.shards]

    def drain_updates(self) -> dict[str, list[tuple[int, int]]]:
        """Dirty (shard, index) pairs per array since the last drain —
        the per-shard patch stream: a steady-state subscribe touches
        O(topic-depth) elements of ONE shard's arrays, never the stack."""
        out: dict[str, list[tuple[int, int]]] = {}
        for si, s in enumerate(self.shards):
            for name, idxs in s.drain_updates().items():
                out.setdefault(name, []).extend((si, i) for i in idxs)
        return out

    # -- topic tokenizer ---------------------------------------------------

    def intern(self, word: str) -> int:
        return self.shards[0].intern(word)

    def word_id(self, word: str) -> int:
        return self.shards[0].word_id(word)

    def tokenize(self, topics: Sequence[str]):
        # the vocab is shared, so shard 0's tokenizer speaks for all
        return self.shards[0].tokenize(topics)
