"""Retained messages — parity with ``apps/emqx_retainer``.

Store: retained message per exact topic; empty payload deletes
(MQTT spec). Lookup is the *inverse* trie problem:
given a subscription filter, find all retained topic *names* matching
it. The reference builds word-position indices for this
(emqx_retainer_mnesia.erl / emqx_retainer_index.erl); this store goes
vectorized instead (a recursive Python name-trie is slow at 100K
retained):

- every retained topic is a row in a token matrix ``tok[N, L]`` (word
  ids via an interning vocab) with depth/$-flags in parallel arrays;
- a filter match is a handful of numpy comparisons over the candidate
  rows — ``+`` constrains nothing (depth covers it), a word constrains
  one column, a trailing ``#`` relaxes the depth equality;
- candidates come from a (level0, level1) prefix bucket when the
  filter's first two levels are literal (the common
  ``vendor/device/...`` shape — buckets cut 100K rows to the ~200
  sharing the prefix), else the whole matrix is scanned;
- each bucket IS a compact submatrix (token rows, depth, deadline,
  message/topic lists) maintained INCREMENTALLY on store/delete/expire
  — append and swap-with-last writes, amortized-doubling growth. A
  per-bucket cache rebuilt on the first lookup after any churn would
  make exactly the lookup the reference's word-position index serves
  fast (first wildcard match after a churn burst) pay a rebuild cliff;
- topics deeper than ``MAX_LEVELS`` go to a tiny fallback dict walked
  with ``T.match`` (they are rare; correctness is preserved).

Broker wiring (same hookpoints as the reference):
- ``message.publish``      retain flag ⇒ store/delete (and deliver a copy)
- ``session.subscribed``   dispatch matching retained msgs per the
                           retain-handling (rh) subopt
TTL: per-message Message-Expiry-Interval plus a store-wide default;
expired entries are dropped lazily on read + via ``sweep()``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Message, now_ms

MAX_LEVELS = 16


class _Bucket:
    """One (level0-id, level1-id) prefix bucket: a compact, always-live
    submatrix of the retained-topic token matrix, position-aligned with
    its message/topic lists. Updated in place on every store/delete —
    append at ``n`` (amortized-doubling growth) and swap-with-last
    removal — so a lookup right after churn reads ready arrays instead
    of rebuilding a cache."""

    __slots__ = ("n", "tok", "depth", "deadline", "stored", "msgs",
                 "topics", "rows", "finite")

    def __init__(self, cap: int = 8):
        self.n = 0
        self.tok = np.zeros((cap, MAX_LEVELS), dtype=np.int32)
        self.depth = np.zeros(cap, dtype=np.int32)
        self.deadline = np.full(cap, np.inf)
        self.stored = np.zeros(cap, dtype=np.int64)
        self.msgs: list = []
        self.topics: list[str] = []
        self.rows: list[int] = []    # global row ids, position-aligned
        # sticky "a finite per-message deadline was ever seen": False
        # keeps the hit-dense one-extend fast path; deletes never clear
        # it (conservative)
        self.finite = False

    def append(self, row: int, tok_row, depth: int, deadline: float,
               stored: int, msg, topic: str) -> int:
        if self.n == self.tok.shape[0]:
            cap = self.n * 2
            for name in ("tok", "depth", "deadline", "stored"):
                old = getattr(self, name)
                new = np.full((cap,) + old.shape[1:],
                              np.inf if name == "deadline" else 0,
                              dtype=old.dtype)
                new[: self.n] = old
                setattr(self, name, new)
        pos = self.n
        self.tok[pos] = tok_row
        self.depth[pos] = depth
        self.deadline[pos] = deadline
        self.stored[pos] = stored
        self.msgs.append(msg)
        self.topics.append(topic)
        self.rows.append(row)
        if deadline != np.inf:
            self.finite = True
        self.n = pos + 1
        return pos

    def remove(self, pos: int) -> "int | None":
        """Swap-with-last removal; returns the global row id that moved
        INTO ``pos`` (the caller re-points its position map), or None."""
        last = self.n - 1
        moved = None
        if pos != last:
            self.tok[pos] = self.tok[last]
            self.depth[pos] = self.depth[last]
            self.deadline[pos] = self.deadline[last]
            self.stored[pos] = self.stored[last]
            self.msgs[pos] = self.msgs[last]
            self.topics[pos] = self.topics[last]
            self.rows[pos] = moved = self.rows[last]
        self.msgs.pop()
        self.topics.pop()
        self.rows.pop()
        self.n = last
        return moved


class Retainer:
    def __init__(self, max_retained: int = 0, default_expiry_ms: int = 0):
        self.max_retained = max_retained          # 0 = unlimited
        self.default_expiry_ms = default_expiry_ms
        self._lock = threading.RLock()
        self.dropped = 0
        # mirror observers: fired under the store lock as
        # ("set", topic, msg, effective_deadline_ms) on store/update and
        # ("del", topic, None, 0) on delete/expire — the native server
        # replicates the store into the host-side retained snapshot so
        # SUBSCRIBE-triggered delivery resolves below the GIL. Callbacks
        # must be non-blocking (they enqueue ops); this store remains
        # the oracle and the authority.
        self.observers: list = []
        self._count = 0               # live retained messages (incl. deep)
        # row-aligned store
        self._row_of: dict[str, int] = {}
        self._topics: list[str] = []
        self._msgs: list[Optional[Message]] = []
        self._stored: list[int] = []
        # per-row absolute expiry deadline (ms; inf = no msg expiry),
        # precomputed at store so match() can mask expiry vectorized
        # instead of calling msg.is_expired() per hit
        self._deadline = np.full(1024, np.inf)
        self._stored_np = np.zeros(1024, dtype=np.int64)
        self._vocab: dict[str, int] = {}          # word -> id >= 1
        cap = 1024
        self._tok = np.zeros((cap, MAX_LEVELS), dtype=np.int32)
        self._depth = np.zeros(cap, dtype=np.int32)
        self._dollar = np.zeros(cap, dtype=bool)
        self._alive = np.zeros(cap, dtype=bool)
        self._n = 0                   # rows used (live + tombstoned)
        self._dead = 0
        # (id0, id1) -> always-live compact submatrix, maintained
        # incrementally on store/delete/expire (no rebuild-on-miss);
        # _bpos maps a global row to its position inside its bucket
        self._bucket: dict[tuple[int, int], _Bucket] = {}
        self._bpos: dict[int, int] = {}
        # topics deeper than MAX_LEVELS: topic -> (msg, stored_at)
        self._deep: dict[str, tuple[Message, int]] = {}

    def __len__(self) -> int:
        return self._count

    # -- store -------------------------------------------------------------

    def on_publish(self, msg: Message) -> None:
        if not msg.retain:
            return
        if msg.payload:
            self.store(msg)
        else:
            self.delete(msg.topic)     # empty retained payload = clear

    def _eff_deadline_ms(self, msg: Message, stored_ms: int) -> int:
        """Fold the per-message expiry and the store default into ONE
        absolute wall-clock deadline (0 = never) — the number the
        native snapshot checks with a single compare."""
        dl = self._msg_deadline(msg)
        if self.default_expiry_ms:
            dl = min(dl, stored_ms + self.default_expiry_ms)
        return 0 if dl == float("inf") else int(dl)

    def _notify(self, op: str, topic: str, msg, deadline_ms: int) -> None:
        for fn in self.observers:
            try:
                fn(op, topic, msg, deadline_ms)
            except Exception:  # noqa: BLE001 — a mirror must never
                pass           # break the authoritative store

    def _wid(self, w: str) -> int:
        wid = self._vocab.get(w)
        if wid is None:
            wid = len(self._vocab) + 1
            self._vocab[w] = wid
        return wid

    def _grow(self) -> None:
        cap = self._tok.shape[0] * 2
        for name in ("_tok", "_depth", "_dollar", "_alive", "_deadline",
                     "_stored_np"):
            old = getattr(self, name)
            shape = (cap,) + old.shape[1:]
            fill = np.inf if name == "_deadline" else 0
            new = np.full(shape, fill, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)

    def store(self, msg: Message, now: Optional[int] = None) -> bool:
        now = now_ms() if now is None else now
        topic = msg.topic
        kept = msg.set_header("retained", True)
        with self._lock:
            words = T.words(topic)
            if len(words) > MAX_LEVELS:
                if topic not in self._deep:
                    if self.max_retained and self._count >= self.max_retained:
                        self.dropped += 1
                        return False
                    self._count += 1
                self._deep[topic] = (kept, now)
                self._notify("set", topic, kept,
                             self._eff_deadline_ms(kept, now))
                return True
            row = self._row_of.get(topic)
            if row is not None:
                self._msgs[row] = kept
                self._stored[row] = now
                dl = self._msg_deadline(kept)
                self._deadline[row] = dl
                self._stored_np[row] = now
                # in-place bucket refresh at the row's known position
                b = self._bucket[(int(self._tok[row, 0]),
                                  int(self._tok[row, 1]))]
                pos = self._bpos[row]
                b.deadline[pos] = dl
                b.stored[pos] = now
                b.msgs[pos] = kept
                if dl != np.inf:
                    b.finite = True
                self._notify("set", topic, kept,
                             self._eff_deadline_ms(kept, now))
                return True
            if self.max_retained and self._count >= self.max_retained:
                self.dropped += 1
                return False       # table full: new topics rejected
            if self._n >= self._tok.shape[0]:
                self._grow()
            row = self._n
            self._n += 1
            ids = [self._wid(w) for w in words]
            self._tok[row, : len(ids)] = ids
            self._tok[row, len(ids):] = 0
            self._depth[row] = len(ids)
            self._dollar[row] = topic.startswith("$")
            self._alive[row] = True
            self._row_of[topic] = row
            self._topics.append(topic)
            self._msgs.append(kept)
            self._stored.append(now)
            dl = self._msg_deadline(kept)
            self._deadline[row] = dl
            self._stored_np[row] = now
            key = (ids[0], ids[1] if len(ids) > 1 else 0)
            b = self._bucket.get(key)
            if b is None:
                b = self._bucket[key] = _Bucket()
            self._bpos[row] = b.append(
                row, self._tok[row], len(ids), dl, now, kept, topic)
            self._count += 1
            self._notify("set", topic, kept,
                         self._eff_deadline_ms(kept, now))
            return True

    def delete(self, topic: str) -> bool:
        with self._lock:
            if topic in self._deep:
                del self._deep[topic]
                self._count -= 1
                self._notify("del", topic, None, 0)
                return True
            row = self._row_of.pop(topic, None)
            if row is None:
                return False
            self._alive[row] = False
            self._msgs[row] = None
            self._dead += 1
            self._count -= 1
            key = (int(self._tok[row, 0]), int(self._tok[row, 1]))
            b = self._bucket.get(key)
            pos = self._bpos.pop(row, None)
            if b is not None and pos is not None:
                moved = b.remove(pos)    # buckets hold live rows only
                if moved is not None:
                    self._bpos[moved] = pos
                if b.n == 0:
                    del self._bucket[key]
            # tombstones compact when they dominate — O(n) rebuild
            # amortized over >= n/2 deletes
            if self._dead > 1024 and self._dead * 2 > self._n:
                self._compact()
            self._notify("del", topic, None, 0)
            return True

    def _compact(self) -> None:
        live = [r for r in range(self._n) if self._alive[r]]
        topics = [self._topics[r] for r in live]
        msgs = [self._msgs[r] for r in live]
        stored = [self._stored[r] for r in live]
        for name in ("_depth", "_dollar", "_alive", "_deadline",
                     "_stored_np"):
            arr = getattr(self, name)
            arr[: len(live)] = arr[live]
        self._n = len(live)
        self._dead = 0
        self._topics = topics
        self._msgs = msgs
        self._stored = stored
        self._row_of = {t: i for i, t in enumerate(topics)}
        # rebuild the vocab from the survivors: without this, unique
        # topic-name churn (per-UUID topics) grows the intern dict
        # forever (the old trie pruned nodes on delete)
        self._vocab = {}
        self._tok[: self._n] = 0
        for i, t in enumerate(topics):
            ids = [self._wid(w) for w in T.words(t)]
            self._tok[i, : len(ids)] = ids
        self._bucket.clear()
        self._bpos.clear()
        for i, topic_i in enumerate(topics):
            key = (int(self._tok[i, 0]), int(self._tok[i, 1]))
            b = self._bucket.get(key)
            if b is None:
                b = self._bucket[key] = _Bucket()
            self._bpos[i] = b.append(
                i, self._tok[i], int(self._depth[i]),
                float(self._deadline[i]), int(self._stored_np[i]),
                self._msgs[i], topic_i)

    # -- inverse-trie lookup (vectorized) ------------------------------------

    def match(self, filt: str, now: Optional[int] = None) -> list[Message]:
        """All live retained messages whose topic matches ``filt``."""
        now = now_ms() if now is None else now
        fw = T.words(filt)
        out: list[Message] = []
        expired: list[str] = []
        with self._lock:
            self._match_rows(fw, now, out, expired)
            if self._deep:
                guard_dollar = fw[0] in (T.PLUS, T.HASH)
                for topic, (msg, stored_at) in list(self._deep.items()):
                    if guard_dollar and topic.startswith("$"):
                        continue
                    if T.match(topic, filt):
                        if self._msg_expired(msg, stored_at, now):
                            expired.append(topic)
                        else:
                            out.append(msg)
            for topic in expired:       # lazy expiry, same as the walk did
                self.delete(topic)
        return out

    def _match_rows(self, fw: list[str], now: int, out: list[Message],
                    expired: list[str]) -> None:
        n = self._n
        if n == 0:
            return
        has_hash = fw[-1] == T.HASH
        need = len(fw) - 1 if has_hash else len(fw)
        if need > MAX_LEVELS:
            # no array row is that deep (deep topics live in _deep,
            # matched by the caller's fallback walk) — and the literal
            # loops below must never index past the token matrix
            return
        # candidate narrowing: two literal leading levels hit a bucket
        # whose compact arrays are ALWAYS live (no rebuild-on-miss: a lazy
        # cache would make the first lookup after churn pay a rebuild)
        if len(fw) >= 2 and fw[0] not in (T.PLUS, T.HASH) \
                and fw[1] not in (T.PLUS, T.HASH):
            id0 = self._vocab.get(fw[0])
            id1 = self._vocab.get(fw[1])
            if id0 is None or id1 is None:
                return                    # no retained topic has the prefix
            b = self._bucket.get((id0, id1))
            if b is None:
                return
            n_b = b.n
            tok = b.tok[:n_b]
            depth = b.depth[:n_b]
            msgs = b.msgs
            mask = (depth >= need) if has_hash else (depth == need)
            # levels 0/1 == the bucket key; need<=MAX_LEVELS bounds i
            for i in range(2, min(len(fw), MAX_LEVELS)):
                w = fw[i]
                if w == T.HASH:
                    break
                if w == T.PLUS:
                    continue
                wid = self._vocab.get(w)
                if wid is None:
                    return                # literal word never stored
                mask &= tok[:, i] == wid
            if not b.finite and not self.default_expiry_ms:
                if mask.all():            # hit-dense fast path: one extend
                    out.extend(msgs)
                else:
                    out.extend([msgs[j] for j in np.nonzero(mask)[0].tolist()])
                return
            fresh = b.deadline[:n_b] > now
            if self.default_expiry_ms:
                fresh &= (now - b.stored[:n_b]) < self.default_expiry_ms
            stale = np.nonzero(mask & ~fresh)[0]
            hitj = np.nonzero(mask & fresh)[0]
            out.extend([msgs[j] for j in hitj.tolist()])
            expired.extend([b.topics[j] for j in stale.tolist()])
            return
        # full scan: wildcard in the first two levels
        tok = self._tok[:n]
        depth = self._depth[:n]
        mask = self._alive[:n] & (
            (depth >= need) if has_hash else (depth == need))
        if fw[0] in (T.PLUS, T.HASH):
            # MQTT 4.7.2: root wildcards never expose '$'-topics
            mask &= ~self._dollar[:n]
        for i, w in enumerate(fw[:MAX_LEVELS]):
            if w == T.HASH:
                break
            if w == T.PLUS:
                continue
            wid = self._vocab.get(w)
            if wid is None:
                return                    # literal word never stored
            mask &= tok[:, i] == wid
        # expiry is part of the mask: no per-hit Python calls on the
        # emission path (the workload is hit-bound)
        fresh = self._deadline[:n] > now
        if self.default_expiry_ms:
            fresh &= (now - self._stored_np[:n]) < self.default_expiry_ms
        stale = np.nonzero(mask & ~fresh)[0]
        hits = np.nonzero(mask & fresh)[0]
        msgs = self._msgs
        out.extend([msgs[r] for r in hits.tolist()])
        if stale.size:
            topics = self._topics
            expired.extend([topics[r] for r in stale.tolist()])

    @staticmethod
    def _msg_deadline(msg: Message) -> float:
        interval = (msg.headers.get("properties") or {}).get(
            "Message-Expiry-Interval")
        if interval is None:
            return float("inf")
        return msg.timestamp + interval * 1000

    def _msg_expired(self, msg: Message, stored_at: int, now: int) -> bool:
        if msg.is_expired(now):
            return True
        if self.default_expiry_ms and now - stored_at >= self.default_expiry_ms:
            return True
        return False

    # -- maintenance ---------------------------------------------------------

    def sweep(self, now: Optional[int] = None) -> int:
        """Periodic clear of expired entries (emqx_retainer clear timer)."""
        now = now_ms() if now is None else now
        removed = 0
        with self._lock:
            victims = [
                self._topics[r]
                for r in range(self._n)
                if self._alive[r] and self._msgs[r] is not None
                and self._msg_expired(self._msgs[r], self._stored[r], now)
            ]
            victims.extend(
                t for t, (m, s) in self._deep.items()
                if self._msg_expired(m, s, now))
            for topic in victims:
                if self.delete(topic):
                    removed += 1
        return removed

    def topics(self) -> list[str]:
        with self._lock:
            out = [self._topics[r] for r in range(self._n)
                   if self._alive[r]]
            out.extend(self._deep)
            return out

    def mirror_attach(self, fn) -> None:
        """Atomically boot a mirror: replay the current store through
        ``fn`` as ("set", ...) events, then register it as an observer —
        all under the store lock. A store/delete racing the native
        server's boot mirror therefore either lands in the replay or
        fires the observer after it, in order; it can never fall in a
        gap (missed mutation) or apply out of order (a delete overtaken
        by a stale boot "set" would resurrect the topic)."""
        with self._lock:
            for topic, msg, dl in self.dump():
                fn("set", topic, msg, dl)
            self.observers.append(fn)

    def dump(self) -> list[tuple]:
        """Every live retained message as ``(topic, msg,
        effective_deadline_ms)`` — the native server's boot-time mirror
        snapshot (messages retained before the server started)."""
        with self._lock:
            out = []
            for r in range(self._n):
                if self._alive[r] and self._msgs[r] is not None:
                    out.append((self._topics[r], self._msgs[r],
                                self._eff_deadline_ms(self._msgs[r],
                                                      self._stored[r])))
            for topic, (msg, stored_at) in self._deep.items():
                out.append((topic, msg,
                            self._eff_deadline_ms(msg, stored_at)))
            return out
