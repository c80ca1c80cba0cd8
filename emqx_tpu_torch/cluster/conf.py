"""Cluster-replicated config transactions — the ``emqx_cluster_rpc``
analogue (apps/emqx_conf/src/emqx_cluster_rpc.erl:26-44,71-140).

The reference keeps an mnesia table of config transactions (MFAs) plus a
per-node commit-cursor table; every node applies the log in order, a
lagging/failed node stalls its cursor and catches up later, with
``skip_failed_commit`` / ``fast_forward_to_commit`` escape hatches.

Here the same shape without mnesia:

- **ordered log**: entries ``{tnx_id, kind, path, value, initiator}``.
  Global order comes from a deterministic **coordinator** — the
  lowest-named alive *core* node (mria core/replicant split: replicants
  never coordinate, they forward appends — ``emqx_machine.erl:86-87``).
  The coordinator assigns ``tnx_id``, validates the op by applying it
  locally (the reference aborts a multicall whose MFA fails on the
  initiating node), then broadcasts the commit.
- **per-node cursors**: each node applies strictly in order; an entry
  that fails to apply stalls the cursor (later commits queue), the
  stall is retried every housekeeping tick, and the operator can
  ``skip_failed_commit`` past a poison entry or
  ``fast_forward_to_commit`` to a chosen id.
- **catch-up**: a commit arriving with a gap pulls ``conf.catchup``
  from its sender; joiners replay the log carried in the bootstrap
  snapshot (emqx_cluster_rpc.erl:92-105 catch-up on join).

Coordinator fail-over: commits replicate the log everywhere, so the
next-lowest core continues from ``max(tnx_id)`` it has seen (after
draining its own queue — a catching-up coordinator refuses writes
rather than committing unvalidated entries).

Partitions: like the reference (mnesia is not partition-tolerant;
ekka **autoheal** restarts the minority island, discarding its
divergent writes), both sides of a split may commit conflicting
tnx_ids. On heal, the bootstrap exchange detects the conflict and the
side that lost the coordinator tie-break (higher-named core) ADOPTS
the winner's log and cluster override wholesale — its
partition-era writes are discarded, exactly the autoheal outcome.
A 2-node cluster therefore keeps accepting config changes when one
node dies (availability parity with the reference) at the documented
cost of last-writer-wins-by-node-order across a true split-brain.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from emqx_tpu_torch.cluster.transport import TransportError


class ClusterConfError(RuntimeError):
    """Transient cluster condition (no core, coordinator catching up,
    local apply stalled) — retryable."""


class ClusterConfRejected(ClusterConfError):
    """The txn failed validation on the coordinator — permanent for this
    value; NOT retryable (mgmt maps it to 400, not 503)."""


class ClusterConf:
    # applied entries kept behind the cursor for lagging peers' catch-up;
    # older entries compact away (the reference prunes applied cluster_rpc
    # rows the same way) — a peer further behind adopts a snapshot instead
    KEEP = 500

    def __init__(self, node) -> None:
        self.node = node                     # ClusterNode
        self.log: dict[int, dict] = {}       # tnx_id → entry
        self.max_seen = 0                    # highest tnx_id in self.log
        self.cursor = 0                      # last APPLIED tnx_id
        self.compacted_to = 0                # entries ≤ this are pruned
        self.failed: Optional[dict] = None   # {"tnx_id", "error"}
        self._was_coordinator = False        # tail-sync latch (failover)
        self._lock = threading.RLock()

    # -- coordinator election ------------------------------------------------

    def coordinator(self) -> Optional[str]:
        """Lowest-named alive core node (self included). None when no
        core is reachable — replicants cannot commit alone."""
        n = self.node
        alive = [n.name] if n.role == "core" else []
        with n._lock:
            alive += [peer for peer, m in n.members.items()
                      if m.get("alive")
                      and m.get("role", "core") == "core"]
        return min(alive) if alive else None

    # -- write path (emqx_cluster_rpc:multicall) -----------------------------

    def multicall(self, kind: str, path: tuple, value: Any = None) -> Any:
        """Cluster-wide config op. Returns the locally applied value."""
        leader = self.coordinator()
        if leader is None:
            raise ClusterConfError(
                "no core node reachable — config txns need a core "
                "(mria core/replicant: replicants cannot commit)")
        if leader == self.node.name:
            entry = self._append(kind, list(path), value)
        else:
            self._was_coordinator = False
            try:
                resp = self.node.transport.call(
                    leader, "conf.append", from_node=self.node.name,
                    kind=kind, path=list(path), value=value)
            except TransportError as e:
                raise ClusterConfError(
                    f"coordinator {leader} unreachable: {e}") from e
            if resp.get("error"):
                cls = (ClusterConfRejected if resp.get("rejected")
                       else ClusterConfError)
                raise cls(resp["error"])
            entry = resp["entry"]
            # apply here-and-now; the broadcast cast that also carries
            # this entry is a no-op once the cursor has passed it
            self._ingest(entry, from_node=leader)
            with self._lock:
                if self.cursor < entry["tnx_id"]:
                    # committed cluster-wide but failed to apply HERE —
                    # surface the partial state instead of returning the
                    # stale pre-txn value as success
                    err = (self.failed or {}).get("error", "apply lagging")
                    raise ClusterConfError(
                        f"txn {entry['tnx_id']} committed cluster-wide "
                        f"but failed to apply on {self.node.name}: {err} "
                        f"(node stalled; see /cluster_rpc, "
                        f"skip_failed_commit to recover)")
        conf = getattr(self.node.app, "config", None)
        if conf is not None and kind == "put":
            return conf.get(tuple(entry["path"]))
        return None

    def _sync_tail(self) -> None:
        """On promotion, learn the true log tail from every reachable
        peer before assigning ids: the previous coordinator's final
        commit may have reached a subset of nodes we haven't heard from
        (a lost cast), and re-using its tnx_id would silently diverge
        that subset."""
        for peer in self.node.alive_peers():
            try:
                st = self.node.transport.call(
                    peer, "conf.status", from_node=self.node.name)
            except TransportError:
                continue
            if st.get("max_seen", 0) > self.max_seen:
                self.catchup(peer)

    def _append(self, kind: str, path: list, value: Any) -> dict:
        """Coordinator side: assign id, validate by local apply,
        replicate."""
        if not self._was_coordinator:
            self._sync_tail()            # failover read-repair
            self._was_coordinator = True
        self._drain()      # a just-promoted coordinator finishes catching
        #                    up before accepting new txns
        with self._lock:
            tnx_id = self.max_seen + 1
            if self.cursor != tnx_id - 1:
                raise ClusterConfError(
                    f"coordinator still catching up "
                    f"(applied {self.cursor}/{self.max_seen}) — retry")
            entry = {"tnx_id": tnx_id, "kind": kind, "path": path,
                     "value": value, "initiator": self.node.name,
                     # committing coordinator: the split-brain tie-break
                     # compares the CONFLICTING ENTRIES' coordinators so
                     # every node on both sides reaches the same verdict
                     "coord": self.node.name}
            # validate: the txn must apply cleanly on the coordinator
            # (reference: multicall aborts if the MFA fails on the
            # initiating node — nothing is committed)
            try:
                self._apply(entry)
            except Exception as e:
                raise ClusterConfRejected(
                    f"config txn rejected: {e}") from e
            self.cursor = tnx_id
            self.log[tnx_id] = entry
            self.max_seen = tnx_id
        self.node._broadcast("conf.commit", entry=entry)
        return entry

    # -- apply machinery -----------------------------------------------------

    def _apply(self, entry: dict) -> None:
        conf = getattr(self.node.app, "config", None)
        if conf is None:
            return                        # log-only node (no Config bound)
        path = tuple(entry["path"])
        if entry["kind"] == "put":
            conf.put(path, entry["value"], layer="cluster", local=True)
        elif entry["kind"] == "remove":
            conf.remove(path, layer="cluster", local=True)

    def _drain(self) -> None:
        """Apply every queued entry in order until a gap or a failure."""
        while True:
            with self._lock:
                nxt = self.log.get(self.cursor + 1)
                if nxt is None:
                    return
                try:
                    self._apply(nxt)
                except Exception as e:   # stall; retried on tick
                    self.failed = {"tnx_id": nxt["tnx_id"],
                                   "error": str(e)}
                    return
                self.cursor = nxt["tnx_id"]
                if self.failed and self.failed["tnx_id"] <= self.cursor:
                    self.failed = None

    def _ingest(self, entry: dict, from_node: str) -> None:
        with self._lock:
            self.log[entry["tnx_id"]] = entry
            self.max_seen = max(self.max_seen, entry["tnx_id"])
            gap = entry["tnx_id"] > self.cursor + 1 and \
                self.log.get(self.cursor + 1) is None
        if gap:
            self.catchup(from_node)
        self._drain()

    def catchup(self, peer: str) -> None:
        with self._lock:
            since = self.cursor
        try:
            resp = self.node.transport.call(
                peer, "conf.catchup", from_node=self.node.name,
                since=since)
        except TransportError:
            return
        if resp.get("snapshot") is not None:
            # the peer compacted past our cursor: individual replay is
            # impossible, adopt its state wholesale
            self._adopt(resp["snapshot"])
            return
        with self._lock:
            for e in resp.get("entries", ()):
                self.log[e["tnx_id"]] = e
                self.max_seen = max(self.max_seen, e["tnx_id"])
        self._drain()

    def tick(self) -> None:
        """Housekeeping: retry a stalled apply, pull missing entries,
        prune the applied tail."""
        with self._lock:
            if not self._was_coordinator or \
                    self.coordinator() != self.node.name:
                self._was_coordinator = False
            stalled = self.failed is not None
            behind = self.cursor < self.max_seen
            gap = behind and self.log.get(self.cursor + 1) is None
        if stalled:
            with self._lock:
                self.failed = None       # retry from the stalled entry
            self._drain()
        elif gap:
            # a lost commit cast left a hole; re-pull from the
            # coordinator (or whoever has the tail)
            leader = self.coordinator()
            if leader is not None and leader != self.node.name:
                self.catchup(leader)
        elif behind:
            self._drain()
        self.prune()

    def prune(self) -> None:
        """Compact applied entries beyond the KEEP window (bounded
        memory + bounded bootstrap size; peers further behind than the
        window adopt a snapshot instead of replaying)."""
        with self._lock:
            floor = self.cursor - self.KEEP
            if floor > self.compacted_to:
                for i in range(self.compacted_to + 1, floor + 1):
                    self.log.pop(i, None)
                self.compacted_to = floor

    # -- operator escape hatches (emqx_cluster_rpc.erl:26-44) ---------------

    def skip_failed_commit(self) -> int:
        """Advance past a poison entry WITHOUT applying it; returns the
        new cursor."""
        with self._lock:
            if self.failed is not None:
                self.cursor = max(self.cursor, self.failed["tnx_id"])
                self.failed = None
        self._drain()
        with self._lock:
            return self.cursor

    def fast_forward_to_commit(self, tnx_id: int) -> int:
        """Jump the cursor to ``tnx_id`` (entries in between are NOT
        applied — operator asserts the node state already matches)."""
        with self._lock:
            self.cursor = max(self.cursor, min(tnx_id, self.max_seen))
            self.failed = None
        self._drain()
        with self._lock:
            return self.cursor

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {"node": self.node.name, "role": self.node.role,
                    "tnx_id": self.cursor, "max_seen": self.max_seen,
                    "coordinator": self.coordinator(),
                    "failed": dict(self.failed) if self.failed else None}

    def cluster_status(self) -> list[dict]:
        """This node's view + every live peer's (mgmt/CLI surface)."""
        out = [self.status()]
        for peer in self.node.alive_peers():
            try:
                out.append(self.node.transport.call(
                    peer, "conf.status", from_node=self.node.name))
            except TransportError:
                pass
        return out

    # -- transport handlers --------------------------------------------------

    def h_append(self, from_node: str, kind: str, path: list,
                 value: Any) -> dict:
        if self.coordinator() != self.node.name:
            return {"error": f"not the coordinator "
                             f"(coordinator={self.coordinator()})"}
        try:
            entry = self._append(kind, path, value)
        except ClusterConfRejected as e:
            return {"error": str(e), "rejected": True}
        except ClusterConfError as e:
            return {"error": str(e)}
        return {"entry": entry}

    def h_commit(self, from_node: str, entry: dict) -> None:
        self._ingest(entry, from_node)

    def h_catchup(self, from_node: str, since: int) -> dict:
        with self._lock:
            if since < self.compacted_to:
                pass                     # snapshot path (outside lock)
            else:
                return {"entries": [self.log[i] for i in sorted(self.log)
                                    if i > since]}
        return {"snapshot": self.snapshot()}

    def h_status(self, from_node: str) -> dict:
        return self.status()

    # -- snapshot integration (catch-up on join, autoheal on re-merge) ------

    def snapshot(self) -> dict:
        conf = getattr(self.node.app, "config", None)
        with self._lock:
            return {"log": [self.log[i] for i in sorted(self.log)],
                    "compacted_to": self.compacted_to,
                    "cursor": self.cursor,
                    "override": (conf.overrides()[0]
                                 if conf is not None else {})}

    def apply_snapshot(self, snap: dict, from_node: str = "") -> None:
        entries = list(snap.get("log", ()))
        with self._lock:
            conflicting = [
                e for e in entries
                if self.log.get(e["tnx_id"]) is not None
                and self.log[e["tnx_id"]] != e]
            mine = (self.log[conflicting[0]["tnx_id"]]
                    if conflicting else None)
            behind_compaction = snap.get("compacted_to", 0) > self.cursor
        if conflicting:
            # split-brain re-merge: same tnx_id, different content on the
            # two sides. The tie-break compares the CONFLICTING ENTRIES'
            # committing coordinators (not the snapshot sender — a node
            # can receive the winning log from any peer of the other
            # side): lower coordinator name wins, so every node on both
            # sides reaches the same verdict. The losing side adopts log
            # + override wholesale and its partition-era writes are
            # discarded (ekka autoheal restarts the minority — same
            # outcome)
            theirs_coord = conflicting[0].get("coord", from_node)
            mine_coord = mine.get("coord", self.node.name)
            if theirs_coord < mine_coord:
                self._adopt(snap)
            return                       # else: the peer adopts ours
        if behind_compaction:
            # the peer pruned past our cursor — entry-by-entry replay is
            # impossible; adopt its state (fresh joiner far behind)
            self._adopt(snap)
            return
        with self._lock:
            for e in entries:
                self.log[e["tnx_id"]] = e
                self.max_seen = max(self.max_seen, e["tnx_id"])
        self._drain()

    def _adopt(self, snap: dict) -> None:
        conf = getattr(self.node.app, "config", None)
        with self._lock:
            self.log = {e["tnx_id"]: e for e in snap.get("log", ())}
            self.max_seen = max(self.log) if self.log else \
                snap.get("compacted_to", 0)
            # the adopted override reflects the sender's APPLIED prefix
            # (its cursor), not its whole log — a stalled sender may
            # carry queued entries its override doesn't include yet; set
            # our cursor to the sender's and drain the tail normally
            self.cursor = snap.get("cursor", self.max_seen)
            self.compacted_to = snap.get("compacted_to", 0)
            self.failed = None
            if conf is not None:
                conf.adopt_cluster_override(snap.get("override", {}))
        self._drain()
