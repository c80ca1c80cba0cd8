"""Disk-backed FIFO queue with at-least-once ack — the ``replayq`` dep.

The reference buffers bridge traffic (emqx_resource_worker.erl:17-18,164)
and MQTT-bridge egress through replayq: a segmented on-disk log with an
ack pointer, so queued items survive restarts and are replayed after a
crash. Same contract here:

- ``append(items)``      durably appends binary items
- ``pop(n)``             returns ``(ack_ref, items)`` without consuming
- ``ack(ack_ref)``       commits consumption up to that point
- reopening a dir resumes from the last committed ack

Layout: ``<dir>/<segno>.seg`` files of length-prefixed records, plus
``<dir>/ack`` holding "segno itemidx" of the committed read position.
Segments roll at ``seg_bytes``; fully-acked segments are deleted.
Per-segment item counts are tracked in memory so an ack is pure
arithmetic + at most a few unlinks (no re-reading of segment files).
``mem_only=True`` keeps everything in RAM (the reference's
``mem_only`` mode) for tests and low-durability buffers.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Optional

_LEN = struct.Struct("<I")


class ReplayQ:
    def __init__(self, dir: Optional[str] = None, *, mem_only: bool = False,
                 seg_bytes: int = 4 * 1024 * 1024,
                 max_total_bytes: int = 0) -> None:
        self.mem_only = mem_only or dir is None
        self.seg_bytes = seg_bytes
        self.max_total_bytes = max_total_bytes     # 0 = unlimited
        self._lock = threading.RLock()
        self._items: list[bytes] = []     # unacked tail, in order
        self._bytes = 0
        self.dropped = 0
        if self.mem_only:
            self.dir = None
            return
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        # surviving segments in order: [segno, full_item_count]; the ack
        # index counts consumed items within the FIRST one
        self._segments: list[list[int]] = []
        self._ack_idx = 0
        self._load()

    # -- persistence ---------------------------------------------------------

    def _seg_path(self, segno: int) -> str:
        return os.path.join(self.dir, f"{segno:010d}.seg")

    def _load(self) -> None:
        ack_seg, ack_idx = 0, 0
        ack_path = os.path.join(self.dir, "ack")
        if os.path.exists(ack_path):
            with open(ack_path) as f:
                parts = f.read().split()
                if len(parts) == 2:
                    ack_seg, ack_idx = int(parts[0]), int(parts[1])
        segs = sorted(
            int(f[:-4]) for f in os.listdir(self.dir) if f.endswith(".seg")
        )
        self._write_seg = max(segs[-1] if segs else 0, ack_seg)
        for segno in segs:
            if segno < ack_seg:
                os.unlink(self._seg_path(segno))    # fully consumed
                continue
            items = self._read_seg(segno)
            skip = ack_idx if segno == ack_seg else 0
            self._segments.append([segno, len(items)])
            for item in items[skip:]:
                self._items.append(item)
                self._bytes += len(item)
        self._ack_idx = ack_idx if self._segments and \
            self._segments[0][0] == ack_seg else 0

    def _read_seg(self, segno: int) -> list[bytes]:
        out = []
        try:
            with open(self._seg_path(segno), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return out
        off = 0
        while off + 4 <= len(data):
            (n,) = _LEN.unpack_from(data, off)
            if off + 4 + n > len(data):
                break                              # torn tail write — drop
            out.append(data[off + 4:off + 4 + n])
            off += 4 + n
        return out

    def _append_disk(self, items: list[bytes]) -> None:
        path = self._seg_path(self._write_seg)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size >= self.seg_bytes:
            self._write_seg += 1
            path = self._seg_path(self._write_seg)
        with open(path, "ab") as f:
            for item in items:
                f.write(_LEN.pack(len(item)) + item)
            f.flush()
            os.fsync(f.fileno())
        if self._segments and self._segments[-1][0] == self._write_seg:
            self._segments[-1][1] += len(items)
        else:
            self._segments.append([self._write_seg, len(items)])

    def _commit_ack(self) -> None:
        """Advance the persisted read position; unlink drained segments."""
        consumed = self._ack_idx
        while self._segments:
            segno, count = self._segments[0]
            if consumed >= count:
                consumed -= count
                try:
                    os.unlink(self._seg_path(segno))
                except OSError:
                    pass
                self._segments.pop(0)
            else:
                break
        self._ack_idx = consumed
        if self._segments:
            ack_seg = self._segments[0][0]
        else:
            # queue fully drained: future appends must start at/after the
            # ack point or reopen would discard them as consumed
            ack_seg = self._write_seg = self._write_seg + 1
        with open(os.path.join(self.dir, "ack"), "w") as f:
            f.write(f"{ack_seg} {self._ack_idx}")

    # -- queue API -----------------------------------------------------------

    def append(self, items: list[bytes]) -> int:
        """Append items; returns how many were accepted (overflow drops
        the *new* items, matching replayq's max_total_bytes policy)."""
        with self._lock:
            accepted = []
            for item in items:
                if (self.max_total_bytes
                        and self._bytes + len(item) > self.max_total_bytes):
                    self.dropped += 1
                    continue
                accepted.append(item)
                self._bytes += len(item)
            self._items.extend(accepted)
            if accepted and not self.mem_only:
                self._append_disk(accepted)
            return len(accepted)

    def pop(self, n: int = 1) -> tuple[int, list[bytes]]:
        """Peek the first n items. The ack_ref is the count to pass to
        ``ack`` once the items are safely handled."""
        with self._lock:
            items = self._items[:n]
            return len(items), list(items)

    def ack(self, ack_ref: int) -> None:
        with self._lock:
            done = self._items[:ack_ref]
            self._items = self._items[ack_ref:]
            self._bytes -= sum(len(i) for i in done)
            if not self.mem_only and ack_ref:
                self._ack_idx += ack_ref
                self._commit_ack()

    def count(self) -> int:
        with self._lock:
            return len(self._items)

    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def is_empty(self) -> bool:
        return self.count() == 0

    def close(self) -> None:
        pass
