"""Buffer worker — parity with
``apps/emqx_resource/src/emqx_resource_worker.erl``.

Sits between rule-engine actions and a ResourceManager: requests are
queued (RAM or disk via replayq — emqx_resource_worker.erl:17-18,164),
flushed in batches, retried with backoff while the resource is down,
and dropped past ``max_retries`` / on queue overflow. Counters mirror
the reference's buffer metrics (matched/success/failed/dropped/queuing).

Flush is explicit (``flush``/``tick``), driven by the app housekeeping
timer — the same role the reference's batch_time timer plays.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Optional

from emqx_tpu_torch.resource.resource import ResourceManager
from emqx_tpu_torch.utils.replayq import ReplayQ

log = logging.getLogger(__name__)


def _default_encode(req: Any) -> bytes:
    return json.dumps(req).encode()


def _default_decode(b: bytes) -> Any:
    return json.loads(b)


class BufferWorker:
    def __init__(
        self, manager: ResourceManager, *,
        batch_size: int = 16,
        batch_time_s: float = 0.02,
        max_retries: int = 3,
        retry_backoff_s: float = 1.0,
        queue_dir: Optional[str] = None,       # None → RAM queue
        max_queue_bytes: int = 64 * 1024 * 1024,
        encode: Callable[[Any], bytes] = _default_encode,
        decode: Callable[[bytes], Any] = _default_decode,
        on_result: Optional[Callable[[Any, Any], None]] = None,
        auto_flush: bool = False,
    ) -> None:
        self.manager = manager
        self.batch_size = batch_size
        self.batch_time_s = batch_time_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.encode, self.decode = encode, decode
        self.on_result = on_result             # fn(req, result) async replies
        self.q = ReplayQ(queue_dir, mem_only=queue_dir is None,
                         max_total_bytes=max_queue_bytes)
        self.metrics = {
            "matched": 0, "success": 0, "failed": 0,
            "dropped": 0, "retried": 0,
        }
        self._retries = 0
        self._next_flush_at = 0.0
        self._next_retry_at = 0.0
        # a flush can race between the event-loop thread (enqueue hits
        # batch_size inside a publish hook) and the housekeeping thread
        # (app.tick runs in to_thread): without this, both pop/ack the
        # same batch — duplicated sends + silently discarded requests
        self._lock = threading.RLock()
        # auto_flush: a dedicated flusher honours batch_time_s/batch_size
        # instead of waiting for the (much slower) app housekeeping tick.
        # Off by default so tests with simulated clocks stay deterministic.
        self._stop = threading.Event()
        self._wake = threading.Event()
        # paused: queue accepts but nothing flushes (disabled bridge keeps
        # its buffered data instead of burning retries into drops)
        self.paused = False
        self._flusher: Optional[threading.Thread] = None
        if auto_flush:
            self._flusher = threading.Thread(
                target=self._run_flusher, daemon=True,
                name=f"buffer-{manager.id}")
            self._flusher.start()

    # -- enqueue -------------------------------------------------------------

    def enqueue(self, req: Any, now: Optional[float] = None) -> bool:
        with self._lock:
            now = time.monotonic() if now is None else now
            self.metrics["matched"] += 1
            before = self.q.dropped
            self.q.append([self.encode(req)])
            if self.q.dropped > before:
                self.metrics["dropped"] += 1
                return False
            if self._next_flush_at == 0.0:
                self._next_flush_at = now + self.batch_time_s
            # NOTE: no inline flush here even at batch_size — enqueue is
            # called from publish hooks on the event-loop thread, and a
            # flush does blocking network I/O. The flusher thread (or the
            # housekeeping tick) does the I/O; a full batch just wakes it.
            if self._flusher is not None and self.q.count() >= self.batch_size:
                self._wake.set()
            return True

    def queuing(self) -> int:
        return self.q.count()

    # -- flush ---------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        if self.paused:
            return
        with self._lock:
            now = time.monotonic() if now is None else now
            if self.q.count() and (
                    self.q.count() >= self.batch_size
                    or now >= self._next_flush_at
            ) and now >= self._next_retry_at:
                self.flush(now)

    def _run_flusher(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.batch_time_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.tick()
            except Exception:
                log.exception("buffer %s flusher", self.manager.id)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2)
            self._flusher = None

    def flush(self, now: Optional[float] = None) -> int:
        """Drain as many full/partial batches as the resource accepts;
        returns the number of requests completed."""
        with self._lock:
            now = time.monotonic() if now is None else now
            if now < self._next_retry_at:
                return 0
            done = 0
            while self.q.count():
                ref, raw = self.q.pop(self.batch_size)
                reqs = [self.decode(b) for b in raw]
                try:
                    results = self.manager.batch_query(reqs)
                except Exception as e:
                    self._retries += 1
                    self.metrics["retried"] += 1
                    if self._retries > self.max_retries:
                        # drop the poisoned batch, move on (reference's
                        # max_retries → reply {error, ...} and dequeue)
                        self.q.ack(ref)
                        self.metrics["failed"] += len(reqs)
                        self._retries = 0
                        log.warning(
                            "buffer %s dropped batch after retries: %s",
                            self.manager.id, e)
                        continue
                    self._next_retry_at = now + self.retry_backoff_s
                    return done
                self.q.ack(ref)
                self._retries = 0
                self.metrics["success"] += len(reqs)
                done += len(reqs)
                if self.on_result is not None:
                    for req, res in zip(reqs, results or [None] * len(reqs)):
                        self.on_result(req, res)
            self._next_flush_at = 0.0
            return done
