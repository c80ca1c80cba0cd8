"""Cluster transports.

``Transport`` carries method calls between named nodes:

- ``call(node, method, kwargs)``  → result (sync RPC; the Erlang-dist /
  gen_rpc sync slot)
- ``cast(node, method, kwargs)``  → fire-and-forget, per-peer ordered
  (gen_rpc async with per-topic-key ordering: one ordered lane per peer;
  TCP framing preserves order, LocalBus is synchronous)

Implementations:

- ``LocalBus`` — in-process registry; the multi-node-on-one-host test
  harness (the reference's ct_slave peer-node pattern, SURVEY.md §4.3,
  without separate processes).
- ``TcpTransport`` — asyncio TCP, 4-byte-length-prefixed codec frames,
  lazy per-peer connections, request/response correlation ids. The DCN
  path; one connection per peer keeps the forwarding lane ordered.
"""

from __future__ import annotations

import asyncio
import struct
import threading
from collections import deque
from typing import Any, Callable, Optional

from emqx_tpu_torch.cluster import codec

Handler = Callable[..., Any]   # handler(**kwargs) -> result


class TransportError(ConnectionError):
    pass


class Transport:
    def __init__(self, node: str) -> None:
        self.node = node
        self._handlers: dict[str, Handler] = {}

    def register(self, method: str, fn: Handler) -> None:
        self._handlers[method] = fn

    def _dispatch(self, method: str, kwargs: dict) -> Any:
        fn = self._handlers.get(method)
        if fn is None:
            raise TransportError(f"{self.node}: no handler for {method!r}")
        return fn(**kwargs)

    def call(self, to: str, method: str, **kwargs: Any) -> Any:
        raise NotImplementedError

    def cast(self, to: str, method: str, _key: Any = None,
             **kwargs: Any) -> None:
        """Fire-and-forget. ``_key`` (gen_rpc's per-{Key,Node} client
        pools, emqx_rpc.erl:79-84) pins all casts sharing a key to ONE
        ordered lane to the peer; different keys may ride parallel
        lanes. None = the default lane."""
        raise NotImplementedError

    def peers(self) -> list[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalBus(Transport):
    """All nodes in one process; calls are direct function invocations
    (still passed through the codec so anything that would not survive a
    real wire fails loudly in tests)."""

    class Fabric:
        def __init__(self) -> None:
            self.nodes: dict[str, "LocalBus"] = {}
            self.partitions: set[frozenset] = set()

        def partition(self, a: str, b: str) -> None:
            """Cut the link a↔b (net-split injection)."""
            self.partitions.add(frozenset((a, b)))

        def heal(self, a: str, b: str) -> None:
            self.partitions.discard(frozenset((a, b)))

    def __init__(self, node: str, fabric: "LocalBus.Fabric") -> None:
        super().__init__(node)
        self.fabric = fabric
        fabric.nodes[node] = self

    def _peer(self, node: str) -> "LocalBus":
        if frozenset((self.node, node)) in self.fabric.partitions:
            raise TransportError(f"partitioned from {node}")
        peer = self.fabric.nodes.get(node)
        if peer is None:
            raise TransportError(f"unknown node {node}")
        return peer

    def call(self, to: str, method: str, **kwargs: Any) -> Any:
        peer = self._peer(to)
        wire = codec.decode(codec.encode(kwargs))
        return codec.decode(codec.encode(peer._dispatch(method, wire)))

    def cast(self, to: str, method: str, _key: Any = None,
             **kwargs: Any) -> None:
        self.call(to, method, **kwargs)     # in-process: always ordered

    def peers(self) -> list[str]:
        return [n for n in self.fabric.nodes if n != self.node]

    def close(self) -> None:
        self.fabric.nodes.pop(self.node, None)


class TcpTransport(Transport):
    """Length-prefixed frames over N_LANES TCP connections per peer.

    Runs its own event loop in a daemon thread so the synchronous
    call/cast surface works from broker code. Frame = 4-byte BE length +
    codec.encode({id, kind: req|resp|cast, method, kwargs | result |
    error}).

    Lanes are the gen_rpc client-pool analogue (emqx_rpc.erl:74-84,
    ?DefaultClientNum): casts carrying the same ``_key`` (the topic, at
    the forwarding call sites) always take the same connection — TCP
    framing plus the server's sequential per-connection dispatch keep
    per-key order — while different keys spread across lanes and are
    processed in parallel on the peer. Lane 0 carries calls and keyless
    casts.
    """

    N_LANES = 4

    def __init__(self, node: str, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        super().__init__(node)
        self.host, self.port = host, port
        self._peer_addrs: dict[str, tuple[str, int]] = {}
        self._writers: dict[tuple[str, int], asyncio.StreamWriter] = {}
        self._conn_futs: dict[tuple[str, int], asyncio.Future] = {}
        self._futures: dict[int, asyncio.Future] = {}
        self._req_id = 0
        # per-lane cast FIFOs + their pump tasks: casts are written to
        # the socket strictly in enqueue order (see cast() for why a
        # bare write-after-await cannot keep that promise)
        self._cast_bufs: dict[tuple[str, int], deque] = {}
        self._cast_pumps: dict[tuple[str, int], asyncio.Task] = {}
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True,
            name=f"cluster-{node}")
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._start(), self._loop)
        fut.result(timeout=10)

    async def _start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    def add_peer(self, node: str, host: str, port: int) -> None:
        self._peer_addrs[node] = (host, port)

    # -- framing ------------------------------------------------------------

    @staticmethod
    async def _read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
        try:
            head = await reader.readexactly(4)
            (ln,) = struct.unpack(">I", head)
            return codec.decode(await reader.readexactly(ln))
        except (asyncio.IncompleteReadError, ConnectionError):
            return None

    @staticmethod
    def _frame(obj: dict) -> bytes:
        body = codec.encode(obj)
        return struct.pack(">I", len(body)) + body

    # -- server side --------------------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        while True:
            msg = await self._read_frame(reader)
            if msg is None:
                break
            kind = msg.get("kind")
            if kind in ("req", "cast"):
                # handlers run on executor threads, NOT the loop thread:
                # a handler may itself issue blocking transport.call()s
                # (bootstrap-from-handler paths) which schedule onto this
                # loop — running them inline would deadlock it. Awaiting
                # the executor future keeps per-connection frame order.
                try:
                    result = await self._loop.run_in_executor(
                        None, lambda m=msg: self._dispatch(
                            m["method"], m.get("kwargs") or {}))
                    err = None
                except Exception as e:          # noqa: BLE001 — relay error
                    result, err = None, f"{type(e).__name__}: {e}"
                if kind == "req":
                    writer.write(self._frame({
                        "id": msg["id"], "kind": "resp",
                        "result": result, "error": err}))
                    await writer.drain()
            elif kind == "resp":
                fut = self._futures.pop(msg["id"], None)
                if fut is not None and not fut.done():
                    if msg.get("error"):
                        fut.set_exception(TransportError(msg["error"]))
                    else:
                        fut.set_result(msg.get("result"))
        writer.close()

    # -- client side --------------------------------------------------------

    async def _open_lane(self, node: str, lane: int) -> asyncio.StreamWriter:
        addr = self._peer_addrs.get(node)
        if addr is None:
            raise TransportError(f"unknown node {node}")
        reader, writer = await asyncio.open_connection(*addr)
        self._writers[(node, lane)] = writer
        # responses to our requests come back on this same connection
        asyncio.ensure_future(self._on_conn(reader, writer))
        return writer

    async def _get_writer(self, node: str,
                          lane: int = 0) -> asyncio.StreamWriter:
        # single connect future per (node, lane): a burst of same-key
        # casts before the lane exists must all await ONE connection —
        # racing opens would split the lane across sockets and break the
        # per-key ordering the lane exists to provide
        key = (node, lane)
        fut = self._conn_futs.get(key)
        if fut is None or (fut.done() and (
                fut.exception() is not None
                or fut.result().is_closing())):
            fut = self._conn_futs[key] = self._loop.create_task(
                self._open_lane(node, lane))
        return await asyncio.shield(fut)

    @classmethod
    def _lane_for(cls, key: Any) -> int:
        if key is None:
            return 0
        import zlib
        return 1 + zlib.crc32(str(key).encode()) % max(1, cls.N_LANES - 1)

    async def _send(self, node: str, obj: dict, lane: int = 0) -> None:
        writer = await self._get_writer(node, lane)
        writer.write(self._frame(obj))
        await writer.drain()

    async def _call_async(self, node: str, method: str,
                          kwargs: dict, timeout: float) -> Any:
        self._req_id += 1
        rid = self._req_id
        fut: asyncio.Future = self._loop.create_future()
        self._futures[rid] = fut
        await self._send(node, {"id": rid, "kind": "req",
                                "method": method, "kwargs": kwargs})
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._futures.pop(rid, None)

    def call(self, to: str, method: str, *, _timeout: float = 10.0,
             **kwargs: Any) -> Any:
        fut = asyncio.run_coroutine_threadsafe(
            self._call_async(to, method, kwargs, _timeout), self._loop)
        try:
            return fut.result(timeout=_timeout + 1)
        except (ConnectionError, OSError, asyncio.TimeoutError,
                TimeoutError) as e:
            raise TransportError(f"call {method} to {to}: {e}") from e

    def cast(self, to: str, method: str, _key: Any = None,
             **kwargs: Any) -> None:
        # Enqueue-then-pump, NOT write-after-await: a coroutine that
        # awaits the lane's connect future resumes via the event-loop
        # callback queue (two hops), while a cast issued just AFTER the
        # connect completed awaits an already-done future and writes
        # immediately (zero hops) — overtaking every cast still parked
        # on its wakeup. The deflaked per-key ordering contract (the
        # gen_rpc client-pool guarantee) therefore pins the ORDER at
        # enqueue time: the frame is appended to the lane's FIFO as the
        # pump task's first synchronous step, and one pump per lane
        # drains it in order.
        lane = self._lane_for(_key)
        frame = self._frame({"id": 0, "kind": "cast",
                             "method": method, "kwargs": kwargs})
        key = (to, lane)

        def _enq():
            self._cast_bufs.setdefault(key, deque()).append(frame)
            t = self._cast_pumps.get(key)
            if t is None or t.done():
                self._cast_pumps[key] = self._loop.create_task(
                    self._pump_casts(key))
        # call_soon_threadsafe preserves submission order per caller
        # thread, so enqueue order == cast order
        self._loop.call_soon_threadsafe(_enq)

    async def _pump_casts(self, key: tuple) -> None:
        node, lane = key
        q = self._cast_bufs[key]
        while q:
            frame = q.popleft()
            try:
                writer = await self._get_writer(node, lane)
                writer.write(frame)
                await writer.drain()
            except (ConnectionError, OSError):
                # only THIS frame drops (async-mode semantics, same as
                # the old per-cast _send): the next frame re-dials via
                # _get_writer — clearing the whole queue here would
                # silently discard every queued broadcast on a one-frame
                # transient (e.g. a shared-membership delta after a
                # peer restart)
                continue
        # a cast appended after the final `while q` check sees the task
        # done() and spawns a fresh pump — both run on the loop thread,
        # so the check/append interleaving cannot lose a frame

    def flush_casts(self, timeout: float = 10.0) -> None:
        """Barrier: block until every queued cast has been written AND
        drained to its socket (the deterministic settle the lane tests
        need — the bytes are on the wire; the peer's per-connection
        sequential dispatch does the rest in order)."""
        async def _wait():
            while (any(self._cast_bufs.values())
                   or any(not t.done()
                          for t in self._cast_pumps.values())):
                await asyncio.sleep(0.001)
        fut = asyncio.run_coroutine_threadsafe(_wait(), self._loop)
        try:
            fut.result(timeout)
        except BaseException:
            # a timed-out (or interrupted) barrier must not leave the
            # 1ms poll coroutine spinning on the loop forever
            fut.cancel()
            raise

    def peers(self) -> list[str]:
        return list(self._peer_addrs)

    def close(self) -> None:
        async def shutdown():
            for t in self._cast_pumps.values():
                t.cancel()
            for w in self._writers.values():
                w.close()
            self._server.close()
        asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(5)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
