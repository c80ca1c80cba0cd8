"""Connection/session manager — parity with ``apps/emqx/src/emqx_cm.erl``.

Registry of clientid → live channel, session open with clean-start /
resume semantics, takeover/discard/kick (emqx_cm.erl:268-341, :377-429,
:433-560). The reference's per-clientid distributed lock (emqx_cm_locker)
maps to a per-clientid threading lock here; the cross-node legs ride the
cluster plane's versioned protos once connected.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from emqx_tpu_torch.observe import trace as _tracing
from emqx_tpu_torch.session.session import Session


class CM:
    def __init__(self, persistence: Any = None) -> None:
        self._channels: dict[str, Any] = {}     # clientid -> Channel
        self._locks: dict[str, threading.Lock] = {}
        self._glock = threading.Lock()
        # optional PersistentSessions service: the restart-surviving tier
        # behind the in-memory disconnected-channel state (emqx_cm checks
        # emqx_persistent_session on resume with no live channel)
        self.persistence = persistence

    def _lock_for(self, clientid: str) -> threading.Lock:
        with self._glock:
            return self._locks.setdefault(clientid, threading.Lock())

    def _wire_settle(self, clientid: str, session: Session) -> None:
        """Wire the session's delivery-settlement observer to the
        persistence layer (consume-on-ack): a store replay
        marker is spent when the delivery SETTLES — subscriber ack,
        effective-qos0 write, or a final drop — never at delivery-write
        time, so a conn that dies between the socket write and the
        PUBACK keeps its marker and restart resume retransmits."""
        if self.persistence is not None and session is not None:
            session.settle_fn = (
                lambda mid, _sid=clientid:
                self.persistence.settle(_sid, mid))

    def lookup_channel(self, clientid: str) -> Optional[Any]:
        return self._channels.get(clientid)

    def register_channel(self, clientid: str, channel: Any) -> None:
        self._channels[clientid] = channel

    def unregister_channel(self, clientid: str, channel: Any = None) -> None:
        cur = self._channels.get(clientid)
        if channel is None or cur is channel:
            self._channels.pop(clientid, None)

    def all_channels(self) -> list[tuple[str, Any]]:
        return list(self._channels.items())

    def open_session(
        self, clean_start: bool, clientid: str, new_channel: Any,
        session_opts: Optional[dict] = None,
    ) -> tuple[Session, bool, list]:
        """Returns (session, session_present, pending_messages).

        clean_start=True  → discard any live channel + fresh session
        clean_start=False → takeover: old channel yields its session and
                            pending messages, then dies (2-phase:
                            emqx_cm.erl takeover_session)
        """
        with self._lock_for(clientid):
            old = self._channels.get(clientid)
            if clean_start:
                if old is not None and old is not new_channel:
                    old.discard()                     # kicked (RC 0x8E)
                elif self.persistence is not None:
                    # no live channel, but a clean start still wipes any
                    # stored session state (MQTT5 3.1.2.4)
                    self.persistence.discard(clientid)
                session = Session(
                    clientid=clientid, clean_start=True,
                    **(session_opts or {}),
                )
                self._wire_settle(clientid, session)
                self._channels[clientid] = new_channel
                return session, False, []
            # resume path
            if old is not None and old is not new_channel:
                session, pending = old.takeover()
                self._channels[clientid] = new_channel
                if session is not None:
                    session.clean_start = False
                    self._wire_settle(clientid, session)
                    if (self.persistence is not None
                            and self.persistence.lookup(clientid)
                            is not None):
                        # consume the stored markers too, or a later node
                        # restart replays messages this takeover already
                        # delivered; merge any the in-memory queue dropped
                        _subs, stored = self.persistence.resume(clientid)
                        seen = {m.id for m in pending}
                        pending = pending + [
                            m for m in stored if m.id not in seen
                        ]
                    return session, True, pending
            self._channels[clientid] = new_channel
            session = Session(
                clientid=clientid, clean_start=False,
                **(session_opts or {}),
            )
            self._wire_settle(clientid, session)
            # restart-resume: no live channel — replay from the store
            # (emqx_persistent_session:resume, :275-310)
            if (self.persistence is not None
                    and self.persistence.lookup(clientid) is not None):
                subs, pending = self.persistence.resume(clientid)
                session.subscriptions.update(subs)
                return session, True, pending
            return session, False, []

    def dispatch(self, deliveries: dict[str, list]) -> None:
        """Fan broker deliveries out to each target channel's socket.

        Inside a traced pipeline batch's delivery
        (``observe.trace.active_batch``) the call is the batch's
        ``cm.dispatch`` span, over the sessions it reached."""
        from emqx_tpu_torch.core.message import now_ms

        trace = _tracing.active_batch()
        if trace:
            t0 = _tracing.now_ns()
        begin = now_ms()
        for sid, items in deliveries.items():
            # deliver-begin stamp (emqx_session.erl:908 mark_begin_deliver):
            # slow-subs latency measures dispatch→flush, not storage age —
            # retained/delayed messages would otherwise report their shelf
            # time as delivery latency. Unconditional: a replay of a stored
            # message (retainer keeps a copy sharing this extra dict) is a
            # NEW delivery and must restamp.
            for _st, m in items:
                m.extra["deliver_begin_at"] = begin
            ch = self._channels.get(sid)
            if ch is not None:
                # marker consumption moved to the SETTLE seam (round
                # 18): the session spends each marker when the delivery
                # settles — subscriber ack / effective-qos0 write /
                # final drop — never here at delivery-write time, so a
                # conn death before the ack keeps the replay marker
                ch.send(ch.handle_deliver(items))
        if trace:
            trace.span("cm.dispatch", t0, _tracing.now_ns(), len(deliveries))

    def kick(self, clientid: str) -> bool:
        """Administrative kick (emqx_cm:kick_session)."""
        with self._lock_for(clientid):
            ch = self._channels.pop(clientid, None)
            if ch is None:
                return False
            ch.discard()
            return True
