"""Hook registry — parity with ``apps/emqx/src/emqx_hooks.erl``.

Named hookpoints hold priority-ordered callback chains; ``run`` executes
for side effects with stop semantics, ``run_fold`` threads an accumulator
(emqx_hooks.erl:156-193). Priorities sort descending, ties in insertion
order. A callback returns:

- ``None``               → continue (acc unchanged in run_fold)
- ``Hooks.STOP``         → stop the chain
- ``(Hooks.STOP, acc)``  → stop with new acc (run_fold)
- ``(Hooks.OK, acc)``    → continue with new acc (run_fold)

Standard hookpoints (emqx_hooks.hrl): client.connect/connack/connected/
disconnected/authenticate/authorize/subscribe/unsubscribe,
session.created/subscribed/unsubscribed/resumed/discarded/takenover/
terminated, message.publish/delivered/acked/dropped.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)


@dataclass
class _Callback:
    fn: Callable
    priority: int
    seq: int


class Hooks:
    STOP = object()
    OK = object()

    def __init__(self) -> None:
        self._hooks: dict[str, list[_Callback]] = {}
        self._seq = 0
        self._lock = threading.RLock()

    def add(self, name: str, fn: Callable, priority: int = 0) -> None:
        with self._lock:
            self._seq += 1
            chain = self._hooks.setdefault(name, [])
            if any(cb.fn is fn for cb in chain):
                return  # emqx_hooks:add is idempotent per callback
            chain.append(_Callback(fn, priority, self._seq))
            chain.sort(key=lambda cb: (-cb.priority, cb.seq))

    def put(self, name: str, fn: Callable, priority: int = 0) -> None:
        """add-or-replace (emqx_hooks:put)."""
        self.delete(name, fn)
        self.add(name, fn, priority)

    def delete(self, name: str, fn: Callable) -> None:
        with self._lock:
            chain = self._hooks.get(name)
            if chain:
                chain[:] = [cb for cb in chain if cb.fn is not fn]

    def run(self, name: str, args: tuple = ()) -> None:
        for cb in self._chain(name):
            try:
                ret = cb.fn(*args)
            except Exception:
                # a crashing callback must not break the chain or kill
                # the caller (emqx_hooks wraps every callback the same
                # way: log and continue)
                log.exception("hook %s callback %r crashed", name, cb.fn)
                continue
            if ret is Hooks.STOP:
                return

    # folds whose accumulator is a security verdict: a crashing callback
    # must abort the operation (fail closed), not fall through to the
    # permissive default accumulator
    FAIL_CLOSED = frozenset({"client.authenticate", "client.authorize"})

    def run_fold(self, name: str, args: tuple, acc: Any) -> Any:
        for cb in self._chain(name):
            try:
                ret = cb.fn(*args, acc)
            except Exception:
                log.exception("hook %s callback %r crashed", name, cb.fn)
                if name in self.FAIL_CLOSED:
                    raise
                continue
            if ret is None:
                continue
            if ret is Hooks.STOP:
                return acc
            if isinstance(ret, tuple) and len(ret) == 2:
                tag, acc2 = ret
                if tag is Hooks.STOP:
                    return acc2
                if tag is Hooks.OK:
                    acc = acc2
                    continue
            acc = ret  # plain value → new acc
        return acc

    def _chain(self, name: str) -> list[_Callback]:
        with self._lock:
            return list(self._hooks.get(name, ()))
