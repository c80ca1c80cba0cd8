"""In-flight window — parity with ``apps/emqx/src/emqx_inflight.erl``
(gb_tree keyed by packet id with a max window, :47-70): the QoS1/2
outbound messages awaiting PUBACK/PUBREC/PUBCOMP."""

from __future__ import annotations

from typing import Any, Iterator, Optional


class Inflight:
    """Ordered insert-time map with a max size (the receive window)."""

    def __init__(self, max_size: int = 32):
        self.max_size = max_size            # 0 = unlimited
        self._d: dict[int, Any] = {}        # insertion-ordered

    def is_full(self) -> bool:
        return self.max_size != 0 and len(self._d) >= self.max_size

    def is_empty(self) -> bool:
        return not self._d

    def contain(self, key: int) -> bool:
        return key in self._d

    def insert(self, key: int, value: Any) -> None:
        if key in self._d:
            raise KeyError(f"packet id {key} already in flight")
        self._d[key] = value

    def update(self, key: int, value: Any) -> None:
        if key not in self._d:
            raise KeyError(key)
        self._d[key] = value

    def delete(self, key: int) -> Optional[Any]:
        return self._d.pop(key, None)

    def lookup(self, key: int) -> Optional[Any]:
        return self._d.get(key)

    def peek_oldest(self) -> Optional[tuple[int, Any]]:
        for k, v in self._d.items():
            return k, v
        return None

    def items(self) -> Iterator[tuple[int, Any]]:
        return iter(list(self._d.items()))

    def values(self):
        return list(self._d.values())

    def __len__(self) -> int:
        return len(self._d)
