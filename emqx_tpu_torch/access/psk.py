"""TLS-PSK identity table — ``apps/emqx_psk/`` analogue.

identity → pre-shared key (hex on disk, raw bytes in memory), with the
reference's bootstrap-file import format (``identity:psk-hex`` per line,
emqx_psk.erl). The lookup surface is the SSL server callback shape: a
TLS listener asks for the PSK bytes of an offered identity.
"""

from __future__ import annotations

import threading
from typing import Optional


class PskStore:
    def __init__(self, enable: bool = True,
                 init_file: Optional[str] = None,
                 separator: str = ":") -> None:
        self.enable = enable
        self.separator = separator
        self._table: dict[str, bytes] = {}
        self._lock = threading.RLock()
        if init_file:
            self.import_file(init_file)

    def import_file(self, path: str) -> int:
        """``identity:hex`` per line; blank lines/comments skipped.
        Returns the number of imported identities."""
        n = 0
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                ident, sep, hexkey = line.partition(self.separator)
                if not sep:
                    continue
                try:
                    self.insert(ident, bytes.fromhex(hexkey.strip()))
                    n += 1
                except ValueError:
                    continue
        return n

    def insert(self, identity: str, psk: bytes) -> None:
        with self._lock:
            self._table[identity] = psk

    def lookup(self, identity: str) -> Optional[bytes]:
        """The ssl psk_lookup callback: None → handshake rejected."""
        if not self.enable:
            return None
        return self._table.get(identity)

    def delete(self, identity: str) -> bool:
        with self._lock:
            return self._table.pop(identity, None) is not None

    def all(self) -> list[str]:
        return list(self._table)

    def __len__(self) -> int:
        return len(self._table)
