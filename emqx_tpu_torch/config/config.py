"""Layered config store — parity with
``apps/emqx/src/emqx_config.erl`` + ``emqx_config_handler.erl``.

Layers merge in the reference's order (emqx_config.erl:309-337):

    base file → cluster override → local override

then the merged raw conf is schema-checked and the *checked* tree is
held for lock-free reads (the reference parks it in ``persistent_term``;
here a plain dict reference swap — readers see either the old or the
new complete tree, never a partial write).

Runtime updates (``put``) go through per-path handlers
(emqx_config_handler): the deepest registered handler for the path may
validate/transform, the raw overlay is recorded in the chosen override
layer, the full tree re-checks, and only then does the swap happen —
a failing update leaves config untouched.

Zones (emqx_schema zones): named overlay dicts over the root ``mqtt``
section; ``get_zone_conf(zone, path)`` falls back to the global value.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

from emqx_tpu_torch.config import hocon
from emqx_tpu_torch.config.hocon import deep_merge
from emqx_tpu_torch.config.schema import Struct, root_schema

Path = tuple[str, ...]


def _path(p: "str | Path") -> Path:
    if isinstance(p, str):
        return tuple(k for k in p.split(".") if k)
    return tuple(p)


class ConfigError(ValueError):
    pass


class Config:
    def __init__(self, schema: Optional[Struct] = None) -> None:
        self.schema = schema or root_schema()
        self._base: dict = {}
        self._cluster_override: dict = {}
        self._local_override: dict = {}
        self._checked: dict = self.schema.check({})
        self._handlers: dict[Path, Callable] = {}
        self._listeners: list[Callable[[Path, Any], None]] = []
        # cluster seam: when a ClusterNode binds this config, cluster-layer
        # writes route through the replicated txn log (emqx_cluster_rpc);
        # signature: cluster_fn(kind, path_tuple, value) -> applied value
        self.cluster_fn: Optional[Callable] = None

    # -- load (emqx_config:init_load) ---------------------------------------

    def init_load(self, text: str = "",
                  cluster_override: Optional[dict] = None,
                  local_override: Optional[dict] = None) -> None:
        self._base = hocon.loads(text) if text else {}
        self._cluster_override = copy.deepcopy(cluster_override or {})
        self._local_override = copy.deepcopy(local_override or {})
        self._recheck()

    def load_file(self, path: str) -> None:
        with open(path) as f:
            self.init_load(f.read())

    def _merged_raw(self) -> dict:
        raw = copy.deepcopy(self._base)
        deep_merge(raw, copy.deepcopy(self._cluster_override))
        deep_merge(raw, copy.deepcopy(self._local_override))
        return raw

    def _recheck(self) -> None:
        self._checked = self.schema.check(self._merged_raw())

    # -- reads (emqx:get_config) --------------------------------------------

    def get(self, path: "str | Path" = (), default: Any = None) -> Any:
        cur: Any = self._checked
        for k in _path(path):
            if not isinstance(cur, dict) or k not in cur:
                return default
            cur = cur[k]
        return cur

    def get_raw(self, path: "str | Path" = (), default: Any = None) -> Any:
        cur: Any = self._merged_raw()
        for k in _path(path):
            if not isinstance(cur, dict) or k not in cur:
                return default
            cur = cur[k]
        return cur

    def get_zone_conf(self, zone: str, path: "str | Path",
                      default: Any = None) -> Any:
        """Zone override falling back to global (emqx_config:get_zone_conf).
        ``path`` is relative to the ``mqtt`` section."""
        p = _path(path)
        zones = self.get(("zones",), {}) or {}
        cur: Any = zones.get(zone)
        for k in p:
            if not isinstance(cur, dict) or k not in cur:
                cur = None
                break
            cur = cur[k]
        if cur is not None:
            return cur
        return self.get(("mqtt",) + p, default)

    # -- update handlers (emqx_config_handler) ------------------------------

    def add_handler(self, path: "str | Path",
                    handler: Callable[[Path, Any, dict], Any]) -> None:
        """handler(path, new_raw_value, old_checked_root) → value to
        store (may transform) or raise to reject."""
        self._handlers[_path(path)] = handler

    def add_listener(self, fn: Callable[[Path, Any], None]) -> None:
        """Post-commit notification (config change broadcast seam)."""
        self._listeners.append(fn)

    def _handler_for(self, path: Path) -> Optional[tuple[Path, Callable]]:
        # deepest matching prefix wins (emqx_config_handler walks up)
        for ln in range(len(path), -1, -1):
            h = self._handlers.get(path[:ln])
            if h is not None:
                return path[:ln], h
        return None

    # -- writes (emqx_config:update / emqx_conf:update) ---------------------

    def put(self, path: "str | Path", value: Any,
            layer: str = "cluster", local: bool = False) -> Any:
        """Runtime update: handler → overlay → recheck → swap → notify.
        Returns the new checked value at ``path``.

        With a cluster seam bound, cluster-layer writes become
        cluster-wide transactions (the reference's ``emqx_conf:update``
        → ``emqx_cluster_rpc:multicall``); ``local=True`` is the
        txn-apply path itself (and node-local maintenance)."""
        p = _path(path)
        if not p:
            raise ConfigError("empty update path")
        if self.cluster_fn is not None and layer == "cluster" and not local:
            return self.cluster_fn("put", p, value)
        found = self._handler_for(p)
        if found is not None:
            _hpath, handler = found
            value = handler(p, value, self._checked)
        over = (self._cluster_override if layer == "cluster"
                else self._local_override)
        node = over
        for k in p[:-1]:
            nxt = node.get(k)
            if not isinstance(nxt, dict):
                nxt = node[k] = {}
            node = nxt
        old = node.get(p[-1], "__missing__")
        node[p[-1]] = copy.deepcopy(value)
        try:
            self._recheck()
        except Exception:
            # roll the overlay back; config stays consistent
            if old == "__missing__":
                del node[p[-1]]
            else:
                node[p[-1]] = old
            raise
        new_val = self.get(p)
        for fn in self._listeners:
            fn(p, new_val)
        return new_val

    def remove(self, path: "str | Path", layer: str = "cluster",
               local: bool = False) -> None:
        p = _path(path)
        if self.cluster_fn is not None and layer == "cluster" and not local:
            self.cluster_fn("remove", p, None)
            return
        over = (self._cluster_override if layer == "cluster"
                else self._local_override)
        node: Any = over
        for k in p[:-1]:
            node = node.get(k)
            if not isinstance(node, dict):
                return
        node.pop(p[-1], None)
        self._recheck()
        for fn in self._listeners:
            fn(p, self.get(p))

    def adopt_cluster_override(self, raw: dict) -> None:
        """Replace the cluster override wholesale (split-brain re-merge:
        the autoheal loser adopts the winner's replicated layer)."""
        old = self._cluster_override
        self._cluster_override = copy.deepcopy(raw)
        try:
            self._recheck()
        except Exception:
            self._cluster_override = old
            self._recheck()
            raise
        # notify per affected top-level section: listeners dispatch on
        # path prefixes (e.g. BrokerApp._on_config_change), which an
        # empty path would never match
        for key in sorted(set(old) | set(raw)):
            for fn in self._listeners:
                fn((key,), self.get((key,)))

    # -- persistence of the override layers ---------------------------------

    def overrides(self) -> tuple[dict, dict]:
        """(cluster, local) — what the reference persists to
        ``cluster-override.conf`` / ``local-override.conf``."""
        return (copy.deepcopy(self._cluster_override),
                copy.deepcopy(self._local_override))
