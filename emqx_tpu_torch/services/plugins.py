"""Runtime-installable plugins — ``apps/emqx_plugins/`` analogue.

The reference installs tarballs of BEAM apps described by a
``release.json`` and starts them in configured order
(emqx_plugins.erl:297 package discovery, ensure_installed/started).
Here a plugin is a directory ``<install_dir>/<name>-<vsn>/`` holding:

- ``release.json`` — {"name", "rel_vsn", "description", ...}
- ``plugin.py``    — a module exposing ``on_start(app)`` / ``on_stop(app)``
  (hooks are the extension surface, exactly like reference plugins that
  register emqx_hooks callbacks on app start).

Position-ordered start (``ensure_enabled(name, position)``), per-plugin
enable/disable persisted in the manager's state list.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Plugin:
    name_vsn: str                 # "<name>-<vsn>"
    dir: str
    info: dict = field(default_factory=dict)
    enabled: bool = False
    running: bool = False
    module: Any = None
    error: Optional[str] = None


class PluginManager:
    def __init__(self, app, install_dir: str) -> None:
        self.app = app
        self.install_dir = install_dir
        self.plugins: dict[str, Plugin] = {}
        self.order: list[str] = []            # start order
        self._lock = threading.RLock()

    # -- discovery / install -------------------------------------------------

    def _state_file(self) -> str:
        return os.path.join(self.install_dir, "plugins_state.json")

    def _save_state(self) -> None:
        """Persist enablement + order (the reference keeps this in the
        cluster config; we keep it beside the packages)."""
        try:
            with open(self._state_file(), "w", encoding="utf-8") as fh:
                json.dump({"states": [
                    {"name_vsn": n, "enabled": self.plugins[n].enabled}
                    for n in self.order if n in self.plugins
                ]}, fh)
        except OSError:
            pass

    def _load_state(self) -> None:
        try:
            with open(self._state_file(), "r", encoding="utf-8") as fh:
                states = json.load(fh).get("states", [])
        except (OSError, json.JSONDecodeError):
            return
        ordered = [s["name_vsn"] for s in states
                   if s["name_vsn"] in self.plugins]
        self.order = ordered + [n for n in self.order if n not in ordered]
        for s in states:
            p = self.plugins.get(s["name_vsn"])
            if p is not None:
                p.enabled = bool(s.get("enabled"))

    def scan(self) -> list[str]:
        """Discover installed packages (release.json probe, the
        emqx_plugins.erl:297 glob) and re-apply persisted enablement."""
        found = []
        if not os.path.isdir(self.install_dir):
            return found
        with self._lock:
            for entry in sorted(os.listdir(self.install_dir)):
                pdir = os.path.join(self.install_dir, entry)
                relf = os.path.join(pdir, "release.json")
                if not os.path.isfile(relf):
                    continue
                try:
                    with open(relf, "r", encoding="utf-8") as fh:
                        info = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    continue
                if entry not in self.plugins:
                    self.plugins[entry] = Plugin(entry, pdir, info)
                    self.order.append(entry)
                found.append(entry)
            self._load_state()
        return found

    def ensure_installed(self, name_vsn: str) -> Plugin:
        self.scan()
        p = self.plugins.get(name_vsn)
        if p is None:
            raise ValueError(f"plugin {name_vsn} not found in "
                             f"{self.install_dir}")
        return p

    # -- enable / start ------------------------------------------------------

    def ensure_enabled(self, name_vsn: str,
                       position: Optional[int] = None) -> None:
        with self._lock:
            p = self.ensure_installed(name_vsn)
            p.enabled = True
            if position is not None:
                self.order.remove(name_vsn)
                self.order.insert(position, name_vsn)
            self._save_state()

    def ensure_disabled(self, name_vsn: str) -> None:
        with self._lock:
            p = self.plugins.get(name_vsn)
            if p is not None:
                p.enabled = False
                self._save_state()

    def _load_module(self, p: Plugin):
        if p.module is not None:
            return p.module
        path = os.path.join(p.dir, "plugin.py")
        spec = importlib.util.spec_from_file_location(
            f"emqx_plugin_{p.name_vsn.replace('-', '_').replace('.', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        p.module = mod
        return mod

    def ensure_started(self, name_vsn: Optional[str] = None) -> None:
        """Start one plugin, or every enabled plugin in order."""
        with self._lock:
            self.scan()             # one rescan, then plain lookups
            if name_vsn is not None:
                if name_vsn not in self.plugins:
                    raise ValueError(
                        f"plugin {name_vsn} not found in {self.install_dir}")
                targets = [name_vsn]
            else:
                targets = [n for n in self.order
                           if self.plugins[n].enabled]
            for n in targets:
                p = self.plugins[n]
                if p.running:
                    continue
                try:
                    mod = self._load_module(p)
                    if hasattr(mod, "on_start"):
                        mod.on_start(self.app)
                    p.running, p.error = True, None
                except Exception as e:  # noqa: BLE001 — isolate plugins
                    p.error = f"{type(e).__name__}: {e}"

    def ensure_stopped(self, name_vsn: Optional[str] = None) -> None:
        with self._lock:
            targets = ([name_vsn] if name_vsn
                       else list(reversed(self.order)))
            for n in targets:
                p = self.plugins.get(n)
                if p is None or not p.running:
                    continue
                try:
                    if p.module is not None and hasattr(p.module, "on_stop"):
                        p.module.on_stop(self.app)
                except Exception:
                    pass
                p.running = False

    def restart(self, name_vsn: str) -> None:
        with self._lock:
            self.ensure_stopped(name_vsn)
            self.ensure_started(name_vsn)

    def ensure_uninstalled(self, name_vsn: str, purge: bool = True) -> bool:
        """Stop, forget, and (by default) delete the package directory —
        without the purge a later scan() would re-discover it."""
        with self._lock:
            if name_vsn not in self.plugins:
                return False
            self.ensure_stopped(name_vsn)
            p = self.plugins.pop(name_vsn)
            if name_vsn in self.order:
                self.order.remove(name_vsn)
            self._save_state()
            if purge:
                shutil.rmtree(p.dir, ignore_errors=True)
            return True

    # -- introspection -------------------------------------------------------

    def list(self) -> list[dict]:
        with self._lock:
            return [self.describe(n) for n in self.order
                    if n in self.plugins]

    def describe(self, name_vsn: str) -> dict:
        with self._lock:
            p = self.plugins.get(name_vsn)
            if p is None:
                # concurrent uninstall: surface as not-found, not a crash
                raise ValueError(f"plugin {name_vsn} not installed")
            return {
                "name_vsn": p.name_vsn,
                "description": p.info.get("description", ""),
                "enabled": p.enabled,
                "running": p.running,
                **({"error": p.error} if p.error else {}),
            }
