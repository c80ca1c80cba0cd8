"""HOCON-subset parser — the config file format
(reference dep ``hocon`` 0.34; files like ``etc/emqx.conf``).

Supported surface (what EMQX configs actually use):

- ``key = value`` / ``key: value``; dotted path keys ``a.b.c = 1``
- nested objects ``a { b = 1 }``; objects merge (later wins per leaf)
- arrays ``[1, 2, 3]`` incl. arrays of objects
- strings bare or quoted (single/double), triple-quoted blocks
- numbers, booleans, null; durations ``10s/5m/1h/100ms`` → seconds;
  byte sizes ``100MB/16KB/1GB`` → bytes; percentages ``80%`` → 0.8
- comments ``#`` and ``//``; trailing commas; ``include`` is NOT
  supported (single-file loads; the layering lives in ConfigStore)
- ``${path}`` substitutions resolved against the same document
"""

from __future__ import annotations

import re
from typing import Any, Optional

_DUR = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)$")
_SIZE = re.compile(r"^(\d+(?:\.\d+)?)(kb|mb|gb|b)$", re.IGNORECASE)
_PCT = re.compile(r"^(\d+(?:\.\d+)?)%$")
_NUM = re.compile(r"^-?\d+(\.\d+)?([eE][+-]?\d+)?$")

_DUR_MULT = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
_SIZE_MULT = {"b": 1, "kb": 1024, "mb": 1024**2, "gb": 1024**3}


class HoconError(ValueError):
    pass


class Duration(float):
    """Seconds, parsed from '10s'/'100ms' — distinct type so schema
    fields can require it."""


class ByteSize(int):
    """Bytes, parsed from '16KB'/'1GB'."""


def _convert_scalar(tok: str) -> Any:
    if tok == "true":
        return True
    if tok == "false":
        return False
    if tok in ("null", "undefined"):
        return None
    if _NUM.match(tok):
        return float(tok) if ("." in tok or "e" in tok or "E" in tok) \
            else int(tok)
    m = _DUR.match(tok)
    if m:
        return Duration(float(m.group(1)) * _DUR_MULT[m.group(2)])
    m = _SIZE.match(tok)
    if m:
        return ByteSize(int(float(m.group(1))
                        * _SIZE_MULT[m.group(2).lower()]))
    m = _PCT.match(tok)
    if m:
        return float(m.group(1)) / 100.0
    return tok                               # bare string


class _Parser:
    def __init__(self, text: str) -> None:
        self.s = text
        self.i = 0
        self.n = len(text)

    # -- low-level ----------------------------------------------------------

    def _ws(self, newlines: bool = True) -> None:
        while self.i < self.n:
            c = self.s[self.i]
            if c == "#" or self.s.startswith("//", self.i):
                while self.i < self.n and self.s[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.i += 1
            else:
                return

    def _peek(self) -> str:
        return self.s[self.i] if self.i < self.n else ""

    def _err(self, msg: str) -> HoconError:
        line = self.s.count("\n", 0, self.i) + 1
        return HoconError(f"line {line}: {msg}")

    # -- values -------------------------------------------------------------

    def parse_document(self) -> dict:
        self._ws()
        if self._peek() == "{":
            obj = self.parse_object()
        else:
            obj = self.parse_object_body(top=True)
        self._ws()
        if self.i < self.n:
            raise self._err(f"trailing content {self.s[self.i:self.i+10]!r}")
        return obj

    def parse_object(self) -> dict:
        assert self._peek() == "{"
        self.i += 1
        obj = self.parse_object_body(top=False)
        if self._peek() != "}":
            raise self._err("expected '}'")
        self.i += 1
        return obj

    def parse_object_body(self, top: bool) -> dict:
        obj: dict = {}
        while True:
            self._ws()
            if self.i >= self.n:
                if top:
                    return obj
                raise self._err("unexpected EOF in object")
            if self._peek() == "}":
                if top:
                    raise self._err("unexpected '}'")
                return obj
            if self._peek() == ",":
                self.i += 1
                continue
            key = self._parse_key()
            self._ws(newlines=False)
            c = self._peek()
            if c == "{":                      # 'a { ... }' implicit assign
                val = self.parse_object()
            elif c in "=:":
                self.i += 1
                self._ws(newlines=False)
                val = self.parse_value()
            else:
                raise self._err(f"expected '=' after key {key!r}")
            self._merge_path(obj, key.split("."), val)

    def _parse_key(self) -> str:
        if self._peek() in "\"'":
            return self._parse_quoted()
        j = self.i
        while self.i < self.n and (self.s[self.i].isalnum()
                                   or self.s[self.i] in "_.-$"):
            self.i += 1
        if j == self.i:
            raise self._err(f"bad key at {self.s[self.i:self.i+10]!r}")
        return self.s[j:self.i]

    def _parse_quoted(self) -> str:
        q = self.s[self.i]
        if self.s.startswith(q * 3, self.i):   # triple-quoted block
            end = self.s.find(q * 3, self.i + 3)
            if end < 0:
                raise self._err("unterminated triple-quoted string")
            out = self.s[self.i + 3:end]
            self.i = end + 3
            return out
        self.i += 1
        out = []
        while self.i < self.n:
            c = self.s[self.i]
            if c == "\\" and self.i + 1 < self.n:
                nxt = self.s[self.i + 1]
                out.append({"n": "\n", "t": "\t", "r": "\r"}.get(nxt, nxt))
                self.i += 2
                continue
            if c == q:
                self.i += 1
                return "".join(out)
            if c == "\n":
                raise self._err("newline in string")
            out.append(c)
            self.i += 1
        raise self._err("unterminated string")

    def parse_value(self) -> Any:
        c = self._peek()
        if not c:
            raise self._err("expected value, got EOF")
        if c == "{":
            return self.parse_object()
        if c == "[":
            return self._parse_array()
        if c in "\"'":
            return self._parse_quoted()
        if self.s.startswith("${", self.i):
            end = self.s.find("}", self.i)
            if end < 0:
                raise self._err("unterminated substitution")
            ref = self.s[self.i + 2:end]
            self.i = end + 1
            return _Subst(ref)
        # bare scalar: up to newline/comma/}/]/comment
        j = self.i
        while self.i < self.n and self.s[self.i] not in "\n,}]#":
            if self.s.startswith("//", self.i):
                break
            self.i += 1
        tok = self.s[j:self.i].strip()
        if not tok:
            raise self._err("empty value")
        return _convert_scalar(tok)

    def _parse_array(self) -> list:
        assert self._peek() == "["
        self.i += 1
        out = []
        while True:
            self._ws()
            if self._peek() == "]":
                self.i += 1
                return out
            if self._peek() == ",":
                self.i += 1
                continue
            out.append(self.parse_value())

    @staticmethod
    def _merge_path(obj: dict, path: list[str], val: Any) -> None:
        for k in path[:-1]:
            nxt = obj.get(k)
            if not isinstance(nxt, dict):
                nxt = obj[k] = {}
            obj = nxt
        k = path[-1]
        if isinstance(val, dict) and isinstance(obj.get(k), dict):
            deep_merge(obj[k], val)
        else:
            obj[k] = val


class _Subst:
    def __init__(self, ref: str) -> None:
        self.ref = ref


def deep_merge(base: dict, over: dict) -> dict:
    """Merge ``over`` into ``base`` in place; objects merge per-leaf,
    everything else (incl. arrays) replaces — HOCON semantics."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _resolve(node: Any, root: dict) -> Any:
    if isinstance(node, _Subst):
        cur: Any = root
        for part in node.ref.split("."):
            if not isinstance(cur, dict) or part not in cur:
                raise HoconError(f"unresolved substitution ${{{node.ref}}}")
            cur = cur[part]
        return _resolve(cur, root)
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    return node


def loads(text: str) -> dict:
    doc = _Parser(text).parse_document()
    return _resolve(doc, doc)


def load(path: str) -> dict:
    with open(path) as f:
        return loads(f.read())
