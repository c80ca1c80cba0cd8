"""Builtin SQL functions — parity with
``apps/emqx_rule_engine/src/emqx_rule_funcs.erl`` — 131 funcs covering
the math/bit/string/map/array/date/compression/hash/topic families, same
names/semantics.
"""

from __future__ import annotations

import base64
import gzip as _gzip
import hashlib
import json
import math
import re
import time
import uuid
import zlib
from typing import Any, Callable

FUNCS: dict[str, Callable] = {}


def f(name: str):
    def deco(fn):
        FUNCS[name] = fn
        return fn
    return deco


def _num(x) -> float:
    if isinstance(x, bool):
        return 1.0 if x else 0.0
    if isinstance(x, (int, float)):
        return x
    return float(x)


def _str(x) -> str:
    if isinstance(x, bytes):
        return x.decode(errors="replace")
    if isinstance(x, bool):
        return "true" if x else "false"
    if x is None:
        return ""
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


# -- math (emqx_rule_funcs math section) ----------------------------------

for _name in ("sin cos tan asin acos atan sinh cosh tanh log log10 log2 "
              "exp sqrt").split():
    FUNCS[_name] = (lambda fn: lambda x: fn(_num(x)))(
        getattr(math, _name if _name != "log2" else "log2"))
FUNCS["abs"] = lambda x: abs(_num(x))
FUNCS["ceil"] = lambda x: math.ceil(_num(x))
FUNCS["floor"] = lambda x: math.floor(_num(x))
FUNCS["round"] = lambda x: round(_num(x))
FUNCS["power"] = lambda x, y: math.pow(_num(x), _num(y))
FUNCS["fmod"] = lambda x, y: math.fmod(_num(x), _num(y))
FUNCS["random"] = lambda: __import__("random").random()
FUNCS["pi"] = lambda: math.pi

# -- type checks / conversion ---------------------------------------------

FUNCS["is_null"] = lambda x: x is None
FUNCS["is_not_null"] = lambda x: x is not None
FUNCS["is_num"] = lambda x: isinstance(x, (int, float)) \
    and not isinstance(x, bool)
FUNCS["is_int"] = lambda x: isinstance(x, int) and not isinstance(x, bool)
FUNCS["is_float"] = lambda x: isinstance(x, float)
FUNCS["is_str"] = lambda x: isinstance(x, str)
FUNCS["is_bool"] = lambda x: isinstance(x, bool)
FUNCS["is_map"] = lambda x: isinstance(x, dict)
FUNCS["is_array"] = lambda x: isinstance(x, list)
FUNCS["str"] = _str
FUNCS["str_utf8"] = _str
FUNCS["int"] = lambda x: int(_num(x))
FUNCS["float"] = lambda x: float(_num(x))
FUNCS["bool"] = lambda x: (x in (True, "true", 1))
FUNCS["num"] = _num


# -- strings ---------------------------------------------------------------

FUNCS["lower"] = lambda s: _str(s).lower()
FUNCS["upper"] = lambda s: _str(s).upper()
FUNCS["trim"] = lambda s: _str(s).strip()
FUNCS["ltrim"] = lambda s: _str(s).lstrip()
FUNCS["rtrim"] = lambda s: _str(s).rstrip()
FUNCS["reverse"] = lambda s: _str(s)[::-1]
FUNCS["strlen"] = lambda s: len(_str(s))
FUNCS["substr"] = lambda s, start, ln=None: (
    _str(s)[int(start):] if ln is None
    else _str(s)[int(start):int(start) + int(ln)])
FUNCS["split"] = lambda s, sep=",": [p for p in _str(s).split(_str(sep))
                                     if p != ""]
FUNCS["concat"] = lambda *xs: "".join(_str(x) for x in xs)
FUNCS["sprintf"] = lambda fmt, *xs: _str(fmt) % xs
FUNCS["pad"] = lambda s, ln, side="trailing", ch=" ": (
    _str(s).ljust(int(ln), ch) if side == "trailing"
    else _str(s).rjust(int(ln), ch))
FUNCS["replace"] = lambda s, old, new: _str(s).replace(_str(old), _str(new))
FUNCS["regex_match"] = lambda s, p: re.search(p, _str(s)) is not None
FUNCS["regex_replace"] = lambda s, p, r: re.sub(p, r, _str(s))
FUNCS["regex_extract"] = lambda s, p: (
    (m := re.search(p, _str(s))) and (m.group(1) if m.groups()
                                      else m.group(0)) or "")
FUNCS["ascii"] = lambda s: ord(_str(s)[0]) if _str(s) else None
FUNCS["find"] = lambda s, sub: (
    _str(s)[i:] if (i := _str(s).find(_str(sub))) >= 0 else "")
FUNCS["tokens"] = FUNCS["split"]
FUNCS["startswith"] = lambda s, p: _str(s).startswith(_str(p))
FUNCS["endswith"] = lambda s, p: _str(s).endswith(_str(p))


@f("like")
def _like(s, pattern):
    """SQL LIKE: % = any run, _ = one char."""
    rx = re.escape(_str(pattern)).replace("%", ".*").replace("_", ".")
    return re.fullmatch(rx, _str(s)) is not None


# -- maps / arrays ---------------------------------------------------------

FUNCS["map_get"] = lambda k, m, default=None: (
    m.get(_str(k), default) if isinstance(m, dict) else default)
FUNCS["map_put"] = lambda k, v, m: {**(m or {}), _str(k): v}
FUNCS["map_keys"] = lambda m: list((m or {}).keys())
FUNCS["map_values"] = lambda m: list((m or {}).values())
FUNCS["mget"] = FUNCS["map_get"]
FUNCS["mput"] = FUNCS["map_put"]
FUNCS["nth"] = lambda n, xs: (
    xs[int(n) - 1] if isinstance(xs, list) and 1 <= int(n) <= len(xs)
    else None)
FUNCS["length"] = lambda xs: len(xs)
FUNCS["sublist"] = lambda ln, xs: xs[:int(ln)]
FUNCS["first"] = lambda xs: xs[0] if xs else None
FUNCS["last"] = lambda xs: xs[-1] if xs else None
FUNCS["contains"] = lambda x, xs: x in xs
FUNCS["range"] = lambda a, b: list(range(int(a), int(b) + 1))


# -- json / binary ---------------------------------------------------------

FUNCS["json_encode"] = lambda x: json.dumps(x, separators=(",", ":"))
FUNCS["json_decode"] = lambda s: json.loads(
    s if isinstance(s, (str, bytes)) else _str(s))
FUNCS["base64_encode"] = lambda b: base64.b64encode(
    b if isinstance(b, bytes) else _str(b).encode()).decode()
FUNCS["base64_decode"] = lambda s: base64.b64decode(_str(s))
FUNCS["bin2hexstr"] = lambda b: (
    b if isinstance(b, bytes) else _str(b).encode()).hex()
FUNCS["hexstr2bin"] = lambda s: bytes.fromhex(_str(s))
FUNCS["byteize"] = lambda x: x if isinstance(x, bytes) else _str(x).encode()
FUNCS["subbits"] = lambda b, ln: int.from_bytes(
    (b if isinstance(b, bytes) else _str(b).encode()), "big") \
    >> max(0, len(b) * 8 - int(ln))


# -- hashing / ids ---------------------------------------------------------

FUNCS["md5"] = lambda s: hashlib.md5(
    s if isinstance(s, bytes) else _str(s).encode()).hexdigest()
FUNCS["sha"] = lambda s: hashlib.sha1(
    s if isinstance(s, bytes) else _str(s).encode()).hexdigest()
FUNCS["sha256"] = lambda s: hashlib.sha256(
    s if isinstance(s, bytes) else _str(s).encode()).hexdigest()
FUNCS["crc32"] = lambda s: zlib.crc32(
    s if isinstance(s, bytes) else _str(s).encode())
FUNCS["uuid_v4"] = lambda: str(uuid.uuid4())


# -- time ------------------------------------------------------------------

FUNCS["now_timestamp"] = lambda unit="second": (
    int(time.time()) if unit == "second"
    else time.time_ns() // 1_000_000 if unit == "millisecond"
    else time.time_ns() // 1000 if unit == "microsecond"
    else time.time_ns())
FUNCS["now_rfc3339"] = lambda: time.strftime(
    "%Y-%m-%dT%H:%M:%S%z", time.localtime())
FUNCS["unix_ts_to_rfc3339"] = lambda ts, unit="second": time.strftime(
    "%Y-%m-%dT%H:%M:%S%z", time.localtime(
        _num(ts) / {"second": 1, "millisecond": 1000,
                    "microsecond": 1e6}.get(unit, 1)))
FUNCS["timezone_to_second"] = lambda tz: int(_num(tz))


# -- mqtt ------------------------------------------------------------------

@f("topic")
def _topic_join(*words):
    return "/".join(_str(w) for w in words)


@f("nth_topic_level")
def _nth_topic_level(n, topic):
    parts = _str(topic).split("/")
    n = int(n)
    return parts[n - 1] if 1 <= n <= len(parts) else None


FUNCS["term_to_binary"] = lambda x: json.dumps(x).encode()
FUNCS["binary_to_term"] = lambda b: json.loads(b)


# -- bit / binary ops (emqx_rule_funcs.erl bit* family) --------------------

FUNCS["bitand"] = lambda x, y: int(_num(x)) & int(_num(y))
FUNCS["bitor"] = lambda x, y: int(_num(x)) | int(_num(y))
FUNCS["bitxor"] = lambda x, y: int(_num(x)) ^ int(_num(y))
FUNCS["bitnot"] = lambda x: ~int(_num(x))
FUNCS["bitsl"] = lambda x, n: int(_num(x)) << int(_num(n))
FUNCS["bitsr"] = lambda x, n: int(_num(x)) >> int(_num(n))
FUNCS["bitsize"] = lambda b: len(b) * 8 if isinstance(b, (bytes, bytearray)) \
    else len(_str(b).encode()) * 8
FUNCS["mod"] = lambda x, y: int(_num(x)) % int(_num(y))
FUNCS["eq"] = lambda x, y: x == y


@f("subbits")
def _subbits(b, start_or_len, ln=None):
    """subbits(Bytes, Len) / subbits(Bytes, Start, Len) — big-endian
    unsigned int of the selected bit range (1-based start)."""
    data = b if isinstance(b, (bytes, bytearray)) else _str(b).encode()
    val = int.from_bytes(data, "big")
    total = len(data) * 8
    if ln is None:
        start, ln = 1, int(_num(start_or_len))
    else:
        start, ln = int(_num(start_or_len)), int(_num(ln))
    if start < 1 or start + ln - 1 > total:
        return None
    return (val >> (total - (start - 1) - ln)) & ((1 << ln) - 1)


# -- inverse hyperbolics ----------------------------------------------------

FUNCS["acosh"] = lambda x: math.acosh(_num(x))
FUNCS["asinh"] = lambda x: math.asinh(_num(x))
FUNCS["atanh"] = lambda x: math.atanh(_num(x))
def _float2str(x, prec=10):
    s = f"{_num(x):.{int(prec)}f}"
    # only trim the fractional part — prec=0 must not eat integer zeros
    return s.rstrip("0").rstrip(".") if "." in s else s


FUNCS["float2str"] = _float2str


# -- compression / hashing / encoding ---------------------------------------

def _as_bytes(x):
    return x if isinstance(x, (bytes, bytearray)) else _str(x).encode()


FUNCS["gzip"] = lambda b: _gzip.compress(_as_bytes(b))
FUNCS["gunzip"] = lambda b: _gzip.decompress(_as_bytes(b))
FUNCS["zip"] = lambda b: zlib.compress(_as_bytes(b), 9)[2:-4]
FUNCS["unzip"] = lambda b: zlib.decompress(_as_bytes(b), wbits=-15)
FUNCS["zip_compress"] = lambda b: zlib.compress(_as_bytes(b))
FUNCS["zip_uncompress"] = lambda b: zlib.decompress(_as_bytes(b))


@f("hash")
def _hash(alg, data):
    return hashlib.new(_str(alg), _as_bytes(data)).hexdigest()


FUNCS["term_encode"] = FUNCS["term_to_binary"]
FUNCS["term_decode"] = FUNCS["binary_to_term"]


# -- topic predicates --------------------------------------------------------

@f("contains_topic")
def _contains_topic(topics, topic, *rest):
    items = topics if isinstance(topics, list) else [topics]
    return any(_str(t) == _str(topic) for t in items)


@f("contains_topic_match")
def _contains_topic_match(filters, topic, *rest):
    from emqx_tpu_torch.core import topic as T

    items = filters if isinstance(filters, list) else [filters]
    return any(T.match(_str(topic), _str(fl)) for fl in items)


@f("find_topic_filter")
def _find_topic_filter(filters, topic):
    from emqx_tpu_torch.core import topic as T

    items = filters if isinstance(filters, list) else [filters]
    for fl in items:
        if T.match(_str(topic), _str(fl)):
            return _str(fl)
    return None


# -- maps --------------------------------------------------------------------

FUNCS["map_new"] = lambda: {}
FUNCS["map"] = lambda x=None: dict(x) if isinstance(x, dict) else {}


@f("map_path")
def _map_path(path, obj):
    cur = obj
    for seg in _str(path).lstrip("$.").split("."):
        if isinstance(cur, dict) and seg in cur:
            cur = cur[seg]
        else:
            return None
    return cur


# -- dates -------------------------------------------------------------------

@f("format_date")
def _format_date(unit, offset, fmt, ts=None):
    from datetime import datetime, timedelta, timezone

    ts_s = (_num(ts) if ts is not None else time.time()) / {
        "second": 1, "millisecond": 1000, "microsecond": 1e6,
        "nanosecond": 1e9}.get(_str(unit), 1)
    off = _str(offset)
    if off in ("", "local"):
        return time.strftime(_str(fmt), time.localtime(ts_s))
    if off in ("Z", "z", "+00:00", "0"):
        tz = timezone.utc
    else:
        sign = -1 if off.startswith("-") else 1
        hh, _, mm = off.lstrip("+-").partition(":")
        tz = timezone(sign * timedelta(hours=int(hh or 0),
                                       minutes=int(mm or 0)))
    return datetime.fromtimestamp(ts_s, tz).strftime(_str(fmt))


@f("date_to_unix_ts")
def _date_to_unix_ts(unit, fmt, date):
    mult = {"second": 1, "millisecond": 1000, "microsecond": 1_000_000,
            "nanosecond": 1_000_000_000}.get(_str(unit), 1)
    return int(time.mktime(time.strptime(_str(date), _str(fmt)))) * mult


@f("rfc3339_to_unix_ts")
def _rfc3339_to_unix_ts(date, unit="second"):
    from datetime import datetime

    dt = datetime.fromisoformat(_str(date).replace("Z", "+00:00"))
    mult = {"second": 1, "millisecond": 1000, "microsecond": 1_000_000,
            "nanosecond": 1_000_000_000}.get(_str(unit), 1)
    return int(dt.timestamp() * mult)


FUNCS["time_unit"] = lambda u: {"second": 1, "millisecond": 1000,
                                "microsecond": 1_000_000,
                                "nanosecond": 1_000_000_000}.get(_str(u), 1)


# -- per-rule kv store (emqx_rule_funcs kv_store_* / proc_dict_*) -----------
#
# The reference scopes the store per rule (the rule's worker process
# dictionary); a process-global dict would let rules collide on keys and
# grow without bound.  The engine sets the active rule id around each
# apply (engine.py) via a contextvar; keys are bounded per rule with
# oldest-first eviction.

import contextvars

_RULE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "emqx_rule_id", default="")
_KV_STORE: dict = {}          # rule_id → {key: value}
_KV_MAX_KEYS = 10_000


def set_rule_context(rule_id):
    """Returns a token for reset_rule_context (used by the engine)."""
    return _RULE_CTX.set(rule_id)


def reset_rule_context(token) -> None:
    _RULE_CTX.reset(token)


def drop_rule_store(rule_id) -> None:
    _KV_STORE.pop(rule_id, None)


def _kv() -> dict:
    return _KV_STORE.setdefault(_RULE_CTX.get(), {})


@f("kv_store_put")
def _kv_store_put(k, v):
    d = _kv()
    k = _str(k)
    if len(d) >= _KV_MAX_KEYS and k not in d:
        d.pop(next(iter(d)))          # evict oldest insertion
    d[k] = v
    return v


FUNCS["kv_store_get"] = lambda k, default=None: _kv().get(_str(k), default)


@f("kv_store_del")
def _kv_store_del(k):
    _kv().pop(_str(k), None)
    return None
FUNCS["proc_dict_put"] = FUNCS["kv_store_put"]
FUNCS["proc_dict_get"] = FUNCS["kv_store_get"]
FUNCS["proc_dict_del"] = FUNCS["kv_store_del"]


# -- remaining emqx_rule_funcs.erl surface -------------------------------

FUNCS["null"] = lambda: None        # null/0: the SQL undefined literal


@f("find_s")
def _find_s(s, sub, direction="leading"):
    """find with an explicit direction (find_s/3): 'leading' scans from
    the left (= find/2), 'trailing' from the right."""
    s, sub = _str(s), _str(sub)
    i = s.find(sub) if _str(direction) == "leading" else s.rfind(sub)
    return s[i:] if i >= 0 else ""


FUNCS["sprintf_s"] = FUNCS["sprintf"]       # erlang-side alias


@f("jq")
def _jq(program, value, _timeout_ms=None):
    # the reference runs this through the optional libjq NIF
    # (emqx_rule_funcs.erl:806-828, jq:process_json/3 → list of
    # outputs); this build ships its own jq-subset interpreter instead
    # (utils/jq.py). jq/3's timeout is a NIF-dirty-scheduler concern
    # the in-process evaluator doesn't have; accepted and ignored.
    from emqx_tpu_torch.utils.jq import JqError, jq as run_jq
    if isinstance(program, (bytes, bytearray)):
        program = program.decode("utf-8")
    if isinstance(value, str):
        # reference semantics: the SQL value is a binary holding JSON
        # text (jq:process_json/3 parses it); our runtime hands SQL
        # binaries over as str, so decode here — invalid JSON fails the
        # rule, same as the NIF. utils/jq.py itself never sniffs str.
        try:
            value = json.loads(value)
        except ValueError as e:
            raise JqError(f"jq: invalid JSON input: {e}") from None
    return run_jq(program, value)


# -- message-context accessors (clientid/0, payload/0, ... in the
# reference read the event's message record; here they read the rule's
# event columns via the CONTEXT_FUNCS registry the runtime passes
# columns into)

CONTEXT_FUNCS: dict[str, Callable] = {}


for _col in ("clientid", "username", "payload", "qos", "topic",
             "peerhost", "flags", "timestamp"):
    CONTEXT_FUNCS[_col] = (lambda c: lambda cols: cols.get(c))(_col)
CONTEXT_FUNCS["clientip"] = lambda cols: cols.get("peerhost")
CONTEXT_FUNCS["msgid"] = lambda cols: cols.get("id")
CONTEXT_FUNCS["flag"] = lambda cols, name: (
    (cols.get("flags") or {}).get(_str(name)))
CONTEXT_FUNCS["rule_id"] = lambda cols: _RULE_CTX.get()
