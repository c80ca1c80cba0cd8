"""A jq-subset interpreter — backing for the rule engine's ``jq/2``
(emqx_rule_funcs.erl:806-828, which calls the optional libjq NIF; this
build ships its own evaluator instead of gating the function away).

jq programs are stream transformers: every expression maps one input
value to a *stream* of outputs; ``a | b`` feeds each output of ``a``
through ``b``; ``a, b`` concatenates streams; operators distribute over
the cartesian product of their operand streams. ``jq(prog, json)``
returns the list of all outputs, like the reference's
``jq:process_json/3``.

Supported subset (the jq-manual core):
  identity ``.``   paths ``.a.b``, ``.["k"]``, ``.[0]``, slices
  ``.[1:3]``   iteration ``.[]``   optional ``?``   pipe ``|``
  comma   ``//`` alternative   arithmetic ``+ - * / %``   comparisons
  and/or/not   ``if .. then .. elif .. else .. end``   ``select``
  array/object construction ``[...]`` ``{a: .b, "c", d}``   literals
  builtins: length keys values has type empty not add any all min max
  sort sort_by unique reverse join split map range first last floor
  ceil sqrt abs tostring tonumber tojson fromjson ascii_downcase
  ascii_upcase startswith endswith contains ltrimstr rtrimstr
  to_entries from_entries error

Not supported (raises JqError at parse time): ``def``, ``$vars``/``as``,
``reduce``/``foreach``, ``..``, regex builtins, string interpolation,
``try``/``catch`` (use ``?``), ``label``/``break``.
"""

from __future__ import annotations

import functools
import json
import math
import re
from typing import Any, Callable, Iterator, Optional

Stream = Iterator[Any]
Fn = Callable[[Any], Stream]


class JqError(Exception):
    pass


# ---------------------------------------------------------------------------
# tokenizer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+(\.\d+)?([eE][+-]?\d+)?)
  | (?P<str>"(\\.|[^"\\])*")
  | (?P<op>\.\.|\|=|==|!=|<=|>=|//|[.\[\]{}()|,:;?<>=+\-*/%])
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<var>\$[A-Za-z_][A-Za-z0-9_]*)
""", re.VERBOSE)

_KEYWORDS = {"if", "then", "elif", "else", "end", "and", "or", "not",
             "true", "false", "null", "def", "as", "reduce", "foreach",
             "try", "catch", "label", "import", "include"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise JqError(f"jq: bad character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text in _KEYWORDS:
            kind = "kw"
        out.append((kind, text))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# helpers: jq value semantics


def _truthy(v: Any) -> bool:
    return v is not None and v is not False


def _type(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    raise JqError(f"jq: unsupported value {v!r}")


_ORD = {"null": 0, "false": 1, "true": 2, "number": 3, "string": 4,
        "array": 5, "object": 6}


def _sort_key(v: Any):
    """jq total order: null < false < true < numbers < strings < arrays
    < objects."""
    t = _type(v)
    if t == "boolean":
        t = "true" if v else "false"
    rank = _ORD[t]
    if t in ("null", "false", "true"):
        return (rank, 0)
    if t == "array":
        return (rank, [_sort_key(x) for x in v])
    if t == "object":
        return (rank, sorted((k, _sort_key(x)) for k, x in v.items()))
    return (rank, v)


def _cmp(a: Any, b: Any) -> int:
    ka, kb = _sort_key(a), _sort_key(b)
    return -1 if ka < kb else (1 if ka > kb else 0)


def _add(a: Any, b: Any) -> Any:
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, bool) or isinstance(b, bool):
        raise JqError("jq: booleans cannot be added")
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a + b
    if isinstance(a, str) and isinstance(b, str):
        return a + b
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    if isinstance(a, dict) and isinstance(b, dict):
        return {**a, **b}
    raise JqError(f"jq: {_type(a)} and {_type(b)} cannot be added")


def _arith(op: str, a: Any, b: Any) -> Any:
    if op == "+":
        return _add(a, b)
    if op == "-":
        if isinstance(a, list) and isinstance(b, list):
            return [x for x in a if x not in b]
        if _num2(a, b):
            return a - b
    if op == "*":
        if _num2(a, b):
            return a * b
        if isinstance(a, dict) and isinstance(b, dict):
            return _deep_merge(a, b)
    if op == "/":
        if _num2(a, b):
            if b == 0:
                raise JqError("jq: division by zero")
            # exact integer quotients stay integers (jq prints 6/2 as 3)
            if isinstance(a, int) and isinstance(b, int) and a % b == 0:
                return a // b
            return a / b
        if isinstance(a, str) and isinstance(b, str):
            if not b:
                raise JqError("jq: cannot split by empty string")
            return a.split(b)
    if op == "%":
        if _num2(a, b):
            if int(b) == 0:
                raise JqError("jq: division by zero")
            return int(math.fmod(int(a), int(b)))
    raise JqError(f"jq: {_type(a)} {op} {_type(b)} is not defined")


def _num2(a, b) -> bool:
    return (isinstance(a, (int, float)) and not isinstance(a, bool) and
            isinstance(b, (int, float)) and not isinstance(b, bool))


def _deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if isinstance(out.get(k), dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _index(v: Any, key: Any, opt: bool) -> Stream:
    try:
        if v is None:
            yield None
        elif isinstance(v, dict):
            if not isinstance(key, str):
                raise JqError(f"jq: cannot index object with {_type(key)}")
            yield v.get(key)
        elif isinstance(v, list):
            if isinstance(key, bool) or not isinstance(key, (int, float)):
                raise JqError(f"jq: cannot index array with {_type(key)}")
            i = int(key)
            n = len(v)
            if i < 0:
                i += n
            yield v[i] if 0 <= i < n else None
        else:
            raise JqError(f"jq: cannot index {_type(v)}")
    except JqError:
        if not opt:
            raise


def _iterate(v: Any, opt: bool) -> Stream:
    if isinstance(v, list):
        yield from v
    elif isinstance(v, dict):
        yield from v.values()
    elif not opt:
        raise JqError(f"jq: cannot iterate over {_type(v)}")


# ---------------------------------------------------------------------------
# builtins: name -> (n_args, fn(input, *compiled_args) -> stream)


def _b_simple(fn):
    return lambda v: iter([fn(v)])


def _length(v):
    if v is None:
        return 0
    if isinstance(v, bool):
        raise JqError("jq: boolean has no length")
    if isinstance(v, (int, float)):
        return abs(v)
    return len(v)


def _keys(v):
    if isinstance(v, dict):
        return sorted(v.keys())
    if isinstance(v, list):
        return list(range(len(v)))
    raise JqError(f"jq: {_type(v)} has no keys")


def _tonumber(v):
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                raise JqError(f"jq: cannot parse {v!r} as number") from None
    raise JqError(f"jq: cannot parse {_type(v)} as number")


def _tostring(v):
    return v if isinstance(v, str) else json.dumps(v)


def _expect(v, t, what: str):
    if isinstance(v, bool) or not isinstance(v, t):
        names = (t.__name__ if isinstance(t, type)
                 else "/".join(x.__name__ for x in t))
        raise JqError(f"jq: {what} requires {names}, got {_type(v)}")
    return v


_BUILTINS_0: dict[str, Callable[[Any], Stream]] = {
    "length": _b_simple(_length),
    "keys": _b_simple(_keys),
    "values": lambda v: iter(() if v is None else (v,)),   # select(.!=null)
    "type": _b_simple(_type),
    "not": _b_simple(lambda v: not _truthy(v)),
    "empty": lambda v: iter(()),
    "add": _b_simple(lambda v: _fold_add(v)),
    "floor": _b_simple(lambda v: math.floor(_expect(v, (int, float),
                                                    "floor"))),
    "ceil": _b_simple(lambda v: math.ceil(_expect(v, (int, float),
                                                  "ceil"))),
    "sqrt": _b_simple(lambda v: math.sqrt(_expect(v, (int, float),
                                                  "sqrt"))),
    "abs": _b_simple(lambda v: abs(_expect(v, (int, float), "abs"))),
    "sort": _b_simple(lambda v: sorted(_expect(v, list, "sort"),
                                       key=_sort_key)),
    "unique": _b_simple(lambda v: _unique(_expect(v, list, "unique"))),
    "reverse": _b_simple(lambda v: list(reversed(
        _expect(v, list, "reverse")))),
    "min": _b_simple(lambda v: min(_expect(v, list, "min"),
                                   key=_sort_key, default=None)),
    "max": _b_simple(lambda v: max(_expect(v, list, "max"),
                                   key=_sort_key, default=None)),
    "tostring": _b_simple(_tostring),
    "tonumber": _b_simple(_tonumber),
    "tojson": _b_simple(lambda v: json.dumps(v)),
    "fromjson": _b_simple(lambda v: json.loads(
        _expect(v, str, "fromjson"))),
    "ascii_downcase": _b_simple(lambda v: _expect(v, str,
                                                  "ascii_downcase").lower()),
    "ascii_upcase": _b_simple(lambda v: _expect(v, str,
                                                "ascii_upcase").upper()),
    "to_entries": _b_simple(lambda v: [
        {"key": k, "value": x}
        for k, x in _expect(v, dict, "to_entries").items()]),
    "from_entries": _b_simple(lambda v: {
        str(e.get("key", e.get("k", e.get("name")))):
            e.get("value", e.get("v"))
        for e in _expect(v, list, "from_entries")}),
    # first = .[0], last = .[-1] (jq defs): empty array yields null
    "first": lambda v: iter([_expect(v, list, "first")[0] if v else None]),
    "last": lambda v: iter([_expect(v, list, "last")[-1] if v else None]),
}


def _fold_add(v):
    if not isinstance(v, list):
        raise JqError("jq: add requires array")
    out = None
    for x in v:
        out = _add(out, x)
    return out


def _unique(v: list) -> list:
    out: list = []
    for x in sorted(v, key=_sort_key):
        if not out or _cmp(out[-1], x) != 0:
            out.append(x)
    return out


def _b1_value(name: str, fn):
    """Builtin whose single argument is evaluated against the SAME
    input, distributing over its stream."""
    def run(v, arg: Fn) -> Stream:
        for a in arg(v):
            yield fn(v, a)
    return run


_BUILTINS_1: dict[str, Callable[[Any, Fn], Stream]] = {
    "has": _b1_value("has", lambda v, k:
                     (k in v) if isinstance(v, dict)
                     else (isinstance(k, int) and 0 <= k < len(v))
                     if isinstance(v, list)
                     else _raise(f"jq: {_type(v)} has no keys")),
    "join": _b1_value("join", lambda v, s: _expect(s, str, "join").join(
        "" if x is None else (x if isinstance(x, str) else json.dumps(x))
        for x in _expect(v, list, "join"))),
    "split": _b1_value("split", lambda v, s:
                       _expect(v, str, "split").split(
                           _expect(s, str, "split"))),
    "startswith": _b1_value("startswith", lambda v, p:
                            _expect(v, str, "startswith").startswith(
                                _expect(p, str, "startswith"))),
    "endswith": _b1_value("endswith", lambda v, p:
                          _expect(v, str, "endswith").endswith(
                              _expect(p, str, "endswith"))),
    "ltrimstr": _b1_value("ltrimstr", lambda v, p:
                          v[len(p):] if isinstance(v, str)
                          and isinstance(p, str) and v.startswith(p) else v),
    "rtrimstr": _b1_value("rtrimstr", lambda v, p:
                          v[:-len(p)] if isinstance(v, str)
                          and isinstance(p, str) and p and v.endswith(p)
                          else v),
    "contains": _b1_value("contains", lambda v, x: _contains(v, x)),
    "error": _b1_value("error", lambda v, m: _raise(f"jq: error: {m}")),
}


def _raise(msg: str):
    raise JqError(msg)


def _contains(v, x) -> bool:
    if isinstance(v, str) and isinstance(x, str):
        return x in v
    if isinstance(v, list) and isinstance(x, list):
        return all(any(_contains(a, b) for a in v) for b in x)
    if isinstance(v, dict) and isinstance(x, dict):
        return all(k in v and _contains(v[k], b) for k, b in x.items())
    return _cmp(v, x) == 0


# filter-argument builtins (argument runs per element / as predicate)

def _b_select(v, f: Fn) -> Stream:
    for t in f(v):
        if _truthy(t):
            yield v


def _b_map(v, f: Fn) -> Stream:
    out = []
    for x in _expect(v, list, "map"):
        out.extend(f(x))
    yield out


def _b_sort_by(v, f: Fn) -> Stream:
    yield sorted(_expect(v, list, "sort_by"),
                 key=lambda x: _sort_key(next(f(x), None)))


def _b_any(v, f: Fn) -> Stream:
    yield any(_truthy(t) for x in _expect(v, list, "any") for t in f(x))


def _b_all(v, f: Fn) -> Stream:
    yield all(_truthy(t) for x in _expect(v, list, "all") for t in f(x))


def _b_range(v, f: Fn) -> Stream:
    for n in f(v):
        yield from range(int(n))


_BUILTINS_F: dict[str, Callable[[Any, Fn], Stream]] = {
    "select": _b_select, "map": _b_map, "sort_by": _b_sort_by,
    "any": _b_any, "all": _b_all, "range": _b_range,
}


def _guard(fn: Fn) -> Fn:
    """Builtins must fail with JqError only — a ValueError out of
    fromjson/sqrt/split would escape `?` and `//` error suppression."""
    def run(v, fn=fn):
        try:
            yield from fn(v)
        except JqError:
            raise
        except (ValueError, TypeError, AttributeError, KeyError,
                ArithmeticError) as e:
            raise JqError(f"jq: {e}") from e
    return run


# ---------------------------------------------------------------------------
# parser → compiled closures (each: Fn = input -> stream)


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]) -> None:
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        if self.toks[self.i][1] == text and self.toks[self.i][0] != "str":
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        if not self.accept(text):
            k, t = self.peek()
            raise JqError(f"jq: expected {text!r}, got {t!r}")

    # pipe (lowest precedence)
    def parse_pipe(self) -> Fn:
        left = self.parse_comma()
        if self.accept("|"):
            right = self.parse_pipe()

            def run(v, left=left, right=right):
                for a in left(v):
                    yield from right(a)
            return run
        return left

    def parse_comma(self) -> Fn:
        parts = [self.parse_alt()]
        while self.accept(","):
            parts.append(self.parse_alt())
        if len(parts) == 1:
            return parts[0]

        def run(v, parts=parts):
            for p in parts:
                yield from p(v)
        return run

    def parse_alt(self) -> Fn:
        left = self.parse_or()
        if self.accept("//"):
            right = self.parse_alt()

            def run(v, left=left, right=right):
                got = False
                try:
                    for a in left(v):
                        if _truthy(a):
                            got = True
                            yield a
                except JqError:
                    pass
                if not got:
                    yield from right(v)
            return run
        return left

    def _binop(self, sub, ops: tuple, apply) -> Fn:
        left = sub()
        while self.peek()[1] in ops and self.peek()[0] in ("op", "kw"):
            op = self.next()[1]
            right = sub()

            def run(v, left=left, right=right, op=op):
                for b in right(v):       # jq evaluates rhs first
                    for a in left(v):
                        yield apply(op, a, b)
            left = run
        return left

    def _shortcircuit(self, sub, op_name: str, stop_on: bool) -> Fn:
        """jq and/or: left first, rhs only evaluated when needed —
        `false and error` is false, not an error."""
        left = sub()
        while self.peek() == ("kw", op_name):
            self.next()
            right = sub()

            def run(v, left=left, right=right, stop_on=stop_on):
                for a in left(v):
                    if _truthy(a) is stop_on:
                        yield stop_on
                    else:
                        for b in right(v):
                            yield _truthy(b)
            left = run
        return left

    def parse_or(self) -> Fn:
        return self._shortcircuit(self.parse_and, "or", stop_on=True)

    def parse_and(self) -> Fn:
        return self._shortcircuit(self.parse_cmp, "and", stop_on=False)

    _CMP = {"==": lambda c: c == 0, "!=": lambda c: c != 0,
            "<": lambda c: c < 0, "<=": lambda c: c <= 0,
            ">": lambda c: c > 0, ">=": lambda c: c >= 0}

    def parse_cmp(self) -> Fn:
        return self._binop(
            self.parse_add, tuple(self._CMP),
            lambda op, a, b: self._CMP[op](_cmp(a, b)))

    def parse_add(self) -> Fn:
        return self._binop(self.parse_mul, ("+", "-"), _arith)

    def parse_mul(self) -> Fn:
        return self._binop(self.parse_unary, ("*", "/", "%"), _arith)

    def parse_unary(self) -> Fn:
        if self.accept("-"):
            inner = self.parse_postfix()

            def run(v, inner=inner):
                for a in inner(v):
                    if isinstance(a, bool) or not isinstance(a, (int, float)):
                        raise JqError(f"jq: {_type(a)} cannot be negated")
                    yield -a
            return run
        return self.parse_postfix()

    # postfix: primary followed by .foo  [..]  []  ?
    def parse_postfix(self) -> Fn:
        fn = self.parse_primary()
        while True:
            if self.peek()[1] == "." and self.toks[self.i + 1][0] == "name":
                self.next()
                name = self.next()[1]
                # default-arg binding: a loop-captured `name` would make
                # every segment of .a.b.c index with the LAST name
                fn = self._chain_index(fn, lambda v, s=name: iter([s]))
            elif self.accept("["):
                fn = self._bracket(fn)
            elif self.accept("?"):
                fn = self._optional(fn)
            else:
                return fn

    @staticmethod
    def _optional(fn: Fn) -> Fn:
        def run(v, fn=fn):
            try:
                yield from fn(v)
            except JqError:
                return
        return run

    @staticmethod
    def _chain_index(fn: Fn, keyf: Fn) -> Fn:
        def run(v, fn=fn, keyf=keyf):
            for a in fn(v):
                for k in keyf(v):
                    yield from _index(a, k, opt=False)
        return run

    def _bracket(self, fn: Fn) -> Fn:
        """``[...]`` after an expression: iterate, index, or slice."""
        if self.accept("]"):
            def run(v, fn=fn):
                for a in fn(v):
                    yield from _iterate(a, opt=False)
            return run
        lo: Optional[Fn] = None
        hi: Optional[Fn] = None
        if not self.peek()[1] == ":":
            lo = self.parse_pipe()
        if self.accept(":"):
            if self.peek()[1] != "]":
                hi = self.parse_pipe()
            self.expect("]")

            def run(v, fn=fn, lo=lo, hi=hi):
                for a in fn(v):
                    los = lo(v) if lo else iter([None])
                    for lov in los:
                        his = hi(v) if hi else iter([None])
                        for hiv in his:
                            if a is None:        # .x[0:2] on null → null
                                yield None
                                continue
                            if not isinstance(a, (list, str)):
                                raise JqError(
                                    f"jq: cannot slice {_type(a)}")
                            s = slice(
                                None if lov is None else int(lov),
                                None if hiv is None else int(hiv))
                            yield a[s]
            return run
        self.expect("]")

        def run(v, fn=fn, lo=lo):
            for a in fn(v):
                for k in lo(v):
                    yield from _index(a, k, opt=False)
        return run

    def parse_primary(self) -> Fn:
        kind, text = self.peek()
        if text == "(":
            self.next()
            inner = self.parse_pipe()
            self.expect(")")
            return inner
        if text == ".":
            self.next()
            # .name / ."k" here; .[...] postfix picks up from identity
            if self.peek()[0] == "name":
                name = self.next()[1]
                return self._chain_index(lambda v: iter([v]),
                                         lambda v, s=name: iter([s]))
            if self.peek()[0] == "str":
                s = json.loads(self.next()[1])
                return self._chain_index(lambda v: iter([v]),
                                         lambda v, s=s: iter([s]))
            return lambda v: iter([v])
        if text == "..":
            raise JqError("jq: recursive descent (..) not supported")
        if kind == "num":
            self.next()
            n = float(text) if ("." in text or "e" in text.lower()) \
                else int(text)
            return lambda v, n=n: iter([n])
        if kind == "str":
            if "\\(" in text:
                raise JqError("jq: string interpolation not supported")
            try:
                s = json.loads(text)
            except ValueError as e:
                raise JqError(f"jq: bad string literal {text}") from e
            self.next()
            return lambda v, s=s: iter([s])
        if kind == "var":
            raise JqError("jq: variables ($x) not supported")
        if kind == "kw":
            return self._keyword()
        if text == "[":
            self.next()
            if self.accept("]"):
                return lambda v: iter([[]])
            inner = self.parse_pipe()
            self.expect("]")
            return lambda v, inner=inner: iter([list(inner(v))])
        if text == "{":
            return self._object()
        if kind == "name":
            return self._call()
        raise JqError(f"jq: unexpected token {text!r}")

    def _keyword(self) -> Fn:
        _kind, text = self.next()
        if text in ("true", "false", "null"):
            lit = {"true": True, "false": False, "null": None}[text]
            return lambda v, lit=lit: iter([lit])
        if text == "not":
            return _BUILTINS_0["not"]
        if text == "if":
            cond = self.parse_pipe()
            self.expect("then")
            then = self.parse_pipe()
            branches = [(cond, then)]
            while self.accept("elif"):
                c = self.parse_pipe()
                self.expect("then")
                branches.append((c, self.parse_pipe()))
            els = self.parse_pipe() if self.accept("else") \
                else (lambda v: iter([v]))
            self.expect("end")

            def run(v, branches=branches, els=els):
                def descend(k: int) -> Stream:
                    if k == len(branches):
                        yield from els(v)
                        return
                    cond, then = branches[k]
                    for t in cond(v):
                        if _truthy(t):
                            yield from then(v)
                        else:
                            yield from descend(k + 1)
                yield from descend(0)
            return run
        raise JqError(f"jq: {text!r} not supported")

    def _object(self) -> Fn:
        self.expect("{")
        fields: list[tuple[Fn, Optional[Fn]]] = []
        if not self.accept("}"):
            while True:
                kind, text = self.peek()
                if kind in ("name", "kw"):
                    self.next()
                    keyf: Fn = (lambda v, s=text: iter([s]))
                elif kind == "str":
                    self.next()
                    keyf = (lambda v, s=json.loads(text): iter([s]))
                elif self.accept("("):
                    keyf = self.parse_pipe()
                    self.expect(")")
                else:
                    raise JqError(f"jq: bad object key {text!r}")
                valf = self.parse_alt() if self.accept(":") else None
                fields.append((keyf, valf))
                if not self.accept(","):
                    break
            self.expect("}")

        def run(v, fields=fields):
            def descend(k: int, acc: dict) -> Stream:
                if k == len(fields):
                    yield dict(acc)
                    return
                keyf, valf = fields[k]
                for key in keyf(v):
                    if not isinstance(key, str):
                        raise JqError("jq: object key must be string")
                    vals = (valf(v) if valf is not None
                            else _index(v, key, opt=False))
                    had, old = key in acc, acc.get(key)
                    for val in vals:
                        acc[key] = val
                        yield from descend(k + 1, acc)
                    if had:          # backtrack: {("a","b"): 1} must not
                        acc[key] = old       # leak "a" into the "b" object
                    else:
                        acc.pop(key, None)
            yield from descend(0, {})
        return run

    def _call(self) -> Fn:
        name = self.next()[1]
        args: list[Fn] = []
        if self.accept("("):
            args.append(self.parse_pipe())
            while self.accept(";"):
                args.append(self.parse_pipe())
            self.expect(")")
        if not args and name in _BUILTINS_0:
            return _guard(_BUILTINS_0[name])
        if len(args) == 1 and name in _BUILTINS_F:
            f = _BUILTINS_F[name]
            return _guard(lambda v, f=f, a=args[0]: f(v, a))
        if len(args) == 1 and name in _BUILTINS_1:
            f = _BUILTINS_1[name]
            return _guard(lambda v, f=f, a=args[0]: f(v, a))
        raise JqError(f"jq: unknown function {name}/{len(args)}")


@functools.lru_cache(maxsize=256)
def compile_program(src: str) -> Fn:
    """Compiled programs are stateless closures — cached so jq/2 on the
    per-message rule hot path compiles each program once."""
    p = _Parser(_tokenize(src))
    fn = p.parse_pipe()
    if p.peek()[0] != "eof":
        raise JqError(f"jq: trailing input at token {p.peek()[1]!r}")
    return fn


def jq(program: str, value: Any) -> list:
    """Run a jq program; returns the list of ALL outputs.

    ``value`` is an already-decoded term, with one exception: bytes are
    a JSON document (invalid JSON errors). A ``str`` is ALWAYS a plain
    string term — never sniffed as JSON text, so ``jq(".", "0")`` is
    ``["0"]``, not ``[0]``. The reference-semantics seam (SQL values
    are binaries holding JSON text, emqx_rule_funcs.erl:806-828) lives
    in rules/funcs.py:_jq, which decodes str/bytes before calling here."""
    if isinstance(value, (bytes, bytearray)):
        try:
            value = json.loads(value.decode("utf-8"))
        except ValueError as e:
            raise JqError(f"jq: invalid JSON input: {e}") from None
    return list(compile_program(program)(value))
