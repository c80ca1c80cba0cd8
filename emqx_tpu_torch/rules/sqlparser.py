"""Rule SQL parser — parity with the ``rulesql`` dep
(``apps/emqx_rule_engine/src/emqx_rule_sqlparser.erl`` wraps it).

Grammar (the surface EMQX rules use):

    SELECT <fields> FROM <topics> [WHERE <cond>]
    FOREACH <expr> [AS ident] [DO <fields>] [INCASE <cond>]
        FROM <topics> [WHERE <cond>]

    fields := * | expr [AS dotted_ident] (, ...)
    topics := 'string' (, ...)          -- topic filters / $events/...
    expr   := OR / AND / NOT chains over comparisons
              (=, !=, <>, >, <, >=, <=, IN (..), LIKE? → not in ref),
              arithmetic (+ - * / div mod), string concat via +,
              function calls f(a, b), dotted refs payload.x.y[1],
              literals (numbers, 'strings', true/false/null), CASE WHEN

Produces a small AST of tuples:
    ("const", v) ("var", ["payload","x"]) ("call", name, [args])
    ("op", sym, l, r) ("neg", e) ("not", e) ("and"/"or", l, r)
    ("in", e, [items]) ("case", [(when, then)...], else_or_None)
    ("index", e, idx_expr)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<dq>"(?:[^"]|"")*")
  | (?P<cmp><>|!=|>=|<=|=|>|<)
  | (?P<op>[+\-*/(),.\[\]])
  | (?P<word>[A-Za-z_$][A-Za-z0-9_$#/+-]*)
""", re.VERBOSE)

KEYWORDS = {"select", "from", "where", "as", "and", "or", "not", "in",
            "foreach", "do", "incase", "case", "when", "then", "else",
            "end", "div", "mod", "true", "false", "null", "like"}


class SqlError(ValueError):
    pass


@dataclass
class Token:
    kind: str       # num | str | word | cmp | op
    val: str
    pos: int


def tokenize(sql: str) -> list[Token]:
    out, i = [], 0
    while i < len(sql):
        m = _TOKEN.match(sql, i)
        if m is None:
            raise SqlError(f"bad token at {sql[i:i+12]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "dq":                 # "quoted identifier"
            out.append(Token("word", val[1:-1].replace('""', '"'), m.start()))
        elif kind == "str":
            out.append(Token("str", val[1:-1].replace("''", "'"), m.start()))
        else:
            out.append(Token(kind, val, m.start()))
    return out


@dataclass
class Select:
    fields: list            # [("*",)| (expr, alias|None)]
    topics: list[str]
    where: Optional[tuple]  # expr AST
    # FOREACH extras
    foreach: Optional[tuple] = None       # expr producing an array
    foreach_alias: Optional[str] = None
    do_fields: Optional[list] = None
    incase: Optional[tuple] = None

    @property
    def is_foreach(self) -> bool:
        return self.foreach is not None


class _P:
    def __init__(self, toks: list[Token]) -> None:
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[Token]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise SqlError("unexpected end of SQL")
        self.i += 1
        return t

    def kw(self, word: str) -> bool:
        t = self.peek()
        if t and t.kind == "word" and t.val.lower() == word:
            self.i += 1
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.kw(word):
            t = self.peek()
            raise SqlError(f"expected {word.upper()}, got "
                           f"{t.val if t else 'EOF'!r}")

    def expect_op(self, sym: str) -> None:
        t = self.next()
        if t.kind != "op" or t.val != sym:
            raise SqlError(f"expected {sym!r}, got {t.val!r}")

    def at_op(self, sym: str) -> bool:
        t = self.peek()
        if t and t.kind == "op" and t.val == sym:
            self.i += 1
            return True
        return False

    # -- statements ---------------------------------------------------------

    def parse(self) -> Select:
        if self.kw("foreach"):
            return self._foreach()
        self.expect_kw("select")
        fields = self._fields()
        self.expect_kw("from")
        topics = self._topics()
        where = self._expr() if self.kw("where") else None
        self._eof()
        return Select(fields, topics, where)

    def _foreach(self) -> Select:
        fe = self._expr()
        alias = None
        if self.kw("as"):
            alias = self._dotted()[-1]
        do_fields = self._fields() if self.kw("do") else None
        incase = self._expr() if self.kw("incase") else None
        self.expect_kw("from")
        topics = self._topics()
        where = self._expr() if self.kw("where") else None
        self._eof()
        return Select([("*",)], topics, where, foreach=fe,
                      foreach_alias=alias, do_fields=do_fields,
                      incase=incase)

    def _eof(self) -> None:
        if self.peek() is not None:
            raise SqlError(f"trailing input at {self.peek().val!r}")

    def _fields(self) -> list:
        fields = []
        while True:
            if self.at_op("*"):
                fields.append(("*",))
            else:
                e = self._expr()
                alias = None
                if self.kw("as"):
                    alias = ".".join(self._dotted())
                fields.append((e, alias))
            if not self.at_op(","):
                return fields

    def _topics(self) -> list[str]:
        topics = []
        while True:
            t = self.next()
            if t.kind not in ("str", "word"):
                raise SqlError(f"expected topic, got {t.val!r}")
            topics.append(t.val)
            if not self.at_op(","):
                return topics

    # -- expressions (precedence climbing) ----------------------------------

    def _expr(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.kw("or"):
            left = ("or", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.kw("and"):
            left = ("and", left, self._not())
        return left

    def _not(self):
        if self.kw("not"):
            return ("not", self._not())
        return self._cmp()

    def _cmp(self):
        left = self._sum()
        t = self.peek()
        if t and t.kind == "cmp":
            self.i += 1
            return ("op", t.val, left, self._sum())
        if t and t.kind == "word" and t.val.lower() == "in":
            self.i += 1
            self.expect_op("(")
            items = []
            while True:
                items.append(self._expr())
                if not self.at_op(","):
                    break
            self.expect_op(")")
            return ("in", left, items)
        if t and t.kind == "word" and t.val.lower() == "like":
            self.i += 1
            pat = self.next()
            if pat.kind != "str":
                raise SqlError("LIKE needs a string pattern")
            return ("call", "like", [left, ("const", pat.val)])
        return left

    def _sum(self):
        left = self._term()
        while True:
            if self.at_op("+"):
                left = ("op", "+", left, self._term())
            elif self.at_op("-"):
                left = ("op", "-", left, self._term())
            else:
                return left

    def _term(self):
        left = self._unary()
        while True:
            if self.at_op("*"):
                left = ("op", "*", left, self._unary())
            elif self.at_op("/"):
                left = ("op", "/", left, self._unary())
            elif self.kw("div"):
                left = ("op", "div", left, self._unary())
            elif self.kw("mod"):
                left = ("op", "mod", left, self._unary())
            else:
                return left

    def _unary(self):
        if self.at_op("-"):
            return ("neg", self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._atom()
        while True:
            if self.at_op("["):
                idx = self._expr()
                self.expect_op("]")
                e = ("index", e, idx)
            else:
                return e

    def _atom(self):
        t = self.next()
        if t.kind == "num":
            return ("const", float(t.val) if "." in t.val else int(t.val))
        if t.kind == "str":
            return ("const", t.val)
        if t.kind == "op" and t.val == "(":
            e = self._expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.val == "[":
            # array literal: ["a", b.c, 1] (rulesql array syntax)
            items = []
            if not self.at_op("]"):
                while True:
                    items.append(self._expr())
                    if not self.at_op(","):
                        break
                self.expect_op("]")
            return ("list", items)
        if t.kind == "word":
            low = t.val.lower()
            if low == "true":
                return ("const", True)
            if low == "false":
                return ("const", False)
            if low == "null":
                return ("const", None)
            if low == "case":
                return self._case()
            # function call?
            if self.at_op("("):
                args = []
                if not self.at_op(")"):
                    while True:
                        args.append(self._expr())
                        if not self.at_op(","):
                            break
                    self.expect_op(")")
                return ("call", t.val.lower(), args)
            # dotted variable reference
            path = [t.val]
            while self.at_op("."):
                nxt = self.next()
                if nxt.kind not in ("word", "num"):
                    raise SqlError(f"bad path segment {nxt.val!r}")
                path.append(nxt.val)
            return ("var", path)
        raise SqlError(f"unexpected token {t.val!r}")

    def _case(self):
        whens = []
        while self.kw("when"):
            cond = self._expr()
            self.expect_kw("then")
            whens.append((cond, self._expr()))
        els = self._expr() if self.kw("else") else None
        self.expect_kw("end")
        if not whens:
            raise SqlError("CASE needs at least one WHEN")
        return ("case", whens, els)

    def _dotted(self) -> list[str]:
        t = self.next()
        if t.kind != "word":
            raise SqlError(f"expected identifier, got {t.val!r}")
        path = [t.val]
        while self.at_op("."):
            path.append(self.next().val)
        return path


def parse(sql: str) -> Select:
    return _P(tokenize(sql)).parse()
