"""Rule runtime — parity with
``apps/emqx_rule_engine/src/emqx_rule_runtime.erl:58-205``.

Evaluates a parsed ``Select`` against an event's column map:
WHERE filters, SELECT projects (with aliases and nested paths), FOREACH
fans an array column out to one result per element (with DO projection
and INCASE filter). ``payload`` auto-decodes from JSON on first nested
access, as the reference's column resolution does.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from emqx_tpu_torch.rules.funcs import CONTEXT_FUNCS, FUNCS
from emqx_tpu_torch.rules.sqlparser import Select, SqlError


class RuleEvalError(ValueError):
    pass


def _decode_payload(val):
    if isinstance(val, (bytes, str)):
        try:
            return json.loads(val)
        except Exception:
            return None
    return val


def _lookup(columns: dict, path: list[str]) -> Any:
    cur: Any = columns
    for i, key in enumerate(path):
        if isinstance(cur, dict):
            if key in cur:
                cur = cur[key]
            elif (key == "payload" or i > 0) and isinstance(
                    cur.get(key, None), (bytes,)):
                cur = cur[key]
            else:
                return None
        elif isinstance(cur, list):
            try:
                cur = cur[int(key) - 1]           # SQL arrays are 1-based
            except (ValueError, IndexError):
                return None
        else:
            return None
        # nested access into a raw payload: decode JSON lazily
        if (isinstance(cur, (bytes,)) or isinstance(cur, str)) \
                and i < len(path) - 1:
            cur = _decode_payload(cur)
    return cur


def eval_expr(ast, columns: dict) -> Any:
    tag = ast[0]
    if tag == "const":
        return ast[1]
    if tag == "var":
        return _lookup(columns, ast[1])
    if tag == "neg":
        return -eval_expr(ast[1], columns)
    if tag == "not":
        return not _truthy(eval_expr(ast[1], columns))
    if tag == "and":
        return _truthy(eval_expr(ast[1], columns)) \
            and _truthy(eval_expr(ast[2], columns))
    if tag == "or":
        return _truthy(eval_expr(ast[1], columns)) \
            or _truthy(eval_expr(ast[2], columns))
    if tag == "in":
        v = eval_expr(ast[1], columns)
        return any(v == eval_expr(item, columns) for item in ast[2])
    if tag == "case":
        for cond, then in ast[1]:
            if _truthy(eval_expr(cond, columns)):
                return eval_expr(then, columns)
        return eval_expr(ast[2], columns) if ast[2] is not None else None
    if tag == "list":
        return [eval_expr(item, columns) for item in ast[1]]
    if tag == "index":
        seq = eval_expr(ast[1], columns)
        idx = eval_expr(ast[2], columns)
        if isinstance(seq, list):
            try:
                return seq[int(idx) - 1]
            except (IndexError, ValueError):
                return None
        if isinstance(seq, dict):
            return seq.get(idx)
        return None
    if tag == "op":
        return _binop(ast[1],
                      eval_expr(ast[2], columns),
                      eval_expr(ast[3], columns))
    if tag == "call":
        cfn = CONTEXT_FUNCS.get(ast[1])
        if cfn is not None and not (ast[2] and ast[1] in FUNCS):
            # message-context accessors (clientid(), payload(), flag(x))
            # read the event columns, not just their arguments. Names
            # shared with value builtins keep the builtin when called
            # WITH arguments: topic() reads the column, topic('a', id)
            # stays the join function.
            return cfn(columns, *[eval_expr(a, columns) for a in ast[2]])
        fn = FUNCS.get(ast[1])
        if fn is None:
            raise RuleEvalError(f"unknown SQL function {ast[1]!r}")
        return fn(*[eval_expr(a, columns) for a in ast[2]])
    raise RuleEvalError(f"bad AST node {tag!r}")


def _truthy(v: Any) -> bool:
    return bool(v) and v is not None


def _binop(sym: str, l: Any, r: Any) -> Any:
    if sym == "=":
        return _eq(l, r)
    if sym in ("!=", "<>"):
        return not _eq(l, r)
    if sym in (">", "<", ">=", "<="):
        try:
            ln, rn = _coerce_num(l), _coerce_num(r)
        except (TypeError, ValueError):
            ln, rn = str(l), str(r)
        return {">": ln > rn, "<": ln < rn,
                ">=": ln >= rn, "<=": ln <= rn}[sym]
    if sym == "+":
        if isinstance(l, str) or isinstance(r, str):
            # string + string concatenates (rulesql does this)
            from emqx_tpu_torch.rules.funcs import _str
            return _str(l) + _str(r)
        return _coerce_num(l) + _coerce_num(r)
    if sym == "-":
        return _coerce_num(l) - _coerce_num(r)
    if sym == "*":
        return _coerce_num(l) * _coerce_num(r)
    if sym == "/":
        return _coerce_num(l) / _coerce_num(r)
    if sym == "div":
        return int(_coerce_num(l)) // int(_coerce_num(r))
    if sym == "mod":
        return int(_coerce_num(l)) % int(_coerce_num(r))
    raise RuleEvalError(f"bad operator {sym!r}")


def _coerce_num(v: Any):
    if isinstance(v, bool):
        raise TypeError("bool in arithmetic")
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        return float(v) if "." in v else int(v)
    if isinstance(v, bytes):
        return float(v) if b"." in v else int(v)
    raise TypeError(f"not a number: {v!r}")


def _eq(l: Any, r: Any) -> bool:
    if isinstance(l, bytes):
        l = l.decode(errors="replace")
    if isinstance(r, bytes):
        r = r.decode(errors="replace")
    if isinstance(l, (int, float)) and isinstance(r, (int, float)) \
            and not isinstance(l, bool) and not isinstance(r, bool):
        return float(l) == float(r)
    return l == r


def _project(fields, columns: dict) -> dict:
    out: dict[str, Any] = {}
    for fld in fields:
        if fld == ("*",):
            for k, v in columns.items():
                out.setdefault(k, v)
            continue
        expr, alias = fld
        val = eval_expr(expr, columns)
        if alias is None:
            alias = ".".join(expr[1]) if expr[0] == "var" else "value"
        # dotted alias builds nested maps (SELECT x AS a.b)
        parts = alias.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def apply_select(sel: Select, columns: dict) -> Optional[list[dict]]:
    """Run WHERE + SELECT (+FOREACH). Returns None if filtered out,
    else a list of result column maps (len>1 only for FOREACH)."""
    if sel.where is not None and not _truthy(eval_expr(sel.where, columns)):
        return None
    if not sel.is_foreach:
        return [_project(sel.fields, columns)]
    arr = eval_expr(sel.foreach, columns)
    if not isinstance(arr, list):
        return None
    results = []
    alias = sel.foreach_alias or "item"
    for item in arr:
        cols = {**columns, alias: item, "item": item}
        if sel.incase is not None and not _truthy(
                eval_expr(sel.incase, cols)):
            continue
        results.append(_project(sel.do_fields or [("*",)], cols)
                       if sel.do_fields else
                       {**cols})
    return results
