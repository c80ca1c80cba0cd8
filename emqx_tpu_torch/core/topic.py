"""Topic algebra: split/join/validate/wildcard/match.

Functional parity with the reference's ``apps/emqx/src/emqx_topic.erl``
(words/1, join/1, validate/1, wildcard/1, match/2, parse/1) — re-expressed
as pure Python over word lists so it can feed both the host oracle trie and
the tokenizer for the device index.

MQTT matching semantics implemented here:

- ``+`` matches exactly one level (which may be the empty word);
- ``#`` matches the remaining levels *including zero* (``a/#`` matches ``a``)
  and must be the last level of a filter;
- topics whose first level begins with ``$`` (``$SYS/...``) are NOT matched
  by filters whose first level is a wildcard (reference:
  ``emqx_topic.erl`` match clauses for ``<<$$, _>>``).
"""

from __future__ import annotations

from typing import Iterable, Optional

MAX_TOPIC_LEN = 65535

PLUS = "+"
HASH = "#"


def words(topic: str) -> list[str]:
    """Split a topic/filter into levels. ``"a//b"`` → ``["a", "", "b"]``."""
    return topic.split("/")


def join(ws: Iterable[str]) -> str:
    return "/".join(ws)


def levels(topic: str) -> int:
    return len(words(topic))


def wildcard(topic_or_words: str | list[str]) -> bool:
    """True if the filter contains ``+`` or ``#`` (emqx_topic:wildcard/1)."""
    ws = words(topic_or_words) if isinstance(topic_or_words, str) else topic_or_words
    return any(w in (PLUS, HASH) for w in ws)


def validate_name(topic: str) -> bool:
    """A publish topic: non-empty, bounded, no wildcards, no NUL."""
    return (
        0 < len(topic) <= MAX_TOPIC_LEN
        and "\x00" not in topic
        and not wildcard(topic)
    )


def validate_filter(topic: str) -> bool:
    """A subscription filter: wildcards allowed; ``#`` only at the last level."""
    if not 0 < len(topic) <= MAX_TOPIC_LEN or "\x00" in topic:
        return False
    ws = words(topic)
    for i, w in enumerate(ws):
        if w == HASH and i != len(ws) - 1:
            return False
        if w not in (PLUS, HASH) and (PLUS in w or HASH in w):
            # '+'/'#' must occupy the whole level
            return False
    return True


def validate(topic: str, kind: str = "filter") -> bool:
    return validate_name(topic) if kind == "name" else validate_filter(topic)


def is_sys(topic_or_words: str | list[str]) -> bool:
    """First level starts with '$' (``$SYS``, ``$share``, ``$queue``, ...)."""
    ws = words(topic_or_words) if isinstance(topic_or_words, str) else topic_or_words
    return bool(ws) and ws[0].startswith("$")


def match_words(name: list[str], filt: list[str]) -> bool:
    """Single filter match over word lists (emqx_topic:match/2)."""
    if is_sys(name) and filt and filt[0] in (PLUS, HASH):
        return False
    return _match(name, filt)


def _match(name: list[str], filt: list[str]) -> bool:
    for i, f in enumerate(filt):
        if f == HASH:
            # '#' swallows the rest, including zero levels ("a/#" matches "a")
            return True
        if i >= len(name):
            return False
        if f != PLUS and f != name[i]:
            return False
    return len(name) == len(filt)


def match(name: str, filt: str) -> bool:
    """Does publish-topic ``name`` match subscription-filter ``filt``?"""
    return match_words(words(name), words(filt))


# --- $share / $queue parsing (emqx_topic:parse/1) -------------------------

SHARE_PREFIX = "$share"
QUEUE_PREFIX = "$queue"


def parse_share(topic: str) -> tuple[Optional[str], str]:
    """Return ``(group, real_topic)``; group is None for non-shared topics.

    ``$share/g1/t/1`` → ``("g1", "t/1")``; ``$queue/t`` → ``("$queue", "t")``.
    """
    ws = words(topic)
    if ws[0] == SHARE_PREFIX and len(ws) >= 3:
        return ws[1], join(ws[2:])
    if ws[0] == QUEUE_PREFIX and len(ws) >= 2:
        return QUEUE_PREFIX, join(ws[1:])
    return None, topic


EXCLUSIVE_PREFIX = "$exclusive"


def parse_exclusive(topic: str) -> tuple[bool, str]:
    """``$exclusive/t/1`` → ``(True, "t/1")`` — the reference strips the
    prefix and flags the subopts (emqx_topic.erl:225-230); the
    subscription itself lands on the real topic."""
    ws = words(topic)
    if ws[0] == EXCLUSIVE_PREFIX and len(ws) >= 2:
        return True, join(ws[1:])
    return False, topic


def feed_var(template: str, bindings: dict[str, str]) -> str:
    """Substitute ``%c``/``%u``-style or ``${var}`` placeholders in a topic.

    Covers both emqx_topic:feed_var/3 and the mountpoint/auto-subscribe
    placeholder conventions. Single-pass per level: substituted values are
    never re-scanned, so a clientid that literally contains ``%u`` cannot
    inject the username expansion (the reference substitutes on parsed
    words for the same reason).
    """

    def sub_word(w: str) -> str:
        if w in bindings:
            val = bindings[w]
            return val if val is not None else ""
        # single-pass left-to-right scan for embedded placeholders
        out, i = [], 0
        while i < len(w):
            for key, val in bindings.items():
                if w.startswith(key, i):
                    out.append(val if val is not None else "")
                    i += len(key)
                    break
            else:
                out.append(w[i])
                i += 1
        return "".join(out)

    return join(sub_word(w) for w in words(template))
