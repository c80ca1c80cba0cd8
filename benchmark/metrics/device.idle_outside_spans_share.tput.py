"""The share of the card's idle time of the window that no program span
covers: the ``outside`` seconds of the trace's ``idle_by_program`` split
(``program_spans.idle_by_program``) over all its idle seconds."""


def read(run):
    t = run.trace
    idle = t.get("idle_by_program") if t is not None else None
    total = sum(idle.values()) if idle else 0
    return idle.get("outside", 0.0) / total if total else None
