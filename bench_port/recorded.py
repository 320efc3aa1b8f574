"""Reading the program's flight recorder out of a traced run: the spans
(``run["spans"]``, each as ``Span.to_dict`` gives it) and the tallies
(``run["tallies"]``: name -> (count, seconds)) it recorded in the
window. Untraced runs record none, and then every reading is None; so
is every span reading of a window whose ring dropped spans
(``run["dropped"]``), which would read short."""

from __future__ import annotations

from typing import Optional


def span_ms(run: dict, name: str, attr: Optional[str] = None) -> Optional[float]:
    """The seconds of the spans named *name* (or, given *attr*, the sum
    of that attribute of theirs) a window gang, in ms; None where the
    window recorded no such span or dropped any."""
    gangs = run["gangs"]
    if run.get("dropped"):
        return None
    got = [s for s in run.get("spans") or () if s["name"] == name]
    if not got or not gangs:
        return None
    if attr is None:
        total = sum(s["dur"] for s in got)
    else:
        total = sum(s.get("attrs", {})[attr] for s in got)
    return 1e3 * total / len(gangs)


def tally_ms(run: dict, name: str) -> Optional[float]:
    """The seconds of tally *name* a window gang, in ms; None where the
    window recorded no call of it. Tallies are kept apart from the ring,
    so a drop leaves them whole."""
    gangs = run["gangs"]
    count, seconds = (run.get("tallies") or {}).get(name, (0, 0.0))
    return 1e3 * seconds / len(gangs) if count and gangs else None
