"""Config-path addressing: get/set values at paths like ``mods[0].dp[0].rx_cores[2]``.

The reference leans on the `magicattr` package for this indirection — the
Triad format's TopologyCfg section names *fields elsewhere in the config*
that hold core numbers (TriadCfgParser.py:17,124-127,169-174), and the
solved assignment is written back through the same paths
(TriadCfgParser.py:382-395). This module is the dependency-free equivalent,
operating on the ConfigDict/tuple/list trees produced by
nhd_tpu.config.libconfig.

Because libconfig lists parse as immutable tuples, setting an element inside
a tuple rebuilds that tuple in place on its parent (libconfig has no
in-place list mutation anyway — the reference works around the same
constraint by re-writing whole tuples, TriadCfgParser.py:436-452).
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple, Union

_SEGMENT_RE = re.compile(r"([A-Za-z_][A-Za-z0-9_*-]*)((?:\[\d+\])*)")
_INDEX_RE = re.compile(r"\[(\d+)\]")

Key = Union[str, int]


class PathError(AttributeError):
    """Raised when a config path does not resolve."""


def parse_path(path: str) -> List[Key]:
    """``a.b[0][1].c`` → ['a', 'b', 0, 1, 'c']"""
    keys: List[Key] = []
    for part in path.split("."):
        m = _SEGMENT_RE.fullmatch(part)
        if m is None:
            raise PathError(f"malformed path segment {part!r} in {path!r}")
        keys.append(m.group(1))
        keys.extend(int(i) for i in _INDEX_RE.findall(m.group(2)))
    return keys


def _step(obj: Any, key: Key, path: str) -> Any:
    try:
        if isinstance(key, int):
            return obj[key]
        return obj[key]
    except (KeyError, IndexError, TypeError):
        raise PathError(f"cannot resolve {key!r} while walking {path!r}") from None


def path_get(cfg: Any, path: str) -> Any:
    """Return the value at *path* inside the config tree."""
    obj = cfg
    for key in parse_path(path):
        obj = _step(obj, key, path)
    return obj


def path_parent_and_key(cfg: Any, path: str) -> Tuple[Any, Key]:
    """Return (parent container, final key) for *path*."""
    keys = parse_path(path)
    obj = cfg
    for key in keys[:-1]:
        obj = _step(obj, key, path)
    return obj, keys[-1]


def path_set(cfg: Any, path: str, value: Any) -> None:
    """Assign *value* at *path*, rebuilding any enclosing tuples.

    Tuples (libconfig ``( )`` lists) are immutable, so assignment into one
    replaces it with an updated copy on its parent, recursively up to the
    nearest mutable container (dict or list).
    """
    keys = parse_path(path)
    _set_rec(cfg, keys, value, path)


def _set_rec(obj: Any, keys: List[Key], value: Any, path: str) -> Any:
    """Set keys[0:] under obj. Returns a replacement for obj when obj is
    immutable (tuple) and had to be rebuilt; otherwise returns None."""
    key = keys[0]
    if len(keys) == 1:
        new_child = value
    else:
        child = _step(obj, key, path)
        rebuilt = _set_rec(child, keys[1:], value, path)
        if rebuilt is None:
            return None  # mutation happened in place somewhere below
        new_child = rebuilt

    if isinstance(obj, tuple):
        if not isinstance(key, int) or not (0 <= key < len(obj)):
            raise PathError(f"bad tuple index {key!r} in {path!r}")
        return obj[:key] + (new_child,) + obj[key + 1 :]
    try:
        obj[key] = new_child
    except (IndexError, KeyError, TypeError):
        raise PathError(f"cannot assign {key!r} while walking {path!r}") from None
    return None
