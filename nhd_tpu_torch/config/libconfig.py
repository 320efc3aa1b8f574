"""A self-contained libconfig reader/writer.

The reference workload format is libconfig (Triad configs parsed via the
`libconf` package, TriadCfgParser.py:3,40-46). That package is not vendored
here; this module implements the subset of the format the framework needs,
with the same Python-type conventions `libconf` established so the rest of
the code reads naturally:

* groups  ``{ ... }``  →  ConfigDict (a dict with attribute access)
* lists   ``( ... )``  →  tuple  (heterogeneous, may hold groups)
* arrays  ``[ ... ]``  →  list   (homogeneous scalars)
* scalars: bool / int (dec & hex, optional L/LL suffix) / float / string
  (with C escapes and adjacent-literal concatenation)
* comments: ``//``, ``#``, ``/* ... */``
* settings terminated by ``;`` or ``,`` (both accepted, either optional),
  ``=`` or ``:`` as the assignment operator.

``dumps`` emits canonical text that this parser (and libconfig proper)
reads back: the config→topology→solved-config round trip
(TriadCfgParser.py:413-459 in the reference) depends on it.
"""

from __future__ import annotations

import re
from typing import Any, IO, Iterator, List, Tuple


class ConfigError(ValueError):
    """Raised on malformed libconfig text."""


class ConfigDict(dict):
    """A dict whose items are also attributes (libconf's AttrDict analog).

    Unlike libconf's implementation, attribute *assignment* works too —
    the reference had to special-case write-back through plain indexing
    (TriadCfgParser.py:382-395,443-452); here both spellings are fine.
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<float>[-+]?(?:\d+\.\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
  | (?P<hex>0[xX][0-9a-fA-F]+L{0,2})
  | (?P<int>[-+]?\d+L{0,2})
  | (?P<bool>\b(?:true|false|TRUE|FALSE|True|False)\b)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z*][A-Za-z0-9_*-]*)
  | (?P<punct>[={}()\[\];:,])
    """,
    re.VERBOSE | re.DOTALL,
)

_STRING_ESCAPES = {
    "\\": "\\",
    '"': '"',
    "n": "\n",
    "t": "\t",
    "r": "\r",
    "f": "\f",
    "b": "\b",
    "a": "\a",
    "v": "\v",
    "0": "\0",
}


def _unescape(raw: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            if nxt == "x" and i + 3 < len(raw):
                out.append(chr(int(raw[i + 2 : i + 4], 16)))
                i += 4
                continue
            out.append(_STRING_ESCAPES.get(nxt, nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _tokenize(text: str) -> Iterator[Tuple[str, str]]:
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            line = text.count("\n", 0, pos) + 1
            raise ConfigError(f"unexpected character {text[pos]!r} at line {line}")
        pos = m.end()
        kind = m.lastgroup or ""
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()
    yield "eof", ""


class _Parser:
    def __init__(self, text: str):
        self._tokens = list(_tokenize(text))
        self._idx = 0

    def _peek(self) -> Tuple[str, str]:
        return self._tokens[self._idx]

    def _next(self) -> Tuple[str, str]:
        tok = self._tokens[self._idx]
        self._idx += 1
        return tok

    def _expect_punct(self, chars: str) -> str:
        kind, val = self._next()
        if kind != "punct" or val not in chars:
            raise ConfigError(f"expected one of {chars!r}, got {val!r}")
        return val

    def parse(self) -> ConfigDict:
        cfg = self._parse_settings(top_level=True)
        kind, val = self._peek()
        if kind != "eof":
            raise ConfigError(f"trailing content starting at {val!r}")
        return cfg

    def _parse_settings(self, top_level: bool) -> ConfigDict:
        out = ConfigDict()
        while True:
            kind, val = self._peek()
            if kind == "eof":
                if not top_level:
                    raise ConfigError("unexpected end of input inside group")
                return out
            if kind == "punct" and val == "}":
                if top_level:
                    raise ConfigError("unbalanced '}'")
                return out
            if kind != "name":
                raise ConfigError(f"expected setting name, got {val!r}")
            self._next()
            self._expect_punct("=:")
            out[val] = self._parse_value()
            kind2, val2 = self._peek()
            if kind2 == "punct" and val2 in ";,":
                self._next()

    def _parse_value(self) -> Any:
        kind, val = self._peek()
        if kind == "punct":
            if val == "{":
                self._next()
                grp = self._parse_settings(top_level=False)
                self._expect_punct("}")
                return grp
            if val == "(":
                return self._parse_list()
            if val == "[":
                return self._parse_array()
            raise ConfigError(f"unexpected {val!r} where a value was expected")
        return self._parse_scalar()

    def _parse_scalar(self) -> Any:
        kind, val = self._next()
        if kind == "int":
            return int(val.rstrip("L"))
        if kind == "hex":
            return int(val.rstrip("L"), 16)
        if kind == "float":
            return float(val)
        if kind == "bool":
            return val.lower() == "true"
        if kind == "string":
            parts = [_unescape(val[1:-1])]
            while self._peek()[0] == "string":  # adjacent-literal concatenation
                parts.append(_unescape(self._next()[1][1:-1]))
            return "".join(parts)
        raise ConfigError(f"expected scalar, got {val!r}")

    def _parse_list(self) -> tuple:
        self._expect_punct("(")
        items: List[Any] = []
        while True:
            kind, val = self._peek()
            if kind == "punct" and val == ")":
                self._next()
                return tuple(items)
            items.append(self._parse_value())
            kind, val = self._peek()
            if kind == "punct" and val == ",":
                self._next()

    def _parse_array(self) -> list:
        self._expect_punct("[")
        items: List[Any] = []
        while True:
            kind, val = self._peek()
            if kind == "punct" and val == "]":
                self._next()
                return items
            items.append(self._parse_scalar())
            kind, val = self._peek()
            if kind == "punct" and val == ",":
                self._next()


def loads(text: str) -> ConfigDict:
    """Parse libconfig text into a ConfigDict tree."""
    return _Parser(text).parse()


def load(fh: IO[str]) -> ConfigDict:
    """Parse libconfig text from a file-like object."""
    return loads(fh.read())


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _escape(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\t", "\\t").replace("\r", "\\r")
    return out


def _dump_scalar(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        text = repr(value)
        return text if any(c in text for c in ".eE") else text + ".0"
    if isinstance(value, str):
        return f'"{_escape(value)}"'
    raise ConfigError(f"cannot serialize scalar of type {type(value).__name__}")


def _dump_value(value: Any, indent: int) -> str:
    pad = " " * indent
    inner = " " * (indent + 4)
    if isinstance(value, dict):
        body = _dump_settings(value, indent + 4)
        return "{\n" + body + pad + "}"
    if isinstance(value, tuple):
        if not value:
            return "( )"
        items = ",\n".join(inner + _dump_value(v, indent + 4) for v in value)
        return "(\n" + items + "\n" + pad + ")"
    if isinstance(value, list):
        return "[ " + ", ".join(_dump_scalar(v) for v in value) + " ]"
    return _dump_scalar(value)


def _dump_settings(cfg: dict, indent: int) -> str:
    pad = " " * indent
    lines = []
    for key, value in cfg.items():
        lines.append(f"{pad}{key} = {_dump_value(value, indent)};\n")
    return "".join(lines)


def dumps(cfg: dict) -> str:
    """Serialize a ConfigDict tree back to libconfig text."""
    return _dump_settings(cfg, 0)
