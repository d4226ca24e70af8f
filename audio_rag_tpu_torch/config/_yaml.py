"""A reader of the YAML subset that the shipped profiles use (the port
imports no YAML package).

It reads block mappings nested by indentation (spaces), plain,
single-quoted and double-quoted scalars, full-line and trailing comments
(a ``#`` after a space, outside quotes), flow sequences of scalars on
one line (``fallback_temperatures: [0.2, 0.4]``), and a key's block
sequence whose items are flow mappings of scalars on one line each
(``queues:`` then ``- {name: high, timeout_s: 3600}``, as
``configs/queue.yaml`` has it). Scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1): ``yes``/``no``/``on``/
``off``/``true``/``false`` in three casings are booleans, ``~``, ``null``
and an empty value are None, ``14.0`` is a float but ``1e-3`` is a string
(a float needs a dot), ``0x1F``/``017``/``0b101``/``1:30`` are integers,
and a quoted scalar is always a string. Duplicate keys keep the last
value, as ``safe_load`` does.

Anything else raises ``ConfigError`` naming the file and the line: tabs,
anchors, aliases and tags, block sequences of anything but one-line
flow mappings, flow mappings elsewhere, block and multi-line scalars, complex keys, timestamps, merge keys and
document markers. An empty file gives ``{}``; a root that is not a
mapping raises.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

from audio_rag_tpu_torch.core.exceptions import ConfigError

__all__ = ["read_yaml", "parse_yaml"]

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}
#: a plain scalar cannot start with these
_INDICATORS = set("[]{}#&*!|>'\"%@`,")


class _Error(Exception):
    pass


def _sexagesimal(text: str, cast) -> Any:
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve(text: str) -> Any:
    """A plain scalar's value, as ``yaml.safe_load`` constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise _Error(f"timestamp {text!r} is not supported")
    if text in ("<<", "="):
        raise _Error(f"merge or value key {text!r} is not supported")
    return text


def _single_quoted(s: str, i: int) -> tuple[str, int]:
    out = []
    i += 1
    while i < len(s):
        if s[i] == "'":
            if s.startswith("''", i):
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(s[i])
        i += 1
    raise _Error("unterminated single-quoted scalar (multi-line scalars "
                 "are not supported)")


def _double_quoted(s: str, i: int) -> tuple[str, int]:
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            if i + 1 >= len(s):
                raise _Error("escaped line break is not supported")
            e = s[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                n = _HEX[e]
                code = s[i + 2: i + 2 + n]
                if len(code) != n or not all(
                        ch in "0123456789abcdefABCDEF" for ch in code):
                    raise _Error(f"bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                i += 2 + n
            else:
                raise _Error(f"unknown escape \\{e}")
            continue
        out.append(c)
        i += 1
    raise _Error("unterminated double-quoted scalar (multi-line scalars "
                 "are not supported)")


def _quoted(s: str, i: int) -> tuple[str, int]:
    return (_single_quoted if s[i] == "'" else _double_quoted)(s, i)


def _rest_is_comment(s: str, i: int) -> None:
    rest = s[i:]
    if rest.strip() and not (rest.lstrip().startswith("#")
                             and (rest[:1].isspace())):
        raise _Error(f"unexpected text after a scalar: {rest.strip()!r}")


def _plain_end(s: str, i: int, flow: bool) -> int:
    """Where a plain scalar starting at ``i`` ends: at " #", at ": "
    (refused by the caller), or in a flow sequence at "," or "]"."""
    j = i
    while j < len(s):
        c = s[j]
        if c == "#" and j > i and s[j - 1] in " ":
            break
        if flow and c in ",[]{}":
            break
        if c == ":" and (j + 1 == len(s) or s[j + 1] == " "
                         or (flow and s[j + 1] in ",[]{}")):
            break
        j += 1
    return j


def _check_plain_start(text: str) -> None:
    if text[0] in _INDICATORS or (text[0] in "-?:" and (
            len(text) == 1 or text[1] == " ")):
        what = {"[": "a flow sequence here", "{": "a flow mapping",
                "&": "an anchor", "*": "an alias", "!": "a tag",
                "|": "a block scalar", ">": "a block scalar",
                "-": "a block sequence", "?": "a complex key"}.get(
                    text[0], f"a scalar starting with {text[0]!r}")
        raise _Error(f"{what} is not supported")


def _flow_sequence(s: str, i: int) -> tuple[list, int]:
    out: list = []
    i += 1
    expect_item = True
    while True:
        while i < len(s) and s[i] == " ":
            i += 1
        if i >= len(s):
            raise _Error("unterminated flow sequence (multi-line flow "
                         "sequences are not supported)")
        c = s[i]
        if c == "]":
            return out, i + 1
        if c == ",":
            if expect_item:
                raise _Error("empty item in a flow sequence")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise _Error("missing ',' in a flow sequence")
        if c in "'\"":
            value, i = _quoted(s, i)
        else:
            j = _plain_end(s, i, flow=True)
            text = s[i:j].rstrip()
            if not text or s[j: j + 1] == ":":
                raise _Error("only scalars are supported in a flow sequence")
            _check_plain_start(text)
            value, i = _resolve(text), j
        out.append(value)
        expect_item = False


def _flow_scalar(s: str, i: int) -> tuple[Any, int]:
    """A quoted or plain scalar inside a flow collection."""
    if s[i] in "'\"":
        return _quoted(s, i)
    j = _plain_end(s, i, flow=True)
    text = s[i:j].rstrip()
    if not text:
        return None, j
    _check_plain_start(text)
    return _resolve(text), j


def _flow_mapping(s: str, i: int) -> tuple[dict, int]:
    """``{key: scalar, ...}`` on one line, from its ``{`` at ``i``."""
    out: dict = {}
    i += 1
    expect_item = True
    while True:
        while i < len(s) and s[i] == " ":
            i += 1
        if i >= len(s):
            raise _Error("unterminated flow mapping (multi-line flow "
                         "mappings are not supported)")
        c = s[i]
        if c == "}":
            return out, i + 1
        if c == ",":
            if expect_item:
                raise _Error("empty item in a flow mapping")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise _Error("missing ',' in a flow mapping")
        if c in "[{":
            raise _Error("only scalars are supported in a flow mapping")
        key, i = _flow_scalar(s, i)
        while i < len(s) and s[i] == " ":
            i += 1
        if s[i: i + 1] != ":":
            raise _Error("expected 'key: value' in a flow mapping")
        i += 1
        while i < len(s) and s[i] == " ":
            i += 1
        if s[i: i + 1] in ("[", "{"):
            raise _Error("only scalars are supported in a flow mapping")
        value, i = (None, i) if s[i: i + 1] in (",", "}") else \
            _flow_scalar(s, i)
        out[key] = value
        expect_item = False


def _sequence_item(s: str, i: int) -> dict:
    """The flow mapping of a ``- {...}`` line from column ``i``."""
    j = i + 1
    while j < len(s) and s[j] == " ":
        j += 1
    if s[j: j + 1] != "{":
        raise _Error("a block sequence is supported only with one-line flow "
                     "mappings as items")
    item, j = _flow_mapping(s, j)
    _rest_is_comment(s, j)
    return item


def _value(s: str, i: int) -> Any:
    """The value of a ``key: value`` line from column ``i`` (not empty)."""
    if s[i] in "'\"":
        value, j = _quoted(s, i)
        _rest_is_comment(s, j)
        return value
    if s[i] == "[":
        value, j = _flow_sequence(s, i)
        _rest_is_comment(s, j)
        return value
    j = _plain_end(s, i, flow=False)
    if j < len(s) and s[j] == ":":
        raise _Error("a mapping inside a value is not supported")
    text = s[i:j].rstrip()
    _check_plain_start(text)
    return _resolve(text)


def _key(s: str, i: int) -> tuple[Any, int]:
    """A mapping key from column ``i``; returns (key, column after ':')."""
    if s[i] in "'\"":
        key, j = _quoted(s, i)
        if s[j: j + 1] != ":" or (j + 1 < len(s) and s[j + 1] != " "):
            raise _Error("expected ':' after a quoted key")
        return key, j + 1
    j = _plain_end(s, i, flow=False)
    if j >= len(s) or s[j] != ":":
        raise _Error("expected 'key: value' (multi-line scalars and "
                     "sequences are not supported)")
    text = s[i:j].rstrip()
    _check_plain_start(text)
    return _resolve(text), j + 1


def _is_key_line(line: str, i: int) -> bool:
    """Whether the content from column ``i`` is a ``key:`` line."""
    if line[i] in "'\"":
        try:
            _, j = _quoted(line, i)
        except _Error:
            return False
        return line[j: j + 1] == ":"
    j = _plain_end(line, i, flow=False)
    return j < len(line) and line[j] == ":"


def parse_yaml(text: str, name: str = "<string>") -> dict[str, Any]:
    """The mapping that ``text`` holds ({} when it holds nothing)."""
    root: dict[str, Any] = {}
    # (indent, mapping) from the root down; the root's indent is its
    # first key's
    stack: list[tuple[int | None, dict]] = [(None, root)]
    # a key with nothing after its ':' (a nested mapping, a sequence or
    # None)
    pending: tuple[dict, Any, int] | None = None
    # the block sequence being read and the column of its "-"
    seq: tuple[list, int] | None = None
    for lineno, line in enumerate(text.splitlines(), 1):
        try:
            if "\t" in line:
                raise _Error("tabs are not supported")
            body = line.lstrip(" ")
            if not body or body.startswith("#"):
                continue
            indent = len(line) - len(body)
            if indent == 0 and body.startswith(("---", "...", "%")):
                raise _Error("document markers and directives are not "
                             "supported")
            if body == "-" or body.startswith("- "):
                if pending is not None and indent >= pending[2]:
                    parent, key, _ = pending
                    pending = None
                    seq = ([], indent)
                    parent[key] = seq[0]
                elif seq is None or indent != seq[1]:
                    raise _Error("a block sequence is not supported here")
                seq[0].append(_sequence_item(line, indent))
                continue
            seq = None
            if not _is_key_line(line, indent):
                if body[0] not in "[{'\"":
                    _check_plain_start(body)
                if stack[0][0] is None:
                    raise ConfigError(f"config root must be a mapping: "
                                      f"{name}", context={"path": name})
                raise _Error("expected 'key: value' (multi-line scalars "
                             "are not supported)")
            if pending is not None:
                parent, key, key_indent = pending
                pending = None
                if indent > key_indent:
                    child: dict[str, Any] = {}
                    parent[key] = child
                    stack.append((indent, child))
            while len(stack) > 1 and indent < stack[-1][0]:
                stack.pop()
            if stack[0][0] is None:
                stack[0] = (indent, root)
            if indent != stack[-1][0]:
                raise _Error("bad indentation")
            mapping = stack[-1][1]
            key, j = _key(line, indent)
            while j < len(line) and line[j] == " ":
                j += 1
            if j >= len(line) or line[j] == "#":
                mapping[key] = None
                pending = (mapping, key, indent)
            else:
                mapping[key] = _value(line, j)
        except _Error as exc:
            raise ConfigError(f"{name}:{lineno}: {exc}",
                              context={"path": name, "line": lineno}
                              ) from None
    return root


def read_yaml(path: str | Path) -> dict[str, Any]:
    """The mapping in the file at ``path`` ({} for an empty file)."""
    path = Path(path)
    try:
        text = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as exc:
        raise ConfigError(f"cannot read {path}: {exc}",
                          context={"path": str(path)}) from exc
    return parse_yaml(text, str(path))
