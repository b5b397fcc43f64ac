"""The subset of YAML that the configuration files use, read and written
without a YAML library.

``experiments/cfgs/**/*.yml`` are mappings at most two levels deep of plain
or quoted scalars and flow lists (nested lists too, and lists that run over
several lines), with ``#`` comments. ``load`` reads exactly that and gives
the Python values that ``yaml.safe_load`` gives, by PyYAML's YAML 1.1
resolution rules: ``0.000005`` and ``2.0`` are floats, ``1e-5`` (no dot) is
a string, ``True``/``on``/``yes`` are booleans, ``0x1f`` and ``017`` are
ints. Anything outside the subset (block lists, anchors, tags, flow
mappings, block scalars, timestamps, several documents) raises
``ValueError`` instead of being read differently. ``dump`` writes a mapping
in the same subset, keys sorted as ``yaml.safe_dump`` sorts them, so that
``yaml.safe_load`` and ``load`` both read it back equal.
"""

from __future__ import annotations

import json
import math
import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _resolve(text: str, where: str):
    """A plain scalar -> its value, as PyYAML's SafeLoader resolves and
    constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if (_TIMESTAMP.match(text) or text[0] in "!&*|>%@`{}[],#'\"" or text[:2] in ("- ", "? ", ": ")
            or text in ("-", "?", ":") or ": " in text or text.endswith(":") or " #" in text):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset of the configuration files")
    return text


def _quoted(s: str, pos: int, where: str):
    """The quoted scalar starting at s[pos] -> (its value, the position after it)."""
    quote = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if c == quote:
            if quote == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            raise ValueError(f"{where}: unknown escape \\{e}")
        out.append(c)
        i += 1
    raise ValueError(f"{where}: unterminated quoted scalar")


def _skip_spaces(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] == " ":
        pos += 1
    return pos


def _flow_list(s: str, pos: int, where: str):
    """The flow list starting at s[pos] == "[" -> (list, the position after it)."""
    items = []
    pos = _skip_spaces(s, pos + 1)
    if s[pos:pos + 1] == "]":
        return items, pos + 1
    while True:
        pos = _skip_spaces(s, pos)
        if pos >= len(s):
            raise ValueError(f"{where}: unterminated flow list")
        if s[pos] == "[":
            item, pos = _flow_list(s, pos, where)
        elif s[pos] in "'\"":
            item, pos = _quoted(s, pos, where)
        else:
            end = pos
            while end < len(s) and s[end] not in ",]":
                end += 1
            plain = s[pos:end].strip()
            if not plain:
                raise ValueError(f"{where}: empty entry in a flow list")
            item, pos = _resolve(plain, where), end
        items.append(item)
        pos = _skip_spaces(s, pos)
        if s[pos:pos + 1] == ",":
            pos = _skip_spaces(s, pos + 1)
            if s[pos:pos + 1] == "]":
                return items, pos + 1
        elif s[pos:pos + 1] == "]":
            return items, pos + 1
        else:
            raise ValueError(f"{where}: expected ',' or ']' in a flow list")


def _value(text: str, where: str):
    """The text after ``key:`` on a line (comments stripped) -> its value."""
    if text == "{}":
        return {}
    if text[0] in "[\"'":
        value, end = (_flow_list if text[0] == "[" else _quoted)(text, 0, where)
        if text[end:].strip():
            raise ValueError(f"{where}: unexpected text after the value: {text[end:]!r}")
        return value
    return _resolve(text, where)


def _strip_comment(line: str) -> str:
    """The line without its ``#`` comment: a ``#`` at the line's start or
    after a space, outside a quoted scalar (a quote opens one only where a
    scalar starts)."""
    quote = None
    prev = " "
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 1  # the escaped character cannot close the scalar
            elif c == quote and quote == "'" and line[i + 1:i + 2] == "'":
                i += 1  # '' is a quote inside a single-quoted scalar
            elif c == quote:
                quote = None
        elif c in "'\"" and prev in " :[,":
            quote = c
        elif c == "#" and prev in " \t":
            return line[:i]
        prev = c
        i += 1
    return line


def _entries(text: str, name: str):
    """(indent, key, value text, where) per mapping entry; a flow list that
    runs over several lines is joined into its entry."""
    entries = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        where = f"{name}:{i + 1}"
        line = _strip_comment(lines[i]).rstrip()
        i += 1
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: a tab in the indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        key, sep, rest = body.partition(":")
        if not sep or (rest and rest[0] != " ") or not _KEY.match(key):
            raise ValueError(f"{where}: {body!r} is not a 'KEY: value' line of the YAML subset")
        rest = rest.strip()
        while rest.startswith("[") and rest.count("[") > rest.count("]"):
            if i >= len(lines):
                raise ValueError(f"{where}: unterminated flow list")
            rest += " " + _strip_comment(lines[i]).strip()
            i += 1
        entries.append((indent, key, rest, where))
    return entries


def _mapping(entries, i: int, indent: int):
    out = {}
    while i < len(entries):
        ind, key, rest, where = entries[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"{where}: unexpected indentation")
        i += 1
        if rest:
            out[key] = _value(rest, where)
        elif i < len(entries) and entries[i][0] > indent:
            out[key], i = _mapping(entries, i, entries[i][0])
        else:
            out[key] = None
    return out, i


def load(text: str, name: str = "<yaml>"):
    """The mapping a configuration file holds (None for a file of comments
    only, as ``yaml.safe_load`` gives)."""
    entries = _entries(text, name)
    if not entries:
        return None
    if entries[0][0] != 0:
        raise ValueError(f"{entries[0][3]}: the first key is indented")
    out, _ = _mapping(entries, 0, 0)
    return out


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):  # SafeRepresenter.represent_float
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return json.dumps(v)  # double-quoted, with the escapes both readers know
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    raise TypeError(f"{type(v).__name__} is outside the YAML subset of the configuration files")


def dump(mapping: dict) -> str:
    """A mapping (values: scalars, lists, and mappings of those) as text."""
    lines = []
    for key in sorted(mapping):
        value = mapping[key]
        if isinstance(value, dict) and value:
            lines.append(f"{key}:")
            for sub in sorted(value):
                if isinstance(value[sub], dict):
                    raise TypeError(f"{key}.{sub}: mappings nest two levels deep at most")
                lines.append(f"  {sub}: {_scalar(value[sub])}")
        else:
            lines.append(f"{key}: {'{}' if isinstance(value, dict) else _scalar(value)}")
    return "\n".join(lines) + "\n"
