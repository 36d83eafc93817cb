"""A small YAML reader and writer for imgstore ``metadata.yaml`` files, so
that reading or writing a store needs no PyYAML.

``load`` covers what imgstore metadata holds: nested block mappings, block
sequences (indented or, as PyYAML writes them, indentless), flow
sequences and mappings, and plain, single- or double-quoted scalars
resolved as ``yaml.safe_load`` resolves them (YAML 1.1: ``null``/``~``,
the booleans with ``yes``/``no``/``on``/``off``, decimal, octal, hex,
binary and base-60 ints, floats with ``.inf``/``.nan``). Plain timestamps
stay strings; anchors, aliases, tags and block scalars (``|``, ``>``)
raise ``ValueError``.

``dump`` writes what ``yaml.safe_dump(obj)`` writes for a mapping or a
sequence of mappings, sequences, ``None``, bools, ints, floats and
printable ASCII strings: sorted keys, two-space indentation, indentless
block sequences, ``{}``/``[]`` for empty collections and PyYAML's choice
between plain and single-quoted strings. Long strings are not folded at
80 columns as PyYAML folds them.
"""

from __future__ import annotations

import math
import re

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers (resolver.py), whole-string matches
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_TIMESTAMP = re.compile(
    r"[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _resolve(text: str):
    """A plain scalar's value, as ``yaml.safe_load`` gives it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
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
    if _FLOAT.fullmatch(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


# ------------------------------------------------------------------ load


def _quoted(text: str, i: int):
    """The quoted scalar starting at ``text[i]``; returns (value, end)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                out.append(chr(int(text[j + 2:j + 2 + n], 16)))
                j += 2 + n
            else:
                raise ValueError(f"bad escape in {text!r}")
            continue
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _flow(text: str, i: int):
    """The flow collection or scalar starting at ``text[i]``; returns
    (value, end)."""
    while text[i] == " ":
        i += 1
    c = text[i]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items = [] if c == "[" else {}
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                return items, i + 1
            v, i = _flow(text, i)
            while text[i] == " ":
                i += 1
            if c == "{":
                if text[i] != ":":
                    raise ValueError(f"bad flow mapping: {text!r}")
                items[v], i = _flow(text, i + 1)
                while text[i] == " ":
                    i += 1
            else:
                items.append(v)
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"bad flow collection: {text!r}")
    if c in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}")):
        j += 1
    return _resolve(text[i:j].strip()), j


def _plain_end(text: str) -> int:
    """Where a plain scalar ends: at a comment (`` #``) or the line's end."""
    j = text.find(" #")
    return len(text) if j < 0 else j


def _inline(text: str):
    """A value written on one line after ``key:`` or ``- ``."""
    if text[0] in "&*!|>":
        raise ValueError(f"unsupported YAML: {text!r}")
    if text[0] in "[{'\"":
        value, end = _flow(text, 0)
        rest = text[end:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"trailing text after {text!r}")
        return value
    return _resolve(text[:_plain_end(text)].strip())


def _key_split(text: str):
    """(key, rest) when ``text`` is a mapping entry, else None."""
    j = 0
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
        if text[j:j + 1] != ":":
            return None
    else:
        if text[0] in "[{":
            return None
        end = _plain_end(text)
        while j < end and not (
                text[j] == ":" and (j + 1 == len(text) or text[j + 1] == " ")):
            j += 1
        if j >= end:
            return None
        key = _resolve(text[:j].strip())
    rest = text[j + 1:].strip()
    return key, "" if rest.startswith("#") else rest


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i: int, indent: int):
    text = lines[i][1]
    if _is_item(text):
        return _sequence(lines, i, indent)
    if _key_split(text) is not None:
        return _mapping(lines, i, indent)
    return _inline(text), i + 1


def _nested(lines, i: int, indent: int, seq_ok: bool):
    """The block under an entry whose own line ended at ``i - 1``."""
    if i < len(lines) and (lines[i][0] > indent or (
            seq_ok and lines[i][0] == indent and _is_item(lines[i][1]))):
        return _block(lines, i, lines[i][0])
    return None, i


def _mapping(lines, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i][0] == indent \
            and not _is_item(lines[i][1]):
        kv = _key_split(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value': {lines[i][1]!r}")
        key, rest = kv
        if rest:
            out[key] = _inline(rest)
            i += 1
        else:
            out[key], i = _nested(lines, i + 1, indent, True)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation: {lines[i][1]!r}")
    return out, i


def _sequence(lines, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].lstrip()
        if not rest or rest.startswith("#"):
            value, i = _nested(lines, i + 1, indent, False)
        else:
            # the item's text is a block of its own at its column
            col = indent + len(lines[i][1]) - len(rest)
            lines[i] = (col, rest)
            value, i = _block(lines, i, col)
        out.append(value)
    return out, i


def load(text: str):
    """Parse a YAML document of the subset above (``yaml.safe_load``)."""
    lines = []
    for raw in text.splitlines():
        if raw.startswith(("%", "---", "...")):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation")
        line = raw.strip()
        if line and not line.startswith("#"):
            lines.append((len(raw) - len(raw.lstrip(" ")), line))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unparsed YAML from: {lines[i][1]!r}")
    return value


# ------------------------------------------------------------------ dump


def _plain_ok(s: str) -> bool:
    """PyYAML's ``analyze_scalar`` and ``choose_scalar_style`` for a
    printable ASCII string in block context."""
    if not s:
        return False
    if _resolve(s) is not s or _TIMESTAMP.fullmatch(s) or s in ("=", "<<"):
        return False
    if s[0] == " " or s[-1] == " ":
        return False
    if s.startswith(("---", "...")):
        return False
    ws = " \t"
    for j, c in enumerate(s):
        followed = j + 1 == len(s) or s[j + 1] in ws
        if j == 0:
            if c in "#,[]{}&*!|>'\"%@`":
                return False
            if c in "?:-" and followed:
                return False
        else:
            if c == ":" and followed:
                return False
            if c == "#" and s[j - 1] in ws:
                return False
    return True


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        if not all(" " <= c <= "~" for c in v):
            raise ValueError(f"only printable ASCII strings: {v!r}")
        if _plain_ok(v):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _empty(v) -> bool:
    return isinstance(v, (dict, list)) and not v


def _lines(obj, indent: int) -> list:
    pad = " " * indent
    out = []
    if isinstance(obj, dict):
        try:
            keys = sorted(obj)
        except TypeError:               # mixed key types: PyYAML keeps order
            keys = list(obj)
        for k in keys:
            v = obj[k]
            if k == "":
                raise ValueError("an empty key needs YAML's complex-key form")
            ks = _scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{ks}:")
                out += _lines(v, indent + 2)
            elif isinstance(v, list) and v:
                out.append(f"{pad}{ks}:")
                out += _lines(v, indent)          # indentless, as PyYAML
            else:
                out.append(f"{pad}{ks}: {_value(v)}")
        return out
    for v in obj:
        if isinstance(v, (dict, list)) and v:
            sub = _lines(v, indent + 2)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out += sub[1:]
        else:
            out.append(f"{pad}- {_value(v)}")
    return out


def _value(v) -> str:
    if _empty(v):
        return "{}" if isinstance(v, dict) else "[]"
    return _scalar(v)


def dump(obj) -> str:
    """The text ``yaml.safe_dump(obj)`` writes, for a non-empty mapping or
    sequence of the types above."""
    if not isinstance(obj, (dict, list)) or not obj:
        raise TypeError("dump takes a non-empty mapping or sequence")
    return "\n".join(_lines(obj, 0)) + "\n"
