"""Minimal TOML writer (stdlib ``tomllib`` is read-only; the ``toml``
package is not in this environment).

Supports the subset needed for anipose-compatible ``config.toml`` /
``calibration.toml`` files: str/bool/int/float/lists (incl. nested) and one
level of tables. Values written here round-trip through ``tomllib.load``.
"""

from __future__ import annotations

from typing import Any


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        if isinstance(v, float) and (v != v):  # NaN
            return "nan"
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[ " + ", ".join(_fmt(x) for x in v) + " ]"
    raise TypeError(f"unsupported TOML value type: {type(v)!r}")


def dumps_toml(doc: dict) -> str:
    lines: list[str] = []
    tables: list[tuple[str, dict]] = []
    for k, v in doc.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{k} = {_fmt(v)}")
    for name, tbl in tables:
        lines.append("")
        lines.append(f"[{name}]")
        for k, v in tbl.items():
            if isinstance(v, dict):
                lines.append(f"[{name}.{k}]")
                for k2, v2 in v.items():
                    lines.append(f"{k2} = {_fmt(v2)}")
            else:
                lines.append(f"{k} = {_fmt(v)}")
    return "\n".join(lines) + "\n"


def dump_toml(doc: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps_toml(doc))
