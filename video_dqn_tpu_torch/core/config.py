"""Typed, freezable configuration trees and the YAML subset that
experiment configs use (counterpart of video_dqn_tpu/core/config.py).

The JAX package reads `config.yml` with PyYAML, which the card's machine
does not have; `load_yaml` reads the subset that configs/experiments/*/
config.yml and yaml.safe_dump of a flat config use, and resolves each
scalar as PyYAML's YAML 1.1 resolver does (so `1e-4`, which has no dot,
stays a string there and here). It raises on anything outside the subset.
`dump_yaml` writes a config tree as yaml.safe_dump(tree, sort_keys=True)
does (ConfigNode.dump, the text of an experiment's `log`).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple


class ConfigError(Exception):
    pass


class ConfigNode:
    """Hierarchical config node with attribute access and type-checked
    merge: a merged value whose type differs from the default raises (None
    and int<->float allowed), and a frozen node rejects every change."""

    __slots__ = ("_fields", "_frozen")

    def __init__(self, init: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_fields", {})
        object.__setattr__(self, "_frozen", False)
        for k, v in (init or {}).items():
            self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._fields[name]
        except KeyError:
            raise AttributeError(f"config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._fields[name]

    def __setitem__(self, name: str, value: Any) -> None:
        if self._frozen:
            raise ConfigError(f"cannot set {name!r}: config is frozen")
        self._fields[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self._fields.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, ConfigNode) else v)
                for k, v in self._fields.items()}

    def dump(self) -> str:
        return dump_yaml(self.to_dict())

    def merge_from_dict(self, other: Dict[str, Any], _path: str = "") -> None:
        if self._frozen:
            raise ConfigError("cannot merge into a frozen config")
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self._fields:
                raise ConfigError(f"unknown config key: {full!r}")
            cur = self._fields[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise ConfigError(f"{full!r}: expected mapping, got {type(v).__name__}")
                cur.merge_from_dict(v, full)
            else:
                self._fields[k] = _coerce(cur, v, full)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            self.merge_from_dict(load_yaml(f.read()))

    def validate(self, valid_values: Dict[str, list]) -> None:
        """Raise unless each listed key holds one of its allowed values."""
        for k, allowed in valid_values.items():
            if self[k] not in allowed:
                raise ConfigError(f"invalid value for {k!r}: {self[k]!r} not in {allowed}")


def _coerce(default: Any, value: Any, path: str) -> Any:
    """Type-check a merged value against the default (yacs rules)."""
    if default is None or value is None:
        return value
    dt, vt = type(default), type(value)
    if dt is vt:
        return value
    if dt is float and vt is int:
        return float(value)
    if dt is int and vt is float and float(value).is_integer():
        return int(value)
    raise ConfigError(
        f"{path!r}: type mismatch (default {dt.__name__}, got {vt.__name__} {value!r})")


# PyYAML's YAML 1.1 implicit resolvers for the scalars the subset takes
_BOOL = {w: w.lower() in ("yes", "true", "on") for base in
         ("yes", "no", "true", "false", "on", "off")
         for w in (base, base.capitalize(), base.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
                  ".nan": float("nan")}
# other YAML 1.1 int forms (octal, hex, binary, base 60): outside the subset
_OTHER_INT = re.compile(r"[-+]?(?:0[0-9_]+|0[xob][0-9a-fA-F_]+|[0-9][0-9_]*(?::[0-9_]+)+)")


def _scalar(text: str, where: str) -> Any:
    if text[:1] == "'":
        end = re.match(r"'((?:[^']|'')*)'", text)
        if not end or text[end.end():].strip():
            raise ValueError(f"{where}: bad single-quoted string {text!r}")
        return end.group(1).replace("''", "'")
    if text[:1] == '"':
        end = re.match(r'"((?:[^"\\]|\\.)*)"', text)
        if not end or text[end.end():].strip():
            raise ValueError(f"{where}: bad double-quoted string {text!r}")
        return json.loads(end.group(0))
    if (text and text[0] in "[{&*!|>%@`") or text == "-" or text.startswith("- ") \
            or ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset this reader takes")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text.lower()]
    if _OTHER_INT.fullmatch(text):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset this reader takes")
    return text


def _strip_comment(value: str) -> str:
    """The line without a trailing ` # comment` (quoted text respected:
    '' inside single quotes and \\" inside double quotes do not close them)."""
    quote, i = None, 0
    while i < len(value):
        ch = value[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                if quote == "'" and value[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "'\"" and (i == 0 or value[i - 1] in " \t"):
            quote = ch
        elif ch == "#" and (i == 0 or value[i - 1] in " \t"):
            return value[:i].rstrip()
        i += 1
    return value.rstrip()


def load_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset: block maps of `KEY: value` lines, nested by
    indentation; scalars bare, single- or double-quoted; comments."""
    lines: List[Tuple[int, int, str]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab in indentation")
        lines.append((n, len(body) - len(body.lstrip()), body.strip()))

    def block(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines):
            n, ind, body = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            m = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_.-]*)\s*:(?:\s+(.*))?", body)
            if not m:
                raise ValueError(f"line {n}: {body!r} is not a `KEY: value` line")
            key, value = m.group(1), (m.group(2) or "").strip()
            if key in out:
                raise ValueError(f"line {n}: duplicate key {key!r}")
            i += 1
            if not value and i < len(lines) and lines[i][1] > indent:
                out[key], i = block(i, lines[i][1])
            else:
                out[key] = _scalar(value, f"line {n}")
        return out, i

    tree, end = block(0, lines[0][1] if lines else 0)
    if end < len(lines):
        raise ValueError(f"line {lines[end][0]}: indented less than the first key")
    return tree


_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}"
                        r"(?:(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)?")


def _plain_allowed(text: str) -> bool:
    """Whether PyYAML's emitter writes `text` as a plain block scalar:
    no indicator where it would start a token, no leading or trailing
    space, and a plain reading that resolves back to a string."""
    if text.startswith(("---", "...")) or text != text.strip(" "):
        return False
    if text[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if text[0] in "?:-" and (len(text) == 1 or text[1] == " "):
        return False
    if ": " in text or text.endswith(":") or " #" in text:
        return False
    if text in ("=", "<<") or _TIMESTAMP.fullmatch(text):
        return False
    try:
        return isinstance(_scalar(text, "dump"), str)
    except ValueError:
        return False


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(value, str):
        if any(not " " <= ch <= "~" for ch in value):
            # PyYAML escapes such characters in a double-quoted scalar;
            # JSON's escapes are valid YAML there, if not always the same text
            return json.dumps(value)
        if value and _plain_allowed(value):
            return value
        return "'" + value.replace("'", "''") + "'"
    raise ValueError(f"{value!r} is outside the YAML subset this writer takes")


def dump_yaml(tree: Dict[str, Any], indent: str = "") -> str:
    """`tree` (nested dicts of scalars) as yaml.safe_dump(tree,
    sort_keys=True) writes it. Plain and quoted strings are not folded at
    80 columns, as PyYAML folds long ones with spaces."""
    lines = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            lines.append(f"{indent}{key}:\n" + dump_yaml(value, indent + "  ") if value
                         else f"{indent}{key}: {{}}\n")
        else:
            lines.append(f"{indent}{key}: {_dump_scalar(value)}\n")
    return "".join(lines)
