"""Read the YAML of ``training_configs/`` into the port's dataclasses,
without PyYAML or pydantic (the card's machine has neither).

:func:`parse_yaml` parses the subset of YAML those files use — block
mappings and sequences by indentation, sequences of mappings, flow
sequences and mappings (``[0.9, 0.95]``, ``{}``), quoted and plain
scalars, comments — and resolves plain scalars as PyYAML's ``safe_load``
does (YAML 1.1: ``True``/``no``/``~``, ints, and floats only with a dot,
so ``3e-3`` stays a string); it returns what ``yaml.safe_load`` returns.
Anything outside the subset (anchors, tags, block scalars, multi-document
streams) raises.

:func:`from_dict` builds a dataclass from such a mapping with pydantic's
lax coercions (a numeric string or an int to a float field, a list to a
tuple, a value to an Enum); unknown keys are ignored, as a pydantic model
ignores them, and a missing required field raises.  A ``Union`` of
dataclasses is decided as pydantic's smart mode decides it for these
configs: the members that the mapping validates as, and of those the one
that takes the most of its keys (``rotator_config: {ff_mult: 2}`` is an
``MLPConfig``, the MoE fields make an ``MoEConfig``).
"""
from __future__ import annotations

import dataclasses
import enum
import re
import typing
from pathlib import Path
from typing import Any, Dict, List, Tuple

from image2text_torch.configs.trainer import TrainingConfig

# PyYAML's implicit resolvers (yaml/resolver.py), for the plain scalars
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _plain(text: str) -> Any:
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if text[0] in "&*!|>%@`":
        raise ValueError(f"YAML outside the supported subset: {text!r}")
    return text


def _quoted(text: str) -> Tuple[str, str]:
    """(the scalar a quoted string at the start of ``text`` gives, the rest
    of ``text`` after it)."""
    q = text[0]
    i, out = 1, []
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            nxt = text[i + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(
                nxt, "\\" + nxt))
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a '#' at the start or after a
    space, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow(text: str) -> Tuple[Any, str]:
    """(value, rest) of the flow node at the start of ``text``."""
    text = text.lstrip()
    if text[0] in "'\"":
        return _quoted(text)
    if text[0] in "[{":
        close = "]" if text[0] == "[" else "}"
        items: List[Any] = []
        mapping: Dict[Any, Any] = {}
        rest = text[1:].lstrip()
        while not rest.startswith(close):
            if close == "}":
                key, rest = _flow(rest)
                rest = rest.lstrip()
                if not rest.startswith(":"):
                    raise ValueError(f"flow mapping without ':': {text!r}")
                value, rest = _flow(rest[1:])
                mapping[key] = value
            else:
                value, rest = _flow(rest)
                items.append(value)
            rest = rest.lstrip()
            if rest.startswith(","):
                rest = rest[1:].lstrip()
            elif not rest.startswith(close):
                raise ValueError(f"bad flow collection: {text!r}")
        return (mapping if close == "}" else items), rest[1:]
    m = re.match(r"[^,\]\}]*?(?=\s*(?:[,\]\}]|:\s|$))", text)
    return _plain(m.group(0).strip()), text[m.end():]


def _scalar(text: str) -> Any:
    value, rest = _flow(text)
    if rest.strip():
        raise ValueError(f"trailing text after a value: {text!r}")
    return value


def _key_value(text: str):
    """(key, rest) of a mapping entry ``key: rest``, or None."""
    if text[0] in "'\"":
        key, rest = _quoted(text)
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    m = re.match(r"([^:#'\"\[\]{},]+?):(?:\s+|$)(.*)$", text)
    if m is None:
        return None
    return _plain(m.group(1).strip()), m.group(2).strip()


class _Lines:
    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("tab indentation is not YAML")
            line = _strip_comment(raw)
            if line.strip() in ("---", "..."):
                raise ValueError("multi-document YAML is outside the subset")
            if line.strip():
                self.lines.append((len(line) - len(line.lstrip()),
                                   line.strip()))
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None


def _block(lines: _Lines, indent: int) -> Any:
    """The block node whose lines start at ``indent``."""
    ind, text = lines.peek()
    if text == "-" or text.startswith("- "):
        return _sequence(lines, ind)
    return _mapping(lines, ind)


def _value_after(lines: _Lines, rest: str, indent: int, seq_ok: bool) -> Any:
    """The value of an entry whose text after the indicator is ``rest``:
    inline, or the block on the next lines (deeper than ``indent``; a
    sequence may also sit at ``indent`` itself under a mapping key)."""
    if rest:
        return _scalar(rest)
    nxt = lines.peek()
    if nxt is None:
        return None
    ind, text = nxt
    if ind > indent or (seq_ok and ind == indent
                        and (text == "-" or text.startswith("- "))):
        return _block(lines, ind)
    return None


def _mapping(lines: _Lines, indent: int) -> Dict[Any, Any]:
    out: Dict[Any, Any] = {}
    while (nxt := lines.peek()) is not None and nxt[0] == indent:
        kv = _key_value(nxt[1])
        if kv is None:
            if nxt[1].startswith("- "):
                break
            raise ValueError(f"expected 'key: value', got {nxt[1]!r}")
        lines.i += 1
        key, rest = kv
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        out[key] = _value_after(lines, rest, indent, seq_ok=True)
    if (nxt := lines.peek()) is not None and nxt[0] > indent:
        raise ValueError(f"bad indentation at {nxt[1]!r}")
    return out


def _sequence(lines: _Lines, indent: int) -> List[Any]:
    out: List[Any] = []
    while (nxt := lines.peek()) is not None and nxt[0] == indent and (
            nxt[1] == "-" or nxt[1].startswith("- ")):
        rest = nxt[1][1:].strip()
        kv = _key_value(rest) if rest and rest[0] not in "[{" else None
        if kv is None:
            lines.i += 1
            out.append(_value_after(lines, rest, indent, seq_ok=False))
            continue
        # a mapping whose first entry shares the dash's line: its keys sit
        # at the column after "- "
        col = indent + len(nxt[1]) - len(rest)
        lines.lines[lines.i] = (col, rest)
        out.append(_mapping(lines, col))
    return out


def parse_yaml(text: str) -> Any:
    """What ``yaml.safe_load(text)`` returns, for the supported subset."""
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    value = _block(lines, lines.peek()[0])
    if lines.peek() is not None:
        raise ValueError(f"unparsed YAML from {lines.peek()[1]!r}")
    return value


# -- dataclasses from mappings ------------------------------------------------

def _convert(value: Any, tp: Any, path: str) -> Any:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:
        if value is None and type(None) in args:
            return None
        fits = []
        for member in args:
            if member is type(None):
                continue
            try:
                fits.append((member, _convert(value, member, path)))
            except (TypeError, ValueError, KeyError):
                continue
        if not fits:
            raise ValueError(f"{path}: {value!r} fits no member of {tp}")
        if isinstance(value, dict):
            def taken(item):
                member = item[0]
                if not dataclasses.is_dataclass(member):
                    return 0
                names = {f.name for f in dataclasses.fields(member)}
                return len(names & set(value))
            return max(fits, key=taken)[1]
        return fits[0][1]
    if dataclasses.is_dataclass(tp):
        if not isinstance(value, dict):
            raise TypeError(f"{path}: {tp.__name__} needs a mapping, got "
                            f"{value!r}")
        return from_dict(tp, value, path)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(value)
    if origin in (list, List):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: a list needed, got {value!r}")
        return [_convert(v, args[0], f"{path}[{i}]")
                for i, v in enumerate(value)]
    if origin in (tuple, Tuple):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: a tuple needed, got {value!r}")
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_convert(v, args[0], path) for v in value)
        if len(args) != len(value):
            raise ValueError(f"{path}: {len(args)} values needed, got "
                             f"{value!r}")
        return tuple(_convert(v, a, path) for v, a in zip(value, args))
    if tp is float:
        if isinstance(value, bool):
            raise TypeError(f"{path}: a float needed, got {value!r}")
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            return float(value.strip())
        raise TypeError(f"{path}: a float needed, got {value!r}")
    if tp is int:
        if isinstance(value, bool):
            raise TypeError(f"{path}: an int needed, got {value!r}")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str) and re.fullmatch(r"[-+]?\d+", value.strip()):
            return int(value)
        raise TypeError(f"{path}: an int needed, got {value!r}")
    if tp is bool:
        if isinstance(value, bool):
            return value
        raise TypeError(f"{path}: a bool needed, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise TypeError(f"{path}: a string needed, got {value!r}")
    return value


def from_dict(cls, data: Dict[str, Any], path: str = ""):
    """An instance of the dataclass ``cls`` from the mapping ``data``."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        where = f"{path}.{f.name}" if path else f.name
        if f.name in data:
            kwargs[f.name] = _convert(data[f.name], hints[f.name], where)
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise KeyError(f"{where}: required field missing")
    return cls(**kwargs)


def load_training_config(path) -> TrainingConfig:
    """The :class:`TrainingConfig` of a ``training_configs/`` YAML file."""
    return from_dict(TrainingConfig, parse_yaml(Path(path).read_text()))


__all__ = ["from_dict", "load_training_config", "parse_yaml"]
