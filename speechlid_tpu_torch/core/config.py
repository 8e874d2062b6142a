"""YAML config tree with hydra-compatible semantics (port of
``speechlid_tpu/core/config.py``), and a reader of the YAML it needs.

The same schema as the JAX package (trainer / module / data / logger /
stage groups):

- ``defaults: [{group: name}, ...]`` merged from ``<config_dir>/<group>/<name>.yaml``
- ``${path.to.key}`` string interpolation (recursive, cycles detected)
- dotted CLI overrides with YAML-typed values (``trainer.total_epoch=10``)
- attribute-style access via :class:`ConfigDict`

PyYAML is not imported: :func:`safe_load` reads the subset of YAML that the
repository's configs use and gives what ``yaml.safe_load`` gives for it —

- block mappings, and block sequences of scalars and of mappings;
- one-line flow sequences and mappings (``[2.0, 4.0]``, ``{values: [8, 14]}``);
- ``#`` comments; plain, single-quoted and double-quoted scalars;
- plain scalars resolved by YAML 1.1's rules as PyYAML applies them: null
  (``null``, ``~``, empty), booleans (``true``/``false``, ``yes``/``no``,
  ``on``/``off``), ints (decimal, octal, hex, binary) and floats (``1.0e-3``,
  ``.inf``; ``2e-3``, without a dot, stays a string).

Anything else (anchors and aliases, tags, block scalars ``|``/``>``,
documents, directives, complex keys, merge keys, plain or quoted scalars
over several lines, sexagesimal numbers, timestamps) raises ``ValueError``
naming the line: the reader refuses what it does not read exactly.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigDict(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def unwrap(o: Any) -> Any:
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (resolver.py), applied to plain scalars only
_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP_RE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
# a plain scalar may not start with these (YAML's indicators)
_BAD_START = set("&*!|>%@`")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int) -> None:
        self.indent, self.text, self.no = indent, text, no


def _fail(no: int, what: str) -> ValueError:
    return ValueError(f"line {no}: {what}")


def _resolve_plain(s: str, no: int) -> Any:
    """A plain scalar's value, by PyYAML's resolvers and constructors."""
    if s in _NULL:
        return None
    if s in _BOOL_TRUE:
        return True
    if s in _BOOL_FALSE:
        return False
    if _INT_RE.match(s):
        if ":" in s:
            raise _fail(no, f"sexagesimal int {s!r} is not supported")
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(s):
        if ":" in s:
            raise _fail(no, f"sexagesimal float {s!r} is not supported")
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if _TIMESTAMP_RE.match(s):
        raise _fail(no, f"timestamp {s!r} is not supported")
    if s in ("=", "<<"):
        raise _fail(no, f"{s!r} (value / merge key) is not supported")
    return s


def _strip_comment(line: str, no: int) -> str:
    """``line`` without its ``#`` comment, right-stripped.  A ``#`` at the
    start or after whitespace starts a comment unless it lies inside a
    quoted scalar, and a quote opens a scalar only where a node starts (at
    the start, after ``- ``, ``? ``, ``: ``, and after ``[``, ``{`` or ``,``
    inside a flow collection): elsewhere it is a character of a plain
    scalar.  These are the node starts :class:`_Flow` and :class:`_Block`
    read."""
    depth = 0  # flow collections open
    at_start = True  # a node may start here
    i = 0
    while i < len(line):
        c = line[i]
        nxt = line[i + 1:i + 2]
        if c in " \t":
            i += 1
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        if at_start and c in "'\"":
            i += 1
            while True:
                if i >= len(line):
                    raise _fail(no, "a quoted scalar over several lines is not supported")
                if c == "'" and line[i] == "'":
                    if line[i + 1:i + 2] != "'":
                        break
                    i += 1
                elif c == '"' and line[i] == "\\":
                    i += 1
                elif c == '"' and line[i] == '"':
                    break
                i += 1
            at_start = False
        elif at_start and c in "[{":
            depth += 1
        elif at_start and depth == 0 and c in "-?" and nxt in ("", " ", "\t"):
            pass  # a sequence item or a complex key: a node starts after it
        elif c == ":" and (nxt in ("", " ", "\t") or (depth and nxt in ",[]{}")):
            at_start = True
        elif depth and c == ",":
            at_start = True
        elif depth and c in "]}":
            depth -= 1
            at_start = False
        else:
            at_start = False
        i += 1
    return line.rstrip()


class _Flow:
    """One line's node: a flow collection, a quoted scalar or a plain
    scalar.  ``flow`` is True inside ``[...]`` or ``{...}``."""

    def __init__(self, text: str, no: int) -> None:
        self.s, self.i, self.no = text, 0, no

    def fail(self, what: str) -> ValueError:
        return _fail(self.no, f"{what} in {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def node(self, flow: bool) -> Any:
        self.skip()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        return self.plain(flow)

    def sequence(self) -> List:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.node(flow=True))
            self.skip()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c == "]":
                continue
            elif c == ":":
                raise self.fail("a single-pair mapping in a flow sequence is not supported")
            else:
                raise self.fail("unclosed or malformed flow sequence")

    def mapping(self) -> Dict:
        self.i += 1
        out: Dict = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.i += 1
                return out
            if self.peek() in ("[", "{", "?"):
                raise self.fail("a complex key is not supported")
            key = self.node(flow=True)
            self.skip()
            if self.peek() != ":":
                raise self.fail("a flow mapping entry without ':' is not supported")
            self.i += 1
            self.skip()
            value = None if self.peek() in (",", "}") else self.node(flow=True)
            out[key] = value
            self.skip()
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                raise self.fail("unclosed or malformed flow mapping")

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.fail("a quoted scalar over several lines is not supported")
            c = self.s[self.i]
            if q == "'":
                if c == "'":
                    if self.s[self.i + 1:self.i + 2] == "'":
                        out.append("'")
                        self.i += 2
                        continue
                    self.i += 1
                    return "".join(out)
                out.append(c)
                self.i += 1
                continue
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.fail("bad escape")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                else:
                    raise self.fail("bad or line-ending escape")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> Any:
        start = self.i
        c = self.peek()
        if not c or c in _BAD_START or c in ",]}" or (
                c in "-?:" and self.s[self.i + 1:self.i + 2] in ("", " ", "\t")):
            raise self.fail(f"unsupported node starting with {c!r}")
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if flow and c in ",[]{}":
                break
            if c == ":" and (nxt in ("", " ", "\t") or (flow and nxt in ",[]{}")):
                if not flow:
                    raise self.fail("a mapping is not allowed here")
                break
            self.i += 1
        return _resolve_plain(self.s[start:self.i].rstrip(), self.no)

    def whole(self) -> Any:
        """The one node the text holds, which must fill it."""
        value = self.node(flow=False)
        self.skip()
        if self.i != len(self.s):
            raise self.fail("unexpected text after the node")
        return value


def _split_key(text: str, no: int) -> Optional[Tuple[Any, str]]:
    """``key: rest`` → (key, rest); None when the line is not a mapping
    entry."""
    if text[:1] in ("'", '"'):
        f = _Flow(text, no)
        key = f.quoted()
        f.skip()
        if f.peek() == ":" and text[f.i + 1:f.i + 2] in ("", " ", "\t"):
            return key, text[f.i + 1:].strip()
        return None
    if text[:1] in ("[", "{"):
        return None
    if text.startswith("? ") or text == "?":
        raise _fail(no, "a complex key is not supported")
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    key_text = text[:m.start()].rstrip()
    if not key_text:
        raise _fail(no, "an empty key is not supported")
    return _Flow(key_text, no).whole(), text[m.end():].strip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Block:
    def __init__(self, lines: List[_Line]) -> None:
        self.lines, self.i = lines, 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        line = self.peek()
        if _is_item(line.text):
            return self.sequence(line.indent)
        if _split_key(line.text, line.no) is not None:
            return self.mapping(line.indent)
        self.i += 1
        value = _Flow(line.text, line.no).whole()
        self.no_deeper(indent, line)
        return value

    def no_deeper(self, indent: int, after: _Line) -> None:
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            raise _fail(nxt.no, f"unexpected indentation after line {after.no} "
                                "(a plain scalar over several lines is not supported)")

    def value(self, rest: str, line: _Line, indent: int, item_of_map: bool) -> Any:
        """The value after ``key:`` or ``-`` on ``line`` (``rest``) at
        ``indent``."""
        if rest:
            if rest[0] in "&*!|>":
                raise _fail(line.no, f"{rest[0]!r} (anchor, alias, tag or block scalar) "
                                     "is not supported")
            value = _Flow(rest, line.no).whole()
            self.no_deeper(indent, line)
            return value
        nxt = self.peek()
        if nxt is not None and nxt.indent > indent:
            return self.node(nxt.indent)
        if item_of_map and nxt is not None and nxt.indent == indent and _is_item(nxt.text):
            return self.sequence(indent)  # an indentless sequence under its key
        return None

    def mapping(self, indent: int) -> Dict:
        out: Dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line.no, "unexpected indentation")
            if _is_item(line.text):
                return out  # the caller's indentless sequence ends the mapping
            split = _split_key(line.text, line.no)
            if split is None:
                raise _fail(line.no, "expected 'key: value'")
            key, rest = split
            self.i += 1
            out[key] = self.value(rest, line, indent, item_of_map=True)

    def sequence(self, indent: int) -> List:
        out: List = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line.no, "unexpected indentation")
            if not _is_item(line.text):
                return out
            rest = line.text[1:].lstrip(" \t")
            if rest and (_is_item(rest) or _split_key(rest, line.no) is not None):
                # '- key: v' / '- - v': a node that starts on the item's line,
                # its further lines at the column where it starts
                column = line.indent + len(line.text) - len(rest)
                self.lines[self.i] = _Line(column, rest, line.no)
                out.append(self.node(column))
                continue
            self.i += 1
            out.append(self.value(rest, line, indent, item_of_map=False))


def safe_load(text: str) -> Any:
    """What ``yaml.safe_load(text)`` gives for the supported subset; raises
    ``ValueError`` naming the line for anything outside it."""
    lines: List[_Line] = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise _fail(no, "a tab in the indentation")
        stripped = _strip_comment(body, no)
        if not stripped:
            continue
        indent = len(raw) - len(body)
        if indent == 0 and (stripped.startswith(("---", "...", "%"))):
            raise _fail(no, "documents and directives are not supported")
        lines.append(_Line(indent, stripped, no))
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0].indent)
    if block.peek() is not None:
        raise _fail(block.peek().no, "unexpected text after the document's node")
    return value


# ---------------------------------------------------------------------------
# the config tree
# ---------------------------------------------------------------------------


def _read(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return safe_load(f.read())


def _deep_merge(base: Dict, extra: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _lookup(tree: Dict, dotted: str) -> Any:
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"interpolation key not found: {dotted}")
        node = node[part]
    return node


def _interpolate(tree: Dict) -> Dict:
    def resolve(value: Any, stack: tuple) -> Any:
        if isinstance(value, dict):
            return {k: resolve(v, stack) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, stack) for v in value]
        if isinstance(value, str):
            full = _INTERP_RE.fullmatch(value)
            if full:  # whole-string interpolation keeps the referent's type
                key = full.group(1)
                if key in stack:
                    raise ValueError(f"interpolation cycle at {key}")
                return resolve(_lookup(tree, key), stack + (key,))

            def sub(m: "re.Match[str]") -> str:
                key = m.group(1)
                if key in stack:
                    raise ValueError(f"interpolation cycle at {key}")
                return str(resolve(_lookup(tree, key), stack + (key,)))

            return _INTERP_RE.sub(sub, value)
        return value

    return resolve(tree, ())


_SCI_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _apply_override(tree: Dict, dotted: str, raw_value: str) -> None:
    value = safe_load(raw_value)
    # YAML 1.1 parses "2e-3" (no dot) as a string — coerce scientific
    # notation to float like hydra does
    if isinstance(value, str) and _SCI_FLOAT_RE.match(value):
        value = float(value)
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def load_config(
    config_dir: str,
    config_name: str,
    overrides: Optional[List[str]] = None,
) -> ConfigDict:
    """Load ``<config_dir>/<config_name>.yaml`` with defaults + overrides."""
    tree: Dict[str, Any] = _read(os.path.join(config_dir, config_name + ".yaml")) or {}

    merged: Dict[str, Any] = {}
    for entry in tree.pop("defaults", []) or []:
        if isinstance(entry, str):
            if entry == "_self_":
                merged = _deep_merge(merged, tree)
                tree = {}
                continue
            group_path = os.path.join(config_dir, entry + ".yaml")
            group_key = None
        else:
            (group_key, name), = entry.items()
            group_path = os.path.join(config_dir, str(group_key), f"{name}.yaml")
        sub = _read(group_path) or {}
        merged = _deep_merge(merged, {group_key: sub} if group_key else sub)
    merged = _deep_merge(merged, tree)

    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got: {ov}")
        key, _, val = ov.partition("=")
        _apply_override(merged, key.strip(), val.strip())

    return ConfigDict.wrap(_interpolate(merged))
