"""A reader for the YAML that ``configs/`` and ``studies/`` are written in,
and for CLI override values (the card's machine has no PyYAML).

The subset: block mappings and sequences (a sequence may sit at its key's
indentation), flow mappings and sequences (which may run over several
lines), comments, single- and double-quoted strings, and plain scalars
resolved as PyYAML's ``safe_load`` resolves them (YAML 1.1): ``null``,
``~`` and empty values; bools (``true``, ``yes``, ``on`` ...); ints
(decimal, ``0x``, ``0b``, a leading ``0`` for octal, ``_`` separators);
floats, which need a dot (``1.0e-05``; ``1e-5`` stays a string), ``.inf``
and ``.nan``; anything else is a string.  Anchors, tags, block scalars
(``|``, ``>``), multi-line plain scalars, several documents, sexagesimal
numbers and timestamps raise ``ValueError``.
"""

from __future__ import annotations

import re

_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# what PyYAML would read as a sexagesimal number or a timestamp
_UNSUPPORTED_RE = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                             r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?)$")
_FLOW_END = ",]}"


def scalar(text: str):
    """A plain scalar's value, as PyYAML's resolver and constructors give it."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return _BOOL[text.lower()]
    if _INT_RE.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value != "0" and value.startswith("0"):
            return sign * int(value, 8)
        return sign * int(value)
    if _FLOAT_RE.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        return sign * float(value)
    if _UNSUPPORTED_RE.match(text):
        raise ValueError(f"yaml_lite: {text!r} is a sexagesimal number or a timestamp in "
                         "YAML 1.1, which this reader does not take")
    return text


def _quoted(text: str, pos: int) -> tuple[str, int]:
    """The quoted string starting at ``text[pos]`` and the position after it."""
    quote = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
        else:
            if ch == '"':
                return "".join(out), i + 1
            if ch == "\\":
                esc = text[i + 1:i + 2]
                if esc == "u":
                    out.append(chr(int(text[i + 2:i + 6], 16)))
                    i += 6
                    continue
                table = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0",
                         "r": "\r", " ": " "}
                if esc not in table:
                    raise ValueError(f"yaml_lite: unsupported escape \\{esc}")
                out.append(table[esc])
                i += 2
                continue
        out.append(ch)
        i += 1
    raise ValueError(f"yaml_lite: unterminated string {text[pos:]!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a ``#`` at the start or after a blank,
    outside quotes) and trailing blanks."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive descent over one flow collection's text."""

    def __init__(self, text: str):
        self.text, self.pos = text, 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def _expect(self, ch: str):
        self._skip()
        if self.text[self.pos:self.pos + 1] != ch:
            raise ValueError(f"yaml_lite: expected {ch!r} at {self.text[self.pos:]!r}")
        self.pos += 1

    def node(self, key: bool = False):
        self._skip()
        ch = self.text[self.pos:self.pos + 1]
        if ch == "{":
            self.pos += 1
            out = {}
            self._skip()
            while self.text[self.pos] != "}":
                k = self.node(key=True)
                self._expect(":")
                self._skip()
                out[k] = None if self.text[self.pos] in _FLOW_END else self.node()
                self._skip()
                if self.text[self.pos] == ",":
                    self.pos += 1
                    self._skip()
            self.pos += 1
            return out
        if ch == "[":
            self.pos += 1
            out = []
            self._skip()
            while self.text[self.pos] != "]":
                out.append(self.node())
                self._skip()
                if self.text[self.pos] == ",":
                    self.pos += 1
                    self._skip()
            self.pos += 1
            return out
        if ch in ("'", '"'):
            value, self.pos = _quoted(self.text, self.pos)
            return value
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in _FLOW_END or (c == ":" and (key or self.text[self.pos + 1:self.pos + 2]
                                                in (" ", "\n", ",", "]", "}", ""))):
                break
            self.pos += 1
        return scalar(self.text[start:self.pos].strip())


def _flow_open(text: str) -> int:
    """How many flow brackets ``text`` leaves open (outside quotes)."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _value(text: str):
    """An inline value: a flow collection, a quoted string or a plain scalar."""
    if text[:1] in ("[", "{"):
        flow = _Flow(text)
        out = flow.node()
        if text[flow.pos:].strip():
            raise ValueError(f"yaml_lite: text after a flow collection: {text!r}")
        return out
    if text[:1] in ("'", '"'):
        out, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"yaml_lite: text after a quoted string: {text!r}")
        return out
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"yaml_lite: unsupported YAML construct {text!r}")
    return scalar(text)


def _split_key(text: str):
    """(key, rest) if ``text`` is ``key: rest`` or ``key:``, else None."""
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text[:1] in ("[", "{"):
        return None
    m = re.match(r"^([^#'\"\n]*?):(?: +(.*))?$", text, re.DOTALL)
    if m is None:
        return None
    return scalar(m.group(1).strip()), (m.group(2) or "").strip()


class _Block:
    """The document as (indent, text) lines, flow collections joined."""

    def __init__(self, text: str):
        self.lines: list[tuple[int, str]] = []
        pending = None
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("yaml_lite: tabs in indentation")
            line = _strip_comment(raw)
            if pending is not None:
                pending = (pending[0], pending[1] + "\n" + line.strip())
                if _flow_open(pending[1]) <= 0:
                    self.lines.append(pending)
                    pending = None
                continue
            if not line.strip():
                continue
            if line.strip() == "...":  # the end of the document
                break
            if line.strip() == "---":
                if self.lines:
                    raise ValueError("yaml_lite: one document a file")
                continue
            entry = (len(line) - len(line.lstrip()), line.strip())
            if _flow_open(entry[1]) > 0:
                pending = entry
            else:
                self.lines.append(entry)
        if pending is not None:
            raise ValueError("yaml_lite: unterminated flow collection")
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        out = self.node(self.lines[0][0])
        if self.i != len(self.lines):
            raise ValueError(f"yaml_lite: unexpected line {self.lines[self.i][1]!r}")
        return out

    def node(self, indent: int):
        text = self.lines[self.i][1]
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _split_key(text) is not None:
            return self.mapping(indent)
        self.i += 1
        return _value(text)

    def _nested(self, indent: int, allow_sequence_at_indent: bool):
        """The block value that follows a ``key:`` or ``-`` with nothing after it."""
        if self.i < len(self.lines):
            nxt_indent, nxt = self.lines[self.i]
            if nxt_indent > indent:
                return self.node(nxt_indent)
            if (allow_sequence_at_indent and nxt_indent == indent
                    and (nxt == "-" or nxt.startswith("- "))):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            line_indent, text = self.lines[self.i]
            if line_indent < indent:
                break
            if line_indent > indent:
                raise ValueError(f"yaml_lite: bad indentation at {text!r}")
            split = _split_key(text)
            if split is None:
                break
            key, rest = split
            self.i += 1
            out[key] = _value(rest) if rest else self._nested(indent, True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            line_indent, text = self.lines[self.i]
            if line_indent != indent or not (text == "-" or text.startswith("- ")):
                break
            rest = text[1:].strip()
            if not rest:
                self.i += 1
                out.append(self._nested(indent, False))
                continue
            # an item that starts a mapping: its keys sit at the item's text column
            column = indent + len(text) - len(rest)
            self.lines[self.i] = (column, rest)
            out.append(self.node(column))
        return out


def loads(text: str):
    """The value of one YAML document, as ``yaml.safe_load`` gives it."""
    return _Block(text).parse()


def load(path: str):
    with open(path) as f:
        return loads(f.read())
