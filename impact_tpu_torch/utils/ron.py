"""A small RON (Rusty Object Notation) parser: the port's copy of
``impact_tpu/utils/ron.py``.

The reference configures everything through serde-default RON files
(ref: engine/src/engine.rs:573-592 ``EngineConfig::from_ron_file``;
apps/basic_app/config/engine_config_no_assets.ron). This host-side parser lets
those config trees load unchanged.

Mapping to Python:
  structs       ``Name(a: 1)`` / ``(a: 1)``  → dict (struct name recorded under
                                               the ``"__name__"`` key when present)
  enum variants ``Variant`` / ``Variant(x)``  → :class:`Variant`
  Option        ``Some(x)`` / ``None``        → value / ``None``
  lists / maps / tuples / numbers / strings / bools → the obvious Python types
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Variant:
    """An enum variant: ``name`` plus positional and/or named payload."""

    name: str
    args: tuple = ()
    fields: dict | None = None

    def __str__(self):
        return self.name


class RonError(ValueError):
    pass


_PUNCT = set("()[]{},:")


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    # --- lexing helpers -------------------------------------------------
    def _skip_ws(self):
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "/" and self.pos + 1 < self.n:
                nxt = self.text[self.pos + 1]
                if nxt == "/":
                    while self.pos < self.n and self.text[self.pos] != "\n":
                        self.pos += 1
                elif nxt == "*":
                    depth, self.pos = 1, self.pos + 2
                    while self.pos < self.n and depth:
                        if self.text.startswith("/*", self.pos):
                            depth += 1
                            self.pos += 2
                        elif self.text.startswith("*/", self.pos):
                            depth -= 1
                            self.pos += 2
                        else:
                            self.pos += 1
                else:
                    break
            else:
                break

    def _peek(self) -> str:
        self._skip_ws()
        return self.text[self.pos] if self.pos < self.n else ""

    def _expect(self, c: str):
        if self._peek() != c:
            raise RonError(
                f"expected {c!r} at offset {self.pos}: "
                f"...{self.text[max(0, self.pos - 20):self.pos + 20]!r}"
            )
        self.pos += 1

    def _ident(self) -> str:
        self._skip_ws()
        start = self.pos
        while self.pos < self.n and (
            self.text[self.pos].isalnum() or self.text[self.pos] == "_"
        ):
            self.pos += 1
        if self.pos == start:
            raise RonError(f"expected identifier at offset {self.pos}")
        return self.text[start:self.pos]

    # --- values ----------------------------------------------------------
    def parse_value(self) -> Any:
        c = self._peek()
        if c == "(":
            return self._struct_or_tuple(name=None)
        if c == "[":
            return self._list()
        if c == "{":
            return self._map()
        if c == '"':
            return self._string()
        if c == "'":
            return self._char()
        if c.isdigit() or c in "+-.":
            return self._number()
        ident = self._ident()
        if ident == "true":
            return True
        if ident == "false":
            return False
        if ident == "None":
            return None
        if ident == "Some":
            self._expect("(")
            v = self.parse_value()
            self._expect(")")
            return v
        if ident in ("inf", "NaN"):
            return float(ident.lower().replace("nan", "nan"))
        if self._peek() == "(":
            return self._struct_or_tuple(name=ident)
        return Variant(ident)

    def _struct_or_tuple(self, name: str | None) -> Any:
        self._expect("(")
        if self._peek() == ")":
            self.pos += 1
            return Variant(name) if name else ()
        # Decide struct vs tuple: struct iff 'ident:' follows.
        save = self.pos
        is_struct = False
        try:
            self._ident()
            is_struct = self._peek() == ":"
        except RonError:
            pass
        self.pos = save
        if is_struct:
            fields: dict[str, Any] = {}
            while True:
                key = self._ident()
                self._expect(":")
                fields[key] = self.parse_value()
                if self._peek() == ",":
                    self.pos += 1
                    if self._peek() == ")":
                        break
                else:
                    break
            self._expect(")")
            if name:
                return Variant(name, fields=fields)
            return fields
        items = []
        while True:
            items.append(self.parse_value())
            if self._peek() == ",":
                self.pos += 1
                if self._peek() == ")":
                    break
            else:
                break
        self._expect(")")
        if name:
            return Variant(name, args=tuple(items))
        return tuple(items)

    def _list(self) -> list:
        self._expect("[")
        items = []
        while self._peek() != "]":
            items.append(self.parse_value())
            if self._peek() == ",":
                self.pos += 1
        self._expect("]")
        return items

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        while self._peek() != "}":
            k = self.parse_value()
            self._expect(":")
            out[k] = self.parse_value()
            if self._peek() == ",":
                self.pos += 1
        self._expect("}")
        return out

    def _string(self) -> str:
        self._expect('"')
        out = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "\\":
                nxt = self.text[self.pos + 1]
                out.append({"n": "\n", "t": "\t", "r": "\r"}.get(nxt, nxt))
                self.pos += 2
            elif c == '"':
                self.pos += 1
                return "".join(out)
            else:
                out.append(c)
                self.pos += 1
        raise RonError("unterminated string")

    def _char(self) -> str:
        self._expect("'")
        c = self.text[self.pos]
        self.pos += 1
        if c == "\\":
            c = {"n": "\n", "t": "\t"}.get(self.text[self.pos], self.text[self.pos])
            self.pos += 1
        self._expect("'")
        return c

    def _number(self):
        self._skip_ws()
        start = self.pos
        while self.pos < self.n and (
            self.text[self.pos].isalnum() or self.text[self.pos] in "+-._"
        ):
            self.pos += 1
        tok = self.text[start:self.pos].replace("_", "")
        try:
            if any(ch in tok for ch in ".eE") and not tok.startswith("0x"):
                return float(tok)
            return int(tok, 0)
        except ValueError as e:
            raise RonError(f"bad number {tok!r} at offset {start}") from e


def loads(text: str) -> Any:
    p = _Parser(text)
    v = p.parse_value()
    p._skip_ws()
    if p.pos != p.n:
        raise RonError(f"trailing content at offset {p.pos}")
    return v


def load(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())
