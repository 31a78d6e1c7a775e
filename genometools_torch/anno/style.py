"""AnnotationSketch style files.

The port's copy of ``genometools_tpu/anno/style.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference style system (ref:
src/annotationsketch/style.c — Lua tables evaluated by the embedded
interpreter; gtdata/sketch/default.style): a tolerant parser for the
declarative subset those files actually use — one nested table literal
``style = { section = { key = value, ... }, ... }`` with numbers,
strings, booleans, nil and RGB(A) color tables — no Lua interpreter
required.
"""

from __future__ import annotations

import re


class StyleError(ValueError):
    pass


def _strip_comments(text: str) -> str:
    text = re.sub(r"--\[\[.*?\]\](--)?", "", text, flags=re.S)
    return re.sub(r"--[^\n]*", "", text)


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\r\n,;":
            self.i += 1

    def peek(self):
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, ch):
        self.ws()
        if not self.s.startswith(ch, self.i):
            raise StyleError(
                f"expected {ch!r} at offset {self.i}: "
                f"{self.s[self.i:self.i + 30]!r}")
        self.i += len(ch)

    def ident(self):
        self.ws()
        m = re.match(r"[A-Za-z_][A-Za-z0-9_']*", self.s[self.i:])
        if not m:
            raise StyleError(f"identifier expected at {self.i}")
        self.i += m.end()
        return m.group(0)

    def value(self):
        c = self.peek()
        if c == "{":
            return self.table()
        if c in "\"'":
            q = c
            self.i += 1
            j = self.s.index(q, self.i)
            v = self.s[self.i:j]
            self.i = j + 1
            return v
        m = re.match(r"-?(\d+\.?\d*|\.\d+)([eE]-?\d+)?",
                     self.s[self.i:])
        if m:
            self.i += m.end()
            t = m.group(0)
            return float(t) if ("." in t or "e" in t.lower()) \
                else int(t)
        w = self.ident()
        if w == "true":
            return True
        if w == "false":
            return False
        if w == "nil":
            return None
        # bare function refs / identifiers are kept as strings
        return w

    def table(self):
        self.expect("{")
        out: dict = {}
        n = 0
        while True:
            c = self.peek()
            if c == "}":
                self.i += 1
                return out
            if c == "[":                     # ["key"] = value
                self.expect("[")
                key = self.value()
                self.expect("]")
                self.expect("=")
                out[key] = self.value()
                continue
            save = self.i
            try:
                key = self.ident()
                self.ws()
                if self.s.startswith("=", self.i):
                    self.i += 1
                    out[key] = self.value()
                    continue
            except StyleError:
                pass
            self.i = save
            out[n] = self.value()            # positional entry
            n += 1


def parse_style(text: str) -> dict:
    """The ``style`` table as nested dicts."""
    text = _strip_comments(text)
    m = re.search(r"\bstyle\s*=\s*\{", text)
    if not m:
        raise StyleError('no "style = {" table found')
    p = _P(text)
    p.i = m.end() - 1
    return p.table()


def load_style(path: str) -> dict:
    with open(path) as f:
        return parse_style(f.read())


def color_hex(c, default: str = "#d3d3d3") -> str:
    """RGB(A) table {red=..,green=..,blue=..} (0..1 floats) -> #rrggbb."""
    if not isinstance(c, dict):
        return default
    def b(x):
        return max(0, min(255, int(round(float(x) * 255))))
    try:
        return "#%02x%02x%02x" % (b(c.get("red", 0)), b(c.get("green", 0)),
                                  b(c.get("blue", 0)))
    except (TypeError, ValueError):
        return default


def track_colors(style: dict) -> dict[str, dict[str, str]]:
    """type -> {fill, stroke} hex colors from a parsed style table."""
    out = {}
    for ftype, sec in style.items():
        if not isinstance(sec, dict):
            continue
        entry = {}
        if "fill" in sec:
            entry["fill"] = color_hex(sec["fill"])
        if "stroke" in sec:
            entry["stroke"] = color_hex(sec["stroke"], "#555555")
        if entry:
            out[ftype] = entry
    return out
