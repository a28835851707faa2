"""Regex -> NFA (Thompson construction) over compressed byte classes.

Supported syntax (the subset needed for PCRE-style benchmark patterns and the
PROSITE protein patterns of the paper's evaluation):

  literals, ``\\`` escapes (``\\n \\t \\r \\d \\D \\w \\W \\s \\S`` + punct),
  ``.`` (any byte), character classes ``[a-z0-9]`` / negated ``[^...]``,
  grouping ``( )``, alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}``.

Anchors are intentionally not supported: the engine implements the paper's
membership / search semantics (see ``make_search_dfa``).

The parser first collects every leaf byte-set of the AST, refines a partition
of 0..255 into equivalence classes, and emits NFA transitions over class ids.
This keeps downstream DFA tables at ``[Q, n_classes]`` with n_classes usually
far below 256 — the property that lets the Pallas kernel pin the table in VMEM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .automata import NFA

__all__ = ["parse_regex", "regex_to_nfa", "prosite_to_regex"]


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Node:
    pass


@dataclasses.dataclass
class Lit(Node):
    byteset: frozenset[int]  # set of accepted byte values


@dataclasses.dataclass
class Concat(Node):
    parts: list[Node]


@dataclasses.dataclass
class Alt(Node):
    options: list[Node]


@dataclasses.dataclass
class Repeat(Node):
    child: Node
    lo: int
    hi: Optional[int]  # None = unbounded


_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    set(range(ord("a"), ord("z") + 1))
    | set(range(ord("A"), ord("Z") + 1))
    | set(range(ord("0"), ord("9") + 1))
    | {ord("_")}
)
_SPACE = frozenset({ord(" "), ord("\t"), ord("\n"), ord("\r"), ord("\f"), ord("\v")})
_ALL = frozenset(range(256))

_ESCAPES = {
    "n": frozenset({ord("\n")}),
    "t": frozenset({ord("\t")}),
    "r": frozenset({ord("\r")}),
    "f": frozenset({ord("\f")}),
    "v": frozenset({ord("\v")}),
    "0": frozenset({0}),
    "d": _DIGITS,
    "D": _ALL - _DIGITS,
    "w": _WORD,
    "W": _ALL - _WORD,
    "s": _SPACE,
    "S": _ALL - _SPACE,
}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> Exception:
        return ValueError(f"regex error at {self.i} in {self.p!r}: {msg}")

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def take(self) -> str:
        ch = self.peek()
        self.i += 1
        return ch

    # alternation := concat ('|' concat)*
    def parse_alt(self) -> Node:
        opts = [self.parse_concat()]
        while self.peek() == "|":
            self.take()
            opts.append(self.parse_concat())
        return opts[0] if len(opts) == 1 else Alt(opts)

    def parse_concat(self) -> Node:
        parts: list[Node] = []
        while self.peek() not in ("", "|", ")"):
            parts.append(self.parse_repeat())
        if not parts:
            return Concat([])  # empty string
        return parts[0] if len(parts) == 1 else Concat(parts)

    def parse_repeat(self) -> Node:
        atom = self.parse_atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                atom = Repeat(atom, 0, None)
            elif ch == "+":
                self.take()
                atom = Repeat(atom, 1, None)
            elif ch == "?":
                self.take()
                atom = Repeat(atom, 0, 1)
            elif ch == "{":
                save = self.i
                rep = self._try_counted()
                if rep is None:
                    self.i = save
                    break
                atom = Repeat(atom, rep[0], rep[1])
            else:
                break
        return atom

    def _try_counted(self) -> Optional[tuple[int, Optional[int]]]:
        assert self.take() == "{"
        lo = ""
        while self.peek().isdigit():
            lo += self.take()
        if not lo:
            return None
        if self.peek() == "}":
            self.take()
            return int(lo), int(lo)
        if self.peek() != ",":
            return None
        self.take()
        hi = ""
        while self.peek().isdigit():
            hi += self.take()
        if self.peek() != "}":
            return None
        self.take()
        return int(lo), (int(hi) if hi else None)

    def parse_atom(self) -> Node:
        ch = self.take()
        if ch == "(":
            # non-capturing group marker (?: is accepted and ignored
            if self.peek() == "?" and self.i + 1 < len(self.p) and self.p[self.i + 1] == ":":
                self.take(); self.take()
            node = self.parse_alt()
            if self.take() != ")":
                raise self.error("unbalanced parenthesis")
            return node
        if ch == "[":
            return self.parse_class()
        if ch == ".":
            return Lit(_ALL)
        if ch == "\\":
            return Lit(self.parse_escape())
        if ch in ("*", "+", "?", "{", ")", "|", ""):
            raise self.error(f"unexpected {ch!r}")
        return Lit(frozenset({ord(ch)}))

    def parse_escape(self) -> frozenset[int]:
        ch = self.take()
        if not ch:
            raise self.error("dangling escape")
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        if ch == "x":
            hx = self.take() + self.take()
            return frozenset({int(hx, 16)})
        return frozenset({ord(ch)})

    def parse_class(self) -> Node:
        negate = False
        if self.peek() == "^":
            self.take()
            negate = True
        members: set[int] = set()
        first = True
        while True:
            ch = self.peek()
            if ch == "":
                raise self.error("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                members |= self.parse_escape()
                continue
            self.take()
            lo = ord(ch)
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.take()
                hi_ch = self.take()
                if hi_ch == "\\":
                    hi_set = self.parse_escape()
                    if len(hi_set) != 1:
                        raise self.error("bad range bound")
                    hi = next(iter(hi_set))
                else:
                    hi = ord(hi_ch)
                if hi < lo:
                    raise self.error("reversed range")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        byteset = frozenset(members)
        return Lit(_ALL - byteset if negate else byteset)


def parse_regex(pattern: str) -> Node:
    p = _Parser(pattern)
    node = p.parse_alt()
    if p.i != len(pattern):
        raise p.error("trailing input")
    return node


# --------------------------------------------------------------------------
# Byte-class compression
# --------------------------------------------------------------------------

def _collect_leaf_sets(node: Node, out: list[frozenset[int]]) -> None:
    if isinstance(node, Lit):
        out.append(node.byteset)
    elif isinstance(node, Concat):
        for n in node.parts:
            _collect_leaf_sets(n, out)
    elif isinstance(node, Alt):
        for n in node.options:
            _collect_leaf_sets(n, out)
    elif isinstance(node, Repeat):
        _collect_leaf_sets(node.child, out)


def _byte_classes(leaf_sets: list[frozenset[int]]) -> np.ndarray:
    """Partition 0..255 by the signature of leaf-set membership."""
    sig = np.zeros(256, dtype=np.int64)
    for k, s in enumerate(set(leaf_sets)):
        mask = np.zeros(256, dtype=bool)
        mask[list(s)] = True
        sig = sig * 2 + mask  # may overflow for >62 distinct sets -> use tuple below
    if len(set(leaf_sets)) > 60:
        sigs = [tuple(b in s for s in set(leaf_sets)) for b in range(256)]
        uniq = {t: i for i, t in enumerate(dict.fromkeys(sigs))}
        return np.array([uniq[t] for t in sigs], dtype=np.int32)
    _, inv = np.unique(sig, return_inverse=True)
    return inv.astype(np.int32)


# --------------------------------------------------------------------------
# Thompson construction
# --------------------------------------------------------------------------

class _Builder:
    def __init__(self, byte_to_class: np.ndarray, n_classes: int):
        self.b2c = byte_to_class
        self.n_classes = n_classes
        self.transitions: list[list[tuple[int, int]]] = []

    def new_state(self) -> int:
        self.transitions.append([])
        return len(self.transitions) - 1

    def add(self, s: int, cls: int, t: int) -> None:
        self.transitions[s].append((cls, t))

    def classes_for(self, byteset: frozenset[int]) -> set[int]:
        return {int(self.b2c[b]) for b in byteset}

    def build(self, node: Node) -> tuple[int, int]:
        """Return (entry, exit) fragment states."""
        if isinstance(node, Lit):
            a, b = self.new_state(), self.new_state()
            for cls in self.classes_for(node.byteset):
                self.add(a, cls, b)
            return a, b
        if isinstance(node, Concat):
            if not node.parts:
                a = self.new_state()
                return a, a
            entry, cur = self.build(node.parts[0])
            for part in node.parts[1:]:
                nxt_in, nxt_out = self.build(part)
                self.add(cur, -1, nxt_in)
                cur = nxt_out
            return entry, cur
        if isinstance(node, Alt):
            a, b = self.new_state(), self.new_state()
            for opt in node.options:
                i, o = self.build(opt)
                self.add(a, -1, i)
                self.add(o, -1, b)
            return a, b
        if isinstance(node, Repeat):
            lo, hi = node.lo, node.hi
            a = self.new_state()
            cur = a
            for _ in range(lo):
                i, o = self.build(node.child)
                self.add(cur, -1, i)
                cur = o
            if hi is None:  # unbounded tail: child*
                i, o = self.build(node.child)
                self.add(cur, -1, i)
                self.add(o, -1, cur)
                return a, cur
            end = self.new_state()
            self.add(cur, -1, end)
            for _ in range(hi - lo):
                i, o = self.build(node.child)
                self.add(cur, -1, i)
                cur = o
                self.add(cur, -1, end)
            return a, end
        raise TypeError(f"unknown node {node!r}")


def regex_to_nfa(pattern: str) -> NFA:
    ast = parse_regex(pattern)
    leaves: list[frozenset[int]] = []
    _collect_leaf_sets(ast, leaves)
    if not leaves:
        leaves = [_ALL]
    b2c = _byte_classes(leaves)
    n_classes = int(b2c.max()) + 1
    builder = _Builder(b2c, n_classes)
    entry, exit_ = builder.build(ast)
    return NFA(
        n_states=len(builder.transitions),
        start=entry,
        accepts=frozenset({exit_}),
        transitions=builder.transitions,
        n_classes=n_classes,
        byte_to_class=b2c,
    )


# --------------------------------------------------------------------------
# PROSITE pattern syntax (paper Sec. 6 benchmark suite)
# --------------------------------------------------------------------------

def prosite_to_regex(pattern: str) -> str:
    """Convert PROSITE notation to the regex subset above.

    Example: ``C-x(2,4)-C-x(3)-[LIVMFYWC]-x(8)-H-x(3,5)-H``.
    ``x`` = any amino acid, ``[..]`` class, ``{..}`` negated class, ``(n[,m])``
    repetition, ``<``/``>`` anchors (stripped: engine uses search semantics),
    trailing ``.`` terminator stripped.
    """
    pat = pattern.strip().rstrip(".")
    pat = pat.lstrip("<").rstrip(">")
    out: list[str] = []
    for element in pat.split("-"):
        element = element.strip()
        if not element:
            continue
        rep = ""
        if "(" in element:
            element, rep_body = element.split("(", 1)
            rep_body = rep_body.rstrip(")")
            rep = "{" + rep_body + "}"
        if element == "x":
            core = "[A-Z]"
        elif element.startswith("[") and element.endswith("]"):
            core = element
        elif element.startswith("{") and element.endswith("}"):
            core = "[^" + element[1:-1] + "]"
        elif len(element) == 1 and element.isalpha():
            core = element
        else:
            raise ValueError(f"bad PROSITE element {element!r} in {pattern!r}")
        out.append(core + rep)
    return "".join(out)
