"""PROSITE pattern syntax: each element is a residue, ``x`` (any residue),
``[..]`` (one of), ``{..}`` (none of), with an optional ``(n)`` or
``(n,m)`` repeat; elements are joined by ``-``, and a trailing ``>`` anchors
the motif at a sequence's C-terminus.

A database shard holds whole sequences, each ended by a newline, so a motif
never spans two sequences: every element takes upper-case letters only
(``{..}`` is the letters A-Z less the set, never the newline), and the
C-terminal anchor is the newline that ends the sequence.  Both the traffic
(which plants instances) and the plain reference read the texts through this
module; the system under test gets the regex texts it writes.
"""

from __future__ import annotations

import string

LETTERS = string.ascii_uppercase.encode()
END = b"\n"   # ends every sequence of a shard


def parse(text: str) -> tuple[list[tuple[bytes, int, int]], bool]:
    """PROSITE text -> ([(allowed letters, min count, max count)], whether
    the motif is anchored at the C-terminus)."""
    body = text.strip().rstrip(".")
    if body.startswith("<"):
        raise ValueError(f"N-terminal anchors are not supported: {text!r}")
    c_term = body.endswith(">")
    elements = []
    for element in body.rstrip(">").split("-"):
        lo = hi = 1
        if "(" in element:
            element, rep = element.split("(", 1)
            bounds = [int(x) for x in rep.rstrip(")").split(",")]
            lo, hi = bounds[0], bounds[-1]
        if element == "x":
            allowed = LETTERS
        elif element.startswith("[") and element.endswith("]"):
            allowed = element[1:-1].encode()
        elif element.startswith("{") and element.endswith("}"):
            banned = set(element[1:-1].encode())
            allowed = bytes(c for c in LETTERS if c not in banned)
        elif len(element) == 1 and element.isupper():
            allowed = element.encode()
        else:
            raise ValueError(f"bad PROSITE element {element!r} in {text!r}")
        if not allowed or not set(allowed) <= set(LETTERS):
            raise ValueError(f"bad PROSITE element {element!r} in {text!r}")
        elements.append((bytes(sorted(set(allowed))), lo, hi))
    return elements, c_term


def _char_class(allowed: bytes) -> str:
    """A regex class of the letters, runs written as ranges."""
    if len(allowed) == 1:
        return chr(allowed[0])
    runs, start = [], allowed[0]
    for prev, cur in zip(allowed, allowed[1:] + b"\0"):
        if cur != prev + 1:
            runs.append(chr(start) if start == prev
                        else f"{chr(start)}-{chr(prev)}" if prev > start + 1
                        else chr(start) + chr(prev))
            start = cur
    return "[" + "".join(runs) + "]"


def to_regex(text: str) -> str:
    """The regex of a PROSITE text, in the subset that both Python's ``re``
    and the system under test read: classes, ``{n,m}`` repeats, ``\\n``."""
    elements, c_term = parse(text)
    out = []
    for allowed, lo, hi in elements:
        rep = "" if lo == hi == 1 else f"{{{lo}}}" if lo == hi else f"{{{lo},{hi}}}"
        out.append(_char_class(allowed) + rep)
    return "".join(out) + ("\\n" if c_term else "")


def instance(rng, text_or_parsed, alphabet: bytes = LETTERS) -> bytes:
    """One string that the motif matches: a letter of each element's set
    that ``alphabet`` holds, each repeat count drawn from its range, and the
    sequence's end where the motif is anchored there."""
    elements, c_term = (parse(text_or_parsed) if isinstance(text_or_parsed, str)
                        else text_or_parsed)
    keep = set(alphabet)
    out = bytearray()
    for allowed, lo, hi in elements:
        allowed = bytes(c for c in allowed if c in keep)
        for _ in range(int(rng.integers(lo, hi + 1))):
            out.append(allowed[int(rng.integers(len(allowed)))])
    return bytes(out) + (END if c_term else b"")
