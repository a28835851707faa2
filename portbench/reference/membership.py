"""The plain reference of a membership test: Python's ``re`` over each whole
document.

A decision is ``re.search(pattern, document) is not None`` on bytes with
``re.DOTALL``: ``.`` takes any byte and ``\\d``, ``\\w``, ``\\s`` are ASCII,
as the program's regex dialect defines them.  The reference sees only the
regex texts of the configuration and the generated bytes.

``split`` (the control) matches each ``split``-byte piece of a document on
its own and ORs the answers: the parallel split without the speculative
merge, which misses every match that spans two pieces.

The work spreads over worker processes: this file run as a script, fed its
share of the documents through a pipe and waited for.
"""

from __future__ import annotations

import functools
import pickle
import re
import subprocess
import sys
from typing import Sequence

import numpy as np


@functools.lru_cache(maxsize=8)
def _compiled(patterns: tuple[str, ...]) -> tuple[re.Pattern, ...]:
    return tuple(re.compile(p.encode(), re.DOTALL) for p in patterns)


def decide_one(patterns: tuple[str, ...], doc: bytes, split: int = 0
               ) -> np.ndarray:
    """[K] decisions of one document."""
    pieces = ([doc] if split <= 0 else
              [doc[o:o + split] for o in range(0, max(len(doc), 1), split)])
    return np.array([any(rx.search(p) is not None for p in pieces)
                     for rx in _compiled(patterns)], bool)


def _rows(patterns: tuple[str, ...], docs, split: int) -> np.ndarray:
    rows = [decide_one(patterns, d, split) for d in docs]
    return np.stack(rows) if rows else np.zeros((0, len(patterns)), bool)


def decide(patterns: Sequence[str], docs: Sequence[bytes], *,
           workers: int = 0, split: int = 0) -> np.ndarray:
    """[len(docs), K] decisions; ``workers`` processes (0: this one)."""
    pats = tuple(patterns)
    if workers <= 1 or len(docs) <= 1:
        return _rows(pats, docs, split)
    # longest first onto the least loaded worker
    shares: list[list[int]] = [[] for _ in range(min(workers, len(docs)))]
    load = [0] * len(shares)
    for i in sorted(range(len(docs)), key=lambda i: -len(docs[i])):
        w = load.index(min(load))
        shares[w].append(i)
        load[w] += len(docs[i])
    procs = [subprocess.Popen([sys.executable, __file__],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in shares]
    try:
        for p, share in zip(procs, shares):
            # each worker reads all of its input before it starts
            p.stdin.write(pickle.dumps((pats, split, [docs[i] for i in share])))
            p.stdin.close()
        out = np.zeros((len(docs), len(pats)), bool)
        for p, share in zip(procs, shares):
            rows = pickle.loads(p.stdout.read())
            if p.wait() != 0:
                raise RuntimeError(f"reference worker exited {p.returncode}")
            out[share] = rows
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _worker() -> None:
    pats, split, docs = pickle.loads(sys.stdin.buffer.read())
    sys.stdout.buffer.write(pickle.dumps(_rows(pats, docs, split)))


if __name__ == "__main__":
    _worker()
