"""Finite-automata data structures.

The DFA representation mirrors the paper's flattened ``SBase`` layout (Fig. 8c):
a dense row-major transition table ``table[Q, n_classes]`` of ``int32`` state ids,
plus a byte->class map (``byte_to_class``, the paper's ``IBase`` symbol mapping,
Fig. 8d) so that arbitrary byte inputs index a compressed alphabet.  Alphabet
compression (merging byte columns with identical behaviour) is standard lexer
practice (RE2/flex) and is what makes the transition table small enough to pin
in TPU VMEM; the paper uses the same idea when it maps characters to integers.

States are integers ``0..Q-1``.  ``sink`` is the unique error state q_e: a
non-accepting state whose every outgoing transition is a self-loop.  Every DFA
built by this package is *complete* (total transition function) so the matching
loop is branch-free, exactly as in the paper's Listing 1.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import numpy as np

__all__ = ["NFA", "DFA", "PackedDFA", "make_search_dfa", "pack_dfas",
           "packed_from_arrays", "packed_signature", "random_dfa"]


@dataclasses.dataclass
class NFA:
    """Thompson-construction NFA over compressed byte classes.

    ``transitions[s]`` is a list of ``(cls, target)`` with ``cls == -1`` for
    epsilon moves.  ``n_classes`` byte classes; ``byte_to_class`` maps raw bytes
    to class ids.
    """

    n_states: int
    start: int
    accepts: frozenset[int]
    transitions: list[list[tuple[int, int]]]
    n_classes: int
    byte_to_class: np.ndarray  # [256] int32

    def eps_closure(self, states: Iterable[int]) -> frozenset[int]:
        stack = list(states)
        seen = set(stack)
        while stack:
            s = stack.pop()
            for cls, t in self.transitions[s]:
                if cls == -1 and t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def step(self, states: Iterable[int], cls: int) -> frozenset[int]:
        out: set[int] = set()
        for s in states:
            for c, t in self.transitions[s]:
                if c == cls:
                    out.add(t)
        return self.eps_closure(out)


@dataclasses.dataclass
class DFA:
    """Complete DFA with a dense transition table (paper Fig. 8c layout)."""

    table: np.ndarray  # [Q, n_classes] int32, complete
    accepting: np.ndarray  # [Q] bool
    start: int
    sink: int  # error state q_e; -1 if the DFA has no dead state
    byte_to_class: np.ndarray  # [256] int32

    @property
    def n_states(self) -> int:
        return int(self.table.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.table.shape[1])

    def __post_init__(self) -> None:
        self.table = np.asarray(self.table, dtype=np.int32)
        self.accepting = np.asarray(self.accepting, dtype=bool)
        self.byte_to_class = np.asarray(self.byte_to_class, dtype=np.int32)
        q, c = self.table.shape
        if not ((0 <= self.table).all() and (self.table < q).all()):
            raise ValueError("transition table references out-of-range states")
        if self.byte_to_class.shape != (256,):
            raise ValueError("byte_to_class must have shape [256]")
        if not ((0 <= self.byte_to_class).all() and (self.byte_to_class < c).all()):
            raise ValueError("byte_to_class references out-of-range classes")

    # -- host-side reference semantics (the paper's Algorithm 1) ------------

    def classes_of(self, data: bytes | np.ndarray) -> np.ndarray:
        arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data)
        return self.byte_to_class[arr.astype(np.int64)]

    def run(self, data: bytes | np.ndarray, state: int | None = None) -> int:
        """delta*(state, data) computed sequentially on host (oracle)."""
        s = self.start if state is None else state
        for cls in self.classes_of(data):
            s = int(self.table[s, cls])
        return s

    def accepts(self, data: bytes | np.ndarray) -> bool:
        return bool(self.accepting[self.run(data)])

    def flat_table(self) -> np.ndarray:
        """Paper's SBase: 1-D flattened table; state ids pre-scaled by n_classes.

        ``flat[s * n_classes + cls]`` already contains ``next_state * n_classes``
        so the matching loop is a single add + gather per symbol (Listing 1).
        """
        return (self.table.astype(np.int64) * self.n_classes).astype(np.int32).reshape(-1)

    def find_sink(self) -> int:
        """Locate the error state if present (non-accepting, all self-loops)."""
        for s in range(self.n_states):
            if not self.accepting[s] and (self.table[s] == s).all():
                return s
        return -1


@dataclasses.dataclass
class PackedDFA:
    """K DFAs stacked into one transition table over a joint class alphabet.

    The packed table is the multi-pattern analogue of the paper's flattened
    ``SBase`` (Fig. 8c): pattern k's states live at ids
    ``offsets[k] .. offsets[k+1]-1`` and every table entry is already a packed
    id, so K patterns advance through one shared gather — lanes become
    chunks x candidates x patterns (cf. simultaneous-FA matching,
    arXiv:1405.0562).

    The joint alphabet is the product refinement of the per-pattern byte
    classifications (``IBase``): two bytes share a joint class iff they share
    a class under *every* pattern, so one class stream per document drives all
    K patterns.  ``n_classes`` is the refined count (<= 256).
    """

    table: np.ndarray          # [Q_total, n_classes] int32, packed state ids
    accepting: np.ndarray      # [Q_total] bool
    starts: np.ndarray         # [K] int32 packed start states
    sinks: np.ndarray          # [K] int32 packed sink ids; -1 = no dead state
    offsets: np.ndarray        # [K+1] int32 state-id offset per pattern
    byte_to_class: np.ndarray  # [256] int32 joint classes

    @property
    def n_states(self) -> int:
        return int(self.table.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.table.shape[1])

    @property
    def n_patterns(self) -> int:
        return int(self.starts.shape[0])

    def __post_init__(self) -> None:
        self.table = np.asarray(self.table, dtype=np.int32)
        self.accepting = np.asarray(self.accepting, dtype=bool)
        self.starts = np.asarray(self.starts, dtype=np.int32)
        self.sinks = np.asarray(self.sinks, dtype=np.int32)
        self.offsets = np.asarray(self.offsets, dtype=np.int32)
        self.byte_to_class = np.asarray(self.byte_to_class, dtype=np.int32)

    def pattern_slice(self, k: int) -> slice:
        return slice(int(self.offsets[k]), int(self.offsets[k + 1]))

    def classes_of(self, data: bytes | np.ndarray) -> np.ndarray:
        arr = (np.frombuffer(data, dtype=np.uint8)
               if isinstance(data, (bytes, bytearray)) else np.asarray(data))
        return self.byte_to_class[arr.astype(np.int64)]

    def run_all(self, data: bytes | np.ndarray) -> np.ndarray:
        """Host oracle: final packed state of every pattern, sequentially."""
        states = self.starts.copy()
        for cls in self.classes_of(data):
            states = self.table[states, cls]
        return states

    def accepts_all(self, data: bytes | np.ndarray) -> np.ndarray:
        return self.accepting[self.run_all(data)]


def pack_dfas(dfas: Sequence[DFA]) -> PackedDFA:
    """Stack K DFAs into one ``PackedDFA`` (joint classes + offset state ids)."""
    if not dfas:
        raise ValueError("pack_dfas needs at least one DFA")
    keys = np.stack([d.byte_to_class for d in dfas], axis=1)       # [256, K]
    uniq, joint = np.unique(keys, axis=0, return_inverse=True)     # joint ids
    byte_to_class = joint.astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum([d.n_states for d in dfas])]).astype(np.int32)
    tables = []
    for k, d in enumerate(dfas):
        col_map = uniq[:, k]                   # joint class -> pattern-k class
        tables.append(d.table[:, col_map].astype(np.int64) + int(offsets[k]))
    starts = np.array([int(offsets[k]) + d.start
                       for k, d in enumerate(dfas)], np.int32)
    sinks = np.array([int(offsets[k]) + d.sink if d.sink >= 0 else -1
                      for k, d in enumerate(dfas)], np.int32)
    return PackedDFA(table=np.concatenate(tables).astype(np.int32),
                     accepting=np.concatenate([d.accepting for d in dfas]),
                     starts=starts, sinks=sinks, offsets=offsets,
                     byte_to_class=byte_to_class)


PACKED_FIELDS = ("table", "accepting", "starts", "sinks", "offsets",
                 "byte_to_class")


def packed_from_arrays(arrays: dict[str, np.ndarray]) -> PackedDFA:
    """Rebuild a ``PackedDFA`` from its six field arrays.

    ``arrays`` maps each name of ``PACKED_FIELDS`` to a numpy array, e.g. the
    fields of a pattern table packed by another process or by the JAX
    package; the packed table is this system's counterpart of a model's
    weights, so this is how a table crosses from one runtime to the other.
    Missing fields raise ``KeyError``; dtypes are normalized as on every
    ``PackedDFA``.
    """
    return PackedDFA(**{name: np.array(arrays[name], copy=True)
                        for name in PACKED_FIELDS})


def packed_signature(packed: PackedDFA) -> str:
    """Content hash of a packed pattern block.

    Two ``PackedDFA``s with equal signatures are byte-for-byte the same
    automaton: every array that determines matching behaviour (and state-id
    layout, which streaming cursors depend on) is folded in, shapes included.
    Used as the identity for block-level lowering reuse across
    ``swap_patterns`` and for checkpoint compatibility checks.
    """
    h = hashlib.sha1()
    for arr in (packed.table, packed.accepting, packed.starts, packed.sinks,
                packed.offsets, packed.byte_to_class):
        a = np.ascontiguousarray(arr)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def make_search_dfa(dfa: DFA) -> DFA:
    """Convert membership semantics to search semantics (paper Sec. 6 usage).

    Algorithm 1 returns *true* as soon as a final state is entered — i.e. it
    tests whether any prefix matches.  Making accepting states absorbing gives
    the identical result while preserving the clean L-vector algebra (a sticky
    accept is just an absorbing accept state).
    """
    table = dfa.table.copy()
    for s in np.flatnonzero(dfa.accepting):
        table[s, :] = s
    return DFA(table=table, accepting=dfa.accepting.copy(), start=dfa.start,
               sink=dfa.sink, byte_to_class=dfa.byte_to_class.copy())


def random_dfa(n_states: int, n_classes: int, *, rng: np.random.Generator,
               accept_frac: float = 0.2, with_sink: bool = True) -> DFA:
    """Random complete DFA for property tests and capacity profiling."""
    if n_states < 2:
        raise ValueError("need at least 2 states")
    table = rng.integers(0, n_states, size=(n_states, n_classes), dtype=np.int32)
    accepting = rng.random(n_states) < accept_frac
    sink = -1
    if with_sink:
        sink = n_states - 1
        table[sink, :] = sink
        accepting[sink] = False
    accepting[0] = False  # start state non-accepting keeps tests interesting
    byte_to_class = rng.integers(0, n_classes, size=256, dtype=np.int32)
    # Guarantee every class is reachable from some byte so inputs exercise all.
    byte_to_class[:n_classes] = np.arange(n_classes, dtype=np.int32)
    return DFA(table=table, accepting=accepting, start=0, sink=sink,
               byte_to_class=byte_to_class)
