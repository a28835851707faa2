"""NFA -> DFA (subset construction) and Hopcroft minimization.

The paper builds its benchmark DFAs with Grail+ (regex -> NFA -> DFA -> minimal
DFA); this module is our Grail+ replacement, built in-repo per the "implement
every substrate" rule.  Output DFAs are *complete* (explicit sink q_e) to match
the paper's assumption of a unique error state.
"""

from __future__ import annotations

import numpy as np

from .automata import DFA, NFA
from .regex import prosite_to_regex, regex_to_nfa

__all__ = ["nfa_to_dfa", "minimize", "compile_regex", "compile_prosite"]


def nfa_to_dfa(nfa: NFA, *, max_states: int = 100_000) -> DFA:
    """Subset construction; always emits a complete DFA with an explicit sink."""
    start_set = nfa.eps_closure([nfa.start])
    index: dict[frozenset[int], int] = {start_set: 0}
    worklist = [start_set]
    rows: list[list[int]] = []
    accepting: list[bool] = []
    empty = frozenset()

    while worklist:
        cur = worklist.pop()
        # deterministic exploration order keeps state numbering stable
        i = index[cur]
        while len(rows) <= i:
            rows.append([0] * nfa.n_classes)
            accepting.append(False)
        accepting[i] = bool(cur & nfa.accepts)
        for cls in range(nfa.n_classes):
            nxt = nfa.step(cur, cls)
            key = frozenset(nxt) if nxt else empty
            if key not in index:
                if len(index) >= max_states:
                    raise RuntimeError(
                        f"subset construction exceeded {max_states} states — "
                        "bounded-repeat pattern under search prefix explodes; "
                        "rewrite the pattern or raise max_states")
                index[key] = len(index)
                worklist.append(key)
            rows[i][cls] = index[key]

    n = len(index)
    table = np.zeros((n, nfa.n_classes), dtype=np.int32)
    acc = np.zeros(n, dtype=bool)
    for i, row in enumerate(rows):
        table[i] = row
        acc[i] = accepting[i]
    # rows for states discovered but never popped before loop end are filled:
    # (worklist pops everything, so all rows are filled; assert for safety)
    assert all(len(r) == nfa.n_classes for r in rows) and len(rows) == n

    sink = index.get(frozenset(), -1)
    dfa = DFA(table=table, accepting=acc, start=0, sink=sink,
              byte_to_class=nfa.byte_to_class.copy())
    return dfa


def minimize(dfa: DFA) -> DFA:
    """Hopcroft's algorithm on the complete DFA; preserves the sink state."""
    q, n_cls = dfa.n_states, dfa.n_classes
    # build reverse transitions: rev[cls][target] -> list of sources
    rev: list[list[list[int]]] = [[[] for _ in range(q)] for _ in range(n_cls)]
    for s in range(q):
        for c in range(n_cls):
            rev[c][int(dfa.table[s, c])].append(s)

    accepting = set(np.flatnonzero(dfa.accepting).tolist())
    non_accepting = set(range(q)) - accepting
    partition: list[set[int]] = [p for p in (accepting, non_accepting) if p]
    # block id per state
    block_of = np.zeros(q, dtype=np.int64)
    for b, blk in enumerate(partition):
        for s in blk:
            block_of[s] = b
    work = {(b, c) for b in range(len(partition)) for c in range(n_cls)}

    while work:
        b, c = work.pop()
        splitter = partition[b]
        # states with a c-transition into the splitter
        x: set[int] = set()
        for t in splitter:
            x.update(rev[c][t])
        if not x:
            continue
        touched: dict[int, set[int]] = {}
        for s in x:
            touched.setdefault(int(block_of[s]), set()).add(s)
        for bid, inter in touched.items():
            blk = partition[bid]
            if len(inter) == len(blk):
                continue
            rest = blk - inter
            partition[bid] = inter
            new_id = len(partition)
            partition.append(rest)
            for s in rest:
                block_of[s] = new_id
            for cc in range(n_cls):
                if (bid, cc) in work:
                    work.add((new_id, cc))
                else:
                    smaller = bid if len(inter) <= len(rest) else new_id
                    work.add((smaller, cc))

    # rebuild with start-state-first numbering for stable tests
    order = sorted(range(len(partition)), key=lambda b: (b != block_of[dfa.start], b))
    remap = {old: new for new, old in enumerate(order)}
    m = len(partition)
    table = np.zeros((m, n_cls), dtype=np.int32)
    acc = np.zeros(m, dtype=bool)
    for old_bid, blk in enumerate(partition):
        rep = next(iter(blk))
        new_bid = remap[old_bid]
        acc[new_bid] = bool(dfa.accepting[rep])
        for c in range(n_cls):
            table[new_bid, c] = remap[int(block_of[int(dfa.table[rep, c])])]
    new = DFA(table=table, accepting=acc, start=remap[int(block_of[dfa.start])],
              sink=-1, byte_to_class=dfa.byte_to_class.copy())
    new.sink = new.find_sink()
    return new


def compile_regex(pattern: str, *, minimize_dfa: bool = True) -> DFA:
    """regex string -> minimal complete DFA (the Grail+ pipeline of Sec. 5)."""
    dfa = nfa_to_dfa(regex_to_nfa(pattern))
    return minimize(dfa) if minimize_dfa else dfa


def compile_prosite(pattern: str, *, minimize_dfa: bool = True) -> DFA:
    return compile_regex(prosite_to_regex(pattern), minimize_dfa=minimize_dfa)
