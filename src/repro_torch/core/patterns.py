"""Benchmark pattern libraries standing in for the paper's suites.

The paper evaluates 299 PCRE-library regexes and 110 PROSITE protein patterns.
Those exact corpora are not redistributable here, so we ship representative
public patterns of both families: the PROSITE entries below are real database
patterns (prosite.expasy.org accession ids noted), and the PCRE-style set
covers the usual syntactic range (classes, alternation, bounded repeats).
Benchmarks sweep these libraries plus random DFAs to reach the paper's |Q|
ranges (up to ~1288 states).
"""

from __future__ import annotations

import hashlib
from typing import Mapping, Optional, Sequence, Union

import numpy as np

from .automata import (DFA, PackedDFA, make_search_dfa, pack_dfas,
                       packed_signature)
from .determinize import compile_prosite, compile_regex

__all__ = ["PROSITE_PATTERNS", "PCRE_PATTERNS", "PatternSet",
           "compile_pattern_suite"]

# Real PROSITE patterns (public database, accession in comment).
PROSITE_PATTERNS: dict[str, str] = {
    "PS00001_ASN_GLYCOSYLATION": "N-{P}-[ST]-{P}",
    "PS00004_CAMP_PHOSPHO_SITE": "[RK](2)-x-[ST]",
    "PS00005_PKC_PHOSPHO_SITE": "[ST]-x-[RK]",
    "PS00006_CK2_PHOSPHO_SITE": "[ST]-x(2)-[DE]",
    "PS00007_TYR_PHOSPHO_SITE": "[RK]-x(2,3)-[DE]-x(2,3)-Y",
    "PS00008_MYRISTYL": "G-{EDRKHPFYW}-x(2)-[STAGCN]-{P}",
    "PS00009_AMIDATION": "x-G-[RK]-[RK]",
    "PS00016_RGD": "R-G-D",
    "PS00017_ATP_GTP_A": "[AG]-x(4)-G-K-[ST]",
    "PS00018_EF_HAND_1": "D-x-[DNS]-{ILVFYW}-[DENSTG]-[DNQGHRK]-{GP}-[LIVMC]-[DENQSTAGC]-x(2)-[DE]-[LIVMFYW]",
    "PS00028_ZINC_FINGER_C2H2": "C-x(2,4)-C-x(3)-[LIVMFYWC]-x(8)-H-x(3,5)-H",
    "PS00029_LEUCINE_ZIPPER": "L-x(6)-L-x(6)-L-x(6)-L",
    "PS00134_TRYPSIN_HIS": "[LIVM]-[ST]-A-[STAG]-H-C",
    "PS00135_TRYPSIN_SER": "[DNSTAGC]-[GSTAPIMVQH]-x(2)-G-[DE]-S-G-[GS]-[SAPHV]-[LIVMFYWH]-[LIVMFYSTANQH]",
    "PS00010_ASX_HYDROXYL": "C-x-[DN]-x(4)-[FY]-x-C-x-C",
    "PS00013_PROKAR_LIPOPROTEIN": "{DERK}(6)-[LIVMFWSTAG](2)-[LIVMFYSTAGCQ]-[AGS]-C",
    "PS00027_HOMEOBOX_1": "[LIVMFYG]-[ASLVR]-x(2)-[LIVMSTACN]-x-[LIVM]-{Y}-x(2)-{L}-[LIV]-[RKNQESTAIY]-[LIVFSTNKH]-W-[FYVC]-x-[NDQTAH]-x(5)-[RKNAIMW]",
    "PS00190_CYTOCHROME_P450": "[FW]-[SGNH]-x-[GD]-{F}-[RKHPT]-{P}-C-[LIVMFAP]-[GAD]",
    "PS00342_MICROBODIES_CTER": "[STAGCN]-[RKH]-[LIVMAFY]",
    "PS00383_TYR_PHOSPHATASE": "[LIVMF]-H-C-x(2)-G-x(3)-[STC]-[STAGP]-x-[LIVMFY]",
}

# PCRE-style regex suite (classes, alternation, bounded repeats, escapes).
PCRE_PATTERNS: dict[str, str] = {
    "ipv4": r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}",
    "email": r"[a-zA-Z0-9_.]+@[a-zA-Z0-9]+\.[a-z]{2,4}",
    "iso_date": r"\d{4}-\d{2}-\d{2}",
    "hex_color": r"#[0-9a-fA-F]{6}",
    "float": r"[0-9]+\.[0-9]+([eE][+\-]?[0-9]+)?",
    "uri_scheme": r"(http|https|ftp)://[a-zA-Z0-9./_\-]+",
    "c_ident": r"[a-zA-Z_][a-zA-Z0-9_]{3,8}",
    "quoted": r'"[^"]*"',
    "html_tag": r"<[a-z]{1,6}( [a-z]+=[a-z0-9]+)*>",
    "uuid_like": r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}",
    "phone": r"\+?[0-9]{1,3}[ \-][0-9]{2,4}[ \-][0-9]{4,6}",
    "keyword_alt": r"(for|while|if|else|return|break|continue)",
    "base64ish": r"[A-Za-z0-9+/]{12,16}=?=?",
    "repeat_ab": r"(ab|ba){2,6}",
}


PatternSource = Union[Mapping[str, str], Sequence[str], Sequence[DFA]]


class PatternSet:
    """K patterns split into independently-determinized blocks of ``k_blk``.

    Each block is its own ``PackedDFA`` (and, downstream, its own
    ``DeviceTables``), so table memory and rebuild cost scale linearly in
    blocks instead of super-linearly in K — the pattern-axis analogue of the
    paper's input chunking.  Packed state ids are local per block;
    ``state_bases[b]`` re-offsets them to the global id space, and because
    ``pack_dfas`` offsets are a plain cumsum of per-pattern state counts, the
    re-offset block ids are *bit-identical* to what one unblocked
    ``pack_dfas`` over all K patterns would assign.

    ``patterns`` is a name->regex mapping, a sequence of regex strings, or a
    sequence of prebuilt ``DFA``s (no regexes retained — such blocks are
    never prefilter-gated).  ``search=True`` compiles ``.*(pat)`` with
    absorbing accepts (``re.search`` semantics); ``search=False`` compiles
    the bare pattern (``re.fullmatch`` semantics).
    """

    def __init__(self, patterns: PatternSource, *, k_blk: int = 32,
                 search: bool = True,
                 names: Optional[Sequence[str]] = None):
        if k_blk < 1:
            raise ValueError("k_blk must be >= 1")
        self.k_blk = int(k_blk)
        self.search = bool(search)
        if isinstance(patterns, Mapping):
            if names is not None:
                raise ValueError("names= conflicts with a mapping source")
            names = list(patterns.keys())
            patterns = list(patterns.values())
        else:
            patterns = list(patterns)
        if not patterns:
            raise ValueError("PatternSet needs at least one pattern")
        self.regexes: tuple[Optional[str], ...]
        self.dfas: tuple[DFA, ...]
        if isinstance(patterns[0], DFA):
            if not all(isinstance(p, DFA) for p in patterns):
                raise TypeError("mixed DFA / regex sources are not supported")
            self.regexes = (None,) * len(patterns)
            self.dfas = tuple(patterns)
        else:
            self.regexes = tuple(str(p) for p in patterns)
            self.dfas = tuple(self._compile(r) for r in self.regexes)
        self.names = tuple(names) if names is not None else tuple(
            f"p{i:04d}" for i in range(len(self.dfas)))
        if len(self.names) != len(self.dfas):
            raise ValueError("names length does not match pattern count")
        self.blocks: tuple[PackedDFA, ...] = tuple(
            pack_dfas(self.dfas[i:i + self.k_blk])
            for i in range(0, len(self.dfas), self.k_blk))
        self.block_signatures: tuple[str, ...] = tuple(
            packed_signature(b) for b in self.blocks)
        # global state-id base per block: cumsum of block sizes == the
        # unblocked pack's offsets at each block boundary (fan-in identity)
        sizes = [b.n_states for b in self.blocks]
        self.state_bases = np.concatenate(
            [[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    def _compile(self, regex: str) -> DFA:
        if self.search:
            return make_search_dfa(compile_regex(".*(" + regex + ")"))
        return compile_regex(regex)

    # -- shape -----------------------------------------------------------

    @property
    def n_patterns(self) -> int:
        return len(self.dfas)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def block_slice(self, b: int) -> slice:
        """Global pattern-index range covered by block ``b``."""
        lo = b * self.k_blk
        return slice(lo, min(lo + self.k_blk, self.n_patterns))

    def block_regexes(self, b: int) -> tuple[Optional[str], ...]:
        sl = self.block_slice(b)
        return self.regexes[sl]

    def block_names(self, b: int) -> tuple[str, ...]:
        return self.names[self.block_slice(b)]

    # -- identity --------------------------------------------------------

    @property
    def signature(self) -> str:
        """Full-set content hash (blocking layout + every block's tables)."""
        h = hashlib.sha1()
        h.update(f"k_blk={self.k_blk};search={self.search};".encode())
        for sig in self.block_signatures:
            h.update(sig.encode())
        return h.hexdigest()

    # -- editing ---------------------------------------------------------

    def with_patterns(self, updates: Mapping[Union[str, int], str]
                      ) -> "PatternSet":
        """A new set with some patterns replaced (by name or index) — the
        hot-swap constructor: unchanged blocks keep identical signatures, so
        ``swap_patterns`` reuses their compiled lowerings."""
        if any(r is None for r in self.regexes):
            raise ValueError("with_patterns requires a regex-sourced set")
        regexes = list(self.regexes)
        for key, regex in updates.items():
            idx = self.names.index(key) if isinstance(key, str) else int(key)
            regexes[idx] = regex
        return PatternSet(regexes, k_blk=self.k_blk, search=self.search,
                          names=self.names)

    def __repr__(self) -> str:
        return (f"PatternSet(K={self.n_patterns}, k_blk={self.k_blk}, "
                f"n_blocks={self.n_blocks}, search={self.search})")


def compile_pattern_suite(kind: str = "prosite", *, search: bool = True) -> dict[str, DFA]:
    """Compile a suite name -> minimal DFA map; search semantics by default."""
    if kind == "prosite":
        items = {k: compile_prosite(v) for k, v in PROSITE_PATTERNS.items()}
    elif kind == "pcre":
        items = {k: compile_regex(v) for k, v in PCRE_PATTERNS.items()}
    else:
        raise ValueError(f"unknown suite {kind!r}")
    if search:
        # search semantics: Sigma* R — prefix the DFA by allowing restarts.
        # Implemented by compiling .*(pattern) directly for correctness.
        if kind == "prosite":
            from .regex import prosite_to_regex
            items = {k: compile_regex(".*(" + prosite_to_regex(v) + ")")
                     for k, v in PROSITE_PATTERNS.items()}
        else:
            items = {k: compile_regex(".*(" + v + ")") for k, v in PCRE_PATTERNS.items()}
        items = {k: make_search_dfa(d) for k, d in items.items()}
    return items
