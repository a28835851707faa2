"""Synthetic corpus generation for end-to-end training and filter benchmarks.

Generates documents from a mixture of character distributions (english-ish
words, code-ish tokens, protein-ish residue strings, numeric noise) with
pattern "contaminants" planted at a controlled rate so the DFA filter has
real positives to find — mirroring the paper's PCRE/PROSITE evaluation data.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterator, Optional

import numpy as np

__all__ = ["CorpusConfig", "generate_documents", "generate_bytes",
           "load_pattern_fixtures"]

_FIXTURES = (pathlib.Path(__file__).resolve().parents[3]
             / "tests" / "fixtures" / "pattern_corpus.json")

_WORDS = (b"the quick brown fox jumps over lazy dog state machine parallel "
          b"speculative chunk merge lookahead automaton pattern match input "
          b"cloud vector gather table processor speedup").split()
_CODE = (b"for while if else return int float def class import lambda "
         b"static void template typename").split()
_RESIDUES = b"ACDEFGHIKLMNPQRSTVWY"


@dataclasses.dataclass
class CorpusConfig:
    n_documents: int = 64
    doc_len: int = 2048
    contaminant: bytes = b"SECRET-123"   # planted pattern for filter tests
    contaminant_rate: float = 0.1        # fraction of docs containing it
    seed: int = 0


def _one_doc(rng: np.random.Generator, cfg: CorpusConfig) -> bytes:
    kind = rng.integers(0, 3)
    out = bytearray()
    while len(out) < cfg.doc_len:
        if kind == 0:
            out += rng.choice(_WORDS) + b" "
        elif kind == 1:
            out += rng.choice(_CODE) + b"_" + str(rng.integers(100)).encode() + b" "
        else:
            out += bytes(rng.choice(list(_RESIDUES),
                                    size=int(rng.integers(5, 40)))) + b"\n"
    doc = bytes(out[: cfg.doc_len])
    if rng.random() < cfg.contaminant_rate:
        pos = int(rng.integers(0, max(1, cfg.doc_len - len(cfg.contaminant))))
        doc = doc[:pos] + cfg.contaminant + doc[pos + len(cfg.contaminant):]
    return doc


def generate_documents(cfg: CorpusConfig) -> Iterator[bytes]:
    rng = np.random.default_rng(cfg.seed)
    for _ in range(cfg.n_documents):
        yield _one_doc(rng, cfg)


def generate_bytes(total: int, seed: int = 0) -> bytes:
    cfg = CorpusConfig(n_documents=(total // 2048) + 1, seed=seed)
    return b"".join(generate_documents(cfg))[:total]


def load_pattern_fixtures(path: Optional[str] = None) -> list[dict]:
    """Load the checked-in pattern corpus fixtures.

    Each entry is ``{"name", "kind" ("pcre"|"prosite"), "source" (the raw
    PCRE regex or PROSITE motif), "pattern" (the translated regex actually
    compiled — also valid Python ``re`` syntax, the conformance oracle),
    "positive": [str, ...], "negative": [str, ...]}`` with every example
    pre-verified against ``re.search`` at generation time.  Shared by the
    conformance suite and the ``pattern_scale`` benchmark so both sweep the
    same corpus the paper's PCRE/PROSITE evaluation stands in for.
    """
    p = pathlib.Path(path) if path is not None else _FIXTURES
    with open(p) as f:
        data = json.load(f)
    entries = data["entries"]
    if not entries:
        raise ValueError(f"no fixture entries in {p}")
    return entries
