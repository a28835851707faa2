"""Byte-level tokenizer with a small reserved-special block.

Production LM stacks pair a learned subword vocab with the model's embedding
table; for this framework the data path is byte-level (ids 0..255) plus
specials, which keeps the DFA corpus filter (data/filter.py) and the
grammar-constrained decoder (serving/constrained.py) operating on the same
alphabet the paper's automata use.  Models with larger vocabs simply embed
the byte ids; nothing in the pipeline assumes vocab == 256 + specials.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258
    N_SPECIAL = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.N_SPECIAL

    def encode(self, text: str | bytes, *, bos: bool = True,
               eos: bool = True) -> np.ndarray:
        raw = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        ids = list(raw)
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: np.ndarray) -> bytes:
        return bytes(int(i) for i in np.asarray(ids).reshape(-1)
                     if 0 <= int(i) < 256)
