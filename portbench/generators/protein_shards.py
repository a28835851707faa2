"""Shards of a protein sequence database for motif scanning.

Residues are drawn from a stated composition (UniProtKB/Swiss-Prot's, in the
mix file); sequences have gamma-distributed lengths and each ends with a
newline, the shard's last byte included, so a shard holds whole sequences.
Each PROSITE motif of the configuration is planted once in a
``motif_share`` of the shards, and ``boundary_plants`` further motif
instances a shard straddle a multiple of ``boundary_stride``.  An instance
is sampled from the PROSITE text itself (``syntax/prosite.py``); a motif
anchored at the C-terminus is planted with the newline that ends its
sequence.
"""

from __future__ import annotations

import numpy as np

from portbench import manifest, textgen

prosite = manifest.load_module("syntax", "prosite")


def residue_table(mix: dict) -> np.ndarray:
    """65,536 residue codes in the mix's proportions: one uint16 draw picks
    a residue (the composition rounded to 1 / 65,536)."""
    p = np.asarray(mix["composition"], np.float64)
    edges = np.cumsum(p / p.sum()) * 65536
    idx = np.searchsorted(edges, np.arange(65536) + 0.5)
    codes = np.frombuffer(mix["residues"].encode(), np.uint8)
    return codes[np.minimum(idx, codes.size - 1)]


def make_shards(rng: np.random.Generator, lengths, config: dict,
                mix: dict) -> list[bytes]:
    table = residue_table(mix)
    residues = mix["residues"].encode()
    motifs = [prosite.parse(t) for t in config["patterns"].values()]
    n_docs = len(lengths)
    bufs = []
    for n in lengths:
        buf = table[rng.integers(0, 65536, size=int(n), dtype=np.uint16)]
        shape = mix["sequence_shape"]
        seqs = rng.gamma(shape, mix["mean_sequence"] / shape,
                         size=int(n) // mix["mean_sequence"] * 2 + 16)
        ends = np.cumsum(np.maximum(seqs.astype(np.int64), 1) + 1) - 1
        buf[ends[ends < n]] = ord("\n")
        buf[-1] = ord("\n")
        bufs.append(buf)
    # plants write inside buf[:-1], so the shard's last newline stays
    per_motif = max(1, round(mix["motif_share"] * n_docs))
    for motif in motifs:
        for d in rng.choice(n_docs, size=per_motif, replace=False):
            text = prosite.instance(rng, motif, residues)
            pos = int(rng.integers(0, bufs[d].shape[0] - len(text)))
            textgen.plant(bufs[d], text, pos)
    for buf in bufs:
        for _ in range(mix["boundary_plants"]):
            text = prosite.instance(rng, motifs[int(rng.integers(len(motifs)))],
                                    residues)
            textgen.plant_across_boundary(rng, buf[:-1], text,
                                          mix["boundary_stride"])
    return [b.tobytes() for b in bufs]


def make_pool(config: dict, mix: dict, seed: int) -> list[list[bytes]]:
    """``mix["pool"]`` calls of ``mix["docs_per_call"]`` shards each."""
    pool = []
    for rng in textgen.streams(seed, mix["pool"]):
        lengths = textgen.stratified_lengths(
            rng, mix["docs_per_call"], mix["min_bytes"], mix["max_bytes"])
        pool.append(make_shards(rng, lengths, config, mix))
    return pool
