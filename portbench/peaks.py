"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit,
and the least time a membership test needs, counted from its inputs alone.

HBM_BYTES_PER_S: 3.35 TB/s, NVIDIA's data sheet.

SMEM_LOADS_PER_S: a sequential DFA step is one dependent four-byte table
load per pattern and byte, served by shared memory (or L1, the same
hardware).  The card's 67 TFLOP/s float32 rate is 132 SMs x 128 lanes x 2
(an FMA) per clock, so it runs 67e12 / 256 = 2.617e11 SM clocks a second;
each SM serves 32 four-byte shared-memory words a clock, 8.375e12 loads a
second in all.  (The value PERF.md's kernel table has used since the
port's first kernels.)
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 67e12 / (128 * 2)
SMEM_LOADS_PER_S = 32 * SM_CLOCKS_PER_S


def membership_least_s(doc_bytes: int, k: int, table_bytes: int,
                       decisions: int) -> float:
    """The least time the card needs to decide ``k`` patterns over
    ``doc_bytes`` document bytes: the larger of ``k`` table lookups a byte
    at the shared-memory load rate and the documents, the tables and the
    one-byte decisions each moved once through HBM.  It counts no lanes,
    routes or kernels, so it is the same whatever implements the test."""
    lookups = k * doc_bytes / SMEM_LOADS_PER_S
    moved = (doc_bytes + table_bytes + decisions) / HBM_BYTES_PER_S
    return max(lookups, moved)
