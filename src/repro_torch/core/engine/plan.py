"""Planner layer: everything decided *before* a device call.

  * **spec-vs-seq split** — documents shorter than ``4 * num_chunks`` take the
    batched sequential scan, the rest take the speculative chunk path;
  * **shape bucketing** — speculative documents are grouped by
    ``next_pow2(ceil(n / C))`` chunk length; bucket keys are *sticky* across
    calls and fresh keys merge upward until the lifetime ``max_buckets``
    budget is respected (bucket keys decide the kernel's block size, and so
    its skipped-block counts);
  * **chunk partitioning** — a uniform ``ChunkLayout`` per bucket width;
  * **lookahead-table selection** — the packed Eq. 11/13 candidate tables
    plus the identity-pad device tensors, bundled once in ``DeviceTables``.

Planning is pure numpy; only ``DeviceTables`` touches a device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..automata import PackedDFA
from ..lookahead import PackedLookaheadTables, build_packed_lookahead_tables
from ..partition import Partition, uniform_partition

__all__ = ["next_pow2", "resolve_device", "DeviceTables", "ChunkLayout", "BucketPlan",
           "MatchPlan", "LanePlan", "Planner",
           "ENTRY_STARTS", "ENTRY_STATES", "ENTRY_LANES"]

# Entry-seed stage modes of a LanePlan (how chunk 0 / the scan rows start):
ENTRY_STARTS = "starts"  # the packed pattern start states (whole documents)
ENTRY_STATES = "states"  # caller-supplied exact [B, K] states
ENTRY_LANES = "lanes"    # candidate rows of each row's boundary key; output
                         # keeps the [B, K, S] lane axis


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another; asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    return dev


_R2_TABLE_CAP = 1 << 22  # max int32 entries of the r=2 [n_keys+1, Q] index


class DeviceTables:
    """Constant tensors shared by every executor lowering, on ``device``.

    ``table_pad_t`` appends the identity transition column ``pad_cls``;
    ``cand_pad_t``/``cidx_pad_t`` append the pad rows (the pad candidates row
    holds in-range states for the gather; the pad ``cand_index`` row stays
    -1).  ``absorbing[q]`` (host numpy; ``absorbing_t`` on the device, int32)
    marks states with only self-loops over real classes — the early-exit
    test.

    Boundary keys: ``lookahead_r=1`` keys a chunk on the class of the byte
    before it (Eq. 11, ``n_keys == n_classes``), ``lookahead_r=2`` on the
    pair ``c_prev * n_classes + c_last`` (Eq. 13, ``n_keys ==
    n_classes ** 2``); ``"auto"`` picks r=2 exactly when it strictly shrinks
    the lane width S and its tables fit ``_R2_TABLE_CAP``.  ``pad_key ==
    n_keys`` is the identity key.  The candidate tables build lazily on
    first speculative use.  ``device=None`` is the CUDA card and raises
    ``RuntimeError`` when there is none (``resolve_device``).
    """

    def __init__(self, packed: PackedDFA, *, lookahead_r: int | str = "auto",
                 device: torch.device | str | None = None):
        if lookahead_r not in ("auto", 1, 2):
            raise ValueError(f"lookahead_r must be 'auto', 1 or 2, "
                             f"got {lookahead_r!r}")
        self.packed = packed
        self.lookahead_r = lookahead_r
        self.device = resolve_device(device)
        self.pad_cls = packed.n_classes
        q = packed.n_states
        ident = np.arange(q, dtype=np.int32).reshape(-1, 1)
        self.table_pad_t = self._put(                   # [Q, n_cls + 1]
            np.concatenate([packed.table, ident], axis=1))
        self.starts_t = self._put(packed.starts)        # [K]
        self.sinks_t = self._put(packed.sinks)          # [K]
        self.byte_to_class_t = self._put(packed.byte_to_class)  # [256]
        self.absorbing = (packed.table
                          == np.arange(q, dtype=np.int32)[:, None]).all(axis=1)
        self.absorbing_t = self._put(self.absorbing)    # [Q] 0/1

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    @classmethod
    def build(cls, packed: PackedDFA, *, lookahead_r: int | str = "auto",
              device: torch.device | str | None = None) -> "DeviceTables":
        return cls(packed, lookahead_r=lookahead_r, device=device)

    @property
    def n_patterns(self) -> int:
        return self.packed.n_patterns

    @property
    def i_max(self) -> int:
        return self.tables.i_max

    @property
    def spec_r(self) -> int:
        """Resolved reverse-lookahead depth of the boundary-key space."""
        return self.tables.r

    @property
    def n_keys(self) -> int:
        return self.tables.n_keys

    @property
    def pad_key(self) -> int:
        """The identity boundary key (pad row of ``cand_pad``/``cidx_pad``)."""
        return self.tables.n_keys

    @functools.cached_property
    def tables(self) -> PackedLookaheadTables:
        if self.lookahead_r != "auto":
            return build_packed_lookahead_tables(self.packed,
                                                 r=int(self.lookahead_r))
        t1 = build_packed_lookahead_tables(self.packed)
        n, q = self.packed.n_classes, self.packed.n_states
        k = self.packed.n_patterns
        fits = (n * n + 1) * max(q, k * t1.i_max) <= _R2_TABLE_CAP
        if t1.i_max > 1 and n >= 2 and fits:
            t2 = build_packed_lookahead_tables(self.packed, r=2)
            if t2.i_max < t1.i_max:
                return t2
        return t1

    def advance_key(self, prev_key: int, data: bytes | np.ndarray) -> int:
        """Boundary key of a stream after it absorbs ``data`` (host-side).

        ``prev_key`` is the key before the segment (``-1`` = no usable
        history).  r=1: the class of the last byte.  r=2: a segment of >= 2
        bytes keys on its own suffix; a 1-byte segment shifts ``prev_key``'s
        last class in; without 2 bytes of history the key is ``-1``.
        """
        arr = (np.frombuffer(data, np.uint8)
               if isinstance(data, (bytes, bytearray))
               else np.asarray(data, np.uint8))
        if arr.size == 0:
            return int(prev_key)
        b2c = self.packed.byte_to_class
        if self.spec_r == 1:
            return int(b2c[arr[-1]])
        n = self.packed.n_classes
        if arr.size >= 2:
            return int(b2c[arr[-2]]) * n + int(b2c[arr[-1]])
        if 0 <= int(prev_key) < n * n:
            return (int(prev_key) % n) * n + int(b2c[arr[-1]])
        return -1

    @functools.cached_property
    def cand_pad_t(self) -> torch.Tensor:  # [n_keys + 1, K, S]
        t = self.tables
        return self._put(np.concatenate([t.candidates, t.candidates[:1]]))

    @functools.cached_property
    def cidx_pad_t(self) -> torch.Tensor:  # [n_keys + 1, Q]
        return self._put(np.concatenate(
            [self.tables.cand_index,
             np.full((1, self.packed.n_states), -1, np.int32)]))


@dataclasses.dataclass
class ChunkLayout:
    """Static chunk boundaries of one bucket width.

    ``starts``/``ends`` partition ``[0, width)`` into ``C`` contiguous
    chunks; ``exact[i]`` marks chunks that start at stream position 0;
    ``lmax`` is the padded per-chunk buffer length.
    """

    width: int
    starts: np.ndarray     # [C] int64
    ends: np.ndarray       # [C] int64
    exact: np.ndarray      # [C] bool
    lmax: int

    # interior chunk boundaries keep >= 2 preceding symbols so r=2 boundary
    # keys always exist
    MIN_CUT = 2

    @classmethod
    def from_partition(cls, part: Partition, width: int) -> "ChunkLayout":
        starts, ends = part.start.copy(), part.end.copy()
        if (starts[1:] == ends[:-1]).all():  # contiguous: clamp cut points
            cuts = np.where((starts > 0) & (starts < cls.MIN_CUT),
                            np.int64(cls.MIN_CUT), starts)
            cuts = np.minimum(np.maximum.accumulate(cuts), width)
            starts = cuts
            ends = np.append(cuts[1:], ends[-1])
        sizes = ends - starts
        return cls(width=width, starts=starts, ends=ends,
                   exact=(starts == 0), lmax=int(max(sizes.max(), 1)))

    @classmethod
    def uniform(cls, width: int, num_chunks: int) -> "ChunkLayout":
        return cls.from_partition(uniform_partition(width, num_chunks, 1),
                                  width)


@dataclasses.dataclass
class BucketPlan:
    """One fused device dispatch group: documents sharing a compiled shape."""

    kind: str            # "seq" | "spec"
    width: int           # padded byte/symbol width of the device buffer
    chunk_len: int       # Lc for spec buckets (width == C * Lc); 0 for seq
    doc_idx: np.ndarray  # [n_docs] int64 indices into the batch


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """One lane program: classify -> entry-seed -> chunk-scan -> merge.

      kind       "seq" (rows scan start-to-end) or "spec" (chunked scan +
                 Eq. 8 merge);
      entry      ``ENTRY_STARTS`` | ``ENTRY_STATES`` | ``ENTRY_LANES``;
      early_exit absorbing-state early exit enabled for this program;
      spec_r     boundary-key depth of the candidate tables.

    ``key`` is the lowering cache key.
    """

    kind: str
    width: int
    chunk_len: int
    entry: str
    early_exit: bool = True
    spec_r: int = 1
    table_epoch: int = 0

    def __post_init__(self):
        if self.kind not in ("seq", "spec"):
            raise ValueError(f"unknown plan kind {self.kind!r}")
        if self.entry not in (ENTRY_STARTS, ENTRY_STATES, ENTRY_LANES):
            raise ValueError(f"unknown entry mode {self.entry!r}")
        if self.spec_r not in (1, 2):
            raise ValueError(f"spec_r must be 1 or 2, got {self.spec_r!r}")

    @property
    def key(self) -> tuple:
        return (self.kind, self.width, self.chunk_len, self.entry,
                self.early_exit, self.spec_r, self.table_epoch)


@dataclasses.dataclass
class MatchPlan:
    """Everything an executor needs to run one batch, decided up front."""

    buckets: list[BucketPlan]
    lengths: np.ndarray      # [B] int64 document byte lengths
    spec_mask: np.ndarray    # [B] bool — True: speculative chunk path
    chunk_len: np.ndarray    # [B] int64 assigned Lc (0 for seq docs)

    @property
    def n_docs(self) -> int:
        return int(self.lengths.shape[0])


class Planner:
    """Sticky-bucket batch planner for one device.

    ``max_buckets`` is the lifetime compiled-shape budget of the
    speculative path; the short-document sequential width is fixed at
    ``next_pow2(4C - 1)`` (it grows only when ``num_chunks <= 1``).
    """

    def __init__(self, *, num_chunks: int = 8, max_buckets: int = 2):
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        if max_buckets < 1:
            raise ValueError("max_buckets must be >= 1")
        self.num_chunks = int(num_chunks)
        self.max_buckets = int(max_buckets)
        self.table_epoch = 0
        self.spec_keys: list[int] = []
        self.seq_width = next_pow2(max(4 * self.num_chunks - 1, 1))
        self._layouts: dict[int, ChunkLayout] = {}

    def layout_for(self, chunk_len: int) -> ChunkLayout:
        """Uniform chunk boundaries of one spec bucket width (cached)."""
        if chunk_len not in self._layouts:
            self._layouts[chunk_len] = ChunkLayout.uniform(
                self.num_chunks * chunk_len, self.num_chunks)
        return self._layouts[chunk_len]

    def lane_plan(self, bucket: BucketPlan, *, entry: str = ENTRY_STARTS,
                  early_exit: bool = True, spec_r: int = 1) -> LanePlan:
        return LanePlan(kind=bucket.kind, width=bucket.width,
                        chunk_len=bucket.chunk_len, entry=entry,
                        early_exit=early_exit, spec_r=spec_r,
                        table_epoch=self.table_epoch)

    def plan(self, lengths: np.ndarray) -> MatchPlan:
        """Assign every document to a bucket, updating the sticky key set."""
        lengths = np.asarray(lengths, dtype=np.int64)
        b = lengths.shape[0]
        c = self.num_chunks
        spec = (lengths >= 4 * c) & (c > 1)
        chunk_len = np.zeros(b, np.int64)
        buckets: list[BucketPlan] = []

        seq_idx = np.flatnonzero(~spec)
        if seq_idx.size and int(lengths[seq_idx].max()) > 0:
            lmax = int(lengths[seq_idx].max())
            if lmax > self.seq_width:  # only reachable when num_chunks <= 1
                self.seq_width = next_pow2(lmax)
            buckets.append(BucketPlan("seq", self.seq_width, 0, seq_idx))

        spec_idx = np.flatnonzero(spec)
        if spec_idx.size:
            lc = np.array([next_pow2(-(-int(n) // c)) for n in lengths[spec_idx]])
            # snap each doc up into an already-compiled bucket when one fits
            known = sorted(self.spec_keys)
            for j, v in enumerate(lc):
                fit = [key for key in known if key >= v]
                if fit:
                    lc[j] = fit[0]
            # fresh keys: merge smallest upward until within the lifetime
            # budget (always allowing one new key for oversized documents)
            fresh = sorted(set(lc.tolist()) - set(known))
            allowed = max(1, self.max_buckets - len(known))
            while len(fresh) > allowed:
                lc[lc == fresh[0]] = fresh[1]
                fresh.pop(0)
            self.spec_keys = sorted(set(known) | set(fresh))
            for key in sorted(set(lc.tolist())):
                sel = spec_idx[lc == key]
                chunk_len[sel] = key
                buckets.append(BucketPlan("spec", c * key, key, sel))

        return MatchPlan(buckets=buckets, lengths=lengths, spec_mask=spec,
                         chunk_len=chunk_len)
