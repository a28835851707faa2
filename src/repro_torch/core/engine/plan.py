"""Planner layer: everything decided *before* a device call.

  * **spec-vs-seq split** — documents shorter than ``4 * num_chunks`` take the
    batched sequential scan, the rest take the speculative chunk path;
  * **shape bucketing** — speculative documents are grouped by
    ``next_pow2(ceil(n / C))`` chunk length; bucket keys are *sticky* across
    calls and fresh keys merge upward until the lifetime ``max_buckets``
    budget is respected (bucket keys decide the kernel's block size, and so
    its skipped-block counts);
  * **chunk partitioning / capacity weighting** — a ``ChunkLayout`` maps the
    padded symbol width of a bucket onto per-device chunk boundaries, uniform
    or capacity-weighted by the paper's Eqs. 1–7
    (``core.partition.weighted_partition``); on a ("doc", "chunk") mesh a
    ``MeshLayout`` holds one such layout per doc row-block and places
    documents raggedly over the rows;
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
from ..partition import Partition, uniform_partition, weighted_partition

__all__ = ["next_pow2", "resolve_device", "DeviceTables", "ChunkLayout",
           "MeshLayout", "BucketPlan", "MatchPlan", "LanePlan", "Planner",
           "ENTRY_STARTS", "ENTRY_STATES", "ENTRY_LANES",
           "expand_device_weights", "layout_device_work"]

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


def expand_device_weights(weights: np.ndarray,
                          chunks_per_device: int) -> np.ndarray:
    """Per-chunk weights from per-device weights (device d owns a contiguous
    run of ``chunks_per_device`` chunks)."""
    w = np.asarray(weights, dtype=np.float64)
    return np.repeat(w, chunks_per_device)


@dataclasses.dataclass
class ChunkLayout:
    """Static chunk boundaries of one bucket width, assigned to devices.

    ``starts``/``ends`` partition ``[0, width)`` into ``C`` contiguous
    chunks; chunk ``i`` lives on device ``device_of[i]`` (a contiguous run of
    ``C / D`` chunks a device).  ``exact[i]`` marks chunks that start at
    stream position 0 (chunk 0, and any chunk behind zero-length leading
    chunks); ``lmax`` is the padded per-chunk buffer length.
    """

    width: int
    starts: np.ndarray     # [C] int64
    ends: np.ndarray       # [C] int64
    device_of: np.ndarray  # [C] int64
    exact: np.ndarray      # [C] bool
    lmax: int

    @property
    def num_chunks(self) -> int:
        return int(self.starts.shape[0])

    @property
    def num_devices(self) -> int:
        return int(self.device_of.max()) + 1 if self.starts.size else 1

    @property
    def sizes(self) -> np.ndarray:
        return self.ends - self.starts

    # interior chunk boundaries keep >= 2 preceding symbols so r=2 boundary
    # keys always exist
    MIN_CUT = 2

    @classmethod
    def from_partition(cls, part: Partition, width: int,
                       devices: int) -> "ChunkLayout":
        c = part.start.shape[0]
        if c % devices != 0:
            raise ValueError(f"{c} chunks do not divide over {devices} devices")
        starts, ends = part.start.copy(), part.end.copy()
        if (starts[1:] == ends[:-1]).all():  # contiguous: clamp cut points
            cuts = np.where((starts > 0) & (starts < cls.MIN_CUT),
                            np.int64(cls.MIN_CUT), starts)
            cuts = np.minimum(np.maximum.accumulate(cuts), width)
            starts = cuts
            ends = np.append(cuts[1:], ends[-1])
        sizes = ends - starts
        return cls(width=width, starts=starts, ends=ends,
                   device_of=np.repeat(np.arange(devices), c // devices),
                   exact=(starts == 0), lmax=int(max(sizes.max(), 1)))

    @classmethod
    def uniform(cls, width: int, num_chunks: int,
                devices: int = 1) -> "ChunkLayout":
        return cls.from_partition(uniform_partition(width, num_chunks, 1),
                                  width, devices)

    @classmethod
    def weighted(cls, width: int, num_chunks: int, devices: int,
                 weights: np.ndarray, m: int = 1) -> "ChunkLayout":
        """Capacity-weighted boundaries (paper Eqs. 2–7 over the bucket
        width).  ``m = 1`` sizes chunks in proportion to capacity (equal
        capacities give ``uniform``); ``m = I_max`` is the paper's
        scalar-worker model, where the exact chunk 0 is ``m`` times longer.
        """
        w_chunks = expand_device_weights(weights, num_chunks // devices)
        return cls.from_partition(weighted_partition(width, w_chunks, m),
                                  width, devices)


@dataclasses.dataclass
class MeshLayout:
    """Per-doc-shard chunk layouts of one bucket width on a 2-D mesh.

    Doc row-block ``r`` (tile rows ``[r * B/Dd, (r+1) * B/Dd)``) belongs to
    mesh row ``r``, and ``rows[r]`` is that row's own ``ChunkLayout``,
    weighted by that row's chunk-axis devices.  All rows share ``width``;
    ``lmax`` is the largest padded chunk buffer over the rows.

    **Ragged doc rows.**  ``row_weights`` (the Eq. 1 weights of each mesh
    row's aggregate capacity) makes the document axis capacity-weighted
    too: ``doc_counts`` applies Eq. 7 to the document count of a tile and
    ``tile_rows`` packs real documents into the fixed row-blocks raggedly
    (a slow row gets more zero-length pad rows).  Only the doc -> tile-row
    placement moves, so results equal the uniform layout's.  ``None`` is
    the uniform placement.
    """

    width: int
    rows: tuple[ChunkLayout, ...]
    row_weights: tuple[float, ...] | None = None

    @property
    def doc_shards(self) -> int:
        return len(self.rows)

    @property
    def is_ragged(self) -> bool:
        return self.row_weights is not None

    def doc_counts(self, n: int) -> np.ndarray:
        """Eq. 7 on the doc axis: documents per mesh row, summing to ``n``."""
        if self.row_weights is None:
            d = self.doc_shards
            return np.diff(np.linspace(0, n, d + 1).astype(np.int64))
        part = weighted_partition(n, np.asarray(self.row_weights), 1)
        return (part.end - part.start).astype(np.int64)

    def tile_rows(self, m: int, tile: int) -> np.ndarray:
        """Physical tile row of each of ``m`` real documents ([m] int64).

        The tile keeps ``tile // doc_shards`` rows per mesh row; documents
        pack into the row-blocks per ``doc_counts``, clipped to the block
        size, with the overflow waterfilled into the fastest rows that
        still have room.  Uniform layouts return ``arange(m)``.
        """
        d = self.doc_shards
        if tile % d:
            raise ValueError(f"tile of {tile} rows does not split over "
                             f"{d} doc shards")
        if m > tile:
            raise ValueError(f"{m} documents exceed the {tile}-row tile")
        if self.row_weights is None:
            return np.arange(m, dtype=np.int64)
        rps = tile // d
        counts = np.minimum(self.doc_counts(m), rps)
        short = int(m - counts.sum())
        order = np.argsort(-np.asarray(self.row_weights, np.float64),
                           kind="stable")
        while short > 0:
            for r in order:
                if short and counts[r] < rps:
                    counts[r] += 1
                    short -= 1
        return np.concatenate(
            [r * rps + np.arange(counts[r], dtype=np.int64)
             for r in range(d)]) if m else np.zeros(0, np.int64)

    @property
    def num_chunks(self) -> int:
        return self.rows[0].num_chunks

    @property
    def lmax(self) -> int:
        return max(r.lmax for r in self.rows)

    @property
    def num_devices(self) -> int:
        return self.doc_shards * self.rows[0].num_devices

    def device_work(self, lengths: np.ndarray) -> np.ndarray:
        """Real symbols per device for one full tile of document lengths
        (pad rows as zeros): ``[Dd * Dc]`` in mesh row-major order."""
        lengths = np.asarray(lengths, dtype=np.int64)
        if lengths.shape[0] % self.doc_shards:
            raise ValueError(f"tile of {lengths.shape[0]} rows does not "
                             f"split over {self.doc_shards} doc shards")
        rps = lengths.shape[0] // self.doc_shards
        return np.concatenate(
            [layout_device_work(row, lengths[r * rps:(r + 1) * rps])
             for r, row in enumerate(self.rows)])


def layout_device_work(layout: ChunkLayout,
                       lengths: np.ndarray) -> np.ndarray:
    """Real symbols matched per device for documents of the given lengths:
    a chunk's work on a document of length ``n`` is the overlap of its
    ``[start, end)`` with ``[0, n)``.  Returns ``[D]`` summed over the
    documents."""
    lengths = np.asarray(lengths, dtype=np.int64)
    overlap = (np.minimum(layout.ends[None, :], lengths[:, None])
               - np.minimum(layout.starts[None, :], lengths[:, None]))
    per_chunk = overlap.sum(axis=0)
    work = np.zeros(layout.num_devices, dtype=np.int64)
    np.add.at(work, layout.device_of, per_chunk)
    return work


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
    """Sticky-bucket batch planner.

    ``max_buckets`` is the lifetime compiled-shape budget of the
    speculative path; the short-document sequential width is fixed at
    ``next_pow2(4C - 1)`` (it grows only when ``num_chunks <= 1``).

    ``devices`` is the chunk-axis extent and ``doc_shards`` the doc-axis
    extent of a ("doc", "chunk") matcher mesh (1 and 1 on a single device);
    ``num_chunks`` rounds up to a ``devices`` multiple.  ``weights`` holds
    per-device capacity weights, flat ``[doc_shards * devices]`` in mesh
    row-major order or ``[doc_shards, devices]``; with ``doc_shards > 1``
    ``layout_for`` returns a ``MeshLayout`` whose row ``r`` applies Eqs. 1–7
    with mesh row ``r``'s weights only.
    """

    def __init__(self, *, num_chunks: int = 8, max_buckets: int = 2,
                 devices: int = 1, weights: np.ndarray | None = None,
                 spec_m: int = 1, doc_shards: int = 1,
                 row_weights: np.ndarray | None = None):
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        if max_buckets < 1:
            raise ValueError("max_buckets must be >= 1")
        if devices < 1:
            raise ValueError("devices must be >= 1")
        if doc_shards < 1:
            raise ValueError("doc_shards must be >= 1")
        self.num_chunks = -(-int(num_chunks) // int(devices)) * int(devices)
        self.max_buckets = int(max_buckets)
        self.devices = int(devices)
        self.doc_shards = int(doc_shards)
        self.spec_m = int(spec_m)
        self.table_epoch = 0
        self.weights: np.ndarray | None = None
        self.row_weights: np.ndarray | None = None
        self.spec_keys: list[int] = []
        self.seq_width = next_pow2(max(4 * self.num_chunks - 1, 1))
        self._layouts: dict[int, ChunkLayout | MeshLayout] = {}
        if weights is not None or row_weights is not None:
            self.set_weights(weights, row_weights=row_weights)

    def set_weights(self, weights: np.ndarray | None, *,
                    row_weights: np.ndarray | None = None) -> None:
        """Replace the per-device capacity weights and drop the cached
        layouts (sticky bucket keys and the seq width survive: only chunk
        boundaries move).  ``row_weights`` ([doc_shards] Eq. 1 weights of
        each mesh row's aggregate capacity) make the doc axis of every
        ``MeshLayout`` ragged; ``None`` keeps the uniform doc split."""
        if row_weights is None:
            self.row_weights = None
        else:
            rw = np.asarray(row_weights, np.float64).reshape(-1)
            if rw.shape != (self.doc_shards,):
                raise ValueError(f"need one row weight per doc shard: "
                                 f"expected {self.doc_shards}, got {rw.size}")
            if not np.all(np.isfinite(rw)) or (rw <= 0).any():
                raise ValueError("row weights must be finite and > 0")
            self.row_weights = rw
        if weights is None:
            self.weights = None
        else:
            w = np.asarray(weights, np.float64)
            if w.ndim == 1:
                w = w.reshape(self.doc_shards, -1)
            if w.shape != (self.doc_shards, self.devices):
                raise ValueError("need one capacity weight per (doc, chunk) "
                                 f"device: expected {self.doc_shards}x"
                                 f"{self.devices}, got {w.shape}")
            if not np.all(np.isfinite(w)) or (w <= 0).any():
                raise ValueError("capacity weights must be finite and > 0")
            self.weights = w
        self._layouts.clear()

    def layout_for(self, chunk_len: int) -> ChunkLayout | MeshLayout:
        """Chunk boundaries of one spec bucket width (cached): a
        ``ChunkLayout`` on a single mesh row, a ``MeshLayout`` of per-row
        layouts when ``doc_shards > 1``."""
        if chunk_len not in self._layouts:
            width = self.num_chunks * chunk_len

            def row_layout(r: int) -> ChunkLayout:
                if self.weights is None:
                    return ChunkLayout.uniform(width, self.num_chunks,
                                               self.devices)
                return ChunkLayout.weighted(width, self.num_chunks,
                                            self.devices, self.weights[r],
                                            m=self.spec_m)

            if self.doc_shards == 1:
                self._layouts[chunk_len] = row_layout(0)
            else:
                rw = (tuple(float(w) for w in self.row_weights)
                      if self.row_weights is not None else None)
                self._layouts[chunk_len] = MeshLayout(
                    width=width,
                    rows=tuple(row_layout(r)
                               for r in range(self.doc_shards)),
                    row_weights=rw)
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
