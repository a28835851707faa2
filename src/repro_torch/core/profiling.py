"""Offline capacity profiling (paper Sec. 4.1 step 1, Eq. 1) + shape autotuner.

On heterogeneous fleets the partitioner needs per-worker matching
capacities ``m_k`` (symbols/us).  The paper measures several partial
matching runs and takes the *median*; so does ``profile_capacity``, against
a benchmark DFA, with the sequential matcher (``sequential_state``: kernel
B6 with one lane on a card, a host loop on the CPU).  ``profile_workers``
turns capacities into the Eq. 1 weights that ``SpecDFAEngine(weights=...)``
takes; ``synthetic_capacities`` makes a skewed fleet for benchmarks and
tests.

On a sharded matcher's mesh ``calibrated_capacities(..., mesh=)`` measures
each rank's own device and gathers the [D] vector in row-major mesh order,
so every rank lays out the same chunks.

The same measure-then-choose discipline drives ``autotune_spec_shapes``, the
opt-in shape autotuner behind ``Matcher(autotune=True)``: it times candidate
``(num_chunks, l_blk)`` configurations (and, on the sharded backend, mesh
extents, each candidate's cost the slowest rank's) on a synthetic probe
corpus and applies the measured winner.  ``l_blk`` is the symbol block of the fused CUDA kernels,
so it is searched on ``backend="cuda"``.  Results cache per (DFA,
candidates, device, backend) key: in-process, and on disk when
``$REPRO_AUTOTUNE_CACHE`` names a JSON path (the JAX package's row schema).

The synthetic probe is only the cold-start guess.  ``TrafficProfile``
accumulates the (batch fill, document length) distribution of *real*
dispatches; its ``snapshot()``, an ``ObservedTraffic`` signature, feeds
back through ``autotune_spec_shapes(observed=...)`` so the probe corpus
mirrors what the matcher serves, and ``ObservedTraffic.drift`` tells
``Matcher.maybe_retune`` when the live distribution has moved far enough
from the one the current shapes were tuned on to justify re-timing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .automata import DFA, random_dfa
from .engine import sequential_state
from .engine.plan import resolve_device
from .partition import capacity_weights

__all__ = ["profile_capacity", "profile_workers", "synthetic_capacities",
           "calibrated_capacities", "clear_calibration_cache",
           "mesh_gather_values",
           "TunedShape", "autotune_spec_shapes", "clear_autotune_cache",
           "ObservedTraffic", "TrafficProfile", "synthetic_traffic"]


def profile_capacity(dfa: DFA | None = None, *, n_symbols: int = 200_000,
                     repeats: int = 5, seed: int = 0, devices=None,
                     device=None) -> float | np.ndarray:
    """Median symbols/us of the sequential matcher (paper Sec. 4.1 step 1).

    With ``devices=None`` (the default): one measurement on ``device`` (the
    card unless the caller names another; raises without one), returned as
    a float.  With ``devices=`` a sequence of torch devices: the same
    benchmark run timed per device (table and symbol stream placed there)
    and a [D] symbols/us array returned, ready for ``profile_workers``.
    On a card every timed run ends in ``torch.cuda.synchronize()``.
    """
    rng = np.random.default_rng(seed)
    if dfa is None:
        dfa = random_dfa(64, 16, rng=rng)
    table_np = np.asarray(dfa.table, np.int32)
    classes_np = rng.integers(0, dfa.n_classes, size=n_symbols, dtype=np.int32)

    def measure(device) -> float:
        dev = resolve_device(device)
        table = torch.as_tensor(table_np, device=dev)
        classes = torch.as_tensor(classes_np, device=dev)

        def run():
            sequential_state(table, classes, dfa.start)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        run()  # warmup (and the kernel build, on a card)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return n_symbols / (float(np.median(times)) * 1e6)

    if devices is None:
        return measure(device)
    return np.array([measure(d) for d in devices], dtype=np.float64)


# (device set, benchmark signature) -> measured [D] capacities: one timed
# benchmark per device set per process; ``refresh`` re-measures.
_CALIBRATION_CACHE: dict[tuple, np.ndarray] = {}


def _calibration_key(devices, dfa: DFA | None, n_symbols: int, repeats: int,
                     seed: int, mesh=None) -> tuple:
    # a custom benchmark DFA changes what is being measured -> its content
    # hashes into the key; the default benchmark is pinned by its parameters
    sig = ("default",) if dfa is None else (
        dfa.table.shape, dfa.table.tobytes(), int(dfa.start))
    key = (tuple(str(d) for d in devices), sig, int(n_symbols),
           int(repeats), int(seed))
    # a mesh's vector is the gathered one: its own entry per mesh
    return key if mesh is None else key + (id(mesh), tuple(mesh.shape))


def mesh_gather_values(mesh, values, device) -> np.ndarray:
    """All-gather each rank's float64 values over the whole mesh: [D, ...]
    in row-major mesh order, identical on every rank (``device`` is the
    rank's own, where an NCCL mesh gathers)."""
    from ..launch.mesh import all_gather_rows
    x = torch.as_tensor(np.atleast_1d(np.asarray(values, np.float64)))
    out = all_gather_rows(mesh, x[None].to(device))
    return out.cpu().numpy()


def calibrated_capacities(devices, dfa: DFA | None = None, *,
                          n_symbols: int = 200_000, repeats: int = 5,
                          seed: int = 0, refresh: bool = False,
                          mesh=None) -> np.ndarray:
    """Cached ``profile_capacity`` over a device set (one measurement per
    (device set, benchmark) pair per process).

    With ``mesh`` (a sharded matcher's ``DeviceMesh``; call it on every
    rank): ``devices`` is this rank's own device, each rank measures it, and
    the [D] capacities are gathered over the mesh in row-major order, the
    same vector on every rank.  ``refresh=True`` forces a re-measurement and
    replaces the cache entry.  Returns a copy; mutating the result never
    corrupts the cache.
    """
    key = _calibration_key(devices, dfa, n_symbols, repeats, seed, mesh)
    if refresh or key not in _CALIBRATION_CACHE:
        caps = np.asarray(
            profile_capacity(dfa, n_symbols=n_symbols, repeats=repeats,
                             seed=seed, devices=list(devices)), np.float64)
        if mesh is not None:
            caps = mesh_gather_values(mesh, caps,
                                      resolve_device(devices[0])).reshape(-1)
        _CALIBRATION_CACHE[key] = caps
    return _CALIBRATION_CACHE[key].copy()


def clear_calibration_cache() -> None:
    """Drop every cached calibration (tests; full cluster restart)."""
    _CALIBRATION_CACHE.clear()


def profile_workers(capacities: np.ndarray | list[float]) -> np.ndarray:
    """Eq. 1 weights from measured capacities (one entry per worker)."""
    return capacity_weights(np.asarray(capacities, dtype=np.float64))


# --------------------------------------------------------------------------
# observed traffic (autotune feedback loop)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ObservedTraffic:
    """Compact signature of dispatch traffic: the probe corpus to tune on.

    ``batch`` is the median real-document fill of a dispatched tile;
    ``lengths`` a sorted quantile sample of real document lengths (one probe
    document per entry).  Hashable, so it extends the autotune cache key.
    """

    batch: int
    lengths: tuple

    def drift(self, other: "ObservedTraffic") -> float:
        """Symmetric distribution distance, in doublings.

        The max of |log2| ratios of the median document length and of the
        tile fill: 1.0 means the traffic halved or doubled on some axis,
        the scale at which a different ``l_blk`` / ``num_chunks`` starts
        winning.
        """
        def ratio(a: float, b: float) -> float:
            return abs(float(np.log2(max(a, 1.0) / max(b, 1.0))))

        med_a = float(np.median(self.lengths)) if self.lengths else 1.0
        med_b = float(np.median(other.lengths)) if other.lengths else 1.0
        return max(ratio(med_a, med_b),
                   ratio(float(self.batch), float(other.batch)))


def synthetic_traffic(probe_docs: int = 8,
                      probe_bytes: int = 2048) -> ObservedTraffic:
    """The traffic signature of the default synthetic probe corpus.

    ``Matcher(autotune=True)`` seeds its drift baseline with this, so the
    first ``maybe_retune`` compares real traffic against what the cold-start
    tuning measured.
    """
    return ObservedTraffic(batch=int(probe_docs),
                           lengths=(int(probe_bytes),) * int(probe_docs))


class TrafficProfile:
    """Bounded reservoir of observed (tile fill, document length) samples.

    ``Matcher._dispatch`` records every dispatched tile; ``snapshot()``
    collapses the reservoir into an ``ObservedTraffic`` signature (median
    fill + length quantiles).  Bounded deques keep long-running servers at
    O(max_samples) memory while tracking the *recent* distribution, which
    is what drift detection wants.
    """

    def __init__(self, max_samples: int = 4096):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.max_samples = int(max_samples)
        self._lengths: deque = deque(maxlen=self.max_samples)
        self._batches: deque = deque(maxlen=self.max_samples)
        self.n_tiles = 0
        self.n_docs = 0

    @property
    def n_samples(self) -> int:
        return len(self._lengths)

    def record(self, batch: int, lengths) -> None:
        """One dispatched tile: ``batch`` real docs with these lengths."""
        self.n_tiles += 1
        self.n_docs += int(batch)
        self._batches.append(int(batch))
        self._lengths.extend(int(x) for x in np.asarray(lengths).ravel())

    def snapshot(self, probe_docs: int = 8) -> Optional[ObservedTraffic]:
        """Current signature, or None before any traffic was recorded."""
        if not self._lengths:
            return None
        lens = np.asarray(self._lengths, dtype=np.float64)
        qs = np.quantile(lens, np.linspace(0.0, 1.0, int(probe_docs)))
        lengths = tuple(int(max(1, round(q))) for q in qs)
        batch = int(max(1, round(float(np.median(self._batches)))))
        return ObservedTraffic(batch=batch, lengths=lengths)


# --------------------------------------------------------------------------
# shape autotuner (Matcher(autotune=True))
# --------------------------------------------------------------------------

# The kernel symbol blocks tried on backend="cuda".  B1's ring tile divides
# the block (``dfa_match.merge_plan``), so the candidates are powers of two,
# and each keeps a tile of 256-2,048 symbols (the block, or the most the
# ring holds) at PCRE-14's 8-16 KiB chunks; chip_smoke.py phase 17 prints
# the tile of each.  A chunk shorter than a candidate clamps it to the
# chunk length (``ops._pad_to_block``), so on short documents several
# candidates run the same program.
CUDA_L_BLK_CANDIDATES = (256, 512, 1024, 2048, 4096)


@dataclasses.dataclass(frozen=True)
class TunedShape:
    """A measured shape choice for the speculative path.

    ``mesh_shape`` is the winning (doc, chunk) extents when the search ran
    over an ``"auto"`` sharded mesh (else the caller's value echoed back);
    ``l_blk`` is the winning kernel symbol-block length (0 = not searched:
    only the cuda backend scans symbols in blocks).  ``source`` records
    provenance: "measured", "cache" (in-process) or "disk" (the
    ``$REPRO_AUTOTUNE_CACHE`` file).
    """

    num_chunks: int
    mesh_shape: Optional[tuple]
    l_blk: int
    us_per_call: float
    source: str


_AUTOTUNE_CACHE: dict[str, TunedShape] = {}
_AUTOTUNE_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"


def clear_autotune_cache() -> None:
    """Drop every in-process autotune result (tests; never touches disk)."""
    _AUTOTUNE_CACHE.clear()


def _device_sig(device: torch.device) -> tuple:
    """What the cache key knows of the device: its type and index, and the
    card's name (a CPU tune is never reused on a card, nor one card's on
    another model)."""
    if device.type == "cuda":
        return ("cuda", device.index, torch.cuda.get_device_name(device))
    return (device.type, device.index)


def _autotune_key(packed, backend: str, nc_cands, lb_cands, mesh_shape,
                  devices, lookahead_r, observed=None, *,
                  device: torch.device) -> str:
    h = hashlib.sha256()
    h.update(packed.table.tobytes())
    h.update(packed.starts.tobytes())
    obs_sig = None if observed is None else (int(observed.batch),
                                             tuple(observed.lengths))
    world = (_world_size(),) if backend == "sharded" else ()
    h.update(repr((backend, tuple(nc_cands), tuple(lb_cands),
                   mesh_shape, devices, lookahead_r, obs_sig,
                   _device_sig(device)) + world).encode())
    return h.hexdigest()[:24]


def _disk_cache_load(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _disk_cache_store(path: str, key: str, tuned: TunedShape) -> None:
    data = _disk_cache_load(path)
    row = dataclasses.asdict(tuned)
    row["mesh_shape"] = list(tuned.mesh_shape) if isinstance(
        tuned.mesh_shape, tuple) else tuned.mesh_shape
    data[key] = row
    try:
        with open(path, "w") as fh:
            json.dump(data, fh, indent=1, sort_keys=True)
    except OSError:
        pass  # unwritable cache path degrades to in-process caching


def _probe_corpus(num_docs: int, doc_bytes: int, n_alpha: int = 8):
    rng = np.random.default_rng(0)
    return [rng.integers(0, n_alpha, size=doc_bytes).astype(np.uint8)
            for _ in range(num_docs)]


def _observed_corpus(observed: ObservedTraffic, n_alpha: int = 8):
    """Synthetic bytes shaped like the observed traffic (deterministic)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, n_alpha, size=max(1, int(n))).astype(np.uint8)
            for n in observed.lengths]


def _measure_config(packed, probe, *, backend: str, num_chunks: int,
                    mesh_shape, devices, l_blk: int, lookahead_r,
                    repeats: int, batch_tile: Optional[int] = None,
                    device=None) -> float:
    """Median host-clock microseconds of warm ``membership_batch`` calls of
    one candidate ``Matcher`` on ``device``; on a card each reading ends in
    ``torch.cuda.synchronize()`` (the call is host-bound, so the host work
    that decides the winner is inside the clock).  A sharded candidate
    builds its mesh on every rank and costs its slowest rank's median,
    gathered over the mesh, so every rank picks the same winner."""
    from .engine.facade import Matcher  # lazy: facade imports this module
    kw = {}
    if backend == "sharded":
        kw.update(mesh_shape=mesh_shape, devices=devices)
    if batch_tile is None:
        batch_tile = max(8, len(probe))
    m = Matcher(packed, num_chunks=num_chunks, backend=backend,
                batch_tile=int(batch_tile), lookahead_r=lookahead_r,
                device=device, **kw)
    if l_blk:
        m.executor.spec_l_blk[0] = int(l_blk)

    def run():
        m.membership_batch(probe)
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)

    run()  # warmup: lowering (and the kernel build) outside the clock
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    us = float(np.median(times)) * 1e6
    if backend == "sharded":
        us = float(mesh_gather_values(m.executor.mesh, [us],
                                      m.device).max())
    return us


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def autotune_spec_shapes(packed, *, backend: str = "cuda",
                         num_chunks_candidates: Sequence[int] = (4, 8),
                         mesh_shape=None, devices: Optional[int] = None,
                         lookahead_r="auto",
                         l_blk_candidates: Sequence[int] = CUDA_L_BLK_CANDIDATES,
                         probe_docs: int = 8, probe_bytes: int = 2048,
                         repeats: int = 2,
                         time_fn: Optional[Callable[[dict], float]] = None,
                         observed: Optional[ObservedTraffic] = None,
                         refresh: bool = False, device=None) -> TunedShape:
    """Measure candidate speculative shapes and return the fastest.

    Greedy coordinate descent over three axes: ``num_chunks`` (every
    backend), mesh (doc, chunk) extents (sharded backend with
    ``mesh_shape="auto"``: all divisor factorings of ``devices``, the world
    size by default, near-square first) and the kernel symbol-block length ``l_blk``
    (``backend="cuda"`` only), each axis tuned while the others hold their
    incumbent, so the search costs sums of candidates, not products.  Each
    candidate is one ``Matcher`` on ``device`` (the card unless the caller
    names another) timed on a deterministic synthetic corpus: the median of
    ``repeats`` warm ``membership_batch`` calls on the host clock.

    ``time_fn`` replaces the measurement: it receives the candidate config
    as a dict (``backend`` / ``num_chunks`` / ``mesh_shape`` / ``l_blk``)
    and returns a cost in microseconds, for deterministic tests.  A measured
    sharded tune runs on every rank of the world (SPMD): each candidate mesh
    is built everywhere and costs its slowest rank.  Results cache per (DFA,
    candidates, device, world size, backend) key: in-process always, and
    through the JSON file named by
    ``$REPRO_AUTOTUNE_CACHE`` when set (``refresh=True`` re-measures and
    overwrites both).

    ``observed`` replaces the synthetic ``probe_docs`` x ``probe_bytes``
    corpus with one shaped like real traffic (an ``ObservedTraffic``
    snapshot from ``TrafficProfile``: document-length quantiles become the
    probe documents, the median tile fill the probe batch tile).  The bytes
    stay synthetic; only the *shape* of the traffic is observed.  The
    signature extends the cache key, so re-tuning after drift never reuses
    a stale measurement.
    """
    nc_cands = [int(c) for c in num_chunks_candidates if int(c) >= 1]
    if not nc_cands:
        raise ValueError("need at least one num_chunks candidate")
    lb_cands = ([int(b) for b in l_blk_candidates if int(b) >= 1]
                if backend == "cuda" else [])
    device = resolve_device(device)
    key = _autotune_key(packed, backend, nc_cands, lb_cands, mesh_shape,
                        devices, lookahead_r, observed, device=device)
    cache_path = os.environ.get(_AUTOTUNE_CACHE_ENV)
    if not refresh:
        if key in _AUTOTUNE_CACHE:
            return dataclasses.replace(_AUTOTUNE_CACHE[key], source="cache")
        if cache_path:
            row = _disk_cache_load(cache_path).get(key)
            if row is not None:
                ms = row.get("mesh_shape")
                tuned = TunedShape(
                    num_chunks=int(row["num_chunks"]),
                    mesh_shape=tuple(ms) if isinstance(ms, list) else ms,
                    l_blk=int(row["l_blk"]),
                    us_per_call=float(row["us_per_call"]), source="disk")
                _AUTOTUNE_CACHE[key] = tuned
                return tuned

    if backend == "sharded" and mesh_shape == "auto":
        n_dev = int(devices) if devices else _world_size()
        mesh_cands = sorted(((d, n_dev // d) for d in range(1, n_dev + 1)
                             if n_dev % d == 0),
                            key=lambda s: abs(s[0] - s[1]))
    else:
        mesh_cands = [mesh_shape if backend == "sharded" else None]

    if observed is None:
        probe = _probe_corpus(probe_docs, probe_bytes)
        batch_tile = None
    else:
        probe = _observed_corpus(observed)
        batch_tile = max(8, len(probe), int(observed.batch))
    scores: dict[tuple, float] = {}

    def cost(nc: int, ms, lb: int) -> float:
        cfg = (nc, tuple(ms) if isinstance(ms, (tuple, list)) else ms, lb)
        if cfg not in scores:
            if time_fn is not None:
                scores[cfg] = float(time_fn(
                    {"backend": backend, "num_chunks": nc,
                     "mesh_shape": cfg[1], "l_blk": lb}))
            else:
                scores[cfg] = _measure_config(
                    packed, probe, backend=backend, num_chunks=nc,
                    mesh_shape=ms, devices=devices, l_blk=lb,
                    lookahead_r=lookahead_r, repeats=repeats,
                    batch_tile=batch_tile, device=device)
        return scores[cfg]

    base_lb = lb_cands[-1] if lb_cands else 0
    best_nc = min(nc_cands, key=lambda nc: cost(nc, mesh_cands[0], base_lb))
    best_ms = (min(mesh_cands, key=lambda ms: cost(best_nc, ms, base_lb))
               if len(mesh_cands) > 1 else mesh_cands[0])
    best_lb = (min(lb_cands, key=lambda lb: cost(best_nc, best_ms, lb))
               if lb_cands else 0)
    tuned = TunedShape(
        num_chunks=best_nc,
        mesh_shape=(tuple(best_ms) if isinstance(best_ms, (tuple, list))
                    else best_ms),
        l_blk=best_lb, us_per_call=cost(best_nc, best_ms, best_lb),
        source="measured")
    _AUTOTUNE_CACHE[key] = tuned
    if cache_path:
        _disk_cache_store(cache_path, key, tuned)
    return tuned


def synthetic_capacities(n_workers: int, *, ratio: float = 1.41,
                         n_fast: int | None = None) -> np.ndarray:
    """Deliberately skewed capacity profile for benchmarks and tests.

    ``n_fast`` workers run at ``ratio``x the base speed - 1.41 is the paper's
    measured gap between its two EC2 instance generations (Table 3); the
    default skews half the fleet.  Feed the result to ``profile_workers``
    to exercise the capacity-balanced partition without a real
    heterogeneous fleet.
    """
    if n_workers < 1:
        raise ValueError("need at least one worker")
    if n_fast is None:
        n_fast = n_workers // 2
    if not 0 <= n_fast <= n_workers:
        raise ValueError("n_fast out of range")
    return np.array([ratio] * n_fast + [1.0] * (n_workers - n_fast),
                    dtype=np.float64)
