"""One rank's census of a traced program: flops, bytes, collectives and
kernel launches, the inputs of ``launch.roofline``.

The counterpart of the JAX package's ``launch/hlo_census.py``.  That module
parses the partitioned HLO of a compiled program and weights each op by the
trip counts of its enclosing while loops.  Torch has no HLO: eager torch
runs a program op by op, so this census watches one call of the program
through a ``TorchDispatchMode`` and counts every op the dispatcher runs.
The same code serves real tensors (on the card or the CPU) and
``FakeTensor``s, which carry shapes and no data (``launch.dryrun``).

  * ``dot_flops``        - 2 * |out| * K for every product the dispatcher
                           sees (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                           convolutions; ``torch.utils.flop_counter``'s
                           formulas).  A loop is unrolled by the dispatcher,
                           so nothing is multiplied afterwards.
  * ``approx_hbm_bytes`` - eager torch fuses nothing, so each op is charged
                           its tensor inputs read once and its outputs
                           written once; ``bytes_by_op`` splits it by op.
                           Views and metadata ops (returns that alias an
                           input without a write) and allocations are
                           charged 0, the counterpart of the HLO census's
                           skipped ops; an in-place op its operands.
  * ``max_multiplier``   - the most times one product signature (op, input
                           shapes, dtypes) ran: the nearest counterpart of
                           a while loop's trip count.
  * ``collectives``      - by the reference's five kinds, each with
                           ``bytes`` (the collective's output bytes, the
                           reference's convention: the gathered tensor of an
                           all-gather, the shard of a reduce-scatter),
                           ``count``, ``static_count`` (distinct (axes,
                           shape, dtype) signatures) and sorted
                           ``group_sizes``.  ``launch.mesh``'s collectives
                           record them (``census_hooks
                           .record_collective``).
  * ``kernels``          - ``{name: {"launches", "flops", "bytes"}}`` of the
                           hand-written kernels launched through
                           ``kernels.ops``: a launch through ctypes is
                           invisible to a dispatch mode, so the wrappers
                           record it (``census_hooks.record_kernel``)
                           with its work.
  * ``ops``              - calls per op (``aten.mm.default``: n).

``trace_memory`` adds the peak of the live storages over the call (each
storage an op creates counts, rounded up to the CUDA caching allocator's
512-byte blocks, until it is freed), the counterpart of XLA's
``memory_analysis``: what ``torch.cuda.max_memory_allocated`` would read
for the call and its arguments.

Everything is per rank: a traced rank sees its own shards.

The port takes its card route where a tensor is on the card
(``kernels.census_hooks.on_card``: B9 in ``models.layers.attention``, the
kernels in ``kernels.ops``).  A trace of the card's program (``launch
.dryrun``) uses fake CPU tensors inside ``fake_card()``, which sends
FakeTensors down the card route, on every torch: one route, the same
whether torch was built with CUDA or not (a torch built without it cannot
index, copy or differentiate fake CUDA tensors).  Real tensors are never
affected.  The layers report kernel launches and collectives through
``kernels.census_hooks``, which this module's censuses read.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.census_hooks import (_tensors, fake_card, is_fake, on_card,
                                    record_collective, record_kernel,
                                    recording, tensor_bytes)

__all__ = ["trace_census", "trace_memory", "Census", "LiveBytes",
           "record_collective", "record_kernel", "is_fake", "on_card",
           "fake_card", "tensor_bytes", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops whose tensor inputs are read for their metadata only
_LIKE = {"empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
         "randn_like", "randint_like", "new_empty", "new_zeros", "new_ones",
         "new_full", "new_empty_strided"}
# allocations: no byte moves
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# op -> (name, packet, a product?, a view?, an allocation?, inputs read
# for their metadata only?, in place?), the facts its schema fixes
_FACTS: dict = {}


def _facts(func) -> tuple:
    facts = _FACTS.get(func)
    if facts is None:
        packet = func.overloadpacket
        schema = func._schema
        in_place = schema.is_mutable or any(
            r.alias_info is not None and r.alias_info.is_write
            for r in schema.returns)
        facts = _FACTS[func] = (str(func), packet, packet in flop_registry,
                                func.is_view, packet.__name__ in _ALLOC,
                                packet.__name__ in _LIKE, in_place)
    return facts


class LiveBytes:
    """Bytes of the live storages it has been shown (``add``), each rounded
    up to 512 bytes and counted until the storage is freed, and their
    peak."""

    def __init__(self):
        self.current = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = -(-st.nbytes() // 512) * 512
        self.current += n
        self.peak = max(self.peak, self.current)
        self._refs[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k,
                                                                           n))

    def _free(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self.current -= n


class Census:
    """The counts of one trace; ``as_dict()`` is the record's form."""

    def __init__(self, live: LiveBytes | None = None):
        self.live = live
        self.dot_flops = 0
        self.hbm_bytes = 0
        self.bytes_by_op: dict[str, int] = collections.Counter()
        self.ops: dict[str, int] = collections.Counter()
        self.products: dict[tuple, int] = collections.Counter()
        self.collectives = {k: {"bytes": 0, "count": 0, "sigs": set(),
                                "group_sizes": set()} for k in COLLECTIVES}
        self.kernels: dict[str, dict] = {}

    # -- the dispatcher's ops -------------------------------------------------

    def op(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":
            return                       # prim.device, prim.layout: metadata
        name, packet, product, view, alloc, like, in_place = _facts(func)
        self.ops[name] += 1
        ins = _tensors(args) + _tensors(kwargs)
        if product:
            self.dot_flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
            self.products[(name, tuple(tuple(a.shape) for a in ins),
                           tuple(str(a.dtype) for a in ins))] += 1
        if view:
            return
        outs = _tensors(out)
        if self.live is not None:
            for o in outs:
                self.live.add(o)
        if alloc:
            return
        if in_place:
            moved = sum(_nbytes(a) for a in ins)          # operands
        else:
            moved = sum(_nbytes(o) for o in outs)
            if not like:
                moved += sum(_nbytes(a) for a in ins)
        if moved:
            self.hbm_bytes += moved
            self.bytes_by_op[str(packet)] += moved

    # -- records from the port's layers ---------------------------------------

    def collective(self, kind: str, out: torch.Tensor, group_size: int,
                   axes) -> None:
        c = self.collectives[kind]
        c["bytes"] += _nbytes(out)
        c["count"] += 1
        c["sigs"].add((tuple(axes), tuple(out.shape), str(out.dtype)))
        c["group_sizes"].add(int(group_size))

    def kernel(self, name: str, launches: int, flops: float,
               nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += int(launches)
        k["flops"] += flops
        k["bytes"] += nbytes

    def as_dict(self) -> dict:
        return {
            "dot_flops": float(self.dot_flops),
            "approx_hbm_bytes": float(self.hbm_bytes),
            "collectives": {
                k: {"bytes": float(c["bytes"]), "count": c["count"],
                    "static_count": len(c["sigs"]),
                    "group_sizes": sorted(c["group_sizes"])}
                for k, c in self.collectives.items()},
            "max_multiplier": max(self.products.values(), default=1),
            "bytes_by_op": {k: float(v) for k, v in
                            sorted(self.bytes_by_op.items())},
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "ops": dict(sorted(self.ops.items())),
            "n_ops": sum(self.ops.values()),
        }


class _Mode(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.census.op(func, args, kwargs, out)
        return out


def _trace(census: Census, fn, args, kwargs):
    with recording(census), _Mode(census):
        return fn(*args, **kwargs)


def trace_census(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), census)``: one call of ``fn`` under the
    census, whose dict has the JAX package's ``hlo_census`` keys (and
    ``collectives``, ``kernels``, ``ops``)."""
    census = Census()
    return _trace(census, fn, args, kwargs), census.as_dict()


def trace_memory(fn, args: tuple, arguments) -> tuple:
    """``(fn(*args), census, memory)``: ``trace_census`` with the live
    storages tracked; ``memory`` is ``{"peak_bytes", "argument_bytes",
    "temp_bytes"}``, the tensors ``arguments`` live from the start
    (``argument_bytes``) and ``temp_bytes`` = peak - arguments."""
    live = LiveBytes()
    for t in arguments:
        live.add(t)
    argument_bytes = live.current
    census = Census(live)
    result = _trace(census, fn, args, {})
    return result, census.as_dict(), {
        "peak_bytes": live.peak, "argument_bytes": argument_bytes,
        "temp_bytes": live.peak - argument_bytes}
