"""What the port's layers tell a census (``launch.census``) and a running
torch profiler, and the card route's test for fake tensors.

The kernels' wrappers, the model's attention and the mesh's collectives
report here; ``launch.census`` reads the reports.  Outside a census
(``active()`` false) the reports cost one list test: nothing is counted.

  * ``is_fake`` / ``on_card`` / ``fake_card``: a tensor takes the card's
    route where it is a CUDA tensor, or a ``FakeTensor`` inside
    ``fake_card()`` (a dry run's trace of the card's program, with fake
    CPU tensors: ``launch.dryrun``).  Real tensors are never affected.
  * ``recording(census)``: the census that ``record_kernel`` and
    ``record_collective`` report to while it is open.
  * ``span(name)``: a named range of host time at a layer boundary (the
    matcher facade's plan, tile packing, read-back and scatter; the
    executor's lowering, upload, stages and launch), recorded as
    ``repro_torch.<name>`` on the profiler's own clock while a torch
    profiler records, and nothing otherwise (one flag test).
"""

from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["is_fake", "on_card", "fake_card", "active", "recording",
           "record_collective", "record_kernel", "tensor_bytes", "span"]

# the censuses being taken (innermost last)
_ACTIVE: list = []
# whether FakeTensors stand for card tensors (``fake_card``)
_FAKE_CARD = [False]
# the span of every call made while no profiler records
_NO_SPAN = contextlib.nullcontext()


def is_fake(x) -> bool:
    """Whether ``x`` is a ``FakeTensor`` (shapes, no data)."""
    return isinstance(x, FakeTensor)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's route: a CUDA tensor, or a FakeTensor
    inside ``fake_card()``."""
    return x.device.type == "cuda" or (_FAKE_CARD[0] and is_fake(x))


@contextlib.contextmanager
def fake_card():
    """Within, every FakeTensor takes the card's route (``on_card``)."""
    was = _FAKE_CARD[0]
    _FAKE_CARD[0] = True
    try:
        yield
    finally:
        _FAKE_CARD[0] = was


def active() -> bool:
    """Whether a census is being taken."""
    return bool(_ACTIVE)


@contextlib.contextmanager
def recording(census):
    """Within, the reports go to ``census`` (and to any census open
    around it)."""
    _ACTIVE.append(census)
    try:
        yield census
    finally:
        _ACTIVE.remove(census)


def _tensors(x) -> list:
    """The tensors of an op's arguments or results (a tensor, a number,
    or a list, tuple or dict of them, as the dispatcher passes them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    out = []
    for y in x:
        out += _tensors(y)
    return out


def tensor_bytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or a list, tuple or dict
    of them and other values)."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def record_collective(kind: str, out: torch.Tensor, group_size: int,
                      axes=()) -> None:
    """Count a collective of ``kind`` (one of ``launch.census
    .COLLECTIVES``) whose output is ``out``, over a group of
    ``group_size`` ranks along ``axes``, in every census being taken."""
    for c in _ACTIVE:
        c.collective(kind, out, group_size, axes)


def record_kernel(name: str, launches: int, flops: float,
                  nbytes: float) -> None:
    """Count ``launches`` of the hand-written kernel ``name`` and their
    work in every census being taken."""
    for c in _ACTIVE:
        c.kernel(name, launches, flops, nbytes)


def span(name: str):
    """A context manager that records ``repro_torch.<name>`` as a range of
    the running torch profiler (``record_function``: the profiler's host
    event, on the clock it places the card's activity on), or does nothing
    where no profiler records.  Spans nest on the caller's thread."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function("repro_torch." + name)
    return _NO_SPAN
