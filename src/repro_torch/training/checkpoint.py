"""Checkpointing: async save, atomic publish, restore onto ``like``.

Layout per step:  <dir>/step_<N>/
    manifest.msgpack   — step, wall-time and the sorted leaf keys
    arrays.npz         — one entry per leaf (path-joined key)

Writes go to ``step_<N>.tmp`` and are atomically renamed — a crashed writer
never publishes a partial checkpoint, so restore always finds the latest
*complete* step (the ``RestartManager`` contract).  The layout is the JAX
package's, byte for byte in the keys: a checkpoint written by one package
restores in the other.

Keys follow ``jax.tree_util``'s paths without importing JAX: dict keys in
sorted order (an ``OrderedDict`` keeps its own), list and tuple entries by
index, a namedtuple field as ``.name``; ``None`` holds no leaf.  A leaf is a
``torch.Tensor`` on any device, a numpy array or a Python scalar.  A dtype
numpy lacks (bfloat16, the float8 types) is stored as its raw bit pattern,
``|V<itemsize>`` — what ``np.savez`` makes of an ``ml_dtypes`` array, so a
bfloat16 leaf of either package restores bit for bit in the other.

Restore follows ``like``: each leaf comes back as a tensor of the ``like``
leaf's dtype on the ``like`` leaf's device, or as numpy where ``like`` holds
no tensor.  Saving asynchronously copies every leaf to the host before
``submit`` returns (torch updates tensors in place, so a later ``add_`` must
not reach the file); the writer thread sees numpy only.

A state sharded on an LM mesh (``DTensor`` leaves, ``training.train_loop
.init_train_state_sharded``) saves collectively: every rank of the mesh
calls ``save``, each leaf is gathered whole to the host, and one writer,
the mesh's first rank, publishes the same ``arrays.npz``.  ``restore(like,
shardings=state_shardings(like, mesh))`` places a checkpoint saved on any
mesh onto this one: every rank reads the file and keeps its shards.

The manifest is msgpack without the ``msgpack`` package: ``_packb`` /
``_unpackb`` encode exactly the subset the manifest uses, in msgpack's
smallest encodings, so the bytes equal ``msgpack.packb``'s.
"""

from __future__ import annotations

import collections
import os
import shutil
import struct
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "save_checkpoint_async", "restore_checkpoint",
           "latest_step", "CheckpointManager"]


# -- the pytree walk ---------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node) -> Optional[list[tuple[Any, str, Any]]]:
    """(key, path name, child) of a container node in JAX's flattening
    order, or None for a leaf."""
    if isinstance(node, dict):
        keys = (list(node) if isinstance(node, collections.OrderedDict)
                else sorted(node))
        return [(k, str(k), node[k]) for k in keys]
    if _is_namedtuple(node):
        return [(f, f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(i, str(i), c) for i, c in enumerate(node)]
    return None


def _leaves(tree: Any, prefix: tuple = ()):
    """Yield (key, leaf) in JAX's order; ``None`` subtrees hold no leaf."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for _, name, child in kids:
        yield from _leaves(child, prefix + (name,))


def _rebuild(like: Any, leaf_of, prefix: tuple = ()) -> Any:
    """``like``'s structure with every leaf replaced by ``leaf_of(key,
    like_leaf)``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return leaf_of("/".join(prefix), like)
    vals = [(k, _rebuild(c, leaf_of, prefix + (name,)))
            for k, name, c in kids]
    if isinstance(like, dict):
        out = like.copy()      # keeps the mapping's own type
        out.update(vals)
        return out
    if _is_namedtuple(like):
        return type(like)(*(v for _, v in vals))
    return type(like)(v for _, v in vals)


# -- leaves to host numpy and back -------------------------------------------

def _dtensor_mesh(leaf: Any):
    """The LM mesh of a ``DTensor`` leaf (None for any other leaf)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        from ..launch.mesh import lm_mesh_of
        return lm_mesh_of(leaf)
    return None


def _to_numpy(leaf: Any) -> np.ndarray:
    """A host copy of one leaf (never a view of memory the caller may
    mutate afterwards); a ``DTensor`` leaf is gathered whole (collective)."""
    if _dtensor_mesh(leaf) is not None:
        from ..launch.mesh import whole_on_host
        leaf = whole_on_host(leaf, writer_only=True)
        if leaf is None:                 # not the writer: nothing to keep
            return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.to("cpu")           # a blocking device-to-host copy
        else:
            t = t.clone()
        try:
            return t.numpy()
        except TypeError:             # bfloat16, float8: no numpy dtype
            raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
            return raw.view(np.dtype(f"V{t.element_size()}")).reshape(
                tuple(t.shape))
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """Every leaf on the host; a sharded leaf is gathered to the writer
    (other ranks keep nothing of it)."""
    flat = {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}
    return {k: v for k, v in flat.items() if v is not None}


def _from_numpy(arr: np.ndarray, like: Any, host: bool = False) -> Any:
    """A loaded entry as the ``like`` leaf's type: a tensor of its dtype on
    its device (``host``: on the host), else numpy."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V":          # raw bit pattern of a non-numpy dtype
        nbytes = like.element_size()
        if arr.dtype.itemsize != nbytes:
            raise ValueError(f"stored {arr.dtype} cannot restore into "
                             f"{like.dtype} ({nbytes} bytes an element)")
        raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        out = raw.view(like.dtype).reshape(arr.shape)
        return out if host else out.to(like.device)
    return torch.from_numpy(np.array(arr)).to(
        device="cpu" if host else like.device, dtype=like.dtype)


def _unflatten(tree_like: Any, flat: dict[str, np.ndarray],
               host: bool = False) -> Any:
    return _rebuild(tree_like,
                    lambda key, like: _from_numpy(flat[key], like, host))


def _state_mesh(tree: Any):
    """The LM mesh of a sharded state (its first ``DTensor`` leaf's), or
    None."""
    for _, leaf in _leaves(tree):
        mesh = _dtensor_mesh(leaf)
        if mesh is not None:
            return mesh
    return None


def _is_writer(mesh) -> bool:
    import torch.distributed as dist
    return mesh is None or dist.get_rank() == int(mesh.ranks.flat[0])


# -- the manifest: msgpack's encoding of a small subset ----------------------

_UINT = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
         (0xCF, ">Q", 1 << 64))
_LEN16, _LEN32 = {0xA0: 0xDA, 0x90: 0xDC}, {0xA0: 0xDB, 0x90: 0xDD}


def _packb(obj: Any) -> bytes:
    """msgpack's smallest encoding (``msgpack.packb``'s bytes) of the
    manifest's subset: a map of fewer than 16 entries, str, non-negative
    int, float, and lists or tuples of them."""
    out = bytearray()

    def head(fix, n, fix_max):
        """A str or array header: fix form, then 8- (str only), 16- or
        32-bit length."""
        if n < fix_max:
            out.append(fix | n)
        elif fix == 0xA0 and n < 1 << 8:
            out.extend((0xD9, n))
        elif n < 1 << 16:
            out.append(_LEN16[fix])
            out.extend(struct.pack(">H", n))
        else:
            out.append(_LEN32[fix])
            out.extend(struct.pack(">I", n))

    def enc(x):
        if isinstance(x, bool) or x is None:
            raise TypeError(f"{x!r} is outside the manifest's subset")
        if isinstance(x, int):
            if x < 0:
                raise TypeError(f"{x} is outside the manifest's subset")
            if x < 0x80:
                out.append(x)
                return
            for tag, fmt, top in _UINT:
                if x < top:
                    out.append(tag)
                    out.extend(struct.pack(fmt, x))
                    return
            raise OverflowError(f"int {x} does not fit msgpack")
        if isinstance(x, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", x))
        elif isinstance(x, str):
            b = x.encode()
            head(0xA0, len(b), 32)
            out.extend(b)
        elif isinstance(x, (list, tuple)):
            head(0x90, len(x), 16)
            for v in x:
                enc(v)
        elif isinstance(x, dict) and len(x) < 16:
            out.append(0x80 | len(x))
            for k, v in x.items():
                enc(k)
                enc(v)
        else:
            raise TypeError(f"cannot msgpack-encode {type(x).__name__} in "
                            "the manifest's subset")

    enc(obj)
    return bytes(out)


_FIXED = {tag: fmt for tag, fmt, _ in _UINT} | {0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I"}


def _unpackb(data: bytes) -> Any:
    """Decode what ``_packb`` encodes (lists come back as lists)."""
    pos = 0

    def take(fmt):
        nonlocal pos
        (v,) = struct.unpack_from(fmt, data, pos)
        pos += struct.calcsize(fmt)
        return v

    def dec():
        nonlocal pos
        tag = data[pos]
        pos += 1
        if tag < 0x80:
            return tag
        if tag in _FIXED:
            return take(_FIXED[tag])
        if 0xA0 <= tag < 0xC0 or tag in (0xD9, 0xDA, 0xDB):
            n = tag & 0x1F if tag < 0xC0 else take(_LEN[tag])
            s = data[pos:pos + n].decode()
            pos += n
            return s
        if 0x90 <= tag < 0xA0 or tag in (0xDC, 0xDD):
            n = tag & 0x0F if tag < 0xA0 else take(_LEN[tag])
            return [dec() for _ in range(n)]
        if 0x80 <= tag < 0x90:
            out = {}
            for _ in range(tag & 0x0F):
                k = dec()
                out[k] = dec()
            return out
        raise ValueError(f"msgpack tag 0x{tag:02x} is outside the manifest's "
                         "subset")

    obj = dec()
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the object")
    return obj


# -- save and restore --------------------------------------------------------

def _publish(directory: str, flat: dict[str, np.ndarray], step: int) -> str:
    """Write host arrays to ``step_<N>.tmp`` and rename it into place."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys())}
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_packb(manifest))
    if os.path.exists(final):  # idempotent re-save
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, state: Any, step: int) -> str:
    """Publish ``state`` as step ``step``; a sharded state's leaves are
    gathered (every rank of its mesh calls this) and its mesh's first rank
    writes.  Returns the step's directory."""
    mesh = _state_mesh(state)
    flat = _flatten(state)
    if not _is_writer(mesh):
        return os.path.join(directory, f"step_{step:08d}")
    return _publish(directory, flat, step)


class _AsyncSaver:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def submit(self, directory: str, state: Any, step: int):
        self.wait()
        # every leaf is on the host, in memory of its own, before this
        # returns: the caller may update its tensors in place right away
        mesh = _state_mesh(state)
        flat = _flatten(state)
        if not _is_writer(mesh):
            return

        def work():
            try:
                self.last_path = _publish(directory, flat, step)
            except BaseException as exc:  # noqa: BLE001 — re-raised by wait
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_SAVER = _AsyncSaver()


def save_checkpoint_async(directory: str, state: Any, step: int) -> None:
    _SAVER.submit(directory, state, step)


def _step_of(name: str) -> Optional[int]:
    """Step number of a *published* checkpoint dir name, else None.

    ``step_<N>.tmp`` (a crashed or in-flight writer) and any stray
    non-numeric ``step_*`` entry are never a restore candidate.
    """
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [s for d in os.listdir(directory)
             if (s := _step_of(d)) is not None]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore the latest (or given) step in ``like``'s structure, each leaf
    on the ``like`` leaf's device and dtype; with ``shardings`` (a tree of
    ``(mesh, placements)``) each leaf, read on the host, is then placed on
    its mesh by ``distributed.fault_tolerance.reshard_tree`` (call it on
    every rank)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        if shardings is not None and isinstance(like, dict):
            # leaf by leaf: a rank holds one whole leaf at a time
            from ..distributed.fault_tolerance import reshard_tree
            return _rebuild(like, lambda key, leaf: reshard_tree(
                _from_numpy(z[key], leaf, host=True),
                _sharding_at(shardings, key))), step
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(like, flat, host=shardings is not None)
    if shardings is not None:
        from ..distributed.fault_tolerance import reshard_tree
        tree = reshard_tree(tree, shardings)
    return tree, step


def _sharding_at(shardings: Any, key: str) -> Any:
    """The sharding of the leaf at checkpoint key ``key`` in a tree of
    nested dicts."""
    node = shardings
    for part in key.split("/"):
        node = node[part]
    return node


class CheckpointManager:
    """Keep-last-K policy + async saves + restart-manager adapters."""

    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.directory = directory
        self.keep = keep
        self.use_async = use_async
        self._mesh = None        # the LM mesh of the last sharded save
        os.makedirs(directory, exist_ok=True)

    def save(self, state: Any, step: int) -> None:
        """Save (asynchronously by default); a sharded state's save is
        collective over its mesh."""
        self._mesh = _state_mesh(state)
        if self.use_async:
            save_checkpoint_async(self.directory, state, step)
        else:
            save_checkpoint(self.directory, state, step)
        if _is_writer(self._mesh):
            self._gc()

    def wait(self):
        """Wait for the last save to be published (after a sharded save,
        on every rank of its mesh: one barrier after the writer's wait)."""
        _SAVER.wait()
        if self._mesh is not None:
            from ..launch.mesh import barrier
            mesh, self._mesh = self._mesh, None
            barrier(mesh)

    def restore(self, like: Any, shardings: Any = None) -> tuple[Any, int]:
        self.wait()
        return restore_checkpoint(self.directory, like, shardings=shardings)

    def _gc(self):
        steps = sorted(s for d in os.listdir(self.directory)
                       if (s := _step_of(d)) is not None)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
