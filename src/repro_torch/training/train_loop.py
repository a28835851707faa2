"""Training step factory: microbatched gradient accumulation, on one device
or on an LM mesh.

The port of the JAX package's ``training/train_loop.py``.
``make_train_step(cfg, mesh, ...)`` returns ``train_step(state, batch) ->
(state, metrics)`` with

  * gradient accumulation over ``num_microbatches``: the batch splits on
    axis 0, each microbatch's forward and backward run in turn (one
    microbatch's activations live at a time, as under the reference's
    ``lax.scan``), float32 gradients and losses summed and divided by the
    count;
  * loss = token cross entropy + ``aux_loss_weight`` x the MoE aux loss,
    float32;
  * AdamW (``training.optimizer``) on the float32 parameters.

Each layer's body is rematerialised by ``cfg.remat_policy``
(``models.layers.remat``).  Gradients come from torch autograd.  The step
runs on the parameters' device and syncs nothing with the host: ``metrics``
holds ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors.  Unlike the
reference's pure function, the step updates the state's tensors in place
(the reference's production step donates its state to ``jit``): at full
width a second copy of the parameters and moments would not fit beside the
first.

On an LM mesh (``launch.mesh.LMMesh``) the state is sharded by
``state_shardings`` (``DTensor`` leaves whose local shards sit on the
rank's card; ``init_train_state_sharded`` builds it leaf by leaf) and the
step is one SPMD program a rank, the reference's sharding rules run as its
GSPMD program runs them; every rank passes the same global batch:

  * each rank takes its rows of each microbatch over the dp axes
    ("pod", "data"), as ``batch_specs`` places them;
  * each layer gathers its leaves over "data" just before use, inside its
    rematerialised body, so the backward pass gathers them again (FSDP),
    and frees them after use.  Every family keeps each leaf's "model"
    shard and runs tensor parallelism over "model" (``models.layers``:
    heads, hidden width and vocab; the RG-LRU's and the sLSTM's channels,
    the mLSTM's heads; one sum of partial results a block); the MoE
    layers' experts stay this rank's shard, under expert parallelism over
    "model", with the tokens split over it;
  * the loss is vocab-parallel: each rank keeps its ``[rows, T, V / m]``
    slice of the logits and ``models.layers.vocab_parallel_nll`` reduces
    the log-sum-exp and the gold logit over "model" (three ``[rows, T]``
    float32 tensors a microbatch), as the reference's partitioned
    ``lm_loss`` does; the whole vocab is never gathered;
  * gradients are averaged over the dp axes: over "data" each leaf's
    gradient is reduce-scattered to its shard (or averaged, where the
    leaf is whole over "data"), over "pod" averaged, or exchanged in int8
    (``distributed.compression``) with ``grad_compression="int8"``.  Along
    "model" a tensor-parallel leaf's gradient is the rank's shard, and a
    leaf whole over "model" gets equal gradients on every model rank; none
    is summed there;
  * AdamW updates each shard in place; the global gradient norm counts
    each element once.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig
from ..distributed import compression as comp
from ..distributed import sharding as shr
from ..launch import mesh as lmesh
from ..models import api
from ..models import layers as L
from ..models.transformer import lm_loss
from .optimizer import AdamWConfig, _tree_map, adamw_init, adamw_update

__all__ = ["TrainOptions", "make_train_step", "init_train_state",
           "init_train_state_sharded", "state_shardings", "jit_train_step",
           "local_state"]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    num_microbatches: int = 1
    aux_loss_weight: float = 0.01
    grad_compression: str = "none"   # none | int8
    optimizer: AdamWConfig = AdamWConfig()


def _wants_err(mesh, opts: TrainOptions) -> bool:
    return (opts.grad_compression == "int8" and mesh is not None
            and "pod" in tuple(mesh.mesh_dim_names))


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device=None,
                     mesh=None, opts: TrainOptions = TrainOptions()) -> dict:
    """``{"params", "opt"}``: ``api.init``'s random parameters from ``seed``
    on ``device`` (default: the card) and zero AdamW moments, whole; with
    ``grad_compression="int8"`` and a mesh with "pod", the error-feedback
    state ``"err"`` too."""
    params = api.init(cfg, seed, device=device)
    state = {"params": params, "opt": adamw_init(params)}
    if _wants_err(mesh, opts):
        state["err"] = comp.init_error_state(params)
    return state


def state_shardings(state: dict, mesh):
    """The ``(mesh, placements)`` tree of a train state (whole, or sharded:
    the rules read each leaf's global shape)."""
    Replicate = _replicate()
    specs = {
        "params": shr.param_specs(state["params"], mesh),
        "opt": {"m": shr.param_specs(state["opt"]["m"], mesh),
                "v": shr.param_specs(state["opt"]["v"], mesh),
                "step": tuple(Replicate for _ in mesh.mesh_dim_names)},
    }
    if "err" in state:
        specs["err"] = shr.param_specs(state["err"], mesh)
    return shr.named(specs, mesh)


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_state(tree):
    """The tree of each ``DTensor`` leaf's local shard (the tensor itself,
    not a copy: writing to it writes the state); other leaves as they
    are."""
    def local(x):
        if _is_dtensor(x):
            with torch.no_grad():
                return x.to_local()
        return x
    return _tree_map(local, tree)


def init_train_state_sharded(cfg: ModelConfig, seed: int, mesh,
                             opts: TrainOptions = TrainOptions()) -> dict:
    """The state of ``init_train_state(cfg, seed, mesh=mesh, opts=opts)``,
    placed by ``state_shardings`` on ``mesh``: each leaf is drawn whole
    from the seed in the unsharded order (one layer's leaves at a time),
    this rank keeps its shard on its device and frees the rest, so no rank
    ever holds the whole state.  Call it on every rank of the mesh."""
    shapes = api.param_shapes(cfg)
    specs = shr.param_specs(shapes, mesh)
    local = api.init(cfg, seed, device=mesh.device,
                     keep=shr.param_keep(mesh))

    def wrap(tree):
        return _tree_map(mesh.dtensor, tree, specs, shapes)

    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    rep = tuple(_replicate() for _ in mesh.mesh_dim_names)
    state = {"params": wrap(local),
             "opt": {"m": wrap(_tree_map(zeros, local)),
                     "v": wrap(_tree_map(zeros, local)),
                     "step": mesh.dtensor(torch.zeros(
                         (), dtype=torch.int32, device=mesh.device), rep,
                         ())}}
    if _wants_err(mesh, opts):
        state["err"] = wrap(_tree_map(zeros, local))
    return state


def _microbatches(batch: dict, nm: int) -> list[dict]:
    def split(name, x):
        if x.shape[0] % nm:
            raise ValueError(f"batch[{name!r}] has {x.shape[0]} rows, not a "
                             f"multiple of num_microbatches={nm}")
        return x.reshape((nm, x.shape[0] // nm) + tuple(x.shape[1:]))

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(nm)]


def make_train_step(cfg: ModelConfig, mesh=None,
                    opts: TrainOptions = TrainOptions()):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The
    batch's tensors (``tokens``, ``labels``, and ``patches`` or ``frames``
    where the family takes them) lie on the parameters' device; the state
    is updated in place and returned.  With ``mesh`` the state is
    ``init_train_state_sharded``'s and every rank passes the same global
    batch (see the module's docstring)."""
    if mesh is not None:
        return _make_sharded_step(cfg, mesh, opts)

    def loss_fn(params, mb):
        logits, aux = api.train_logits(params, cfg, mb)
        return lm_loss(logits, mb["labels"]) + opts.aux_loss_weight * aux

    def train_step(state, batch):
        params = state["params"]
        nm = opts.num_microbatches
        # leaves that share the parameters' storage and collect gradients:
        # each backward adds its float32 gradient to .grad (the sum over
        # microbatches), and the update below writes the parameters
        live = _tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            if nm > 1:
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
                for mb in _microbatches(batch, nm):
                    loss = loss_fn(live, mb)
                    loss.backward()
                    lsum = lsum + loss.detach()
                loss = lsum / nm
            else:
                loss = loss_fn(live, batch)
                loss.backward()
                loss = loss.detach()

        def grad(p):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            return g.div_(nm) if nm > 1 else g

        grads = _tree_map(grad, live)
        del live
        new_params, new_opt, metrics = adamw_update(
            opts.optimizer, params, grads, state["opt"])
        new_state = dict(state, params=new_params, opt=new_opt)
        return new_state, dict(metrics, loss=loss)

    return train_step


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _make_sharded_step(cfg: ModelConfig, mesh, opts: TrainOptions):
    names = tuple(mesh.mesh_dim_names)
    dp = lmesh.dp_axes(mesh)
    dp_size = mesh.axis_size(dp)
    n_data = mesh.axis_size("data")
    ep = "model" in names
    # the MoE layers see the "model" axis alone: the rows are this rank's
    layer_mesh = mesh.submesh(("model",)) if ep else None
    nm = opts.num_microbatches
    err_on = _wants_err(mesh, opts)

    def expert(path) -> bool:
        return ep and "moe" in path and path[-1] in shr.MOE_EXPERT_KEYS

    def rows(batch: dict, i: int) -> dict:
        """This rank's rows of microbatch ``i``."""
        out = {}
        for k, x in batch.items():
            b = x.shape[0]
            if b % nm or (b // nm) % dp_size:
                raise ValueError(f"batch[{k!r}] has {b} rows: not "
                                 f"num_microbatches={nm} x a multiple of "
                                 f"the {dp_size} data-parallel ranks")
            mb, part = b // nm, b // nm // dp_size
            start = i * mb + mesh.group_index(dp) * part
            out[k] = x[start:start + part]
        return out

    def train_step(state, batch):
        params = state["params"]
        shards = {p: shr.shards_of(x.placements, mesh)
                  for p, x in _paths(params).items()}
        local = local_state(params)
        live = _tree_map(lambda p: p.detach().requires_grad_(), local)

        def gathered(path, tree):
            """``tree`` (at ``path``; under a stack key one layer's
            entries) with every non-expert leaf gathered over "data", its
            "model" shard kept (tensor parallelism)."""
            stacked = bool(path) and path[0] in shr.STACK_KEYS

            def leaf(sub, x):
                full = path + sub
                if expert(full):
                    return x
                sh = tuple((a, d - 1 if stacked else d)
                           for a, d in shards[full] if a != "model")
                return lmesh.gather_shards(x, mesh, sh, summed=dp)
            return _map_sub(leaf, tree)

        loss_sum = torch.zeros((), dtype=torch.float32, device=mesh.device)
        with torch.enable_grad():
            for i in range(nm):
                mb = rows(batch, i)
                labels_all = batch["labels"].reshape(
                    (nm, -1) + tuple(batch["labels"].shape[1:]))[i]
                count = torch.clamp((labels_all >= 0).sum(), min=1)
                logits, aux = api.train_logits(
                    live, cfg, mb, mesh=layer_mesh, weights=gathered)
                nll_sum, _ = L.vocab_parallel_nll(
                    logits, mb["labels"], vocab=cfg.padded_vocab,
                    mesh=layer_mesh)
                obj = nll_sum * (dp_size / count) \
                    + opts.aux_loss_weight * aux
                obj.backward()
                loss_sum = loss_sum + obj.detach()
        loss = lmesh.all_reduce(loss_sum / nm, mesh, names, "mean")

        grads = {}
        for path, p in _paths(live).items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if nm > 1:
                g.div_(nm)
            # the data tier: the backward's reduce-scatter summed a data-
            # sharded leaf's gradient; a leaf whole over "data" averages
            if any(a == "data" for a, _ in shards[path]):
                g.div_(n_data)
            else:
                g = lmesh.all_reduce(g, mesh, "data", "mean")
            grads[path] = g
        del live
        # the pod tier: a mean, or the int8 exchange with error feedback
        if err_on:
            errs = _paths(local_state(state["err"]))
            mean, new_err = comp.compressed_pod_mean(grads, errs, mesh)
            for path, e in new_err.items():
                errs[path].copy_(e)
            grads = mean
        else:
            grads = {p: lmesh.all_reduce(g, mesh, "pod", "mean")
                     for p, g in grads.items()}
        # the global norm: each element once (a leaf is whole on the ranks
        # of the axes that do not shard it)
        n = mesh.size()
        sq = sum(torch.sum(torch.square(g)) * (
            math.prod(mesh.axis_size(a) for a, _ in shards[p]) / n)
            for p, g in grads.items())
        norm = torch.sqrt(lmesh.all_reduce(sq, mesh, names))
        _, _, metrics = adamw_update(opts.optimizer, local, _unpaths(grads),
                                     local_state(state["opt"]), norm=norm)
        return state, dict(metrics, loss=loss)

    return train_step


def _map_sub(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_sub(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def _unpaths(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def jit_train_step(cfg: ModelConfig, mesh, state, batch_specs_tree,
                   opts: TrainOptions = TrainOptions()):
    """The sharded step (the reference's ``jit``-wrapped entry with
    explicit shardings): the state is ``state_shardings``' and is updated
    in place (the reference donates it); the batch is the global one on
    every rank, split as ``batch_specs_tree`` places it (its leading dim
    over the dp axes)."""
    dp = lmesh.dp_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    for spec in _paths(batch_specs_tree).values():
        split = {names[i] for i, p in enumerate(spec)
                 if getattr(p, "dim", None) == 0}
        if split and split != set(dp):
            raise ValueError(f"batch placements {spec} split the rows over "
                             f"{sorted(split)}, not the dp axes {dp}")
    return make_train_step(cfg, mesh, opts)
