"""Training step factory: microbatched gradient accumulation on one device.

The port of the JAX package's ``training/train_loop.py``.
``make_train_step(cfg, ...)`` returns ``train_step(state, batch) ->
(state, metrics)`` with

  * gradient accumulation over ``num_microbatches``: the batch splits on
    axis 0, each microbatch's forward and backward run in turn (one
    microbatch's activations live at a time, as under the reference's
    ``lax.scan``), float32 gradients and losses summed and divided by the
    count;
  * loss = token cross entropy + ``aux_loss_weight`` x the MoE aux loss,
    float32 (``loss_fn``);
  * AdamW (``training.optimizer``) on the float32 parameters.

Each layer's body is rematerialised by ``cfg.remat_policy``
(``models.layers.remat``).  Gradients come from torch autograd.  The step
runs on the parameters' device and syncs nothing with the host: ``metrics``
holds ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors.  Unlike the
reference's pure function, the step updates the state's tensors in place
(the reference's production step donates its state to ``jit``): at full
width a second copy of the parameters and moments would not fit beside the
first.

The mesh-sharded step (the reference's ``state_shardings``,
``init_train_state_sharded``, ``jit_train_step`` and the int8 cross-pod
gradient compression) waits for the LM mesh (ROADMAP A15): a mesh raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..models import api
from ..models.transformer import lm_loss
from .optimizer import AdamWConfig, _tree_map, adamw_init, adamw_update

__all__ = ["TrainOptions", "make_train_step", "init_train_state"]


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    num_microbatches: int = 1
    aux_loss_weight: float = 0.01
    grad_compression: str = "none"   # none | int8
    optimizer: AdamWConfig = AdamWConfig()


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh is not ported yet (ROADMAP A15, the LM "
            "mesh: sharded parameters and optimizer state, the cross-pod "
            "gradient compression); pass mesh=None to train on one device")


def init_train_state(cfg: ModelConfig, seed: int = 0, *, device=None,
                     opts: TrainOptions = TrainOptions()) -> dict:
    """``{"params", "opt"}``: ``api.init``'s random parameters from ``seed``
    on ``device`` (default: the card) and zero AdamW moments.  ``opts``
    adds no state on one device (the int8 compression's error state
    belongs to a mesh's "pod" axis)."""
    params = api.init(cfg, seed, device=device)
    return {"params": params, "opt": adamw_init(params)}


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
    is updated in place and returned."""
    _refuse_mesh(mesh)

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
