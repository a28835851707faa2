"""Batched serving engine: prefill + decode with optional grammar constraint.

The port of the JAX package's ``serving/engine.py``.  Requests are padded
into a fixed decode batch, the prompt is ingested in one prefill call, then
tokens stream out of eager ``decode_step`` calls (a CUDA graph of the step
is later work).  Constrained requests carry DFA states advanced by
``GrammarConstraint``; their logits are masked by the fused kernel B5 on
the card.  Greedy (``argmax``) and temperature sampling are supported; the
temperature path draws from a ``torch.Generator`` seeded with ``seed``, a
different stream from the JAX package's ``jax.random``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import transformer as TF
from .constrained import GrammarConstraint

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 -> greedy
    eos_id: int = 258


class ServingEngine:
    """Decode-batch server for the dense transformer family.

    ``params`` live on the device the engine serves from; prompts are moved
    there.  ``constraint`` (if any) must hold its tables on the same device.
    """

    def __init__(self, cfg: ModelConfig, params,
                 serve: ServeConfig = ServeConfig(),
                 constraint: Optional[GrammarConstraint] = None):
        if cfg.family != "dense":
            raise NotImplementedError(f"serving the {cfg.family!r} family is "
                                      "not ported yet (ROADMAP A15)")
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.constraint = constraint
        self.device = params["embed"]["table"].device
        if constraint is not None and constraint.allowed.device != self.device:
            raise ValueError(f"constraint tables on "
                             f"{constraint.allowed.device}, model on "
                             f"{self.device}")

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        logits = logits[:, -1].float()  # [B, V]
        v = logits.shape[-1]
        # never sample padding ids beyond the real vocab
        if v > self.cfg.vocab_size:
            pad = torch.arange(v, device=logits.device) >= self.cfg.vocab_size
            logits = logits.masked_fill(pad[None, :], -1e30)
        if self.serve.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.serve.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    def generate(self, prompts, *, seed: int = 0,
                 decode_stream=None) -> np.ndarray:
        """prompts [B, T_prompt] int32 -> generated tokens [B, max_new].

        Grammar prefill rides resumable cursors
        (``GrammarConstraint.open_decode``): the prompt is fed once and
        never re-scanned.  Pass ``decode_stream`` (a ``DecodeStream``
        already fed with the prompt, e.g. in chunks from a streaming
        endpoint) to skip the prompt prefill.  The per-token loop advances
        states with the single-gather ``constraint.advance``, on the device.
        """
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(
            self.device)
        b, t_prompt = toks.shape
        max_len = t_prompt + self.serve.max_new_tokens
        cache = TF.init_cache(self.cfg, b, max_len, device=self.device)
        # the cache is longer than the prompt, so this prefill takes the
        # blockwise attention path, as the JAX engine's does
        logits, cache, _ = TF.forward(self.params, self.cfg, toks,
                                      cache=cache, last_only=True)
        gen = None
        if self.serve.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        states = None
        stream = decode_stream
        if self.constraint is not None:
            if stream is None:
                stream = self.constraint.open_decode(b)
                states = stream.feed_tokens(toks)
            else:
                if stream.batch != b:
                    raise ValueError(f"decode_stream holds {stream.batch} "
                                     f"sessions for a batch of {b}")
                states = stream.states  # prompt already fed incrementally
        elif decode_stream is not None:
            raise ValueError("decode_stream requires a grammar constraint")

        out = np.full((b, self.serve.max_new_tokens), self.serve.eos_id,
                      np.int32)
        last = logits[:, -1:]
        finished = np.zeros(b, bool)
        for i in range(self.serve.max_new_tokens):
            step_logits = last
            if states is not None:
                step_logits = self.constraint.mask_logits(
                    states, step_logits[:, -1]).reshape(step_logits.shape)
            tok = self._sample(step_logits, gen)             # [B]
            tok_h = tok.cpu().numpy()
            out[:, i] = np.where(finished, self.serve.eos_id, tok_h)
            finished |= tok_h == self.serve.eos_id
            if finished.all():
                break
            if states is not None:
                states = self.constraint.advance(states, tok)
            last, cache = TF.decode_step(self.params, self.cfg, cache,
                                         tok[:, None], t_prompt + i)
        return out
