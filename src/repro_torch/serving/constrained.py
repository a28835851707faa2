"""Grammar-constrained decoding backed by the paper's DFA machinery.

The port of the JAX package's ``serving/constrained.py``.  A regex/grammar
is compiled to a DFA over bytes; during decoding each sequence carries its
DFA state, the per-state allowed-token mask is applied to the logits (the
fused kernel B5, ``kernels.ops.token_mask``, on the card), and states
advance with the chosen tokens.

Draft verification (speculative decoding's accept step) is the paper's
algorithm verbatim: K draft tokens form a chunk matched from the sequence's
current state, with the per-position state trajectory recovered.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import DFA, Matcher
from ..kernels import ops as kops
from ..kernels.ref import token_mask_ref

__all__ = ["GrammarConstraint", "DecodeStream"]


class DecodeStream:
    """Incremental grammar state over streaming cursors (one per sequence).

    Holds one resumable ``StreamSession`` per batch row: each
    ``feed_tokens`` call scans *only the new tokens*, and the B per-row
    segments coalesce into one micro-batched tick (the stream's matcher
    tiles its batch to cover all B rows).  Special (non-byte) tokens are
    identity moves, exactly as in ``advance_tokens``, so the states are
    bit-identical to a one-shot prefill of the concatenation.

    The stream rides ``StreamMatcher``'s default ``num_chunks=1``: the seq
    lowering, a per-symbol torch loop on the constraint's device (no
    kernel), as the JAX package's ``lax.scan``.  The per-token decode loop
    keeps using ``GrammarConstraint.advance``.
    """

    def __init__(self, constraint: "GrammarConstraint", batch: int):
        from ..core.engine.plan import next_pow2
        from ..streaming import StreamMatcher, TickPolicy

        self.constraint = constraint
        # ticks only on explicit flush: feed_tokens admits all B rows first,
        # then dispatches them as one coalesced round
        self.stream = StreamMatcher(
            constraint.matcher.packed,
            batch_tile=next_pow2(batch),
            policy=TickPolicy(max_batch=1 << 30, max_delay=1 << 30),
            device=constraint.device)
        self.sessions = [self.stream.open() for _ in range(batch)]

    @property
    def batch(self) -> int:
        return len(self.sessions)

    @property
    def states(self) -> torch.Tensor:
        """[B] current DFA states on the constraint's device (grammar DFAs
        are packed alone, so packed state ids are plain state ids)."""
        st = np.stack([s.cursor.states[0] for s in self.sessions])
        return torch.from_numpy(st.astype(np.int32)).to(
            self.constraint.device)

    def feed_tokens(self, tokens) -> torch.Tensor:
        """Advance every row by its new tokens [B, T]; returns the states.

        Byte-valued tokens (< 256) feed the row's cursor; special tokens are
        identity moves and are simply skipped (same semantics as the pad
        class in ``advance_tokens``).
        """
        toks = (tokens.cpu().numpy() if isinstance(tokens, torch.Tensor)
                else np.asarray(tokens))
        if toks.ndim != 2 or toks.shape[0] != self.batch:
            raise ValueError(f"expected [{self.batch}, T] tokens, "
                             f"got {toks.shape}")
        for row, sess in zip(toks, self.sessions):
            data = row[(row >= 0) & (row < 256)].astype(np.uint8).tobytes()
            if data:
                sess.feed(data)
        self.stream.flush()  # one coalesced tick for all B rows
        return self.states


class GrammarConstraint:
    """Per-state token masks + batched state advance for byte-level vocabs.

    State advance rides the matching runtime facade (``core.engine.Matcher``
    with ``num_chunks=1``): special (non-byte) tokens map to the padded
    table's identity column, so no masking branch exists, and every advance
    is bit-identical to stepping the raw DFA token by token.  Shapes:
    ``states`` are [B] int32 DFA state ids, token blocks are [B, T], logits
    [B, V].  ``allowed`` [Q, V] uint8, ``tok_cls`` [V] int32 and the padded
    transition table live on ``device`` (default: the card).
    """

    def __init__(self, dfa: DFA, vocab_size: int, *, use_kernel: bool = True,
                 allow_specials: tuple[int, ...] = (), eos_id: int = 258,
                 device=None):
        self.dfa = dfa
        self.vocab_size = vocab_size
        self.use_kernel = use_kernel
        self._allow_specials = tuple(allow_specials)
        self._eos_id = eos_id
        # the matching runtime facade: its padded transition table has an
        # identity column at matcher.pad_cls, so state advance runs through
        # the same engine layers as corpus scanning
        self.matcher = Matcher(dfa, num_chunks=1, batch_tile=1, device=device)
        self.device = self.matcher.device
        self._build_tables()

    def _build_tables(self) -> None:
        """(Re)build the token mask + token->class tables for ``self.dfa``."""
        dfa, vocab_size = self.dfa, self.vocab_size
        q = dfa.n_states
        allowed = np.zeros((q, vocab_size), np.uint8)
        byte_cls = dfa.byte_to_class
        nxt = dfa.table  # [Q, n_cls]
        for v in range(min(vocab_size, 256)):
            cls = int(byte_cls[v])
            tgt = nxt[:, cls]
            ok = (tgt != dfa.sink) if dfa.sink >= 0 else np.ones(q, bool)
            allowed[:, v] = ok
        for v in self._allow_specials:
            if v < vocab_size:
                allowed[:, v] = 1
        # termination semantics: accepting states may emit EOS; states with no
        # legal continuation MUST emit EOS (grammar exhausted)
        if self._eos_id is not None and self._eos_id < vocab_size:
            allowed[dfa.accepting, self._eos_id] = 1
            dead = allowed.sum(axis=1) == 0
            allowed[dead, self._eos_id] = 1
        self.allowed = torch.from_numpy(allowed).to(self.device)
        packed_cls = self.matcher.packed.byte_to_class  # facade class ids
        # token -> class map for state advance; special (non-byte) tokens map
        # to the identity pad class, so they advance no DFA with no masking
        tok_cls = np.full((vocab_size,), self.matcher.pad_cls, np.int32)
        nb = min(vocab_size, 256)
        tok_cls[:nb] = packed_cls[:nb]
        self.tok_cls = torch.from_numpy(tok_cls).to(self.device)
        self.table = self.matcher.dev.table_pad_t

    def swap_grammar(self, dfa: DFA) -> bool:
        """Swap the constraint grammar in place (a new response schema
        between requests) without rebuilding the engine stack.

        Rides ``Matcher.swap_patterns``: a signature-equal grammar is a
        no-op (returns False, every lowering kept); otherwise the facade
        retables under a bumped plan ``table_epoch`` and the token mask /
        token->class tables rebuild for the new DFA on the constraint's
        device.  Sequences decoded under the old grammar hold stale states
        — restart them with ``init_states`` / a fresh ``open_decode``.
        """
        if not self.matcher.swap_patterns(dfa):
            return False
        self.dfa = dfa
        self._build_tables()
        return True

    def init_states(self, batch: int) -> torch.Tensor:
        return torch.full((batch,), self.dfa.start, dtype=torch.int32,
                          device=self.device)

    def open_decode(self, batch: int) -> DecodeStream:
        """Open resumable per-sequence cursors for incremental prefill
        (see ``DecodeStream``); used by ``ServingEngine.generate`` so prompt
        chunks never re-prefill from the start states."""
        return DecodeStream(self, batch)

    def mask_logits(self, states: torch.Tensor,
                    logits: torch.Tensor) -> torch.Tensor:
        """[B] states x [B, V] logits -> masked logits (B5 when
        ``use_kernel``, else the two-call gather and select)."""
        v = logits.shape[-1]
        allowed = self.allowed
        if v > allowed.shape[1]:  # padded model vocab: pad table (disallowed)
            allowed = torch.nn.functional.pad(allowed,
                                              (0, v - allowed.shape[1]))
        if self.use_kernel:
            return kops.token_mask(states, allowed, logits.contiguous())
        return token_mask_ref(states, allowed, logits)

    def advance(self, states: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        """Advance each sequence's DFA state by its chosen token [B].

        Special tokens map to the pad class, whose padded-table column is the
        identity — no branch needed.
        """
        return self.table[states.long(), self.tok_cls[tokens.long()].long()]

    def advance_tokens(self, states, tokens) -> torch.Tensor:
        """Advance [B] states through [B, T] tokens: a column-wise replay of
        ``advance`` through ``Matcher.advance_classes`` (the batched prompt
        prefill path)."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32).to(self.device)
        if tokens.dim() != 2:
            raise ValueError("advance_tokens expects [B, T] tokens")
        return self.matcher.advance_classes(states,
                                            self.tok_cls[tokens.long()])

    def verify_draft(self, state: int,
                     draft_bytes: np.ndarray) -> tuple[int, np.ndarray]:
        """Speculative-decoding accept test for one sequence's K draft bytes.

        Returns (n_accepted, state_trajectory[K]); a draft byte is accepted
        while the DFA stays out of the sink.
        """
        classes = self.dfa.classes_of(draft_bytes.astype(np.uint8))
        states = np.zeros(len(classes), np.int32)
        s = state
        for i, c in enumerate(classes):
            s = int(self.dfa.table[s, int(c)])
            states[i] = s
        if self.dfa.sink >= 0:
            bad = states == self.dfa.sink
            n_ok = int(np.argmax(bad)) if bad.any() else len(states)
        else:
            n_ok = len(states)
        return n_ok, states
