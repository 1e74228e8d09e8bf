"""Draft-token sources for speculative decoding (the n-gram part of the
reference's ``serving/speculative.py``).

The engine drafts up to ``spec_k`` candidate continuations per running
sequence, scores them all in one multi-token verify forward
(``M.verify_step_paged``) and keeps the longest accepted prefix
(``sampling.spec_accept_batched``).  :class:`NGramDrafter` is
prompt-lookup decoding: candidates are read out of the request's own
prompt and generated tokens (the longest suffix n-gram that occurred
earlier predicts the tokens that followed it).  No extra model, no extra
launches.

A drafter proposes per slot; its state must be dropped when the slot
turns over (finish or preemption) via :meth:`Drafter.release`.

Drafts are suggestions only: greedy acceptance keeps the emitted tokens
identical to the non-speculative engine, so a bad drafter costs speed,
never tokens.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class Drafter:
    """Interface: ``propose`` returns up to ``k`` draft tokens for one
    slot plus the (n, vocab_padded) distribution each was sampled from,
    or ``None`` when ``deterministic`` is set (the accept step then
    treats each draft as one-hot)."""

    name = "none"
    deterministic = False

    def propose(self, slot: int, context: Sequence[int], k: int,
                temperature: float) -> Tuple[List[int],
                                             Optional[np.ndarray]]:
        raise NotImplementedError

    def release(self, slot: int) -> None:
        """Forget per-slot state (slot finished or preempted)."""


class NGramDrafter(Drafter):
    """Prompt-lookup drafter (deterministic, model-free).

    Finds the longest suffix n-gram (``min_n <= n <= max_n``) of the
    context that also occurs earlier in the context, preferring the most
    recent earlier occurrence, and proposes the tokens that followed it.
    Stateless, so preemption and slot turnover need no bookkeeping."""

    name = "ngram"
    deterministic = True

    def __init__(self, vocab_padded: int, max_n: int = 3, min_n: int = 1):
        self.vocab = vocab_padded
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, slot, context, k, temperature):
        ctx = list(context)
        drafts: List[int] = []
        for n in range(min(self.max_n, len(ctx) - 1), self.min_n - 1, -1):
            pat = tuple(ctx[-n:])
            for i in range(len(ctx) - n - 1, -1, -1):
                if tuple(ctx[i:i + n]) == pat:
                    drafts = ctx[i + n:i + n + k]
                    break
            if drafts:
                break
        return drafts, None


def make_drafter(kind: Optional[str], cfg, *, spec_k: int, capacity: int,
                 draft_cfg=None, draft_params=None) -> Optional[Drafter]:
    """Engine-facing factory.  ``kind``: None | "ngram" | "draft"."""
    if not kind:
        return None
    if kind == "ngram":
        return NGramDrafter(cfg.vocab_padded)
    if kind == "draft":
        raise NotImplementedError(
            "speculative='draft' is not ported yet: the draft-model "
            "drafter needs the dense per-slot cache and the decode_attention "
            "kernel (ROADMAP item B7)")
    raise ValueError(f"unknown speculative drafter {kind!r} "
                     "(expected 'ngram' or 'draft')")
