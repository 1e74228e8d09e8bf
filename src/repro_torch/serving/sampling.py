"""Token sampling.  This port has the greedy path only: argmax over the
vocabulary, first index on ties (as ``jnp.argmax``), and the greedy
branch of the speculative accept cascade.  Temperature sampling is
refused at ``InferenceEngine.submit``."""
from __future__ import annotations

from typing import Tuple

import torch


def sample(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 greedy tokens."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def spec_accept_batched(logits: torch.Tensor, tokens: torch.Tensor,
                        n_draft: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy speculative accept over one verify launch (the greedy branch
    of the reference's ``spec_accept_batched``).

    logits (B,T,V): ``logits[:, t]`` is the target for the token after
    tail position t; tokens (B,T): ``tokens[:, 0]`` the last emitted
    token, ``tokens[:, 1:]`` the k = T-1 drafts; n_draft (B,) how many
    drafts are real per row.  Drafts are accepted left to right while
    each equals the target's argmax at its position; the first mismatch
    is replaced by that argmax, and when all drafts pass the argmax after
    the last one is a bonus token.  A row with ``n_draft == 0`` emits one
    plain argmax.  Returns (out (B,T) int32, n_emit (B,) int32): row b
    emits ``out[b, :n_emit[b]]``, ``n_emit = accepted + 1``."""
    B, T, _ = logits.shape
    k = T - 1
    gm = torch.argmax(logits, dim=-1).to(torch.int32)          # (B,T)
    drafts = tokens[:, 1:].to(torch.int32)
    tpos = torch.arange(k, device=logits.device)[None, :]
    acc = (drafts == gm[:, :k]) & (tpos < n_draft.to(logits.device)[:, None])
    m = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)   # (B,)
    tt = torch.arange(T, device=logits.device)[None, :]
    drafts_pad = torch.cat(
        [drafts, torch.zeros((B, 1), dtype=torch.int32,
                             device=logits.device)], dim=1)
    out = torch.where(tt < m[:, None], drafts_pad,
                      torch.where(tt == m[:, None], gm,
                                  torch.zeros_like(gm)))
    return out.to(torch.int32), (m + 1).to(torch.int32)
