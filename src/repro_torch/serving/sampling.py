"""Token sampling.  This slice ports the greedy path only: argmax over
the vocabulary, first index on ties (as ``jnp.argmax``).  Temperature
sampling is refused at ``InferenceEngine.submit``."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) -> (B,) int32 greedy tokens."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
