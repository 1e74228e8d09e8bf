"""Shared layers: norms, rotary embeddings, gated MLP, embeddings.

Each mirrors the function of the same name in the reference's
``models/layers.py``; the rmsnorm goes through the hand-written kernel
(``kernels.rmsnorm``) where the reference runs its jnp oracle.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import KERNELS, KernelSet
from repro_torch.models.param import ParamSpec


# ----------------------------------------------------------------- norms
def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    return {"scale": ParamSpec((d or cfg.d_model,), "ones")}


def apply_norm(cfg: ModelConfig, p, x, kernels: KernelSet = KERNELS):
    """RMSNorm with f32 accumulation, cast back to x's type."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return kernels.rmsnorm(x, p["scale"], cfg.norm_eps)


# ----------------------------------------------------------------- rope
def rope_frequencies(cfg: ModelConfig, head_dim: int,
                     device=None) -> torch.Tensor:
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)          # (rot/2,)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor, head_dim: int):
    """f32 (cos, sin), each (..., seq, 1, rot/2), for ``positions`` (...,
    seq); None when no dims rotate.  A forward pass makes them once and
    every layer's q and k reuse them."""
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    if rot == 0 or cfg.pos_emb != "rope":
        return None
    inv = rope_frequencies(cfg, head_dim, positions.device)
    ang = positions[..., :, None].to(torch.float32) * inv   # (..., S, rot/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Apply :func:`rope_tables` to x (..., seq, heads, head_dim): rotates
    the two halves of the first ``rot`` dims (not interleaved pairs)."""
    if tables is None:
        return x
    cos, sin = tables
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype), xp], -1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               head_dim: Optional[int] = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    return rotate(x, rope_tables(cfg, positions, head_dim or x.shape[-1]))


# ----------------------------------------------------------------- mlp
def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "gate": ParamSpec((d, ff), "fan_in"),
        "up": ParamSpec((d, ff), "fan_in"),
        "down": ParamSpec((ff, d), "fan_in"),
    }


def apply_mlp(cfg: ModelConfig, p, x):
    """Gated MLP, x: (..., d_model).  silu only: the reference's gelu is
    the tanh approximation, which this slice does not need."""
    if cfg.act != "silu" or "gate" not in p:
        raise NotImplementedError(f"act {cfg.act!r} is not ported yet")
    h = F.silu(x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]


# ----------------------------------------------------------------- embed
def embedding_specs(cfg: ModelConfig):
    s = {"embed": ParamSpec((cfg.vocab_padded, cfg.d_model), "normal", 0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_padded), "fan_in")
    return s


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    """Token lookup; out-of-range ids are clamped, as the reference's
    ``mode="clip"`` gather does."""
    table = p["embed"]
    idx = tokens.long().clamp(0, table.shape[0] - 1)
    return table[idx]


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = x @ w
    if cfg.vocab_padded != cfg.vocab_size:
        # pad-vocab logits are masked so sampling never selects them
        logits[..., cfg.vocab_size:] = -1e30
    return logits
