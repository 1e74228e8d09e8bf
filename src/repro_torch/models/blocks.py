"""One residual layer: (norm -> GQA attention -> +res) -> (norm -> MLP ->
+res), the ``mixer="gqa"``, ``ffn="mlp"`` case of the reference's
``models/blocks.py apply_layer``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import KERNELS, KernelSet
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, mlp_specs, \
    norm_specs


def layer_specs(cfg: ModelConfig):
    return {"mixer": attn_mod.attn_specs(cfg), "ln1": norm_specs(cfg),
            "mlp": mlp_specs(cfg), "ln2": norm_specs(cfg)}


def apply_layer(cfg: ModelConfig, p, x, rope, *, mode: str, cache=None,
                paged=None, kernels: KernelSet = KERNELS):
    """Returns (x, new_cache).  ``rope``: the forward's rotary tables;
    ``paged``: the decode step's ``attention.PagedStep``."""
    h = apply_norm(cfg, p["ln1"], x, kernels)
    o, new_cache = attn_mod.attention_block(
        cfg, p["mixer"], h, rope, mode=mode, cache=cache, paged=paged,
        kernels=kernels)
    x = x + o
    h = apply_norm(cfg, p["ln2"], x, kernels)
    x = x + apply_mlp(cfg, p["mlp"], h)
    return x, new_cache
