"""Decoder-only LM for uniform GQA stacks (the serving slice of the
reference's ``models/model.py``).

API, as in the reference:
  model_specs(cfg)                       -> ParamSpec tree
  init(cfg, seed, dtype, device)         -> params (same leaf paths)
  prefill(cfg, params, batch)            -> (logits_last, cache, aux)
  make_paged_pool(cfg, blocks, size)     -> {"stack": {"k", "v"}}
  make_quantized_paged_pool(cfg, blocks, size)
                              -> {"stack": {"k", "v", "k_scale", "v_scale"}}
  decode_step_paged(cfg, params, tokens, pool, tables, lengths)
                                         -> (logits, pool)
  verify_step_paged(cfg, params, tokens, pool, tables, lengths)
                                         -> (logits (B,T,V), pool)

Layer stacks keep the reference's stacked layout (leading ``layers``
axis under ``params["stack"]``); a Python loop over layers replaces
``lax.scan``.  Every function takes ``kernels`` (default: the
hand-written kernels; ``repro_torch.kernels.PLAIN`` runs the plain
versions instead).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNELS, KernelSet
from repro_torch.models.attention import PagedStep
from repro_torch.models.blocks import apply_layer, layer_specs
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       embedding_specs, norm_specs,
                                       rope_tables, unembed)
from repro_torch.models.param import init_params, stack_specs, tree_map


# --------------------------------------------------------------- plans
def stack_plan(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.is_encoder_decoder:
        return {"kind": "encdec"}
    if cfg.block_period > 1:
        return {"kind": "hybrid",
                "groups": cfg.num_layers // cfg.block_period}
    mixer = {"gqa": "gqa", "mla": "mla", "none": "mamba"}[cfg.attention]
    ffn = "none" if cfg.family == "ssm" else (
        "moe" if cfg.has_moe else "mlp")
    first = []
    n = cfg.num_layers
    if cfg.has_moe and cfg.first_k_dense:
        first = [(mixer, "mlp")] * cfg.first_k_dense
        n -= cfg.first_k_dense
    return {"kind": "uniform", "mixer": mixer, "ffn": ffn,
            "first": first, "n": n}


def check_supported(cfg: ModelConfig) -> None:
    """The port covers uniform GQA + gated-silu-MLP + RMSNorm stacks with
    rotary (or no) positions and text-only inputs so far."""
    plan = stack_plan(cfg)
    ok = (plan["kind"] == "uniform" and plan["mixer"] == "gqa"
          and plan["ffn"] == "mlp" and not plan["first"]
          and cfg.norm == "rmsnorm" and cfg.act == "silu"
          and cfg.pos_emb in ("rope", "none") and cfg.frontend == "none")
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: only uniform GQA/MLP/RMSNorm stacks are ported")


def model_specs(cfg: ModelConfig):
    check_supported(cfg)
    return {"embed": embedding_specs(cfg), "ln_f": norm_specs(cfg),
            "stack": stack_specs(layer_specs(cfg), cfg.num_layers)}


def init(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
         device=None):
    """Random weights drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``."""
    return init_params(model_specs(cfg), seed, dtype,
                       resolve_device(device))


# --------------------------------------------------------------- caches
def supports_paged_cache(cfg: ModelConfig) -> bool:
    """True iff decode can run over a paged block pool: pure-attention
    uniform stacks with text inputs (the reference's predicate)."""
    if cfg.is_encoder_decoder or cfg.frontend == "vision":
        return False
    plan = stack_plan(cfg)
    return plan["kind"] == "uniform" and plan["mixer"] in ("gqa", "mla")


def make_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype=torch.bfloat16, device=None):
    """Shared physical KV pool: each leaf is (layers, num_blocks,
    block_size, KV, hd), so one block id spans the whole stack."""
    if not supports_paged_cache(cfg):
        raise ValueError("architecture has no position-sliceable KV cache")
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"stack": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def make_quantized_paged_pool(cfg: ModelConfig, num_blocks: int,
                              block_size: int, device=None):
    """Int8 paged pool: :func:`make_paged_pool`'s layout with int8 block
    data, plus float32 per-block-per-KV-head scales riding in the same
    layer dict (``k_scale``/``v_scale`` of (layers, num_blocks, KV)), so
    the layer loop and the byte accounting treat them as pool leaves.
    Scales start at 0 (a block's first write sets them)."""
    pool = make_paged_pool(cfg, num_blocks, block_size, torch.int8, device)
    st = pool["stack"]
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads)
    for name in ("k", "v"):
        st[name + "_scale"] = torch.zeros(shape, dtype=torch.float32,
                                          device=st[name].device)
    return pool


def supports_speculative(cfg: ModelConfig) -> bool:
    """True iff the engine can run speculative decoding: rejected tokens
    are rolled back by length-masking per-position KV, which needs the
    same position-sliceable caches as the paged path."""
    return supports_paged_cache(cfg)


# --------------------------------------------------------------- forward
def _layer(stack, l: int):
    return tree_map(lambda t: t[l], stack)


def _backbone(cfg: ModelConfig, params, x, positions, *, mode: str,
              cache=None, paged=None, kernels: KernelSet = KERNELS):
    """Run all layers, then ln_f.  Returns (hidden, new_cache).  Prefill
    returns the stacked (L,B,S,KV,hd) K/V; paged decode and verify update
    the pool (bf16, or int8 with its scale leaves) in place and return
    it.  The rotary tables (and, in decode, the paged write positions)
    are worked out once for all layers."""
    rope = rope_tables(cfg, positions, cfg.head_dim)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        cl = None
        if cache is not None:
            cl = {n: t[l] for n, t in cache["stack"].items()}
        x, nc = apply_layer(cfg, _layer(params["stack"], l), x, rope,
                            mode=mode, cache=cl, paged=paged,
                            kernels=kernels)
        if mode == "prefill":
            ks.append(nc["k"])
            vs.append(nc["v"])
    x = apply_norm(cfg, params["ln_f"], x, kernels)
    if mode == "prefill":
        return x, {"stack": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return x, cache


def prefill(cfg: ModelConfig, params, batch, *,
            kernels: KernelSet = KERNELS):
    """Returns (next-token logits (B,V) f32, cache, aux).

    batch: tokens (B,S), prompt_lengths (B,).  Cache entries are sized to
    S.  aux is the reference's MoE loss slot, 0 for dense stacks."""
    tokens = batch["tokens"]
    lengths = batch["prompt_lengths"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = embed_tokens(cfg, params["embed"], tokens)
    x, cache = _backbone(cfg, params, x, pos, mode="prefill",
                         kernels=kernels)
    # next-token logits at the last valid position of each sequence
    idx = (lengths.long() - 1).clamp(0, S - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    logits = unembed(cfg, params["embed"], x_last).float()
    return logits, cache, 0.0


def decode_step_paged(cfg: ModelConfig, params, tokens, pool, block_tables,
                      lengths, *, kernels: KernelSet = KERNELS):
    """One decode step over a paged KV pool (see :func:`make_paged_pool`):
    :func:`verify_step_paged` with T = 1.

    tokens (B,1) int; block_tables (B, max_blocks) int32; lengths (B,)
    int32 valid tokens including this one.  The new token's KV is written
    into ``pool`` in place.  Returns (logits (B,V) f32, pool)."""
    logits, pool = verify_step_paged(cfg, params, tokens, pool, block_tables,
                                     lengths, kernels=kernels)
    return logits[:, 0], pool


def verify_step_paged(cfg: ModelConfig, params, tokens, pool, block_tables,
                      lengths, *, kernels: KernelSet = KERNELS):
    """Speculative verify over a paged pool: score a T-token tail in one
    forward.  tokens (B,T) int -- ``tokens[:, 0]`` the last emitted token
    (its KV not yet written), ``tokens[:, 1:]`` the drafts; lengths (B,)
    int32 valid tokens including all T, so token t sits at position
    ``lengths - T + t`` (a tail may straddle a block).  All T positions'
    KV are written into ``pool`` (bf16 or int8) in place; rejected
    positions are rolled back by the caller shrinking lengths.  T == 1
    runs the decode kernels.  Returns (logits (B,T,V) f32, pool):
    ``logits[:, t]`` is the target for the token after position t."""
    T = tokens.shape[1]
    pos = (lengths.long()[:, None] - T
           + torch.arange(T, device=tokens.device)[None, :])
    x = embed_tokens(cfg, params["embed"], tokens)
    paged = PagedStep.make(block_tables, lengths,
                           pool["stack"]["k"].shape[2], T)
    x, pool = _backbone(cfg, params, x, pos, mode="decode", cache=pool,
                        paged=paged, kernels=kernels)
    logits = unembed(cfg, params["embed"], x).float()
    return logits, pool
