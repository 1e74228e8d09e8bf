"""GQA attention: flash prefill and paged single-token decode.

Mirrors the prefill branch and the bf16 paged S == 1 branch of the
reference's ``models/attention.py attention_block``.  Where the reference
runs its jnp oracles (``blockwise_attention``, ``paged_decode_attention``)
the port calls the hand-written kernels through a ``KernelSet``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import KERNELS, KernelSet
from repro_torch.models.layers import rotate
from repro_torch.models.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class PagedStep:
    """One decode step over the paged pool, worked out once for all
    layers: the block tables, the lengths (including the new token), and
    where each row's new token is written.  Inert rows have length 1 and
    a null table row, so they write into the reserved null block 0, which
    is never read."""
    tables: torch.Tensor      # (B, max_blocks) int32
    lengths: torch.Tensor     # (B,) int32
    block: torch.Tensor       # (B,) physical block of the new token
    offset: torch.Tensor      # (B,) its slot inside that block

    @classmethod
    def make(cls, tables, lengths, block_size: int) -> "PagedStep":
        idx = (lengths - 1).long()
        block = tables.long().gather(1, (idx // block_size)[:, None])[:, 0]
        return cls(tables, lengths, block, idx % block_size)


def attn_specs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h * hd), "fan_in"),
        "wk": ParamSpec((d, kv * hd), "fan_in"),
        "wv": ParamSpec((d, kv * hd), "fan_in"),
        "wo": ParamSpec((h * hd, d), "fan_in"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((h * hd,), "zeros")
        s["bk"] = ParamSpec((kv * hd,), "zeros")
        s["bv"] = ParamSpec((kv * hd,), "zeros")
    return s


def project_qkv(cfg: ModelConfig, p, x, rope):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd), rotated by the
    ``layers.rope_tables`` ``rope`` (None: no rotary)."""
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, hd)
    k = k.reshape(B, S, kv, hd)
    v = v.reshape(B, S, kv, hd)
    q = rotate(q, rope)
    k = rotate(k, rope)
    return q, k, v


def attention_block(cfg: ModelConfig, p, x, rope, *, mode: str,
                    cache=None, paged: PagedStep = None,
                    kernels: KernelSet = KERNELS):
    """Attention sublayer.  Returns (out (B,S,d), new_cache or None).

    mode "prefill": causal flash attention over the fresh K/V (in the
    parameter type); returns the (B,S,KV,hd) K/V as the new cache.
    mode "decode" with ``paged``: ``cache`` is one layer of the paged
    pool, ``{"k", "v"}`` of (num_blocks, block_size, KV, hd); the new
    token's K/V is written into it in place (the reference returns an
    updated copy) and the query attends through the tables."""
    B, S, _ = x.shape
    dt = x.dtype
    q, k, v = project_qkv(cfg, p, x, rope)
    if mode == "prefill":
        o = kernels.attention(q, k, v, causal=True)
        new_cache = {"k": k.to(dt), "v": v.to(dt)}
    elif mode == "decode" and paged is not None and S == 1:
        for name, new in (("k", k), ("v", v)):
            pool = cache[name]
            pool[paged.block, paged.offset] = new[:, 0].to(pool.dtype)
        o = kernels.paged_decode(q, cache["k"], cache["v"], paged.tables,
                                 paged.lengths)
        new_cache = cache
    else:
        raise NotImplementedError(
            f"attention mode={mode!r} S={S} paged={paged is not None}"
            " is not ported yet")
    o2 = o.reshape(B, S, -1).to(dt)
    return o2 @ p["wo"], new_cache
