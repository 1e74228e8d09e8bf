"""GQA attention: flash prefill and the paged decode/verify branches.

Mirrors the prefill branch and the paged branches (bf16 or int8 pool,
S == 1 decode or an S-token speculative-verify tail) of the reference's
``models/attention.py attention_block``.  Where the reference runs its
jnp oracles (``blockwise_attention``, ``paged_decode_attention``,
``paged_verify_attention`` and their int8 twins) the port calls the
hand-written kernels through a ``KernelSet``.  The int8 write path,
:func:`quantized_scatter_token`, is plain tensor code, as in the
reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import KERNELS, KernelSet
from repro_torch.models.layers import rotate
from repro_torch.models.param import ParamSpec


# 1 / 127 in float32: symmetric int8 scales are max|x| * INV_127, the
# product XLA compiles the reference's max|x| / 127.0 into
INV_127 = 1.0 / 127.0


@dataclasses.dataclass(frozen=True)
class PagedStep:
    """One decode or verify step over the paged pool, worked out once for
    all layers: the block tables, the lengths (including the T new
    tokens), and where each row's T new tokens are written (token t at
    position ``lengths - T + t``).  Inert rows have length 1 and a null
    table row; their tail positions before 0 are clamped to table column
    0, so all their writes land in the reserved null block 0, which is
    never read."""
    tables: torch.Tensor      # (B, max_blocks) int32
    lengths: torch.Tensor     # (B,) int32
    block: torch.Tensor       # (B, T) physical block of each new token
    offset: torch.Tensor      # (B, T) its slot inside that block

    @classmethod
    def make(cls, tables, lengths, block_size: int, T: int = 1
             ) -> "PagedStep":
        idx = (lengths.long()[:, None] - T
               + torch.arange(T, device=lengths.device)[None, :])
        col = torch.div(idx, block_size, rounding_mode="floor").clamp(min=0)
        block = tables.long().gather(1, col)
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


def quantized_scatter_token(pool, scales, x_t, pb, off) -> None:
    """Write one token's values into an int8 paged pool leaf, in place
    (the reference returns updated copies).

    pool: (num_blocks, blk, KV, hd) int8; scales: (num_blocks, KV)
    float32, one symmetric scale per (block, KV head); x_t: (B, KV, hd);
    pb/off: (B,) physical block and in-block slot.  The block scale is a
    running max: when the new token raises it, the block's resident codes
    are requantized as ``round(q_old * s_old / s_new)``; when it does not,
    the ratio is exactly 1.0 and resident codes are unchanged.  Rounding
    is half to even and codes are clipped to +-127, as the reference's;
    codes and scales come out bit-equal to it as the JAX model runs it
    (jitted: XLA turns its ``/ 127.0`` into a product with the float32
    reciprocal, :data:`INV_127`, and so does the port).  Duplicate ``pb``
    rows occur only for inert slots parked on the null block 0, never
    read."""
    blk = pool.shape[1]
    x = x_t.float()
    q_old = pool[pb].float()                          # (B, blk, KV, hd)
    s_old = scales[pb]                                # (B, KV)
    s_tok = x.abs().amax(dim=-1) * INV_127
    s_new = torch.maximum(s_old, s_tok)
    denom = torch.clamp(s_new, min=1e-12)
    ratio = torch.where(s_new > 0, s_old / denom, torch.zeros_like(s_new))
    q_res = torch.round(q_old * ratio[:, None, :, None])
    q_tok = torch.clamp(torch.round(x / denom[:, :, None]), -127, 127)
    sel = (torch.arange(blk, device=pool.device)[None, :]
           == off[:, None])[:, :, None, None]         # (B, blk, 1, 1)
    pool[pb] = torch.where(sel, q_tok[:, None], q_res).to(pool.dtype)
    scales[pb] = s_new


def attention_block(cfg: ModelConfig, p, x, rope, *, mode: str,
                    cache=None, paged: PagedStep = None,
                    kernels: KernelSet = KERNELS):
    """Attention sublayer.  Returns (out (B,S,d), new_cache or None).

    mode "prefill": causal flash attention over the fresh K/V (in the
    parameter type); returns the (B,S,KV,hd) K/V as the new cache.
    mode "decode" with ``paged``: ``cache`` is one layer of the paged
    pool, ``{"k", "v"}`` of (num_blocks, block_size, KV, hd), plus int8
    pools' ``{"k_scale", "v_scale"}`` of (num_blocks, KV).  The S new
    tokens' K/V are written into it in place (the reference returns an
    updated copy), one position at a time, and the S queries attend
    through the tables: S == 1 is a decode step, S > 1 a speculative
    verify of an S-token tail."""
    B, S, _ = x.shape
    dt = x.dtype
    q, k, v = project_qkv(cfg, p, x, rope)
    if mode == "prefill":
        o = kernels.attention(q, k, v, causal=True)
        new_cache = {"k": k.to(dt), "v": v.to(dt)}
    elif mode == "decode" and paged is not None and "k_scale" in cache:
        # int8 pool: quantized at write time, running-max block scales;
        # the kernels dequantize as each tile loads
        for t in range(S):
            pb, off = paged.block[:, t], paged.offset[:, t]
            quantized_scatter_token(cache["k"], cache["k_scale"], k[:, t],
                                    pb, off)
            quantized_scatter_token(cache["v"], cache["v_scale"], v[:, t],
                                    pb, off)
        attend = kernels.paged_decode_int8 if S == 1 \
            else kernels.paged_verify_int8
        o = attend(q, cache["k"], cache["v"], cache["k_scale"],
                   cache["v_scale"], paged.tables, paged.lengths)
        new_cache = cache
    elif mode == "decode" and paged is not None:
        # a verify tail may straddle a block boundary: each position has
        # its own (block, offset)
        for name, new in (("k", k), ("v", v)):
            pool = cache[name]
            for t in range(S):
                pool[paged.block[:, t], paged.offset[:, t]] = \
                    new[:, t].to(pool.dtype)
        attend = kernels.paged_decode if S == 1 else kernels.paged_verify
        o = attend(q, cache["k"], cache["v"], paged.tables, paged.lengths)
        new_cache = cache
    else:
        raise NotImplementedError(
            f"attention mode={mode!r} paged={paged is not None}"
            " is not ported yet")
    o2 = o.reshape(B, S, -1).to(dt)
    return o2 @ p["wo"], new_cache
