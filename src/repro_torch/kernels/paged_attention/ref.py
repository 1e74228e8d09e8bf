"""Plain PyTorch paged attention: the math of the oracles the JAX model
runs on its paged branches (``models/attention.py``):
``paged_decode_attention`` over ``decode_attention`` for S == 1,
``paged_verify_attention`` over ``verify_attention`` for a T-token tail,
and their int8 twins, which dequantize the gathered pool first.

The oracles gather each sequence's blocks into logical order, cast q to
the (gathered) pool's type, score in float32, mask positions past each
query's own, normalise the softmax and feed ``(p / l).astype(v.dtype)`` to
a float32-accumulated PV product; the output stays float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q: (B,1,H,hd); k_cache/v_cache: (B,Smax,KV,hd); lengths: (B,)
    valid entries.  Returns (B,1,H,hd) float32."""
    B, _, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    G = H // KV
    qg = q.reshape(B, KV, G, hd).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                    device=q.device))
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd",
                     (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd)


def paged_decode_ref(q, k_pool, v_pool, block_tables, lengths
                     ) -> torch.Tensor:
    """q: (B,1,H,hd); k_pool/v_pool: (num_blocks, block_size, KV, hd);
    block_tables: (B, max_blocks) physical ids; lengths: (B,) valid
    tokens.  Returns (B,1,H,hd) float32."""
    B = q.shape[0]
    _, blk, KV, hd = k_pool.shape
    W = block_tables.shape[1]
    idx = block_tables.long()
    k_seq = k_pool[idx].reshape(B, W * blk, KV, hd)
    v_seq = v_pool[idx].reshape(B, W * blk, KV, hd)
    return decode_attention(q, k_seq, v_seq, lengths)


def verify_attention(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q: (B,T,H,hd), the T newest tokens, query t at position
    ``lengths - T + t``; k_cache/v_cache: (B,Smax,KV,hd); lengths: (B,)
    valid entries including all T.  Causal: query t sees positions
    ``<= lengths - T + t``.  Returns (B,T,H,hd) float32."""
    B, T, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd).to(k_cache.dtype)
    s = torch.einsum("btkgd,bmkd->bkgtm", qg.float(), k_cache.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                    device=q.device))
    qpos = (lengths.to(q.device).long()[:, None] - T
            + torch.arange(T, device=q.device)[None, :])          # (B,T)
    valid = (torch.arange(Smax, device=q.device)[None, None, :]
             <= qpos[:, :, None])                                 # (B,T,S)
    s = torch.where(valid[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgtm,bmkd->bkgtd",
                     (p / torch.clamp(l, min=1e-30)).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


def _gather(pool, block_tables):
    B, W = block_tables.shape
    _, blk, KV, hd = pool.shape
    return pool[block_tables.long()].reshape(B, W * blk, KV, hd)


def paged_verify_ref(q, k_pool, v_pool, block_tables, lengths
                     ) -> torch.Tensor:
    """q: (B,T,H,hd), query t of row b at ``lengths[b] - T + t``;
    pools (num_blocks, block_size, KV, hd); block_tables (B, max_blocks);
    lengths (B,) valid tokens including the T tail tokens.  Returns
    (B,T,H,hd) float32."""
    return verify_attention(q, _gather(k_pool, block_tables),
                            _gather(v_pool, block_tables), lengths)


def dequant_pool(pool, scale) -> torch.Tensor:
    """int8 pool (nb, blk, KV, hd) times its per-block-per-head scale
    (nb, KV), in float32."""
    return pool.float() * scale[:, None, :, None]


def paged_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                          block_tables, lengths) -> torch.Tensor:
    """:func:`paged_decode_ref` over an int8 pool with (num_blocks, KV)
    float32 scales: the whole pool is dequantized first, so q meets a
    float32 cache (q is cast to float32, not to int8)."""
    return paged_decode_ref(q, dequant_pool(k_pool, k_scale),
                            dequant_pool(v_pool, v_scale), block_tables,
                            lengths)


def paged_verify_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                          block_tables, lengths) -> torch.Tensor:
    """:func:`paged_verify_ref` over an int8 pool (dequantize, then the
    verify oracle)."""
    return paged_verify_ref(q, dequant_pool(k_pool, k_scale),
                            dequant_pool(v_pool, v_scale), block_tables,
                            lengths)
