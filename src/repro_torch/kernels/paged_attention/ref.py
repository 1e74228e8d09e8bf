"""Plain PyTorch paged decode: the math of the oracle the JAX model runs
on its S == 1 paged branch (``models/attention.py
paged_decode_attention`` over ``decode_attention``).

The oracle gathers each sequence's blocks into logical order, casts q to
the pool's type, scores in float32, masks positions at or past the
length, normalises the softmax and feeds ``(p / l).astype(v.dtype)`` to a
float32-accumulated PV product; the output stays float32.
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
