"""Plain PyTorch flash attention: the math of the oracle the JAX model
runs on its prefill branch (``models/attention.py blockwise_attention``).

The oracle keeps its operands in the model's type, accumulates both
products in float32, runs an online softmax over KV chunks of 1024 and
feeds ``p.astype(v.dtype)`` to the PV product; this mirror does the same.
(The Pallas kernel keeps p in float32, so in bf16 the two differ by the
rounding of p; in float32 they agree.)
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def blockwise_attention(q, k, v, *, causal: bool,
                        kv_len: Optional[int] = None,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd) with H % KV == 0.  Positions at
    or past ``kv_len`` are masked.  Returns (B,Sq,H,hd) float32."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    chunk = min(kv_chunk, Skv)
    if Skv % chunk:
        chunk = Skv          # a single chunk for ragged sizes, as the oracle
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                          device=q.device))
    qpos = torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Skv, chunk):
        kch = k[:, c0:c0 + chunk]
        vch = v[:, c0:c0 + chunk]
        kvpos = c0 + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kch.float()) * scale
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kvpos[None, :]
        if kv_len is not None:
            mask &= (kvpos < kv_len)[None, :]
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(v.dtype).float(), vch.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def attention_ref(q, k, v, *, causal: bool = True,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Kernel layout, as the JAX ``flash_attention/ref.py``: q (B,H,Sq,D),
    k/v (B,KV,Skv,D) -> (B,H,Sq,D) in q's type."""
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              kv_len=kv_len)
    return out.transpose(1, 2).to(q.dtype)

