"""Paged-decode wrapper: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.paged_attention.ref import paged_decode_ref


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,1,H,D); pools: (num_blocks, block_size, KV, D) float32 or
    bfloat16; block_tables: (B, max_blocks) int32; lengths: (B,) int32
    valid tokens, each >= 1.  q is cast to the pool's type, as the
    oracle does.  Table entries at or past ``ceil(length / block_size)``
    are never read.  Returns (B,1,H,D) float32."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, block_tables, lengths)
    B, S, H, D = q.shape
    nb, blk, KV, _ = k_pool.shape
    tensors = (q, k_pool, v_pool, block_tables, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_decode: all tensors must be on one card")
    if S != 1 or H % KV or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != D:
        raise ValueError(f"paged_decode: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"paged_decode: tables {tuple(block_tables.shape)},"
                         f" lengths {tuple(lengths.shape)} for B={B}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode: tables and lengths must be int32")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError(f"paged_decode: pools {k_pool.dtype}, {v_pool.dtype}")
    code = _lib.dtype_code(k_pool, "paged_decode")
    qk = q.reshape(B, H, D).to(k_pool.dtype).contiguous()
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
    out = torch.empty((B, 1, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = _lib.load()
    err = lib.rt_paged_decode(
        qk.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KV, D, blk, block_tables.shape[1], 1.0 / math.sqrt(D), code,
        _lib.stream_handle(q.device))
    _lib.check(err, "paged decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
