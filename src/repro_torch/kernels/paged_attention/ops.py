"""Paged-attention wrappers: the hand-written CUDA kernels
(``csrc/paged_attention.cu`` for bf16/f32 decode, ``csrc/paged_verify.cu``
for verify and for the int8 pool) for CUDA tensors, the plain versions
(``ref.py``) for CPU tensors.  Each wrapper counts its own launches."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.paged_attention.ref import (paged_decode_int8_ref,
                                                     paged_decode_ref,
                                                     paged_verify_int8_ref,
                                                     paged_verify_ref)


def _check(what: str, q, k_pool, v_pool, block_tables, lengths,
           scales=()) -> None:
    """The input checks every paged wrapper makes before a launch: one
    card, q (B,T,H,D) against pools (nb,blk,KV,D), int32 tables and
    lengths, contiguous pools/tables/lengths/scales."""
    B, T, H, D = q.shape
    tensors = (q, k_pool, v_pool, block_tables, lengths, *scales)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all tensors must be on one card")
    if T < 1 or k_pool.dim() != 4 or H % k_pool.shape[2] \
            or k_pool.shape != v_pool.shape or k_pool.shape[3] != D:
        raise ValueError(f"{what}: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"{what}: tables {tuple(block_tables.shape)},"
                         f" lengths {tuple(lengths.shape)} for B={B}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{what}: tables and lengths must be int32")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError(f"{what}: pools {k_pool.dtype}, {v_pool.dtype}")
    for s in scales:
        if s.dtype != torch.float32 or s.shape != k_pool.shape[::2]:
            raise TypeError(f"{what}: scales must be float32 "
                            f"{tuple(k_pool.shape[::2])}, got {s.dtype} "
                            f"{tuple(s.shape)}")
    names = ("k_pool", "v_pool", "block_tables", "lengths", "k_scale",
             "v_scale")
    for name, t in zip(names, tensors[1:]):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


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
    _check("paged_decode", q, k_pool, v_pool, block_tables, lengths)
    B, S, H, D = q.shape
    _, blk, KV, _ = k_pool.shape
    if S != 1:
        raise ValueError(f"paged_decode: q {tuple(q.shape)}")
    code = _lib.dtype_code(k_pool, "paged_decode")
    qk = q.reshape(B, H, D).to(k_pool.dtype).contiguous()
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


def paged_verify(q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,T,H,D), the T newest tokens of each sequence (their K/V
    already in the pool); query t of row b sits at ``lengths[b] - T + t``
    and attends causally.  Pools (num_blocks, block_size, KV, D) float32
    or bfloat16; q is cast to the pool's type, as the oracle does.
    Returns (B,T,H,D) float32.  T == 1 is :func:`paged_decode`'s math."""
    if q.device.type == "cpu":
        return paged_verify_ref(q, k_pool, v_pool, block_tables, lengths)
    _check("paged_verify", q, k_pool, v_pool, block_tables, lengths)
    B, T, H, D = q.shape
    _, blk, KV, _ = k_pool.shape
    code = _lib.dtype_code(k_pool, "paged_verify")
    qk = q.to(k_pool.dtype).contiguous()
    out = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    err = _lib.load().rt_paged_verify(
        qk.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, H, KV, D, blk, block_tables.shape[1], 1.0 / math.sqrt(D),
        code, _lib.stream_handle(q.device))
    _lib.check(err, "paged verify")
    paged_verify.launches += 1
    return out


def _int8(what: str, q, k_pool, v_pool, k_scale, v_scale, block_tables,
          lengths) -> torch.Tensor:
    """Launch the int8 kernel for q (B,T,H,D).  q keeps its own type
    (float32 or bfloat16; it is never cast to the pool's int8)."""
    _check(what, q, k_pool, v_pool, block_tables, lengths,
           (k_scale, v_scale))
    if k_pool.dtype != torch.int8:
        raise TypeError(f"{what}: pools must be int8, got {k_pool.dtype}")
    B, T, H, D = q.shape
    _, blk, KV, _ = k_pool.shape
    code = _lib.dtype_code(q, what)
    qc = q.contiguous()
    out = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    err = _lib.load().rt_paged_int8(
        qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, T, H, KV, D, blk,
        block_tables.shape[1], 1.0 / math.sqrt(D), code,
        _lib.stream_handle(q.device))
    _lib.check(err, what)
    return out


def paged_decode_int8(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """:func:`paged_decode` over an int8 pool: pools (num_blocks,
    block_size, KV, D) int8, k_scale/v_scale (num_blocks, KV) float32
    (``x ~ code * scale``), dequantized as each tile loads.  q: (B,1,H,D)
    float32 or bfloat16.  Returns (B,1,H,D) float32."""
    if q.device.type == "cpu":
        return paged_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lengths)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_int8: q {tuple(q.shape)}")
    out = _int8("paged_decode_int8", q, k_pool, v_pool, k_scale, v_scale,
                block_tables, lengths)
    paged_decode_int8.launches += 1
    return out


def paged_verify_int8(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """:func:`paged_verify` over an int8 pool (as
    :func:`paged_decode_int8`).  Returns (B,T,H,D) float32."""
    if q.device.type == "cpu":
        return paged_verify_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lengths)
    out = _int8("paged_verify_int8", q, k_pool, v_pool, k_scale, v_scale,
                block_tables, lengths)
    paged_verify_int8.launches += 1
    return out


paged_verify.launches = 0
paged_decode_int8.launches = 0
paged_verify_int8.launches = 0
