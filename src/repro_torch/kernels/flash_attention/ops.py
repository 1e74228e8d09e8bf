"""Flash-attention wrapper: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import blockwise_attention

HEAD_DIMS = (16, 32, 64, 128)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, kv_len: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B,Sq,H,D), k/v (B,Skv,KV,D) -> (B,Sq,H,D) in q's
    type.  Key positions at or past ``kv_len`` are masked.  The kernel
    reads any (batch, seq, head) strides; the last dim must be
    contiguous."""
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal,
                                   kv_len=kv_len).to(q.dtype)
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    if q.device.type != "cuda" or {k.device, v.device} != {q.device}:
        raise ValueError(f"mha: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"mha: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KV:
        raise ValueError(f"mha: {H} heads over {KV} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"mha: head dim {D} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mha: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    code = _lib.dtype_code(q, "mha")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"mha: {name} needs a contiguous last dim")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B * Sq * H == 0:
        return o
    kv_len = Skv if kv_len is None else int(kv_len)
    lib = _lib.load()
    err = lib.rt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, KV, Sq, Skv, D, kv_len, int(causal), 1.0 / math.sqrt(D), code,
        q.stride(0), q.stride(2), q.stride(1),
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        o.stride(0), o.stride(2), o.stride(1),
        _lib.stream_handle(q.device))
    _lib.check(err, "flash attention")
    mha.launches += 1
    return o


mha.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Kernel layout of the JAX ``flash_attention``: q (B,H,Sq,D), k/v
    (B,KV,Skv,D) -> (B,H,Sq,D).  The same kernel as :func:`mha`, reading
    the transposed strides."""
    return mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=causal, kv_len=kv_len).transpose(1, 2)
