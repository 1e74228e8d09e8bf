"""RMSNorm wrapper: the hand-written CUDA kernel (``csrc/rmsnorm.cu``)
for a CUDA tensor, the plain version (``ref.py``) for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16; w: (d,) of x's type or float32.
    Returns x's shape and type."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} vs x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: expects contiguous x and w")
    xdt = _lib.dtype_code(x, "rmsnorm x")
    wdt = _lib.dtype_code(w, "rmsnorm w")
    if wdt != xdt and w.dtype != torch.float32:
        raise TypeError(f"rmsnorm: w {w.dtype} with x {x.dtype}")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = int(d % (16 // x.element_size()) == 0
              and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = _lib.load()
    _lib.check(lib.rt_rmsnorm(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              rows, d, float(eps), xdt, wdt, vec,
                              _lib.stream_handle(x.device)), "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
