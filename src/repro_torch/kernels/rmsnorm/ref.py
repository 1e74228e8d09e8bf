"""Plain PyTorch RMSNorm, the counterpart of the JAX ``rmsnorm/ref.py``
(and of the rmsnorm branch of ``models/layers.py apply_norm``)."""
import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); w: (d,).  f32 accumulation, cast back to x's type."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
