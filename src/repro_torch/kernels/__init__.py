"""The port's kernels and the two ways the model can call them.

``KERNELS`` holds the wrappers the model uses by default: each launches
its hand-written CUDA kernel for CUDA tensors and takes its plain
PyTorch version only for CPU tensors.  ``PLAIN`` holds the plain
versions themselves; ``chip_smoke.py`` runs one model step through it on
the card to hold the kernel path against it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.kernels.flash_attention import ops as _flash
from repro_torch.kernels.flash_attention import ref as _flash_ref
from repro_torch.kernels.paged_attention import ops as _paged
from repro_torch.kernels.paged_attention import ref as _paged_ref
from repro_torch.kernels.rmsnorm import ops as _rms
from repro_torch.kernels.rmsnorm import ref as _rms_ref


@dataclasses.dataclass(frozen=True)
class KernelSet:
    rmsnorm: Callable          # (x, w, eps) -> x's type
    attention: Callable        # (q, k, v, *, causal) model layout
    paged_decode: Callable     # (q, k_pool, v_pool, tables, lengths)
    paged_verify: Callable     # (q (B,T,H,D), k_pool, v_pool, tables,
                               #  lengths)
    paged_decode_int8: Callable  # (q, k_pool, v_pool, k_scale, v_scale,
                                 #  tables, lengths), int8 pools
    paged_verify_int8: Callable  # as paged_decode_int8, q (B,T,H,D)


def _plain_attention(q, k, v, *, causal=True, kv_len=None):
    return _flash_ref.blockwise_attention(q, k, v, causal=causal,
                                          kv_len=kv_len).to(q.dtype)


KERNELS = KernelSet(rmsnorm=_rms.rmsnorm, attention=_flash.mha,
                    paged_decode=_paged.paged_decode,
                    paged_verify=_paged.paged_verify,
                    paged_decode_int8=_paged.paged_decode_int8,
                    paged_verify_int8=_paged.paged_verify_int8)
PLAIN = KernelSet(rmsnorm=_rms_ref.rmsnorm_ref, attention=_plain_attention,
                  paged_decode=_paged_ref.paged_decode_ref,
                  paged_verify=_paged_ref.paged_verify_ref,
                  paged_decode_int8=_paged_ref.paged_decode_int8_ref,
                  paged_verify_int8=_paged_ref.paged_verify_int8_ref)

# kernel name (the TPU kernel's) -> its launching wrapper (each counts its
# own launches)
WRAPPERS = {"rmsnorm": _rms.rmsnorm, "flash_attention": _flash.mha,
            "paged_decode_attention": _paged.paged_decode,
            "paged_verify_attention": _paged.paged_verify,
            "paged_decode_attention_int8": _paged.paged_decode_int8,
            "paged_verify_attention_int8": _paged.paged_verify_int8}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
