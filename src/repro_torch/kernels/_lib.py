"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The library lands in
``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a hash
of the sources and flags, and is built at first use.  Nothing here runs
when the module is imported: the CPU tests import every module of the
port, and this host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
SIGNATURES = {
    "rt_rmsnorm": [_VP, _VP, _VP, _I, _I, _F, _I, _I, _I, _VP],
    "rt_flash_fwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                     _F, _I] + [_LL] * 12 + [_VP],
    "rt_paged_decode": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                        _I, _F, _I, _VP],
    "rt_paged_verify": [_VP] * 6 + [_I] * 7 + [_F, _I, _VP],
    "rt_paged_int8": [_VP] * 8 + [_I] * 7 + [_F, _I, _VP],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has not been built yet;
    returns its path.  Raises with nvcc's output if a source fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    logs = []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / f"{s.stem}.o") for s in sources]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    (tmp / "ptxas.log").write_text("\n".join(logs))
    try:
        os.replace(tmp, out_dir)
    except OSError:         # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptxas_log() -> str:
    path = BUILD_ROOT / source_hash() / "ptxas.log"
    return path.read_text() if path.exists() else ""


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)") from None

