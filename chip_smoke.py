#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   -- name and power limit (nvidia-smi); fails without a card.
2. build    -- compiles csrc/*.cu for sm_90a (one nvcc per source).
3. kernels  -- each hand-written kernel (RMSNorm, flash prefill, paged
               decode, paged verify, int8 paged decode, int8 paged
               verify) against its plain PyTorch version on the card, at
               the main paths' shapes and at edge shapes, with the
               tolerance stated; then the device time (profiler) and wall
               time (CUDA events) of the kernel, the plain version and,
               where one exists, a one-call PyTorch yardstick.
4. tiny     -- the scaled-down model served on the card and on the CPU
               (plain versions) from the same f32 weights: greedy tokens
               must agree, speculative tokens must equal plain tokens on
               both, and int8-KV tokens must match at >= 0.90.
5. serve    -- full-width qwen1.5-4b in bf16 (random weights from
               torch.Generator("cuda").manual_seed(0)): the first prefill,
               decode and verify steps (bf16 and int8 pools) against the
               same steps through the plain versions, an int8-pool decode
               step against the bf16-pool step, then 8 greedy requests
               (a prefix hit, a streamed 600-token prompt and a prompt
               that repeats a span of its own among them) through
               InferenceEngine four times: plain bf16 KV, n-gram
               speculation (spec_k 4) on bf16 KV, int8 KV, and both.
               Each run's kernel launch counts are held to the number of
               model calls, with the counts set to 0 just before it.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that last line.  Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels as K                           # noqa: E402
from repro_torch.configs import get_config, scaled_down        # noqa: E402
from repro_torch.kernels import _lib                           # noqa: E402
from repro_torch.kernels.flash_attention.ops import mha        # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    blockwise_attention                                        # noqa: E402
from repro_torch.kernels.paged_attention.ops import (      # noqa: E402
    paged_decode, paged_decode_int8, paged_verify, paged_verify_int8)
from repro_torch.kernels.paged_attention.ref import (      # noqa: E402
    paged_decode_int8_ref, paged_decode_ref, paged_verify_int8_ref,
    paged_verify_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm            # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref        # noqa: E402
from repro_torch.models import model as M                      # noqa: E402
from repro_torch.models.param import tree_items, tree_map      # noqa: E402
from repro_torch.serving.engine import InferenceEngine, Request  # noqa: E402
from repro_torch.serving.kvcache import PagedCacheSlots        # noqa: E402
from repro_torch.serving.scheduler import _bucket               # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

# the TPU kernels the port's kernels replace (def lines)
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:18",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:72",
    "paged_decode_attention":
        "src/repro/kernels/paged_attention/kernel.py:307",
    "paged_verify_attention":
        "src/repro/kernels/paged_attention/kernel.py:256",
    "paged_decode_attention_int8":
        "src/repro/kernels/paged_attention/kernel.py:356",
    "paged_verify_attention_int8":
        "src/repro/kernels/paged_attention/kernel.py:413",
}
SOURCES = {
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_verify_attention": "src/repro_torch/csrc/paged_verify.cu",
    "paged_decode_attention_int8": "src/repro_torch/csrc/paged_verify.cu",
    "paged_verify_attention_int8": "src/repro_torch/csrc/paged_verify.cu",
}
# the serve run whose launch counts each kernel reports (its path)
PATH_OF = {"rmsnorm": "bf16", "flash_attention": "bf16",
           "paged_decode_attention": "bf16",
           "paged_verify_attention": "bf16_spec",
           "paged_decode_attention_int8": "int8",
           "paged_verify_attention_int8": "int8_spec"}

# serve phase: engine shape and traffic; speculation drafts SPEC_K tokens
MAX_BATCH, CAPACITY, BLOCK, MAX_NEW, SPEC_K = 8, 1024, 16, 32, 4


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple:
    """(device ms, wall ms) per call of ``fn``.  Device time is the sum of
    the kernels' own durations in a ``torch.profiler`` window, so a call
    whose host dispatch outlasts its kernels is not charged the gap; wall
    time is CUDA events around ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return busy_us / iters / 1e3, wall


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    """Elementwise |got - want| <= atol + rtol * |want|; returns the max
    absolute error and raises if any element is outside."""
    _sync(got.device)
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    bad = (g - w).abs() > atol + rtol * w.abs()
    err = max_err(g, w)
    if bool(bad.any()):
        raise AssertionError(f"{name}: max abs err {err} beyond "
                             f"atol {atol} + rtol {rtol}")
    return err


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    line = smi_line()
    # float32 products in full float32; bf16 reductions without reduced
    # precision, so kernel-vs-plain gaps are the kernels' own
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit("device", smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    _lib.load()
    secs = time.perf_counter() - t0
    log = _lib.ptxas_log().splitlines()
    regs = [ln.split(":", 1)[1].strip() for ln in log if "registers" in ln]
    spills = [ln.split(":", 1)[1].strip() for ln in log
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    emit("build", seconds=round(secs, 3), ptxas_used=regs,
         ptxas_spills=spills)


def _rand(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _paged_inputs(gen, B, H, KV, D, blk, W, lens, dtype, dev, layers=1,
                  T=1, qdtype=None):
    """Pools with ``layers`` stacked copies (timing rotates through them
    so each launch finds its KV cold in L2, as a decode step does), a
    permuted block table whose entries past ``ceil(len / blk)`` are the
    null block 0, lengths ``lens`` and q of (B, T, H, D).  ``dtype``
    int8 gives int8 codes and (layers, num_blocks, KV) float32 scales, as
    ``(q, k, v, k_scale, v_scale, tables, lengths)``; q is then in
    ``qdtype``."""
    if dtype == torch.int8:
        q, kp, vp, tb, ln = _paged_inputs(gen, B, H, KV, D, blk, W, lens,
                                          torch.float32, dev, layers, T)
        codes = [(t * 40).round().clamp(-127, 127).to(torch.int8)
                 for t in (kp, vp)]
        scales = [torch.rand(kp.shape[:2] + (KV,), generator=gen,
                             device=dev) * 0.02 + 1e-3 for _ in range(2)]
        return (q.to(qdtype), *codes, *scales, tb, ln)
    need = [-(-n // blk) for n in lens]
    nb = 1 + sum(need) + 7
    kp = _rand(gen, (layers, nb, blk, KV, D), dtype, dev)
    vp = _rand(gen, (layers, nb, blk, KV, D), dtype, dev)
    ids = iter((torch.randperm(nb - 1, generator=torch.Generator()
                               .manual_seed(1)) + 1).tolist())
    tables = np.zeros((B, W), np.int32)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(ids)
    q = _rand(gen, (B, T, H, D), dtype, dev)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _timed(shape, err, atol, rtol, b_ms, b_by, kern, plain, library,
           iters=20) -> dict:
    ms, wall = time_ms(kern, iters)
    plain_ms, plain_wall = time_ms(plain, iters)
    lib_ms, lib_wall = time_ms(library, iters) if library else (None, None)
    return dict(shape=shape, max_abs_err=err, atol=atol, rtol=rtol, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, wall_ms=wall, plain_wall_ms=plain_wall,
                library_wall_ms=lib_wall)


def phase_kernels(serve_lens) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    # ---- rmsnorm: bf16 at the main path's rows (prefill 512, decode 8),
    # ragged rows, a width off the 16-byte vector, f32 weights, f32
    tol = {bf16: (1e-2, 1e-2), f32: (1e-5, 1e-5)}
    cases = [((512, 2560), bf16, bf16), ((8, 2560), bf16, bf16),
             ((37, 2560), bf16, bf16), ((5, 130), bf16, bf16),
             ((9, 2560), bf16, f32), ((512, 2560), f32, f32),
             ((3, 7, 130), f32, f32)]
    errs = []
    for shape, xdt, wdt in cases:
        x = _rand(gen, shape, xdt, dev, 2.0)
        w = _rand(gen, (shape[-1],), wdt, dev)
        a, r = tol[xdt]
        errs.append(check_close(f"rmsnorm {shape} {xdt}/{wdt}",
                                rmsnorm(x, w, 1e-5), rmsnorm_ref(x, w, 1e-5),
                                a, r))
    x = _rand(gen, (512, 2560), bf16, dev, 2.0)
    w = _rand(gen, (2560,), bf16, dev)
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    b_ms, b_by = bound_ms(nbytes, 4 * x.numel(), f32)
    xd = _rand(gen, (8, 2560), bf16, dev, 2.0)
    out["rmsnorm"] = _timed(
        "x (512, 2560) bf16 (prefill rows)", errs[0], 1e-2, 1e-2, b_ms, b_by,
        lambda: rmsnorm(x, w, 1e-5), lambda: rmsnorm_ref(x, w, 1e-5),
        lambda: F.rms_norm(x, (2560,), w, 1e-5))
    out["rmsnorm"]["decode_rows_ms"], out["rmsnorm"]["decode_rows_wall_ms"] \
        = time_ms(lambda: rmsnorm(xd, w, 1e-5))
    emit("kernels", kernel="rmsnorm", cases=len(cases),
         max_abs_errs=errs, **out["rmsnorm"])

    # ---- flash prefill: (B, S, H, KV, D); main path is B=1, H=KV=20,
    # D=128, S = a bucket of 32..512; edges: S off the 64-row tile, G=4,
    # G=2 small heads, S=1, f32
    tol = {bf16: (2e-2, 2e-2), f32: (2e-5, 2e-5)}
    cases = [(1, 512, 20, 20, 128, bf16), (1, 32, 20, 20, 128, bf16),
             (2, 100, 32, 8, 128, bf16), (1, 77, 4, 2, 32, bf16),
             (1, 1, 20, 20, 128, bf16), (2, 130, 8, 2, 64, f32),
             (1, 64, 4, 2, 16, f32)]
    errs = []
    for B, S, H, KV, D, dt in cases:
        q = _rand(gen, (B, S, H, D), dt, dev)
        k = _rand(gen, (B, S, KV, D), dt, dev)
        v = _rand(gen, (B, S, KV, D), dt, dev)
        a, r = tol[dt]
        errs.append(check_close(
            f"flash B{B} S{S} H{H} KV{KV} D{D} {dt}",
            mha(q, k, v, causal=True),
            blockwise_attention(q, k, v, causal=True).to(dt), a, r))
    q = _rand(gen, (1, 512, 20, 128), bf16, dev)
    k = _rand(gen, (1, 512, 20, 128), bf16, dev)
    v = _rand(gen, (1, 512, 20, 128), bf16, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = 512 * 513 // 2
    b_ms, b_by = bound_ms(4 * q.numel() * 2, 4 * 20 * pairs * 128, bf16)
    out["flash_attention"] = _timed(
        "B=1 S=512 H=KV=20 D=128 bf16 causal (prefill bucket 512)", errs[0],
        2e-2, 2e-2, b_ms, b_by, lambda: mha(q, k, v, causal=True),
        lambda: blockwise_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    emit("kernels", kernel="flash_attention", cases=len(cases),
         max_abs_errs=errs, **out["flash_attention"])

    # ---- paged decode: main path is B=8 (max batch), H=KV=20, D=128,
    # block 16, table width capacity/16 = 64, lengths of the serve
    # prompts mid-generation; edges: G=4, length 1, lengths off the
    # block, null tail entries, f32 pools
    tol = {bf16: (2e-2, 2e-2), f32: (2e-5, 2e-5)}
    W = CAPACITY // BLOCK
    main_lens = [n + MAX_NEW // 2 for n in serve_lens]
    cases = [(MAX_BATCH, 20, 20, 128, main_lens, bf16),
             (4, 32, 8, 128, [1, 17, 250, 1000], bf16),
             (3, 4, 2, 32, [16, 1, 33], bf16),
             (2, 8, 2, 64, [5, 64], f32)]
    errs = []
    for B, H, KV, D, lens, dt in cases:
        q, kp, vp, tb, ln = _paged_inputs(gen, B, H, KV, D, BLOCK, W, lens,
                                          dt, dev)
        a, r = tol[dt]
        errs.append(check_close(
            f"paged B{B} H{H} KV{KV} D{D} lens{lens} {dt}",
            paged_decode(q, kp[0], vp[0], tb, ln),
            paged_decode_ref(q, kp[0], vp[0], tb, ln), a, r))
    L = 40
    q, kp, vp, tb, ln = _paged_inputs(gen, MAX_BATCH, 20, 20, 128, BLOCK, W,
                                      main_lens, bf16, dev, layers=L)
    layer = itertools.count()

    def kern():
        i = next(layer) % L
        return paged_decode(q, kp[i], vp[i], tb, ln)

    def plain():
        i = next(layer) % L
        return paged_decode_ref(q, kp[i], vp[i], tb, ln)

    live = sum(main_lens)
    nbytes = (q.numel() * 2 + 2 * live * 20 * 128 * 2
              + sum(-(-n // BLOCK) for n in main_lens) * 4 + MAX_BATCH * 4
              + q.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * live * 20 * 128, bf16)
    out["paged_decode_attention"] = _timed(
        f"B=8 H=KV=20 D=128 block 16 bf16 lengths {main_lens}", errs[0],
        2e-2, 2e-2, b_ms, b_by, kern, plain, None, iters=40)
    emit("kernels", kernel="paged_decode_attention", cases=len(cases),
         max_abs_errs=errs, **out["paged_decode_attention"])
    out.update(_kernels_tail(gen, main_lens, W))
    return out


def _tail_work(lens, T, KV, H, D, q_bytes, kv_bytes, int8):
    """(bytes, flops) of one paged verify (T tail queries a row) over
    ``lens``: q and the float32 output once, each live K/V row once, the
    live table entries, the lengths, and for int8 pools two scales a live
    pool block; flops 4 * H * D per (query, visible key), causal."""
    blocks = sum(-(-n // BLOCK) for n in lens)
    live = sum(lens)
    nbytes = (len(lens) * T * H * D * (q_bytes + 4) + 2 * live * KV * D
              * kv_bytes + blocks * 4 + len(lens) * 4
              + (2 * blocks * KV * 4 if int8 else 0))
    seen = sum(n - T + t + 1 for n in lens for t in range(T))
    return nbytes, 4 * H * D * seen


def _kernels_tail(gen, main_lens, W) -> dict:
    """Paged verify (bf16/f32 pools) and the int8-pool decode and verify
    kernels.  Main path: B=8, H=KV=20, D=128, block 16, T = SPEC_K + 1 = 5
    for verify and 1 for int8 decode, lengths of the serve prompts
    mid-generation; edges: T in {1, 2}, tails straddling a block, GQA,
    short rows, f32 pools, f32 q on int8 pools."""
    dev = torch.device("cuda")
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    tol = {bf16: (2e-2, 2e-2), f32: (2e-5, 2e-5)}
    T = SPEC_K + 1
    # lengths shifted by 3: tails that straddle a block (len % 16 < T)
    shifted = [n + 3 for n in main_lens]
    out = {}

    # ---- paged verify over bf16/f32 pools
    cases = [(MAX_BATCH, 20, 20, 128, lens, t, dt)
             for dt in (bf16, f32) for t in (1, 2, T)
             for lens in (main_lens, shifted)]
    cases += [(4, 32, 8, 128, [5, 17, 250, 1000], T, bf16),
              (3, 4, 2, 32, [16, 3, 33], 3, f32)]
    errs, t1_equal = [], []
    for B, H, KV, D, lens, t, dt in cases:
        q, kp, vp, tb, ln = _paged_inputs(gen, B, H, KV, D, BLOCK, W, lens,
                                          dt, dev, T=t)
        a, r = tol[dt]
        got = paged_verify(q, kp[0], vp[0], tb, ln)
        errs.append(check_close(
            f"verify B{B} H{H} KV{KV} D{D} T{t} lens{lens} {dt}", got,
            paged_verify_ref(q, kp[0], vp[0], tb, ln), a, r))
        if t == 1:
            t1_equal.append(bool(torch.equal(
                got, paged_decode(q, kp[0], vp[0], tb, ln))))
    L = 40
    q, kp, vp, tb, ln = _paged_inputs(gen, MAX_BATCH, 20, 20, 128, BLOCK, W,
                                      main_lens, bf16, dev, layers=L, T=T)
    layer = itertools.count()

    def pools():
        i = next(layer) % L
        return kp[i], vp[i]

    nbytes, flops = _tail_work(main_lens, T, 20, 20, 128, 2, 2, False)
    b_ms, b_by = bound_ms(nbytes, flops, bf16)
    out["paged_verify_attention"] = _timed(
        f"B=8 T={T} H=KV=20 D=128 block 16 bf16 lengths {main_lens}",
        errs[4], 2e-2, 2e-2, b_ms, b_by,        # errs[4]: this shape
        lambda: paged_verify(q, *pools(), tb, ln),
        lambda: paged_verify_ref(q, *pools(), tb, ln), None, iters=40)
    emit("kernels", kernel="paged_verify_attention", cases=len(cases),
         max_abs_errs=errs, t1_equals_decode_kernel=t1_equal,
         **out["paged_verify_attention"])
    del q, kp, vp

    # ---- int8 pools: decode (T = 1) and verify, q in bf16 or f32; the
    # plain versions dequantize to float32, so both are held to 2e-5
    cases = [(MAX_BATCH, 20, 20, 128, lens, t, qdt)
             for qdt in (bf16, f32) for t in (1, 2, T)
             for lens in (main_lens, shifted)]
    cases += [(4, 32, 8, 128, [5, 17, 250, 1000], T, bf16),
              (3, 4, 2, 32, [16, 3, 33], 3, f32)]
    derrs, verrs = [], []
    for B, H, KV, D, lens, t, qdt in cases:
        q, kq, vq, ks, vs, tb, ln = _paged_inputs(
            gen, B, H, KV, D, BLOCK, W, lens, i8, dev, T=t, qdtype=qdt)
        args = (kq[0], vq[0], ks[0], vs[0], tb, ln)
        name = f"B{B} H{H} KV{KV} D{D} T{t} lens{lens} q {qdt}"
        verrs.append(check_close(f"verify int8 {name}",
                                 paged_verify_int8(q, *args),
                                 paged_verify_int8_ref(q, *args), 2e-5,
                                 2e-5))
        if t == 1:
            derrs.append(check_close(f"decode int8 {name}",
                                     paged_decode_int8(q, *args),
                                     paged_decode_int8_ref(q, *args), 2e-5,
                                     2e-5))
    for name, t, errs_ in (("paged_decode_attention_int8", 1, derrs),
                           ("paged_verify_attention_int8", T, verrs)):
        fn, ref = ((paged_decode_int8, paged_decode_int8_ref) if t == 1
                   else (paged_verify_int8, paged_verify_int8_ref))
        q, kq, vq, ks, vs, tb, ln = _paged_inputs(
            gen, MAX_BATCH, 20, 20, 128, BLOCK, W, main_lens, i8, dev,
            layers=L, T=t, qdtype=bf16)

        def args():
            i = next(layer) % L
            return (q, kq[i], vq[i], ks[i], vs[i], tb, ln)

        nbytes, flops = _tail_work(main_lens, t, 20, 20, 128, 2, 1, True)
        b_ms, b_by = bound_ms(nbytes, flops, i8)
        # errs_[0] (decode) and errs_[4] (verify): this shape's check
        out[name] = _timed(
            f"B=8 T={t} H=KV=20 D=128 block 16 int8 pools, bf16 q, "
            f"lengths {main_lens}", errs_[0 if t == 1 else 4], 2e-5, 2e-5,
            b_ms, b_by,
            lambda: fn(*args()), lambda: ref(*args()), None, iters=40)
        emit("kernels", kernel=name, cases=len(errs_), max_abs_errs=errs_,
             **out[name])
        del q, kq, vq
    return out


def _serve(cfg, params, prompts, device, max_batch, capacity, **kw):
    eng = InferenceEngine(cfg, params, max_batch=max_batch,
                          capacity=capacity, device=device, **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW)
            for p in prompts]
    for r in reqs:
        eng.submit(r)
    summary = eng.run_until_idle()
    return eng, reqs, summary


def _match_rate(got, want) -> float:
    hit = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return hit / max(sum(len(w) for w in want), 1)


def phase_tiny() -> None:
    """Scaled-down qwen1.5-4b (4 layers, d 128, H 4 over KV 2, head 32)
    in f32 on the card and on the CPU from the same weights: plain and
    n-gram speculative (spec_k 4) tokens equal on both, and int8-KV
    tokens (plain and speculative, on the card) at >= 0.90 of them."""
    cfg = scaled_down(get_config("qwen1.5-4b"))
    cpu_params = M.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 40, 17)]
    prompts.append(prompts[1] + [7, 8, 9])        # a prefix hit
    prompts.append(prompts[2][:9] * 3)            # a repeated span

    def tokens(params, dev, **kw):
        return [r.generated for r in
                _serve(cfg, params, prompts, dev, 4, 128, **kw)[1]]

    spec = {"speculative": "ngram", "spec_k": SPEC_K}
    want = tokens(cpu_params, "cpu")
    runs = {"card": tokens(gpu_params, "cuda"),
            "card_spec": tokens(gpu_params, "cuda", **spec),
            "cpu_spec": tokens(cpu_params, "cpu", **spec)}
    for name, got in runs.items():
        if got != want:
            raise AssertionError(f"tiny: {name} tokens {got} != CPU {want}")
    rates = {name: _match_rate(tokens(gpu_params, "cuda", kv_dtype="int8",
                                      **kw), want)
             for name, kw in (("card_int8", {}), ("card_int8_spec", spec))}
    if min(rates.values()) < 0.90:
        raise AssertionError(f"tiny: int8 match rates {rates} < 0.90")
    emit("tiny", requests=len(prompts), tokens_equal=sorted(runs),
         tokens=sum(len(t) for t in want), int8_match_rates=rates)


def serve_prompts(vocab: int):
    """8 prompts from numpy seed 0: six of 64..512 tokens (the third a
    multiple of the block, the fifth its first half twice: a span the
    n-gram drafter finds), one extending the third by 8 tokens (a prefix
    hit), one of 600 (past prefill_chunk: a streamed tail)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, 6).tolist()
    lens[2] = 256
    prompts = [rng.integers(1, vocab, n).tolist() for n in lens]
    half = prompts[4][:lens[4] // 2]
    prompts[4] = (half * 2 + prompts[4])[:lens[4]]
    prompts.append(prompts[2] + rng.integers(1, vocab, 8).tolist())
    prompts.append(rng.integers(1, vocab, 600).tolist())
    return prompts


def _prefill_one(cfg, params, prompt, dev, kernels=K.KERNELS):
    pad = _bucket(len(prompt))
    toks = torch.zeros((1, pad), dtype=torch.int32, device=dev)
    toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    batch = {"tokens": toks,
             "prompt_lengths": torch.tensor([len(prompt)], dtype=torch.int32,
                                            device=dev)}
    return M.prefill(cfg, params, batch, kernels=kernels)


def _slots_with(cfg, cache, n, dev, kv_dtype, extra):
    """One slot holding the prefill cache of an n-token prompt, with room
    for ``extra`` more positions."""
    slots = PagedCacheSlots(cfg, 1, CAPACITY, block_size=BLOCK,
                            pool_tokens=CAPACITY, device=dev,
                            kv_dtype=kv_dtype)
    slot = slots.allocate("cmp")
    slots.ensure_capacity(slot, n + extra)
    slots.insert_prefill(slot, cache, n)
    return slots


def phase_steps(cfg, params, prompt, dev) -> None:
    """Model steps at full width, kernels against the plain versions on
    the same state: the first prefill, a decode step (bf16 pool), the
    first verify step of SPEC_K + 1 tokens on the same bf16 pool and on
    the same int8 pool, an int8 decode step, and the int8-pool decode
    step against the bf16-pool one on identical state.  bf16 through 40
    layers: both paths round at the same points, but sums run in other
    orders and the attention kernels keep p in float, so each gap is held
    to 5% of the largest logit; argmax agreement is reported."""
    V = cfg.vocab_size
    rel_tol = 5e-2
    n = len(prompt)
    T = SPEC_K + 1
    res = {"rel_tol": rel_tol}

    def hold(name, a, b):
        a, b = a[..., :V], b[..., :V]          # pad vocab is -1e30 in both
        res[name + "_max_abs_err"] = check_close(
            f"{name} logits", a, b, rel_tol * float(b.abs().max()), 0.0)
        res[name + "_max_abs_logit"] = float(b.abs().max())
        res[name + "_argmax_equal"] = bool(
            torch.equal(a.argmax(-1), b.argmax(-1)))

    with torch.no_grad():
        lk, cache, _ = _prefill_one(cfg, params, prompt, dev)
        lp, _, _ = _prefill_one(cfg, params, prompt, dev, kernels=K.PLAIN)
        hold("prefill", lk, lp)
        tok = torch.argmax(lk[:, :V], -1).to(torch.int32)[:, None]
        # the tail: the next token, then SPEC_K drafts from the prompt
        tail = torch.cat([tok, torch.tensor([prompt[:SPEC_K]],
                                            dtype=torch.int32,
                                            device=dev)], 1)
        logits = {}
        for kv in ("bf16", "int8"):
            slots = _slots_with(cfg, cache, n, dev, kv, T)
            tb = slots.tables_device()
            for what, toks, step in (
                    ("decode", tok, M.decode_step_paged),
                    ("verify", tail, M.verify_step_paged)):
                ln = torch.tensor([n + toks.shape[1]], dtype=torch.int32,
                                  device=dev)
                pools = [tree_map(lambda t: t.clone(), slots.pool)
                         for _ in range(2)]
                a, _ = step(cfg, params, toks, pools[0], tb, ln)
                b, _ = step(cfg, params, toks, pools[1], tb, ln,
                            kernels=K.PLAIN)
                hold(f"{what}_{kv}", a, b)
                logits[what, kv] = a
                del pools
            del slots
        hold("decode_int8_vs_bf16", logits["decode", "int8"],
             logits["decode", "bf16"])
        del cache
    emit("serve_check", **res)


def _serve_run(smi, cfg, params, prompts, dev, name, **kw) -> dict:
    """One serve run of the 8 prompts with the launch counts set to 0
    just before it; each kernel's count is held to the number of model
    calls on its path, and every kernel of the path must have run."""
    _sync(dev)
    gc.collect()         # the last run's engine (a reference cycle)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng, reqs, summary = _serve(cfg, params, prompts, dev, MAX_BATCH,
                                CAPACITY, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    sch = eng.scheduler
    L = cfg.num_layers
    int8 = kw.get("kv_dtype") == "int8"
    dec, ver = (("paged_decode_attention_int8", "paged_verify_attention_int8")
                if int8 else ("paged_decode_attention",
                              "paged_verify_attention"))
    want = {k: 0 for k in counts}
    want.update({"rmsnorm": (2 * L + 1) * (sch.prefills + sch.micro_steps
                                           + sch.verify_steps),
                 "flash_attention": L * sch.prefills,
                 dec: L * sch.micro_steps, ver: L * sch.verify_steps})
    path = ["rmsnorm", "flash_attention",
            ver if kw.get("speculative") else dec]
    if counts != want or min(counts[k] for k in path) == 0:
        raise AssertionError(f"{name}: launch counts {counts} != {want} "
                             f"or a kernel of {path} never ran")
    gen = [r.generated for r in reqs]
    V = cfg.vocab_size
    if any(len(g) != MAX_NEW for g in gen) or any(
            not 0 <= t < V for g in gen for t in g):
        raise AssertionError(f"{name}: bad generations {gen}")
    if summary["completed"] != len(prompts) or summary["rejected"]:
        raise AssertionError(f"{name}: {summary}")
    hits = [eng.metrics.requests[r.request_id].n_cached for r in reqs]
    if hits[6] == 0 or sum(h > 0 for h in hits) != 1:
        raise AssertionError(f"{name}: prefix hits {hits}")
    if sch.prefills != len(prompts) - 1:
        raise AssertionError(f"{name}: {sch.prefills} prefills")
    recs = eng.metrics.requests.values()
    first = min(r.first_token for r in recs)
    last = max(r.finish for r in recs)
    decode_tokens = sum(r.n_generated - 1 for r in recs)
    res = dict(
        run=name, smi=smi, arch=cfg.name, dtype="bfloat16",
        kv_dtype=kw.get("kv_dtype", "bf16"),
        speculative=kw.get("speculative"), spec_k=kw.get("spec_k"),
        requests=len(prompts), prompt_lens=[len(p) for p in prompts],
        max_new_tokens=MAX_NEW, prefills=sch.prefills,
        micro_steps=sch.micro_steps, verify_steps=sch.verify_steps,
        launches=counts, prefix_hit_tokens=hits[6],
        ttft_p50_s=summary["ttft_p50_s"], ttft_p99_s=summary["ttft_p99_s"],
        itl_mean_s=summary["itl_mean_s"],
        decode_tokens_per_s=decode_tokens / (last - first),
        tokens_per_s=summary["tokens_per_s"],
        spec_acceptance_rate=summary["spec_acceptance_rate"],
        spec_tokens_per_launch=summary["spec_tokens_per_launch"],
        wall_s=wall,
        max_memory_allocated_bytes=(torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else None),
        kv=eng.kv_stats())
    emit("serve", **res)
    res["tokens"] = gen
    del eng
    return res


def phase_serve(smi: str, prompts, cfg=None, dev="cuda") -> dict:
    """``cfg``/``dev`` default to full-width qwen1.5-4b on the card; a
    scaled-down config on the CPU rehearses the same control flow.
    Returns each run's launch counts by run name."""
    dev = torch.device(dev)
    cfg = cfg or get_config("qwen1.5-4b")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    _sync(dev)
    emit("weights", arch=cfg.name, init_s=time.perf_counter() - t0,
         params=sum(t.numel() for _, t in tree_items(params)))
    phase_steps(cfg, params, prompts[0], dev)
    spec = {"speculative": "ngram", "spec_k": SPEC_K}
    runs = {name: _serve_run(smi, cfg, params, prompts, dev, name, **kw)
            for name, kw in (("bf16", {}), ("bf16_spec", spec),
                             ("int8", {"kv_dtype": "int8"}),
                             ("int8_spec", {"kv_dtype": "int8", **spec}))}
    # greedy speculation reduces in another order than plain decode, so
    # in bf16 its tokens may part from the plain run's: reported, not
    # gated (the f32 tiny phase gates identity)
    base = runs["bf16"]["tokens"]
    emit("serve_agreement", **{
        f"{name}_vs_bf16_match_rate": _match_rate(r["tokens"], base)
        for name, r in runs.items() if name != "bf16"},
        int8_block_bytes_over_bf16=(
            runs["int8"]["kv"]["kv_block_bytes_per_device"]
            / runs["bf16"]["kv"]["kv_block_bytes_per_device"]),
        int8_pool_bytes_over_bf16=(
            runs["int8"]["kv"]["kv_block_bytes_per_device"]
            * runs["int8"]["kv"]["kv_blocks_total"]
            / (runs["bf16"]["kv"]["kv_block_bytes_per_device"]
               * runs["bf16"]["kv"]["kv_blocks_total"])))
    return {name: r["launches"] for name, r in runs.items()}


def main() -> int:
    smi = phase_device()
    phase_build()
    prompts = serve_prompts(get_config("qwen1.5-4b").vocab_size)
    kern = phase_kernels([len(p) for p in prompts])
    phase_tiny()
    counts = phase_serve(smi, prompts)
    line = {"kernels": [
        {"name": name, "ok": True, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": counts[PATH_OF[name]][name],
         "path": PATH_OF[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "kernel_ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": kern[name]["library_ms"]}
        for name in SOURCES]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
