"""Serving entry point of the port: one engine on one device, greedy.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --scale full --requests 8 --max-tokens 32 \\
        [--speculative ngram --spec-k 4] [--kv-dtype int8]

Serves random bf16 weights drawn on the device from ``--seed`` to prompts
of 64..512 random tokens (numpy, same seed) and prints the engine's
metrics summary as one JSON line.  ``--speculative ngram`` drafts up to
``--spec-k`` tokens a slot by prompt lookup and verifies them in one
forward; ``--kv-dtype int8`` keeps the KV pool in int8 with per-block
scales.  ``--profile-out DIR`` then probes one prefill, one decode
micro-step and one verify micro-step (T = spec_k + 1) over a pool of
``--kv-dtype`` (see :func:`probe`) and writes their kernel-time tables
there.  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, scaled_down
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.kernels import _lib
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.kvcache import PagedCacheSlots

PROMPT_LENS = (64, 512)    # the range of chip_smoke.py's traffic


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _kernel_ms(prof, steps: int) -> dict:
    """Device time per step by kernel family, from a profiler window."""
    groups = {"paged_decode": 0.0, "paged_verify": 0.0, "paged_int8": 0.0,
              "flash_attention": 0.0, "rmsnorm": 0.0, "matmul": 0.0,
              "other": 0.0}
    for e in prof.key_averages():
        t = e.self_device_time_total
        if t <= 0:
            continue
        name = e.key
        if "paged_decode_kernel" in name:
            groups["paged_decode"] += t
        elif "paged_verify_kernel" in name:
            # one template: int8 pools (decode and verify) are its
            # <q, signed char, true> instances
            int8 = "signed char" in name or "Lb1E" in name
            groups["paged_int8" if int8 else "paged_verify"] += t
        elif "flash_fwd_kernel" in name:
            groups["flash_attention"] += t
        elif "rmsnorm_kernel" in name:
            groups["rmsnorm"] += t
        elif any(k in name for k in ("nvjet", "gemm", "cutlass", "sm90")):
            groups["matmul"] += t
        elif not name.startswith("aten::"):
            groups["other"] += t
    return {k: v / steps / 1e3 for k, v in groups.items()}


def probe(cfg, params, dev, out_dir: Path, batch: int, ctx: int,
          steps: int = 20, kv_dtype: str = "bf16", spec_k: int = 4) -> dict:
    """Where a step's time goes: the host-clock time of a prefill (one
    512-token prompt), of a decode micro-step and of a verify micro-step
    of T = ``spec_k + 1`` tokens a row (``batch`` sequences at about
    ``ctx`` tokens, over a ``kv_dtype`` pool), each against the device
    time of its kernels from a short ``torch.profiler`` window.  The idle
    share is 1 - device/wall."""
    # device activity only: host-op tracing of the int8 verify step's
    # ~10^4 small ops a call makes the profiler's own bookkeeping take
    # minutes, and the host side is read off the wall clock anyway
    acts = [torch.profiler.ProfilerActivity.CUDA]
    T = spec_k + 1
    # decode then verify each run 3 + 2 * steps times, growing every row
    # by 1 and by T positions a call
    room = ctx + (3 + 2 * steps) * (T + 1)
    slots = PagedCacheSlots(cfg, batch, room, pool_tokens=batch * room,
                            device=dev, kv_dtype=kv_dtype)
    for b in range(batch):
        slots.allocate(f"probe{b}")
        slots.ensure_capacity(b, room)
    tables = slots.tables_device()
    toks = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    vtoks = torch.ones((batch, T), dtype=torch.int32, device=dev)
    pre = {"tokens": torch.ones((1, 512), dtype=torch.int32, device=dev),
           "prompt_lengths": torch.tensor([512], dtype=torch.int32,
                                          device=dev)}
    n = [ctx]

    def decode():
        n[0] += 1
        lens = torch.full((batch,), n[0], dtype=torch.int32, device=dev)
        M.decode_step_paged(cfg, params, toks, slots.pool, tables, lens)

    def verify():
        n[0] += T
        lens = torch.full((batch,), n[0], dtype=torch.int32, device=dev)
        M.verify_step_paged(cfg, params, vtoks, slots.pool, tables, lens)

    def prefill():
        M.prefill(cfg, params, pre)

    out = {}
    with torch.no_grad():
        for name, fn, reps in (("decode_step", decode, steps),
                               (f"verify_step_T{T}", verify, steps),
                               ("prefill_512", prefill, 3)):
            for _ in range(3):
                fn()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                _sync(dev)
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(reps):
                    fn()
                _sync(dev)
            dev_ms = _kernel_ms(prof, reps)
            busy = sum(dev_ms.values())
            out[name] = {"wall_ms": wall_ms, "device_ms": busy,
                         "device_idle_share": 1.0 - busy / wall_ms,
                         "kernels_ms": dev_ms}
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{name}_profile.txt").write_text(
                prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30))
    out["probe"] = {"batch": batch, "ctx": ctx, "kv_dtype": kv_dtype,
                    "verify_T": T}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--speculative", default=None, choices=["ngram"],
                    help="draft tokens by prompt lookup and verify them "
                         "in one forward")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafts per slot and step (--speculative)")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="KV pool precision (int8: per-block scales, "
                         "twice the blocks for the same budget)")
    ap.add_argument("--profile-out", default="",
                    help="after serving, probe one prefill and one decode "
                         "step on the card and write profiles here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "tiny":
        cfg = scaled_down(cfg)
    out = {"arch": cfg.name, "scale": args.scale, "device": "cpu",
           "speculative": args.speculative, "spec_k": args.spec_k,
           "kv_dtype": args.kv_dtype}
    if dev.type == "cuda":
        # set-up, before any request's clock starts: kernel build and load
        t0 = time.perf_counter()
        _lib.load()
        out["build_s"] = time.perf_counter() - t0
        out["device"] = torch.cuda.get_device_name(dev)
    params = M.init(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, args.requests)
    eng = InferenceEngine(cfg, params, max_batch=args.max_batch,
                          capacity=args.capacity, device=dev,
                          speculative=args.speculative, spec_k=args.spec_k,
                          kv_dtype=args.kv_dtype)
    for n in lens:
        eng.submit(Request(prompt=rng.integers(1, cfg.vocab_size,
                                               int(n)).tolist(),
                           max_new_tokens=args.max_tokens))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run_until_idle()
    _sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out.update(eng.metrics.summary())
    out["micro_steps"] = eng.scheduler.micro_steps
    out["verify_steps"] = eng.scheduler.verify_steps
    out["prefills"] = eng.scheduler.prefills
    out["kv"] = eng.kv_stats()
    if dev.type == "cuda":
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    if args.profile_out:
        ctx = int(np.mean(lens)) + args.max_tokens // 2
        out.update(probe(cfg, params, dev, Path(args.profile_out),
                         args.max_batch, ctx, kv_dtype=args.kv_dtype,
                         spec_k=args.spec_k))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
