"""Continuous-batching inference engine (the unified, paged, greedy path
of the reference's ``serving/engine.py``, with n-gram speculative decoding
and a bf16 or int8 KV pool).

One engine = one model replica on one device: a fixed decode batch of
``max_batch`` slots over a shared paged KV pool
(:class:`~repro_torch.serving.kvcache.PagedCacheSlots`), a waiting queue,
pow2-bucketed one-shot prefill, and per-request TTFT/ITL/E2EL metrics.
Admission, chunked prefill, prefix reuse, preemption and speculative
bursts live in :class:`~repro_torch.serving.scheduler.ChunkedPrefillScheduler`.

Each model step runs eagerly: prefill and every decode or verify
micro-step call the hand-written kernels (RMSNorm, flash prefill, paged
decode and verify, over bf16 or int8 pools) on the card, and a
micro-step costs one device-to-host transfer of the sampled (or
accepted) tokens for the whole batch.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.faults import EngineFailure, EngineTimeout
from repro_torch.serving.kvcache import PagedCacheSlots
from repro_torch.serving.metrics import MetricsCollector
from repro_torch.serving.scheduler import (ChunkedPrefillScheduler,
                                           SchedulerConfig)
from repro_torch.serving.speculative import make_drafter


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: int = -1
    request_id: str = ""
    namespace: str = ""      # prefix-cache isolation domain (tenant/project)
    # filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # generated tokens already folded into the prompt by preemption —
    # repeated preemption must fold only the tokens emitted since
    n_folded: int = 0


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "engine0",
                 sched: Optional[SchedulerConfig] = None,
                 pool_tokens: Optional[int] = None,
                 speculative: Optional[str] = None,
                 spec_k: int = 4,
                 kv_dtype: str = "bf16",
                 device=None):
        """``params`` is a tree from ``M.init`` or ``from_numpy_tree`` on
        ``device`` (default: the card; on a host without one, pass
        ``device="cpu"`` or the constructor raises).  ``pool_tokens``
        sizes the shared block pool (default ``max_batch * capacity``, a
        bf16-byte budget); its block size is the scheduler's
        ``prefix_block``, so radix nodes map 1:1 onto physical blocks.
        ``speculative="ngram"`` drafts up to ``spec_k`` tokens a slot by
        prompt lookup and verifies them in one forward (greedy outputs
        stay token-identical).  ``kv_dtype="int8"`` stores the pool as
        int8 with per-(block, KV head) scales: twice the blocks for the
        same budget."""
        self.device = resolve_device(device)
        if not M.supports_paged_cache(cfg):
            raise ValueError(f"{cfg.name}: the port serves paged-KV "
                             f"architectures only")
        M.check_supported(cfg)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.cfg, self.params = cfg, params
        self.name = name
        self.clock = clock
        sched = sched or SchedulerConfig()
        self.slots = PagedCacheSlots(
            cfg, max_batch, capacity, block_size=sched.prefix_block,
            pool_tokens=pool_tokens, device=self.device, kv_dtype=kv_dtype)
        # speculative decoding: draft up to spec_k tokens per sequence and
        # score them in ONE multi-token verify forward
        self.spec_k = spec_k
        self.drafter = None
        if speculative:
            if not M.supports_speculative(cfg):
                raise ValueError(
                    "speculative decoding needs position-sliceable KV "
                    "(uniform GQA/MLA stacks): rejected tokens cannot be "
                    f"rolled back on {cfg.name}")
            self.drafter = make_drafter(speculative, cfg, spec_k=spec_k,
                                        capacity=capacity)
        self.capacity = capacity
        self.queue: deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.metrics = MetricsCollector()
        self._ids = itertools.count()
        self.healthy = True
        self.draining = False
        self.steps = 0
        self.scheduler = ChunkedPrefillScheduler(self, sched)

    # ------------------------------------------------------------ API
    def submit(self, req: Request) -> str:
        st = self.health()
        if st != "ok":
            raise EngineFailure(f"{self.name} is {st}", point="submit",
                                kind=st)
        if req.temperature > 0:
            raise ValueError(
                "the port samples greedily only (temperature 0); "
                "temperature sampling is not ported yet")
        if not req.request_id:
            req.request_id = f"{self.name}-r{next(self._ids)}"
        self.metrics.arrival(req.request_id, self.clock(), len(req.prompt))
        self.queue.append(req)
        return req.request_id

    # -------------------------------------------------------- lifecycle
    def health(self) -> str:
        """``"ok"`` / ``"draining"`` (finishing in-flight work, not
        accepting new) / ``"down"`` (crashed; needs :meth:`recover`)."""
        if not self.healthy:
            return "down"
        if self.draining:
            return "draining"
        return "ok"

    def crash(self, reason: str = "") -> List[Request]:
        """Mark the engine down, evacuate every in-flight request (greedy
        resubmission elsewhere is token-exact) and drop the prefix cache.
        Returns the evacuated requests, oldest first."""
        self.healthy = False
        reqs = self.scheduler.evacuate()
        self.scheduler.reset_cache()
        return reqs

    def recover(self) -> None:
        self.healthy = True
        self.draining = False

    def drain(self, max_steps: int = 100_000):
        """Stop accepting new requests but finish the in-flight ones."""
        self.draining = True
        return self.run_until_idle(max_steps)

    @property
    def num_active(self) -> int:
        return len(self.running) + len(self.queue)

    def kv_stats(self) -> Dict[str, int]:
        """KV-memory accounting in pool blocks (shared prefix blocks count
        once) and bytes, under the reference's key names.  The port runs
        on one device, so the tensor-parallel degree is 1 and the
        per-device bytes are the whole pool's; an int8 pool's bytes
        include its scale leaves."""
        bp = self.slots.bp
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in self.slots.pool["stack"].values())
        per_block = pool_bytes // bp.num_blocks
        return {"kv_blocks_used": bp.num_used,
                "kv_blocks_peak": bp.peak_used,
                "kv_blocks_total": bp.num_blocks - 1,
                "kv_block_size": self.slots.block_size,
                "kv_tp_degree": 1,
                "kv_block_bytes_per_device": per_block,
                "kv_peak_bytes_per_device": per_block * bp.peak_used}

    # ------------------------------------------------------------ steps
    def step(self):
        """One scheduler tick: admit up to N requests, then decode (and
        stream pending prefill chunks)."""
        with torch.no_grad():
            self.scheduler.tick()
        self.steps += 1

    def run_until_idle(self, max_steps: int = 100_000,
                       deadline: Optional[float] = None):
        """Drive the engine until no request is active.  ``deadline``
        (absolute, on the engine's clock) bounds the wall budget: when it
        passes with work still in flight, the remaining requests are
        evacuated and :class:`EngineTimeout` carries them out."""
        while self.num_active and max_steps:
            if deadline is not None and self.clock() >= deadline:
                reqs = self.scheduler.evacuate()
                raise EngineTimeout(
                    f"{self.name}: deadline exceeded with "
                    f"{len(reqs)} request(s) in flight", requests=reqs)
            self.step()
            max_steps -= 1
        return self.metrics.summary()
