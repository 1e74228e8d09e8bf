"""Chunked-prefill scheduler policy for the inference engine (the paged,
greedy path of the reference's ``serving/scheduler.py``).

- **Admission** pops up to ``admit_per_tick`` requests per tick.  Each
  admitted request first runs a longest-prefix match against the radix
  prefix cache; a hit splices the matched physical blocks into the
  request's block table with a refcount bump (copy-free), and only the
  uncached suffix needs compute.
- **Decode runs every tick.**  Running requests emit at least one token
  per tick regardless of admission activity.
- **Chunked prefill.**  A cache miss prefills up to ``prefill_chunk``
  prompt tokens in one shot (padded to a pow2 bucket); the rest of the
  prompt, and a hit's uncached suffix, stream through the batched decode
  step one token per micro-step, in which every running slot advances.
- **Preemption, not over-commit.**  Decode growth allocates real pool
  blocks.  On exhaustion the scheduler first evicts unpinned prefix tree
  leaves, then preempts the latest-admitted running request, whose
  generated tokens are folded into its prompt so it resumes exactly.
- **Speculative bursts.**  With a drafter attached (``engine.drafter``),
  any micro-step with at least one decoding slot runs
  :meth:`_spec_micro_step` instead: each decoding slot drafts up to
  ``spec_k`` tokens, ONE multi-token verify forward scores them all, and
  the slot emits 1..spec_k+1 tokens (greedy accept; the rejected tail is
  rolled back by length and its blocks trimmed).  Prefilling slots ride
  along, consuming one prompt token.

LoRA adapters, the disaggregated hand-off roles and the
graceful-degradation ladder of the reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.serving.prefix_cache import (Match, PagedPrefixCache,
                                              supports_prefix_cache)
from repro_torch.serving.sampling import sample, spec_accept_batched


@dataclasses.dataclass
class SchedulerConfig:
    admit_per_tick: int = 1
    # max uncached suffix tokens consumed per request per tick; also the
    # one-shot prefill size cap for cache-miss prompts
    prefill_chunk: int = 512
    enable_prefix_cache: bool = True
    # token-block size of the radix tree and of the physical pool blocks
    # (node <-> block, 1:1)
    prefix_block: int = 16
    # KV token budget of the prefix cache; default = the pool size
    cache_capacity_tokens: Optional[int] = None


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    """Pow2 prefill-padding bucket."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 4096) * 4096


class ChunkedPrefillScheduler:
    """Policy object driving one engine's admission + decode loop."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None):
        self.eng = engine
        self.config = config or SchedulerConfig()
        self.supported = supports_prefix_cache(engine.cfg)
        self.prefix_cache: Optional[PagedPrefixCache] = None
        if self.config.enable_prefix_cache and self.supported:
            cap = (self.config.cache_capacity_tokens
                   if self.config.cache_capacity_tokens is not None
                   else (engine.slots.bp.num_blocks - 1)
                   * engine.slots.block_size)
            self.prefix_cache = PagedPrefixCache(
                engine.slots.bp, block_size=engine.slots.block_size,
                capacity_tokens=cap)
        # slot -> index of the next prompt token to stream through decode
        self.pending: Dict[int, int] = {}
        # request_id -> pinned radix nodes (unpinned at finish/release)
        self._locked: Dict[str, List] = {}
        # slot -> admission sequence number (preemption picks the max)
        self._admit_order: Dict[int, int] = {}
        self._admit_seq = itertools.count()
        # model launches, for checking kernel launch counts per call:
        # prefills, plain S == 1 micro-steps, and speculative verify
        # micro-steps (T = spec_k + 1 tokens a row)
        self.prefills = 0
        self.micro_steps = 0
        self.verify_steps = 0

    # ------------------------------------------------------------ tick
    def tick(self):
        admitted = 0
        while admitted < self.config.admit_per_tick and self._admit_one():
            admitted += 1
        self._decode_tick()

    # ------------------------------------------------------------ admission
    def _admit_one(self) -> bool:
        eng = self.eng
        if not eng.queue:
            return False
        if not eng.slots.free:
            return False
        req = eng.queue[0]
        # a preempted request resumes with its generated tokens folded
        # into the prompt; only the *remaining* budget counts
        need = len(req.prompt) + req.max_new_tokens - len(req.generated)
        if eng.drafter is not None:
            # the verify step writes spec_k + 1 tail positions before
            # accept/reject, so the slot must address spec_k extra
            # positions past the last real token
            need += eng.spec_k
        if need > eng.capacity:
            # can never fit: explicit rejection, not a silent "finish"
            eng.queue.popleft()
            req.done = True
            eng.metrics.reject(req.request_id, eng.clock())
            return True      # queue progressed; keep admitting
        n = len(req.prompt)
        chunk0 = n
        if self.supported and n > self.config.prefill_chunk:
            chunk0 = self.config.prefill_chunk
        # worst-case (cache-miss) block need for the first chunk; eviction
        # of unpinned tree leaves can free at most evictable_blocks() more
        avail = eng.slots.bp.num_free
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_blocks()
        if eng.slots.blocks_for(chunk0) > avail:
            return False
        eng.queue.popleft()
        slot = eng.slots.allocate(req.request_id)
        eng.metrics.prefill_start(req.request_id, eng.clock())

        cached = 0
        if self.prefix_cache is not None:
            m: Match = self.prefix_cache.match(req.namespace, req.prompt)
            bs = eng.slots.block_size
            n_use = min(len(m.nodes), (n - 1) // bs)
            cached = n_use * bs
            # take the hit only when streaming the uncached suffix costs
            # no more model launches than the miss path (one one-shot
            # prefill chunk + streamed tail); paged hits are whole-block,
            # losing up to block_size-1 cached tokens to rounding, so
            # grant exactly that slack
            miss_launches = (1 + max(0, n - self.config.prefill_chunk)
                             + bs - 1)
            if cached > 0 and n - cached <= miss_launches:
                nodes = m.nodes[:n_use]
                self.prefix_cache.lock(nodes)
                self._locked.setdefault(req.request_id, []).extend(nodes)
                ids = self.prefix_cache.gather_block_ids(m, n_use)
                # copy-free: refcount bump + table splice, no KV moved
                eng.slots.adopt_prefix(slot, ids, cached)
                eng.metrics.prefix_hit(req.request_id, cached)
            else:
                cached = 0
        eng.running[slot] = req
        self._admit_order[slot] = next(self._admit_seq)

        if cached > 0:
            # stream the uncached suffix through decode micro-steps
            self.pending[slot] = cached
            return True

        # cache miss: one-shot prefill of the first chunk (the whole
        # prompt unless it exceeds prefill_chunk)
        chunk = chunk0
        if not self._ensure_blocks(slot, chunk):
            # pool exhausted even after eviction: put the request back
            # and wait for blocks to free up
            eng.running.pop(slot, None)
            self._admit_order.pop(slot, None)
            eng.slots.release(slot)
            eng.queue.appendleft(req)
            return False
        pad = _bucket(chunk)
        toks = np.zeros((1, pad), np.int32)
        toks[0, :chunk] = req.prompt[:chunk]
        dev = eng.slots.device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "prompt_lengths": torch.tensor([chunk], dtype=torch.int32,
                                                device=dev)}
        logits, cache, _ = M.prefill(eng.cfg, eng.params, batch)
        self.prefills += 1
        eng.slots.insert_prefill(slot, cache, chunk)

        if chunk < n:
            self.pending[slot] = chunk
        else:
            self._store_prompt(slot, req)
            self._emit(slot, req, int(sample(logits)[0]))
        return True

    # ------------------------------------------------------ paged memory
    def _ensure_blocks(self, slot: int, new_len: int) -> bool:
        """ensure_capacity with tree-eviction fallback (no preemption)."""
        eng = self.eng
        if eng.slots.ensure_capacity(slot, new_len):
            return True
        need = (eng.slots.blocks_for(new_len)
                - len(eng.slots.seq_blocks.get(slot, [])))
        self._reclaim(need)
        return eng.slots.ensure_capacity(slot, new_len)

    def _reclaim(self, n_blocks: int) -> bool:
        """Evict unpinned prefix-tree leaves until the pool has
        ``n_blocks`` free (shared leaves may free nothing — their blocks
        survive until the last running holder releases)."""
        bp = self.eng.slots.bp
        pc = self.prefix_cache
        while bp.num_free < n_blocks:
            if pc is None or not pc._evict_one():
                return False
        return True

    def _unlock(self, req) -> None:
        if self.prefix_cache is not None:
            nodes = self._locked.pop(req.request_id, None)
            if nodes:
                self.prefix_cache.unlock(nodes)

    def _preempt_latest(self):
        """Free the latest-admitted running request's blocks and return
        it to the queue head.  Its generated tokens are folded into the
        prompt, so re-admission re-prefills (typically a prefix-cache
        hit) and generation resumes token-exactly."""
        eng = self.eng
        slot = max(eng.running, key=lambda s: self._admit_order.get(s, -1))
        req = eng.running.pop(slot)
        self.pending.pop(slot, None)
        self._admit_order.pop(slot, None)
        self._unlock(req)
        self._release_drafter(slot)
        fresh = req.generated[req.n_folded:]
        if fresh:
            req.prompt = list(req.prompt) + list(fresh)
            req.n_folded = len(req.generated)
        eng.slots.release(slot)
        eng.queue.appendleft(req)
        eng.metrics.preempt(req.request_id, eng.clock())

    def evacuate(self) -> List:
        """Pull every in-flight request off the engine (crash/timeout
        path): running requests go through the preemption fold, then the
        whole queue is drained.  Returns the requests oldest-first, ready
        to resubmit anywhere token-exactly (greedy)."""
        eng = self.eng
        while eng.running:
            self._preempt_latest()
        out = list(eng.queue)
        eng.queue.clear()
        return out

    def reset_cache(self) -> None:
        """Drop the whole radix prefix cache (crash path).  Call after
        :meth:`evacuate` — only unlocked nodes can be evicted."""
        pc = self.prefix_cache
        if pc is None:
            return
        while pc._evict_one():
            pass

    def _grow_all(self, n: int = 1):
        """Allocate the next ``n`` positions' blocks for every running
        slot, preempting latest-admitted requests when the pool (plus
        tree eviction) cannot supply them."""
        eng = self.eng
        while eng.running:
            stuck = None
            for slot in sorted(eng.running):
                if not self._ensure_blocks(slot,
                                           int(eng.slots.lengths[slot]) + n):
                    stuck = slot
                    break
            if stuck is None:
                return
            self._preempt_latest()

    # ------------------------------------------------------------ decode
    def _decode_tick(self):
        if not self.eng.running:
            return
        # while any slot is still prefilling (and the per-tick chunk
        # budget lasts), run extra micro-steps; every running slot
        # advances each micro-step, so decode is never stalled
        limit = max(1, self.config.prefill_chunk)
        steps = 0
        while True:
            self._micro_step()
            steps += 1
            if not self.pending or steps >= limit or not self.eng.running:
                break

    def _micro_step(self):
        """One fused decode step for the whole batch.  Prefilling slots
        consume their next prompt token; decoding slots feed their last
        sampled token (its KV gets written now) and emit a new one.  With
        a drafter attached, a step with at least one decoding slot runs
        the speculative variant instead."""
        if self.eng.drafter is not None and any(
                s not in self.pending for s in self.eng.running):
            return self._spec_micro_step()
        self._grow_all()
        if not self.eng.running:
            return
        self._micro_step_body()

    def _micro_step_body(self):
        eng = self.eng
        B = eng.slots.B
        toks = np.zeros((B, 1), np.int32)
        advance = np.zeros((B,), bool)
        for slot, req in eng.running.items():
            advance[slot] = True
            if slot in self.pending:
                toks[slot, 0] = req.prompt[self.pending[slot]]
            else:
                toks[slot, 0] = req.generated[-1]
        lengths = np.where(advance, eng.slots.lengths + 1,
                           eng.slots.lengths).astype(np.int32)
        dev = eng.slots.device
        logits, _ = M.decode_step_paged(
            eng.cfg, eng.params, torch.from_numpy(toks).to(dev),
            eng.slots.pool, eng.slots.tables_device(),
            torch.from_numpy(lengths).to(dev))
        self.micro_steps += 1
        eng.slots.lengths = lengths
        sampled = sample(logits).cpu().numpy()   # one transfer per step
        for slot, req in list(eng.running.items()):
            if slot in self.pending:
                self.pending[slot] += 1
                if self.pending[slot] >= len(req.prompt):
                    # last prompt token consumed: its logits are the
                    # next-token logits — prefill is complete
                    del self.pending[slot]
                    self._store_prompt(slot, req)
                    self._emit(slot, req, int(sampled[slot]))
            else:
                self._emit(slot, req, int(sampled[slot]))

    def _spec_micro_step(self):
        """One speculative verify micro-step.  Every running slot is grown
        to ``len + spec_k + 1`` first (preempting under pool pressure),
        since the verify forward writes all T = spec_k + 1 tail positions
        before the verdict is known."""
        T = self.eng.spec_k + 1
        self._grow_all(T)
        if not self.eng.running:
            return
        self._spec_body(T)

    def _spec_body(self, T: int):
        """Per decoding slot: draft up to ``min(spec_k, budget - 1)``
        tokens, then score ``[last_emitted, drafts...]`` for the whole
        batch in ONE verify forward and accept greedily on the device
        (one transfer for the batch).  Prefilling rows advance one prompt
        token (no drafts: their row reduces to the plain step).  Lengths
        are rolled back to the accepted burst, and tail blocks trimmed,
        BEFORE emitting, because a finishing emit releases the slot."""
        eng = self.eng
        k = T - 1
        B = eng.slots.B
        toks = np.zeros((B, T), np.int32)
        nd = np.zeros((B,), np.int32)
        advance = np.zeros((B,), bool)
        for slot, req in eng.running.items():
            advance[slot] = True
            if slot in self.pending:
                toks[slot, 0] = req.prompt[self.pending[slot]]
                continue
            toks[slot, 0] = req.generated[-1]
            # drafting past the remaining budget is wasted verification
            cap = min(k, req.max_new_tokens - len(req.generated) - 1)
            if cap <= 0:
                continue
            ctx = list(req.prompt) + list(req.generated)
            drafts, _ = eng.drafter.propose(slot, ctx, cap, req.temperature)
            if drafts:
                toks[slot, 1:1 + len(drafts)] = drafts
                nd[slot] = len(drafts)
        base = np.asarray(eng.slots.lengths, np.int32)
        lengths = np.where(advance, base + T, base).astype(np.int32)
        dev = eng.slots.device
        tt = torch.from_numpy(toks).to(dev)
        logits, _ = M.verify_step_paged(
            eng.cfg, eng.params, tt, eng.slots.pool,
            eng.slots.tables_device(), torch.from_numpy(lengths).to(dev))
        self.verify_steps += 1
        out, nem = spec_accept_batched(logits, tt,
                                       torch.from_numpy(nd).to(dev))
        both = torch.cat([out, nem[:, None]], dim=1).cpu().numpy()
        out, nem = both[:, :T], both[:, T]       # one transfer per step
        final = base.copy()
        for slot in eng.running:
            final[slot] = base[slot] + (1 if slot in self.pending
                                        else int(nem[slot]))
            eng.slots.trim(slot, int(final[slot]))
        eng.slots.lengths = final
        for slot, req in list(eng.running.items()):
            if slot in self.pending:
                self.pending[slot] += 1
                if self.pending[slot] >= len(req.prompt):
                    del self.pending[slot]
                    self._store_prompt(slot, req)
                    self._emit(slot, req, int(out[slot, 0]))
                continue
            n = int(nem[slot])
            emitted = 0
            for t in range(n):
                self._emit(slot, req, int(out[slot, t]))
                emitted += 1
                if req.done:
                    break       # EOS or budget mid-burst: drop the tail
            eng.metrics.speculative(int(nd[slot]), n - 1, emitted)

    # ------------------------------------------------------------ lifecycle
    def _release_drafter(self, slot: int):
        """Drop the drafter's per-slot state when the slot turns over
        (finish or preemption)."""
        if self.eng.drafter is not None:
            self.eng.drafter.release(slot)

    def _store_prompt(self, slot: int, req):
        """Index this prompt's KV blocks into the radix tree (zero-copy:
        the tree refcounts the slot's own physical block ids)."""
        if self.prefix_cache is None:
            return
        if len(req.prompt) < self.prefix_cache.block_size:
            return
        ids = self.eng.slots.block_ids(slot)
        bs = self.eng.slots.block_size
        new = self.prefix_cache.insert(req.namespace, req.prompt,
                                       lambda s, e: ids[s // bs])
        if new:
            self._locked.setdefault(req.request_id, []).extend(new)

    def _emit(self, slot: int, req, token: int):
        eng = self.eng
        req.generated.append(token)
        eng.metrics.token(req.request_id, eng.clock())
        if (token == req.eos_id
                or len(req.generated) >= req.max_new_tokens):
            req.done = True
            eng.metrics.finish(req.request_id, eng.clock())
            eng.slots.release(slot)
            eng.running.pop(slot, None)
            self.pending.pop(slot, None)
            self._admit_order.pop(slot, None)
            self._unlock(req)
            self._release_drafter(slot)
