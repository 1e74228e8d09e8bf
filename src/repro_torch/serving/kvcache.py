"""KV-cache storage and block accounting for the serving engine (the
paged path of the reference's ``serving/kvcache.py``).

``BlockPool`` + ``PagedCacheSlots``: one shared physical pool of
``block_size``-token blocks (``M.make_paged_pool``) plus per-slot block
tables.  Blocks are allocated on demand and ref-counted, so memory tracks
actual sequence lengths and the radix prefix cache shares physical blocks
with running requests instead of copying KV.  ``BlockLedger`` is the
node budget of the prefix cache.  The pool holds bf16 K/V, or int8 codes
with float32 per-(block, KV head) scales (``kv_dtype="int8"``).  The
dense per-slot layout and the KV hand-off are not ported yet.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import INV_127

NULL_BLOCK = 0   # reserved physical block: writes from inert slots and
                 # reads past a sequence's length land here, never on data


class BlockLedger:
    """Budget accounting in ``block_size``-token blocks: the prefix cache's
    node budget (one block per stored node).

    - Reservations are **rid-keyed and idempotent**: ``admit`` counts the
      blocks ``rid`` already holds toward its allowance.
    - **Never over-commits**: ``admit`` raises once the budget is spent
      rather than handing out blocks that do not exist.
    - ``release`` is unconditional and forgets the rid entirely.
    """

    def __init__(self, capacity_tokens: int, block_size: int = 128):
        self.block_size = block_size
        self.total_blocks = capacity_tokens // block_size
        self.used: Dict[str, int] = {}

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        return self.total_blocks - sum(self.used.values())

    def admit(self, rid: str, tokens: int):
        need = self.blocks_for(tokens)
        if need > self.free_blocks + self.used.get(rid, 0):
            raise RuntimeError("KV cache exhausted")
        self.used[rid] = need

    def release(self, rid: str):
        self.used.pop(rid, None)


class BlockPool:
    """Ref-counted allocator over the physical blocks of a paged pool.

    One block id spans every layer leaf of the pool (see
    ``M.make_paged_pool``), so allocation is accounted in token blocks,
    not per-layer bytes.  Invariants:

    - **Null block**: block 0 is reserved and never allocated.  Inert
      decode slots scatter their (masked) writes there and block-table
      tails point there; the attention length mask guarantees it is
      never *read*, so no live KV can be corrupted by an idle slot.
    - **Refcount lifecycle**: ``alloc`` hands out ids at refcount 1
      (all-or-nothing for multi-block requests); ``incref`` adds holders
      — the radix prefix tree (one ref per stored node) and every
      running request that adopted the block via a prefix hit;
      ``decref`` frees a block only at refcount 0.  Consequence: tree
      eviction never invalidates a running request, and slot release
      never invalidates the tree.
    - **Shared blocks are read-only by construction**: the tree stores
      only whole prompt blocks, and a sequence writes strictly after its
      adopted prefix, in blocks it allocated privately — so a refcount
      > 1 block is never written.
    - ``incref``/``decref`` on an unallocated id raise — refcount bugs
      surface immediately instead of corrupting the free list.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("pool needs at least one allocatable block")
        self.num_blocks = num_blocks
        self.free: Deque[int] = deque(range(1, num_blocks))
        self.refs: Dict[int, int] = {}
        self.peak_used = 0

    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - len(self.free)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Allocate ``n`` blocks (refcount 1 each), all-or-nothing."""
        if n > len(self.free):
            return None
        ids = [self.free.popleft() for _ in range(n)]
        for b in ids:
            self.refs[b] = 1
        self.peak_used = max(self.peak_used, self.num_used)
        return ids

    def incref(self, ids: Sequence[int]):
        for b in ids:
            if b not in self.refs:
                raise ValueError(f"incref on unallocated block {b}")
            self.refs[b] += 1

    def decref(self, ids: Sequence[int]) -> int:
        """Drop one reference per id; returns how many blocks were freed."""
        freed = 0
        for b in ids:
            r = self.refs.get(b)
            if r is None:
                raise ValueError(f"decref on unallocated block {b}")
            if r > 1:
                self.refs[b] = r - 1
            else:
                del self.refs[b]
                self.free.append(b)
                freed += 1
        return freed


class PagedCacheSlots:
    """``max_batch`` block-table rows (one per decode slot) over a shared
    :class:`BlockPool` of ``pool_tokens // block_size`` physical blocks,
    with the pool as torch tensors on ``device``.

    - memory tracks actual lengths: short sequences hold few blocks;
    - a prefix-cache hit is a table splice + refcount bump
      (``adopt_prefix``) — no KV bytes move in either direction;
    - growth is a real allocation (``ensure_capacity``), so running out
      of blocks is an explicit event the scheduler answers with tree
      eviction or preemption, never a silent over-commit.

    ``kv_dtype="int8"`` stores int8 codes plus per-(block, KV head)
    float32 scales (``M.make_quantized_paged_pool``); ``pool_tokens`` is
    then a bf16-byte budget and buys twice the blocks, and prefill K/V is
    quantized per block as it is inserted.

    Slot invariants: an inert slot has ``lengths[slot] == 1`` and a table
    row of ``NULL_BLOCK`` entries, so its decode-step writes land in the
    null block and its reads are masked out; ``release`` decrefs exactly
    the blocks in ``seq_blocks[slot]`` and resets the table row.
    ``tables_device`` caches the device copy of the table matrix and every
    table mutation invalidates it, so a micro-step uploads tables at most
    once.
    """

    def __init__(self, cfg: ModelConfig, max_batch: int, capacity: int,
                 dtype=torch.bfloat16, block_size: int = 16,
                 pool_tokens: Optional[int] = None, device=None,
                 kv_dtype: str = "bf16"):
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        self.cfg = cfg
        self.B = max_batch
        self.capacity = capacity
        self.block_size = block_size
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.blocks_per_seq = -(-capacity // block_size)
        pool_tokens = (max_batch * capacity if pool_tokens is None
                       else pool_tokens)
        if kv_dtype == "int8":
            # int8 blocks cost half the bytes of bf16 ones: the same
            # budget buys twice the physical blocks
            num_blocks = 1 + max((pool_tokens * 2) // block_size,
                                 self.blocks_per_seq)
            self.pool = M.make_quantized_paged_pool(cfg, num_blocks,
                                                    block_size, self.device)
        else:
            num_blocks = 1 + max(pool_tokens // block_size,
                                 self.blocks_per_seq)
            self.pool = M.make_paged_pool(cfg, num_blocks, block_size,
                                          dtype, self.device)
        self.bp = BlockPool(num_blocks)
        self.tables = np.full((max_batch, self.blocks_per_seq), NULL_BLOCK,
                              np.int32)
        self.lengths = np.ones((max_batch,), np.int32)  # 1 = inert slot
        self.seq_blocks: Dict[int, List[int]] = {}
        self.free: Deque[int] = deque(range(max_batch))
        self.slot_owner: Dict[int, str] = {}
        self._tables_dev: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ tables
    def tables_device(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self.tables.copy()).to(
                self.device)
        return self._tables_dev

    def _touch_tables(self):
        self._tables_dev = None

    # ------------------------------------------------------------ slots
    def allocate(self, rid: str) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.popleft()
        self.slot_owner[slot] = rid
        return slot

    def release(self, slot: int):
        self.slot_owner.pop(slot, None)
        ids = self.seq_blocks.pop(slot, [])
        if ids:
            self.bp.decref(ids)
        self.tables[slot, :] = NULL_BLOCK
        self._touch_tables()
        self.lengths[slot] = 1
        self.free.append(slot)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self.slot_owner)

    # ------------------------------------------------------------ blocks
    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def ensure_capacity(self, slot: int, new_len: int) -> bool:
        """Allocate blocks so positions ``[0, new_len)`` are addressable.
        False when the pool cannot supply them (caller reclaims/preempts)."""
        have = self.seq_blocks.setdefault(slot, [])
        need = self.blocks_for(new_len)
        if need <= len(have):
            return True
        if need > self.blocks_per_seq:
            return False
        ids = self.bp.alloc(need - len(have))
        if ids is None:
            return False
        self.tables[slot, len(have):need] = ids
        have.extend(ids)
        self._touch_tables()
        return True

    def adopt_prefix(self, slot: int, ids: Sequence[int], length: int):
        """Copy-free prefix hit: splice shared physical blocks into this
        slot's table (refcount bump — the blocks themselves never move)."""
        if length != len(ids) * self.block_size:
            raise ValueError("adopt_prefix takes whole blocks only")
        if self.seq_blocks.get(slot):
            raise ValueError("adopt_prefix needs a fresh slot")
        self.bp.incref(ids)
        self.seq_blocks[slot] = list(ids)
        self.tables[slot, :len(ids)] = ids
        self._touch_tables()
        self.lengths[slot] = length

    def block_ids(self, slot: int) -> List[int]:
        return list(self.seq_blocks.get(slot, []))

    def trim(self, slot: int, length: int):
        """Roll back a speculative over-allocation: decref blocks past
        ``blocks_for(length)`` and null their table entries.  A verify
        step writes spec_k + 1 tail positions before accept/reject, so
        the scheduler grows every slot up front and trims back to the
        accepted length here.  Shared prefix blocks lie before any length
        a slot shrinks to, so only private tail blocks are freed."""
        have = self.seq_blocks.get(slot)
        if not have:
            return
        keep = self.blocks_for(max(int(length), 1))
        if keep >= len(have):
            return
        extra = have[keep:]
        del have[keep:]
        self.bp.decref(extra)
        self.tables[slot, keep:keep + len(extra)] = NULL_BLOCK
        self._touch_tables()

    # ------------------------------------------------------------ prefill
    def insert_prefill(self, slot: int, prefill_cache, length: int):
        """Scatter a single-sequence prefill cache (leaves (L, 1, S, KV,
        hd)) for positions ``[0, length)`` into the slot's (already
        allocated) blocks.  Unlike the reference, which returns an updated
        copy of the pool, this writes the pool in place on the device.
        The last block also receives the prefill's padding positions (or
        zeros past S), as in the reference; attention masks them.  An
        int8 pool gets each block quantized with one symmetric scale per
        (block, KV head) over its positions and head dims, padding
        included: ``clip(round(x / max(s, 1e-12)), -127, 127)`` with
        ``s = max|x| * INV_127``, the reference's codes and scales."""
        nblk = self.blocks_for(length)
        ids = self.seq_blocks.get(slot, [])
        if len(ids) < nblk:
            raise ValueError("ensure_capacity() before insert_prefill()")
        idx = torch.as_tensor(ids[:nblk], dtype=torch.long,
                              device=self.device)
        span = nblk * self.block_size
        stack = self.pool["stack"]
        for name in ("k", "v"):
            dst = stack[name]
            src = prefill_cache["stack"][name][:, 0]       # (L, S, KV, hd)
            n = min(src.shape[1], span)
            buf = torch.zeros((dst.shape[0], span) + dst.shape[3:],
                              dtype=torch.float32 if self.kv_dtype == "int8"
                              else dst.dtype, device=dst.device)
            buf[:, :n] = src[:, :n]
            buf = buf.reshape(dst.shape[0], nblk, self.block_size,
                              *dst.shape[3:])
            if self.kv_dtype == "int8":
                s_kd = buf.abs().amax(dim=(2, 4), keepdim=True) * INV_127
                buf = torch.clamp(torch.round(
                    buf / torch.clamp(s_kd, min=1e-12)), -127, 127)
                stack[name + "_scale"][:, idx] = s_kd[:, :, 0, :, 0]
            dst[:, idx] = buf.to(dst.dtype)
        self.lengths[slot] = length
