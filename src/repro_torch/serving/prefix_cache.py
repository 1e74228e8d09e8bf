"""Radix-tree prefix cache over token-block chunks (the port's copy of the
reference's ``serving/prefix_cache.py``, paged path).

Prompts that share a prefix (system prompts, few-shot headers, multi-turn
history) reuse the KV blocks a previous prefill already wrote, so only
the uncached suffix is computed.  The index is a trie whose edges are
fixed-size token blocks; on the paged path a node's payload is the
physical pool block holding that block's KV.

- **Exactness.** For causal attention, K/V at position *i* depend only
  on tokens ``0..i``, so a stored block is valid KV for any prompt that
  shares the token prefix up to that block.
- **Namespaces.** Trees are per namespace, so tenants never share KV.
- **Ref-counting + LRU eviction.** Nodes on a path in use by an
  in-flight request are pinned (``refs > 0``); eviction takes unpinned
  leaves in least-recently-used order.  Capacity is a dedicated
  :class:`~repro_torch.serving.kvcache.BlockLedger` (one block per node).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Sequence, Tuple

from repro_torch.serving.kvcache import BlockLedger


def supports_prefix_cache(cfg) -> bool:
    """True iff every cache leaf is position-sliceable along the sequence
    (the same architecture class that can page its KV)."""
    from repro_torch.models import model as M
    return M.supports_paged_cache(cfg)


# ------------------------------------------------------------------ the tree
class _Node:
    __slots__ = ("block", "seg", "children", "parent", "refs", "last_use",
                 "namespace", "node_id")

    def __init__(self, block: Tuple[int, ...], seg, parent: "_Node | None",
                 namespace: str, node_id: int):
        self.block = block
        self.seg = seg
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.refs = 0
        self.last_use = 0
        self.namespace = namespace
        self.node_id = node_id

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_Node(id={self.node_id}, refs={self.refs}, "
                f"children={len(self.children)})")


class Match:
    """Result of a longest-prefix lookup: the matched node path."""
    __slots__ = ("namespace", "nodes", "length")

    def __init__(self, namespace: str, nodes: List[_Node], length: int):
        self.namespace = namespace
        self.nodes = nodes
        self.length = length


class PrefixCache:
    """Block-chunked radix tree of reusable KV prefixes.

    Capacity is ``capacity_tokens`` rounded down to whole blocks;
    accounting goes through a dedicated :class:`BlockLedger` so eviction
    behaves exactly like admission under memory pressure.  A node's
    payload (``seg``) is whatever ``insert``'s ``extract`` returns; the
    paged subclass stores a physical block id.
    """

    def __init__(self, *, block_size: int = 16,
                 capacity_tokens: int = 4096):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.block_size = block_size
        self.ledger = BlockLedger(capacity_tokens, block_size)
        self.roots: Dict[str, _Node] = {}
        self._clock = itertools.count(1)
        self._ids = itertools.count()
        # stats
        self.queries = 0
        self.hit_queries = 0
        self.hit_tokens = 0
        self.evicted_nodes = 0

    # ------------------------------------------------------------ helpers
    def _root(self, namespace: str) -> _Node:
        root = self.roots.get(namespace)
        if root is None:
            root = _Node((), None, None, namespace, next(self._ids))
            self.roots[namespace] = root
        return root

    def _blocks(self, tokens: Sequence[int]):
        bs = self.block_size
        for i in range(len(tokens) // bs):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    @property
    def n_nodes(self) -> int:
        return len(self.ledger.used)

    @property
    def cached_tokens(self) -> int:
        return self.n_nodes * self.block_size

    # ------------------------------------------------------------ lookup
    def match(self, namespace: str, tokens: Sequence[int],
              peek: bool = False) -> Match:
        """Longest-prefix match in whole blocks.

        ``peek=True`` skips LRU/stat updates (used by affinity routing so
        probes don't pin recency).
        """
        root = self.roots.get(namespace)
        nodes: List[_Node] = []
        node = root
        if node is not None:
            for block in self._blocks(tokens):
                child = node.children.get(block)
                if child is None:
                    break
                nodes.append(child)
                node = child
        length = len(nodes) * self.block_size
        if not peek:
            self.queries += 1
            if nodes:
                self.hit_queries += 1
                self.hit_tokens += length
                tick = next(self._clock)
                for n in nodes:
                    n.last_use = tick
        return Match(namespace, nodes, length)

    def match_len(self, namespace: str, tokens: Sequence[int]) -> int:
        return self.match(namespace, tokens, peek=True).length

    # ------------------------------------------------------------ pinning
    def lock(self, nodes: Sequence[_Node]):
        for n in nodes:
            n.refs += 1

    def unlock(self, nodes: Sequence[_Node]):
        for n in nodes:
            n.refs = max(0, n.refs - 1)

    # ------------------------------------------------------------ insert
    def insert(self, namespace: str, tokens: Sequence[int],
               extract: Callable[[int, int], Any]) -> List[_Node]:
        """Store the whole-block prefix of ``tokens``.

        ``extract(start, end)`` must return the KV segment for prompt
        positions ``[start, end)`` (the scheduler slices it out of the
        request's slot).  Existing nodes are deduplicated; only missing
        blocks are extracted.  Under ledger pressure, unpinned LRU leaves
        are evicted; if nothing is evictable the insert stops early
        (keeping the stored path a valid contiguous prefix).  Returns
        the newly created nodes, already pinned once for the caller.
        """
        node = self._root(namespace)
        created: List[_Node] = []
        tick = next(self._clock)
        # the path being extended must never be an eviction victim: evicting
        # the leaf we are about to hang a child off would orphan the child
        # (unreachable from the root) while it still holds a ledger block
        path_ids = {node.node_id}
        for i, block in enumerate(self._blocks(tokens)):
            child = node.children.get(block)
            if child is None:
                if (self.ledger.free_blocks < 1
                        and not self._evict_one(exclude=path_ids)):
                    break
                start = i * self.block_size
                seg = extract(start, start + self.block_size)
                child = _Node(block, seg, node, namespace, next(self._ids))
                child.refs = 1
                node.children[block] = child
                self.ledger.admit(f"pfx{child.node_id}", self.block_size)
                self._on_store(child)
                created.append(child)
            child.last_use = tick
            path_ids.add(child.node_id)
            node = child
        return created

    # ------------------------------------------------------ payload hooks
    def _on_store(self, node: _Node):
        """Called once per newly stored node (payload already in
        ``node.seg``).  The paged subclass ref-bumps the block pool."""

    def _release_payload(self, node: _Node):
        """Called when a node is evicted, before its payload is dropped.
        The paged subclass returns the physical block to the pool."""

    # ------------------------------------------------------------ eviction
    def _evictable(self, exclude=frozenset()) -> List[_Node]:
        out = []
        for root in self.roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                if n.children:
                    stack.extend(n.children.values())
                elif n.refs == 0 and n.node_id not in exclude:
                    out.append(n)
        return out

    def _evict_one(self, exclude=frozenset()) -> bool:
        cands = self._evictable(exclude)
        if not cands:
            return False
        victim = min(cands, key=lambda n: n.last_use)
        victim.parent.children.pop(victim.block, None)
        self.ledger.release(f"pfx{victim.node_id}")
        self._release_payload(victim)
        victim.seg = None
        self.evicted_nodes += 1
        return True

    def evict(self, n_blocks: int) -> int:
        """Evict up to ``n_blocks`` unpinned LRU leaves; returns count."""
        done = 0
        while done < n_blocks and self._evict_one():
            done += 1
        return done

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        return {
            "nodes": self.n_nodes,
            "cached_tokens": self.cached_tokens,
            "capacity_tokens": self.ledger.total_blocks * self.block_size,
            "queries": self.queries,
            "hit_queries": self.hit_queries,
            "hit_tokens": self.hit_tokens,
            "evicted_nodes": self.evicted_nodes,
        }


# ------------------------------------------------------------------ paged
class PagedPrefixCache(PrefixCache):
    """Radix tree whose node payload is a *physical block id* into a
    shared :class:`~repro_torch.serving.kvcache.BlockPool` — the
    zero-copy prefix cache of the paged KV path.

    Storing a prompt block is a refcount bump on the block the request
    already prefilled; serving a hit is a refcount bump + table splice
    into the new request's block table.  No KV tensor is copied in either
    direction.
    Evicting a node drops the tree's reference; the block returns to the
    pool only once no running request shares it.

    The ``extract`` callable passed to :meth:`PrefixCache.insert` must
    return the prompt's physical block id for positions ``[start, end)``
    (the scheduler reads it off the slot's block table).  Tree size is
    still budgeted through the base ledger so the cache cannot pin the
    whole pool; pool pressure additionally evicts on demand via
    ``evict``/``evictable_blocks``.
    """

    def __init__(self, pool, *, block_size: int = 16,
                 capacity_tokens: int = 4096):
        super().__init__(block_size=block_size,
                         capacity_tokens=capacity_tokens)
        self.pool = pool

    def _on_store(self, node):
        self.pool.incref([node.seg])

    def _release_payload(self, node):
        self.pool.decref([node.seg])

    def gather_block_ids(self, match: Match, n_blocks: int) -> List[int]:
        """Physical block ids for the first ``n_blocks`` matched blocks."""
        if not 0 < n_blocks <= len(match.nodes):
            raise ValueError(f"n_blocks {n_blocks} outside "
                             f"(0, {len(match.nodes)}]")
        return [n.seg for n in match.nodes[:n_blocks]]

    def evictable_blocks(self) -> int:
        """How many pool blocks eviction could release right now (upper
        bound: a block shared with a running request frees nothing)."""
        return len(self._evictable())
