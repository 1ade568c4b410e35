"""Unified KV block pool (paper §3.2, Fig. 4).

The pool is the allocation authority for KV blocks. Full-attn/MLA/SWA
KVCache groups allocate fixed-size *device pages* from it when the paged
layout is on (``DeploymentConfig(paged_kv=True)``); linear-state groups
allocate metadata blocks for their request-level snapshots. With the paged
layout off the pool still runs the same lifecycle purely as a byte-accounting
twin of the dense buffers. Blocks are ref-counted and carry a category:

  * prefix-cache blocks — reusable across requests once fully populated;
    evictable LRU when free space runs out;
  * transfer-cache blocks — tail KVCache produced for PD-disaggregated
    transfer; discarded as soon as the transfer completes (never reused).
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

PREFIX = "prefix"
TRANSFER = "transfer"


@dataclass
class Block:
    block_id: int
    category: str = PREFIX
    ref_count: int = 0
    populated: bool = False      # prefix blocks reusable only when full
    key: Optional[int] = None    # content hash (prefix chain)


class BlockPool:
    """Ref-counted block pool with LRU eviction of unreferenced prefix blocks."""

    def __init__(self, num_blocks: int, block_tokens: int = 64,
                 block_bytes: int = 0):
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.block_bytes = block_bytes
        self._free = list(range(num_blocks - 1, -1, -1))
        self._blocks = {}
        # unreferenced-but-cached prefix blocks, LRU order
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.stats = {"allocated": 0, "evicted": 0, "freed": 0,
                      "alloc_fail": 0}

    # ------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    @property
    def resident(self) -> int:
        """Blocks with live metadata: ref-held or cached (LRU). Conservation
        invariant: ``allocated == freed + evicted + resident``."""
        return len(self._blocks)

    def utilization(self) -> float:
        return self.used_blocks / max(1, self.num_blocks)

    def get(self, block_id: int) -> Block:
        return self._blocks[block_id]

    # ----------------------------------------------------------- lifecycle
    def allocate(self, n: int, category: str = PREFIX):
        """Allocate n blocks (evicting LRU prefix blocks if needed).

        Returns list of block ids, or None if pool cannot satisfy.
        """
        if n > self.free_blocks:
            self.stats["alloc_fail"] += 1
            return None
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            bid = self._free.pop()
            self._blocks[bid] = Block(bid, category=category, ref_count=1)
            out.append(bid)
        self.stats["allocated"] += n
        return out

    def _evict_one(self):
        bid, _ = self._lru.popitem(last=False)
        self._blocks.pop(bid, None)
        self._free.append(bid)
        self.stats["evicted"] += 1

    def retain(self, block_ids):
        for bid in block_ids:
            b = self._blocks[bid]
            if b.ref_count == 0:
                self._lru.pop(bid, None)
            b.ref_count += 1

    def release(self, block_ids):
        """Drop a reference. Transfer blocks free immediately at rc=0;
        prefix blocks stay cached (LRU) if populated, else free."""
        for bid in block_ids:
            b = self._blocks.get(bid)
            if b is None:
                continue
            b.ref_count -= 1
            assert b.ref_count >= 0, f"double free of block {bid}"
            if b.ref_count == 0:
                if b.category == TRANSFER or not b.populated:
                    self._blocks.pop(bid)
                    self._free.append(bid)
                    self.stats["freed"] += 1
                else:
                    self._lru[bid] = None   # cached, evictable

    def touch(self, block_ids):
        """LRU refresh for cached blocks on a prefix hit."""
        for bid in block_ids:
            if bid in self._lru:
                self._lru.move_to_end(bid)

    def mark_populated(self, block_ids, keys=None):
        for i, bid in enumerate(block_ids):
            b = self._blocks[bid]
            b.populated = True
            if keys is not None:
                b.key = keys[i]

    # ------------------------------------------------------------ invariants
    def check_invariants(self):
        ref = sum(1 for b in self._blocks.values() if b.ref_count > 0)
        cached = len(self._lru)
        free = len(self._free)
        assert ref + cached + free == self.num_blocks, \
            (ref, cached, free, self.num_blocks)
        assert all(self._blocks[b].ref_count == 0 for b in self._lru)
        return True
