"""Metadata-only hybrid prefix cache for the cluster simulator.

Same resumable-prefix semantics as ``prefix_cache.HybridPrefixCache`` —
block-level full-attn chain matching plus request-level linear snapshots
valid only at their exact block-aligned length, sharing one LRU-evicted
block budget (paper §3.2) — exploiting a structural fact of the simulated
workload: block hashes are per-session chains, and different sessions never
share a prefix.  A chain is therefore fully described by its covered block
count plus the snapshot boundaries inserted so far, making match/insert
O(1) per *request* instead of O(blocks):

  * match(chain, n)  = largest snapshot boundary <= min(coverage, n)
    — identical to walking the per-block hash chain and then looking for
    the longest linear snapshot at or below the covered boundary;
  * eviction is LRU over whole chains.  In the real ``BlockPool`` a chain's
    blocks sit contiguously in LRU order and evicting a chain's first block
    already zeroes its matchable prefix, so whole-chain eviction yields the
    same observable hit statistics.

The live serving path (``serving.deployment``) keeps the real
``HybridPrefixCache``/``BlockPool``, which track actual KV bytes and
arbitrary cross-request block sharing.
"""
from __future__ import annotations

from bisect import bisect_right, insort
from collections import OrderedDict
from typing import List


class _PoolStats:
    """Duck-typed stand-in for ``BlockPool`` telemetry consumed by
    ``GlobalKVManager.stats`` (utilization / eviction counters)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.used = 0
        self.stats = {"allocated": 0, "evicted": 0, "freed": 0,
                      "alloc_fail": 0}

    def utilization(self) -> float:
        return self.used / max(1, self.num_blocks)

    @property
    def used_blocks(self) -> int:
        return self.used

    @property
    def resident(self) -> int:
        # the simulator's pool twin has no ref-counts: every used block is
        # resident (allocated == freed + evicted + resident holds by
        # construction)
        return self.used


class SimPrefixCache:
    """Drop-in for ``HybridPrefixCache`` inside ``PrfaasSimulator``: exposes
    ``match`` / ``insert`` keyed by (chain id, block count) with the same
    observable semantics, plus ``hit_rate`` / ``pool`` telemetry."""

    def __init__(self, num_blocks: int, block_tokens: int):
        self.block_tokens = block_tokens
        self.pool = _PoolStats(num_blocks)
        # chain id -> ascending snapshot boundaries (block counts); the last
        # entry is the chain's covered prefix length.  OrderedDict = LRU.
        self._chains: "OrderedDict[int, List[int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    # ----------------------------------------------------------------- match
    def match(self, chain: int, n_blocks: int) -> int:
        """Longest resumable cached prefix (tokens) of an ``n_blocks``-block
        request on ``chain``: full-attn blocks cover [0, b) AND a linear
        snapshot exists at a boundary <= b."""
        if n_blocks <= 0:
            return 0
        snaps = self._chains.get(chain)
        if snaps is None:
            self.misses += 1
            return 0
        covered = min(snaps[-1], n_blocks)
        i = bisect_right(snaps, covered)
        matched = snaps[i - 1] * self.block_tokens if i else 0
        self._chains.move_to_end(chain)
        if matched:
            self.hits += 1
            self.hit_tokens += matched
        else:
            self.misses += 1
        return matched

    # ---------------------------------------------------------------- insert
    def insert(self, chain: int, n_blocks: int) -> int:
        """Record the KV/state produced by a completed prefill: the chain's
        missing full-attn blocks plus one linear snapshot at ``n_blocks``.
        Each snapshot costs one extra pool block (request-level state)."""
        if n_blocks <= 0:
            return 0
        pool = self.pool
        if n_blocks + 1 > pool.num_blocks:
            pool.stats["alloc_fail"] += 1
            return 0
        snaps = self._chains.get(chain)
        added = 0
        if snaps is None:
            self._chains[chain] = [n_blocks]
            added = n_blocks + 1
        else:
            if n_blocks > snaps[-1]:
                added = n_blocks - snaps[-1] + 1
                snaps.append(n_blocks)
            elif n_blocks not in snaps:
                added = 1                         # snapshot only; blocks cached
                insort(snaps, n_blocks)
            self._chains.move_to_end(chain)
        pool.used += added
        pool.stats["allocated"] += added
        if pool.used > pool.num_blocks:
            self._evict_over()
        return n_blocks * self.block_tokens

    def _evict_over(self):
        """LRU whole-chain eviction; the insertee sits at the MRU end and is
        never evicted (len > 1 guard)."""
        pool, chains = self.pool, self._chains
        evicted = 0
        while pool.used > pool.num_blocks and len(chains) > 1:
            _, snaps = chains.popitem(last=False)
            freed = snaps[-1] + len(snaps)
            pool.used -= freed
            evicted += freed
        pool.stats["evicted"] += evicted

    # ------------------------------------------------------------- telemetry
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0
