"""Global KVCache manager (paper §3.2): cross-cluster cache metadata.

Maintains one HybridPrefixCache per cluster, computes per-cluster prefix
matches for routing, selects cache-affine nodes, and performs hotspot
rebalancing / opportunistic cross-cluster cache transfer when bandwidth is
abundant (§3.4.3 "bandwidth is abundant" branch).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.blockpool import BlockPool
from repro_torch.core.prefix_cache import HybridPrefixCache, token_block_hashes


@dataclass
class MatchInfo:
    cluster: str
    matched_tokens: int


class GlobalKVManager:
    def __init__(self):
        self.clusters: Dict[str, HybridPrefixCache] = {}
        self.node_affinity: Dict[str, int] = {}   # cluster -> node count
        self.rebalanced = 0
        self.cross_transfers = 0

    def register_cluster(self, name: str, cache: HybridPrefixCache,
                         nodes: int = 1):
        self.clusters[name] = cache
        self.node_affinity[name] = nodes

    # ------------------------------------------------------------- matching
    def match_all(self, tokens: Sequence[int],
                  names: Optional[Sequence[str]] = None) -> Dict[str, int]:
        """Paper: 'computes prefix-match information for every cluster'.

        ``names`` optionally restricts the match to reachable clusters (the
        live deployment filters by link topology)."""
        if names is None:
            names = self.clusters.keys()
        return {name: self.clusters[name].match(tokens)
                for name in names if name in self.clusters}

    def best_match(self, tokens: Sequence[int]) -> MatchInfo:
        matches = self.match_all(tokens)
        best = max(matches.items(), key=lambda kv: kv[1])
        return MatchInfo(cluster=best[0], matched_tokens=best[1])

    # ----------------------------------------------------- affinity routing
    def affine_node(self, cluster: str, tokens: Sequence[int],
                    block_tokens: int = 64) -> int:
        """Cache-affine node within a cluster: consistent hash of the first
        prefix block so same-prefix requests co-locate."""
        n = self.node_affinity.get(cluster, 1)
        hashes = token_block_hashes(tokens[:block_tokens], block_tokens)
        key = hashes[0] if hashes else hash(tuple(tokens[:8]))
        return key % max(1, n)

    # ------------------------------------------------------------ lifecycle
    def record_prefill(self, cluster: str, tokens: Sequence[int]) -> int:
        return self.clusters[cluster].insert(tokens)

    def rebalance(self, tokens: Sequence[int], src: str, dst: str) -> bool:
        """Replicate a hot prefix into another cluster (cache rebalancing /
        cross-cluster cache transfer). Returns True if dst now caches it."""
        if self.clusters[src].match(tokens) == 0:
            return False
        inserted = self.clusters[dst].insert(tokens)
        if inserted:
            self.cross_transfers += 1
        return inserted > 0

    def stats(self) -> dict:
        return {name: {"hit_rate": c.hit_rate(),
                       "pool_util": c.pool.utilization(),
                       "evicted": c.pool.stats["evicted"],
                       "pool": {**c.pool.stats,
                                "resident": c.pool.resident,
                                "used_blocks": c.pool.used_blocks,
                                "num_blocks": c.pool.num_blocks}}
                for name, c in self.clusters.items()}
