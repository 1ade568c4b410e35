"""Hybrid prefix cache pool (paper §3.2, Fig. 4).

Two KVCache group kinds share the unified BlockPool:

  * ``FullAttnGroup`` — block-level KVCache: grows with length, supports
    *partial* prefix matching (longest chain of block-hash matches).
  * ``LinearStateGroup`` — request-level recurrent states: O(1) size,
    reusable only when the cached length matches the new request's prefix
    *exactly* (states are snapshotted at block-aligned lengths).

For a hybrid model the resumable prefix is the longest block-aligned length
covered by BOTH groups — full-attn blocks give the KV, the linear snapshot
gives the recurrent state. For attention-only models it is the block match;
for pure-SSM models the snapshot match.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.blockpool import PREFIX, TRANSFER, BlockPool


def token_block_hashes(tokens: Sequence[int], block_tokens: int) -> List[int]:
    """Chained hashes, one per full block: h_i = H(h_{i-1}, block_i)."""
    out = []
    h = 0
    n_full = len(tokens) // block_tokens
    for i in range(n_full):
        blk = tuple(tokens[i * block_tokens:(i + 1) * block_tokens])
        h = hash((h,) + blk) & 0x7FFFFFFFFFFFFFFF
        out.append(h)
    return out


class FullAttnGroup:
    """Block-level prefix index: chain-hash -> block id."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.index: Dict[int, int] = {}          # chain hash -> block id

    def match(self, hashes: Sequence[int]) -> List[int]:
        """Longest prefix of block ids present (populated blocks only)."""
        out = []
        for h in hashes:
            bid = self.index.get(h)
            if bid is None:
                break
            blk = self.pool._blocks.get(bid)
            if blk is None or not blk.populated:
                del self.index[h]
                break
            out.append(bid)
        self.pool.touch(out)
        return out

    def insert(self, hashes: Sequence[int], block_ids: Sequence[int]):
        """Register populated prefix blocks under their chain hashes."""
        self.pool.mark_populated(list(block_ids), keys=list(hashes))
        for h, bid in zip(hashes, block_ids):
            self.index[h] = bid

    def gc(self):
        dead = [h for h, bid in self.index.items()
                if bid not in self.pool._blocks]
        for h in dead:
            del self.index[h]


@dataclass
class LinearSnapshot:
    length: int                   # block-aligned prefix length
    chain_hash: int
    block_ids: List[int]          # pool blocks holding the state bytes
    payload: Optional[object] = None   # device state (SWA ring + linear leaves)


class LinearStateGroup:
    """Request-level state snapshots: exact-length prefix reuse."""

    def __init__(self, pool: BlockPool, state_bytes: int):
        self.pool = pool
        self.state_bytes = state_bytes
        self.blocks_per_state = max(1, -(-state_bytes // max(1, pool.block_bytes))
                                    if pool.block_bytes else 1)
        self.index: Dict[int, LinearSnapshot] = {}   # chain hash -> snapshot

    def match(self, hashes: Sequence[int]) -> Optional[LinearSnapshot]:
        """Longest exact snapshot at any block boundary of the new prefix."""
        for i in range(len(hashes) - 1, -1, -1):
            snap = self.index.get(hashes[i])
            if snap is not None:
                alive = all(b in self.pool._blocks for b in snap.block_ids)
                if alive:
                    self.pool.touch(snap.block_ids)
                    return snap
                del self.index[hashes[i]]
        return None

    def insert(self, length: int, chain_hash: int,
               payload: Optional[object] = None) -> Optional[LinearSnapshot]:
        if chain_hash in self.index:
            snap = self.index[chain_hash]
            if payload is not None and snap.payload is None:
                snap.payload = payload
            return snap
        bids = self.pool.allocate(self.blocks_per_state, PREFIX)
        if bids is None:
            return None
        self.pool.mark_populated(bids)
        snap = LinearSnapshot(length, chain_hash, bids, payload=payload)
        self.index[chain_hash] = snap
        self.pool.release(bids)            # cached (LRU), not pinned
        return snap


class HybridPrefixCache:
    """One per cluster: the paper's hybrid prefix cache pool."""

    def __init__(self, pool: BlockPool, kv_bytes_per_token_block: int,
                 linear_state_bytes: int, has_full_attn: bool = True,
                 has_linear: bool = True):
        self.pool = pool
        self.block_tokens = pool.block_tokens
        self.full = FullAttnGroup(pool) if has_full_attn else None
        self.linear = (LinearStateGroup(pool, linear_state_bytes)
                       if has_linear else None)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    # ----------------------------------------------------------------- match
    def match(self, tokens: Sequence[int]) -> int:
        """Longest *resumable* cached prefix length (tokens)."""
        return self.match_hashes(token_block_hashes(tokens, self.block_tokens))

    def match_hashes(self, hashes: Sequence[int]) -> int:
        """Hash-chain variant (simulator fast path).

        Resumable = full-attn blocks cover [0, b) AND (for hybrid models) a
        linear state snapshot exists at exactly b.
        """
        if not hashes:
            return 0
        if self.full is not None:
            covered_blocks = len(self.full.match(hashes))
        else:
            covered_blocks = len(hashes)
        if self.linear is None:
            matched = covered_blocks * self.block_tokens
        else:
            snap = self.linear.match(hashes[:covered_blocks])
            matched = 0 if snap is None else min(
                snap.length, covered_blocks * self.block_tokens)
        if matched:
            self.hits += 1
            self.hit_tokens += matched
        else:
            self.misses += 1
        return matched

    def match_resume(self, tokens: Sequence[int], *,
                     require_payload: bool = True
                     ) -> Tuple[int, List[int], Optional[LinearSnapshot]]:
        """Device-resumable prefix: ``(cached_len, seq_page_ids, snapshot)``.

        Unlike :meth:`match` (routing metadata), this returns the actual
        page handles a paged `DecodeEngine` can resume from. The cached
        length is capped at the last *full* page strictly before the prompt
        end so at least the final token is always recomputed (its logits
        seed decode). For models whose resume needs an exact-length state
        (SWA ring / linear mixers — ``has_linear``), a snapshot carrying a
        device payload must exist at exactly the cached length; otherwise
        the hit degrades to a miss. Does not touch hit/miss counters (the
        routing-level ``match`` already accounts those); the caller must
        ``pool.retain`` the returned ids to pin them.
        """
        L = len(tokens)
        hashes = token_block_hashes(tokens, self.block_tokens)
        max_blocks = max(0, (L - 1) // self.block_tokens)
        hashes = hashes[:max_blocks]
        if not hashes:
            return 0, [], None
        if self.full is not None:
            ids = self.full.match(hashes)
            covered = len(ids)
        else:
            ids = []
            covered = len(hashes)
        if covered == 0:
            return 0, [], None
        if self.linear is None:
            return covered * self.block_tokens, ids, None
        snap = self.linear.match(hashes[:covered])
        if snap is None or (require_payload and snap.payload is None):
            return 0, [], None
        c = min(snap.length, covered * self.block_tokens)
        if c != snap.length:
            # exact-length state does not cover the full-attn match; the
            # state is only valid at snap.length, so no resumable prefix
            return 0, [], None
        return c, ids[:c // self.block_tokens], snap

    def insert_device(self, tokens: Sequence[int], seq_ids: Sequence[int] = (),
                      snapshot_payload: Optional[object] = None) -> int:
        """Register *device* pages holding a prompt's prefix.

        ``seq_ids``: ref-held pool pages (one per full prompt page, in
        order) that a paged DecodeEngine wrote the full-attn/MLA KV into;
        indexed under the chain hashes so later requests can resume from
        them. ``snapshot_payload``: exact-length device state (SWA ring +
        linear leaves) — only registered when the prompt length is
        page-aligned, because prefill yields the state at exactly L.
        Caller keeps its refs; pages become LRU-cached when those drop.
        """
        hashes = token_block_hashes(tokens, self.block_tokens)
        if not hashes:
            return 0
        cached = 0
        if self.full is not None and seq_ids:
            n = min(len(hashes), len(seq_ids))
            self.full.insert(hashes[:n], list(seq_ids)[:n])
            cached = n * self.block_tokens
        if (self.linear is not None and snapshot_payload is not None
                and len(tokens) % self.block_tokens == 0):
            snap = self.linear.insert(len(hashes) * self.block_tokens,
                                      hashes[-1], payload=snapshot_payload)
            if snap is not None and self.full is None:
                cached = max(cached, snap.length)
        return cached

    # ---------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int]) -> int:
        return self.insert_hashes(token_block_hashes(tokens,
                                                     self.block_tokens))

    def insert_hashes(self, hashes: Sequence[int]) -> int:
        """Record the KV/state produced by a completed prefill.

        Allocates prefix blocks for the full-attn KV and one linear snapshot
        at the final block boundary. Returns cached length (tokens); 0 if the
        pool was too full.
        """
        if not hashes:
            return 0
        cached = 0
        if self.full is not None:
            have = self.full.match(hashes)
            need = len(hashes) - len(have)
            if need > 0:
                bids = self.pool.allocate(need, PREFIX)
                if bids is None:
                    return 0
                self.full.insert(hashes[len(have):], bids)
                self.pool.release(bids)        # cached, evictable
            cached = len(hashes) * self.block_tokens
        if self.linear is not None:
            snap = self.linear.insert(len(hashes) * self.block_tokens,
                                      hashes[-1])
            if snap is not None:
                cached = max(cached, snap.length) if self.full is None \
                    else cached
        return cached

    # ------------------------------------------------------------- transfer
    def allocate_transfer(self, n_tokens: int) -> Optional[List[int]]:
        """Transfer-cache blocks for the tail KV of a PD-disaggregated
        prefill; discarded via ``release_transfer`` when the wire is done."""
        n = -(-n_tokens // self.block_tokens)
        return self.pool.allocate(n, TRANSFER)

    def release_transfer(self, block_ids: List[int]):
        self.pool.release(block_ids)

    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0
