"""Serving API types."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class PagePin:
    """Device-prefix hit handle (paged KV): the matched pool pages, pinned
    via BlockPool ref-counts between routing and admission so LRU eviction
    cannot reclaim them while the request is queued. ``seq_ids`` become the
    head of the slot's seq block table; ``snapshot`` (when the arch carries
    exact-length SWA/linear state) supplies the ring/state payload."""
    cached_len: int                    # page-aligned resumable prefix tokens
    seq_ids: List[int]                 # pinned full/MLA pages, logical order
    snapshot: Optional[object] = None  # core.prefix_cache.LinearSnapshot


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # prompt token ids (int32)
    max_new_tokens: int = 32
    home: str = ""                     # originating PD region ("" = first)
    # timeline (seconds; wall for compute, virtual for the inter-DC link)
    arrival: float = 0.0
    route: str = ""
    cached_tokens: int = 0
    prefill_s: float = 0.0
    transfer_s: float = 0.0
    kv_bytes: int = 0                  # bytes on the wire (quantized if on)
    kv_bytes_raw: int = 0              # raw cache bytes before compression
    cross_kv_bytes: float = 0.0        # cross-cluster cached-prefix copy
    ttft_s: float = 0.0
    # the core.router.RoutingDecision that placed this request (set by
    # CrossDCDeployment._route; None until routed)
    decision: Optional[object] = None
    # paged-KV device prefix hit (set when the home region resumes from
    # pool pages; pages stay ref-pinned until the request retires)
    device_pin: Optional[PagePin] = None


@dataclass
class Response:
    rid: int
    output_tokens: List[int] = field(default_factory=list)
    finished: bool = False
    # retired at the decode KV-capacity wall with generation budget left
    # (NOT a clean finish; counted in DecodeEngine.truncations)
    truncated: bool = False
