"""Paged decode-cache layout: BlockPool pages as the real device KV.

Counterpart of ``src/repro/models/paged.py``.  The dense per-slot
``(num_slots, capacity, ...)`` decode buffers become shared page pools
addressed through per-slot block tables:

  * full attention:  ``k`` / ``v`` pools ``(R, Hkv, P, T, D)``
  * MLA latents:     ``ckv`` ``(R, P, T, rank)``, ``kpe`` ``(R, P, T, rope)``
  * SWA attention:   the same ``k`` / ``v`` pool leaves, addressed through
    a ring table (the ring is paged too, from the same pool)
  * linear state:    unchanged per-slot leaves (O(1) per request; an
    attention-free model, e.g. xLSTM, has tables of zero columns and
    no pages in use: its paged path is these slots and the prefix
    cache's state snapshots)

``P = num_pool_pages + 1``: the extra *sink* page (id ``num_pool_pages``,
never handed out by the BlockPool) is where retired slots' tables point, so
their writes during a decode block land on a page no live request reads.
``T`` (page tokens) equals the prefix cache's block size, so one BlockPool
id addresses both the metadata block and the device page.

Each slot's seq table ``(num_slots, capacity / T)`` lists its append-only
pages; the pages covering a prompt's full blocks are prefix-shareable
(other slots map them read-only through BlockPool ref-counts).  Its ring
table ``(num_slots, W_buf / T)`` lists its SWA ring pages, always its own:
the ring at length L is only valid for resuming at exactly L, so a shared
prefix's ring travels as an exact-length snapshot payload copied into the
new slot's own pages at admission.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import AttentionSpec, ModelConfig
from repro_torch.models.attention import is_ring, ring_place, ring_unplace
from repro_torch.models.kvcache import dequantize_cache_from_wire
from repro_torch.models.linear_attention import state_shapes
from repro_torch.models.model import torch_dtype, zeros_of
from repro_torch.models.tree import tree_leaves


@dataclass(frozen=True)
class PagedLayout:
    page_tokens: int
    num_pages: int              # pool pages (sink excluded)
    capacity: int
    seq_cols: int               # seq table width (0: no full/MLA layers)
    ring_cols: int = 0          # ring table width (0: no SWA layers)
    ring_tokens: int = 0        # W_buf of the SWA layers (0 if none)

    @property
    def sink(self) -> int:
        return self.num_pages

    @property
    def total_pages(self) -> int:
        return self.num_pages + 1


def _is_seq(m) -> bool:
    return isinstance(m, AttentionSpec) and not is_ring(m)


def has_paged_prefill(cfg: ModelConfig) -> bool:
    """Whether a prefix-hit suffix prefill of ``cfg`` runs the paged-prefill
    kernel: any GQA / MHA block (MLA gathers its latent pages instead)."""
    return any(isinstance(b.mixer, AttentionSpec) and b.mixer.kind != "mla"
               for g in cfg.groups for b in g.blocks)


def paged_layout(cfg: ModelConfig, capacity: int, page_tokens: int,
                 num_pages: int) -> PagedLayout:
    """Validate the arch for paged decode and derive the table geometry."""
    if cfg.encoder_groups is not None or cfg.num_image_patches:
        raise ValueError("paged KV supports decoder-only token models "
                         "(no encoder / image prefix)")
    T = page_tokens
    if capacity % T:
        raise ValueError(f"capacity {capacity} not a multiple of page "
                         f"size {T}")
    has_seq = False
    rings = set()
    for g in cfg.groups:
        for b in g.blocks:
            if b.cross is not None:
                raise ValueError("paged KV does not support cross-attention")
            m = b.mixer
            if is_ring(m):
                w_buf = min(m.window, capacity)
                if w_buf % T:
                    raise ValueError(f"SWA buffer {w_buf} not a multiple of "
                                     f"page size {T}")
                rings.add(w_buf)
            has_seq |= _is_seq(m)
    if len(rings) > 1:
        raise ValueError("paged KV requires one SWA window per model, got "
                         f"{sorted(rings)}")
    ring_tokens = rings.pop() if rings else 0
    return PagedLayout(page_tokens=T, num_pages=num_pages, capacity=capacity,
                       seq_cols=capacity // T if has_seq else 0,
                       ring_cols=ring_tokens // T, ring_tokens=ring_tokens)


def _zeros(cfg: ModelConfig, shapes, device):
    """Zeroed caches in the group structure: ``shapes(bspec)`` gives each
    block's {leaf: (shape, dtype)} (nested for sLSTM's state), stacked
    here over the group's repeats."""
    return {"groups": [{f"b{bi}": zeros_of(shapes(b), (g.repeats,), device)
                        for bi, b in enumerate(g.blocks)}
                       for g in cfg.groups]}


def init_paged_cache(cfg: ModelConfig, num_slots: int, layout: PagedLayout,
                     device):
    """Zeroed page pools + per-slot state on ``device``, in the group
    structure of the dense ``Model.init_cache``."""
    dt = torch_dtype(cfg)
    P, T = layout.total_pages, layout.page_tokens

    def shapes(bspec):
        m = bspec.mixer
        if isinstance(m, AttentionSpec) and m.kind == "mla":
            return {"ckv": ((P, T, m.mla_kv_rank), dt),
                    "kpe": ((P, T, m.mla_rope_dim), dt)}
        if isinstance(m, AttentionSpec):
            shape = (m.kv_heads, P, T, m.head_dim)
            return {"k": (shape, dt), "v": (shape, dt)}
        return state_shapes(m, num_slots, dt)

    return _zeros(cfg, shapes, device)


def page_bytes(cfg: ModelConfig, layout: PagedLayout) -> int:
    """Device bytes one pool page occupies summed across every paged leaf
    (one page id addresses the same row in all attention layers)."""
    size = torch.finfo(torch_dtype(cfg)).bits // 8
    total = 0
    for g in cfg.groups:
        for b in g.blocks:
            m = b.mixer
            if not isinstance(m, AttentionSpec):
                continue
            if m.kind == "mla":
                d = m.mla_kv_rank + m.mla_rope_dim
                total += g.repeats * layout.page_tokens * d * size
            else:
                total += (2 * g.repeats * m.kv_heads * layout.page_tokens
                          * m.head_dim * size)
    return total


def zero_request_payload(cfg: ModelConfig, L: int, device):
    """Zeroed prefill caches of one request (leaves (R, 1, L, ...)) in the
    trimmed format decode admission consumes."""
    dt = torch_dtype(cfg)

    def shapes(bspec):
        m = bspec.mixer
        if isinstance(m, AttentionSpec) and m.kind == "mla":
            return {"ckv": ((1, L, m.mla_kv_rank), dt),
                    "kpe": ((1, L, m.mla_rope_dim), dt)}
        if isinstance(m, AttentionSpec):
            shape = (1, L, m.kv_heads, m.head_dim)
            return {"k": (shape, dt), "v": (shape, dt)}
        return state_shapes(m, 1, dt)

    return _zeros(cfg, shapes, device)


# ---------------------------------------------------------------------------
# request payload -> page tensors (admission)
# ---------------------------------------------------------------------------


def is_wire(node) -> bool:
    """A leaf still in int8 wire form ({"q", "scale"}, see
    ``kvcache.quantize_cache_for_wire``)."""
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _pageify_seq(leaf, c: int, L: int, T: int):
    """(R, 1, L, ...) request leaf -> page tensor for pages [c/T, ceil(L/T)).

    k/v leaves (R, 1, L, Hkv, D) -> (R, Hkv, n, T, D); MLA latents
    (R, 1, L, d) -> (R, n, T, d).  The tail page is zero-padded past L, as
    the dense zero-initialised buffers are.  A wire-form leaf is
    pageified as int8 with its scale alongside, so admission dequantizes
    inside the page write (int8 zero padding dequantizes to the same
    zeros)."""
    if is_wire(leaf):
        return {"q": _pageify_seq(leaf["q"], c, L, T), "scale": leaf["scale"]}
    R = leaf.shape[0]
    n = -(-(L - c) // T)
    span = leaf[:, 0, c:L]
    pad = c + n * T - L
    if pad:
        span = torch.cat([span, span.new_zeros((R, pad) + span.shape[2:])],
                         dim=1)
    if span.ndim == 4:                                       # (R, nT, Hkv, D)
        pages = span.reshape(R, n, T, span.shape[2], span.shape[3])
        return pages.permute(0, 3, 1, 2, 4)                  # (R,Hkv,n,T,D)
    return span.reshape(R, n, T, span.shape[-1])             # (R,n,T,d)


def _ring_from_payload(leaf, L: int, W: int, T: int):
    """The exact SWA ring at length L from the request leaf (R, 1, L, Hkv,
    D) (a suffix prefill's merged caches hold exact rows in the window, the
    prior's un-rung from the snapshot).  Returns pages (R, Hkv, W / T, T,
    D)."""
    R, _, _, Hkv, D = leaf.shape
    ring = ring_place(leaf[:, 0, :L], W, 1)
    return ring.reshape(R, W // T, T, Hkv, D).permute(0, 3, 1, 2, 4)


def build_admit_payload(cfg: ModelConfig, payload, layout: PagedLayout,
                        c: int, L: int):
    """Split one request's prefill caches into paged-admission tensors.

    ``payload``: the trimmed request caches (leaves (R, 1, L, ...))
    covering the prompt [0, L): a full prefill's caches, or a suffix
    prefill's merged prior + suffix caches.  ``c``: device-cached prefix
    (page-aligned; its pages are shared, not rewritten).

    Returns ``{"seq": ..., "ring": ..., "state": ...}``, lists over the
    groups of dicts over the blocks (None where a group has no block of
    the kind).  The ring and state parts double as the snapshot payload
    ``insert_device`` keeps when L is page-aligned.  Wire-form seq leaves
    stay int8 (the engine's page write dequantizes them); wire-form ring
    and state leaves dequantize here.  A table-direct suffix payload (an ``off`` marker in a GQA block,
    see :func:`build_prior`) holds only rows [off, L), so its pages start
    at row ``c - off``."""
    T, W = layout.page_tokens, layout.ring_tokens
    seq_g, ring_g, state_g = [], [], []
    for gi, g in enumerate(cfg.groups):
        seq_b, ring_b, state_b = {}, {}, {}
        for bi, b in enumerate(g.blocks):
            pc = payload["groups"][gi][f"b{bi}"]
            key = f"b{bi}"
            if is_ring(b.mixer):
                pc = dequantize_cache_from_wire(pc)
                ring_b[key] = {name: _ring_from_payload(pc[name], L, W, T)
                               for name in ("k", "v")}
            elif _is_seq(b.mixer):
                off = int(pc["off"].reshape(-1)[0]) if "off" in pc else 0
                seq_b[key] = {name: _pageify_seq(pc[name], c - off,
                                                 L - off, T)
                              for name in pc if name != "off"}
            else:
                state_b[key] = dequantize_cache_from_wire(pc)
        seq_g.append(seq_b or None)
        ring_g.append(ring_b or None)
        state_g.append(state_b or None)
    return {"seq": seq_g, "ring": ring_g, "state": state_g}


# ---------------------------------------------------------------------------
# pages -> chunk-format prior caches (suffix-only prefill on a prefix hit)
# ---------------------------------------------------------------------------


def build_prior(cfg: ModelConfig, paged_caches, layout: PagedLayout,
                seq_ids, snapshot, c: int, *, table_direct: bool = False):
    """Chunk-format prior caches covering [0, c) for a suffix prefill.

    MLA latent rows are gathered from the shared pool pages ``seq_ids``
    (c / T of them, ref-pinned by the caller); SWA rows [max(0, c - W), c)
    are un-rung from the snapshot's ring (rows below are zeros, masked by
    the window); linear state comes from the snapshot's state leaves.  The result plugs into
    ``Model.prefill_chunk(..., caches=prior)`` with positions offset by c.

    GQA blocks gather their K/V the same way, unless ``table_direct``: then
    their prior carries the pool leaves themselves and the request's block
    table (``pk`` / ``pv`` / ``tbl``), an empty dense suffix accumulator
    and an ``off`` marker, and the suffix chunks attend over the table
    through the paged-prefill kernel, the cached prefix never leaving the
    pool."""
    dev = tree_leaves(paged_caches)[0].device
    ids = torch.as_tensor(list(seq_ids), dtype=torch.int32, device=dev)
    groups = []
    for gi, g in enumerate(cfg.groups):
        gc = {}
        for bi, b in enumerate(g.blocks):
            m = b.mixer
            key = f"b{bi}"
            pool = paged_caches["groups"][gi][key]
            if is_ring(m):
                gc[key] = {name: _unring(pages, c, layout.ring_tokens)
                           for name, pages in
                           snapshot["ring"][gi][key].items()}
            elif not _is_seq(m):
                gc[key] = snapshot["state"][gi][key]
            elif m.kind == "mla":
                gc[key] = {n: v[:, ids.long()].reshape(v.shape[0], c,
                                                       v.shape[-1])[:, None]
                           for n, v in pool.items()}
            elif table_direct:
                R, Hkv, _, _, D = pool["k"].shape
                gc[key] = {
                    "k": pool["k"].new_zeros((R, 1, 0, Hkv, D)),
                    "v": pool["v"].new_zeros((R, 1, 0, Hkv, D)),
                    "pk": pool["k"], "pv": pool["v"],
                    "tbl": ids[None, None].expand(R, 1, ids.shape[0]),
                    "off": torch.full((R, 1), c, dtype=torch.int32,
                                      device=dev)}
            else:
                def gather4(v):
                    R, Hkv, D = v.shape[0], v.shape[1], v.shape[-1]
                    pages = v[:, :, ids.long()]              # (R,Hkv,n,T,D)
                    return pages.permute(0, 2, 3, 1, 4).reshape(
                        R, c, Hkv, D)[:, None]
                gc[key] = {n: gather4(v) for n, v in pool.items()}
        groups.append(gc)
    return {"groups": groups}


def _unring(pages, c: int, W: int):
    """Ring pages (R, Hkv, W / T, T, D) at length c -> the chunk-format
    prior (R, 1, c, Hkv, D), zeros below the window."""
    R, Hkv, D = pages.shape[0], pages.shape[1], pages.shape[-1]
    flat = pages.permute(0, 2, 3, 1, 4).reshape(R, W, Hkv, D)
    return ring_unplace(flat, c, 1)[:, None]
