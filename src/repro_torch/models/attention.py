"""Full-attention blocks: GQA / MQA / MHA and MLA (DeepSeek-V2-style
latent KV).

Counterpart of ``src/repro/models/attention.py``:

  * GQA (``kind="full"``): prefill and prefill chunks attend through the
    flash kernel; dense decode through the flash-decode kernel, paged
    decode through the paged flash-decode kernel, and a prefix-hit suffix
    chunk over pool pages + dense suffix through the paged-prefill kernel;
    a speculative verify's q positions (dense) through the flash-decode
    kernel once a position.
  * SWA (``kind="swa"``): GQA whose prefill and chunks pass ``window`` to
    the flash kernel (a chunk keeps the whole prior and masks it); decode
    caches are rings of ``W_buf = min(window, capacity)`` rows, written at
    ``pos % W_buf`` (dense) or through the slot's private ring table
    (paged) and read over ``min(L + 1, W_buf)`` keys.  A speculative
    verify saves the rows its steps will ring-write and puts back the
    rejected ones (:func:`ring_save`, :func:`ring_restore`).
  * MLA: prefill decompresses K/V into MHA form (flash kernel); decode runs
    the absorbed form, MQA over the latent cache (flash-decode kernel, or
    the paged one over the latent pools).
  * An encoder's bidirectional self-attention (``causal=False``) and
    cross-attention (``spec.is_cross``): keys and values from the
    encoder's output, no RoPE, every key visible (flash kernel, Sq != Sk).
    A cross block's decode writes nothing and attends over the whole
    encoder length (flash-decode kernel, reading the prefill's
    ``(B, S_enc, Hkv, D)`` leaves in place, as it reads the self caches).
    The paged layout refuses cross-attention, as the reference's does.

Caches keep the reference's layouts: GQA ``{"k", "v"}`` sequence-major
``(B, S, Hkv, D)``, MLA ``{"ckv": (B, S, R), "kpe": (B, S, Rp)}``; paged
pools ``(Hkv, P, T, D)`` and ``(P, T, R)`` / ``(P, T, Rp)``.  Decode writes
the new token's K/V into the given buffers in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttentionSpec
from repro_torch.distributed.local_map import contiguous_grad, splittable
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm


def _check(spec: AttentionSpec):
    if spec.kind not in ("full", "swa", "mla") or (spec.is_cross
                                                   and spec.kind == "mla"):
        raise NotImplementedError(f"attention kind {spec.kind!r} "
                                  f"(cross: {spec.is_cross}) is not ported "
                                  "(ported: GQA, SWA and MLA, cross GQA)")


def is_ring(spec) -> bool:
    """A sliding-window block, whose decode cache is a ring."""
    return (isinstance(spec, AttentionSpec) and spec.kind == "swa"
            and spec.window > 0)


def _window(spec: AttentionSpec) -> int:
    return spec.window if spec.kind == "swa" else 0


def _lin(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _split_heads(x, H, D):
    B, S, _ = x.shape
    return contiguous_grad(splittable(x, H).reshape(B, S, H, D)).transpose(
        1, 2)                                                 # (B,H,S,D)


def _merge_heads(x):
    B, H, S, D = x.shape
    return contiguous_grad(x.transpose(1, 2).reshape(B, S, H * D), H)


# ---------------------------------------------------------------- GQA


def _gqa_qkv(p, x, spec: AttentionSpec, positions, kv_in=None):
    """Projected q (B,H,S,D) and k, v (B,Hkv,Sk,D) (from ``kv_in``, the
    encoder's output, when given), rotated unless the block is a cross
    one."""
    H, Hkv, D = spec.q_heads, spec.kv_heads, spec.head_dim
    kv_in = x if kv_in is None else kv_in
    q = _split_heads(_lin(p["wq"], x), H, D)
    k = _split_heads(_lin(p["wk"], kv_in), Hkv, D)
    v = _split_heads(_lin(p["wv"], kv_in), Hkv, D)
    if spec.rope and not spec.is_cross:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def gqa_forward(p, x, spec: AttentionSpec, positions, *, kv_source=None,
                causal=True, use_kernels=True):
    """Prefill GQA.  ``kv_source``: the encoder's output (B, S_enc, d), the
    keys' and values' input of a cross block, which sees every key;
    ``causal=False``: an encoder's bidirectional self-attention.  Returns
    (y, {"k", "v": (B, Sk, Hkv, D)})."""
    _check(spec)
    q, k, v = _gqa_qkv(p, x, spec, positions, kv_source)
    o = ops.attention(q, k, v, causal=causal and not spec.is_cross,
                      window=_window(spec), q_offset=0,
                      use_kernel=use_kernels)
    y = _merge_heads(o) @ p["wo"]["w"]
    return y, {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}


def gqa_forward_chunk(p, x, spec: AttentionSpec, positions, cache, *,
                      use_kernels=True):
    """Chunked-prefill GQA: the chunk's queries attend over the prior
    chunks' ``{"k", "v"}`` (B, S_prior, Hkv, D) and their own keys.
    Returns (y, merged cache).

    A table-direct prior (``paged.build_prior(..., table_direct=True)``)
    also carries the pool pages ``pk`` / ``pv`` (Hkv, P, T, D), the
    request's block table ``tbl`` (1, N) and the ``off`` marker; its dense
    ``k`` / ``v`` then hold only the suffix rows, and the chunk attends over
    pages + suffix through the paged-prefill kernel, the cached prefix never
    leaving the pool."""
    _check(spec)
    q, k, v = _gqa_qkv(p, x, spec, positions)
    k_full = torch.cat([cache["k"].to(k.dtype), k.transpose(1, 2)], dim=1)
    v_full = torch.cat([cache["v"].to(v.dtype), v.transpose(1, 2)], dim=1)
    if "pk" in cache:
        o = ops.paged_prefill_attention(
            q, cache["pk"], cache["pv"], cache["tbl"],
            k_full.transpose(1, 2), v_full.transpose(1, 2),
            use_kernel=use_kernels)
        y = _merge_heads(o) @ p["wo"]["w"]
        return y, {**cache, "k": k_full, "v": v_full}
    o = ops.attention(q, k_full.transpose(1, 2), v_full.transpose(1, 2),
                      causal=True, window=_window(spec),
                      q_offset=cache["k"].shape[1], use_kernel=use_kernels)
    y = _merge_heads(o) @ p["wo"]["w"]
    return y, {"k": k_full, "v": v_full}


def cross_decode(p, x, spec: AttentionSpec, cache, *, use_kernels=True):
    """A cross block's decode: the query over every row of the encoder's
    K/V {"k", "v": (B, S_enc, Hkv, D)}, which it does not write.  The
    kernel reads the leaves in place through a transpose.  Returns (y,
    cache)."""
    B = x.shape[0]
    q = _split_heads(_lin(p["wq"], x), spec.q_heads, spec.head_dim)
    enc_len = torch.full((B,), cache["k"].shape[1], dtype=torch.int32,
                         device=x.device)
    o = ops.decode_attention(q[:, :, 0], cache["k"].transpose(1, 2),
                             cache["v"].transpose(1, 2), enc_len,
                             use_kernel=use_kernels)
    return _merge_heads(o[:, :, None]) @ p["wo"]["w"], cache


def gqa_decode(p, x, spec: AttentionSpec, cache, lengths, *,
               use_kernels=True):
    """Dense GQA decode.  x: (B,1,d); cache {"k", "v": (B, S_cap, Hkv, D)};
    lengths (B,).  The new token's K/V go in place at ``lengths`` modulo
    the buffer (the reference's write index), then the query attends over
    ``min(lengths + 1, S_cap)`` keys.  An SWA cache is a ring of S_cap =
    ``min(window, capacity)`` rows: it holds exactly the window's keys, in
    ring order (softmax is order-free, and RoPE was applied at the write),
    so the kernel takes no window.  Returns (y, cache)."""
    _check(spec)
    B = x.shape[0]
    pos = lengths.to(x.device).long()[:, None]
    q, k, v = _gqa_qkv(p, x, spec, pos)
    kbuf, vbuf = cache["k"], cache["v"]
    w_buf = kbuf.shape[1]
    rows = torch.arange(B, device=x.device)
    at = pos[:, 0] % w_buf
    kbuf[rows, at] = k[:, :, 0].to(kbuf.dtype)
    vbuf[rows, at] = v[:, :, 0].to(vbuf.dtype)
    eff_len = torch.clamp(lengths.to(x.device) + 1, max=w_buf)
    o = ops.decode_attention(q[:, :, 0], kbuf.transpose(1, 2),
                             vbuf.transpose(1, 2), eff_len,
                             use_kernel=use_kernels)
    y = _merge_heads(o[:, :, None]) @ p["wo"]["w"]
    return y, {"k": kbuf, "v": vbuf}


def gqa_decode_verify(p, x, spec: AttentionSpec, cache, lengths, *,
                      use_kernels=True):
    """Speculative verify for append-only full attention: the current
    token and k drafts, x (B, Q, d), in one pass.  All Q positions are
    projected and rotated at once, their K/V written in place at
    ``lengths + j``, then :func:`ops.verify_attention` scores position j
    over ``min(lengths + 1 + j, S_cap)`` keys, so a row written for a
    later position adds exactly 0.  A position past the buffer keeps the
    row's content (the reference drops that write; the row, ``pos % S``,
    is distinct from the slot's other positions while Q <= S, so one
    ``index_put_`` has no duplicate index).  Returns (y (B, Q, d),
    cache)."""
    _check(spec)
    B, Q, _ = x.shape
    pos = (lengths.to(x.device).long()[:, None]
           + torch.arange(Q, device=x.device)[None])          # (B, Q)
    q, k, v = _gqa_qkv(p, x, spec, pos)
    kbuf, vbuf = cache["k"], cache["v"]
    S = kbuf.shape[1]
    rows = torch.arange(B, device=x.device)[:, None]
    at = pos % S
    keep = (pos < S)[..., None, None]
    for buf, new in ((kbuf, k), (vbuf, v)):
        buf[rows, at] = torch.where(keep, new.transpose(1, 2).to(buf.dtype),
                                    buf[rows, at])
    o = ops.verify_attention(q, kbuf.transpose(1, 2), vbuf.transpose(1, 2),
                             lengths.to(x.device) + 1,
                             use_kernel=use_kernels)          # (B,H,Q,D)
    y = _merge_heads(o) @ p["wo"]["w"]
    return y, {"k": kbuf, "v": vbuf}


def _page_slot(tbl, pos, page_tokens: int, sink: int):
    """(physical page, in-page row) of each slot's write at ``pos``.  A
    slot stepping past its table (surplus steps at the capacity wall,
    retired on the host afterwards) writes into the sink page, which no
    live table references, instead of clobbering its last live page."""
    cols = tbl.shape[1]
    lp = torch.clamp(pos // page_tokens, max=cols - 1)
    phys = tbl[torch.arange(tbl.shape[0], device=tbl.device), lp].long()
    phys = torch.where(pos >= cols * page_tokens,
                       torch.full_like(phys, sink), phys)
    return phys, pos % page_tokens


def gqa_decode_paged(p, x, spec: AttentionSpec, cache, lengths, tables, *,
                     page_tokens, capacity, use_kernels=True):
    """Paged GQA decode: ``cache`` holds the shared page pools {"k", "v":
    (Hkv, P, T, D)}, ``tables["seq"]`` (B, capacity/T) maps each slot's
    logical pages to physical ones.  The new K/V are written into the pool
    in place through the table; inactive slots (tables at the sink page)
    write into the sink.  An SWA block writes and reads through the slot's
    private ring table ``tables["ring"]`` instead: ring row ``pos % W_buf``
    (``W_buf = min(window, capacity)``), ``min(L + 1, W_buf)`` keys."""
    _check(spec)
    pos = lengths.to(x.device).long()[:, None]
    q, k, v = _gqa_qkv(p, x, spec, pos)
    kbuf, vbuf = cache["k"], cache["v"]
    if is_ring(spec):
        w_buf = min(spec.window, capacity)
        tbl = tables["ring"][:, :w_buf // page_tokens]
        wpos = pos[:, 0] % w_buf
    else:
        w_buf, tbl, wpos = capacity, tables["seq"], pos[:, 0]
    phys, off = _page_slot(tbl, wpos, page_tokens, kbuf.shape[1] - 1)
    kbuf[:, phys, off] = k[:, :, 0].transpose(0, 1).to(kbuf.dtype)
    vbuf[:, phys, off] = v[:, :, 0].transpose(0, 1).to(vbuf.dtype)
    eff_len = torch.clamp(lengths.to(x.device) + 1, max=w_buf)
    o = ops.paged_decode_attention(q[:, :, 0], kbuf, vbuf, tbl, eff_len,
                                   use_kernel=use_kernels)
    y = _merge_heads(o[:, :, None]) @ p["wo"]["w"]
    return y, {"k": kbuf, "v": vbuf}


# ---------------------------------------------------------------- MLA


def _mla_q(p, x, spec: AttentionSpec):
    H, D, Rp = spec.q_heads, spec.head_dim, spec.mla_rope_dim
    if spec.mla_q_rank:
        q = _lin(p["wq_b"], rms_norm(_lin(p["wq_a"], x), p["q_norm"]))
    else:
        q = _lin(p["wq"], x)
    q = _split_heads(q, H, D + Rp)
    return q[..., :D], q[..., D:]                             # nope, pe


def _mha_kv(p, spec: AttentionSpec, ckv, kpe):
    """Decompress latents (B,S,R) + rope keys (B,S,Rp) to MHA K and V."""
    B, S, _ = ckv.shape
    D, Rp, Hkv = spec.head_dim, spec.mla_rope_dim, spec.kv_heads
    kv = _split_heads(_lin(p["wkv_b"], ckv), Hkv, 2 * D)
    k_nope, v = kv[..., :D], kv[..., D:]
    k = torch.cat([k_nope, kpe[:, None].expand(B, Hkv, S, Rp)], dim=-1)
    return k, v


def mla_forward(p, x, spec: AttentionSpec, positions, *, use_kernels=True):
    """Prefill MLA.  Returns (y, {"ckv": (B,S,R), "kpe": (B,S,Rp)})."""
    _check(spec)
    H, D, R, Rp = (spec.q_heads, spec.head_dim, spec.mla_kv_rank,
                   spec.mla_rope_dim)
    q_nope, q_pe = _mla_q(p, x, spec)
    kv_a = _lin(p["wkv_a"], x)                                # (B,S,R+Rp)
    ckv = rms_norm(kv_a[..., :R], p["kv_norm"])
    q_pe = apply_rope(q_pe, positions, spec.rope_theta)
    kpe = apply_rope(kv_a[..., R:][:, None], positions, spec.rope_theta)[:, 0]
    k, v = _mha_kv(p, spec, ckv, kpe)
    q = torch.cat([q_nope, q_pe], dim=-1)
    o = ops.attention(q, k, v, causal=True, scale=(D + Rp) ** -0.5,
                      q_offset=0, use_kernel=use_kernels)
    y = _merge_heads(o) @ p["wo"]["w"]
    return y, {"ckv": ckv, "kpe": kpe}


def mla_forward_chunk(p, x, spec: AttentionSpec, positions, cache, *,
                      use_kernels=True):
    """Chunked-prefill MLA: append the chunk's latents to the prior ones,
    decompress K/V for the whole prefix and attend the chunk's queries with
    ``q_offset`` = prior length.  Returns (y, merged latent cache)."""
    _check(spec)
    H, D, R, Rp = (spec.q_heads, spec.head_dim, spec.mla_kv_rank,
                   spec.mla_rope_dim)
    q_nope, q_pe = _mla_q(p, x, spec)
    q_pe = apply_rope(q_pe, positions, spec.rope_theta)
    kv_a = _lin(p["wkv_a"], x)
    ckv_new = rms_norm(kv_a[..., :R], p["kv_norm"])
    kpe_new = apply_rope(kv_a[..., R:][:, None], positions,
                         spec.rope_theta)[:, 0]
    prior = cache["ckv"].shape[1]
    ckv = torch.cat([cache["ckv"].to(ckv_new.dtype), ckv_new], dim=1)
    kpe = torch.cat([cache["kpe"].to(kpe_new.dtype), kpe_new], dim=1)
    k, v = _mha_kv(p, spec, ckv, kpe)
    q = torch.cat([q_nope, q_pe], dim=-1)
    o = ops.attention(q, k, v, causal=True, scale=(D + Rp) ** -0.5,
                      q_offset=prior, use_kernel=use_kernels)
    y = _merge_heads(o) @ p["wo"]["w"]
    return y, {"ckv": ckv, "kpe": kpe}


def _mla_decode_q(p, x, spec: AttentionSpec, pos):
    """The absorbed decode query and the new token's latents: q_eff
    (B, H, R + Rp) float32 with W_uk folded in, ckv_new (B, 1, R), kpe_new
    (B, 1, Rp)."""
    H, D, R = spec.q_heads, spec.head_dim, spec.mla_kv_rank
    q_nope, q_pe = _mla_q(p, x, spec)                         # (B,H,1,·)
    q_pe = apply_rope(q_pe, pos, spec.rope_theta)
    kv_a = _lin(p["wkv_a"], x)                                # (B,1,R+Rp)
    ckv_new = rms_norm(kv_a[..., :R], p["kv_norm"])
    kpe_new = apply_rope(kv_a[..., R:][:, None], pos, spec.rope_theta)[:, 0]
    # absorb W_uk into q: q_abs[h, r] = sum_d q_nope[h, d] * W_uk[r, h, d]
    wkv_b = p["wkv_b"]["w"].reshape(R, spec.kv_heads, 2 * D)
    w_uk = wkv_b[..., :D].repeat_interleave(H // spec.kv_heads, dim=1)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0].float(),
                         w_uk.float())                        # (B,H,R)
    q_eff = torch.cat([q_abs, q_pe[:, :, 0].float()], dim=-1)
    return q_eff, ckv_new, kpe_new


def _mla_decode_out(p, spec: AttentionSpec, o_lat, x):
    """Latent attention output (B, H, R) -> block output (B, 1, d)."""
    H, D, R = spec.q_heads, spec.head_dim, spec.mla_kv_rank
    wkv_b = p["wkv_b"]["w"].reshape(R, spec.kv_heads, 2 * D)
    w_uv = wkv_b[..., D:].repeat_interleave(H // spec.kv_heads, dim=1)
    o = torch.einsum("bhr,rhd->bhd", o_lat.float(),
                     w_uv.float()).to(x.dtype)
    return o.reshape(x.shape[0], 1, H * D) @ p["wo"]["w"]


def mla_decode(p, x, spec: AttentionSpec, cache, lengths, *,
               use_kernels=True):
    """Absorbed MLA decode: MQA over the latent cache (Dk = R + Rp,
    Dv = R).  x: (B,1,d); cache {"ckv": (B,S,R), "kpe": (B,S,Rp)};
    lengths (B,) context sizes.  The new token's latents are written into
    the cache buffers in place, at ``lengths`` clamped to the last row as
    the reference's dynamic_update_slice clamps it.  Returns (y, cache)."""
    _check(spec)
    B = x.shape[0]
    pos = lengths.to(x.device).long()[:, None]
    q_eff, ckv_new, kpe_new = _mla_decode_q(p, x, spec, pos)
    ckv_buf, kpe_buf = cache["ckv"], cache["kpe"]
    rows = torch.arange(B, device=x.device)
    at = pos[:, 0].clamp(max=ckv_buf.shape[1] - 1)
    ckv_buf[rows, at] = ckv_new[:, 0].to(ckv_buf.dtype)
    kpe_buf[rows, at] = kpe_new[:, 0].to(kpe_buf.dtype)
    k_eff = torch.cat([ckv_buf, kpe_buf], dim=-1)[:, None]    # (B,1,S,R+Rp)
    v_eff = ckv_buf[:, None]                                  # (B,1,S,R)
    o_lat = ops.decode_attention(q_eff.to(x.dtype), k_eff.to(x.dtype),
                                 v_eff.to(x.dtype), lengths + 1,
                                 scale=(spec.head_dim + spec.mla_rope_dim)
                                 ** -0.5, use_kernel=use_kernels)
    return _mla_decode_out(p, spec, o_lat, x), {"ckv": ckv_buf,
                                                "kpe": kpe_buf}


def mla_decode_paged(p, x, spec: AttentionSpec, cache, lengths, tables, *,
                     page_tokens, capacity, use_kernels=True):
    """Absorbed MLA decode over the paged latent pools {"ckv": (P, T, R),
    "kpe": (P, T, Rp)}: the math of :func:`mla_decode`, with the latent
    append routed through ``tables["seq"]``.  As in the reference, the key
    operand is the concatenation [ckv, kpe] of the whole pool, built anew
    each call (``capacity`` is unused: latent lengths are not clamped)."""
    _check(spec)
    pos = lengths.to(x.device).long()[:, None]
    q_eff, ckv_new, kpe_new = _mla_decode_q(p, x, spec, pos)
    ckv_buf, kpe_buf = cache["ckv"], cache["kpe"]
    tbl = tables["seq"]
    phys, off = _page_slot(tbl, pos[:, 0], page_tokens, ckv_buf.shape[0] - 1)
    ckv_buf[phys, off] = ckv_new[:, 0].to(ckv_buf.dtype)
    kpe_buf[phys, off] = kpe_new[:, 0].to(kpe_buf.dtype)
    k_eff = torch.cat([ckv_buf, kpe_buf], dim=-1)[None]       # (1,P,T,R+Rp)
    v_eff = ckv_buf[None]                                     # (1,P,T,R)
    o_lat = ops.paged_decode_attention(
        q_eff.to(x.dtype), k_eff.to(x.dtype), v_eff.to(x.dtype), tbl,
        lengths.to(x.device) + 1,
        scale=(spec.head_dim + spec.mla_rope_dim) ** -0.5,
        use_kernel=use_kernels)                               # (B,H,R)
    return _mla_decode_out(p, spec, o_lat, x), {"ckv": ckv_buf,
                                                "kpe": kpe_buf}


# --------------------------------------- speculative ring rollback (SWA)
#
# A verify's step j ring-writes row (L + j) % W_buf of each slot, which held
# position L + j - W_buf: still in the window of the steps after a rejected
# one.  So the q rows are saved before the verify and the rejected ones put
# back after it (accepted rows are rewritten with their own values, so the
# write needs no mask).  Append-only leaves need nothing: a rejected row is
# rewritten before any kept token reads it.  The save and the restore fill
# and read buffers made once (``Model.verify_buffers``), so a verify block
# stays one CUDA graph.


def _ring_span(L: int, W: int, device):
    """The positions a ring of W rows holds at length L, [start, L) with
    start = max(0, L - W), and their ring rows ``pos % W``."""
    start = max(0, L - W)
    return start, torch.arange(start, L, device=device) % W


def ring_place(x, W: int, dim: int):
    """A sequence along ``dim`` (positions 0 .. S - 1) -> a ring of W rows
    there: the last W positions at ring row ``pos % W``, zeros where S < W."""
    S = x.shape[dim]
    start, rows = _ring_span(S, W, x.device)
    ring = x.new_zeros(x.shape[:dim] + (W,) + x.shape[dim + 1:])
    return ring.index_copy_(dim, rows, x.narrow(dim, start, S - start))


def ring_unplace(ring, L: int, dim: int):
    """The inverse of :func:`ring_place` at length L: a sequence of L rows
    along ``dim``, [max(0, L - W), L) read from ring row ``pos % W``, zeros
    below."""
    start, rows = _ring_span(L, ring.shape[dim], ring.device)
    out = ring.new_zeros(ring.shape[:dim] + (L,) + ring.shape[dim + 1:])
    out.narrow(dim, start, L - start).copy_(ring.index_select(dim, rows))
    return out


def ring_rows(lengths, q: int, w_buf: int):
    """(B, q) ring rows the q verify steps write: (L + j) % W_buf."""
    steps = torch.arange(q, device=lengths.device)[None]
    return (lengths.long()[:, None] + steps) % w_buf


def ring_save(cache, saved, lengths, spec: AttentionSpec, tables=None, *,
              page_tokens=None, capacity=None):
    """Copy the rows the next ``q`` steps will ring-write into ``saved``:
    dense leaves (R, B, W_buf, Hkv, D) give (R, B, q, Hkv, D), paged pools
    (R, Hkv, P, T, D) through the ring table give (R, Hkv, B, q, D).  The
    rows' addresses go into ``saved["at"]`` (dense: the ring rows; paged:
    page and in-page row) for :func:`ring_restore`."""
    q = saved["k"].shape[2 if tables is None else 3]
    B = lengths.shape[0]
    if tables is None:
        rows = ring_rows(lengths, q, cache["k"].shape[2])
        saved["at"].copy_(rows)
        b = torch.arange(B, device=rows.device)[:, None]
        for n in ("k", "v"):
            saved[n].copy_(cache[n][:, b, rows])
        return
    w_buf = min(spec.window, capacity)
    wpos = ring_rows(lengths, q, w_buf)
    tbl = tables["ring"][:, :w_buf // page_tokens].long()
    phys = tbl.gather(1, wpos // page_tokens)
    saved["at"].copy_(torch.stack([phys, wpos % page_tokens]))
    for n in ("k", "v"):
        saved[n].copy_(cache[n][:, :, phys, wpos % page_tokens])


def ring_restore(cache, saved, accept, paged: bool):
    """Put the saved rows back where step j was rejected (j > accept[b]),
    in place."""
    q = saved["k"].shape[3 if paged else 2]
    rej = (torch.arange(q, device=accept.device)[None]
           > accept[:, None])                                  # (B, q)
    for n in ("k", "v"):
        buf = cache[n]
        if paged:
            phys, off = saved["at"][0], saved["at"][1]
            cur = buf[:, :, phys, off]                         # (R,Hkv,B,q,D)
            buf[:, :, phys, off] = torch.where(rej[None, None, :, :, None],
                                               saved[n], cur)
        else:
            rows = saved["at"]
            b = torch.arange(rows.shape[0], device=rows.device)[:, None]
            cur = buf[:, b, rows]                              # (R,B,q,Hkv,D)
            buf[:, b, rows] = torch.where(rej[None, :, :, None, None],
                                          saved[n], cur)


# ----------------------------------------------------------- dispatch


def attention_forward(p, x, spec: AttentionSpec, positions, *,
                      kv_source=None, causal=True, use_kernels=True):
    if spec.kind == "mla":
        return mla_forward(p, x, spec, positions, use_kernels=use_kernels)
    return gqa_forward(p, x, spec, positions, kv_source=kv_source,
                       causal=causal, use_kernels=use_kernels)


def attention_forward_chunk(p, x, spec: AttentionSpec, positions, cache, *,
                            use_kernels=True):
    if spec.is_cross:
        raise ValueError("chunked prefill does not support cross-attention")
    if spec.kind == "mla":
        return mla_forward_chunk(p, x, spec, positions, cache,
                                 use_kernels=use_kernels)
    return gqa_forward_chunk(p, x, spec, positions, cache,
                             use_kernels=use_kernels)


def attention_decode(p, x, spec: AttentionSpec, cache, lengths, *,
                     use_kernels=True):
    if spec.kind == "mla":
        return mla_decode(p, x, spec, cache, lengths, use_kernels=use_kernels)
    return gqa_decode(p, x, spec, cache, lengths, use_kernels=use_kernels)


def attention_decode_paged(p, x, spec: AttentionSpec, cache, lengths, tables,
                           *, page_tokens, capacity, use_kernels=True):
    if spec.is_cross:
        raise ValueError("paged decode does not support cross-attention")
    fn = mla_decode_paged if spec.kind == "mla" else gqa_decode_paged
    return fn(p, x, spec, cache, lengths, tables, page_tokens=page_tokens,
              capacity=capacity, use_kernels=use_kernels)
