"""Full-attention blocks: GQA / MQA / MHA and MLA (DeepSeek-V2-style
latent KV).

Counterpart of ``src/repro/models/attention.py`` for the kinds the port
serves, self-attention only:

  * GQA (``kind="full"``): prefill and prefill chunks attend through the
    flash kernel; dense decode through the flash-decode kernel, paged
    decode through the paged flash-decode kernel, and a prefix-hit suffix
    chunk over pool pages + dense suffix through the paged-prefill kernel.
  * MLA: prefill decompresses K/V into MHA form (flash kernel); decode runs
    the absorbed form, MQA over the latent cache (flash-decode kernel, or
    the paged one over the latent pools).

Caches keep the reference's layouts: GQA ``{"k", "v"}`` sequence-major
``(B, S, Hkv, D)``, MLA ``{"ckv": (B, S, R), "kpe": (B, S, Rp)}``; paged
pools ``(Hkv, P, T, D)`` and ``(P, T, R)`` / ``(P, T, Rp)``.  Decode writes
the new token's K/V into the given buffers in place.  Sliding-window
attention (ring caches) and cross-attention raise ``NotImplementedError``
until their slice lands.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttentionSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm


def _check(spec: AttentionSpec):
    if spec.kind not in ("full", "mla") or spec.is_cross:
        raise NotImplementedError(f"attention kind {spec.kind!r} is not "
                                  "ported yet (ported: self-attention GQA "
                                  "and MLA)")


def _lin(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _split_heads(x, H, D):
    B, S, _ = x.shape
    return x.reshape(B, S, H, D).transpose(1, 2)              # (B,H,S,D)


def _merge_heads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


# ---------------------------------------------------------------- GQA


def _gqa_qkv(p, x, spec: AttentionSpec, positions):
    """Projected, rotated q (B,H,S,D) and k, v (B,Hkv,S,D)."""
    H, Hkv, D = spec.q_heads, spec.kv_heads, spec.head_dim
    q = _split_heads(_lin(p["wq"], x), H, D)
    k = _split_heads(_lin(p["wk"], x), Hkv, D)
    v = _split_heads(_lin(p["wv"], x), Hkv, D)
    if spec.rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def gqa_forward(p, x, spec: AttentionSpec, positions, *, use_kernels=True):
    """Prefill GQA.  Returns (y, {"k", "v": (B, S, Hkv, D)})."""
    _check(spec)
    q, k, v = _gqa_qkv(p, x, spec, positions)
    o = ops.attention(q, k, v, causal=True, q_offset=0,
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
                      causal=True, q_offset=cache["k"].shape[1],
                      use_kernel=use_kernels)
    y = _merge_heads(o) @ p["wo"]["w"]
    return y, {"k": k_full, "v": v_full}


def gqa_decode(p, x, spec: AttentionSpec, cache, lengths, *,
               use_kernels=True):
    """Dense GQA decode.  x: (B,1,d); cache {"k", "v": (B, S_cap, Hkv, D)};
    lengths (B,).  The new token's K/V go in place at ``lengths`` modulo
    the buffer (the reference's write index), then the query attends over
    ``min(lengths + 1, S_cap)`` keys.  Returns (y, cache)."""
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
    write into the sink."""
    _check(spec)
    pos = lengths.to(x.device).long()[:, None]
    q, k, v = _gqa_qkv(p, x, spec, pos)
    kbuf, vbuf = cache["k"], cache["v"]
    tbl = tables["seq"]
    phys, off = _page_slot(tbl, pos[:, 0], page_tokens, kbuf.shape[1] - 1)
    kbuf[:, phys, off] = k[:, :, 0].transpose(0, 1).to(kbuf.dtype)
    vbuf[:, phys, off] = v[:, :, 0].transpose(0, 1).to(vbuf.dtype)
    eff_len = torch.clamp(lengths.to(x.device) + 1, max=capacity)
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
    kv = _lin(p["wkv_b"], ckv).reshape(B, S, Hkv, 2 * D).transpose(1, 2)
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


# ----------------------------------------------------------- dispatch


def attention_forward(p, x, spec: AttentionSpec, positions, *,
                      use_kernels=True):
    if spec.kind == "mla":
        return mla_forward(p, x, spec, positions, use_kernels=use_kernels)
    return gqa_forward(p, x, spec, positions, use_kernels=use_kernels)


def attention_forward_chunk(p, x, spec: AttentionSpec, positions, cache, *,
                            use_kernels=True):
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
    fn = mla_decode_paged if spec.kind == "mla" else gqa_decode_paged
    return fn(p, x, spec, cache, lengths, tables, page_tokens=page_tokens,
              capacity=capacity, use_kernels=use_kernels)
