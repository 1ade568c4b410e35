"""Full-attention blocks, MLA (DeepSeek-V2-style latent KV).

Counterpart of ``src/repro/models/attention.py`` for the kind the port
serves: prefill decompresses K/V into MHA form and attends through the
flash kernel; decode runs the absorbed form, MQA over the latent cache,
through the flash-decode kernel.  GQA/SWA attention raises
``NotImplementedError`` until its slice lands.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttentionSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rms_norm


def _check(spec: AttentionSpec):
    if spec.kind != "mla" or spec.is_cross:
        raise NotImplementedError(f"attention kind {spec.kind!r} is not "
                                  "ported yet (ported: self-attention MLA)")


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


def mla_decode(p, x, spec: AttentionSpec, cache, lengths, *,
               use_kernels=True):
    """Absorbed MLA decode: MQA over the latent cache (Dk = R + Rp,
    Dv = R).  x: (B,1,d); cache {"ckv": (B,S,R), "kpe": (B,S,Rp)};
    lengths (B,) context sizes.  The new token's latents are written into
    the cache buffers in place, at ``lengths`` clamped to the last row as
    the reference's dynamic_update_slice clamps it.  Returns (y, cache)."""
    _check(spec)
    B = x.shape[0]
    H, D, R, Rp = (spec.q_heads, spec.head_dim, spec.mla_kv_rank,
                   spec.mla_rope_dim)
    pos = lengths.to(x.device).long()[:, None]
    q_nope, q_pe = _mla_q(p, x, spec)                         # (B,H,1,·)
    q_pe = apply_rope(q_pe, pos, spec.rope_theta)
    kv_a = _lin(p["wkv_a"], x)                                # (B,1,R+Rp)
    ckv_new = rms_norm(kv_a[..., :R], p["kv_norm"])
    kpe_new = apply_rope(kv_a[..., R:][:, None], pos, spec.rope_theta)[:, 0]

    ckv_buf, kpe_buf = cache["ckv"], cache["kpe"]
    rows = torch.arange(B, device=x.device)
    at = pos[:, 0].clamp(max=ckv_buf.shape[1] - 1)
    ckv_buf[rows, at] = ckv_new[:, 0].to(ckv_buf.dtype)
    kpe_buf[rows, at] = kpe_new[:, 0].to(kpe_buf.dtype)

    # absorb W_uk into q: q_abs[h, r] = sum_d q_nope[h, d] * W_uk[r, h, d]
    wkv_b = p["wkv_b"]["w"].reshape(R, spec.kv_heads, 2 * D)
    group = H // spec.kv_heads
    w_uk = wkv_b[..., :D].repeat_interleave(group, dim=1)     # (R,H,D)
    w_uv = wkv_b[..., D:].repeat_interleave(group, dim=1)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0].float(),
                         w_uk.float())                        # (B,H,R)
    q_eff = torch.cat([q_abs, q_pe[:, :, 0].float()], dim=-1)
    k_eff = torch.cat([ckv_buf, kpe_buf], dim=-1)[:, None]    # (B,1,S,R+Rp)
    v_eff = ckv_buf[:, None]                                  # (B,1,S,R)
    o_lat = ops.decode_attention(q_eff.to(x.dtype), k_eff.to(x.dtype),
                                 v_eff.to(x.dtype), lengths + 1,
                                 scale=(D + Rp) ** -0.5,
                                 use_kernel=use_kernels)      # (B,H,R)
    o = torch.einsum("bhr,rhd->bhd", o_lat.float(),
                     w_uv.float()).to(x.dtype)
    y = o.reshape(B, 1, H * D) @ p["wo"]["w"]
    return y, {"ckv": ckv_buf, "kpe": kpe_buf}

