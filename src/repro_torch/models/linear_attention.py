"""Bounded-state sequence mixers: KDA/GDN (the gated delta rule) and
Mamba2 (SSD as gated linear attention with a scalar per-head decay).

Counterpart of ``src/repro/models/linear_attention.py`` for the kinds the
port serves; the other linear mixers (GLA, mLSTM, sLSTM) raise
``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LinearSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d

SUPPORTED = ("kda", "gdn", "mamba2")


def _check(spec: LinearSpec):
    if spec.kind not in SUPPORTED:
        raise NotImplementedError(f"linear mixer {spec.kind!r} is not ported "
                                  f"yet (ported: {SUPPORTED})")


def _heads(x, H, D):
    B, S, _ = x.shape
    return x.reshape(B, S, H, D).transpose(1, 2)


def _unheads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _l2norm(x, eps=1e-6):
    inv = torch.rsqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True) + eps)
    return x * inv.to(x.dtype)


def _per_head_norm(o, scale, eps=1e-5):
    """RMSNorm over the value dim of (B,H,S,dv), scale (H*dv,)."""
    B, H, S, dv = o.shape
    of = o.float()
    var = torch.mean(of * of, dim=-1, keepdim=True)
    of = of * torch.rsqrt(var + eps)
    return (of * scale.float().reshape(1, H, 1, dv)).to(o.dtype)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _qkv(p, x, spec: LinearSpec, conv_state=None, lengths=None):
    H, dk, dv = spec.heads, spec.key_dim, spec.value_dim
    q = x @ p["wq"]["w"]
    k = x @ p["wk"]["w"]
    v = x @ p["wv"]["w"]
    new_conv = None
    if spec.conv_kernel:
        qkv = torch.cat([q, k, v], dim=-1)
        if lengths is not None:
            # zero padded positions so taps at valid positions only read
            # real inputs (or zeros past the end)
            S = qkv.shape[1]
            mask = torch.arange(S, device=x.device)[None, :] < lengths.to(
                x.device)[:, None]
            qkv = torch.where(mask[..., None], qkv, 0)
        qkv, new_conv = causal_conv1d(qkv, p["conv_w"], conv_state,
                                      lengths=lengths)
        qkv = F.silu(qkv)
        q = qkv[..., :H * dk]
        k = qkv[..., H * dk:2 * H * dk]
        v = qkv[..., 2 * H * dk:]
    return _heads(q, H, dk), _heads(k, H, dk), _heads(v, H, dv), new_conv


def _gates_full(p, x, spec: LinearSpec):
    """Per-token per-head (log_a <= 0, beta), each (B, H, S) float32;
    beta is None for Mamba2, which has no write strength."""
    dt = _softplus(x @ p["a_proj"]["w"] + p["dt_bias"].to(x.dtype))
    log_a = -torch.exp(p["A_log"].float()) * dt.float()
    if spec.kind == "mamba2":
        return log_a.transpose(1, 2), None
    beta = torch.sigmoid((x @ p["b_proj"]["w"]).float())
    return log_a.transpose(1, 2), beta.transpose(1, 2)


def _d_skip(p, o, v):
    """Mamba2's skip term, o + D v in float32 (head axis 1)."""
    shape = (1, -1) + (1,) * (v.dim() - 2)
    return o + p["D_skip"].float().reshape(shape) * v.float()


def linear_forward(p, x, spec: LinearSpec, *, initial_state=None,
                   conv_state=None, lengths=None, use_kernels=True):
    """Full-sequence (prefill) forward.  Returns (y, cache = {"state":
    (B,H,dk,dv) float32, "conv"}).

    ``lengths`` (B,): valid tokens per row of a right-padded batch; padded
    positions leave the state untouched and the conv window is taken at
    ``lengths``, so the cache is exactly that of the unpadded prompt."""
    _check(spec)
    q, k, v, new_conv = _qkv(p, x, spec, conv_state, lengths=lengths)
    log_a, beta = _gates_full(p, x, spec)
    if spec.kind == "mamba2":
        k = k * (spec.key_dim ** -0.5)
        o, state = ops.gla(q, k, v, log_a, initial_state, lengths=lengths,
                           use_kernel=use_kernels)
        o = _d_skip(p, o, v)
    else:
        k = _l2norm(k)
        q = _l2norm(q)
        o, state = ops.delta(q, k, v, log_a, beta, initial_state,
                             lengths=lengths, use_kernel=use_kernels)
    o = _per_head_norm(o.to(x.dtype), p["g_norm"])
    g = F.silu(x @ p["g_proj"]["w"])
    y = (_unheads(o) * g) @ p["wo"]["w"]
    cache = {"state": state}
    if spec.conv_kernel:
        cache["conv"] = new_conv
    return y, cache


def linear_decode(p, x, spec: LinearSpec, cache):
    """x: (B,1,d); cache {"state", "conv"} -> (y, new cache)."""
    _check(spec)
    B = x.shape[0]
    q, k, v, new_conv = _qkv(p, x, spec, cache.get("conv"))
    log_a, beta = _gates_full(p, x, spec)
    q1, k1, v1 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    if spec.kind == "mamba2":
        k1 = k1 * (spec.key_dim ** -0.5)
        o, state = ops.gla_step(q1, k1, v1, log_a[:, :, 0], cache["state"])
        o = _d_skip(p, o, v1)
    else:
        k1 = _l2norm(k1)
        q1 = _l2norm(q1)
        o, state = ops.delta_step(q1, k1, v1, log_a[:, :, 0],
                                  beta[:, :, 0], cache["state"])
    o = _per_head_norm(o[:, :, None].to(x.dtype), p["g_norm"])[:, :, 0]
    g = F.silu(x[:, 0] @ p["g_proj"]["w"])
    y = ((o.reshape(B, -1) * g) @ p["wo"]["w"])[:, None]
    new_cache = {"state": state}
    if spec.conv_kernel:
        new_cache["conv"] = new_conv
    return y, new_cache
