"""Shared layer primitives: RMSNorm, RoPE, FFN, dropless MoE, causal conv.

Counterparts of ``src/repro/models/layers.py``; every function keeps the
reference's dtype at each step (bf16 activations, float32 statistics)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FFNSpec


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (B, S) int. Rotates pairs (2i, 2i+1)."""
    B, H, S, D = x.shape
    inv = rope_freqs(D, theta, x.device)
    ang = positions.float()[:, None, :, None] * inv           # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float().reshape(B, H, S, D // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(B, H, S, D).to(x.dtype)


def _act(h, spec: FFNSpec):
    if spec.activation == "swiglu":
        return F.silu(h)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h, approximate="tanh")


def apply_ffn(p, x, spec: FFNSpec):
    h = _act(x @ p["w1"], spec)
    if spec.activation in ("swiglu", "geglu"):
        h = h * (x @ p["w3"])
    return h @ p["w2"]


def apply_moe_dropless(p, x, spec: FFNSpec):
    """Exact (dropless) top-k MoE.  Tokens are sorted by expert and each
    expert's contiguous run goes through a plain ``torch.matmul`` (the
    reference's ``lax.ragged_dot`` grouped GEMM), then scatter-added back
    weighted by the softmaxed gate logits."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    E, k = spec.num_experts, spec.top_k

    logits = x2.float() @ p["router"]
    gate_logits, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(gate_logits, dim=-1)

    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.bincount(se, minlength=E).tolist()

    xs = x2[st]                                               # (T*k, d)
    ys = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    lo = 0
    for e, n in enumerate(counts):
        if n:
            xe = xs[lo:lo + n]
            h = _act(xe @ p["w1"][e], spec)
            if spec.activation in ("swiglu", "geglu"):
                h = h * (xe @ p["w3"][e])
            ys[lo:lo + n] = h @ p["w2"][e]
        lo += n
    out = torch.zeros((T, d), dtype=ys.dtype, device=x.device).index_add_(
        0, st, ys * sg[:, None].to(ys.dtype))
    if "shared" in p:
        shared = FFNSpec(kind="dense", d_ff=spec.d_ff * spec.shared_experts,
                         activation=spec.activation)
        out = out + apply_ffn(p["shared"], x2, shared)
    return out.reshape(shape)


def causal_conv1d(x, w, conv_state=None, lengths=None):
    """Depthwise causal conv as K shifted multiply-adds. x: (B, S, C);
    w: (K, C).  Returns (y, new_state = the K-1 inputs ending at each row's
    ``lengths``, or at S when None)."""
    B, S, C = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        # tap i multiplies the input shifted (K-1-i) steps into the past
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    if K <= 1:
        new_state = conv_state
    elif lengths is not None:
        # padded position p lives at xp[p + K - 1]: the window [len-K+1,
        # len) is xp[len : len+K-1]
        idx = lengths.to(x.device).long()[:, None] + torch.arange(
            K - 1, device=x.device)[None]
        new_state = torch.gather(xp, 1, idx[..., None].expand(-1, -1, C))
    else:
        new_state = xp[:, -(K - 1):]
    return y, new_state
