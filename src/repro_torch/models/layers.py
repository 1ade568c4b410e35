"""Shared layer primitives: RMSNorm, RoPE, FFN, dropless MoE (a sorted
loop over experts for prefill, every expert at once for decode), causal
conv.

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
    reference's ``lax.ragged_dot`` grouped GEMM).  The combine adds each
    token's k gate-weighted rows in ascending expert id, one add at a time
    in the activation dtype: the order of the reference's sorted
    ``.at[st].add`` and of the CPU's ``index_add_``, fixed on every device
    (CUDA's ``index_add_`` atomics add in no fixed order, so its bits
    would change from call to call)."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    E, k = spec.num_experts, spec.top_k
    gates, idx = _route(p, x2, k)

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
    ys = ys * sg[:, None].to(ys.dtype)
    # each token's rows in the sorted order: its experts are distinct, so
    # ascending sorted positions are ascending expert ids
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    rows = ys[torch.sort(inv.reshape(T, k), dim=1).values]    # (T, k, d)
    out = torch.zeros((T, d), dtype=ys.dtype, device=x.device)
    for j in range(k):
        out = out + rows[:, j]
    return _with_shared(p, out, x2, spec).reshape(shape)


def apply_moe_decode(p, x, spec: FFNSpec):
    """The dropless top-k MoE of :func:`apply_moe_dropless` for decode,
    with no host sync, so a CUDA graph can capture it: every expert runs
    over all T tokens as ``(E, T, d) x (E, d, d_ff)`` products, and each
    expert's output is weighted by its gate, zero off the token's top-k.
    The function is the same; only the order of the sum changes.  A step
    reads every expert's weights once, where the sorted loop reads the
    experts its tokens route to (~28 of 32 at 8 slots x top-8; at all 352
    experts of kimi-linear-1t a grouped product on the device would read
    fewer)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    gates, idx = _route(p, x2, spec.top_k)
    dense = torch.zeros((x2.shape[0], spec.num_experts), dtype=gates.dtype,
                        device=x.device).scatter_(1, idx, gates)  # (T, E)
    h = _act(torch.matmul(x2, p["w1"]), spec)                 # (E, T, d_ff)
    if spec.activation in ("swiglu", "geglu"):
        h = h * torch.matmul(x2, p["w3"])
    ys = torch.matmul(h, p["w2"])                             # (E, T, d)
    out = (ys * dense.T[..., None].to(ys.dtype)).sum(0)
    return _with_shared(p, out, x2, spec).reshape(shape)


def _route(p, x2, k: int):
    """Softmaxed top-k gates (T, k) float32 and their experts (T, k)."""
    gate_logits, idx = torch.topk(x2.float() @ p["router"], k, dim=-1)
    return torch.softmax(gate_logits, dim=-1), idx


def _with_shared(p, out, x2, spec: FFNSpec):
    """Routed output plus the shared experts' dense FFN, where present."""
    if "shared" not in p:
        return out
    shared = FFNSpec(kind="dense", d_ff=spec.d_ff * spec.shared_experts,
                     activation=spec.activation)
    return out + apply_ffn(p["shared"], x2, shared)


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
